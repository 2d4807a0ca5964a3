"""Dry run of every (arch × shape × mesh × strategy) on the meta device:
parameter and state accounting per device, and a run of each step that
proves its shapes and counts its FLOPs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out benchmarks/results/dryrun_torch.json

The port of ``repro.launch.dryrun``, narrowed: no device is involved and
nothing is compiled. Per record:

* ``params``, ``active_params``: the config's counts;
* ``state_bytes_per_device``: the bytes each device of the production
  mesh (``make_production_mesh``: 16×16, or 2×16×16) holds under the
  strategy's specs, as the reference's ``_sharded_bytes``: parameters and
  optimizer state (train, the ``default_optimizer``), parameters
  (prefill), parameters and the decode cache (decode, whose cache shards
  its sequence dim over ``model`` unless the strategy says otherwise);
* ``step_flops``: the whole step's FLOPs (unsharded) by
  ``torch.utils.flop_counter.FlopCounterMode`` over a run of the step on
  meta tensors (``make_train_step`` with remat; prefill and decode on
  the reference's route, as the reference's dry run lowers them, since
  the kernels have no meta implementation), and ``shapes_ok``: the step
  returned what it takes (new parameters and state of the same shapes
  and dtypes, a cache of the input's, logits [B, 1, vocab]; an
  encoder-decoder's prefill, the cross-attention K/V of its frames). The
  train and prefill steps of a model with a recurrence over tokens loop
  in Python on meta tensors (rwkv6's, about 0.05 s a token; the hybrid's
  Mamba scan), so they run at the ``PROBE_SEQ`` of their family and their
  FLOPs are the polynomial through those runs at the shape's sequence
  length (``flops_method``): linear for rwkv6; for the hybrid, quadratic
  (``a + b S + c S^2``: the projections and the scan's ``h . C`` are linear
  in S, the einsum route's masked scores quadratic).

The SPMD fields, the counterpart of the reference's "lowers + compiles"
and its per-device collectives, come from runs of each step as a DTensor
program (``make_*_step(..., mesh=)``) on meta tensors over the production
mesh itself: a ``DeviceMesh`` of 256 or 512 ranks on torch's fake process
group (``torch.testing._internal.distributed.fake_pg``, torch's internal
test module: one process, collectives that move nothing). Per record
(:func:`spmd_record`):

* ``spmd_ok``: the step ran as a DTensor program under the strategy's
  placements and returned its outputs on the out-placements (new
  parameters and state as they came in and the loss replicated; the
  prefill's logits replicated and its cache as ``cache_specs`` places it;
  the decode step's logits replicated and its cache as it came in);
* ``collective_counts`` and ``collective_bytes`` for the reference's five
  op types (:data:`COLLECTIVES`), and ``collective_bytes_total``, per
  device: each collective's result bytes, an all-reduce counted twice, as
  the reference's ``parse_collective_bytes`` counts them (a
  ``TorchDispatchMode`` over the ``_c10d_functional`` ops; the counts are
  ``CommDebugMode``'s, and must agree). The fake mesh's device type is
  ``cuda``, so DTensor issues the collectives it would over NCCL: a
  move of a shard from one tensor dim to another is an all-to-all
  (on a ``cpu`` mesh it would be an all-gather and a slice);
* ``spmd_method``: the layers' program repeats, so the step runs at 2 and
  3 layers (``PROBE_LAYERS``; the first layer's program is its own), its
  collectives extrapolated as the reference's cost probe does
  (``c2 + (L - 2)(c3 - c2)``, exact where the layers after the first are
  alike), at the shape's own batch and sequence (DTensor picks its strategies by the
  bytes they move, so a shorter run may pick others). Prefill and decode
  run the kernel route, as ``make_prefill_step`` and ``make_decode_step``
  build it: each kernel's wrapper checks the placements it is given and
  runs rank-local, issuing no collective; on meta tensors K3 and K5 are
  stood in for by their plain versions, and rwkv6's scan by one op of the
  same shapes (``kernels.rwkv_scan._meta_scan``) in place of a loop over
  the tokens.

An encoder-decoder's runs take a line in each stack, through (2, 2),
(3, 2) and (2, 3) decoder and encoder layers. The hybrid's Mamba scan,
rank-local like the kernels, is stood in for on meta tensors by a few
ops of the same shapes (``models.ssm._meta_selective_scan``), so its
train and prefill steps run at the shape's own sequence length.

The per-device cost, the counterpart of the reference's ``hlo_flops``,
``hlo_bytes`` and ``memory_analysis``, comes from the same runs: a
``TorchDispatchMode`` (:func:`_collective_bytes_mode`) sees each rank's
local ops (rank 0's shards) and counts, per device:

* ``flops_per_device``: the matmul family (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions, attention) by the formulas of
  ``torch.utils.flop_counter`` (``matmul_flops_per_device`` alone, which
  on a 1×1 mesh is ``step_flops``); as XLA's ``flops`` also counts
  elementwise work, one FLOP per output element of every other arithmetic
  op and one per input element of a reduction; views, copies and other
  moves (:data:`MOVES`) and collectives none;
* ``flops_by_op``: ``flops_per_device`` per aten op (the rank-local
  op's name; a stand-in's charge under ``stand-in:`` and its function),
  the :data:`BY_OP_TOP` largest and the rest as ``other``, extrapolated
  over depth as the total is: the entries sum to ``flops_per_device``;
* ``bytes_per_device``: per op that is not a view, the bytes of the
  distinct input storages it reads and of its outputs: an eager, unfused
  count of what the port's eager route moves, not XLA's ``bytes
  accessed`` after fusion, and never to be read as equal to it;
  ``bytes_by_op`` the same per op, as ``flops_by_op``;
* ``memory_analysis``: the reference's keys per device, from the
  lifetimes of the storages the ops make (a weakref per storage):
  ``argument_size`` (the step's inputs, local shards: parameters, optimizer
  state and batch; or parameters, tokens and cache), ``output_size``,
  ``temp_size`` (the most bytes live at once that are neither inputs nor
  outputs; remat's freed and recomputed activations and the tensors
  ``redistribute`` makes and drops are temp) and ``peak_size`` (the most
  bytes live at once, inputs included: what a card can check);
* ``cost_method`` and ``memory_method``: counts and the argument and
  output sizes take the probes' line over depth, as the collectives do;
  temp and peak take it where a run one layer further lies on it (every
  layer adding the same bytes), else a run of the whole depth.

A stand-in is counted as the computation it stands for, by formula
(``rwkv_scan.plain_cost``: the per-token recurrence;
``ssm.selective_scan_cost``: the chunked Mamba loop), its backward too in
a train step; its memory is the stand-in's own. K3 and K5 run their plain
versions on meta, which compute what the reference's einsum route does.
:func:`step_cost` gives these fields for any step (kind, batch, sequence,
mesh). The reference's ``compile_s`` has no counterpart: ``spmd_s`` and
``run_s`` stand there. A record made with ``spmd=False`` has no DTensor
run and so no per-device cost, as its ``cost_method`` says. A step that
fails is recorded as an error row, as the reference records a failure.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from collections import defaultdict
from fractions import Fraction

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import all_archs, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (distribute_model, make_decode_step,
                                      make_prefill_step, make_train_step,
                                      place_cache)
from repro_torch.models import SHAPES, input_specs, params_spec
from repro_torch.models.api import shape_spec
from repro_torch.sharding import (STRATEGIES, MeshShape, cache_specs,
                                  port_param_specs, sharded_bytes,
                                  step_placements)

# family -> sequence lengths of the meta runs of its train or prefill
# step, one more than the degree of its FLOPs in the sequence length
PROBE_SEQ = {"ssm": (16, 32), "hybrid": (16, 32, 48)}
PROBE_FIT = {2: "linear", 3: "quadratic"}


def probe_family(cfg):
    return "hybrid" if cfg.hybrid else cfg.family


# ---------------------------------------------------------------------------
# the step as a DTensor program on the production mesh

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# the namespaces of the ops a DTensor program's collectives become: the
# functional collectives, and DTensor's own all-to-all (a move of a shard
# from one tensor dim to another)
COLLECTIVE_OPS = ("_c10d_functional", "c10d_functional", "_dtensor")
# the depths of the DTensor runs: the first layer's program differs from
# the others' (DTensor picks its strategies by the placements that come
# in, and the first layer's come from the embedding), so the line runs
# through 2 and 3 layers, from which on each layer adds the same program;
# an encoder-decoder's through (2, 2), (3, 2) and (2, 3) decoder and
# encoder layers, a line in each, as the reference's probe takes p11, p21
# and p12
PROBE_LAYERS = (2, 3)
# the entries of a record's flops_by_op: the largest, the rest as "other"
BY_OP_TOP = 12


def _collective_kind(func):
    """The reference's op type of a functional (or c10d) collective, or
    None."""
    name = func._overloadpacket.__name__.rstrip("_")
    for key, kind in (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_gather", "all-gather"), ("allgather", "all-gather"),
                      ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                      ("permute", "collective-permute"),
                      ("send", "collective-permute")):
        if key in name:
            return kind
    return None


# ops that move or make data and compute nothing: no FLOPs, their bytes
# counted (a factory that writes nothing, ``empty``, not even those)
MOVES = frozenset((
    "copy_", "_to_copy", "clone", "contiguous", "cat", "stack", "index",
    "index_select", "gather", "embedding", "slice_scatter",
    "select_scatter", "as_strided_scatter", "scatter", "fill_", "fill",
    "zero_", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_zeros", "new_ones", "new_full", "scalar_tensor",
    "arange", "constant_pad_nd", "repeat", "roll", "flip", "tril_indices",
    "triu_indices", "masked_select", "index_put", "index_put_",
    "_local_scalar_dense", "lift_fresh_copy", "select_backward",
    "slice_backward", "as_strided_backward", "unfold_backward",
    "diagonal_backward", "rand", "randn", "rand_like", "randn_like",
    "randint", "normal_", "uniform_", "bernoulli_"))
WRITES_NOTHING = frozenset(("empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided"))
# reductions: one FLOP per input element
REDUCTIONS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "norm", "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
    "argmax", "argmin", "any", "all", "cumsum", "cumprod"))


def _tensors(tree, out=None):
    """The tensors of an op's arguments or result (lists, tuples, dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _distinct_bytes(t) -> int:
    """The bytes of ``t``'s distinct elements (a broadcast dim of stride 0
    reads one)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _collective_bytes_mode(op_key=None):
    """A ``TorchDispatchMode`` that counts a step's per-device work: it lets
    DTensor ops through first (``NotImplemented``), as ``CommDebugMode``
    does, and sees each rank-local op they become (the per-device program,
    rank 0's shards). Once :meth:`hold` has registered the step's
    arguments it counts only the ops on tensors of their device type (the
    dry run's meta): DTensor's own bookkeeping on host tensors (the mesh's
    ranks, offsets, cached from one layer to the next) is not the step's
    work.

    * ``counts``, ``bytes``: per op type, each collective and the bytes of
      its per-device result (an all-reduce twice).
    * ``flops``: per op, the matmul family (``mm``, ``bmm``, ``addmm``,
      ``baddbmm``, convolutions, attention) by the formulas of
      ``torch.utils.flop_counter`` (also in ``matmul_flops``); a
      reduction (:data:`REDUCTIONS`) one per input element; a view, an op
      of :data:`MOVES` or a collective none; any other op one per output
      element.
    * ``moved``: per op that is not a view (an op whose results alias its
      inputs' storages without writing them), the bytes of its distinct
      input storages (the distinct elements of the views it reads of each,
      at most the storage) and of its outputs. Eager and unfused: what the
      port's eager route moves, not a count after fusion.
    * memory: each storage an op makes is live from that op until the
      storage is freed (a weakref on it); :meth:`hold` registers the
      step's arguments first, and :meth:`memory` gives, once the step's
      outputs are known, ``argument_size``, ``output_size``,
      ``temp_size`` (the most bytes live at once in storages that are
      neither) and ``peak_size`` (the most bytes live at once, arguments
      included).

    * ``flops_by_op``, ``bytes_by_op``: ``flops`` and ``moved`` per aten
      op name (a stand-in's charge under ``stand-in:`` and its name);
      ``op_key(name, inputs, outputs)``, where given, names the entry
      instead (a tool's attribution to the code that issued the op; a
      charge has no tensors). Each sums to its total.

    A stand-in's ops (:func:`repro_torch.kernels._shards.stand_in`) are
    not counted: the computation it stands for is charged instead."""
    import weakref

    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    from repro_torch.kernels._shards import COSTS

    class StepCost(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = defaultdict(int)
            self.counts = defaultdict(int)
            self.flops = self.matmul_flops = self.moved = 0
            self.flops_by_op = defaultdict(int)
            self.bytes_by_op = defaultdict(int)
            self._events = []         # (serial, +/- bytes), in order
            self._live = {}           # storage -> (serial, bytes, weakref)
            self._args = set()        # serials of the arguments' storages
            self._arg_views = {}      # the arguments' tensors, distinct
            self._end = None          # events of the step: those before
            self._device = None       # the arguments' device type

        def __enter__(self):
            COSTS["modes"].append(self)
            return super().__enter__()

        def __exit__(self, *exc):
            COSTS["modes"].remove(self)
            self._end = len(self._events)
            return super().__exit__(*exc)

        def charge(self, flops, matmul_flops, nbytes, name="stand-in"):
            key = op_key(name, (), ()) if op_key else name
            self.flops += flops
            self.matmul_flops += matmul_flops
            self.moved += nbytes
            self.flops_by_op[key] += flops
            self.bytes_by_op[key] += nbytes

        def _storage(self, t, argument=False):
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._live:
                serial = len(self._events)
                n = st.nbytes()

                def freed(_, key=key, serial=serial, n=n):
                    if self._live.get(key, (None,))[0] == serial:
                        del self._live[key]
                        self._events.append((serial, -n))

                self._live[key] = (serial, n, weakref.ref(st, freed))
                self._events.append((serial, n))
                if argument:
                    self._args.add(serial)
            return self._live[key][0]

        def hold(self, *trees):
            """Register the step's arguments (their local shards)."""
            for t in map(_local, _tensors(trees)):
                self._arg_views[_view_key(t)] = _distinct_bytes(t)
                self._storage(t, argument=True)
                self._device = t.device.type

        def memory(self, outputs):
            """The memory analysis, with the step's ``outputs``."""
            outs = {}
            for t in map(_local, _tensors(outputs)):
                outs[_view_key(t)] = (self._storage(t), _distinct_bytes(t))
            fixed = self._args | {s for s, _ in outs.values()}
            live = temp = peak = tpeak = 0
            for serial, n in self._events[:self._end]:
                live += n
                peak = max(peak, live)
                if serial not in fixed:
                    temp += n
                    tpeak = max(tpeak, temp)
            return {"argument_size": sum(self._arg_views.values()),
                    "output_size": sum(n for _, n in outs.values()),
                    "temp_size": tpeak, "peak_size": peak}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            if any(t is DTensor for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if torch._C._get_dispatch_mode(_FAKE_KEY) is not None:
                return out  # DTensor's propagation of shapes: no work
            kind = (_collective_kind(func) if func.namespace in COLLECTIVE_OPS
                    else None)
            if kind is not None:
                n = out.numel() * out.element_size()
                self.bytes[kind] += 2 * n if kind == "all-reduce" else n
                self.counts[kind] += 1
            results = _tensors(out)
            if self._device is not None and not any(
                    t.device.type == self._device
                    for t in results + _tensors((args, kwargs))):
                return out  # host bookkeeping, not the step's work
            if not COSTS["quiet"]:
                self._count(func, args, kwargs, out, results, kind)
            for t in results:
                self._storage(t)
            return out

        def _count(self, func, args, kwargs, out, results, kind):
            ins = _tensors((args, {k: v for k, v in kwargs.items()
                                   if k != "out"}))
            read = defaultdict(dict)
            for t in ins:
                key = _view_key(t)
                read[key[0]][key] = (_distinct_bytes(t),
                                     t.untyped_storage().nbytes())
            name = func._overloadpacket.__name__
            if (not func._schema.is_mutable and results and all(
                    t.untyped_storage()._cdata in read for t in results)):
                return  # a view: it moves nothing
            if kind is None and func.namespace in COLLECTIVE_OPS:
                return  # a collective's bookkeeping (wrap, wait): nothing
            moved = flops = matmul = 0
            if name not in WRITES_NOTHING:
                moved = (sum(min(sum(b for b, _ in v.values()),
                                 max(n for _, n in v.values()))
                             for v in read.values())
                         + sum(_distinct_bytes(t) for t in results))
            packet = func._overloadpacket
            if packet in flop_registry:
                flops = matmul = int(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            elif (kind is not None or func.namespace in COLLECTIVE_OPS
                  or name in MOVES or name in WRITES_NOTHING):
                pass
            elif name in REDUCTIONS:
                flops = ins[0].numel() if ins else 0
            else:
                flops = sum(t.numel() for t in results)
            key = op_key(name, ins, results) if op_key else name
            self.flops += flops
            self.matmul_flops += matmul
            self.moved += moved
            self.flops_by_op[key] += flops
            self.bytes_by_op[key] += moved

    return StepCost()


_FAKE_KEY = torch._C._TorchDispatchModeKey.FAKE


def _view_key(t):
    """A tensor's storage and the view of it: (storage, offset, shape,
    strides)."""
    return (t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape),
            t.stride())


def _local(t):
    """A DTensor's local shard, or the tensor itself."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


_FAKE = {"mesh": None, "depth": 0}


@contextlib.contextmanager
def fake_group():
    """Scope of the fake process groups: :func:`fake_mesh` keeps one group
    (and its mesh) alive within it, and the outermost scope ends it. Raises
    where a real process group exists."""
    if _FAKE["depth"] == 0 and dist.is_initialized():
        raise RuntimeError("the dry run builds its meshes on a fake process "
                           "group of its own; a process group exists")
    _FAKE["depth"] += 1
    try:
        yield
    finally:
        _FAKE["depth"] -= 1
        if _FAKE["depth"] == 0 and dist.is_initialized():
            dist.destroy_process_group()
            _FAKE["mesh"] = None


def fake_mesh(mesh_shape):
    """A ``DeviceMesh`` of ``mesh_shape`` (a ``MeshShape``) over torch's
    fake process group of as many ranks, within :func:`fake_group`. Its
    device type is ``cuda``, the production mesh's (NCCL), though no
    device is touched (the tensors are meta): DTensor plans a mesh's
    collectives by its device type, and on a ``cpu`` mesh (gloo) it
    replaces each all-to-all by an all-gather and a slice."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if _FAKE["depth"] == 0:
        raise RuntimeError("fake_mesh needs a fake_group() scope")
    held = _FAKE["mesh"]
    if held is not None and held[0] == mesh_shape:
        return held[1]
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh_shape.size)
    mesh = init_device_mesh("cuda", mesh_shape.axis_sizes,
                            mesh_dim_names=mesh_shape.axis_names)
    _FAKE["mesh"] = (mesh_shape, mesh)
    return mesh


def _placements(tree):
    if isinstance(tree, dict):
        return {k: _placements(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_placements(v) for v in tree)
    return tuple(tree.placements)


def spmd_run(cfg, shape_name, mesh, strategy, specs=None, op_key=None):
    """One run of ``cfg``'s step for ``shape_name`` (a name of ``SHAPES``
    or a dict of its keys) as a DTensor program on ``mesh`` under
    ``strategy``, on meta tensors: whether its outputs came out on the
    out-placements, its collectives (counts and bytes per op type, per
    device) and its per-device cost (FLOPs, matmul FLOPs, bytes, both per
    op, and the memory analysis: :func:`_collective_bytes_mode`, given
    ``op_key``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.train import distribute
    kind, full = input_specs(cfg, shape_name)
    specs = full if specs is None else specs
    counter = _collective_bytes_mode(op_key)
    if kind == "train":
        model, opt, step = make_train_step(cfg, device="meta", mesh=mesh)
        params = {n: p.detach() for n, p in model.named_parameters()}
        state = opt.init(params)
        places = step_placements("train", mesh, strategy, params=params,
                                 opt_state=state, batch=specs["batch"])
        args = tuple(distribute(t, pl, mesh) for t, pl in zip(
            (params, state, specs["batch"]), places["in"]))
        counter.hold(args)
        with CommDebugMode() as comm, counter:
            out = step(*args)
        got = (_placements(out[0]), _placements(out[1]),
               tuple(out[2].placements))
    elif kind == "prefill":
        # the kernel route, as make_prefill_step builds it: the kernels'
        # wrappers check their placements and stand in for the kernels
        # on meta tensors
        model, step = make_prefill_step(cfg, shape_name, device="meta",
                                        mesh=mesh, strategy=strategy)
        distribute_model(model, mesh, strategy)
        inputs = {k: specs[k] for k in ("frames", "tokens", "frontend_embeds")
                  if k in specs}
        # in: (params, frames), or (params, tokens, frontend_embeds)
        names = (("frames",) if "frames" in inputs
                 else ("tokens", "frontend_embeds"))
        args = {n: distribute(inputs[n], pl, mesh) for n, pl in zip(
            names, step_placements("prefill", mesh, strategy,
                                   **inputs)["in"][1:]) if n in inputs}
        counter.hold(list(model.parameters()), args)
        with CommDebugMode() as comm, counter:
            if "frames" in args:
                out = enc_kv = step(args["frames"])
            else:
                out = logits, cache = step(
                    args["tokens"], frontend_embeds=args.get(
                        "frontend_embeds"))
        if "frames" in args:
            places = step_placements("prefill", mesh, strategy,
                                     frames=inputs["frames"], enc_kv=enc_kv)
            got = _placements(enc_kv)
        else:
            places = step_placements("prefill", mesh, strategy, cache=cache)
            got = (tuple(logits.placements), _placements(cache))
    else:
        model, step = make_decode_step(cfg, shape_name, device="meta",
                                       mesh=mesh)
        distribute_model(model, mesh, strategy)
        places = step_placements("decode", mesh, strategy,
                                 cache=specs["cache"],
                                 tokens=specs["tokens"],
                                 enc_kv=specs.get("enc_kv"))
        cache = place_cache(specs["cache"], mesh, strategy)
        tokens = distribute(specs["tokens"], places["in"][2], mesh)
        enc_kv = () if "enc_kv" not in specs else (tuple(
            distribute(t.detach(), pl, mesh)
            for t, pl in zip(specs["enc_kv"], places["in"][3])),)
        counter.hold(list(model.parameters()), cache, tokens, enc_kv)
        with CommDebugMode() as comm, counter:
            out = logits, cache = step(cache, tokens, *enc_kv)
        got = (tuple(logits.placements), _placements(cache))
    ok = got == tuple(places["out"])
    counts = {k: int(v) for k, v in counter.counts.items()}
    if comm.get_total_counts() != sum(counts.values()):
        raise AssertionError(f"CommDebugMode counted "
                             f"{comm.get_total_counts()} collectives, the "
                             f"byte counter {counts}")
    return {"ok": ok, "counts": counts,
            "bytes": {k: int(v) for k, v in counter.bytes.items()},
            "cost": {"flops": counter.flops,
                     "matmul_flops": counter.matmul_flops,
                     "bytes": counter.moved},
            "flops_by_op": dict(counter.flops_by_op),
            "bytes_by_op": dict(counter.bytes_by_op),
            "memory": counter.memory(out)}


def dtensor_mesh_shape(mesh_shape, strategy: str):
    """The mesh the DTensor program runs on for ``mesh_shape``: itself,
    but on the multi-pod mesh, where every strategy but ``tp_fsdp_inpod``
    shards by ``pod`` and ``data`` together (``("pod", "data")`` in a
    spec: over their product, pod-major), those two axes as one ``data``
    axis of their product, over the same ranks in the same order. The
    placements, and the bytes each device's collectives return, are the
    same; a collective over both axes is one, as XLA issues it, not two
    in a row; and DTensor plans a move over two mesh dims that shard one
    tensor dim with a search that takes minutes a step here."""
    names = mesh_shape.axis_names
    if "pod" not in names or STRATEGIES[strategy].get("fsdp_in_pod"):
        return mesh_shape
    sizes = mesh_shape.shape
    return MeshShape(("data", "model"),
                     (sizes["pod"] * sizes["data"], sizes["model"]))


def _linear(points, L):
    """Per op type, the line through runs at two depths (``c_a + (L -
    a)(c_b - c_a)``) at ``L`` layers; one run is the total itself."""
    if len(points) == 1:
        return dict(points[0][1])
    (la, a), (lb, b) = points
    keys = sorted(set(a) | set(b))
    return {k: a.get(k, 0) + (L - la) * (b.get(k, 0) - a.get(k, 0))
            // (lb - la) for k in keys}


def _probe_depths(cfg):
    """The (decoder, encoder) layers of the DTensor runs: PROBE_LAYERS'
    first in each stack, then its second in one stack at a time (one run
    of the whole model if it is shallower)."""
    a, b = PROBE_LAYERS
    if cfg.encoder_layers > 0:
        return [(a, a), (b, a), (a, b)]
    return [(a, 0), (b, 0)] if cfg.n_layers >= a else [(cfg.n_layers, 0)]


def _extrapolated(depths, runs, cfg):
    """Per op type, the line in each stack's layers through the runs at
    ``depths`` (:func:`_probe_depths`), at ``cfg``'s depths."""
    if len(runs) == 1:
        return dict(runs[0])
    full = (cfg.n_layers, cfg.encoder_layers)
    (base, c0), others = (depths[0], runs[0]), zip(depths[1:], runs[1:])
    out = dict(c0)
    for d, c in others:
        i = 0 if d[0] != base[0] else 1
        line = _linear([(base[i], c0), (d[i], c)], full[i])
        out = {k: out.get(k, 0) + line.get(k, 0) - c0.get(k, 0)
               for k in sorted(set(out) | set(line))}
    return out


def _check_depth(cfg):
    """The depth of the run that checks the memory's line: one layer past
    the probes in each stack."""
    b = PROBE_LAYERS[1] + 1
    return (b, b) if cfg.encoder_layers > 0 else (b, 0)


def _memory(cfg, depths, runs, run_at):
    """(memory analysis, method) at ``cfg``'s depths: the line through the
    probes where a run one layer further (:func:`_check_depth`) lies on
    it, every layer adding the same bytes (argument and output sizes, sums
    over the layers' tensors, always do); else a run of the whole depth
    (``run_at(depth)``)."""
    full = (cfg.n_layers, cfg.encoder_layers)
    mems = dict(zip(depths, (r["memory"] for r in runs)))
    if full in mems:
        return mems[full], "the run at full depth"
    line = _extrapolated(depths, list(mems.values()), cfg)
    check = _check_depth(cfg)
    at = run_at(check)["memory"]
    if check == full:
        return at, "the run at full depth"
    want = _extrapolated(depths, list(mems.values()), dataclasses.replace(
        cfg, n_layers=check[0], encoder_layers=check[1]))
    probes = ", ".join(f"({L}, {E})" if cfg.encoder_layers else str(L)
                       for L, E in depths)
    shown = (f"({check[0]}, {check[1]})" if cfg.encoder_layers
             else str(check[0]))
    if at == want:
        return line, (f"line through the runs at {probes}, on it at "
                      f"{shown}")
    whole = run_at(full)["memory"]
    off = {k: at[k] - want[k] for k in at if at[k] != want[k]}
    return whole, (f"a run of the whole depth: the run at {shown} is off "
                   f"the line through {probes} by {off} bytes")


def largest(by_op, top=BY_OP_TOP):
    """The ``top`` largest entries of a breakdown (all, where ``top`` is
    None), the rest summed under ``"other"``: it still sums to its
    total."""
    ranked = sorted(by_op.items(), key=lambda kv: (-kv[1], kv[0]))
    if top is None or len(ranked) <= top:
        return dict(ranked)
    return {**dict(ranked[:top]), "other": sum(v for _, v in ranked[top:])}


def spmd_record(cfg, shape_name, mesh_shape, strategy: str,
                top=BY_OP_TOP, op_key=None) -> dict:
    """The SPMD fields of one record (see the module's docstring), for
    ``shape_name`` (a name of ``SHAPES`` or a dict of its keys);
    ``flops_by_op`` keeps its ``top`` entries (:func:`largest`),
    ``op_key`` names them (:func:`_collective_bytes_mode`)."""
    t = time.perf_counter()
    depths = _probe_depths(cfg)
    with fake_group():
        mesh = fake_mesh(dtensor_mesh_shape(mesh_shape, strategy))

        def run_at(depth):
            return spmd_run(dataclasses.replace(
                cfg, n_layers=depth[0], encoder_layers=depth[1]),
                shape_name, mesh, strategy, op_key=op_key)

        runs = [run_at(d) for d in depths]
        memory, memory_method = _memory(cfg, depths, runs, run_at)
    out = {field: _extrapolated(depths, [r[field] for r in runs], cfg)
           for field in ("counts", "bytes", "cost", "flops_by_op",
                         "bytes_by_op")}
    if cfg.encoder_layers > 0:
        method = (f"runs at {', '.join(f'({L}, {E})' for L, E in depths)} "
                  "decoder and encoder layers, linear in each")
    else:
        method = (f"runs at {' and '.join(str(L) for L, _ in depths)} "
                  "layers, linear in layers")
    run_on = dtensor_mesh_shape(mesh_shape, strategy)
    if run_on != mesh_shape:
        method += (f"; on {'x'.join(map(str, run_on.axis_sizes))} "
                   "(pod and data as one axis)")
    cost_method = (f"rank 0's local ops ({method}): matmul FLOPs by "
                   "torch.utils.flop_counter's formulas, one a reduction's "
                   "input element and any other arithmetic op's output "
                   "element; bytes read and written per eager op, unfused")
    if cfg.family == "ssm":
        method += "; the rank-local scan stood in for on meta tensors"
        cost_method += ("; the scan counted as its per-token loop "
                        "(rwkv_scan.plain_cost)")
    elif cfg.hybrid:
        method += "; the rank-local Mamba scan stood in for on meta tensors"
        cost_method += ("; the Mamba scan counted as its loop "
                        "(ssm.selective_scan_cost)")
    if not cfg.is_attention_free and input_specs(cfg, shape_name)[0] != \
            "train":
        method += "; the rank-local kernels' plain versions on meta tensors"
        cost_method += "; K3 and K5 counted as their plain versions"
    if cfg.family == "ssm" or cfg.hybrid:
        memory_method += ("; the scan's stand-in holds its outputs, not "
                          "the loop's per-token states")
    return {"spmd_ok": all(r["ok"] for r in runs),
            "collective_counts": {k: out["counts"].get(k, 0)
                                  for k in COLLECTIVES},
            "collective_bytes": {k: out["bytes"].get(k, 0)
                                 for k in COLLECTIVES},
            "collective_bytes_total": sum(out["bytes"].values()),
            "spmd_method": method,
            "flops_per_device": out["cost"]["flops"],
            "matmul_flops_per_device": out["cost"]["matmul_flops"],
            "flops_by_op": largest(out["flops_by_op"], top),
            "bytes_per_device": out["cost"]["bytes"],
            "bytes_by_op": largest(out["bytes_by_op"], top),
            "memory_analysis": {k: memory[k] for k in (
                "argument_size", "output_size", "temp_size", "peak_size")},
            "cost_method": cost_method,
            "memory_method": memory_method,
            "spmd_s": round(time.perf_counter() - t, 2)}


def step_cost(cfg, kind: str, batch: int, seq: int, mesh_shape=(1, 1),
              strategy: str = "tp_fsdp") -> dict:
    """The per-device cost of any step of ``cfg`` (``kind`` "train",
    "prefill" or "decode", at ``batch`` × ``seq``) as a DTensor program on
    ``mesh_shape`` (a ``MeshShape``, or (data, model) sizes) under
    ``strategy``: the SPMD fields of a record (:func:`spmd_record`)."""
    if not isinstance(mesh_shape, MeshShape):
        mesh_shape = MeshShape(("data", "model"), tuple(mesh_shape))
    return spmd_record(cfg, {"kind": kind, "seq": seq, "batch": batch},
                       mesh_shape, strategy)


def case_parts(case: str):
    """A step of a named config on a named mesh (the ones the reference's
    XLA count is held to in ``chip_smoke.py`` and
    tests/test_torch_dryrun_cost.py): ``arch/shape``, the arch's reduced
    config on a 2×2 mesh; ``arch/shape@DxM``, its full config on D × M;
    ``arch:L/shape@DxM``, that cut to L layers. (arch, reduced, L or
    None, shape, (D, M))."""
    name, _, mesh = case.partition("@")
    arch, shape = name.split("/")
    arch, _, layers = arch.partition(":")
    sizes = tuple(int(x) for x in mesh.split("x")) if mesh else (2, 2)
    return arch, not mesh, int(layers) if layers else None, shape, sizes


def case_config(case: str):
    """(config, shape name, ``MeshShape``) of a :func:`case_parts` case."""
    arch, reduced, layers, shape, sizes = case_parts(case)
    cfg = get_config(arch, reduced=reduced)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, shape, MeshShape(("data", "model"), sizes)


def through(points, S):
    """The polynomial of degree ``len(points) - 1`` through ``points``
    [(seq, flops), ...] at ``S``, exactly (Lagrange's form in
    fractions)."""
    total = Fraction(0)
    for i, (si, fi) in enumerate(points):
        term = Fraction(fi)
        for j, (sj, _) in enumerate(points):
            if j != i:
                term *= Fraction(S - sj, si - sj)
        total += term
    return total


def cut_specs(specs, kind, s):
    """A train or prefill step's inputs cut to their first ``s`` tokens."""
    cut = {k: v[:, :s] for k, v in
           (specs["batch"] if kind == "train" else specs).items()}
    return {"batch": cut} if kind == "train" else cut


def _same(a, b) -> bool:
    """Whether two trees of tensors (dicts, tuples) have equal shapes and
    dtypes leaf for leaf."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_same, a, b))
    return a.shape == b.shape and a.dtype == b.dtype


def _run_step(cfg, shape_name, kind, specs):
    """(FLOPs, shapes_ok, optimizer name) of one meta run of the step."""
    B = shape_spec(shape_name)["batch"]
    opt_name = None
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            model, opt, step = make_train_step(cfg, device="meta")
            opt_name = opt.name
            params = dict(model.named_parameters())
            state = opt.init(params)
            new_p, new_s, loss = step(params, state, specs["batch"])
            ok = (_same(new_p, params) and _same(new_s, state)
                  and loss.shape == () and loss.dtype == torch.float32)
        elif kind == "prefill":
            model, step = make_prefill_step(cfg, shape_name, device="meta")
            model.use_kernels = False
            if cfg.encoder_layers > 0:
                enc_kv = step(specs["frames"])
            else:
                # the cache holds the shape's seq positions: a vlm's
                # frontend embeddings and its tokens
                logits, cache = step(
                    specs["tokens"],
                    frontend_embeds=specs.get("frontend_embeds"))
                ok = (logits.shape == (B, 1, cfg.vocab_padded)
                      and _same(tuple(cache), tuple(model.init_cache(
                          B, shape_spec(shape_name)["seq"]))))
        else:
            model, step = make_decode_step(cfg, shape_name, device="meta")
            model.use_kernels = False
            want = tuple(specs["cache"])
            enc_kv = (specs["enc_kv"],) if "enc_kv" in specs else ()
            logits, cache = step(specs["cache"], specs["tokens"], *enc_kv)
            ok = (logits.shape == (B, 1, cfg.vocab_padded)
                  and _same(tuple(cache), want))
    if kind == "prefill" and cfg.encoder_layers > 0:
        # the cross K/V of the frames themselves, outside the count
        with torch.no_grad():
            ok = _same(enc_kv, model.precompute_enc_kv(specs["frames"]))
    return fc.get_total_flops(), ok, opt_name


def step_record(cfg, shape_name) -> dict:
    """The meta run of ``cfg``'s step for ``shape_name`` (a name of
    ``SHAPES`` or a dict of its keys): kind, optimizer, ``step_flops``,
    ``flops_method``, ``shapes_ok`` and ``run_s``."""
    t = time.perf_counter()
    kind, specs = input_specs(cfg, shape_name)
    seqs = PROBE_SEQ.get(probe_family(cfg))
    if seqs and kind != "decode":
        runs = [_run_step(cfg, shape_name, kind, cut_specs(specs, kind, s))
                for s in seqs]
        exact = through([(s, f) for s, (f, _, _) in zip(seqs, runs)],
                        shape_spec(shape_name)["seq"])
        flops, opt = round(exact), runs[0][2]
        at = ", ".join(map(str, seqs[:-1])) + f" and {seqs[-1]}"
        method = (f"{PROBE_FIT[len(seqs)]} in seq from meta runs at {at}"
                  + ("" if exact.denominator == 1
                     else f" (not integral: {float(exact)!r})"))
        ok = all(r[1] for r in runs)
    else:
        flops, ok, opt = _run_step(cfg, shape_name, kind, specs)
        method = "meta run"
    return {"kind": kind, "optimizer": opt, "step_flops": int(flops),
            "flops_method": method, "shapes_ok": bool(ok),
            "run_s": round(time.perf_counter() - t, 2)}


def state_bytes(cfg, shape_name: str, mesh, strategy: str) -> int:
    """Per-device bytes of the step's resident state under ``strategy``."""
    kind, specs = input_specs(cfg, shape_name)
    skw = STRATEGIES[strategy]
    params = params_spec(cfg, shape_name)
    total = sharded_bytes(params, port_param_specs(params, mesh, **skw), mesh)
    if kind == "train":
        _, opt, _ = make_train_step(cfg, device="meta")
        state = opt.init(params)
        total += sharded_bytes(state, port_param_specs(state, mesh, **skw),
                               mesh)
    elif kind == "decode":
        cache = specs["cache"]
        total += sharded_bytes(cache, cache_specs(
            cache, mesh, seq_over_model=skw.get("seq_over_model", True)), mesh)
    return total


def dryrun_one(arch: str, shape_name: str, mesh_kind: str,
               strategy: str = "tp_fsdp", steps: dict = None,
               verbose: bool = True, spmd: bool = False) -> dict:
    """One record. ``steps`` caches :func:`step_record` by (arch, shape):
    the step's run does not depend on the mesh or the strategy. ``spmd``
    adds the SPMD fields and the per-device cost (:func:`spmd_record`;
    the command line does by default); without it ``cost_method`` says
    that the record has no per-device cost."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi_pod"))
    cfg = get_config(arch)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "strategy": strategy, "chips": mesh.size,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count(),
              "state_bytes_per_device": state_bytes(cfg, shape_name, mesh,
                                                    strategy)}
    steps = {} if steps is None else steps
    if (arch, shape_name) not in steps:
        steps[arch, shape_name] = step_record(cfg, shape_name)
    record.update(steps[arch, shape_name])
    if spmd:
        record.update(spmd_record(cfg, shape_name, mesh, strategy))
    else:
        record["cost_method"] = ("none: no DTensor run (spmd=False), so no "
                                 "per-device cost")
    if verbose:
        coll = ("" if "spmd_ok" not in record else
                f", spmd_ok {record['spmd_ok']}, coll/dev "
                f"{record['collective_bytes_total']:.3e} B, flops/dev "
                f"{record['flops_per_device']:.3e}, bytes/dev "
                f"{record['bytes_per_device']:.3e}, peak/dev "
                f"{record['memory_analysis']['peak_size'] / 2**30:.2f} GiB")
        print(f"[dryrun] {arch} × {shape_name} × {mesh_kind} ({strategy}): "
              f"flops {record['step_flops']:.3e} ({record['flops_method']}), "
              f"state/dev {record['state_bytes_per_device'] / 2**30:.2f} GiB, "
              f"shapes_ok {record['shapes_ok']}{coll}", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--strategy", default="tp_fsdp")
    ap.add_argument("--out", default="benchmarks/results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = all_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single_pod", "multi_pod"] if args.mesh == "both"
              else [args.mesh])

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r["strategy"]) for r in results
            if "error" not in r}

    failures, steps = 0, {}
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                key = (arch, shape, mesh_kind, args.strategy)
                if key in done:
                    continue
                try:
                    with fake_group():
                        rec = dryrun_one(arch, shape, mesh_kind,
                                         args.strategy, steps, spmd=True)
                    if not rec["shapes_ok"] or rec.get("spmd_ok") is False:
                        raise AssertionError(f"the step's outputs do not "
                                             f"match its inputs: {rec}")
                except Exception as e:  # a row per failure, as the reference
                    failures += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "strategy": args.strategy, "error": str(e),
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"[dryrun] FAIL {key}: {e}", flush=True)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"],
                               r["strategy"]) != key]
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    print(f"[dryrun] complete: {len(results)} records, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
