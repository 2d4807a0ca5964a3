"""The dry run's per-device cost (``repro_torch.launch.dryrun``:
``flops_per_device``, ``bytes_per_device``, ``memory_analysis``) on the
CPU, on torch's fake process group and meta tensors.

(a) On a 1×1 mesh the matmul-family FLOPs a device equal ``step_flops``
    exactly (the unsharded step under ``FlopCounterMode``): train, prefill
    and decode of a reduced dense, moe, ssm, vlm, encoder-decoder and
    hybrid config. The kernel route's prefill (K3 and K5 plain on meta)
    and the stand-ins of the scans (counted by formula) included. The
    breakdowns by op (``flops_by_op``, ``bytes_by_op``) sum to the totals.
(b) Against the reference's ``_compile_once`` (XLA on forced host
    devices, ``AxisType.Auto`` axes, in a subprocess): reduced dense and
    moe configs on 2×2, train and decode, and llama3.2-3b's train step at
    full width cut to 2 layers on 2×16, every layer unrolled.
    ``argument_size`` equal; ``output_size`` equal but for XLA's output
    tuple table, 8 bytes a leaf of the step's outputs, which the test
    counts (``OUT_TABLE``); ``flops_per_device`` over XLA's ``flops`` within
    ``FLOP_RATIO`` of 1 (XLA counts a softmax's exp, max and sum, a
    convert, a select as work where the eager count has one op or a move;
    both count a matmul as 2 m n k). Bytes are not compared: the port's
    are eager and unfused, XLA's after fusion. chip_smoke.py's
    ``XLA_FLOPS``, which hold the card's dry run to the reference, are
    these counts.
(c) One reduced dense layer's train step on 2×2 (remat, AdamW, batch 4 ×
    32), counted by hand: the step's local ops are recorded by a mode of
    the test's own and FLOPs and bytes worked out from their shapes and
    storages (2 m n k a matmul; a reduction's input elements; another
    arithmetic op's output elements; per op that is not a view, nor a
    collective's wrap or wait, its distinct input storages' bytes and
    its outputs'); ``argument_size``
    from the placements of the parameters, AdamW state and batch.
(d) ``bytes_per_device`` is at least the bytes of the parameters a device
    holds (and of its decode cache).
(e) The depth line holds at a fourth depth: FLOPs, bytes, both by op,
    argument and output sizes, and temp and peak where ``memory_method``
    takes the line.
(f) Each stand-in's count (``rwkv_scan.plain_cost``,
    ``ssm.selective_scan_cost``) equals the cost mode's count over the real
    loop on CPU tensors (forward, and forward and backward as a train step
    takes it), over one chunk and several; and the dry run charges it.
"""
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import textwrap
from collections import defaultdict
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _shards
from repro_torch.kernels.rwkv_scan import _meta_scan, plain_cost, rwkv_scan_plain
from repro_torch.launch import dryrun
from repro_torch.models import input_specs, params_spec, ssm
from repro_torch.sharding import MeshShape, step_placements

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "smollm-360m", "moe": "mixtral-8x22b", "ssm": "rwkv6-1.6b",
            "vlm": "llava-next-34b", "encdec": "seamless-m4t-large-v2",
            "hybrid": "hymba-1.5b"}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
ONE = MeshShape(("data", "model"), (1, 1))
TWO = MeshShape(("data", "model"), (2, 2))
# flops_per_device over XLA's flops (2x2, reduced configs): 1.0083–1.0915
# read on the sound tree
FLOP_RATIO = 0.25
# XLA's output_size counts the output tuple's table, a pointer a leaf
OUT_TABLE = 8

_RECORDS = {}


def _record(family, shape):
    """The DTensor run of ``family``'s reduced config (its whole depth)
    on the 1×1 mesh."""
    if (family, shape) not in _RECORDS:
        cfg = get_config(FAMILIES[family], reduced=True)
        with dryrun.fake_group():
            _RECORDS[family, shape] = dryrun.spmd_run(
                cfg, shape, dryrun.fake_mesh(ONE), "tp_fsdp")
    return _RECORDS[family, shape]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_matmul_flops_on_one_device_equal_step_flops(family, shape):
    cfg = get_config(FAMILIES[family], reduced=True)
    run = _record(family, shape)
    assert run["ok"]
    assert run["cost"]["matmul_flops"] == \
        dryrun.step_record(cfg, shape)["step_flops"]
    assert run["cost"]["flops"] > run["cost"]["matmul_flops"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_breakdown_by_op_sums_to_the_totals(family, shape):
    run = _record(family, shape)
    assert sum(run["flops_by_op"].values()) == run["cost"]["flops"]
    assert sum(run["bytes_by_op"].values()) == run["cost"]["bytes"]
    top = max(run["flops_by_op"], key=run["flops_by_op"].get)
    assert top in ("mm", "bmm", "addmm", "baddbmm")


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in
               torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bytes_cover_the_parameters_and_cache(family, shape):
    cfg = get_config(FAMILIES[family], reduced=True)
    run = _record(family, shape)
    kind, specs = input_specs(cfg, shape)
    need = _nbytes(params_spec(cfg, shape))
    if kind == "decode":
        need += _nbytes(tuple(specs["cache"]))
    ma = run["memory"]
    assert run["cost"]["bytes"] >= need
    assert ma["argument_size"] >= need
    assert ma["peak_size"] >= ma["argument_size"] + ma["temp_size"] > 0


# ---------------------------------------------------------------------------
# (b) the reference's compiled cost on 2×2

REFERENCE = textwrap.dedent("""
    import dataclasses, json, os, sys
    import repro.launch.dryrun as rd  # it sets XLA_FLAGS: set them back
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=32"
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.launch.steps import make_decode_step, make_train_step
    from repro.models import input_specs
    assert len(jax.devices()) == 32, jax.devices()
    out = {}
    for case in sys.argv[1:]:
        arch, reduced, layers, shape, sizes = json.loads(case)
        mesh = jax.make_mesh(sizes, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:sizes[0] * sizes[1]])
        cfg = get_config(arch, reduced=reduced)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        r = rd._compile_once(cfg, shape, mesh, "tp_fsdp", unroll=True,
                             want_memory=True)
        kind, specs = input_specs(cfg, shape)
        if kind == "train":
            model, opt, _ = make_train_step(cfg)
            p = jax.eval_shape(model.init, jax.random.PRNGKey(0))
            leaves = (len(jax.tree_util.tree_leaves(p))
                      + len(jax.tree_util.tree_leaves(
                          jax.eval_shape(opt.init, p))) + 1)
        else:
            leaves = 1 + len(jax.tree_util.tree_leaves(specs["cache"]))
        out[case] = {"flops": r["flops"], "leaves": leaves,
                     "memory_analysis": r["memory_analysis"]}
    print(json.dumps(out))
""")
# dryrun.case_parts: "arch/shape", the reduced config on 2×2;
# "arch:L/shape@DxM", the full config cut to L layers on D×M. On 2×16
# (model 16, as on the production mesh) torch 2.11 planned each output
# projection's backward whole on every rank (1.48× XLA's count; 2×2's
# reduced configs, their attention's S² most of the work, read within
# 1.5 % of it)
CASES = ("smollm-360m/train_4k", "smollm-360m/decode_32k",
         "mixtral-8x22b/train_4k", "mixtral-8x22b/decode_32k",
         "llama3.2-3b:2/train_4k@2x16")
case_parts = dryrun.case_parts


def _reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE,
         *(json.dumps(case_parts(c)) for c in CASES)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return {c: out[json.dumps(case_parts(c))] for c in CASES}


def _port_2x2():
    out = {}
    with dryrun.fake_group():
        for case in CASES:
            cfg, shape, mesh = dryrun.case_config(case)
            out[case] = dryrun.spmd_run(cfg, shape, dryrun.fake_mesh(mesh),
                                        "tp_fsdp")
    return out


@pytest.fixture(scope="module")
def reference():
    return _reference()


@pytest.fixture(scope="module")
def port_2x2():
    return _port_2x2()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", CASES)
def test_chip_smoke_xla_counts_equal_the_reference(case, reference):
    """chip_smoke.py holds the card's dry run to XLA's counts of CASES,
    written there as constants: each is the live count."""
    smoke = _chip_smoke()
    assert tuple(smoke.XLA_FLOPS) == CASES
    assert smoke.FLOP_RATIO == FLOP_RATIO
    assert smoke.XLA_FLOPS[case] == reference[case]["flops"]


@pytest.mark.parametrize("case", CASES)
def test_per_device_cost_against_the_reference_on_2x2(case, reference,
                                                      port_2x2):
    ref, port = reference[case], port_2x2[case]
    ma, rma = port["memory"], ref["memory_analysis"]
    assert ma["argument_size"] == rma["argument_size"]
    assert ma["output_size"] + OUT_TABLE * ref["leaves"] == rma["output_size"]
    ratio = port["cost"]["flops"] / ref["flops"]
    assert abs(ratio - 1) <= FLOP_RATIO, ratio


# ---------------------------------------------------------------------------
# (c) one layer counted by hand

def _recorder():
    """The step's rank-local ops as they run: (name, input tensors'
    (storage, offset, shape, strides, itemsize, storage bytes), outputs'
    the same, whether the op mutates, whether it is a collective's, and
    whether it is a collective's bookkeeping (a wrap, a wait)), on
    meta tensors: DTensor's own shape propagation and its bookkeeping on
    host tensors left out."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def meta(t):
        st = t.untyped_storage()
        return (st._cdata, t.storage_offset(), tuple(t.shape), t.stride(),
                t.element_size(), st.nbytes())

    class Record(TorchDispatchMode):
        ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(t is DTensor for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            fake = torch._C._TorchDispatchModeKey.FAKE
            ins = [t for t in tree_leaves(
                (args, {k: v for k, v in kwargs.items() if k != "out"}))
                if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            if (torch._C._get_dispatch_mode(fake) is None
                    and any(t.is_meta for t in ins + outs)):
                ins, outs = [meta(t) for t in ins], [meta(t) for t in outs]
                comm = func.namespace in dryrun.COLLECTIVE_OPS
                kind = dryrun._collective_kind(func) if comm else None
                self.ops.append((func._overloadpacket.__name__, ins, outs,
                                 func._schema.is_mutable, comm,
                                 comm and kind is None))
            return out

    return Record()


def _by_hand(ops):
    """FLOPs and bytes of the recorded ops by the dry run's convention,
    worked out here from shapes and storages."""
    def distinct(m):
        n = 1
        for size, stride in zip(m[2], m[3]):
            n *= size if stride else 1
        return n * m[4]

    flops = nbytes = 0
    for name, ins, outs, mutable, collective, bookkeeping in ops:
        stores = {m[0] for m in ins}
        if not mutable and outs and all(m[0] in stores for m in outs):
            continue                       # a view
        if bookkeeping:
            continue                       # a collective's wrap or wait
        if name not in dryrun.WRITES_NOTHING:
            per = defaultdict(dict)
            for m in ins:
                per[m[0]][m[:4]] = (distinct(m), m[5])
            nbytes += sum(min(sum(b for b, _ in v.values()),
                              max(s for _, s in v.values()))
                          for v in per.values())
            nbytes += sum(distinct(m) for m in outs)
        if name in ("mm", "bmm"):
            (a, b), o = (ins[0][2], ins[1][2]), outs[0][2]
            flops += 2 * math.prod(o) * a[-1]
        elif name in ("addmm", "baddbmm"):
            flops += 2 * math.prod(outs[0][2]) * ins[1][2][-1]
        elif (collective or name in dryrun.MOVES
              or name in dryrun.WRITES_NOTHING):
            pass
        elif name in dryrun.REDUCTIONS:
            flops += math.prod(ins[0][2])
        else:
            flops += sum(math.prod(m[2]) for m in outs)
    return flops, nbytes


def _hand_counted():
    """The dry run of one reduced dense layer's train step on 2×2, and its
    FLOPs and bytes by hand; also its parameters, AdamW state, batch and
    their input placements."""
    B, S = 4, 32
    cfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                              n_layers=1)
    batch = {k: torch.empty(B, S, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    record = _recorder()
    mode = dryrun._collective_bytes_mode
    try:
        def both(*args):
            counter = mode(*args)

            class Both:
                def __getattr__(self, k):
                    return getattr(counter, k)

                def __enter__(self):
                    counter.__enter__()
                    record.__enter__()
                    return self

                def __exit__(self, *exc):
                    record.__exit__(*exc)
                    return counter.__exit__(*exc)

            return Both()

        dryrun._collective_bytes_mode = both
        with dryrun.fake_group():
            mesh = dryrun.fake_mesh(TWO)
            run = dryrun.spmd_run(cfg, "train_4k", mesh, "tp_fsdp",
                                  specs={"batch": batch})
            params = params_spec(cfg)
            from repro_torch.launch.steps import make_train_step
            state = make_train_step(cfg, device="meta")[1].init(params)
            places = step_placements("train", mesh, params=params,
                                     opt_state=state, batch=batch)["in"]
    finally:
        dryrun._collective_bytes_mode = mode
    assert run["ok"] and record.ops
    flops, nbytes = _by_hand(record.ops)
    return run, flops, nbytes, (params, state, batch), places


def test_hand_counted_layer_train_step_on_2x2():
    run, flops, nbytes, args, places = _hand_counted()
    assert run["cost"]["flops"] == flops
    assert run["cost"]["bytes"] == nbytes
    # a shard per mesh dim it is split on, the first (largest) chunk
    sizes = dict(zip(TWO.axis_names, TWO.axis_sizes))

    def local(t, pl):
        shape = list(t.shape)
        for axis, p in zip(TWO.axis_names, pl):
            if p.is_shard():
                shape[p.dim] = -(-shape[p.dim] // sizes[axis])
        return math.prod(shape) * t.element_size()

    def total(tree, pls):
        if isinstance(tree, dict):
            return sum(total(tree[k], pls[k]) for k in tree)
        return local(tree, pls)

    want = sum(total(t, pl) for t, pl in zip(args, places))
    assert run["memory"]["argument_size"] == want


# ---------------------------------------------------------------------------
# (e) the depth line


@pytest.mark.parametrize("arch,kind,at", (
    ("rwkv6-1.6b", "train", (4, 0)), ("smollm-360m", "train", (4, 0)),
    ("seamless-m4t-large-v2", "prefill", (3, 3))))
def test_cost_line_holds_at_a_fourth_depth(arch, kind, at):
    cfg = get_config(arch, reduced=True)
    shape = {"kind": kind, "seq": 64, "batch": 4}
    depths = dryrun._probe_depths(dataclasses.replace(cfg, n_layers=8,
                                                      encoder_layers=8
                                                      if cfg.encoder_layers
                                                      else 0))
    deeper = dataclasses.replace(cfg, n_layers=at[0], encoder_layers=at[1])
    with dryrun.fake_group():
        mesh = dryrun.fake_mesh(TWO)
        runs = {d: dryrun.spmd_run(dataclasses.replace(
            cfg, n_layers=d[0], encoder_layers=d[1]), shape, mesh, "tp_fsdp")
            for d in (*depths, at)}
    for field in ("cost", "counts", "bytes", "flops_by_op", "bytes_by_op"):
        line = dryrun._extrapolated(depths, [runs[d][field] for d in depths],
                                    deeper)
        assert line == runs[at][field], field
    line = dryrun._extrapolated(depths, [runs[d]["memory"] for d in depths],
                                deeper)
    for k in ("argument_size", "output_size"):
        assert line[k] == runs[at]["memory"][k], k


def test_memory_method_says_how(monkeypatch):
    """The line where a run one layer past the probes lies on it; the
    whole depth where it does not (reduced smollm-360m at 4 × 64 on 2×2:
    the temp bytes grow by another amount from the third layer to the
    fourth), its temp and peak that run's."""
    cfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                              n_layers=6)
    rwkv = dataclasses.replace(get_config("rwkv6-1.6b", reduced=True),
                               n_layers=5)
    assert dryrun.step_cost(rwkv, "train", 4, 64, (2, 2))[
        "memory_method"].startswith("line through the runs at 2, 3, on it")
    runs = []
    run = dryrun.spmd_run
    monkeypatch.setattr(dryrun, "spmd_run", lambda *a, **k: runs.append(
        a[0].n_layers) or run(*a, **k))
    rec = dryrun.step_cost(cfg, "train", 4, 64, (2, 2))
    assert rec["memory_method"].startswith("a run of the whole depth")
    assert runs == [2, 3, 4, 6]


def test_record_without_spmd_says_it_has_no_cost():
    rec = dryrun.dryrun_one("smollm-360m", "decode_32k", "single_pod",
                            verbose=False, spmd=False)
    assert "flops_per_device" not in rec
    assert rec["cost_method"].startswith("none")


# ---------------------------------------------------------------------------
# (f) the stand-ins


def _counted(fn, *args):
    mode = dryrun._collective_bytes_mode()
    with mode:
        out = fn(*args)
    return (mode.flops, mode.matmul_flops, mode.moved), out


def _inputs(shapes, grad, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(s, generator=g, requires_grad=r)
            for s, r in zip(shapes, grad)]


@pytest.mark.parametrize("B,S,H,K", ((2, 3, 4, 5), (3, 6, 2, 4), (1, 5, 3, 2)))
def test_rwkv_stand_in_counts_the_recurrence(B, S, H, K):
    x = _inputs([(B, S, H, K)] * 4 + [(H, K)], [True] * 5)
    fwd, (out, _) = _counted(rwkv_scan_plain, *x)
    gout = torch.rand(B, S, H, K)
    bwd, _ = _counted(lambda: torch.autograd.grad(out, x, gout))
    assert plain_cost(*x, needs=(True,) * 5) == (fwd, bwd)
    with torch.no_grad():
        fwd0, _ = _counted(rwkv_scan_plain, *x)
    assert plain_cost(*x) == (fwd0, (0, 0, 0))
    # the dry run's stand-in is charged the formula, its own ops not
    meta = [t.detach().to("meta").requires_grad_() for t in x]
    charged, (mout, _) = _counted(_meta_scan, *meta)
    assert charged == fwd
    back, _ = _counted(lambda: torch.autograd.grad(
        mout, meta, torch.empty_like(mout)))
    assert back == bwd


@pytest.mark.parametrize("B,S,d,n,chunk", (
    (2, 3, 5, 4, 256), (2, 10, 3, 2, 4), (3, 9, 2, 3, 4), (1, 7, 3, 2, 3)))
def test_mamba_stand_in_counts_the_scan(B, S, d, n, chunk, monkeypatch):
    monkeypatch.setattr(ssm, "SCAN_CHUNK", chunk)
    x = _inputs([(B, S, d), (B, S, d), (B, S, n), (B, S, n), (d, n)],
                [True] * 5)
    h = torch.zeros(B, d, n)
    fwd, (y, _) = _counted(ssm._selective_scan, *x, h)
    gy = torch.rand(B, S, d)
    bwd, _ = _counted(lambda: torch.autograd.grad(y, x, gy))
    needs = (True,) * 5 + (False,)
    assert ssm.selective_scan_cost(*x, h, needs=needs) == (fwd, bwd)
    with torch.no_grad():
        fwd0, _ = _counted(ssm._selective_scan, *x, h)
    assert ssm.selective_scan_cost(*x, h) == (fwd0, (0, 0, 0))
    meta = [t.detach().to("meta").requires_grad_() for t in x]
    charged, (my, _) = _counted(ssm._meta_selective_scan, *meta,
                                h.to("meta"))
    assert charged == fwd
    back, _ = _counted(lambda: torch.autograd.grad(
        my, meta, torch.empty_like(my)))
    assert back == bwd


def test_stand_in_refuses_a_backward_it_does_not_count():
    x = [t.to("meta") for t in _inputs([(2, 3, 4, 5)] * 4 + [(4, 5)],
                                       [False] * 5)]
    x[0].requires_grad_()
    with pytest.raises(NotImplementedError):
        _meta_scan(*x)
    assert _shards.COSTS == {"modes": [], "quiet": 0}


# ---------------------------------------------------------------------------
# the readings of (a), (b) and (c), for tools/plant_faults.py


def readings():
    """{check: (reading, within its limit)}: (a) each family's train step's
    matmul FLOPs a device over ``step_flops`` on 1×1 (exactly 1); (b) each
    case's ``flops_per_device`` over XLA's on 2×2 (within ``FLOP_RATIO`` of
    1); (c) the hand-counted layer's FLOPs and bytes over the dry run's
    (exactly 1)."""
    out = {}
    for family in sorted(FAMILIES):
        cfg = get_config(FAMILIES[family], reduced=True)
        got = _record(family, "train_4k")["cost"]["matmul_flops"]
        r = got / dryrun.step_record(cfg, "train_4k")["step_flops"]
        out[f"a/{family}"] = (r, r == 1)
    ref, port = _reference(), _port_2x2()
    for case in CASES:
        r = port[case]["cost"]["flops"] / ref[case]["flops"]
        out[f"b/{case}"] = (r, abs(r - 1) <= FLOP_RATIO)
    run, flops, nbytes, _, _ = _hand_counted()
    out["c/flops"] = (run["cost"]["flops"] / flops,
                      run["cost"]["flops"] == flops)
    out["c/bytes"] = (run["cost"]["bytes"] / nbytes,
                      run["cost"]["bytes"] == nbytes)
    return out
