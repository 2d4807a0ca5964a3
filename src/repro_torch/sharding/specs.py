"""Partition specs for parameters, optimizer state and step inputs, and
their DTensor placements.

A copy of ``repro/sharding/specs.py``. The baseline strategy, "tp_fsdp":
  * tensor-parallel over the ``model`` axis: attention heads, FFN hidden,
    MoE experts (expert-parallel when E divides the axis, otherwise the
    expert hidden dim is tensor-parallel, e.g. Mixtral's 8 experts on a
    16-wide axis), vocab/lm-head;
  * FSDP (ZeRO-3 style) over the ``data`` axis on a second dimension of
    every large tensor;
  * the ``pod`` axis (multi-pod mesh) extends data parallelism.

Every rule is divisibility-guarded: if a dim does not divide the axis, the
next alternative dim is tried, else the axis is dropped (replicated); on a
1×1 mesh every tensor is replicated. ``STRATEGIES`` carries the variants.

A spec is a :class:`PartitionSpec`, a tuple with one entry per dim:
``None``, an axis name, or a tuple of axis names (the entries of JAX's
``PartitionSpec``). A mesh is a :class:`MeshShape` (axis names and sizes,
no devices: the production meshes of ``launch.mesh``) or a
``torch.distributed`` ``DeviceMesh`` with named dims. Trees are dicts,
lists and tuples (named tuples too); a dict key names its subtree, as a
JAX ``DictKey`` does. :func:`tree_placements` turns specs into DTensor
placements. The rules index dims of the reference's *stacked* block
tensors [L, ...]; :func:`port_param_specs` gives the port's per-layer
tensors the stacked spec without its leading ``L`` entry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models.common import spec_placements
from repro_torch.models.convert import (from_reference_layout,
                                        layer_counts, params_to_reference)
from repro_torch.tree import leaves_with_path, map_with_path


class PartitionSpec(tuple):
    """One entry per dim of a tensor: ``None`` (replicated), an axis name,
    or a tuple of axis names (sharded over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind it."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.axis_names) == len(self.axis_sizes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))


def make_abstract_mesh(axis_sizes, axis_names) -> MeshShape:
    """The reference's ``make_abstract_mesh``: a mesh's axis sizes and
    names with no devices behind it, for the specs and the accounting."""
    assert len(axis_sizes) == len(axis_names)
    return MeshShape(tuple(axis_names), tuple(axis_sizes))


def mesh_shape(mesh) -> MeshShape:
    """``mesh`` as a :class:`MeshShape`; a ``DeviceMesh`` by its dim names
    and sizes."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).shape.get(name, 1)


def _data_axes(mesh):
    """data-parallel axes: ('pod','data') on the multi-pod mesh."""
    names = mesh_shape(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


# rule table: leaf-name (+ndim) -> list of (dim, axis-role) preferences.
# axis-role: "model" = TP axis, "data" = FSDP axis. dim indices refer to the
# STACKED tensor (leading L axis for block params). Alternatives for the
# same role are tried left to right.
def _rules(name: str, ndim: int, parent: str) -> List[Tuple[str, List[int]]]:
    if name == "embed":
        return [("model", [0]), ("data", [1])]
    if name == "lm_head":
        return [("model", [1, 0]), ("data", [0])]
    if parent in ("attn", "xattn"):
        if name == "wq":
            return [("model", [2]), ("data", [1])]
        if name in ("wk", "wv"):
            return [("model", [2]), ("data", [1])]
        if name == "wo":
            return [("model", [1]), ("data", [3])]
    if parent == "moe":
        if name == "router":
            return [("data", [1])]
        if name in ("w1", "w3"):       # [L, E, d, f]
            return [("model", [1, 3]), ("data", [2])]
        if name == "w2":               # [L, E, f, d]
            return [("model", [1, 2]), ("data", [3])]
        if name in ("shared_w1", "shared_w3"):
            return [("model", [2]), ("data", [1])]
        if name == "shared_w2":
            return [("model", [1]), ("data", [2])]
    if parent == "ffn" or (parent == "cm" and name in ("wk", "wv")):
        if name in ("w1", "w3", "wk"):  # [L, d, f]
            return [("model", [2]), ("data", [1])]
        if name in ("w2", "wv"):        # [L, f, d]
            return [("model", [1]), ("data", [2])]
    if parent == "tm":  # rwkv time mix
        if name in ("wr", "wk", "wv", "wg"):
            return [("model", [2]), ("data", [1])]
        if name == "wo":
            return [("model", [1]), ("data", [2])]
        if name in ("shift_lora_a", "w_lora_a"):
            return [("data", [1])]
        if name == "shift_lora_b":
            return [("data", [3])]
        if name == "w_lora_b":
            return [("data", [2])]
    if parent == "mamba":
        if name in ("in_proj", "w_bc"):
            return [("data", [1])]
        if name in ("out_proj",):
            return [("data", [2])]
    return []  # norms, scalars, small vectors, LSTM cells: replicated


def _map(fn, tree):
    """``fn(path, leaf)`` over a tree whose leaves are tensors or specs."""
    return map_with_path(fn, tree,
                         is_leaf=lambda x: isinstance(x, PartitionSpec))


def _leaves(tree):
    return [leaf for _, leaf in leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def leaf_spec(path, leaf, mesh, fsdp: bool = True, tp: bool = True,
              fsdp_in_pod: bool = False) -> PartitionSpec:
    names = [p for p in path if isinstance(p, str)]
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    shape = tuple(leaf.shape)
    assign: Dict[int, object] = {}
    data_axes = _data_axes(mesh)
    if fsdp_in_pod:
        # keep the ZeRO-3 gather inside a pod: params replicated across the
        # (slower, inter-pod) 'pod' axis, sharded over 'data' only
        data_axes = tuple(a for a in data_axes if a != "pod")
    data_sz = int(np.prod([_axis_size(mesh, a) for a in data_axes]))
    model_sz = _axis_size(mesh, "model")
    for role, dims in _rules(name, len(shape), parent):
        if role == "model" and not tp:
            continue
        if role == "data" and not fsdp:
            continue
        size = model_sz if role == "model" else data_sz
        axis_val = "model" if role == "model" else (
            data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None))
        if size <= 1 or axis_val is None:
            continue
        for d in dims:
            if d in assign:
                continue
            if shape[d] % size == 0:
                assign[d] = axis_val
                break
    return P(*[assign.get(d) for d in range(len(shape))])


def param_specs(params_struct, mesh, fsdp: bool = True, tp: bool = True,
                fsdp_in_pod: bool = False, **_ignored):
    """Tree of specs matching ``params_struct`` (a tree in the reference's
    layout of anything with a ``shape``: parameters, or an optimizer
    state, whose subtrees mirror parameter paths)."""
    return _map(lambda path, leaf: leaf_spec(path, leaf, mesh, fsdp, tp,
                                             fsdp_in_pod), params_struct)


def port_param_specs(state: dict, mesh, **strategy) -> dict:
    """Specs of the port's parameters (a dict of ``DecoderLM`` or
    ``EncDecLM`` names) or of its optimizer state (``{"step", "m", "v"}``
    or ``{"step", "mu"}``, each moment such a dict), keyed as ``state``.
    They are computed on the reference's stacked layout
    (:func:`params_to_reference`, on the meta device); a per-layer tensor
    (``blocks.{i}.…``, ``enc_blocks.{i}.…``, ``dec_blocks.{i}.…``) takes
    the stacked spec without its ``L`` entry, which the rules never
    shard."""
    def named(sd):
        meta = {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                for n, t in sd.items()}
        specs = param_specs(params_to_reference(meta), mesh, **strategy)
        return from_reference_layout(specs, layer_counts(sd), _layer_spec)

    # the rules read a leaf's name and its parent's, never a moment's key
    if not any(isinstance(v, dict) for v in state.values()):
        return named(state)
    return {k: named(v) if isinstance(v, dict)
            else param_specs({k: v}, mesh, **strategy)[k]
            for k, v in state.items()}


def _layer_spec(spec: PartitionSpec, layer):
    if layer is None:
        return spec
    if spec[0] is not None:
        raise AssertionError(f"a rule shards the layer dim: {spec}")
    return P(*spec[1:])


# ---------------------------------------------------------------------------
# step-input shardings


def batch_specs(batch_struct, mesh):
    """Training batch: shard the leading (global batch) dim over pod+data."""
    data_axes = _data_axes(mesh)
    ax = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)
    sz = int(np.prod([_axis_size(mesh, a) for a in data_axes]))

    def one(path, leaf):
        ndim = len(leaf.shape)
        b = leaf.shape[0] if ndim else 1
        if ndim and sz > 1 and b % sz == 0:
            return P(ax, *([None] * (ndim - 1)))
        return P(*([None] * ndim))

    return _map(one, batch_struct)


def cache_specs(cache_struct, mesh, seq_over_model: bool = False):
    """Decode cache: batch dim over pod+data when divisible, else the
    sequence/window dim (long-context batch=1); KV heads replicated.

    ``seq_over_model=True`` additionally shards the cache sequence dim over
    the model axis (flash-decode style partial attention)."""
    data_axes = _data_axes(mesh)
    ax = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)
    sz = int(np.prod([_axis_size(mesh, a) for a in data_axes]))
    model_sz = _axis_size(mesh, "model")

    def one(path, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        spec = [None] * ndim
        if sz <= 1 or ax is None or ndim < 2:
            return P(*spec)
        # stacked caches: dim0 = L (or scalar length), dim1 = batch
        b_dim = 1
        if ndim > b_dim and shape[b_dim] % sz == 0:
            spec[b_dim] = ax
            if (seq_over_model and ndim >= 3 and model_sz > 1
                    and shape[2] % model_sz == 0 and shape[2] >= 1024):
                spec[2] = "model"
        elif ndim >= 3 and shape[2] % sz == 0:
            spec[2] = ax  # sequence/window dim
        return P(*spec)

    return _map(one, cache_struct)


def tree_placements(spec_tree, mesh):
    """Each spec of ``spec_tree`` as DTensor placements on ``mesh``, one
    per mesh dim: ``Shard(d)`` where tensor dim ``d``'s entry names that
    axis, else ``Replicate()``."""
    return _map(lambda _, spec: spec_placements(spec, mesh), spec_tree)


def step_placements(kind: str, mesh, strategy: str = "tp_fsdp", *,
                    params=None, opt_state=None, batch=None, tokens=None,
                    cache=None, frames=None, frontend_embeds=None,
                    enc_kv=None) -> dict:
    """The in- and out-placements of a step on ``mesh`` under
    ``strategy``, as the reference's ``jax.jit`` of it takes them
    (``in_shardings``, ``out_shardings`` of its ``tree_shardings``):
    ``{"in": (...), "out": (...)}`` of placements trees. ``params``,
    ``opt_state`` (the port's names), ``batch``, ``tokens``, ``cache``,
    an encoder-decoder's ``frames`` and ``enc_kv`` and a vlm's
    ``frontend_embeds`` are anything with shapes; one left out has
    ``None`` in its places.

    * train: in (params, opt_state, batch), out (params, opt_state, the
      loss replicated);
    * prefill: in (params, tokens, frontend_embeds), each input under
      ``batch_specs``, out (the logits replicated, the cache of
      ``cache_specs``; its sequence over ``model`` unless the strategy
      says otherwise). Given ``frames`` (an encoder-decoder's prefill:
      the encoder, then the cross attention's K/V), in (params, frames),
      and out the placements of ``enc_kv`` that decode takes in: the
      reference's jit of this step states no ``out_shardings``, so the
      port states these;
    * decode: in (params, cache, tokens, enc_kv), out (the logits
      replicated, the cache). ``enc_kv``, an encoder-decoder's cross K/V,
      is placed by ``cache_specs`` without the sequence over ``model``
      (the reference's "cross-KV: batch only")."""
    skw = STRATEGIES[strategy]

    def placed(tree, specs):
        return None if tree is None else tree_placements(specs(tree), mesh)

    def state(tree):
        return port_param_specs(tree, mesh, **skw)

    def batched(tree):
        return placed(tree, lambda b: batch_specs(b, mesh))

    pl = placed(params, state)
    rep = spec_placements(P(), mesh)
    if kind == "train":
        ol = placed(opt_state, state)
        return {"in": (pl, ol, batched(batch)), "out": (pl, ol, rep)}
    cl = placed(cache, lambda c: cache_specs(
        c, mesh, seq_over_model=skw.get("seq_over_model", True)))
    el = placed(enc_kv, lambda e: cache_specs(e, mesh))
    if kind == "prefill":
        if frames is not None:
            return {"in": (pl, batched(frames)), "out": el}
        return {"in": (pl, batched(tokens), batched(frontend_embeds)),
                "out": (rep, cl)}
    return {"in": (pl, cl, batched(tokens), el), "out": (rep, cl)}


def sharded_bytes(struct, spec_tree, mesh) -> int:
    """Analytic per-device bytes of a sharded tree (the reference dry-run's
    ``_sharded_bytes``)."""
    def leaf_bytes(leaf, spec):
        n = int(np.prod(leaf.shape)) if len(leaf.shape) else 1
        denom = 1
        for entry in spec:
            if entry is None:
                continue
            for a in entry if isinstance(entry, tuple) else (entry,):
                denom *= _axis_size(mesh, a)
        return n * leaf.dtype.itemsize // max(denom, 1)

    return sum(leaf_bytes(l, s)
               for l, s in zip(_leaves(struct), _leaves(spec_tree)))


STRATEGIES = {
    # baseline
    "tp_fsdp": dict(fsdp=True, tp=True),
    # variants
    "tp_only": dict(fsdp=False, tp=True),          # params resident (decode)
    "fsdp_only": dict(fsdp=True, tp=False),
    "tp_fsdp_inpod": dict(fsdp=True, tp=True, fsdp_in_pod=True),
    "tp_fsdp_seqkv": dict(fsdp=True, tp=True, seq_over_model=True),
    "tp_only_seqkv": dict(fsdp=False, tp=True, seq_over_model=True),
    "tp_fsdp_flatkv": dict(fsdp=True, tp=True, seq_over_model=False),
}
