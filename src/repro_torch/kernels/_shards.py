"""Kernels and rank-local functions on DTensors: each rank's shard.

On a mesh the model's activations are DTensors. A kernel (or a plain
function that DTensor has no strategy for, such as the MoE layer's
scatter into its capacity buffer) runs on each rank's local tensors
through ``torch.distributed.tensor.experimental.local_map``, with the
placements its inputs already have; the caller states the placements of
its outputs. Nothing here gathers a whole tensor: a placement that the
function cannot take is the caller's to refuse.
"""
from __future__ import annotations

import contextlib

import torch

# the dry run's cost modes that are counting now (launch/dryrun.py), and
# how deep in stand-ins the ops run: a stand-in's own ops are not counted,
# the computation it stands for is charged in their place
COSTS = {"modes": [], "quiet": 0}


@contextlib.contextmanager
def charged(cost, name="stand-in"):
    """Within: the ops run are a stand-in's, not counted by the counting
    cost modes, each of which is charged ``cost`` = (FLOPs, matmul-family
    FLOPs, bytes) once instead, under ``name`` in its breakdown."""
    for mode in COSTS["modes"]:
        mode.charge(*cost, name=name)
    COSTS["quiet"] += 1
    try:
        yield
    finally:
        COSTS["quiet"] -= 1


class _StandIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, costs, *inputs):
        # an output no loss reads gets no zero gradient made for it
        ctx.set_materialize_grads(False)
        ctx.costs = costs
        ctx.label = f"stand-in:{fn.__qualname__}"
        ctx.inputs = [(t.shape, t.dtype, t.device) for t in inputs]
        with charged(costs[0], ctx.label):
            return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        with charged(ctx.costs[1], ctx.label + ".backward"):
            return (None, None) + tuple(
                torch.empty(s, dtype=d, device=dev) if need else None
                for (s, d, dev), need in zip(ctx.inputs,
                                             ctx.needs_input_grad[2:]))


def stand_in(fn, count, *inputs):
    """``fn(*inputs)``: a stand-in's few ops on meta tensors in place of a
    loop over tokens. The cost modes count it as ``count(*inputs,
    needs=...)`` gives the computation it stands for: ((FLOPs, matmul
    FLOPs, bytes) forward, the same backward, for the inputs whose
    gradients autograd takes, ``needs``). Under autograd the backward
    gives each such input an empty gradient of its shape."""
    needs = tuple(torch.is_grad_enabled() and t.requires_grad
                  for t in inputs)
    return _StandIn.apply(fn, count(*inputs, needs=needs), *inputs)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def on_shards(fn, out_placements, *args, grad_placements=None):
    """``fn(*args)`` on each rank's local tensors; a DTensor argument is
    checked against its own placements, a plain tensor or value passes as
    it is. ``out_placements`` as ``local_map`` takes them: one sequence of
    placements, or one per output. ``grad_placements`` (one entry per
    argument, ``None`` for its own placements) states where an argument's
    gradient differs from it, when autograd records: an argument
    replicated over ranks that hold different rows of the others gets a
    partial gradient there."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    if isinstance(out_placements[0], Placement):  # one output
        out_placements = (tuple(out_placements),)
    ins = tuple(a.placements if is_dtensor(a) else None for a in args)
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    kw = {}
    if grad_placements is not None and torch.is_grad_enabled() and any(
            getattr(a, "requires_grad", False) for a in args):
        kw["in_grad_placements"] = tuple(
            g if g is not None else p for g, p in zip(grad_placements, ins))
    return local_map(fn, out_placements=out_placements, in_placements=ins,
                     device_mesh=mesh, **kw)(*args)


def evenly_sharded(name: str, t) -> None:
    """Raise ``ValueError`` unless every sharded dim of DTensor ``t``
    divides its mesh dim (a kernel's shards are then all alike)."""
    from torch.distributed.tensor import Shard
    for axis, size, p in zip(t.device_mesh.mesh_dim_names or (),
                             t.device_mesh.shape, t.placements):
        if isinstance(p, Shard) and t.shape[p.dim] % size:
            raise ValueError(f"{name}: dim {p.dim} ({t.shape[p.dim]}) does "
                             f"not divide mesh axis {axis!r} ({size})")


def refuse(name: str, why: str, *tensors):
    """The ``ValueError`` of a kernel that cannot take its inputs'
    placements on a mesh."""
    shown = ", ".join(f"{tuple(t.shape)} {tuple(t.placements)}"
                      for t in tensors)
    return ValueError(f"{name} on a mesh: {why} (inputs {shown} on axes "
                      f"{tensors[0].device_mesh.mesh_dim_names})")
