"""Meshes: the production meshes as shapes, and device meshes over the
process group.

``make_production_mesh`` gives the reference's meshes (``(16, 16)`` over
``("data", "model")``, or ``(2, 16, 16)`` over ``("pod", "data",
"model")``) as a :class:`~repro_torch.sharding.MeshShape`, for the
accounting that needs no devices (the specs, the state bytes); the dry run
builds them as device meshes over a fake process group of 256 or 512
ranks. :func:`make_mesh` is a ``DeviceMesh`` of any shape over the process
group that exists (one device per rank: nccl on cuda, gloo on the CPU).
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding import MeshShape, make_abstract_mesh


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)


def start_group(device) -> bool:
    """Start a process group of world size 1 on an in-process store (nccl
    on cuda, gloo otherwise) unless one exists; whether it started one
    (the caller then ends it with ``torch.distributed
    .destroy_process_group``)."""
    if dist.is_initialized():
        return False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return True


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` over the named ``axes`` on the ranks
    of the process group, rank ``r`` at row-major position ``r``; each rank
    uses ``device`` (``cuda:0`` by default; under ``torchrun``, the card
    of its local rank). The product of ``shape`` must be the group's size. Without a
    process group (one process), a group of one is started first."""
    from torch.distributed.device_mesh import init_device_mesh
    device = resolve_device(device)
    start_group(device)
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                         f"{math.prod(shape)} ranks; the process group has {n}")
    if device.type == "cuda":
        # one card a rank: the one torchrun's LOCAL_RANK names, else the
        # device asked for
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else device.index or 0)
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(axes))
