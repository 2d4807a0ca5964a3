"""Meshes: the production meshes as shapes, and the one-card host mesh.

``make_production_mesh`` gives the reference's meshes (``(16, 16)`` over
``("data", "model")``, or ``(2, 16, 16)`` over ``("pod", "data",
"model")``) as a :class:`~repro_torch.sharding.MeshShape`: one card cannot
build a 256-device mesh, so only the accounting (the dry run, the specs)
reads them. ``make_host_mesh`` is the 1×1 ``DeviceMesh`` with the
production axis names that the train driver runs on.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(axes, shape)


def make_host_mesh(device=None):
    """A 1×1 ``DeviceMesh`` over ``("data", "model")`` on ``device``
    (``cuda:0`` by default). Without a process group it starts one of
    world size 1 on an in-process store: nccl on cuda, gloo on the CPU;
    the caller ends it with ``torch.distributed.destroy_process_group``."""
    from torch.distributed.device_mesh import init_device_mesh
    device = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"the host mesh is one device; the process group "
                           f"has {dist.get_world_size()}")
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    return init_device_mesh(device.type, (1, 1),
                            mesh_dim_names=("data", "model"))
