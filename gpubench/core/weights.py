"""The benchmark's weights, made on the device from the seed.

Each layer, and the weights outside the layers, has a generator of its
own (``torch.Generator(device)`` seeded from the run's seed and the
layer), and every weight is drawn in the dtype it is served in by one
``normal_`` call. So any layer can be made again alone, with the same
bits: the reference makes each again, layer by layer, once the program's
state is freed, and takes nothing the program holds.

The layout is the reference's (``arch.layer_shapes``), which is the
port's where it runs the source's heads unpadded: :func:`load_port`
copies the weights into the port's parameters.
"""
from __future__ import annotations

import torch

from .arch import Arch, global_shapes, layer_shapes

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _seed(seed: int, part: int) -> int:
    return (int(seed) * 1_000_003 + part * 7_919 + 17) % (2 ** 63)


def _draw(shape, std, dt, gen, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype(dt), device=device)
    return t.fill_(1.0) if std is None else t.normal_(0.0, std, generator=gen)


def layer(a: Arch, seed: int, i: int, device):
    """Yield (name, tensor) of layer ``i``'s weights, made from ``seed``."""
    gen = torch.Generator(device).manual_seed(_seed(seed, i + 1))
    for name, (shape, fan_in, dt) in layer_shapes(a).items():
        std = None if fan_in is None else fan_in ** -0.5
        yield name, _draw(shape, std, dt, gen, device)


def outer(a: Arch, seed: int, device):
    """Yield (name, tensor) of the embedding, the final norm and the head."""
    gen = torch.Generator(device).manual_seed(_seed(seed, 0))
    for name, (shape, std, dt) in global_shapes(a).items():
        yield name, _draw(shape, std, dt, gen, device)


def every(a: Arch, seed: int, device):
    """Yield (port name, tensor) of every weight, one at a time."""
    for name, t in outer(a, seed, device):
        yield name, t
    for i in range(a.n_layers):
        for name, t in layer(a, seed, i, device):
            yield f"blocks.{i}.{name}", t


@torch.no_grad()
def load_port(params: dict, a: Arch, seed: int, device) -> None:
    """Fill the port's parameters (name -> tensor) with the seed's
    weights."""
    names = set(params)
    for name, t in every(a, seed, device):
        if params[name].shape != t.shape:
            raise ValueError(f"{name}: the port's {tuple(params[name].shape)}"
                             f" is not the source's {tuple(t.shape)}")
        params[name].copy_(t)
        names.discard(name)
        del t
    if names:
        raise KeyError(f"port parameters the benchmark does not make: "
                       f"{sorted(names)[:5]}")
