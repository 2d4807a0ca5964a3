"""The benchmark's weights, made on the device from the seed.

Each layer, and the weights outside the layers, has a generator of its
own (``torch.Generator(device)`` seeded from the run's seed and the
layer), and every weight is drawn in the dtype it is served in by one
``normal_`` call. So any layer can be made again alone, with the same
bits: the reference makes each again, layer by layer, once the program's
state is freed, and takes nothing the program holds.

The layout is the family's (``arch`` below: the module
``gpubench/arch/<family>.py``, whose ``layer_shapes(a, i)`` gives layer
``i``'s weights and ``global_shapes(a)`` the rest), which the reference
reads as it is; :func:`load_port` copies the weights into the port's
parameters under the family's ``port_name``.
"""
from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _seed(seed: int, part: int) -> int:
    return (int(seed) * 1_000_003 + part * 7_919 + 17) % (2 ** 63)


def _draw(shape, std, dt, gen, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype(dt), device=device)
    return t.fill_(1.0) if std is None else t.normal_(0.0, std, generator=gen)


def layer(arch, a, seed: int, i: int, device):
    """Yield (name, tensor) of layer ``i``'s weights, made from ``seed``."""
    gen = torch.Generator(device).manual_seed(_seed(seed, i + 1))
    for name, (shape, fan_in, dt) in arch.layer_shapes(a, i).items():
        std = None if fan_in is None else fan_in ** -0.5
        yield name, _draw(shape, std, dt, gen, device)


def outer(arch, a, seed: int, device):
    """Yield (name, tensor) of the embedding, the final norm and the head."""
    gen = torch.Generator(device).manual_seed(_seed(seed, 0))
    for name, (shape, std, dt) in arch.global_shapes(a).items():
        yield name, _draw(shape, std, dt, gen, device)


def every(arch, a, seed: int, device):
    """Yield (benchmark name, tensor) of every weight, one at a time:
    those outside the layers, then layer by layer as ``blocks.<i>.<name>``."""
    for name, t in outer(arch, a, seed, device):
        yield name, t
    for i in range(a.n_layers):
        for name, t in layer(arch, a, seed, i, device):
            yield f"blocks.{i}.{name}", t


def names(arch, a):
    """Yield the benchmark name of every weight, in :func:`every`'s
    order, drawing none."""
    yield from arch.global_shapes(a)
    for i in range(a.n_layers):
        for name in arch.layer_shapes(a, i):
            yield f"blocks.{i}.{name}"


@torch.no_grad()
def load_port(params: dict, arch, a, seed: int, device) -> None:
    """Fill the port's parameters (name -> tensor) with the seed's
    weights, each under its ``arch.port_name``."""
    names = set(params)
    for name, t in every(arch, a, seed, device):
        port = arch.port_name(name)
        if port not in params:
            raise KeyError(f"{name}: the port has no parameter {port!r}")
        if params[port].shape != t.shape:
            raise ValueError(f"{port}: the port's {tuple(params[port].shape)}"
                             f" is not the source's {tuple(t.shape)}")
        params[port].copy_(t)
        names.discard(port)
        del t
    if names:
        raise KeyError(f"port parameters the benchmark does not make: "
                       f"{sorted(names)[:5]}")
