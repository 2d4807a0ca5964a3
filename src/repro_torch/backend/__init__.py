"""Pluggable array backends for the scheduling hot path.

The scheduling stack (``data/traces.py`` synthesis, ``core/selection.py``
solvers) calls array math through an :class:`ArrayBackend` instead of
``np.*`` directly. ``get_backend("cuda")`` — also the default, and
also named ``"torch"`` — returns the device backend: PyTorch ops with
device-resident fleet columns and reach state, and the hand-written
CUDA counter-hash kernels for the synthesis grids. It builds on
``cuda:0`` and raises when CUDA is absent. ``get_backend("numpy")``
returns the bit-exact host reference, for a caller that asks for it; a
caller that wants the device path on the CPU passes an instance, e.g.
``RunSection(backend=CudaBackend(device="cpu"))``. The parity contract
between them is documented in :mod:`repro_torch.backend.base`;
selection is surfaced as the ``backend=`` knob on
:class:`repro_torch.core.experiment.RunSection`.

Backends are process-wide singletons per name, so repeated
``get_backend`` calls return the same object.
"""
from __future__ import annotations

from typing import Dict

from .base import ArrayBackend
from .numpy_backend import NumpyBackend

__all__ = ["ArrayBackend", "NumpyBackend", "get_backend",
           "available_backends"]

_SINGLETONS: Dict[str, ArrayBackend] = {}


def available_backends():
    """Names ``get_backend`` accepts."""
    return ("cuda", "numpy", "torch")


def get_backend(spec=None) -> ArrayBackend:
    """Resolve ``spec`` to a backend singleton.

    ``spec`` may be ``None`` (→ cuda), a backend name, or an
    :class:`ArrayBackend` instance (returned as-is, so already-resolved
    backends thread through dataclasses unchanged). ``"torch"`` names
    the same singleton as ``"cuda"``.
    """
    if isinstance(spec, ArrayBackend):
        return spec
    name = "cuda" if spec is None else str(spec).lower()
    if name == "torch":
        name = "cuda"
    got = _SINGLETONS.get(name)
    if got is not None:
        return got
    if name == "numpy":
        bk: ArrayBackend = NumpyBackend()
    elif name == "cuda":
        from .cuda_backend import CudaBackend
        bk = CudaBackend()
    else:
        raise KeyError(
            f"unknown array backend {name!r}; available: "
            f"{', '.join(available_backends())}")
    _SINGLETONS[name] = bk
    return bk
