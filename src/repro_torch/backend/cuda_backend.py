"""The ``"cuda"`` backend: the registry's name for the device path.

:class:`~.torch_backend.TorchBackend` already sends ``synth_window`` and
``forecast_noise_z`` to the hand-written CUDA kernels, so this class
adds nothing but its name; ``get_backend("torch")`` returns the same
singleton as ``get_backend("cuda")``.
"""
from __future__ import annotations

from .torch_backend import TorchBackend


class CudaBackend(TorchBackend):
    name = "cuda"
