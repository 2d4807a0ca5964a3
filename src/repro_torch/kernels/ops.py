"""Public entry points of the counter-hash kernels and their NumPy
oracles.

``piece_window`` / ``forecast_z`` are the tensor wrappers of
:mod:`.counter_hash` (kernel on a CUDA tensor, plain version on a CPU
tensor). ``piece_window_ref`` / ``forecast_z_ref`` are the ground truth
they are held to: the NumPy counter-hash reference of
:class:`~repro_torch.backend.numpy_backend.NumpyBackend`, on host arrays.
"""
from __future__ import annotations

import numpy as np

from ..backend.numpy_backend import NumpyBackend
from .counter_hash import forecast_z, piece_window

__all__ = ["piece_window", "forecast_z", "piece_window_ref",
           "forecast_z_ref"]


def piece_window_ref(levels, slot, fold, rows, t0, amp) -> np.ndarray:
    """NumPy counter-hash reference for :func:`piece_window`."""
    return NumpyBackend().synth_window(
        np.array(levels, dtype=np.float32), np.asarray(slot, np.int64),
        fold, np.asarray(rows, np.uint64), int(t0), amp)


def forecast_z_ref(fold, rows, now, std) -> np.ndarray:
    """NumPy counter-hash reference for :func:`forecast_z`."""
    std = np.asarray(std, np.float32)
    return NumpyBackend().forecast_noise_z(
        fold, np.asarray(rows, np.uint64), int(now), std.shape[0], std)
