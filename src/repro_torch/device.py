"""Where the port's work runs: on ``cuda:0`` unless the caller names another
device, and never quietly on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None,
                   hint: str = 'pass device="cpu" to run on the CPU'
                   ) -> torch.device:
    """``device``, or ``cuda:0`` for ``None``. A CUDA device on a host
    without CUDA raises ``RuntimeError``, which ends with ``hint`` (how the
    caller asks for the CPU): there is no fallback to the CPU."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: this runs on {dev} unless "
                           f"another device is named; {hint}")
    return dev
