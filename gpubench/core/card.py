"""The card a run measures, and what a run may not have loaded.

A run needs as many CUDA devices as its cell asks for and never falls
back to the CPU. Every result names the card, its count and its power
limit (``nvidia-smi``). Once the window has closed, the process that
prints the result may hold none of the JAX package's modules: the port
is measured alone.
"""
from __future__ import annotations

import gc
import os
import subprocess
import sys
import time

# top-level module names a run may not load, compared whole ("repro_torch"
# is the port and is allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start on the ``time.time()`` clock, from ``/proc``
    where it exists (so set-up counts the interpreter's start), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.time()


class NoCard(RuntimeError):
    pass


def require(chips: int) -> None:
    """Raise :class:`NoCard` unless ``chips`` CUDA devices are visible."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: gpubench measures the port on an "
                     "NVIDIA GPU and does not fall back to the CPU")
    n = torch.cuda.device_count()
    if n < chips:
        raise NoCard(f"the cell asks for {chips} CUDA devices; {n} visible")


def power_limit_w() -> float | None:
    """The first card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_line(device, chips: int) -> dict:
    """The result's ``device``: platform, the card's name, the cards used
    and the peak of allocated memory on the fullest."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips)),
            "power_limit_w": power_limit_w()}


def sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Return the freed program state's memory to the card."""
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def forbidden_loaded() -> list[str]:
    """The forbidden top-level names in ``sys.modules``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
