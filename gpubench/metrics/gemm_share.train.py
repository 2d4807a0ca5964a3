"""Share of the device's busy time in library GEMM kernels (cuBLAS,
CUTLASS) over the traced training steps, in percent. Which kernel names
count is the list in gemm_kernels.json."""
import json
from pathlib import Path

_NAMES = json.loads(Path(__file__).with_name("gemm_kernels.json").read_text())


def is_gemm(name: str) -> bool:
    low = name.lower()
    return (any(m in low for m in _NAMES["marks"])
            and not any(x in low for x in _NAMES["not"]))


def read(ctx):
    if ctx["trace"]["busy_s"] <= 0:
        return None
    spent = sum(t for n, t in ctx["trace"]["kernels"] if is_gemm(n))
    return 100.0 * spent / ctx["trace"]["busy_s"]
