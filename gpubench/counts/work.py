"""What every family's counts share: the query-key pairs a causal mask
keeps, the bytes of a dtype, and the least time the card could take for
counted launches (the roofline readers in ``metrics/`` take it)."""
from __future__ import annotations

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def kept_pairs(S: int, window: int = 0) -> int:
    """Query-key pairs a causal mask keeps in a sequence of S (within a
    window of ``window`` keys where it is > 0)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    w = window
    return w * (w + 1) // 2 + (S - w) * w


def least_seconds(launches, peaks: dict) -> float:
    """The least time the card could take for the launches: per launch the
    larger of operations over the bf16 peak and bytes over HBM's."""
    return sum(max(ops / peaks["bf16_flops"], b / peaks["hbm_bytes_per_s"])
               for ops, b in launches)
