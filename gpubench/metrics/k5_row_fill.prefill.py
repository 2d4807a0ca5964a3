"""The share of K5's rows that hold a token in the traced prefill batches:
the program's counters ``moe.kept`` (routed assignments that hold a
capacity slot) over ``moe.rows`` (the slots the expert products
multiply), in percent, as ``models/moe.py`` counts them."""
from gpubench.metrics._spans import PREFILL, record


def read(ctx):
    rec = record(ctx, PREFILL)
    if rec is None or not rec["counters"].get("moe.rows"):
        return None
    c = rec["counters"]
    return 100.0 * c.get("moe.kept", 0) / c["moe.rows"]
