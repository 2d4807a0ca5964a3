"""Helpers the metric readers share (this file is no metric: a metric's
file is named after it)."""
from __future__ import annotations


def mfu(ctx):
    """Model FLOPs of the traced units over (traced window x bf16 peak), in
    percent; None where no unit was traced."""
    if not ctx["units"]:
        return None
    flops = sum(u["flops"] for u in ctx["units"])
    return 100.0 * flops / (ctx["trace"]["window_s"]
                            * ctx["peaks"]["bf16_flops"])


def roofline(ctx, kernel: str, work: str):
    """The least time for the traced units' launches of ``work`` over the
    summed device time of the kernels whose name holds ``kernel``, in
    percent; None where no such kernel ran."""
    from gpubench.counts.work import least_seconds
    spent = sum(t for n, t in ctx["trace"]["kernels"] if kernel in n)
    if spent <= 0:
        return None
    launches = [x for u in ctx["units"] for x in u.get(work, [])]
    return 100.0 * least_seconds(launches, ctx["peaks"]) / spent


def idle(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
