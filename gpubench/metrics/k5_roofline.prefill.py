"""K5's share of its roofline in the traced prefill batches: the least
time for the expert products' work (routed assignments, not capacity
slots) over the summed device time of ``moe_gemm_wide_kernel``."""
from gpubench.metrics._share import roofline


def read(ctx):
    return roofline(ctx, "moe_gemm_wide_kernel", "k5")
