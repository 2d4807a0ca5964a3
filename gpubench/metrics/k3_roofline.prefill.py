"""K3's share of its roofline in the traced prefill batches: the least
time for attention's work (the pairs the causal mask keeps) over the
summed device time of ``flash_attention_wgmma_kernel``."""
from gpubench.metrics._share import roofline


def read(ctx):
    return roofline(ctx, "flash_attention_wgmma_kernel", "k3")
