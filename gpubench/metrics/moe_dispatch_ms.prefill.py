"""Device ms a traced prefill batch spends in the MoE layers outside the
expert products: the program's spans ``repro_torch.moe`` less
``repro_torch.moe.experts`` (route, slots, pack and combine)."""
from gpubench.metrics._spans import PREFILL, ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, PREFILL, "repro_torch.moe",
                       less="repro_torch.moe.experts")
