"""Device ms a traced prefill batch spends in self attention: the
program's spans ``repro_torch.attention`` (K3, the projections and the
cache's K/V)."""
from gpubench.metrics._spans import PREFILL, ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, PREFILL, "repro_torch.attention")
