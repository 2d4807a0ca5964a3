"""Device ms a traced prefill batch spends in latent attention outside its
contraction: the program's spans ``repro_torch.attention`` less
``repro_torch.attention.core`` (the low-rank projections, their norms,
YaRN, the rope key's broadcast, the latent cache and the output
projection); None where the program records no contraction span."""
from gpubench.metrics._spans import PREFILL, ms_per_unit, record

CORE = "repro_torch.attention.core"


def read(ctx):
    rec = record(ctx, PREFILL)
    if rec is None or not any(s["name"] == CORE for s in rec["spans"]):
        return None
    return ms_per_unit(ctx, PREFILL, "repro_torch.attention", less=CORE)
