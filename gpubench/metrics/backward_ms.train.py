"""Device ms a traced training step spends in the backward
(``autograd.grad``, remat's recompute included): the program's span
``repro_torch.train.backward``."""
from gpubench.metrics._spans import STEP, ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, STEP, "repro_torch.train.backward")
