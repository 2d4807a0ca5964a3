"""Device ms a traced training step spends in the forward (the leaves and
the loss, ``functional_call``): the program's span
``repro_torch.train.forward``."""
from gpubench.metrics._spans import STEP, ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, STEP, "repro_torch.train.forward")
