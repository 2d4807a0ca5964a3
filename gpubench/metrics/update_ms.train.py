"""Device ms a traced training step spends in the optimizer's update
(``optim/optimizers.py``): the program's span
``repro_torch.train.update``."""
from gpubench.metrics._spans import STEP, ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, STEP, "repro_torch.train.update")
