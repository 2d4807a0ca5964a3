"""Device ms a traced training step spends in the gradients' reduction
onto the parameters' placements (DTensor redistributions, which move no
data on one card's 1x1 mesh): the program's span
``repro_torch.train.reduce``."""
from gpubench.metrics._spans import STEP, ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, STEP, "repro_torch.train.reduce")
