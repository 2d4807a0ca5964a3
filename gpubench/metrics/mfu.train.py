"""Model FLOPs of the traced training steps over the traced window at the
card's bf16 peak, in percent (``counts/<family>.py`` counts them)."""
from gpubench.metrics._share import mfu


def read(ctx):
    return mfu(ctx)
