"""The share of the traced training window in which no device activity
ran: 1 - (union of device intervals) / window, in percent."""
from gpubench.metrics._share import idle


def read(ctx):
    return idle(ctx)
