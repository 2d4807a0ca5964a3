"""Device kernels a training step: the kernels in the traced window (no
copy or set) over the traced steps."""


def read(ctx):
    if not ctx["units"]:
        return None
    n = len(ctx["trace"]["kernels"])
    return n / len(ctx["units"]) if n else None
