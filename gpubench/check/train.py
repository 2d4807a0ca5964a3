"""The first training steps against the reference's.

``loss_gap``: the largest relative gap between a step's loss and the
reference's. ``grad_gap``: the first gradient (the program's read from
its optimizer state after one step: m / (1 - b1)), leaf by leaf, as the
gap between the two norms over the larger of the reference's norm of
that leaf and of the median leaf; the worst leaf. ``change_gap``: the
same for each leaf's change over the compared steps, leaving out the
leaves whose reference gradient is under a thousandth of the median
leaf's (they move by round-off alone)."""
from __future__ import annotations

import statistics

QUIET = 1e-3


def _worst(prog: dict, ref: dict, names) -> tuple[float, str]:
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def readings(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"loss": [...], "grad_norm": {leaf: x},
    "change": {leaf: x}}."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                       ref["loss"]))
    names = sorted(ref["grad_norm"])
    grad_gap, grad_leaf = _worst(prog["grad_norm"], ref["grad_norm"], names)
    med = statistics.median(ref["grad_norm"][n] for n in names)
    moved = [n for n in names if ref["grad_norm"][n] >= QUIET * med]
    change_gap, change_leaf = _worst(prog["change"], ref["change"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf, "leaves": len(names),
            "moved_leaves": len(moved)}
