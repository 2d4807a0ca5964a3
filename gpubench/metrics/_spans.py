"""The program's own record of the traced units, for the readers of its
spans and counters (this file is no metric: a metric's file is named
after it).

The program (``repro_torch.spans``) records its spans and counters while
the profiler records, on the traced run's own clock. A unit of the trace
(a prefill batch, a training step) is one top-level call of the program,
a span named :data:`PREFILL` or :data:`STEP`; the readers take the last
``len(ctx["units"])`` of them. The only module of the harness, besides
the drivers and ``port/<family>.py``, that reaches the program, and only
through :func:`record`, which returns None where the program has no such
module (an older checkout), recorded nothing or fewer calls than units.
"""
from __future__ import annotations

import importlib

PREFILL = "repro_torch.prefill"
STEP = "repro_torch.train.step"


def record(ctx, unit: str):
    """``{"spans": [...], "counters": {...}}`` of the traced units' calls
    of ``unit`` (``repro_torch.spans.collected``), or None."""
    n = len(ctx["units"])
    if not n:
        return None
    try:
        spans = importlib.import_module("repro_torch.spans")
    except ImportError:
        return None
    calls = [s["call"] for s in spans.collected()["spans"]
             if s["name"] == unit and s["parent"] is None]
    if len(calls) < n:
        return None
    return spans.collected(calls[-n:])


def ms_per_unit(ctx, unit: str, name: str, less: str | None = None):
    """The summed device ms of the spans ``name`` (less those of ``less``)
    in the traced units, over the units; None where none was recorded."""
    rec = record(ctx, unit)
    if rec is None:
        return None
    found = [s["device_ms"] for s in rec["spans"] if s["name"] == name]
    if not found:
        return None
    total = sum(found) - sum(s["device_ms"] for s in rec["spans"]
                             if s["name"] == less)
    return total / len(ctx["units"])
