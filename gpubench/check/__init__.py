"""The numbers that decide ``correct``: what the program produced in the
timed path, against the plain reference, each held to its limit in
``gpubench/limits/<workload>.json``."""
from __future__ import annotations

import math


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): every number the limits file holds a limit for,
    beside its limit; a number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, spec in limits["numbers"].items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and \
            value <= spec["limit"]
        ok &= good
        checks[name] = {"value": value, "limit": spec["limit"]}
    return ok, checks
