"""The benchmark's cells cut to sizes a CPU test can run: the same
drivers, references, checks and limits, on tiny widths in float32. The
configuration's tiny sizes are its family's (``arch/<family>.py``'s
``tiny``), the traffic's its driver's (``drivers/<driver>.py``'s
``TINY``)."""
from __future__ import annotations

import copy
import importlib

from gpubench.core import spec


def cell(name: str):
    """The cell ``name`` of BENCHMARK.json at a tiny size."""
    c = copy.deepcopy(spec.cell(name))
    c.config.update(c.family.arch.tiny(c.config))
    driver = importlib.import_module(f"gpubench.drivers.{c.driver}")
    c.traffic.update(driver.TINY)
    return c
