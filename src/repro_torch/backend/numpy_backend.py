"""Reference NumPy backend.

The whole reference implementation lives on :class:`ArrayBackend`
(`base.py`) so accelerated backends inherit exact host behaviour for any
op they do not override; this module gives the reference its registry
name and re-exports the counter-hash primitives for callers that want
the bare functions (``data/traces.py`` and the parity tests).
"""
from __future__ import annotations

from .base import ArrayBackend, cheap_u01, hash64, sm64, u01

__all__ = ["NumpyBackend", "sm64", "hash64", "u01", "cheap_u01"]


class NumpyBackend(ArrayBackend):
    name = "numpy"
