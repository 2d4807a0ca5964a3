"""The port's own spans and counters, on the profiler's clock.

Tracing is on only while a ``torch.profiler`` records
(``torch.autograd._profiler_enabled()``). When it is off, :func:`span`
returns one shared null context and :func:`count` returns at once: no
allocation, no clock read, no CUDA call.

When it is on, ``with span(name):`` enters
``torch.profiler.record_function(name)``, so the span is a range on the
trace's host timeline (an idle gap inside it is named after it), and
records in memory:

* its name;
* the id of the top-level call it belongs to: the outermost span open
  when it opened, on any thread (one ``DecoderLM.prefill``, one training
  step);
* its parent, the innermost span open on the same thread;
* its host start and end, from ``time.time_ns()``, the clock of the
  profiler's host events;
* where CUDA is initialised, a pair of CUDA events on the current stream,
  taken from a reused pool: the span's length on the device's timeline,
  idle inside it included. Without CUDA that length is the host
  interval.

The profiler's state is thread-local. Autograd's device threads inherit
it, so a span opened inside a backward (``torch.utils.checkpoint``'s
recompute) records, with no parent of its own thread and the id of the
call that runs the backward. A plain Python thread started under the
profiler sees tracing off and records nothing.

``count(name, value)`` adds an int or a 0-d tensor; tensors are summed
only when read, so counting never waits for the device. :func:`collected`
synchronises once and returns the record; :func:`clear` empties it. The
record grows until it is cleared, and nothing is written to disk: the
profiler's ``export_chrome_trace`` carries the ranges.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import _profiler_enabled

_NULL = contextlib.nullcontext()


class _Entry:
    __slots__ = ("name", "call", "parent", "t0", "t1", "ev0", "ev1")

    def __init__(self, name, call, parent):
        self.name, self.call, self.parent = name, call, parent
        self.t0 = self.t1 = self.ev0 = self.ev1 = None


class Recorder:
    """Spans and counters of one process (the module's functions use
    :data:`RECORD`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: list = []
        self._counts: dict = {}
        self._pool: list = []
        self._open_top = None   # the entry of the open top-level span
        self._calls = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str):
        stack = self._stack()
        with self._lock:
            if stack:
                parent = stack[-1]
                call = self._spans[parent].call
            elif self._open_top is not None:
                parent, call = None, self._open_top.call
            else:
                parent, call = None, self._calls
                self._calls += 1
            entry = _Entry(name, call, parent)
            if parent is None and self._open_top is None:
                self._open_top = entry
            stack.append(len(self._spans))
            self._spans.append(entry)
        return entry

    def _close(self, entry) -> None:
        self._stack().pop()
        if self._open_top is entry:
            self._open_top = None

    def _event(self):
        if not torch.cuda.is_initialized():
            return None
        try:
            ev = self._pool.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def count(self, name: str, value) -> None:
        if not _profiler_enabled():
            return
        stack = self._stack()
        call = (self._spans[stack[-1]].call if stack else
                self._open_top.call if self._open_top is not None else None)
        self._counts.setdefault(name, []).append((call, value))

    def collected(self, calls=None) -> dict:
        """``{"spans": [...], "counters": {name: total}}`` of the closed
        spans and the counts, of the top-level ``calls`` (ids) only where
        given. Each span is a dict: ``name``, ``call``, ``parent`` (an
        index into the list, or None), ``start_ns``, ``end_ns``,
        ``host_ms``, ``device_ms`` and ``self_ms`` (``device_ms`` less
        its children's)."""
        keep = None if calls is None else set(calls)
        entries = [e for e in self._spans if e.t1 is not None
                   and (keep is None or e.call in keep)]
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        index = {id(e): i for i, e in enumerate(entries)}
        out = []
        for e in entries:
            host = (e.t1 - e.t0) / 1e6
            dev = e.ev0.elapsed_time(e.ev1) if e.ev0 is not None else host
            parent = (None if e.parent is None
                      else index.get(id(self._spans[e.parent])))
            out.append({"name": e.name, "call": e.call, "parent": parent,
                        "start_ns": e.t0, "end_ns": e.t1, "host_ms": host,
                        "device_ms": dev, "self_ms": dev})
        for s in out:
            if s["parent"] is not None:
                out[s["parent"]]["self_ms"] -= s["device_ms"]
        counters = {}
        for name, values in self._counts.items():
            picked = [v for c, v in values if keep is None or c in keep]
            if picked:
                counters[name] = sum(int(v) for v in picked)
        return {"spans": out, "counters": counters}

    def clear(self) -> None:
        """Empty the record; its CUDA events go back to the pool."""
        with self._lock:
            for e in self._spans:
                self._pool += [v for v in (e.ev0, e.ev1) if v is not None]
            self._spans, self._counts = [], {}


class _Span:
    __slots__ = ("rec", "name", "entry", "rf")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.entry = e = self.rec._open(self.name)
        e.t0 = time.time_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        e.ev0 = self.rec._event()
        return self

    def __exit__(self, *exc):
        e = self.entry
        if e.ev0 is not None:
            e.ev1 = self.rec._event()
        self.rf.__exit__(*exc)
        e.t1 = time.time_ns()
        self.rec._close(e)
        return False


RECORD = Recorder()


def enabled() -> bool:
    """Whether spans and counts record (a profiler is recording)."""
    return _profiler_enabled()


def span(name: str):
    """A context that records ``name`` while tracing is on, and the shared
    null context otherwise."""
    if not _profiler_enabled():
        return _NULL
    return _Span(RECORD, name)


def count(name: str, value) -> None:
    """Add ``value`` (an int or a 0-d tensor) to counter ``name`` while
    tracing is on."""
    RECORD.count(name, value)


def collected(calls=None) -> dict:
    """The record (:meth:`Recorder.collected`)."""
    return RECORD.collected(calls)


def clear() -> None:
    """Empty the record."""
    RECORD.clear()
