"""The traced run's reading of ``torch.profiler``'s events.

The traced units run under ``torch.profiler.profile`` (host and device
activity) inside one ``record_function`` span, :data:`WINDOW`, that ends
after a device synchronise; its length is the traced window. From the
raw events it takes: every device activity (kernels, copies, sets) with
its start and length, the busy time (the union of their intervals within
the window), and the idle gaps between them, each named by the innermost
host operation running at the gap's middle. Nothing is written to disk.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np

WINDOW = "gpubench.window"
TOP = 10
LABELLED_GAPS = 400
NAME_CHARS = 160  # a kernel's name is cut to this in the breakdown


@contextlib.contextmanager
def profiled():
    """Profile host and device activity; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=False, with_stack=False,
                 profile_memory=False) as prof:
        yield prof


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def _raw(prof):
    """(host events, device events) as lists of (name, start_ns, end_ns)."""
    from torch.autograd import DeviceType
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        row = (e.name(), start, end)
        if e.device_type() == DeviceType.CPU:
            host.append(row)
        else:
            device.append(row)
    return host, device


def is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def summarize(prof) -> dict:
    """The traced window's device activity:

    ``window_s``; ``busy_s`` (the union of device intervals in it);
    ``kernels`` [(name, seconds)] of every kernel in it; ``device_ops``
    the ``TOP`` names by summed device seconds; ``idle_gaps`` the ``TOP``
    host operations by the summed length of the longest gaps
    (``LABELLED_GAPS``) that fell in them."""
    host, device = _raw(prof)
    # a span of record_function has a twin on the device's timeline
    # (gpu_user_annotation) with the host span's name: not device work
    host_names = {n for n, _, _ in host}
    device = [r for r in device if r[0] not in host_names]
    spans = [(s, e) for n, s, e in host if n == WINDOW]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = spans[-1]
    dev = sorted((s, e, n) for n, s, e in device if e > w0 and s < w1)
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, _ in dev:
        s, e = max(s, w0), min(e, w1)
        if cur_e is None:
            if s > w0:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    by_name = defaultdict(float)
    kernels = []
    for s, e, n in dev:
        by_name[n] += (e - s) / 1e9
        if is_kernel(n):
            kernels.append((n, (e - s) / 1e9))
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "kernels": kernels,
            "device_ops": sorted(([n[:NAME_CHARS], t]
                                  for n, t in by_name.items()),
                                 key=lambda r: -r[1])[:TOP],
            "idle_gaps": _label_gaps(gaps, host)}


def _label_gaps(gaps, host) -> list:
    ops = [(n, s, e) for n, s, e in host
           if n != WINDOW and not n.startswith("cuda")]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]
    if not longest:
        return []
    names = [n for n, _, _ in ops]
    starts = np.array([s for _, s, _ in ops], dtype=np.int64)
    ends = np.array([e for _, _, e in ops], dtype=np.int64)
    total = defaultdict(float)
    for g0, g1 in longest:
        mid = (g0 + g1) // 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        label = (names[inside[np.argmax(starts[inside])]] if inside.size
                 else "host between operations")
        total[label] += (g1 - g0) / 1e9
    return sorted(([n, t] for n, t in total.items()),
                  key=lambda r: -r[1])[:TOP]
