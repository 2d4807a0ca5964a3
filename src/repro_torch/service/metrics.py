"""Observability for the always-on scheduler (:mod:`repro_torch.service`).

One :class:`ServiceMetrics` instance rides along a
:class:`~repro_torch.service.engine.SchedulerService` and counts every request
the service handles, times every admission decision, and mirrors the
admission cache's reuse behaviour (builds / engine reuses /
deactivations / compactions). ``snapshot()`` flattens everything into a
plain JSON-able dict — the schema documented in docs/service.md and
consumed by ``python -m repro_torch.service`` and ``chip_smoke.py``'s
``service`` phase.

Latencies are recorded in seconds via a bounded reservoir (the newest
``max_samples`` decisions); quantiles are computed lazily at snapshot
time, so the per-decision overhead is one ``perf_counter`` pair and a
list append.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np


class ServiceMetrics:
    """Counters + admission-latency quantiles for one service instance."""

    def __init__(self, max_samples: int = 100_000):
        self.max_samples = max_samples
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.counters: Dict[str, int] = {
            "admit_requests": 0,      # admit() calls priced
            "admitted": 0,            # ... that returned a selection
            "rejected": 0,            # ... that returned None (infeasible)
            "quote_requests": 0,      # read-only quote() pricings
            "register_calls": 0,
            "register_rows": 0,       # rows actually (re)activated
            "deregister_calls": 0,
            "deregister_rows": 0,     # rows actually deactivated
            "advance_steps": 0,       # virtual-clock steps processed
            "reports": 0,             # rounds closed (executor or caller)
            "rounds_dispatched": 0,   # rounds handed to the executor
            # executor fault behaviour (repro_torch.service.faults/executors)
            "worker_crashes": 0,      # worker deaths detected mid-round
            "worker_restarts": 0,     # replacement workers spawned
            "shard_retries": 0,       # round shards resubmitted
            "client_dropouts": 0,     # mid-round excess-zero dropouts
            "stragglers_injected": 0,  # clients slowed by the fault plan
            "reports_delayed": 0,     # reports arriving late
            "reports_lost": 0,        # delivery attempts lost
            "report_retries": 0,      # redelivery attempts scheduled
            "rounds_degraded": 0,     # partial / zero-information closes
            # admission-cache behaviour (mirrors AdmissionCache counters)
            "engine_builds": 0,       # from-scratch pricing state builds
            "engine_reuses": 0,       # admits served off a held engine
            "engine_deactivations": 0,  # incremental candidate exclusions
            "engine_compactions": 0,  # reach_state_subset compactions
            "engine_memo_hits": 0,    # repeat requests answered verbatim
        }
        self._lat: list = []          # admission latencies, seconds
        self._report_lat: list = []   # report latencies, virtual steps
        # multiprocess workers, by slot: {"device", "launches": {kernel: n}}
        self.workers: Dict[int, Dict] = {}

    # ------------------------------------------------------------------
    def count(self, key: str, n: int = 1):
        self.counters[key] = self.counters.get(key, 0) + int(n)

    def record_report_latency(self, steps: int):
        """Virtual steps from a round's dispatch to its report landing —
        round duration plus any fault-injected delay/retry backoff, the
        distribution the timeout quantiles summarize."""
        self._report_lat.append(int(steps))
        if len(self._report_lat) > self.max_samples:
            self._report_lat = self._report_lat[-self.max_samples // 2:]

    def record_worker(self, slot: int, info: Dict):
        """A worker's reply: the device its backend runs on and the
        kernel launches it made for that shard, summed per slot (the
        parent cannot read a child's launch counts)."""
        w = self.workers.setdefault(int(slot), {"launches": {}})
        w["device"] = info["device"]
        for k, n in info["launches"].items():
            w["launches"][k] = w["launches"].get(k, 0) + int(n)

    def record_admit(self, latency_s: float, admitted: bool):
        self.count("admit_requests")
        self.count("admitted" if admitted else "rejected")
        self._record_latency(latency_s)

    def record_quote(self, latency_s: float):
        self.count("quote_requests")
        self._record_latency(latency_s)

    def _record_latency(self, latency_s: float):
        self._lat.append(float(latency_s))
        if len(self._lat) > self.max_samples:     # keep the newest half
            self._lat = self._lat[-self.max_samples // 2:]

    # ------------------------------------------------------------------
    @property
    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    def latency_quantiles(self) -> Dict[str, float]:
        if not self._lat:
            return {"p50_ms": float("nan"), "p99_ms": float("nan"),
                    "max_ms": float("nan")}
        lat = np.asarray(self._lat)
        return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p99_ms": float(np.percentile(lat, 99) * 1e3),
                "max_ms": float(lat.max() * 1e3)}

    def report_latency_quantiles(self) -> Dict[str, float]:
        """Dispatch-to-report latency quantiles in virtual steps."""
        if not self._report_lat:
            return {"report_p50_steps": float("nan"),
                    "report_p99_steps": float("nan"),
                    "report_max_steps": float("nan")}
        lat = np.asarray(self._report_lat, dtype=float)
        return {"report_p50_steps": float(np.percentile(lat, 50)),
                "report_p99_steps": float(np.percentile(lat, 99)),
                "report_max_steps": float(lat.max())}

    def snapshot(self, backend=None) -> Dict:
        """Flat dict: counters, wall-clock rates, latency quantiles,
        (when a backend is passed) its kernel-dispatch counters, and (when
        workers replied) each worker slot's device and K1/K2 launches."""
        elapsed = self.elapsed_s
        # every priced request is a decision, committed or quoted
        dec = self.counters["admit_requests"] + self.counters["quote_requests"]
        out = dict(self.counters)
        out["elapsed_s"] = elapsed
        out["decisions_per_sec"] = dec / elapsed if elapsed > 0 else 0.0
        out.update(self.latency_quantiles())
        out.update(self.report_latency_quantiles())
        if backend is not None:
            counts = getattr(backend, "dispatch_counts", None)
            if counts is not None:
                out["backend_dispatches"] = dict(counts)
        if self.workers:
            out["worker_devices"] = {s: w["device"]
                                     for s, w in sorted(self.workers.items())}
            out["worker_kernel_launches"] = {
                s: dict(w["launches"]) for s, w in sorted(self.workers.items())}
        return out
