"""Round executors for the always-on scheduler.

The :class:`~repro_torch.service.engine.SchedulerService` prices admissions;
*executors* own everything after the commit: running the round's step
loop, training the contributors, and surfacing the completion report
when the virtual clock passes the round's end. Three implementations
share the delivery machinery in :class:`_ExecutorBase`:

* :class:`InProcessExecutor` — runs
  :func:`~repro_torch.core.simulation.execute_round` + the trainer eagerly at
  dispatch on the service's own scenario (bit unchanged when no faults
  are injected);
* :class:`MultiprocessExecutor` — shards the selection by power domain
  across persistent worker processes. Workers are keyed by the
  deterministic ``(seed, row, step)`` synthesis contract: each worker
  rebuilds the scenario + registry from the pickled
  :class:`~repro_torch.core.experiment.ExperimentConfig` at startup and
  regenerates its own rows' traces locally, so a round-shard task
  message carries row indices and fault effects — never trace data.
  Per-domain sharding makes the merge exact (``share_power`` couples
  clients only within a domain; see
  :func:`~repro_torch.core.simulation.merge_round_shards`), so a zero-fault
  multiprocess run is summary-identical to the in-process executor.
  Workers start with ``spawn`` (a forked child cannot use CUDA; ``fork``
  with a CUDA backend raises ``ValueError``), each builds its own backend
  from the config (on the card, a CUDA context of its own) and loads the
  kernels the parent built before starting it. A worker that cannot
  start, or whose task raises, sends its traceback back and the parent
  raises ``RuntimeError``: only a death (an exit, a kill) goes through
  the retry machinery below. Each reply also carries the worker's device
  and its K1/K2 launches for that shard, which the parent sums per slot
  into the metrics (``worker_devices``, ``worker_kernel_launches``).
* ``executor="none"`` — no executor object at all; the caller (a remote
  fleet, or :meth:`~repro_torch.service.engine.SchedulerService.replay`)
  feeds ``report_round`` itself.

Fault handling (:mod:`repro_torch.service.faults`): a
:class:`~repro_torch.service.faults.FaultPlan` injects client dropouts and
stragglers at dispatch, worker crashes inside the worker loop (retried
per shard up to ``RetryPolicy.max_retries`` with a fresh worker), and
report delays/losses at delivery. Graceful degradation has two flavors,
both of which close the round through the ordinary ``report_round``
path (so a faulted run's event log replays bit-identically with no
executor at all):

* **worker death past the retry budget** — the round closes *partial*:
  surviving shards' contributors aggregate normally, and the dead
  shard's clients are reported with explicit zero-loss samples, which
  is exactly the σ=0 / blocklist bookkeeping an explicit zero-utility
  ``report_round`` would have recorded.
* **report lost past the retry budget** (or past
  ``RetryPolicy.timeout_steps``) — the scheduler never hears the
  outcome: the round closes with *no* contributors (busy rows free,
  no σ or blocklist changes), a zero-information close.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import sys
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from ..backend import ArrayBackend
from ..core.simulation import (execute_round, execute_round_shard,
                               merge_round_shards)
from ..core.types import RoundResult, Selection
from ..kernels import counter_hash

from .faults import FaultPlan, RetryPolicy

_CRASH_EXIT = 73  # worker exit code for plan-injected crashes


class WorkerDied(Exception):
    """A worker slot's process is gone (crash, kill, or closed pipe)."""


def _train_contributors(svc, rr: RoundResult) -> List[np.ndarray]:
    """Local training + aggregation for a round's contributors, in
    finish order — the trainer-call order every executor must preserve
    (trainer state is sequential; reordering would change bits)."""
    sample_losses: List[np.ndarray] = []
    if rr.contributors.size and svc.trainer is not None:
        updates = []
        for pos in rr.contributor_idx:
            upd = svc.trainer.local_update(int(rr.participants[pos]),
                                           float(rr.batches[pos]))
            sample_losses.append(upd["sample_losses"])
            updates.append(upd)
        svc.trainer.aggregate(updates)
    else:
        sample_losses = [np.empty(0)] * int(rr.contributors.size)
    return sample_losses


@dataclasses.dataclass
class _PendingRound:
    """A dispatched round waiting for its completion report to land."""
    round_id: int
    dispatched_at: int
    end: int                      # natural end step (dispatch + duration)
    rr: RoundResult
    losses: List[np.ndarray]
    dead_rows: np.ndarray         # rows lost to dead workers (may be empty)
    next_step: int                # next delivery attempt
    attempt: int = 0


class _ExecutorBase:
    """Shared dispatch-side fault effects + report delivery machinery.

    Subclasses implement ``dispatch(round_id, sel, d_max)`` (produce a
    :class:`RoundResult` + trainer losses, then call
    :meth:`_schedule`); the base class owns the pending-round table and
    :meth:`due`, which the service polls once per clock step.
    """

    def __init__(self, service, faults: Optional[FaultPlan] = None):
        self.svc = service
        self.faults = faults if (faults is None or faults.any_faults) \
            else None
        self._pending: Dict[int, _PendingRound] = {}
        # rid -> rows closed with zero/no information (test introspection)
        self.degraded_rounds: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    @property
    def policy(self) -> RetryPolicy:
        return self.faults.retry if self.faults is not None else RetryPolicy()

    def _effects(self, rid: int, rows: np.ndarray, d_max: int):
        """Client-level fault effects for this round (dropouts /
        stragglers), counted into metrics at dispatch."""
        if self.faults is None:
            return None, None
        svc = self.svc
        drop, speed = self.faults.round_effects(
            svc.scenario, svc._dom_rows, rows, svc.now, d_max, rid)
        if drop is not None:
            svc.metrics.count("client_dropouts", int((drop >= 0).sum()))
        if speed is not None:
            svc.metrics.count("stragglers_injected",
                              int((speed < 1.0).sum()))
        return drop, speed

    def _schedule(self, rid: int, rr: RoundResult,
                  losses: List[np.ndarray], dead_rows: np.ndarray) -> int:
        """Queue the finished round for delivery; returns the step its
        first delivery attempt fires."""
        svc = self.svc
        end = svc.now + max(rr.duration, 1)
        delay = self.faults.report_delay(rid) if self.faults is not None \
            else 0
        if delay:
            svc.metrics.count("reports_delayed")
        if dead_rows.size:
            svc.metrics.count("rounds_degraded")
            self.degraded_rounds[rid] = dead_rows.copy()
        self._pending[rid] = _PendingRound(
            round_id=rid, dispatched_at=svc.now, end=end, rr=rr,
            losses=losses, dead_rows=dead_rows, next_step=end + delay)
        return end + delay

    # ------------------------------------------------------------------
    def due(self, now: int) -> List[tuple]:
        """Reports ready to apply at clock ``now``, in round-id order:
        ``(round_id, contributors, participants, sample_losses,
        duration)`` tuples. Lost deliveries re-arm ``backoff_steps``
        later; a round past its retry budget (or ``timeout_steps``)
        degrades to a zero-information close instead."""
        pol = self.policy
        out: List[tuple] = []
        for rid in sorted(self._pending):
            p = self._pending[rid]
            while rid in self._pending and p.next_step <= now:
                lost = (self.faults is not None
                        and self.faults.report_lost(rid, p.attempt))
                if not lost:
                    out.append(self._emit(p, now, lost_all=False))
                    del self._pending[rid]
                    break
                self.svc.metrics.count("reports_lost")
                p.attempt += 1
                nxt = p.next_step + max(1, pol.backoff_steps)
                timed_out = (pol.timeout_steps is not None
                             and nxt - p.end > pol.timeout_steps)
                if p.attempt > pol.max_retries or timed_out:
                    out.append(self._emit(p, now, lost_all=True))
                    del self._pending[rid]
                    break
                self.svc.metrics.count("report_retries")
                p.next_step = nxt
        return out

    def _emit(self, p: _PendingRound, now: int, lost_all: bool) -> tuple:
        svc = self.svc
        rr = p.rr
        if lost_all:
            # delivery budget exhausted: the scheduler never heard the
            # outcome — free the rows, record nothing
            svc.metrics.count("rounds_degraded")
            self.degraded_rounds[p.round_id] = np.asarray(
                rr.participants, dtype=np.int64).copy()
            contributors = np.empty(0, dtype=np.int64)
            losses: List[np.ndarray] = []
        elif p.dead_rows.size:
            # partial close: survivors aggregate; dead-shard clients get
            # an explicit zero-utility record (σ -> 0, blocklist entry
            # drawn like any contributor's)
            contributors = np.concatenate([
                np.asarray(rr.contributors, dtype=np.int64),
                np.sort(p.dead_rows).astype(np.int64)])
            losses = list(p.losses) + [np.zeros(1)] * int(p.dead_rows.size)
        else:
            contributors = rr.contributors
            losses = p.losses
        svc.metrics.record_report_latency(now - p.dispatched_at)
        return (p.round_id, contributors, rr.participants, losses,
                rr.duration)

    # ------------------------------------------------------------------
    def shutdown(self):
        """Release executor resources (worker processes, pipes)."""


class InProcessExecutor(_ExecutorBase):
    """Runs admitted rounds eagerly on the service's own scenario +
    trainer; completions surface when the virtual clock passes the round
    end (:meth:`SchedulerService.poll`). With a fault plan it injects
    the client- and report-level faults (dropouts, stragglers, delayed/
    lost reports) — worker crashes need :class:`MultiprocessExecutor`.
    """

    def dispatch(self, round_id: int, sel: Selection, d_max: int) -> int:
        """Execute the round now; return the step its report lands.
        ``d_max`` is the admitting request's cap — the round may run
        past the solver's expected duration under realized conditions,
        exactly as in the batch loop."""
        svc = self.svc
        rows = np.asarray(sel.rows, dtype=np.int64)
        drop, speed = self._effects(round_id, rows, d_max)
        rr = execute_round(svc.registry, svc.scenario, svc._dom_rows, sel,
                           svc.now, d_max, round_idx=round_id,
                           drop_step=drop, speed=speed)
        losses = _train_contributors(svc, rr)
        return self._schedule(round_id, rr, losses,
                              np.empty(0, dtype=np.int64))


# ---------------------------------------------------------------------------
# multiprocess executor


def run_sharded_with_retries(slots, assignment: List[List[int]],
                             tasks: List[dict], *, max_retries: int,
                             on_restart=None, on_retry=None):
    """The executor's retry state machine, transport-agnostic so the
    fault tests can drive it with fake slots (no processes).

    ``slots`` expose ``submit(task)`` / ``collect() -> reply`` /
    ``restart()``, where ``collect`` raises :class:`WorkerDied` when the
    slot's worker is gone; ``assignment[w]`` lists the task indices slot
    ``w`` owns, and every task is submitted up front (pipelined — slots
    work their queues concurrently). On a death, every uncollected task
    of that slot bumps its attempt counter: tasks within the retry
    budget are resubmitted to the restarted worker with the new attempt
    (so a plan-scheduled crash keyed ``(round, slot, attempt)`` fires
    once), the rest are declared dead.

    Returns ``(results, dead)``: per-task replies (``None`` for dead
    tasks) and the sorted dead task indices.
    """
    results: List[Optional[dict]] = [None] * len(tasks)
    attempts = [0] * len(tasks)
    dead: List[int] = []
    for w, queue in enumerate(assignment):
        for si in queue:
            slots[w].submit({**tasks[si], "attempt": 0})
    for w, queue in enumerate(assignment):
        queue = list(queue)
        pos = 0
        while pos < len(queue):
            try:
                got = slots[w].collect()
            except WorkerDied:
                if on_restart is not None:
                    on_restart()
                slots[w].restart()
                retry = []
                for sj in queue[pos:]:
                    attempts[sj] += 1
                    if attempts[sj] > max_retries:
                        dead.append(sj)
                    else:
                        if on_retry is not None:
                            on_retry()
                        retry.append(sj)
                queue[pos:] = retry
                for sj in retry:
                    slots[w].submit({**tasks[sj], "attempt": attempts[sj]})
                continue
            results[got["shard"]] = got
            pos += 1
    return results, sorted(dead)


def _on_cuda(spec) -> bool:
    """Whether the backend ``spec`` (a name, ``None`` or an instance)
    runs on a CUDA device, without building it."""
    if isinstance(spec, ArrayBackend):
        return getattr(spec, "device", torch.device("cpu")).type == "cuda"
    return spec is None or str(spec).lower() in ("cuda", "torch")


def _launches() -> Dict[str, int]:
    return {"piece_window": counter_hash.piece_window.launches,
            "forecast_z": counter_hash.forecast_z.launches}


def _worker_main(conn, cfg, slot: int, plan: Optional[FaultPlan]):
    """Worker process entry: rebuild scenario + registry from the config
    (counter-seeded synthesis — no trace data crosses the pipe), report
    ``("ready", info)``, then serve round-shard tasks until told to stop.
    A start-up or task failure is sent back as ``("error", traceback)``
    and ends the worker; a plan-scheduled crash is a hard ``os._exit``
    mid-task: the parent sees the pipe close and drives the retry
    machinery."""
    try:
        from ..core.experiment import build_registry, build_scenario
        scenario = build_scenario(cfg)
        registry = build_registry(cfg, scenario)
        dom_rows = registry.domain_rows(scenario.domain_names)
        device = getattr(scenario.backend, "device", None)
        if device is not None and device.type == "cuda":
            counter_hash.load_library()     # built by the parent
        device = str(device or "cpu")
        conn.send(("ready", {
            "device": device,
            "packages": sorted({m.partition(".")[0] for m in sys.modules})}))
    except Exception:
        conn.send(("error", traceback.format_exc()))
        conn.close()
        return
    while True:
        try:
            kind, task = conn.recv()
        except EOFError:
            break
        if kind == "stop":
            break
        if plan is not None and plan.worker_crash(
                task["round_id"], slot, task["attempt"]):
            os._exit(_CRASH_EXIT)
        try:
            before = _launches()
            res = execute_round_shard(
                registry, scenario, dom_rows, task["rows"], task["now"],
                task["d_max"], constrained=task["constrained"],
                drop_step=task["drop_step"], speed=task["speed"])
            after = _launches()
        except Exception:
            conn.send(("error", traceback.format_exc()))
            break
        conn.send(("ok", {"round_id": task["round_id"],
                          "shard": task["shard"], **res},
                   {"device": device,
                    "launches": {k: after[k] - before[k] for k in after}}))
    conn.close()


class _WorkerSlot:
    """One persistent worker process + its pipe, restartable in place.
    ``on_reply(slot, info)`` receives the worker facts each reply
    carries (device, K1/K2 launches for that shard)."""

    def __init__(self, cfg, slot: int, plan: Optional[FaultPlan],
                 ctx_name: str, on_reply=None):
        self._cfg = cfg
        self.slot = slot
        self._plan = plan
        self._ctx = mp.get_context(ctx_name)
        self._on_reply = on_reply
        self._proc = None
        self._conn = None
        self.info: Optional[dict] = None   # the worker's "ready" report
        self.start()

    def start(self):
        """Start the worker process; :meth:`wait_ready` waits for it."""
        parent, child = self._ctx.Pipe()
        self._proc = self._ctx.Process(
            target=_worker_main, args=(child, self._cfg, self.slot,
                                       self._plan), daemon=True)
        self._proc.start()
        child.close()
        self._conn = parent

    def _failed(self, what: str, tb: str):
        self.close(stop=False)
        raise RuntimeError(f"service worker {self.slot} {what}:\n{tb}")

    def wait_ready(self):
        """Block until the worker has built its scenario and backend.
        A worker that fails or dies before that raises ``RuntimeError``
        here: it never reaches the retry machinery."""
        try:
            kind, payload = self._conn.recv()
        except (EOFError, OSError):
            self._proc.join(timeout=5)
            self._failed("died before it started",
                         f"exit code {self._proc.exitcode}")
        if kind == "error":
            self._failed("failed to start", payload)
        self.info = payload

    def submit(self, task: dict):
        try:
            self._conn.send(("round", task))
        except (BrokenPipeError, OSError):
            # worker already gone: drop the send — collect() raises
            # WorkerDied for this slot and the retry machinery restarts
            # it and resubmits every uncollected task
            pass

    def collect(self) -> dict:
        try:
            msg = self._conn.recv()
        except (EOFError, OSError) as e:
            raise WorkerDied(self.slot) from e
        if msg[0] == "error":
            self._failed("raised", msg[1])
        _, payload, info = msg
        if self._on_reply is not None:
            self._on_reply(self.slot, info)
        return payload

    def restart(self):
        self.close(stop=False)
        self.start()
        self.wait_ready()

    def close(self, stop: bool = True):
        if self._conn is not None:
            if stop:
                try:
                    self._conn.send(("stop", None))
                except (BrokenPipeError, OSError):
                    pass
            self._conn.close()
            self._conn = None
        if self._proc is not None:
            self._proc.join(timeout=5)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=5)
            self._proc = None


class MultiprocessExecutor(_ExecutorBase):
    """Shards admitted rounds across persistent worker processes (see
    module docstring). Workers spawn lazily on the first dispatch (the
    ``spawn`` context — safe after the parent has touched CUDA — pays a
    one-time interpreter + import cost per worker, and on the card a
    CUDA context each) and are reused for the service's lifetime;
    :meth:`shutdown` reaps them."""

    def __init__(self, service, config, workers: int = 2,
                 faults: Optional[FaultPlan] = None,
                 mp_context: Optional[str] = None):
        super().__init__(service, faults)
        if config is None:
            raise ValueError(
                "the multiprocess executor rebuilds worker-side state "
                "from the ExperimentConfig; construct the service via "
                "build_service(cfg, ...) so it is wired through")
        self.config = config
        self.workers = max(1, int(workers))
        self._ctx_name = mp_context or "spawn"
        self._cuda = _on_cuda(config.run.backend)
        if self._ctx_name == "fork" and (self._cuda
                                         or _on_cuda(service.backend)):
            raise ValueError(
                'mp_context="fork" with a CUDA backend: a forked child '
                'cannot use CUDA; use "spawn" (the default)')
        self._slots: Optional[List[_WorkerSlot]] = None

    def _ensure_slots(self):
        if self._slots is not None:
            return
        if self._cuda and torch.cuda.is_available():
            # build the kernels here, once, so that no two workers run
            # nvcc at once on a cold build directory: each only loads
            # them (without CUDA the workers fail to start by themselves)
            counter_hash.load_library()
        m = self.svc.metrics
        slots: List[_WorkerSlot] = []
        try:
            for w in range(self.workers):
                slots.append(_WorkerSlot(self.config, w, self.faults,
                                         self._ctx_name,
                                         on_reply=m.record_worker))
            for s in slots:                 # the workers start together
                s.wait_ready()
        except BaseException:
            for s in slots:
                s.close(stop=False)
            raise
        self._slots = slots

    def dispatch(self, round_id: int, sel: Selection, d_max: int) -> int:
        svc = self.svc
        if bool(getattr(sel, "grid", False)):
            raise ValueError("grid-fallback rounds are not shardable "
                             "(the service schedules excess-powered "
                             "rounds only)")
        self._ensure_slots()
        rows = np.asarray(sel.rows, dtype=np.int64)
        drop, speed = self._effects(round_id, rows, d_max)
        # shard by power domain (grants couple clients only within a
        # domain), domains round-robined over at most `workers` shards
        dom = svc._dom_rows[rows]
        groups = [np.nonzero(dom == pi)[0]
                  for pi in dict.fromkeys(dom.tolist())]
        n_shards = max(1, min(self.workers, len(groups)))
        shard_pos = [np.concatenate(groups[i::n_shards])
                     for i in range(n_shards)]
        tasks = [{"round_id": round_id, "shard": i, "rows": rows[p],
                  "now": svc.now, "d_max": d_max, "constrained": True,
                  "drop_step": None if drop is None else drop[p],
                  "speed": None if speed is None else speed[p]}
                 for i, p in enumerate(shard_pos)]
        assignment: List[List[int]] = [[] for _ in range(self.workers)]
        for i in range(len(tasks)):
            assignment[i % self.workers].append(i)
        m = svc.metrics
        results, dead = run_sharded_with_retries(
            self._slots, assignment, tasks,
            max_retries=self.policy.max_retries,
            on_restart=lambda: (m.count("worker_crashes"),
                                m.count("worker_restarts")),
            on_retry=lambda: m.count("shard_retries"))
        shards = [r for r in results if r is not None]
        dead_rows = (np.sort(np.concatenate(
            [rows[shard_pos[i]] for i in dead])).astype(np.int64)
            if dead else np.empty(0, dtype=np.int64))
        rr = merge_round_shards(sel, shards, svc.now, d_max,
                                n_steps=svc.scenario.n_steps,
                                round_idx=round_id)
        losses = _train_contributors(svc, rr)
        return self._schedule(round_id, rr, losses, dead_rows)

    def shutdown(self):
        if self._slots:
            for s in self._slots:
                s.close()
        self._slots = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass
