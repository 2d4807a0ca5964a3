"""Always-on scheduling service: the batch FedZero simulation turned
into an event-driven scheduler over a live fleet.

:class:`SchedulerService` owns a virtual clock and a dynamic fleet view
(an ``active`` mask over the full client registry, plus a ``busy`` mask
for rows inside unreported rounds) and processes four request kinds:

* ``register(rows)`` / ``deregister(rows)`` — clients joining/leaving;
* ``admit(n, d_max)`` — price one round admission *right now* over the
  currently-eligible candidates (FedZero Algorithm 1 through the
  incremental :class:`~repro_torch.service.admission.AdmissionCache`);
* ``report_round(...)`` — a round's training outcome arriving: utilities
  and the fairness blocklist update, the participants free up;
* ``advance(steps)`` — the virtual clock ticks: one blocklist release
  draw per step (the service-side analogue of the batch strategy's
  per-round ``start_round``) and completed executor rounds auto-report.

**Determinism contract** (docs/service.md): every request is appended to
a :class:`~repro_torch.core.types.ServiceEvent` log; replaying that log
against a fresh instance — or against one with ``incremental=False``,
whose every admit prices from scratch through plain
:func:`~repro_torch.core.selection.select_clients` — reproduces the original
admissions bit for bit. Report events carry the training outcome in
their payload, so replay consumes the log without a trainer; the
service's two RNG streams (blocklist release, exclusion-factor entry)
are consumed at event-processing order, which the log preserves.

Round execution is pluggable (:mod:`repro_torch.service.executors`): the
in-process executor runs :func:`repro_torch.core.simulation.execute_round` +
the trainer at dispatch time and surfaces the report when the clock
passes the round end, so training overlaps admission on the virtual
timeline exactly as the batch loop would have sequenced it; the
multiprocess executor shards rounds by power domain across worker
processes (summary-identical when fault-free); ``executor="none"``
leaves reporting to the caller (remote fleets, replay). Executors take
an optional :class:`~repro_torch.service.faults.FaultPlan` for deterministic
fault injection — faulted runs log the degraded outcomes like any
other, so the replay contract above is unchanged.

The array backend comes from the port's registry
(:func:`repro_torch.backend.get_backend`): by default ``"cuda"`` on
``cuda:0``, which raises ``RuntimeError`` without CUDA. Pricing reads
forecasts through the backend's ``forecast_noise_z`` (K2) and candidates'
utilisation windows through ``synth_window`` (K1), which every executed
round reads too; the host control flow (candidate cache, blocklist,
utility, clock, log) stays NumPy as in the reference.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..backend import get_backend
from ..core.experiment import (ExperimentConfig, build_registry,
                                   build_scenario, build_trainer)
from ..core.fairness import Blocklist
from ..core.strategies import EnvView
from ..core.types import ClientRegistry, Selection, ServiceEvent
from ..core.utility import UtilityTracker

from .admission import AdmissionCache
from .executors import InProcessExecutor, MultiprocessExecutor
from .metrics import ServiceMetrics


class SchedulerService:
    """The always-on scheduler. See the module docstring for the event
    model; construction from an :class:`ExperimentConfig` goes through
    :func:`build_service`."""

    def __init__(self, registry: ClientRegistry, scenario, trainer=None, *,
                 n: int = 10, d_max: int = 60, solver: str = "mip",
                 search: str = "binary", alpha: float = 1.0,
                 exclusion_factor: float = 1.0,
                 sharded: Optional[bool] = None, candidate_cap: int = 0,
                 exact_uncapped: Optional[bool] = None, backend=None,
                 executor: str = "inprocess", incremental: bool = True,
                 compact_frac: float = 0.25, exclude_training: bool = True,
                 record_log: bool = True, seed: int = 0,
                 initially_active: bool = True, workers: int = 2,
                 faults=None, mp_context: Optional[str] = None,
                 config: Optional[ExperimentConfig] = None):
        self.registry = registry
        self.scenario = scenario
        self.trainer = trainer
        self.config = config
        self.n = int(n)
        self.d_max = int(d_max)
        self.exclusion_factor = exclusion_factor
        self.exclude_training = exclude_training
        self.record_log = record_log
        self.backend = get_backend(backend)
        self._dom_rows = registry.domain_rows(scenario.domain_names)
        C = len(registry)
        # fleet bookkeeping — exactly the batch strategy's, shared with it
        # by construction (same classes, same seeds as make_strategy wires)
        self.blocklist = Blocklist(C, alpha=alpha, seed=seed + 7)
        self.utility = UtilityTracker(registry.n_samples_arr)
        self._xrng = np.random.default_rng(seed)   # exclusion-factor draws
        # dynamic fleet view
        self.active = np.full(C, bool(initially_active))
        self.busy = np.zeros(C, dtype=bool)
        self.now = 0
        # candidate cache: the eligibility filter is O(C) (σ gather +
        # three mask passes + nonzero over the full registry), which at
        # 1M clients dwarfs a warm admission — so the filtered set is
        # kept between requests and only recomputed when something it
        # reads changed: the clock or horizon (excess forecasts), the
        # fleet masks (register/deregister, tracked by ``_fleet_gen``),
        # or σ/blocklist state (report / release draws, tracked by the
        # admission cache's generation). Busy-marking on a successful
        # admit subtracts the selected rows in O(candidates) instead of
        # invalidating.
        self._fleet_gen = 0
        self._cand_key = None         # (now, d_max, fleet_gen, cache.gen)
        self._cand: Optional[np.ndarray] = None
        self._sigma: Optional[np.ndarray] = None
        self.metrics = ServiceMetrics()
        self.cache = AdmissionCache(
            registry, backend=self.backend, solver=solver, search=search,
            sharded=sharded, candidate_cap=candidate_cap,
            exact_uncapped=exact_uncapped, incremental=incremental,
            compact_frac=compact_frac, metrics=self.metrics)
        # round lifecycle — pending rounds live inside the executor
        self._next_round = 0
        self.admitted: Dict[int, Selection] = {}  # rid -> selection (open)
        # every admit decision's row array in request order (None =
        # infeasible) — what the replay parity check compares against
        self.history: List[Optional[np.ndarray]] = []
        self.log: List[ServiceEvent] = []
        if executor == "inprocess":
            self.executor = InProcessExecutor(self, faults=faults)
        elif executor == "multiprocess":
            self.executor = MultiprocessExecutor(self, config,
                                                 workers=workers,
                                                 faults=faults,
                                                 mp_context=mp_context)
        elif executor == "none":
            # replay / remote fleets drive report_round directly; a
            # fault plan is meaningless here and silently ignored (so a
            # faulted run's config builds its own replay twin unchanged)
            self.executor = None
        else:
            raise ValueError(f"unknown executor {executor!r}")

    # ------------------------------------------------------------------
    def _log(self, **kw):
        if self.record_log:
            self.log.append(ServiceEvent(step=self.now, **kw))

    # ------------------------------------------------------------------
    def register(self, rows: np.ndarray):
        """Activate ``rows`` (idempotent for already-active rows)."""
        rows = np.asarray(rows, dtype=np.int64)
        fresh = int(np.count_nonzero(~self.active[rows]))
        self.active[rows] = True
        self._fleet_gen += 1
        self.metrics.count("register_calls")
        self.metrics.count("register_rows", fresh)
        self._log(kind="register", rows=rows.copy())

    def deregister(self, rows: np.ndarray):
        """Deactivate ``rows``. Rows inside an unreported round stay in
        it (the executor already holds them) but stop being admissible
        immediately."""
        rows = np.asarray(rows, dtype=np.int64)
        fresh = int(np.count_nonzero(self.active[rows]))
        self.active[rows] = False
        self._fleet_gen += 1
        self.metrics.count("deregister_calls")
        self.metrics.count("deregister_rows", fresh)
        self._log(kind="deregister", rows=rows.copy())

    # ------------------------------------------------------------------
    def _env(self, d_max: int) -> EnvView:
        sc = self.scenario
        return EnvView(registry=self.registry, now=self.now,
                       excess_now=sc.excess_at(self.now), scenario=sc,
                       horizon=d_max, dom_rows=self._dom_rows)

    def _candidates(self, env: EnvView,
                    excess_fc: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(candidate rows, full-[C] σ) — the batch strategy's eligibility
        filter plus the service's liveness masks."""
        sigma = self.utility.sigmas()
        sigma[self.blocklist.blocked] = 0.0     # §4.4: blocked get σ_c = 0
        dom_ok = excess_fc.sum(axis=1) > 0
        ok = (sigma > 0) & dom_ok[self._dom_rows] & self.active
        if self.exclude_training:
            ok &= ~self.busy
        return np.nonzero(ok)[0], sigma

    def _eligible_now(self, d_max: int):
        """Environment view + eligible candidates at the current clock.

        The candidate filter is O(C); its result only changes with the
        clock, the fleet masks or the σ generation, so it is cached
        under exactly that key and shared by :meth:`admit` /
        :meth:`quote` (a committed admission subtracts its busy winners
        from the cached set in O(candidates))."""
        env = self._env(d_max)
        excess_fc = env.excess_fc()
        ckey = (self.now, d_max, self._fleet_gen, self.cache.gen)
        if self._cand_key == ckey:
            cand, sigma = self._cand, self._sigma
        else:
            cand, sigma = self._candidates(env, excess_fc)
            self._cand_key, self._cand, self._sigma = ckey, cand, sigma
        return env, excess_fc, cand, sigma, ckey

    def quote(self, n: Optional[int] = None, d_max: Optional[int] = None
              ) -> Optional[Selection]:
        """Price an admission request *without* committing it: no round
        id, no busy marks, no dispatch, no log entry — a pure read. By
        the determinism contract an immediately following :meth:`admit`
        with the same arguments returns exactly this selection, so
        repeated quotes against unchanged state are answered from the
        admission cache's result memo in O(candidates)."""
        n = self.n if n is None else int(n)
        d_max = self.d_max if d_max is None else int(d_max)
        t0 = time.perf_counter()
        env, excess_fc, cand, sigma, _ = self._eligible_now(d_max)
        sel = None
        if cand.size >= n:
            sel = self.cache.admit(env, cand, sigma, excess_fc, n, d_max)
        self.metrics.record_quote(time.perf_counter() - t0)
        return sel

    def admit(self, n: Optional[int] = None, d_max: Optional[int] = None
              ) -> Optional[Tuple[int, Selection]]:
        """Price one admission request at the current clock. Returns
        ``(round_id, selection)``, or ``None`` when no valid selection
        exists within ``d_max`` — both outcomes are logged, and both are
        reproduced bit-identically by replay."""
        n = self.n if n is None else int(n)
        d_max = self.d_max if d_max is None else int(d_max)
        t0 = time.perf_counter()
        env, excess_fc, cand, sigma, ckey = self._eligible_now(d_max)
        sel = None
        if cand.size >= n:
            sel = self.cache.admit(env, cand, sigma, excess_fc, n, d_max)
        if sel is None:
            self.metrics.record_admit(time.perf_counter() - t0, False)
            self.history.append(None)
            self._log(kind="admit", n=n, d_max=d_max, round_id=-1)
            return None
        rid = self._next_round
        self._next_round += 1
        self.admitted[rid] = sel
        if self.exclude_training:
            self.busy[sel.rows] = True
            if self._cand_key == ckey:
                # the only eligibility change is the n rows just marked
                # busy — subtract them instead of refiltering the fleet
                keep = np.ones(self._cand.size, dtype=bool)
                keep[np.searchsorted(self._cand,
                                     np.asarray(sel.rows))] = False
                self._cand = self._cand[keep]
        if self.executor is not None:
            self.executor.dispatch(rid, sel, d_max)
            self.metrics.count("rounds_dispatched")
        self.metrics.record_admit(time.perf_counter() - t0, True)
        self.history.append(np.asarray(sel.rows, dtype=np.int64).copy())
        self._log(kind="admit", n=n, d_max=d_max, round_id=rid)
        return rid, sel

    # ------------------------------------------------------------------
    def report_round(self, round_id: int, contributors: np.ndarray,
                     participants: np.ndarray,
                     sample_losses: List[np.ndarray],
                     duration: int = 0):
        """Apply one round's training outcome: σ statistics record, the
        exclusion-factor draw gates blocklist entry, participants free
        up, and all cached pricing state is retired (σ generation
        bump)."""
        contributors = np.asarray(contributors, dtype=np.int64)
        participants = np.asarray(participants, dtype=np.int64)
        for row, losses in zip(contributors, sample_losses):
            self.utility.record(int(row), losses)
        enter = self._xrng.random(contributors.size) < self.exclusion_factor
        self.blocklist.record_participation(contributors[enter])
        self.busy[participants] = False
        self.admitted.pop(round_id, None)
        self.cache.invalidate()
        self.metrics.count("reports")
        self._log(kind="report", round_id=round_id, n=int(duration),
                  payload={"contributors": contributors.copy(),
                           "participants": participants.copy(),
                           "sample_losses": [np.asarray(sl)
                                             for sl in sample_losses],
                           "duration": int(duration)})

    def poll(self):
        """Apply executor reports that have come due at the current
        clock (round end + any fault-injected delivery delay/retries)."""
        if self.executor is None:
            return
        for rid, contributors, participants, losses, duration \
                in self.executor.due(self.now):
            self.report_round(rid, contributors, participants, losses,
                              duration=duration)

    def advance(self, steps: int = 1):
        """Tick the virtual clock. Per step: one blocklist ω-update +
        release draw (the batch strategy performs this once per round
        attempt; the service performs it once per virtual minute — the
        policy both the live run and its replay share), then executor
        completions."""
        for _ in range(int(steps)):
            self.now += 1
            self.blocklist.start_round()
            self.metrics.count("advance_steps")
            self._log(kind="advance", n=1)
            self.poll()

    # ------------------------------------------------------------------
    def close(self):
        """Release executor resources (multiprocess worker pool). Safe
        to call more than once; the service remains usable for replay-
        style reads afterwards."""
        if self.executor is not None:
            self.executor.shutdown()

    # ------------------------------------------------------------------
    def replay(self, events: List[ServiceEvent]) -> List[Optional[Selection]]:
        """Process a recorded request log on this (fresh) instance;
        returns each admit event's outcome in order. Build the instance
        with ``executor="none"`` — the log's report events carry the
        training outcomes, so no round is ever re-executed."""
        if self.executor is not None:
            raise ValueError('replay needs executor="none" (report events '
                             "drive round completion, not the executor)")
        out: List[Optional[Selection]] = []
        for ev in events:
            if ev.kind == "advance":
                self.advance(ev.n)
            elif ev.kind == "register":
                self.register(ev.rows)
            elif ev.kind == "deregister":
                self.deregister(ev.rows)
            elif ev.kind == "admit":
                res = self.admit(ev.n, ev.d_max)
                out.append(None if res is None else res[1])
            elif ev.kind == "report":
                p = ev.payload
                self.report_round(ev.round_id, p["contributors"],
                                  p["participants"], p["sample_losses"],
                                  duration=p.get("duration", 0))
            else:
                raise ValueError(f"unknown event kind {ev.kind!r}")
        return out


# ---------------------------------------------------------------------------


def build_service(cfg: ExperimentConfig, *, scenario=None, registry=None,
                  trainer=None, **overrides) -> SchedulerService:
    """Config → ready :class:`SchedulerService`, mirroring
    :func:`~repro_torch.core.experiment.build_experiment`: the strategy section
    supplies the FedZero policy (n, d_max, solver options, blocklist
    seed), the service section the service knobs, the run section the
    backend (``"cuda"`` by default: ``cuda:0``, ``RuntimeError`` without
    CUDA; a CPU caller passes ``CudaBackend(device="cpu")``). Pre-built
    pieces may be passed in; ``overrides`` go to the constructor last
    (tests pin e.g. ``incremental``)."""
    if cfg.strategy.name != "fedzero":
        raise ValueError("the always-on service schedules with FedZero; "
                         f"got strategy {cfg.strategy.name!r}")
    if scenario is None:
        scenario = build_scenario(cfg)
    if registry is None:
        registry = build_registry(cfg, scenario)
    if trainer is None:
        trainer = build_trainer(cfg, registry)
    st, sv = cfg.strategy, cfg.service
    opts = dict(st.options)
    exact = (cfg.run.exact_uncapped if cfg.run.exact_uncapped is not None
             else opts.get("exact_uncapped"))
    kw = dict(
        n=sv.n if sv.n is not None else st.n,
        d_max=sv.d_max if sv.d_max is not None else st.d_max,
        solver=opts.get("solver", "mip"),
        search=opts.get("search", "binary"),
        alpha=opts.get("alpha", 1.0),
        exclusion_factor=opts.get("exclusion_factor", 1.0),
        sharded=opts.get("sharded"),
        candidate_cap=opts.get("candidate_cap", 0),
        exact_uncapped=exact, backend=cfg.run.backend,
        executor=sv.executor, incremental=sv.incremental,
        compact_frac=sv.compact_frac,
        exclude_training=sv.exclude_training,
        record_log=sv.record_log, seed=st.seed,
        workers=sv.workers, faults=sv.faults, config=cfg)
    kw.update(overrides)
    return SchedulerService(registry, scenario, trainer, **kw)


def run_synthetic(svc: SchedulerService, *, steps: int = 60,
                  churn: float = 0.01, admits_per_step: int = 4,
                  quotes_per_step: int = 0, seed: int = 0,
                  verbose: bool = False) -> Dict:
    """Drive a service with a synthetic arrival/departure trace: each
    virtual minute, ``churn``·C random departures and as many arrivals,
    then ``quotes_per_step`` read-only pricings followed by up to
    ``admits_per_step`` admission requests (stopping early when one is
    infeasible), then one clock tick. Returns the metrics snapshot. The
    trace RNG is this function's own — every fleet change flows through
    the public ``register``/``deregister`` API, so the recorded log
    replays like any other (quotes leave no log entries by design)."""
    rng = np.random.default_rng(seed)
    C = len(svc.registry)
    k = int(round(churn * C))
    for _ in range(int(steps)):
        if k:
            act = np.nonzero(svc.active)[0]
            if act.size:
                svc.deregister(rng.choice(act, size=min(k, act.size),
                                          replace=False))
            ina = np.nonzero(~svc.active)[0]
            if ina.size:
                svc.register(rng.choice(ina, size=min(k, ina.size),
                                        replace=False))
        for _ in range(int(quotes_per_step)):
            svc.quote()
        for _ in range(int(admits_per_step)):
            if svc.admit() is None:
                break
        svc.advance(1)
        if verbose:
            m = svc.metrics.counters
            print(f"t={svc.now:5d} admits={m['admit_requests']:5d} "
                  f"ok={m['admitted']:5d} open={len(svc.admitted):3d}")
    return svc.metrics.snapshot(backend=svc.backend)
