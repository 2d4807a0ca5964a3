"""Discrete-event FL co-simulation over energy + load traces (paper §5).

Equivalent of the paper's Flower+Vessim testbed: time advances in 1-minute
slots; rounds are scheduled by a strategy, executed under per-domain
excess-energy budgets (two-phase power sharing) and per-client spare
capacity, and idle windows (no feasible selection) are skipped
event-style. Energy accounting covers *all* selected clients, including
stragglers whose work is discarded (paper §4.5).

Scale architecture: client identity is the **registry row** end to end —
selections arrive as row arrays, per-round state is structure-of-arrays
NumPy indexed by selection position, participation is one [C] counter
array, and the scenario is a chunked float32 :class:`ScenarioStore`
whose selected rows' round window arrives in one ``spare_window``
gather. Client names appear exactly once, in ``summary()`` (the
reporting boundary) and at the trainer's dataset lookup. A simulated
minute costs a few array ops per power domain rather than per-client
Python work — 10k-client rounds execute in well under 100 ms (see
benchmarks/scalability.py), 100k clients over a simulated day fit in
well under 1.5 GB, and a 1M-client day runs under the sparse-activity
store + sharded selection in under 4 GB (benchmarks/e2e_simulation.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..data.traces import ScenarioStore

from .power import share_power
from .strategies import BaseStrategy, EnvView
from .types import ClientRegistry, RoundResult, Selection


def execute_round(registry: ClientRegistry, scenario: ScenarioStore,
                  dom_rows: np.ndarray, sel: Selection, now: int,
                  d_max: int, *, constrained: bool = True,
                  need_done: Optional[int] = None,
                  contrib_limit: Optional[int] = None,
                  round_idx: int = 0,
                  drop_step: Optional[np.ndarray] = None,
                  speed: Optional[np.ndarray] = None) -> RoundResult:
    """Run one round's step loop as structure-of-arrays NumPy state.

    A pure function of (registry, scenario, selection, start step): all
    per-client round state (``computed``, ``energy_used``, ``done_min``,
    ``finished_at``) lives in vectors indexed by position in
    ``sel.rows``; spec fields and domain rows are gathered once per
    round, so the per-minute loop does pure array ops (no identity
    lookups of any kind). :class:`FLSimulation` delegates here, and the
    always-on service's round executor (:mod:`repro_torch.service`) calls it
    directly — both produce identical :class:`RoundResult`\\ s for the
    same arguments, which is what lets rounds execute decoupled from the
    batch loop. Semantically identical to the dict-of-state
    implementation it replaced (see tests/test_vectorized_parity.py).

    ``constrained`` is ``strategy.needs_energy_constraints and not grid``
    in the batch loop; ``need_done`` (default: everyone selected) is how
    many finishers end the round early; ``contrib_limit`` (default:
    ``need_done``) caps how many finishers count as contributors.

    ``drop_step`` / ``speed`` are the service's fault-injection hooks
    (:mod:`repro_torch.service.faults`), both aligned with ``sel.rows``:
    a client with ``drop_step[i] >= 0`` computes nothing from that step
    on (mid-round dropout — its partial work still counts toward energy,
    like any straggler's), and ``speed`` scales each client's effective
    compute rate (straggler injection). Both default to ``None``, which
    leaves the loop bit-identical to the fault-free path.
    """
    reg = registry
    sc = scenario
    grid = bool(getattr(sel, "grid", False))
    rows = np.asarray(sel.rows, dtype=int)     # registry row per client
    n_sel = rows.size
    if need_done is None:
        need_done = n_sel
    if contrib_limit is None:
        contrib_limit = need_done
    dom = dom_rows[rows]                       # scenario domain row
    delta = reg.delta_arr[rows]
    capacity = reg.capacity_arr[rows]
    if speed is not None:
        capacity = capacity * np.asarray(speed, dtype=float)
    m_min = reg.m_min_arr[rows]
    m_max = reg.m_max_arr[rows]
    computed = np.zeros(n_sel)
    energy_used = np.zeros(n_sel)
    done_min = np.zeros(n_sel, dtype=bool)
    finished_at = np.full(n_sel, -1, dtype=int)
    # per-domain member groups, in order of first appearance
    groups = [(pi, np.nonzero(dom == pi)[0])
              for pi in dict.fromkeys(dom.tolist())]
    carbon_g = 0.0  # grid-fallback rounds only
    # carbon accounting reads the whole round window in one gather
    # (column j == carbon_at(now + j) exactly; per-step parity pinned
    # by tests/test_grid_fallback.py)
    carbon_win = sc.carbon_window(now, d_max) if grid else None
    # the selected rows' whole round window in one gather: column j is
    # exactly spare_at(now + j, rows), so the per-minute loop below
    # does pure array reads (and a sparse store synthesizes only
    # these n_sel rows, never a [C, ·] column)
    spare_win = sc.spare_window(now, d_max, rows)
    duration = d_max
    for step in range(d_max):
        t = now + step
        if t >= sc.n_steps:
            duration = step
            break
        spare_sel = spare_win[:, step]     # selected clients only: O(n)
        excess = sc.excess_at(t)
        active = computed < m_max
        if drop_step is not None:
            active &= (drop_step < 0) | (step < drop_step)
        for pi, group in groups:
            mem = group[active[group]]
            if mem.size == 0:
                continue
            caps = spare_sel[mem] * capacity[mem]
            if not constrained:
                batches = capacity[mem]
            else:
                budget = float(excess[pi])  # W × 1 min = Wmin
                grants = share_power(budget, delta[mem], computed[mem],
                                     m_min[mem], m_max[mem], caps)
                batches = np.minimum(grants / delta[mem], caps)
            if grid:
                # fallback round: spare-capacity compute on grid power
                batches = caps
            nb = np.minimum(batches, m_max[mem] - computed[mem])
            computed[mem] += nb
            step_e = nb * delta[mem]
            energy_used[mem] += step_e
            if grid:
                ci = float(carbon_win[pi, step])
                # Wmin -> kWh: /60/1000
                carbon_g += float(step_e.sum()) / 60e3 * ci
            newly = mem[~done_min[mem] & (computed[mem] >= m_min[mem])]
            done_min[newly] = True
            finished_at[newly] = step
        if int(done_min.sum()) >= need_done:
            duration = step + 1
            break

    done_pos = np.nonzero(done_min)[0]
    # finish order, ties broken by registry row (matches the old
    # name-sorted order wherever names sort like rows)
    finish_order = done_pos[np.lexsort((rows[done_pos],
                                        finished_at[done_pos]))]
    contrib_idx = finish_order[:contrib_limit]
    straggler_mask = np.ones(n_sel, dtype=bool)
    straggler_mask[contrib_idx] = False
    total_e = float(energy_used.sum())
    return RoundResult(
        round_idx=round_idx, start_step=now, duration=duration,
        participants=rows, contributors=rows[contrib_idx],
        contributor_idx=contrib_idx,
        stragglers=rows[straggler_mask],
        energy_used=total_e,
        grid_energy=total_e if grid else 0.0,
        carbon_g=carbon_g,
        batches=computed,
    )


def execute_round_shard(registry: ClientRegistry, scenario: ScenarioStore,
                        dom_rows: np.ndarray, rows: np.ndarray, now: int,
                        d_max: int, *, constrained: bool = True,
                        drop_step: Optional[np.ndarray] = None,
                        speed: Optional[np.ndarray] = None) -> Dict:
    """One fleet shard's slice of a round, step-resolved.

    Runs the same per-domain step loop as :func:`execute_round` for a
    *subset* of a selection's rows — a shard must hold whole power
    domains (``share_power`` couples clients only within a domain, so a
    domain-complete shard computes bit-identical grants to the full
    loop). Because the early-finish stop depends on clients in *other*
    shards, the shard runs the full window and returns cumulative
    per-step state; :func:`merge_round_shards` then reads off the exact
    values at the merged round's true duration.

    This is what the multiprocess executor ships to workers: thanks to
    the deterministic ``(seed, row, step)`` synthesis contract, a worker
    regenerates its own rows' traces locally (``spare_window`` /
    ``excess_at`` on its private :class:`ScenarioStore`), so the task
    message carries row indices — never trace data.

    Returns ``{"rows", "computed_cum" [n, w], "energy_cum" [n, w],
    "finished_at" [n], "window"}`` where ``w`` is the in-bounds round
    window and column ``j`` holds state *after* step ``j``. Grid
    fallback rounds are not supported here (the service schedules
    excess-powered rounds only).
    """
    reg = registry
    sc = scenario
    rows = np.asarray(rows, dtype=int)
    n = rows.size
    dom = dom_rows[rows]
    delta = reg.delta_arr[rows]
    capacity = reg.capacity_arr[rows]
    if speed is not None:
        capacity = capacity * np.asarray(speed, dtype=float)
    m_min = reg.m_min_arr[rows]
    m_max = reg.m_max_arr[rows]
    window = int(max(0, min(d_max, sc.n_steps - now)))
    computed = np.zeros(n)
    energy_used = np.zeros(n)
    done_min = np.zeros(n, dtype=bool)
    finished_at = np.full(n, -1, dtype=int)
    computed_cum = np.zeros((n, window))
    energy_cum = np.zeros((n, window))
    groups = [(pi, np.nonzero(dom == pi)[0])
              for pi in dict.fromkeys(dom.tolist())]
    spare_win = sc.spare_window(now, d_max, rows)
    for step in range(window):
        t = now + step
        spare_sel = spare_win[:, step]
        excess = sc.excess_at(t)
        active = computed < m_max
        if drop_step is not None:
            active &= (drop_step < 0) | (step < drop_step)
        for pi, group in groups:
            mem = group[active[group]]
            if mem.size == 0:
                continue
            caps = spare_sel[mem] * capacity[mem]
            if not constrained:
                batches = capacity[mem]
            else:
                budget = float(excess[pi])
                grants = share_power(budget, delta[mem], computed[mem],
                                     m_min[mem], m_max[mem], caps)
                batches = np.minimum(grants / delta[mem], caps)
            nb = np.minimum(batches, m_max[mem] - computed[mem])
            computed[mem] += nb
            energy_used[mem] += nb * delta[mem]
            newly = mem[~done_min[mem] & (computed[mem] >= m_min[mem])]
            done_min[newly] = True
            finished_at[newly] = step
        computed_cum[:, step] = computed
        energy_cum[:, step] = energy_used
    return {"rows": rows, "computed_cum": computed_cum,
            "energy_cum": energy_cum, "finished_at": finished_at,
            "window": window}


def merge_round_shards(sel: Selection, shards: List[Dict], now: int,
                       d_max: int, *, n_steps: int,
                       need_done: Optional[int] = None,
                       contrib_limit: Optional[int] = None,
                       round_idx: int = 0) -> RoundResult:
    """Merge :func:`execute_round_shard` results into one
    :class:`RoundResult` — including the **partial-round close path**.

    With every shard present this reconstructs :func:`execute_round`'s
    output bit-for-bit (pinned by tests/test_executor_mp.py): the true
    duration is the ``need_done``-th smallest finish step + 1, and each
    client's batches/energy are read from its shard's cumulative state
    at exactly that step — no re-summation, so float accumulation order
    matches the sequential loop.

    Shards may be *missing*: a round whose worker died past the retry
    budget closes partially — the dead shard's clients keep their
    zeroed state (no batches, no energy, never finished), so they
    surface as stragglers, never count toward the early-finish quorum,
    and the round runs to the full window. The executor layers the
    zero-utility σ/blocklist bookkeeping for those rows on top of this
    (see :mod:`repro_torch.service.executors`).
    """
    rows = np.asarray(sel.rows, dtype=int)
    n_sel = rows.size
    if need_done is None:
        need_done = n_sel
    if contrib_limit is None:
        contrib_limit = need_done
    window = int(max(0, min(d_max, n_steps - now)))
    computed_cum = np.zeros((n_sel, window))
    energy_cum = np.zeros((n_sel, window))
    finished_at = np.full(n_sel, -1, dtype=int)
    pos_of = {int(r): i for i, r in enumerate(rows)}
    for sh in shards:
        if sh["window"] != window:
            raise ValueError("shard window mismatch: "
                             f"{sh['window']} != {window}")
        p = np.array([pos_of[int(r)] for r in sh["rows"]], dtype=int)
        computed_cum[p] = sh["computed_cum"]
        energy_cum[p] = sh["energy_cum"]
        finished_at[p] = sh["finished_at"]
    fin = finished_at[finished_at >= 0]
    if need_done > 0 and fin.size >= need_done:
        # the step the early-finish stop would have fired on
        duration = int(np.partition(fin, need_done - 1)[need_done - 1]) + 1
    else:
        duration = window
    if duration > 0:
        computed = computed_cum[:, duration - 1].copy()
        energy_used = energy_cum[:, duration - 1].copy()
    else:
        computed = np.zeros(n_sel)
        energy_used = np.zeros(n_sel)
    done_min = (finished_at >= 0) & (finished_at < duration)
    done_pos = np.nonzero(done_min)[0]
    finish_order = done_pos[np.lexsort((rows[done_pos],
                                        finished_at[done_pos]))]
    contrib_idx = finish_order[:contrib_limit]
    straggler_mask = np.ones(n_sel, dtype=bool)
    straggler_mask[contrib_idx] = False
    total_e = float(energy_used.sum())
    return RoundResult(
        round_idx=round_idx, start_step=now, duration=duration,
        participants=rows, contributors=rows[contrib_idx],
        contributor_idx=contrib_idx,
        stragglers=rows[straggler_mask],
        energy_used=total_e, grid_energy=0.0, carbon_g=0.0,
        batches=computed,
    )


class FLSimulation:
    def __init__(self, registry: ClientRegistry, scenario: ScenarioStore,
                 strategy: BaseStrategy, trainer, d_max: int = 60,
                 eval_every: int = 5, seed: int = 0):
        self.registry = registry
        self.scenario = scenario
        self.strategy = strategy
        self.trainer = trainer
        self.d_max = d_max
        self.eval_every = eval_every
        self.now = 0
        self.round_idx = 0
        self.results: List[RoundResult] = []
        self._dom_rows = registry.domain_rows(scenario.domain_names)
        self.participation = np.zeros(len(registry), dtype=np.int64)
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------
    def _env_view(self) -> EnvView:
        # spare_now is a lazy EnvView property: only strategies that read
        # it (grid fallback, Random/Oort availability) pay the [C] gather
        sc = self.scenario
        return EnvView(
            registry=self.registry, now=self.now,
            excess_now=sc.excess_at(self.now),
            scenario=sc, horizon=self.d_max,
            dom_rows=self._dom_rows,
        )

    # ------------------------------------------------------------------
    def _execute_round(self, sel: Selection) -> RoundResult:
        """One round via :func:`execute_round` with this run's strategy
        policy (early-finish count, contributor cap, grid weakening)."""
        grid = bool(getattr(sel, "grid", False))
        need_done = (self.strategy.n if self.strategy.over_select > 1.0
                     else len(np.asarray(sel.rows)))
        return execute_round(
            self.registry, self.scenario, self._dom_rows, sel, self.now,
            self.d_max,
            constrained=self.strategy.needs_energy_constraints and not grid,
            need_done=need_done,
            contrib_limit=max(self.strategy.n, need_done),
            round_idx=self.round_idx)

    # ------------------------------------------------------------------
    def run(self, until_step: Optional[int] = None, max_rounds: Optional[int] = None,
            target_metric: Optional[float] = None, verbose: bool = False):
        until = until_step if until_step is not None else self.scenario.n_steps - 1
        while self.now < until:
            if max_rounds is not None and self.round_idx >= max_rounds:
                break
            env = self._env_view()
            sel = self.strategy.select(env)
            if sel is None or not len(sel.rows):
                self.now += self.strategy.wait_for()  # idle fast-forward
                continue
            rr = self._execute_round(sel)
            # local training + aggregation for contributors
            sample_losses: List[np.ndarray] = []
            if rr.contributors.size:
                updates = []
                for pos in rr.contributor_idx:
                    upd = self.trainer.local_update(int(rr.participants[pos]),
                                                    float(rr.batches[pos]))
                    sample_losses.append(upd["sample_losses"])
                    updates.append(upd)
                rr.train_loss = float(np.mean(
                    [u["mean_loss"] for u in updates]))
                self.trainer.aggregate(updates)
                self.participation[rr.contributors] += 1
            self.strategy.record_round(rr.contributors, rr.participants,
                                       sample_losses)
            if self.eval_every and self.round_idx % self.eval_every == 0:
                rr.eval_metric = float(self.trainer.evaluate())
            self.results.append(rr)
            self.round_idx += 1
            self.now += max(rr.duration, 1)
            if verbose:
                print(f"[{self.strategy.name}] round {rr.round_idx:4d} "
                      f"t={rr.start_step:6d} dur={rr.duration:3d} "
                      f"contrib={len(rr.contributors):2d} "
                      f"E={rr.energy_used/60:.1f}Wh loss={rr.train_loss:.4f} "
                      f"metric={rr.eval_metric:.4f}")
            if target_metric is not None and rr.eval_metric == rr.eval_metric \
                    and rr.eval_metric >= target_metric:
                break
        return self.summary()

    # ------------------------------------------------------------------
    def summary(self, names: bool = False) -> Dict:
        """Aggregate run statistics.

        ``participation`` is keyed by registry row by default — a [C]
        list where entry r is row r's contribution count — so summarizing
        a fleet-scale run never materializes the name list (array-built
        registries generate names lazily, and a 1M-entry name-keyed dict
        is exactly the O(C) Python-object cost the row-ID refactor
        removed from the scheduling path). Pass ``names=True`` at the
        reporting boundary to get the legacy name-keyed dict instead.
        """
        total_energy = sum(r.energy_used for r in self.results)
        metrics, cum_e = [], 0.0
        for r in self.results:
            cum_e += r.energy_used
            if r.eval_metric == r.eval_metric:
                metrics.append((r.start_step + r.duration, r.eval_metric,
                                cum_e / 60.0))  # (min, metric, cum Wh)
        best = max((m for _, m, _ in metrics), default=float("nan"))
        durations = [r.duration for r in self.results]
        return {
            "strategy": self.strategy.name,
            "rounds": len(self.results),
            "sim_minutes": self.now,
            "total_energy_wh": total_energy / 60.0,
            "grid_energy_wh": sum(r.grid_energy for r in self.results) / 60.0,
            "carbon_g": sum(r.carbon_g for r in self.results),
            "grid_rounds": sum(1 for r in self.results if r.grid_energy > 0),
            "best_metric": best,
            "metric_curve": metrics,
            "mean_round_duration": float(np.mean(durations)) if durations else 0,
            "std_round_duration": float(np.std(durations)) if durations else 0,
            "participation": {name: int(count) for name, count in
                              zip(self.registry.client_names,
                                  self.participation)}
            if names else self.participation.astype(int).tolist(),
        }

    def time_energy_to_metric(self, target: float):
        """(sim minutes, Wh) until eval metric first reached target."""
        energy = 0.0
        for r in self.results:
            energy += r.energy_used
            if r.eval_metric == r.eval_metric and r.eval_metric >= target:
                return r.start_step + r.duration, energy / 60.0
        return None, None
