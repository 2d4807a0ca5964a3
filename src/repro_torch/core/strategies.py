"""Client-selection strategies: FedZero and the paper's baselines (§5.1).

* ``FedZeroStrategy``      — forecasts + Algorithm 1 MIP + blocklist fairness
* ``RandomStrategy``       — uniform over currently-available clients
* ``OortStrategy``         — statistical × system utility (Oort [30]),
                             updated each round from available energy/capacity
* over-selection (×1.3)    — ``over_select`` parameter on Random/Oort
* forecast-filter (``fc``) — ``use_forecast_filter`` on Random/Oort: drop
                             clients not expected to reach m_min within d_max
* ``UpperBoundStrategy``   — random selection, no energy/capacity constraints

All strategies see the same :class:`EnvView`; client identity is registry
rows everywhere (``Selection.rows``), and forecasts are **pulled lazily**
through the view: ``spare_fc(rows)`` gathers the candidate rows *before*
the per-round noise draw, so a strategy that has pre-filtered its
candidates pays [k, H] — not [C, H] — noise cost, and strategies that
never consume forecasts (plain Random/Oort) draw none at all.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from .fairness import Blocklist
from .selection import LazySelectionInputs, SelectionInputs, select_clients
from .types import ClientRegistry, Selection
from .utility import UtilityTracker


@dataclasses.dataclass
class EnvView:
    """What a strategy may observe at round start.

    ``excess_now`` and the lazy ``spare_now`` property are actuals;
    forecasts come from the lazy ``excess_fc()``/``spare_fc(rows)``
    accessors (memoized by the scenario store, so repeated calls within
    a round are free). ``spare_now`` materializes the full [C] spare
    column on first touch only — the FedZero path never reads it, which
    matters on sparse million-client stores where an all-rows gather is
    real work. ``dom_rows[c]`` maps registry row c to its domain's row
    in the scenario's ``excess``/``excess_fc`` panels.
    """

    registry: ClientRegistry
    now: int
    excess_now: np.ndarray          # [P] W actual right now
    scenario: object                # ScenarioStore (forecast source)
    horizon: int                    # forecast horizon (d_max)
    dom_rows: np.ndarray            # [C] registry row -> scenario domain row
    _spare_now: Optional[np.ndarray] = None

    @property
    def spare_now(self) -> np.ndarray:
        """[C] fraction of capacity free right now (gathered lazily)."""
        if self._spare_now is None:
            self._spare_now = self.scenario.spare_at(self.now)
        return self._spare_now

    def excess_fc(self) -> np.ndarray:
        """[P, H] excess-power forecast."""
        return self.scenario.excess_forecast(self.now, self.horizon)

    def spare_fc(self, rows: Optional[np.ndarray] = None,
                 horizon: Optional[int] = None) -> Optional[np.ndarray]:
        """[C, H] (or [len(rows), H]) spare-fraction forecast; None under
        the no-load-forecast ablation. Pass candidate rows to gather
        before the noise draw; pass a shorter ``horizon`` to gather only
        the leading columns (row-keyed noise makes the result the exact
        prefix of the full-horizon gather)."""
        return self.scenario.spare_forecast(self.now,
                                            horizon or self.horizon,
                                            rows=rows)


class BaseStrategy:
    name = "base"
    needs_energy_constraints = True

    def __init__(self, registry: ClientRegistry, n: int = 10, d_max: int = 60,
                 seed: int = 0, over_select: float = 1.0,
                 use_forecast_filter: bool = False, backend=None,
                 exact_uncapped: Optional[bool] = None):
        self.registry = registry
        self.n = n
        self.d_max = d_max
        self.over_select = over_select
        self.use_forecast_filter = use_forecast_filter
        # array backend threaded into the selection solvers; strategies
        # that never build SelectionInputs simply ignore it
        self.backend = backend
        # exact-uncapped reach evaluator: None = auto (use the segment
        # overlay whenever the scenario store provides one), True =
        # require it (raise where it cannot apply), False = legacy
        # bounds. Strategies without a sharded path ignore it.
        self.exact_uncapped = exact_uncapped
        self.rng = np.random.default_rng(seed)
        self.utility = UtilityTracker(registry.n_samples_arr)

    # -- hooks -----------------------------------------------------------
    def n_to_select(self):
        return int(math.ceil(self.n * self.over_select))

    def wait_for(self) -> int:
        """Steps to fast-forward when no selection is possible."""
        return 5

    def record_round(self, contributors: np.ndarray, selected: np.ndarray,
                     sample_losses: List[np.ndarray]):
        """``contributors``/``selected`` are registry rows;
        ``sample_losses`` aligns with ``contributors``."""
        for row, losses in zip(contributors, sample_losses):
            self.utility.record(int(row), losses)

    # -- availability ------------------------------------------------------
    def _available(self, env: EnvView) -> np.ndarray:
        """Rows with access to excess energy + spare capacity right now."""
        reg = self.registry
        ok = ((env.excess_now[env.dom_rows] > 0)
              & (env.spare_now * reg.capacity_arr > 0))
        return np.nonzero(ok)[0]

    def _forecast_filter(self, env: EnvView, rows: np.ndarray) -> np.ndarray:
        """Drop rows not expected to reach m_min within d_max (fc
        baselines). Forecast noise is drawn only for ``rows``."""
        rows = np.asarray(rows, dtype=int)
        if not rows.size:
            return rows
        reg = self.registry
        excess_fc = env.excess_fc()
        H = excess_fc.shape[1]
        cap = reg.capacity_arr[rows]
        spare_fc = env.spare_fc(rows)
        if spare_fc is None:
            spare = np.broadcast_to(cap[:, None], (rows.size, H))
        else:
            spare = spare_fc * cap[:, None]
        energy = excess_fc[env.dom_rows[rows]] / reg.delta_arr[rows, None]
        reach = np.minimum(spare, energy).sum(axis=1)
        return rows[reach >= reg.m_min_arr[rows]]

    def select(self, env: EnvView) -> Optional[Selection]:
        raise NotImplementedError


class RandomStrategy(BaseStrategy):
    name = "random"

    def select(self, env: EnvView) -> Optional[Selection]:
        rows = self._available(env)
        if self.use_forecast_filter:
            rows = self._forecast_filter(env, rows)
        k = self.n_to_select()
        if rows.size < k:
            return None
        chosen = self.rng.choice(rows, size=k, replace=False)
        return Selection(rows=np.asarray(chosen, dtype=int),
                         expected_duration=self.d_max)


class OortStrategy(BaseStrategy):
    """Oort [30]: utility = statistical utility × system-speed penalty,
    with ε-greedy exploration. System utility is recomputed each round from
    the available energy and capacity (paper §5.1)."""

    name = "oort"

    def __init__(self, *a, pref_duration: int = 15, alpha_sys: float = 2.0,
                 epsilon: float = 0.1, **kw):
        super().__init__(*a, **kw)
        self.pref_duration = pref_duration
        self.alpha_sys = alpha_sys
        self.epsilon = epsilon

    def _scores(self, env: EnvView, rows: np.ndarray) -> np.ndarray:
        """Utility per candidate row — batched over all candidates."""
        reg = self.registry
        stat = self.utility.sigmas(rows)
        # achievable batches/step right now given energy + capacity
        rate = np.minimum(env.spare_now[rows] * reg.capacity_arr[rows],
                          env.excess_now[env.dom_rows[rows]]
                          / reg.delta_arr[rows])
        with np.errstate(divide="ignore"):
            est_dur = np.where(rate > 0, reg.m_min_arr[rows]
                               / np.maximum(rate, 1e-300), np.inf)
        sys_factor = np.where(est_dur > self.pref_duration,
                              (self.pref_duration
                               / np.maximum(est_dur, 1e-300)) ** self.alpha_sys,
                              1.0)
        return np.where(rate > 0, stat * sys_factor, 0.0)

    def select(self, env: EnvView) -> Optional[Selection]:
        rows = self._available(env)
        if self.use_forecast_filter:
            rows = self._forecast_filter(env, rows)
        k = self.n_to_select()
        if rows.size < k:
            return None
        rows = np.asarray(rows, dtype=int)
        n_explore = int(round(self.epsilon * k))
        scores = self._scores(env, rows)
        order = np.argsort(-scores)
        exploit = rows[order[: k - n_explore]]
        rest = rows[~np.isin(rows, exploit)]
        explore = list(self.rng.choice(rest, size=min(n_explore, rest.size),
                                       replace=False)) \
            if rest.size and n_explore else []
        chosen = [int(x) for x in exploit] + [int(x) for x in explore]
        if len(chosen) < k:
            return None
        return Selection(rows=np.asarray(chosen, dtype=int),
                         expected_duration=self.d_max)


class UpperBoundStrategy(BaseStrategy):
    """Random selection with no energy/capacity constraints (paper's
    Upper bound — still heterogeneous clients, but grid-powered)."""

    name = "upper_bound"
    needs_energy_constraints = False

    def select(self, env: EnvView) -> Optional[Selection]:
        rows = np.arange(len(self.registry))
        chosen = self.rng.choice(rows, size=self.n, replace=False)
        return Selection(rows=np.asarray(chosen, dtype=int),
                         expected_duration=self.d_max)


class FedZeroStrategy(BaseStrategy):
    """FedZero (paper §4). ``fallback``:

    * "wait" (paper default) — if no valid selection exists within d_max,
      idle until conditions improve;
    * "grid" — Alg. 1 line 19's constraint weakening: select by statistical
      utility on spare capacity only, drawing (carbon-accounted) grid
      energy for that round. Used at most every ``grid_cooldown`` rounds so
      the training stays overwhelmingly excess-powered.

    ``sharded`` picks the lazily-gathered selection path
    (:class:`~repro_torch.core.selection.LazySelectionInputs`): candidate spare
    forecasts are gathered in expanding top-score-upper-bound sets
    instead of materialized [K, H] up front. Selections are identical to
    the materialized path; the default (``None``) auto-enables it for
    the greedy solver over a sparse-util scenario store — the
    million-client configuration, where per-round [K, H] slabs are the
    dominant cost. Forcing it over a *dense* store with
    ``error="realistic"`` changes which forecast-noise stream a
    candidate sees (dense noise is positional, not row-keyed), so
    selections stay deterministic but differ from the materialized path;
    sparse stores key noise per row and match exactly.

    ``candidate_cap`` (sharded mode only) bounds per-round forecast
    evaluation to the top-cap candidates by optimistic reach. Exactness
    has a price on degenerate score landscapes — near-uniform σ over few
    hardware profiles ties hundreds of thousands of upper bounds, which
    forces evaluating all of them — so fleet-scale configs trade it for
    a deterministic, documented approximation: admission is exact within
    the capped set (and identical to exact whenever the cap exceeds the
    tie depth). 0 (default) keeps the walk exact.
    """

    name = "fedzero"

    def __init__(self, *a, alpha: float = 1.0, solver: str = "mip",
                 search: str = "binary", exclusion_factor: float = 1.0,
                 fallback: str = "wait", grid_cooldown: int = 10,
                 sharded: Optional[bool] = None, candidate_cap: int = 0,
                 **kw):
        super().__init__(*a, **kw)
        self.blocklist = Blocklist(len(self.registry), alpha=alpha,
                                   seed=kw.get("seed", 0) + 7)
        self.solver = solver
        self.search = search
        # fraction of past participants entering the blocklist (1.0 = paper)
        self.exclusion_factor = exclusion_factor
        self.fallback = fallback
        self.grid_cooldown = grid_cooldown
        self._rounds_since_grid = grid_cooldown
        # fail fast: the sharded path exists for the greedy solver only,
        # and candidate_cap means nothing outside it — a mismatch would
        # otherwise surface mid-run, at the first round with candidates
        if solver != "greedy" and (sharded or candidate_cap
                                   or self.exact_uncapped):
            raise ValueError("sharded selection, candidate_cap and "
                             "exact_uncapped require solver='greedy'")
        # exact_uncapped=True asserts the walk is exact over *everyone*;
        # a candidate cap contradicts that by construction
        if self.exact_uncapped and candidate_cap:
            raise ValueError("exact_uncapped=True is incompatible with a "
                             "positive candidate_cap")
        self.sharded = sharded
        # 0 = exact sharded walk; > 0 bounds per-round evaluation to the
        # top-cap candidates by optimistic reach (fleet-scale mode)
        self.candidate_cap = candidate_cap

    def _grid_fallback(self, env: EnvView) -> Optional[Selection]:
        """Weakened constraints: capacity-only selection on grid energy."""
        sigma = self.utility.sigmas()
        cap = self.registry.capacity_arr
        ok = ~self.blocklist.blocked & (env.spare_now * cap > 0)
        rows = np.nonzero(ok)[0]
        if rows.size < self.n:
            rows = np.nonzero(env.spare_now > 0)[0]
        if rows.size < self.n:
            return None
        chosen = rows[np.lexsort((rows, -sigma[rows]))][: self.n]
        return Selection(rows=chosen, expected_duration=self.d_max, grid=True)

    def select(self, env: EnvView) -> Optional[Selection]:
        self.blocklist.start_round()
        sigma = self.utility.sigmas()
        sigma[self.blocklist.blocked] = 0.0  # §4.4: blocked get σ_c = 0
        excess_fc = env.excess_fc()
        # cheap pre-filter (σ > 0, domain has excess in the window) so the
        # spare-forecast noise draw below is [k, H] for eligible rows only
        dom_ok = excess_fc.sum(axis=1) > 0
        cand = np.nonzero((sigma > 0) & dom_ok[env.dom_rows])[0]
        sel = None
        if cand.size >= self.n:
            inp = self._selection_inputs(env, cand, sigma, excess_fc)
            sel = select_clients(inp, self.n, self.d_max, solver=self.solver,
                                 search=self.search)
        if sel is not None:
            self._rounds_since_grid += 1
            return sel
        if (self.fallback == "grid"
                and self._rounds_since_grid >= self.grid_cooldown):
            sel = self._grid_fallback(env)
            if sel is not None:
                self._rounds_since_grid = 0
            return sel
        return None

    def _selection_inputs(self, env: EnvView, cand: np.ndarray,
                          sigma: np.ndarray, excess_fc: np.ndarray):
        """This strategy's solver inputs over ``cand`` — delegates to the
        module-level :func:`fedzero_selection_inputs` so the always-on
        service (:mod:`repro.service`) prices admissions through the
        byte-identical construction."""
        return fedzero_selection_inputs(
            env, cand, sigma, excess_fc, registry=self.registry,
            backend=self.backend, solver=self.solver, sharded=self.sharded,
            candidate_cap=self.candidate_cap,
            exact_uncapped=self.exact_uncapped)

    def record_round(self, contributors, selected, sample_losses):
        super().record_round(contributors, selected, sample_losses)
        contributors = np.asarray(contributors, dtype=int)
        enter = self.rng.random(contributors.size) < self.exclusion_factor
        self.blocklist.record_participation(contributors[enter])


def fedzero_selection_inputs(env: EnvView, cand: np.ndarray,
                             sigma: np.ndarray, excess_fc: np.ndarray, *,
                             registry: ClientRegistry, backend=None,
                             solver: str = "greedy",
                             sharded: Optional[bool] = None,
                             candidate_cap: int = 0,
                             exact_uncapped: Optional[bool] = None):
    """FedZero's per-round solver inputs over candidate rows ``cand``.

    The single construction path shared by :class:`FedZeroStrategy` and
    the always-on service's admission layer
    (:mod:`repro.service.admission`): given the same environment view,
    candidate set and σ, both produce byte-identical inputs — the
    foundation of the service's batch-parity contract. ``sharded=None``
    auto-picks the lazy path for the greedy solver over a sparse-util
    store (the million-client configuration); the materialized branch
    gathers the [K, H] spare slab up front.
    """
    use_sharded = sharded if sharded is not None else (
        solver == "greedy"
        and getattr(env.scenario, "util_mode", "dense") == "sparse")
    cap_all = registry.capacity_arr
    horizon = excess_fc.shape[1]
    if not use_sharded:
        cap = cap_all[cand]
        spare_fc = env.spare_fc(cand)
        if spare_fc is not None:
            m_spare = spare_fc * cap[:, None]
        else:
            m_spare = np.broadcast_to(
                cap[:, None], (cand.size, horizon)).copy()
        return SelectionInputs(
            registry=registry, m_spare=m_spare, r_excess=excess_fc,
            sigma=sigma[cand], rows=cand, dom=env.dom_rows[cand],
            backend=backend)

    # lazy inputs: the solver pulls candidate forecast blocks through
    # ``spare_fc`` (a per-row sparse gather) on demand
    def spare_of(pos: np.ndarray, h: Optional[int] = None) -> np.ndarray:
        rows = cand[pos]
        spare_fc = env.spare_fc(rows, horizon=h)
        cap = cap_all[rows]
        if spare_fc is None:  # no-load-forecast ablation
            return np.repeat(cap[:, None], h or horizon, axis=1)
        return spare_fc * cap[:, None]

    # exact-uncapped reach evaluator: fetch the candidates' certified
    # spare-segment overlay from the store (None for dense stores and
    # the no-load ablation — under no-load the capacity grant is
    # already exact, so the walk stays exact without an overlay)
    overlay = noise_ub = None
    if exact_uncapped is not False:
        get_ov = getattr(env.scenario, "spare_ub_overlay", None)
        ov = get_ov(env.now, horizon, cand) if get_ov else None
        if ov is not None:
            noise_ub = ov["noise_mult_ub"]
            overlay = ov
    if exact_uncapped and overlay is None \
            and getattr(env.scenario, "error", None) != "no_load":
        raise ValueError(
            "exact_uncapped=True needs a scenario store exposing "
            "spare_ub_overlay (sparse util mode)")

    return LazySelectionInputs(
        registry=registry, spare_of=spare_of, m_spare_ub=cap_all[cand],
        r_excess=excess_fc, sigma=sigma[cand], rows=cand,
        dom=env.dom_rows[cand], candidate_cap=candidate_cap,
        backend=backend, seg_overlay=overlay, noise_mult_ub=noise_ub)


def make_strategy(name, registry: ClientRegistry, **kw) -> BaseStrategy:
    """Factory covering the paper's seven configurations.

    ``name`` is either a strategy key (below) or a declarative strategy
    config section (any object with ``name``/``n``/``d_max``/``seed``/
    ``options`` attributes, e.g. ``experiment.StrategySection``) — the
    experiment API routes through here so config-built strategies and
    hand-wired ones are the same object. Explicit ``kw`` override the
    section's ``options``.
    """
    if not isinstance(name, str):  # a strategy config section
        section = name
        merged = dict(section.options)
        merged.update(kw)
        return make_strategy(section.name, registry, n=section.n,
                             d_max=section.d_max, seed=section.seed, **merged)
    table = {
        "fedzero": lambda: FedZeroStrategy(registry, **kw),
        "random": lambda: RandomStrategy(registry, **kw),
        "random_1.3n": lambda: RandomStrategy(registry, over_select=1.3, **kw),
        "random_fc": lambda: RandomStrategy(registry, use_forecast_filter=True, **kw),
        "oort": lambda: OortStrategy(registry, **kw),
        "oort_1.3n": lambda: OortStrategy(registry, over_select=1.3, **kw),
        "oort_fc": lambda: OortStrategy(registry, use_forecast_filter=True, **kw),
        "upper_bound": lambda: UpperBoundStrategy(registry, **kw),
    }
    return table[name]()
