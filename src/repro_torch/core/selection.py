"""FedZero client selection: Algorithm 1 + the per-duration MIP (paper §4.3).

For each candidate round duration ``d`` (binary-searched up to d_max), we
solve

    max  Σ_c b_c · σ_c · Σ_t m_exp[c,t]
    s.t. m_min·b_c ≤ Σ_t m_exp[c,t] ≤ m_max·b_c        ∀c      (1)
         Σ_{c∈C_p} δ_c · m_exp[c,t] ≤ r_{p,t}          ∀p,t    (2)
         Σ_c b_c = n                                            (3)
         0 ≤ m_exp[c,t] ≤ m_spare[c,t]

with b_c binary. The paper solves this with Gurobi; we use
``scipy.optimize.milp`` (HiGHS). For very large instances a greedy
waterfilling heuristic (``solver='greedy'``) reproduces the selection with
near-identical quality at O(C·d + C log C) cost — used by the scalability
benchmark beyond the exact-MIP comfort zone and validated against the MIP
in tests.

Implementation notes (100k-client scale): identity is registry rows
throughout — :class:`SelectionInputs` carries a ``rows`` array (registry
row per candidate) and ``dom`` (domain row per candidate); no client
names or name-keyed dicts appear anywhere in this module. All per-client
work is batched NumPy over the registry's structure-of-arrays mirrors.
A per-call :class:`_ProbeCache` shares the expensive intermediates
(SoA gather, cumulative reachability/excess sums) across the O(log d_max)
binary-search probes. The MIP path builds **one** HiGHS model at the
largest probe duration and re-solves it per probe with only variable
bounds changed (m vars beyond the probe's ``d`` pinned to 0) — the
constraint matrix is never reassembled (:class:`_WarmMip`). Greedy
probes run **feasibility-only** (stop at ``n`` admissions, no batch
schedule materialization); the full schedule is built once at the
minimal feasible ``d``. Greedy admissions are committed in batched chunk
passes over the rank queue — see :func:`_solve_greedy`; the per-client
sequential commit loop survives as :func:`_solve_greedy_sequential`, the
bit-exact reference that the property/parity suite pins the batched
variant against.

Million-candidate scale: :class:`LazySelectionInputs` +
:class:`_LazyGreedy` replace the materialized [K, H] ``m_spare`` slab
with a block provider — candidates are ranked by a cheap score upper
bound and real forecasts are gathered only for expanding top sets until
admissions are provably exact (or, with ``candidate_cap``, exact within
the capped set). FedZero auto-routes here for the greedy solver over
sparse-util stores.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, List, Optional

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from ..backend import get_backend
from .types import ClientRegistry, Selection


@dataclasses.dataclass
class SelectionInputs:
    """Per-round inputs to the optimizer (forecasts + utility weights).

    Candidate identity is positional: row k of ``m_spare``/``sigma`` is
    candidate k, whose registry row is ``rows[k]`` and whose power domain
    is row ``dom[k]`` of ``r_excess``.
    """

    registry: ClientRegistry
    m_spare: np.ndarray        # [K, H] forecast spare capacity (batches/step)
    r_excess: np.ndarray       # [P, H] forecast excess energy (Wmin/step)
    sigma: np.ndarray          # [K] statistical utility (0 = blocked)
    rows: np.ndarray           # [K] registry row per candidate
    dom: np.ndarray            # [K] domain row (into r_excess) per candidate
    backend: object = None     # ArrayBackend / name / None (cuda)

    def arrays(self):
        """SoA client data gathered for the candidate rows (cached).

        Returns ``(delta[K], m_min[K], m_max[K], dom[K])``.
        """
        cached = getattr(self, "_soa", None)
        if cached is None:
            reg = self.registry
            cached = (reg.delta_arr[self.rows], reg.m_min_arr[self.rows],
                      reg.m_max_arr[self.rows], self.dom)
            self._soa = cached
        return cached


class _ProbeCache:
    """Shared intermediates for one ``select_clients`` call.

    Binary search probes several durations ``d`` over the *same* inputs;
    everything that is d-independent — or a cumulative sum that any ``d``
    can slice — is computed once here:

    * ``reach_cum[K, H]``: cumulative Σ_t min(m_spare, r_excess/δ), so the
      Alg. 1 line-11 reachability test at duration d is ``reach_cum[:, d-1]``;
    * ``excess_cum[P, H]``: cumulative domain excess for the line-6 filter;
    * ``ub[K, H]``: clipped m_spare slab for the MIP variable upper bounds.
    """

    def __init__(self, inp: SelectionInputs):
        delta, m_min, m_max, dom = inp.arrays()
        self.delta, self.m_min, self.m_max, self.dom = delta, m_min, m_max, dom
        self._inp = inp
        self.bk = get_backend(inp.backend)
        self.excess_cum = np.cumsum(inp.r_excess, axis=1)
        self.reach_cum = self.bk.take_reach(inp.m_spare,
                                            inp.r_excess[dom], delta)
        self._ub = None
        # greedy rank memo: rank depends on d only through the clamped
        # duration dd (reach_cum column), so probes at the same dd reuse
        # the O(K log K) lexsort. Counters feed benchmarks/scalability.py.
        self._rank_memo: dict = {}
        self._rank_soa: Optional[tuple] = None  # (el, gathered SoA) share
        self.rank_queries = 0
        self.rank_builds = 0

    @property
    def ub(self) -> np.ndarray:
        """Clipped m_spare slab — only the MIP needs it, built lazily."""
        if self._ub is None:
            self._ub = self.bk.relu(self._inp.m_spare)
        return self._ub


def _eligible(inp: SelectionInputs, d: int,
              cache: Optional[_ProbeCache] = None) -> List[int]:
    """Pre-filters of Algorithm 1 (lines 6, 8, 11) — vectorized over K."""
    if cache is None:
        cache = _ProbeCache(inp)
    # clamp to the forecast horizon: a probe beyond H sees the same windows
    # as d == H (the [:d] slices of the loop implementation did the same)
    dd = min(d, cache.reach_cum.shape[1])
    if dd <= 0:
        return []
    # line 6: domains with excess energy somewhere in [0, d) — the paper
    # filters domains with no excess at all in the window (a domain with a
    # single zero step can still power clients in other steps).
    dom_ok = cache.excess_cum[:, dd - 1] > 0
    # line 8 (σ > 0, blocklist) + line 11 (capacity+energy reach m_min in d)
    mask = ((inp.sigma > 0) & dom_ok[cache.dom]
            & (cache.reach_cum[:, dd - 1] >= cache.m_min))
    return np.nonzero(mask)[0].tolist()


class _WarmMip:
    """One HiGHS model reused across all binary-search probes.

    The model is assembled **once** at ``d_cap`` (the largest duration any
    probe can see) over the eligible set at ``d_cap`` — a superset of
    every smaller probe's eligible set. A probe at duration ``d`` then
    only swaps variable bounds: the upper bound of every m[c, t] with
    ``t ≥ d`` is pinned to 0, which (a) zeroes those steps out of the
    objective and the budget rows and (b) lets HiGHS presolve drop them.
    Candidates unable to reach m_min within ``d`` need no explicit
    exclusion — constraint (1) already forces their b_c to 0, because the
    reachability test optimistically grants each client the whole domain
    budget. Constraint rows (budgets for t ≥ d) are trivially satisfied
    by the pinned variables, so lo/hi never change.
    """

    def __init__(self, inp: SelectionInputs, cache: _ProbeCache, n: int):
        self.d_cap = cache.reach_cum.shape[1]
        self.el = np.asarray(_eligible(inp, self.d_cap, cache), dtype=int)
        k, d = self.el.size, self.d_cap
        self.k = k
        if k < n:
            return  # no probe can ever succeed; solve() never called
        el = self.el
        delta, m_min, m_max = cache.delta[el], cache.m_min[el], cache.m_max[el]
        dom = cache.dom[el]
        nv = k + k * d  # b vars then m vars (client-major)
        c_obj = np.zeros(nv)
        c_obj[k:] = -np.repeat(inp.sigma[el], d)  # maximize
        jj = np.arange(k)
        j_rep = np.repeat(jj, d)                  # [k*d] local client per m var
        t_rep = np.tile(np.arange(d), k)          # [k*d] step per m var
        mcols = k + j_rep * d + t_rep
        # (1) m_min·b ≤ Σ m  and  Σ m ≤ m_max·b   (rows 2j, 2j+1)
        rows1 = np.concatenate([2 * j_rep, 2 * j_rep + 1, 2 * jj, 2 * jj + 1])
        cols1 = np.concatenate([mcols, mcols, jj, jj])
        vals1 = np.concatenate([np.ones(2 * k * d), -m_min, -m_max])
        lo1 = np.tile([0.0, -np.inf], k)
        hi1 = np.tile([np.inf, 0.0], k)
        # (2) per-domain per-step energy budget, domains ranked by first
        # appearance among the eligible candidates
        uniq, first, inv = np.unique(dom, return_index=True,
                                     return_inverse=True)
        by_first = np.argsort(first, kind="stable")
        rank_of = np.empty(uniq.size, dtype=int)
        rank_of[by_first] = np.arange(uniq.size)
        rank = rank_of[inv]                       # [k] domain rank per client
        rows2 = 2 * k + rank[j_rep] * d + t_rep
        vals2 = delta[j_rep]
        lo2 = np.full(uniq.size * d, -np.inf)
        hi2 = inp.r_excess[uniq[by_first], :d].ravel()
        # (3) exactly n clients
        r3 = 2 * k + uniq.size * d
        rows = np.concatenate([rows1, rows2, np.full(k, r3)])
        cols = np.concatenate([cols1, mcols, jj])
        vals = np.concatenate([vals1, vals2, np.ones(k)])
        self.A = sp.csr_matrix((vals, (rows, cols)), shape=(r3 + 1, nv))
        self.lo = np.concatenate([lo1, lo2, [float(n)]])
        self.hi = np.concatenate([hi1, hi2, [float(n)]])
        self.c_obj = c_obj
        self.integrality = np.zeros(nv)
        self.integrality[:k] = 1
        self.ub_full = np.ones(nv)
        self.ub_full[k:] = cache.ub[el, :d].ravel()
        self.n = n

    def solve(self, d: int, time_limit: float):
        """Probe at duration ``d``: bounds swap + re-solve, no rebuild."""
        k, d_cap = self.k, self.d_cap
        dd = min(d, d_cap)
        ub = self.ub_full.copy()
        if dd < d_cap:
            ub[k:].reshape(k, d_cap)[:, dd:] = 0.0
        res = milp(c=self.c_obj,
                   constraints=LinearConstraint(self.A, self.lo, self.hi),
                   bounds=Bounds(np.zeros_like(ub), ub),
                   integrality=self.integrality,
                   options={"time_limit": time_limit, "presolve": True})
        if not res.success or res.x is None:
            return None
        b = res.x[:k] > 0.5
        if b.sum() != self.n:
            return None
        sel = np.nonzero(b)[0]
        batches = res.x[k:].reshape(k, d_cap)[sel][:, :dd]
        return self.el[sel].tolist(), batches


def _solve_mip(inp: SelectionInputs, d: int, n: int, eligible: List[int],
               time_limit: float = 60.0,
               cache: Optional[_ProbeCache] = None,
               model: Optional[_WarmMip] = None):
    """Exact MIP via HiGHS. Returns (selected candidate rows,
    batches [n, d]) or None. ``model`` carries the warm (pre-assembled)
    probe model across binary-search probes; without one, a single-use
    model is built."""
    if cache is None:
        cache = _ProbeCache(inp)
    if model is None:
        model = _WarmMip(inp, cache, n)
    if model.k < n or len(eligible) < n:
        return None
    return model.solve(d, time_limit)


def _rank_candidates(inp: SelectionInputs, d: int, el: np.ndarray,
                     cache: _ProbeCache):
    """Shared greedy scoring pass: feasible candidates in rank order.

    The achievable-batch total against the untouched budget is exactly the
    cached cumulative reachability (``reach_cum``), so scoring is three
    gathers and a lexsort — no per-probe [k, d] slab. Rank is descending
    score with ties broken by descending candidate row (matches sorting
    (score, row) tuples in reverse).

    Rank depends on ``d`` only through the clamped column ``dd`` of
    ``reach_cum``, so results are memoized per ``dd`` in the probe cache:
    the O(K log K) lexsort — the dominant per-probe cost at 100k clients —
    runs once per *distinct* probe duration instead of once per probe
    (binary search re-probing the minimal feasible d, the final full
    solve, and horizon-clamped probes all hit the memo). The eligible set
    is part of the memo key via an exact array comparison, so callers
    passing a hand-built ``el`` can never read a stale rank.
    """
    dd = min(d, cache.reach_cum.shape[1])
    cache.rank_queries += 1
    hit = cache._rank_memo.get(dd)
    if hit is not None and hit[0].size == len(el) \
            and np.array_equal(hit[0], el):
        return hit[1], hit[2]
    cache.rank_builds += 1
    # the SoA gathers and the el key depend only on the eligible set, not
    # on dd — share them across memo entries while el is unchanged (the
    # common case: most probe durations see the same eligible set)
    prev = cache._rank_soa
    if prev is not None and prev[0].size == len(el) \
            and np.array_equal(prev[0], el):
        el_key, soa = prev
    else:
        el_key = np.array(el, dtype=int, copy=True)
        soa = (cache.delta[el], cache.m_min[el], cache.m_max[el],
               cache.dom[el])
        cache._rank_soa = (el_key, soa)
    delta, m_min, m_max, dom = soa
    if dd <= 0:
        return np.empty(0, dtype=int), soa
    score, feas = cache.bk.greedy_scores(inp.sigma[el],
                                         cache.reach_cum[el, dd - 1],
                                         m_min, m_max)
    cand = np.nonzero(feas)[0]
    cand = cand[np.lexsort((-el[cand], -score[cand]))]
    cache._rank_memo[dd] = (el_key, cand, soa)
    return cand, soa


def _solve_greedy_sequential(inp: SelectionInputs, d: int, n: int,
                             eligible: List[int],
                             cache: Optional[_ProbeCache] = None):
    """Reference greedy: admit in rank order, one commit per admitted
    client, water-filling each domain's per-step budget.

    Kept as the semantic pin for :func:`_solve_greedy` (see
    tests/test_greedy_properties.py) and for instances small enough that
    batching doesn't pay.
    """
    if cache is None:
        cache = _ProbeCache(inp)
    el = np.asarray(eligible, dtype=int)
    cand, (delta, m_min, m_max, dom) = _rank_candidates(inp, d, el, cache)
    spare = inp.m_spare[el, :d]
    budget = inp.r_excess[:, :d].copy()  # remaining energy per domain/step

    chosen, batches = [], []
    for j in cand:
        pi = dom[j]
        take = np.minimum(spare[j], budget[pi] / delta[j])
        cum = np.cumsum(take)
        total_j = min(cum[-1] if d else 0.0, m_max[j])
        if total_j < m_min[j]:
            continue
        # cap at m_max: stop allocating once reached
        overshoot = cum - m_max[j]
        take = np.where(overshoot > 0, np.maximum(take - overshoot, 0.0), take)
        budget[pi] -= take * delta[j]
        chosen.append(int(el[j]))
        batches.append(take)
        if len(chosen) == n:
            return chosen, np.array(batches)
    return None


def _solve_greedy(inp: SelectionInputs, d: int, n: int, eligible: List[int],
                  cache: Optional[_ProbeCache] = None,
                  feasibility_only: bool = False):
    """Greedy heuristic: rank clients by σ_c × energy-feasible batches, then
    admit in rank order while water-filling per-domain per-step budgets.

    Clients in different power domains never contend for the same budget,
    so admissions are water-filled with *batched* passes over the rank
    queue instead of one Python iteration per admitted client: each pass
    takes a chunk of candidates, computes their optimistic takes against
    their domains' current budgets in one [chunk, d] batch, bulk-rejects
    rows that cannot reach m_min (their reachable total only shrinks as
    budgets drain, so rejection against the current budget is exact), and
    admits the longest prefix whose pre-cap drains stay under their
    domain budget — accumulated per domain, clients of different domains
    never interact — by a 1e-9 relative margin. Margin-valid rows are
    spare/m_max-limited at every step, so their takes are bit-identical
    to what the sequential commit loop would compute; a budget-limited
    row at the head of the queue falls back to an exact single admission.
    Every pass either admits ≥ 1 client or retires a whole chunk, so the
    result matches :func:`_solve_greedy_sequential` exactly.

    ``feasibility_only`` is the binary-search probe mode: identical
    admission decisions (so feasibility answers match the full solve
    bit-exactly), but chunks start at ``n`` rows instead of ``4n`` and no
    batch schedule is materialized — the caller re-solves fully once at
    the minimal feasible duration. Returns ``(chosen, None)``.
    """
    if cache is None:
        cache = _ProbeCache(inp)
    el = np.asarray(eligible, dtype=int)
    cand, (delta, m_min, m_max, dom) = _rank_candidates(inp, d, el, cache)
    if cand.size < n:
        return None

    budgets = inp.r_excess[:, :d].copy()   # [P, d] remaining energy
    el_rows = el[cand]                     # candidate rows, rank order
    dom_c = dom[cand]
    # probes only need the first n admissions, so feasibility mode sweeps
    # with the smallest exact chunk; the full solve keeps a deeper queue
    chunk_size = max(n, 16) if feasibility_only else max(4 * n, 64)
    chosen, batches = [], []
    rows, drows, srows = cand, dom_c, el_rows
    while rows.size and len(chosen) < n:
        nc = min(chunk_size, rows.size)
        r, dr = rows[:nc], drows[:nc]
        # one fused backend pass: takes, feasibility, overshoot capping
        # and the per-domain margin prefix-scan (decision-safe, vmapped
        # on a device backend) — a single device dispatch per chunk
        feas, ok_m, capped = cache.bk.admit_domains(
            inp.m_spare[srows[:nc], :d], budgets, dr, delta[r],
            m_min[r], m_max[r])
        if not feas.any():
            rows, drows, srows = rows[nc:], drows[nc:], srows[nc:]
            chunk_size *= 2  # unproductive pass: sweep faster
            continue
        keep = np.nonzero(feas)[0]
        r, dr = r[keep], dr[keep]
        capped, ok = capped[keep], ok_m[keep]
        bad = np.nonzero(~ok)[0]
        npfx = int(bad[0]) if bad.size else r.size
        npfx = max(1, min(npfx, n - len(chosen)))
        for i in range(npfx):  # ≤ n tiny [d] commits, same arithmetic as
            budgets[dr[i]] -= capped[i] * delta[r[i]]  # the sequential loop
            chosen.append(int(el[r[i]]))
            if not feasibility_only:
                batches.append(capped[i])
        survivors = keep[npfx:]
        rows = np.concatenate([r[npfx:], rows[nc:]])
        drows = np.concatenate([dr[npfx:], drows[nc:]])
        srows = np.concatenate([srows[:nc][survivors], srows[nc:]])
    if len(chosen) < n:
        return None
    return chosen, (None if feasibility_only else np.array(batches))


@dataclasses.dataclass
class LazySelectionInputs:
    """Sharded, lazily-gathered per-round inputs for fleet-scale greedy.

    The materialized :class:`SelectionInputs` carries the whole
    ``m_spare`` [K, H] slab — affordable at 100k candidates, not at 1M.
    This variant carries a **provider** instead: ``spare_of(pos)`` maps
    candidate positions (indices into ``sigma``/``rows``/``dom``) to
    their m_spare block [len(pos), H], typically a sparse-store
    row-gather behind ``EnvView.spare_fc``. The solver ranks candidates
    by a cheap per-candidate upper bound (``m_spare_ub`` — the per-step
    spare-capacity ceiling, i.e. capacity — against the domain's
    cumulative excess) and gathers blocks of real forecasts only until
    the admission decisions are provably identical to evaluating
    everyone (:class:`_LazyGreedy`), so a round touches O(admitted +
    near-miss) candidate rows, never the full [C, T] or even [K, H]
    slab.
    """

    registry: ClientRegistry
    # positions -> [B, H] forecast block. Providers may accept a second
    # parameter *named* ``h`` or ``horizon`` — (positions, h) -> [B, h];
    # the engine detects it by name and then gathers only the leads a
    # probe actually needs. The returned block must be the column prefix
    # of the full-horizon gather, bit for bit (row-keyed noise makes
    # this hold for both scenario stores; pinned by
    # tests/test_selection_exactness.py).
    spare_of: Callable[..., np.ndarray]
    m_spare_ub: np.ndarray     # [K] per-step upper bound on m_spare
    r_excess: np.ndarray       # [P, H] forecast excess energy (Wmin/step)
    sigma: np.ndarray          # [K] statistical utility (0 = blocked)
    rows: np.ndarray           # [K] registry row per candidate
    dom: np.ndarray            # [K] domain row (into r_excess) per candidate
    block: int = 1024          # rows gathered per evaluation block
    # candidate_cap = 0 keeps the walk exact: it expands until admissions
    # are provably identical to evaluating every candidate. Without a
    # segment overlay, degenerate score landscapes (near-uniform σ) can
    # make that mean evaluating everyone; a positive cap then bounds
    # evaluation to the top-cap candidates by score upper bound —
    # admission exact *within* that set (a documented approximation,
    # deterministic, identical to exact whenever cap ≥ the tie depth).
    # With ``seg_overlay`` the exact walk terminates lazily even on tied
    # landscapes (tight bounds + the tie-exact admission rule), so the
    # cap is unnecessary — the `1m_1day` benchmark runs uncapped.
    candidate_cap: int = 0
    backend: object = None     # ArrayBackend / name / None (cuda)
    # exact-uncapped reach evaluator inputs (optional): the candidates'
    # spare-fraction upper bounds as regime segments over the forecast
    # window (``ScenarioStore.spare_ub_overlay`` CSR dict, window-
    # relative steps, indexed by candidate position) plus the per-lead
    # forecast-noise multiplier bound. When present, score upper bounds
    # come from the per-domain concave reach function Σ_t min(x, E_t)
    # instead of the loose full-spare grant. Contract: every realizable
    # ``spare_of(pos)`` cell in segment s at lead j must be
    # ≤ min(x_ub[s]·noise_mult_ub[j], 1) · m_spare_ub[pos].
    seg_overlay: Optional[dict] = None
    noise_mult_ub: Optional[np.ndarray] = None


class _LazyGreedy:
    """Greedy admission over lazily-evaluated top-candidate sets.

    Per probed duration ``dd`` the engine computes a per-candidate
    **score upper bound**, selects the top-M candidates by that bound
    with one O(K) backend ``top_m`` (deterministic position-descending
    ties, no full K-sized sort anywhere), and gathers real forecasts
    only for them. Two bound flavours:

    * **legacy** (no overlay): full spare every step against the
      domain's cumulative excess — the line-11 test's optimistic grant,
      clipped by m_max and scaled by σ (backend ``score_ub``);
    * **segment reach** (``seg_overlay`` present): the per-domain
      concave piecewise-linear reach ``Σ_t min(x, E_t)`` queried per
      candidate regime segment with its certified spare threshold
      (backend ``reach_tables``/``segment_reach``, per-candidate sums
      assembled on the host, inflated by ``REACH_SLACK`` — decision-
      safe). Busy candidates price far below σ·m_max, which collapses
      the degenerate tie plateaus that used to force ``candidate_cap``.

    Admission walks the evaluated candidates in true-score order — ties
    broken exactly like :func:`_rank_candidates` (descending candidate
    position) — and may touch a candidate while its true score is
    strictly above ``bound``, the exact maximum upper bound among the
    unselected remainder (``top_m`` returns the (M+1)-th value). A
    candidate whose true score *equals* the bound is still provably
    admissible while its position exceeds every unselected bound-tie's
    position (``top_m`` keeps the largest-position ties, so the
    evaluated ties extend the global (score desc, pos desc) order as a
    prefix down to that position) — the **tie-exact rule** that lets
    fully-idle clients tied at σ·m_max admit without materializing the
    whole plateau. If the walk still runs out before n admissions, M
    expands geometrically, reusing every evaluation, and the probe
    replays. Admissions are therefore bit-identical to materializing
    ``m_spare`` for all K candidates and running :func:`_solve_greedy`
    (pinned by tests/test_sparse_util.py and
    tests/test_selection_exactness.py), but a round evaluates
    O(admitted + near-miss) candidates — the property that makes exact
    uncapped 1M-candidate rounds affordable. Evaluations and per-``dd``
    bound arrays persist across the O(log d_max) probes of one
    ``select_clients`` call; each probe replays admission against its
    own budget copy, mirroring the sequential reference commit loop.
    """

    def __init__(self, inp: LazySelectionInputs, n: int,
                 reach_state: Optional[dict] = None):
        reg = inp.registry
        self.inp = inp
        self.n = n
        self.bk = get_backend(inp.backend)
        rows = np.asarray(inp.rows, dtype=int)
        self.delta = reg.delta_arr[rows]
        self.m_min = reg.m_min_arr[rows]
        self.m_max = reg.m_max_arr[rows]
        self.dom = np.asarray(inp.dom, dtype=int)
        self.sigma = np.asarray(inp.sigma, dtype=float)
        self.spare_ub = np.asarray(inp.m_spare_ub, dtype=float)
        self.excess_cum = np.cumsum(inp.r_excess, axis=1)
        self.H = self.excess_cum.shape[1]
        self._kept = np.nonzero(self.sigma > 0)[0]   # Alg. 1 line 8
        self._cols = None              # backend-resident fleet columns
        self._ub_memo: dict = {}       # dd -> (ub handle, n_viable)
        self._host_memo: dict = {}     # dd -> host f64 ub over kept
        self._order_memo: dict = {}    # (dd, evaluated) -> admit order
        self._top_memo: dict = {}      # (dd, M) -> (top, bound)
        self._warm_d = None            # last winning duration (service)
        # proven-infeasible frontier: feasibility is monotone in d
        # (paper §4.3), so a probe that comes back empty pins every
        # duration <= dd empty *at the current dead set* — repeat
        # requests between deactivations read "d*-1 is infeasible" off
        # this instead of re-sweeping. It does NOT survive deactivate:
        # greedy feasibility is not monotone under candidate removal
        # (killing a budget-hogging winner can let smaller clients fit
        # where they previously could not)
        self._d_infeasible = 0
        self._exhausted_h = 0          # all viable(dd<=this) evaluated
        # evaluation store: doubling buffers, position -> buffer row;
        # rows are gathered only up to the horizon a probe needed
        # (_eval_h), and re-gathered wider when a later probe asks
        self._eval_idx = np.full(self.sigma.size, -1, dtype=np.int64)
        self._eval_h = np.zeros(self.sigma.size, dtype=np.int64)
        # buffer width tracks the widest gather so far, not H: sweeps
        # land at the binary search's mid durations, so full-H-wide
        # buffers would be mostly dead columns written with 4x the
        # memory traffic (the search descends after its first feasible
        # probe; widening re-allocation is the rare case)
        self._buf_w = 0
        self._reach_buf = np.empty((0, 0))   # [E, W] reach cumsums
        self._spare_buf = np.empty((0, 0))   # [E, W] m_spare rows
        self.evaluated = 0             # rows gathered (benchmark counter)
        try:
            params = list(inspect.signature(inp.spare_of)
                          .parameters.values())
            # horizon-aware providers NAME their second parameter h /
            # horizon — a mere second default (e.g. a lambda capture)
            # must not be mistaken for one
            self._spare_takes_h = (len(params) >= 2 and params[1].name
                                   in ("h", "horizon"))
        except (TypeError, ValueError):
            self._spare_takes_h = False
        # candidate deactivation (always-on service, repro/service): rows
        # excluded *after* engine construction — admitted-and-now-busy or
        # deregistered mid-step — score -inf wherever true scores are
        # read, so the walk admits exactly what a fresh engine over the
        # survivors would (positions renumber monotonically under
        # removal, preserving the descending-position tie order; any
        # bound a dead candidate still holds only stops a walk early,
        # which expands M — conservative, never wrong). Evaluations,
        # bound memos and reach state all survive, so a same-step admit
        # after an exclusion costs O(excluded) + a walk replay.
        self._dead: Optional[np.ndarray] = None
        self._dead_gen = 0
        self._n_dead = 0
        self._tables = None            # per-domain reach tables (overlay)
        if reach_state is not None:
            # pre-built evaluator state injected by the caller (the
            # service's incremental admission cache: a backend
            # reach_state_subset of a previous build) — the segment
            # overlay gather is skipped entirely
            self._tables = reach_state
        elif inp.seg_overlay is not None and self._kept.size:
            self._init_reach(inp.seg_overlay)

    def deactivate(self, pos: np.ndarray):
        """Exclude candidate positions (indices into ``inp.sigma``) from
        all future admissions on this engine. Positions already dead are
        a no-op; dead positions keep their evaluations and bound-memo
        entries (upper bounds stay valid — exclusion only removes
        admissibility, never adds it)."""
        pos = np.asarray(pos, dtype=np.int64)
        if not pos.size:
            return
        if self._dead is None:
            self._dead = np.zeros(self.sigma.size, dtype=bool)
        fresh = pos[~self._dead[pos]]
        if not fresh.size:
            return
        self._dead[fresh] = True
        self._n_dead += int(fresh.size)
        self._dead_gen += 1
        # greedy feasibility can go either way under removal (the warm
        # duration stays a valid *start*: the probes re-verify exactly)
        self._d_infeasible = 0

    @property
    def n_live(self) -> int:
        """Kept candidates still admissible (σ > 0 and not deactivated)."""
        return self._kept.size - self._n_dead

    def _mask_dead(self, score: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """-inf the scores of deactivated candidates (``pos`` indexes the
        original candidate axis, like ``_eval_idx``)."""
        if self._dead is not None:
            score = np.where(self._dead[pos], -np.inf, score)
        return score

    def _init_reach(self, ov: dict):
        """Gather the kept candidates' window segments into flat CSR
        columns and build the per-domain reach tables — once per round.
        Flat layout (no [K, S_max] padding): ~1.33 segments/candidate on
        the paper's regime process, so the evaluator's per-``dd`` query
        is a couple of float passes over ~1.33·K segments."""
        k = self._kept
        ptr = np.asarray(ov["ptr"], dtype=np.int64)
        lens = ptr[k + 1] - ptr[k]
        kptr = np.zeros(k.size + 1, dtype=np.int64)
        np.cumsum(lens, out=kptr[1:])
        idx = np.repeat(ptr[k] - kptr[:-1], lens) \
            + np.arange(kptr[-1], dtype=np.int64)
        self._seg_a = np.clip(np.asarray(ov["a"], dtype=np.int64)[idx],
                              0, self.H)
        self._seg_b = np.clip(np.asarray(ov["b"], dtype=np.int64)[idx],
                              0, self.H)
        self._seg_x = np.asarray(ov["x_ub"], dtype=np.float64)[idx]
        owner = np.repeat(np.arange(k.size, dtype=np.int64), lens)
        kk = k[owner]
        nu = self.inp.noise_mult_ub
        # one backend op adopts the whole per-round evaluator state —
        # tables, segment columns, kept fleet columns, noise bound —
        # and (on a device backend) moves the probe-invariant pieces device-
        # resident, so each probe ships only its per-dd thresholds
        self._tables = self.bk.reach_state(
            self.inp.r_excess[:, :self.H],
            seg={"a": self._seg_a, "b": self._seg_b, "x": self._seg_x,
                 "owner": owner, "dom": self.dom[kk],
                 # energy threshold base: spare fraction → Wmin/step
                 # is ·cap·δ
                 "capd": self.spare_ub[kk] * self.delta[kk]},
            kept={"delta": self.delta[k], "m_min": self.m_min[k],
                  "m_max": self.m_max[k], "sigma": self.sigma[k],
                  "dom": self.dom[k]},
            noise_mult_ub=None if nu is None
            else np.asarray(nu, dtype=np.float64))

    def _reach_scores(self, dd: int):
        """Segment-reach score upper bounds at ``dd``.

        One backend op (``probe_scores``): per candidate
        ``Σ_s [G_p(min(b_s, dd), w_s) − G_p(min(a_s, dd), w_s)] / δ``
        with the per-window thresholds ``w_s = min(x_s·ν[min(b_s, dd)],
        1)·cap·δ`` — each segment is priced with the sup noise
        multiplier over the leads it can actually occupy, not the
        global ν at dd (any per-segment threshold yields a valid
        concave upper bound, so admissions are unchanged while
        far-future segments stop inflating near-term probes). Bits are
        the host reference's by contract; the bound is inflated by
        REACH_SLACK, so it can never dip below the true score it
        certifies (decision-safe; see backend.base)."""
        return self.bk.probe_scores(self._tables, dd,
                                    self.excess_cum[:, dd - 1])

    def _ub(self, dd: int):
        """(ub handle, n_viable) at duration ``dd`` — score upper bounds
        over the kept candidates (-inf where the candidate can never be
        admitted at dd). With a segment overlay the bounds come from the
        reach evaluator and are adopted by the backend; otherwise the
        backend computes the optimistic full-spare grant over fleet
        columns moved backend-resident once per round."""
        hit = self._ub_memo.get(dd)
        if hit is None:
            if self._tables is not None:
                ub_np, n_viable = self._reach_scores(dd)
                self._host_memo[dd] = ub_np
                hit = (self.bk.adopt_scores(ub_np), n_viable)
            else:
                if self._cols is None:
                    k = self._kept
                    self._cols = self.bk.fleet_cols(
                        delta=self.delta[k], m_min=self.m_min[k],
                        m_max=self.m_max[k], sigma=self.sigma[k],
                        spare_ub=self.spare_ub[k], dom=self.dom[k])
                hit = self.bk.score_ub(self._cols,
                                       self.excess_cum[:, dd - 1],
                                       float(dd))   # line 6 + 11
            self._ub_memo[dd] = hit
        return hit

    def _ub_host(self, dd: int) -> np.ndarray:
        """Host float64 view of the ``dd`` bounds over the kept
        candidates — the tie-exact admission rule compares score bits
        against it (same bits as the backend handle by contract)."""
        h = self._host_memo.get(dd)
        if h is None:
            handle, _ = self._ub(dd)
            h = np.asarray(self.bk.asnumpy(handle),
                           dtype=np.float64)[:self._kept.size]
            self._host_memo[dd] = h
        return h

    def _evaluate(self, pos: np.ndarray, h: int):
        """Gather forecasts for the candidates not yet evaluated out to
        lead ``h`` (one provider call; results land in amortized-doubling
        buffers). Horizon-aware providers hand back only ``h`` columns —
        the bulk of an exhaustive low-``dd`` probe's cost — and a row is
        re-gathered wider iff a later probe needs more leads (binary
        search descends after its first feasible probe, so widening is
        the rare case)."""
        h = int(h)
        miss = pos[(self._eval_idx[pos] < 0) | (self._eval_h[pos] < h)]
        if not miss.size:
            return
        if self._spare_takes_h:
            spare = np.asarray(self.inp.spare_of(miss, h), dtype=float)
        else:
            spare = np.asarray(self.inp.spare_of(miss), dtype=float)
        got = spare.shape[1]           # legacy providers return full H
        reach = self.bk.take_reach(spare,
                                   self.inp.r_excess[self.dom[miss], :got],
                                   self.delta[miss])
        fresh = miss[self._eval_idx[miss] < 0]
        base = self.evaluated
        need = base + fresh.size
        rcap = self._reach_buf.shape[0]
        if need > rcap:
            rcap = max(2 * rcap, need, 256)
        w = max(self._buf_w, got)
        if (rcap, w) != self._reach_buf.shape:
            for name in ("_reach_buf", "_spare_buf"):
                buf = np.empty((rcap, w))
                buf[:base, :self._buf_w] = \
                    getattr(self, name)[:base, :self._buf_w]
                setattr(self, name, buf)
            self._buf_w = w
        self._eval_idx[fresh] = base + np.arange(fresh.size)
        self.evaluated = need
        if fresh.size == miss.size:
            # all-new rows (the exhaustive sweep): slots are consecutive
            # in miss order by construction — block write, no scatter
            self._reach_buf[base:need, :got] = reach
            self._spare_buf[base:need, :got] = spare
        else:
            slots = self._eval_idx[miss]
            self._reach_buf[slots, :got] = reach
            self._spare_buf[slots, :got] = spare
        self._eval_h[miss] = got

    def probe(self, d: int, feasibility_only: bool = False):
        """Admit up to n clients at duration ``d`` — the lazy equivalent
        of ``_eligible`` + ``_solve_greedy`` over the same inputs."""
        dd = min(d, self.H)
        if dd <= self._d_infeasible:
            return None
        res = self._probe_at(dd, feasibility_only)
        if res is None:
            self._d_infeasible = max(self._d_infeasible, dd)
        return res

    def _probe_at(self, dd: int, feasibility_only: bool):
        if dd <= 0 or self.n_live < self.n:
            return None
        cap = int(self.inp.candidate_cap)
        if cap <= 0 and dd <= self._exhausted_h:
            return self._probe_exhausted(dd, feasibility_only)
        ub, n_viable = self._ub(dd)
        if n_viable < self.n:
            return None
        ceiling = n_viable if cap <= 0 else min(n_viable, cap)
        M = min(max(int(self.inp.block), 4 * self.n, 64), ceiling)
        while True:
            if M >= n_viable:
                top = self.bk.viable_positions(ub)
                bound = -np.inf
                if cap <= 0:
                    # every viable-at-dd candidate is evaluated out to
                    # >= dd leads after this gather; viability only
                    # grows with dd (excess is nonnegative), so this
                    # probe — and any later probe at a shorter duration
                    # — can admit straight off the buffers, skipping
                    # the bound machinery (and memoizing the sort)
                    self._evaluate(self._kept[top], dd)
                    self._exhausted_h = max(self._exhausted_h, dd)
                    return self._probe_exhausted(dd, feasibility_only)
            else:
                # the dd bounds never change over an engine's lifetime
                # (deactivation removes admissibility, not bounds), so
                # the top-M partition is memoized across same-step
                # admissions — the service's repeat requests skip the
                # O(kept) argpartition entirely
                hit_top = self._top_memo.get((dd, M))
                if hit_top is None:
                    hit_top = self.bk.top_m(ub, M)
                    self._top_memo[(dd, M)] = hit_top
                top, bound = hit_top
            if M >= ceiling < n_viable:
                # capped: admission is exact within the top-`ceiling`
                # set; candidates beyond it are out of scope by contract
                bound = -np.inf
            cand = self._kept[top]
            self._evaluate(cand, dd)
            result = self._admit(cand, top, dd, bound, feasibility_only)
            if result is not None or M >= ceiling:
                return result
            # the walk hit the bound: widen the set geometrically, and
            # jump straight to everyone once the next step is close —
            # degenerate score landscapes (near-uniform σ, few hardware
            # types) make upper-bound ties hundreds of thousands deep,
            # so partial expansions there only add partition passes
            M = M * 8
            if M * 4 >= ceiling:
                M = ceiling

    def _probe_exhausted(self, dd: int, feasibility_only: bool):
        """Probe at a duration the walk has already swept exhaustively.

        An exhaustive uncapped probe at duration ``d`` evaluates every
        viable-at-``d`` candidate out to ``>= d`` leads, and viability
        is monotone in duration (excess is nonnegative, reach bounds
        and ``ν`` are nondecreasing in ``dd``), so for any ``dd <= d``
        the evaluated rows with ``_eval_h >= dd`` are a superset of
        viable(dd): admission can run straight off the buffers —
        realized scores, no upper bounds, no expansion loop. Rows
        outside viable(dd) score ``-inf`` (their realized reach is
        below ``m_min`` or their domain has no excess), so the walk
        order equals the exhaustive path's bit for bit. The score/
        order construction is lazy and memoized per (dd, evaluated):
        the admission walk usually resolves within the first few
        hundred candidates of the order, so the first try sorts only
        an exact top-K prefix (argpartition, not a full lexsort over
        the evaluated pool) and falls back to the complete order iff
        the prefix walk runs dry — which is how an infeasible duration
        proves itself, so that path pays what it always had to."""
        key = (dd, self.evaluated)
        hit = self._order_memo.get(key)
        if hit is None:
            pos = np.nonzero((self._eval_idx >= 0)
                             & (self._eval_h >= dd))[0]
            eids = self._eval_idx[pos]
            base, feas = self.bk.greedy_scores(
                self.sigma[pos], self._reach_buf[eids, dd - 1],
                self.m_min[pos], self.m_max[pos])
            base = np.where(feas, base, -np.inf)
            score = self._mask_dead(base, pos)
            fin = np.nonzero(score > -np.inf)[0]
            hit = [pos, base, score, fin, None, self._dead_gen]
            self._order_memo[key] = hit
        pos, base, score, fin, order, gen = hit
        if gen != self._dead_gen:
            # deaths since the memo was cut: re-mask off the unmasked
            # base scores and *filter* the memoized order in place —
            # removing elements from an exact (score desc, pos desc)
            # prefix leaves exactly the fresh prefix over the survivors,
            # so a same-step admission after a deactivation costs
            # O(pool) masking instead of a fresh partition + lexsort
            score = self._mask_dead(base, pos)
            fin = np.nonzero(score > -np.inf)[0]
            if order is not None:
                order = order[score[order] > -np.inf]
            hit[2], hit[3], hit[4], hit[5] = score, fin, order, \
                self._dead_gen
        if order is None:
            order = self._order_prefix(pos, score, fin,
                                       max(8 * self.n, 512))
            hit[4] = order
        res = self._admit(pos, None, dd, -np.inf, feasibility_only,
                          pre=(score, order))
        if res is not None or order.size >= fin.size:
            return res
        # the prefix ran out with fewer than n admissions: replay the
        # walk over the complete order (deterministic — identical
        # admissions up to where the prefix ended)
        hit[4] = self._order_prefix(pos, score, fin, fin.size)
        return self._admit(pos, None, dd, -np.inf, feasibility_only,
                           pre=(score, hit[4]))

    def _order_prefix(self, pos: np.ndarray, score: np.ndarray,
                      fin: np.ndarray, k: int) -> np.ndarray:
        """Exact first ``min(k, fin.size)`` elements of the admission
        order (score desc, position desc) over the finite-score rows.

        Bit-identical to ``fin[lexsort(...)][:k]`` by construction:
        rows scoring strictly above the k-th largest score all belong
        to the prefix, and the boundary tie class — position-descending
        in the full order — contributes exactly its top positions. Near-
        uniform sigma makes that tie class hundreds of thousands deep,
        which is precisely when O(F) partitions beat an O(F log F)
        two-key lexsort of everyone."""
        if k >= fin.size:
            return fin[np.lexsort((-pos[fin], -score[fin]))]
        s = score[fin]
        s_k = s[np.argpartition(-s, k - 1)[k - 1]]
        strict = fin[s > s_k]
        tied = fin[s == s_k]
        need = k - strict.size
        if need < tied.size:
            tied = tied[np.argpartition(-pos[tied], need - 1)[:need]]
        sel = np.concatenate([strict, tied])
        return sel[np.lexsort((-pos[sel], -score[sel]))]

    def _admit(self, cand: np.ndarray, top: Optional[np.ndarray],
               dd: int, bound: float, feasibility_only: bool,
               pre=None):
        """One admission pass over the evaluated candidate set; None if
        the admissible candidates run out before n admissions (an
        unevaluated candidate could rank among the remainder). The
        admissible queue is everyone scoring strictly above ``bound``
        plus the tie-exact prefix: evaluated candidates whose score
        *equals* the bound, walked in position-descending order down to
        (exclusive) the largest position among unselected bound-ties —
        ``top_m`` keeps the largest-position ties, so up to that point
        no unevaluated candidate can precede them in the global (score
        desc, position desc) order, and past it one could, so the walk
        must stop there rather than skip (budget drain order matters).

        Candidates are walked in exact (score desc, position desc) order
        — one lexsort over the evaluated set — and admitted in batched
        chunk passes mirroring :func:`_solve_greedy`: optimistic takes
        for a whole chunk against its domains' current budgets
        (backend ``take_matrix``), bulk rejection of rows that cannot
        reach m_min (exact — reach only shrinks as budgets drain), then
        commit of the longest prefix whose cumulative pre-cap drains
        stay under their domain budgets by the 1e-9 relative margin
        (backend ``margin_prefix_ok``). Margin-valid rows are
        spare/m_max-limited at every step, so their takes are
        bit-identical to a per-candidate sequential walk; a
        budget-limited head row falls back to an exact single
        admission, and every pass either admits ≥ 1 client or retires a
        whole chunk. Selections match the sequential reference exactly
        at O(passes) instead of O(walked candidates) Python iterations.
        """
        eids = self._eval_idx[cand]
        if pre is not None:
            score, order = pre
        else:
            reach_dd = self._reach_buf[eids, dd - 1]
            score, feas = self.bk.greedy_scores(self.sigma[cand],
                                                reach_dd,
                                                self.m_min[cand],
                                                self.m_max[cand])
            score = self._mask_dead(np.where(feas, score, -np.inf), cand)
            # lexsort only the feasible rows: on infeasible probes most
            # of a large evaluated pool scores -inf, never admissible
            fin = np.nonzero(score > -np.inf)[0]
            order = fin[np.lexsort((-cand[fin], -score[fin]))]
        # candidates scoring strictly above the bound are always
        # admissible; -score[order] is ascending, so the count is one
        # searchsorted (excludes -inf rows for free)
        n_valid = int(np.searchsorted(-score[order], -float(bound),
                                      side="left"))
        queue = order[:n_valid]
        if np.isfinite(bound):
            end = int(np.searchsorted(-score[order], -float(bound),
                                      side="right"))
            ties = order[n_valid:end]
            if ties.size:
                # U = largest position among *unselected* upper-bound
                # ties (-1 if none): score-ties above U are admissible,
                # the first at or below U stops the walk (score bits
                # compare exactly — bound and ub_host share one array)
                ub_host = self._ub_host(dd)
                tie_kept = np.nonzero(ub_host == bound)[0]
                n_sel = int(np.count_nonzero(ub_host[top] == bound))
                if n_sel >= tie_kept.size:
                    u_pos = -1
                else:
                    u_pos = int(self._kept[tie_kept[-(n_sel + 1)]])
                cand_t = cand[ties]          # position-descending
                n_tie = int(np.searchsorted(-cand_t, -u_pos,
                                            side="left"))
                queue = order[:n_valid + n_tie]
        budgets = self.inp.r_excess[:, :dd].copy()
        chosen: List[int] = []
        batches = []
        chunk = max(4 * self.n, 64)
        while queue.size and len(chosen) < self.n:
            nc = min(chunk, queue.size)
            q = queue[:nc]
            cj = cand[q]
            dj = self.dom[cj]
            delta_j = self.delta[cj]
            # one fused backend pass (single device dispatch): takes,
            # feasibility, overshoot capping and the decision-safe
            # per-domain margin prefix-scan
            feas, ok_m, capped = self.bk.admit_domains(
                self._spare_buf[eids[q], :dd], budgets, dj, delta_j,
                self.m_min[cj], self.m_max[cj])
            if not feas.any():
                queue = queue[nc:]
                chunk *= 2      # unproductive pass: sweep faster
                continue
            keep = np.nonzero(feas)[0]
            q, cj, dj, delta_j = q[keep], cj[keep], dj[keep], delta_j[keep]
            capped, ok = capped[keep], ok_m[keep]
            bad = np.nonzero(~ok)[0]
            npfx = int(bad[0]) if bad.size else q.size
            npfx = max(1, min(npfx, self.n - len(chosen)))
            for i in range(npfx):   # ≤ n tiny [dd] commits, identical
                budgets[dj[i]] -= capped[i] * delta_j[i]  # to sequential
                chosen.append(int(cj[i]))
                if not feasibility_only:
                    batches.append(capped[i])
            queue = np.concatenate([q[npfx:], queue[nc:]])
        if len(chosen) < self.n:
            return None
        return chosen, (None if feasibility_only else np.array(batches))


def _select_clients_lazy(inp: LazySelectionInputs, n: int, d_max: int,
                         solver: str, search: str,
                         engine: Optional[_LazyGreedy] = None
                         ) -> Optional[Selection]:
    if solver != "greedy":
        raise ValueError("lazy/sharded selection supports solver='greedy' "
                         "only — materialize SelectionInputs for the MIP")
    # a caller-held engine (the always-on service) carries evaluations,
    # bound memos and reach state across calls; every probe replays
    # against its own budget copy, so reuse is bit-identical to a fresh
    # engine over the same live candidates
    eng = _LazyGreedy(inp, n) if engine is None else engine
    if eng.n != n:
        raise ValueError(f"reused engine was built for n={eng.n}, "
                         f"request asks n={n}")
    # chosen indices map through the engine's own candidate axis
    inp = eng.inp
    if search == "linear":
        for d in range(1, d_max + 1):
            best = eng.probe(d)
            if best is not None:
                return _to_selection(inp, best, d)
        return None
    # feasibility is monotone in d (paper §4.3): the minimal feasible
    # duration d* is unique, so any probe schedule that brackets it is
    # exact. A reused engine remembers its last winning duration and
    # starts there — consecutive service admissions rarely move d*, so
    # the common case is two probes (d* feasible, d*-1 not) instead of
    # the full O(log d_max) descent.
    lo_d, hi_d, found_d = 1, d_max - 1, d_max
    w = eng._warm_d
    warm_best = None
    if w is not None and 1 <= w <= d_max:
        warm_best = eng.probe(w)                     # full walk, kept
    if warm_best is not None:
        if w == 1 or eng.probe(w - 1, feasibility_only=True) is None:
            # steady state: d* == w — one walk total, since the w-1
            # infeasibility usually reads off the engine's proven-
            # infeasible frontier
            eng._warm_d = w
            return _to_selection(inp, warm_best, w)
        found_d, hi_d = w - 1, w - 2                 # d* <= w - 1
    else:
        # warm duration infeasible (or none held): d* > w. One probe at
        # d_max settles the common idle-minute case without the binary
        # search's ascending — and individually expensive — infeasible
        # probes; at d_max the certified bounds saturate hardest, so
        # this probe is also the one most likely to resolve from bounds
        # alone
        if eng.probe(d_max, feasibility_only=True) is None:
            return None
        if w is not None and w >= 1:
            lo_d = min(w + 1, d_max)
    while lo_d <= hi_d:
        mid = (lo_d + hi_d) // 2
        if eng.probe(mid, feasibility_only=True) is not None:
            found_d = mid
            hi_d = mid - 1
        else:
            lo_d = mid + 1
    eng._warm_d = found_d
    return _to_selection(inp, eng.probe(found_d), found_d)


def find_clients_for_duration(inp: SelectionInputs, d: int, n: int,
                              solver: str = "mip", time_limit: float = 60.0,
                              cache: Optional[_ProbeCache] = None,
                              model: Optional[_WarmMip] = None,
                              feasibility_only: bool = False):
    if cache is None:
        cache = _ProbeCache(inp)
    eligible = _eligible(inp, d, cache)
    if len(eligible) < n:  # Alg. 1 line 13
        return None
    if solver == "greedy":
        return _solve_greedy(inp, d, n, eligible, cache,
                             feasibility_only=feasibility_only)
    return _solve_mip(inp, d, n, eligible, time_limit, cache, model)


def select_clients(inp: SelectionInputs, n: int, d_max: int,
                   solver: str = "mip", search: str = "binary",
                   time_limit: float = 60.0,
                   engine: Optional[_LazyGreedy] = None,
                   cache: Optional[_ProbeCache] = None,
                   model: Optional[_WarmMip] = None) -> Optional[Selection]:
    """Algorithm 1: smallest d ∈ [1, d_max] admitting a valid solution.

    ``search='binary'`` exploits the monotonicity of feasibility in d
    (paper §4.3: O(log d_max)); ``'linear'`` matches the pseudo-code
    literally. All probes share one :class:`_ProbeCache`; MIP probes
    additionally share one :class:`_WarmMip` model (bounds-swap re-solve)
    and greedy probes run feasibility-only with one full solve at the
    minimal feasible duration.

    A :class:`LazySelectionInputs` routes to the sharded lazy greedy
    (:class:`_LazyGreedy`) — identical selections, but candidate
    forecasts are gathered in blocks instead of materialized [K, H].

    ``engine`` / ``cache`` / ``model`` let a caller that prices many
    requests against the *same* inputs (the always-on service,
    :mod:`repro.service`) reuse the per-round evaluation state across
    calls instead of rebuilding it: a held :class:`_LazyGreedy` for lazy
    inputs, a :class:`_ProbeCache` (+ :class:`_WarmMip`) for
    materialized ones. All per-probe state is keyed by duration and
    replayed against fresh budget copies, so reuse is bit-identical to
    the from-scratch call — the service's determinism contract.
    """
    if isinstance(inp, LazySelectionInputs):
        return _select_clients_lazy(inp, n, d_max, solver, search,
                                    engine=engine)
    if cache is None:
        cache = _ProbeCache(inp)
    if solver == "mip":
        if model is None:
            model = _WarmMip(inp, cache, n)
        if model.k < n:
            return None
    else:
        model = None

    def attempt(d, feasibility_only=False):
        return find_clients_for_duration(
            inp, d, n, solver, time_limit, cache, model,
            feasibility_only=feasibility_only and solver == "greedy")

    if search == "linear":
        for d in range(1, d_max + 1):
            best = attempt(d)
            if best is not None:
                return _to_selection(inp, best, d)
        return None
    lo_d, hi_d, found, found_d = 1, d_max, None, None
    while lo_d <= hi_d:
        mid = (lo_d + hi_d) // 2
        res = attempt(mid, feasibility_only=True)
        if res is not None:
            found, found_d = res, mid
            hi_d = mid - 1
        else:
            lo_d = mid + 1
    if found is None:
        return None
    if found[1] is None:  # feasibility-only probe: build the schedule once
        found = attempt(found_d)
    return _to_selection(inp, found, found_d)


def _to_selection(inp: SelectionInputs, result, d: int) -> Selection:
    chosen, batches = result
    return Selection(
        rows=inp.rows[np.asarray(chosen, dtype=int)],
        expected_duration=d,
        expected_batches=batches.sum(axis=1),
    )
