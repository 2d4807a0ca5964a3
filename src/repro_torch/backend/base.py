"""Array-backend op surface for the scheduling hot path.

:class:`ArrayBackend` names every array operation the FedZero scheduling
stack is allowed to accelerate: the counter-hash synthesis primitives
behind the sparse-activity util model (``sm64``/``hash64``/``u01``/
``cheap_u01`` and the fused grid draws built from them), the gathered
elementwise math of the greedy solvers (``take_matrix``,
``greedy_scores``, ``score_ub``), the segment-domain reach evaluator
behind exact uncapped lazy selection (``reach_tables``/
``segment_reach``/``adopt_scores``), the top-M candidate selection
(``top_m``/``viable_positions``) and the per-domain prefix-scan margin
check of the chunked admission walk (``margin_prefix_ok``). Everything
else — Python control flow, binary search, LRU caches, the registry —
stays backend-agnostic host code.

Parity contract (what ``numpy`` and any accelerated backend must agree
on, bit for bit):

* **integer/hash ops** — uint64 add/mul/xor/shift wrap identically
  everywhere, so every synthesis primitive is bit-exact across backends;
* **elementwise float ops** — IEEE-754 add/sub/mul/div/min/max/compare
  are exactly rounded, so any op built only from them (``take_matrix``,
  ``greedy_scores``, ``score_ub``, the fused noise grids) must return
  bit-identical floats;
* **float reductions and transcendentals are NOT portable** — summation
  order and ``exp``/``log`` implementations differ between NumPy and
  XLA. Ops whose *bits* feed scheduling decisions therefore keep their
  reductions on the host (``np.cumsum``/``np.exp`` in the callers), and
  backends return pre-reduction values (e.g. ``forecast_noise_z``
  returns the pre-``exp`` exponent). The one backend-side reduction —
  the cumulative drain inside ``margin_prefix_ok`` — is *decision-safe*
  by construction: the 1e-9 admission margin dwarfs any reordering
  error, and a margin miss only defers a candidate to the exact
  single-admission fallback, so final admissions are identical under
  any summation order (see docs/backends.md).
* **selection sets** — ``top_m`` breaks upper-bound ties
  deterministically: value descending, candidate **position descending**
  (a stable descending sort of the reversed array on the device
  backends, mirrored by the NumPy reference), and returns the exact
  maximum upper bound over the *unselected* remainder — the pair of
  properties the lazy walk's tie-exact admission rule is built on (see
  ``core/selection.py``).

The base class implements every op with reference NumPy semantics, so a
subclass only overrides what it accelerates and inherits exact host
behaviour for the rest.
"""
from __future__ import annotations

import numpy as np

_U64 = np.uint64

# admission margin: a chunked prefix is committed only while its
# cumulative pre-cap drains stay this far (relatively) under the domain
# budget — far above any f64 summation-reorder error (~1e-13), far below
# any real budget slack, so every backend reaches the same admissions
MARGIN = 1.0 - 1e-9

# reach-evaluator inflation: segment-reach score upper bounds are
# multiplied by this before use, the mirror of MARGIN — the 1e-9 relative
# slack dwarfs the f64 rounding daylight between the evaluator's
# sorted-order sums and the admission walk's time-order sums (~1e-13),
# so a bound can never dip below the true score it certifies and the
# lazy walk stays exact (see docs/architecture.md)
REACH_SLACK = 1.0 + 1e-9


def _reach_rank(vals, dom, w, dom_sort=None):
    """[N] int64 per-query breakpoint rank: the count of ``vals[dom]``
    entries strictly below ``w``. Integer-valued (comparisons only), so
    it is computed on the host in **every** backend — trivially
    bit-exact, and it keeps the device side of ``segment_reach`` purely
    gathers + exactly-rounded float ops.

    ``dom_sort`` is an optional precomputed grouping of the (fixed)
    ``dom`` column — ``(order, starts, uniq)`` with ``order`` a stable
    domain-ascending permutation and ``uniq[k]``'s queries at
    ``order[starts[k]:starts[k+1]]``. Callers that query the same
    segment set once per duration (the lazy selector) pay the
    per-domain masking passes once instead of per call; ranks are
    identical either way."""
    j = np.empty(w.shape, dtype=np.int64)
    if dom_sort is None:
        for p in np.unique(dom):
            m = dom == p
            j[m] = np.searchsorted(vals[p], w[m], side="left")
        return j
    order, starts, uniq = dom_sort
    ws = w[order]
    js = np.empty_like(j)
    for k, p in enumerate(uniq):
        sl = slice(starts[k], starts[k + 1])
        js[sl] = np.searchsorted(vals[p], ws[sl], side="left")
    j[order] = js
    return j


def reach_dom_sort(dom) -> tuple:
    """Precompute ``_reach_rank``'s domain grouping for a fixed flat
    ``dom`` column: (stable domain-ascending order, group starts,
    group domain ids)."""
    dom = np.asarray(dom, dtype=np.int64)
    order = np.argsort(dom, kind="stable")
    uniq, counts = np.unique(dom, return_counts=True)
    starts = np.zeros(uniq.size + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return order, starts, uniq


def sm64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 (reference impl).

    Wraparound is the mixing mechanism — numpy warns about it only for
    0-d inputs, so the intended overflow is silenced explicitly."""
    with np.errstate(over="ignore"):
        x = (x + _U64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def hash64(seed: int, salt: int, *keys) -> np.ndarray:
    """Chained splitmix64 over broadcastable non-negative integer keys."""
    h = sm64(np.asarray(_U64(seed) ^ sm64(np.asarray(_U64(salt)))))
    for k in keys:
        h = sm64(h ^ np.asarray(k, dtype=np.uint64))
    return h


def u01(h: np.ndarray) -> np.ndarray:
    """uint64 hash → float64 uniform in [0, 1) (53 mantissa bits)."""
    return (h >> _U64(11)).astype(np.float64) * (2.0 ** -53)


def cheap_u01(fold: np.uint64, key: np.ndarray) -> np.ndarray:
    """float32 uniform in [0, 1) from a uint64 key grid via a two-round
    multiply–xorshift mixer — the per-cell hot path (noise), where the
    full splitmix chain would double the gather's memory traffic. The
    ``fold`` scalar carries the (seed, salt) entropy."""
    with np.errstate(over="ignore"):
        h = key ^ fold              # fresh array; never mutate the key
        h *= _U64(0xFF51AFD7ED558CCD)
        h ^= h >> _U64(32)
        h *= _U64(0xC4CEB9FE1A85EC53)
        h ^= h >> _U64(29)
        h >>= _U64(40)
    out = h.astype(np.float32)
    out *= np.float32(2.0 ** -24)
    return out


class ArrayBackend:
    """Reference (NumPy) implementation of the scheduling op surface.

    Subclasses override the grid-heavy ops with accelerated versions and
    keep the bit-exactness contract documented in the module docstring;
    anything not overridden runs the host reference below.
    """

    name = "numpy"

    # -- dispatch accounting ---------------------------------------------
    # Every op implementation ticks the counter once per *dispatch*: for
    # the host reference that is one tick per op call; accelerated
    # backends tick once per device executable launched, so the counter
    # is the per-round dispatch budget the benchmarks and the CI
    # regression step read (see docs/backends.md, "fused ops & dispatch
    # budget").

    @property
    def dispatch_counts(self) -> dict:
        d = self.__dict__.get("_dispatch_counts")
        if d is None:
            d = self.__dict__["_dispatch_counts"] = {}
        return d

    def _tick(self, op: str, n: int = 1):
        c = self.dispatch_counts
        c[op] = c.get(op, 0) + n

    def reset_dispatch_counts(self):
        self.dispatch_counts.clear()

    def dispatch_total(self) -> int:
        return sum(self.dispatch_counts.values())

    # -- counter-hash synthesis primitives -------------------------------
    def sm64(self, x):
        self._tick("sm64")
        return sm64(np.asarray(x, dtype=np.uint64))

    def hash64(self, seed, salt, *keys):
        self._tick("hash64")
        return hash64(seed, salt, *keys)

    def u01(self, h):
        self._tick("u01")
        return u01(np.asarray(h, dtype=np.uint64))

    def cheap_u01(self, fold, key):
        self._tick("cheap_u01")
        return cheap_u01(_U64(fold), np.asarray(key, dtype=np.uint64))

    # -- dense-store chunk RNG -------------------------------------------
    def chunk_rng(self, seed, salt, i) -> np.random.Generator:
        """Counter-seeded generator behind the dense chunk synthesizers
        (``ScenarioStore._excess_chunk``/``_util_chunk``/etc.).

        Routed through the backend so ``RunSection(backend=...)`` reaches
        every synthesis path, but **host-pinned in every backend**:
        NumPy's bit-stream generators (PCG64) have no counter-hash
        equivalent on an accelerator, and the dense goldens pin their
        exact streams. Accelerated backends inherit this reference —
        overriding it would change dense-store bits and break the golden
        suite by contract.
        """
        self._tick("chunk_rng")
        return np.random.default_rng((int(seed) & 0xFFFFFFFF, int(salt),
                                      int(i)))

    # -- fused synthesis grids -------------------------------------------
    def cell_noise(self, fold, rows, t_grid):
        """[R, W] float32 uniform [0,1) noise cell per (row, step)."""
        self._tick("cell_noise")
        key = (np.asarray(rows, dtype=np.uint64)[:, None] << _U64(24)) \
            ^ np.asarray(t_grid, dtype=np.uint64)[None, :]
        return cheap_u01(_U64(fold), key)

    def synth_window(self, levels, slot, fold, rows, t0, amp):
        """[R, W] util window: per-slot level gather + centered per-cell
        noise + clip to [0, 1] — the grid-heavy tail of a sparse-util
        gather (the data-dependent segment walk that produced ``levels``
        and ``slot`` stays on the host).

        The whole chain is elementwise IEEE float ops (parity-contract
        point 2), so accelerated backends fuse it into a single
        dispatch; the float32 multiply→add seam (``noise·amp`` then
        ``util + noise``) must be fenced against FMA contraction (see
        docs/backends.md, "fused ops & dispatch budget")."""
        self._tick("synth_window")
        util = np.take_along_axis(levels, slot, axis=1)
        t_grid = t0 + np.arange(slot.shape[1], dtype=np.int64)
        key = (np.asarray(rows, dtype=np.uint64)[:, None] << _U64(24)) \
            ^ np.asarray(t_grid, dtype=np.uint64)[None, :]
        noise = cheap_u01(_U64(fold), key)
        noise -= np.float32(0.5)
        noise *= np.float32(amp)
        util += noise
        np.clip(util, 0.0, 1.0, out=util)
        return util

    def piece_grid(self, levels, slot, fold, rows, t0, amp):
        """Back-compat alias for :meth:`synth_window` (the fused op the
        synthesis path now calls)."""
        return self.synth_window(levels, slot, fold, rows, t0, amp)

    def forecast_noise_z(self, fc_fold, rows, now, horizon, std):
        """[R, horizon] pre-``exp`` multiplicative forecast-error
        exponent keyed per registry row. The caller applies the host
        ``np.exp`` (transcendentals are not bit-portable — see module
        docstring); returns a fresh writable float32 array."""
        self._tick("forecast_noise_z")
        fold = _U64(fc_fold)
        row_h = sm64(np.asarray(rows, dtype=np.uint64) ^ fold)[:, None]
        key = row_h ^ ((_U64(now) << _U64(20))
                       + np.arange(1, horizon + 1, dtype=np.uint64)[None, :])
        z = cheap_u01(fold, key)
        z -= np.float32(0.5)
        z *= np.float32(np.sqrt(12.0))
        z *= np.asarray(std, dtype=np.float32)
        return z

    # -- greedy-solver elementwise math ----------------------------------
    def relu(self, x):
        """max(x, 0) — the MIP variable-bound clip."""
        return np.maximum(x, 0.0)

    def take_matrix(self, spare, budget_rows, delta):
        """[B, d] optimistic per-step takes: min(spare, budget/δ)."""
        self._tick("take_matrix")
        return np.minimum(spare, budget_rows / delta[:, None])

    def take_reach(self, spare, budget_rows, delta):
        """[B, d] cumulative reach of the optimistic takes:
        ``cumsum(min(spare, budget/δ), axis=1)``.

        The cumulative sum is a float reduction whose *bits* feed
        admissions, so accelerated backends must reproduce NumPy's
        left-to-right column order exactly (a sequential per-column
        scan — bit-exact, unlike a tree-reduction ``cumsum``; see
        docs/backends.md). Fusing it with the take avoids one full
        [B, d] round-trip per evaluation batch."""
        self._tick("take_reach")
        return np.cumsum(np.minimum(spare, budget_rows / delta[:, None]),
                         axis=1)

    def greedy_scores(self, sigma, reach, m_min, m_max):
        """(score[B], feas[B]) for ranked greedy admission."""
        self._tick("greedy_scores")
        total = np.minimum(reach, m_max)
        return sigma * total, total >= m_min

    # -- lazy-greedy candidate scoring / selection ------------------------
    def fleet_cols(self, **cols):
        """Adopt the per-round fleet columns (delta/m_min/m_max/sigma/
        spare_ub/dom over the kept candidates). Accelerated backends
        move them device-resident here, once per round."""
        self._tick("fleet_cols")
        return {k: np.ascontiguousarray(v) for k, v in cols.items()}

    def score_ub(self, cols, excess_col, dd):
        """(ub handle, n_viable) — score upper bounds at duration dd.

        ``ub[k] = σ·min(min(spare_ub·dd, excess/δ), m_max)`` where the
        candidate can reach m_min and its domain has excess, else -inf
        (Alg. 1 lines 6 + 11, optimistically granting the whole budget).
        """
        self._tick("score_ub")
        ex = excess_col[cols["dom"]]
        reach_ub = np.minimum(cols["spare_ub"] * dd, ex / cols["delta"])
        ok = (reach_ub >= cols["m_min"]) & (ex > 0)
        ub = np.where(ok, cols["sigma"] * np.minimum(reach_ub,
                                                     cols["m_max"]),
                      -np.inf)
        return ub, int(np.isfinite(ub).sum())

    def viable_positions(self, ub):
        """All candidate positions with a finite score upper bound."""
        return np.nonzero(np.isfinite(np.asarray(ub)))[0]

    def top_m(self, ub, M):
        """(positions of the top-M upper bounds, exact remainder bound).

        Deterministic tie rule — value descending, position
        **descending** — so ties spilling past M keep their
        largest-position members, the same head the admission walk's
        (score desc, position desc) order would process first. The
        returned bound is the (M+1)-th largest value: the exact maximum
        upper bound over the *unselected* candidates, which is what lets
        the walk admit evaluated bound-ties ahead of every unevaluated
        candidate (the tie-exact rule in ``_LazyGreedy._admit``).
        Requires M < number of finite ubs (so position M exists).
        """
        self._tick("top_m")
        ub = np.asarray(ub)
        part = np.argpartition(-ub, M)
        bound = float(ub[part[M]])
        pivot = float(ub[part[:M]].min())
        strict = np.nonzero(ub > pivot)[0]
        ties = np.nonzero(ub == pivot)[0][strict.size - M:]
        return np.concatenate([strict, ties]), bound

    def adopt_scores(self, ub):
        """Adopt a host-assembled score array as a handle usable by
        ``top_m`` / ``viable_positions`` / ``asnumpy``. Accelerated
        backends pad to their shape buckets (inert ``-inf``) and move
        the array device-resident; the reference is a host copy."""
        self._tick("adopt_scores")
        return np.ascontiguousarray(np.asarray(ub, dtype=np.float64))

    # -- segment-domain reach evaluator ----------------------------------
    def reach_tables(self, r_excess):
        """Per-domain prefix tables of the concave piecewise-linear
        reach ``G_p(τ, x) = Σ_{t<τ} min(x, E[p, t])`` (energy units).

        ``r_excess`` is the [P, H] per-domain per-step excess forecast.
        Returns ``{"vals", "cnt", "csum"}``: ``vals[p]`` the sorted
        breakpoints (the step energies), ``cnt[p, j, τ]`` how many of
        the first ``τ`` steps hold one of the ``j`` smallest energies,
        and ``csum[p, j, τ]`` their float64 sum, so a query is two
        gathers: ``G_p(τ, x) = csum[p, j, τ] + x·(τ − cnt[p, j, τ])``
        with ``j`` the count of breakpoints strictly below ``x``.

        O(P·H²) memory — tiny at forecast horizons (H ≤ 60 → ≲ 1 MB for
        a dozen domains). Built on the **host in every backend**: the
        cumulative sums are float reductions, which the parity contract
        (point 3) keeps host-side so the tables are bit-identical
        everywhere.
        """
        self._tick("reach_tables")
        ex = np.ascontiguousarray(np.asarray(r_excess, dtype=np.float64))
        P, H = ex.shape
        order = np.argsort(ex, axis=1, kind="stable")
        vals = np.take_along_axis(ex, order, axis=1)
        rank = np.empty((P, H), dtype=np.int64)
        np.put_along_axis(
            rank, order,
            np.broadcast_to(np.arange(H, dtype=np.int64), (P, H)), axis=1)
        below = rank[:, None, :] < np.arange(H + 1, dtype=np.int64)[None, :,
                                                                    None]
        cnt = np.zeros((P, H + 1, H + 1), dtype=np.int64)
        cnt[:, :, 1:] = np.cumsum(below, axis=2)
        csum = np.zeros((P, H + 1, H + 1), dtype=np.float64)
        csum[:, :, 1:] = np.cumsum(np.where(below, ex[:, None, :], 0.0),
                                   axis=2)
        return {"vals": vals, "cnt": cnt, "csum": csum}

    def segment_reach(self, tables, dom, a, b, w, dom_sort=None):
        """[N] per-segment reach energies ``G_dom(b, w) − G_dom(a, w)``.

        ``dom``/``a``/``b`` are flat int segment columns (CSR order,
        step bounds in [0, H]), ``w`` the float64 per-segment spare
        thresholds, ``dom_sort`` an optional precomputed
        :func:`reach_dom_sort` of the ``dom`` column. Everything after
        the host-side integer rank lookup is gathers plus
        exactly-rounded float ops — one multiply, then adds — so
        results are bit-identical across backends (accelerated impls
        must split the multiply→add boundary into separate kernels; see
        docs/backends.md). Padding-friendly: ``a == b`` or ``w == 0``
        contributes exactly 0.
        """
        self._tick("segment_reach")
        vals, cnt, csum = tables["vals"], tables["cnt"], tables["csum"]
        dom = np.asarray(dom, dtype=np.int64)
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        w = np.asarray(w, dtype=np.float64)
        j = _reach_rank(vals, dom, w, dom_sort)
        # one flat (dom, j) base index instead of four 3-D fancy
        # gathers — same elements, same float ops, same bits
        H1 = cnt.shape[1]
        base = (dom * H1 + j) * H1
        fa = base + a
        fb = base + b
        cntf = cnt.reshape(-1)
        csumf = csum.reshape(-1)
        ga = csumf[fa] + w * (a - cntf[fa])
        gb = csumf[fb] + w * (b - cntf[fb])
        return gb - ga

    # -- fused probe pipeline ---------------------------------------------
    def reach_state(self, r_excess, seg, kept, noise_mult_ub=None):
        """Adopt the per-round reach-evaluator state consumed by
        :meth:`probe_scores`, once per ``select_clients`` call.

        ``r_excess`` is the [P, H] per-domain excess forecast; ``seg``
        the flat CSR segment columns over kept candidates
        (``a``/``b``/``x``/``owner``/``dom``/``capd``); ``kept`` the
        per-candidate columns (``delta``/``m_min``/``m_max``/``sigma``/
        ``dom``); ``noise_mult_ub`` the per-lead [H] sup multiplicative
        noise bound ν (or None for exact spares). Accelerated backends
        move the prefix tables and segment columns device-resident here,
        so each probe re-uploads only its per-duration thresholds.
        """
        self._tick("reach_state")
        seg = {k: np.ascontiguousarray(v) for k, v in seg.items()}
        kept = {k: np.ascontiguousarray(v) for k, v in kept.items()}
        nu = None if noise_mult_ub is None else np.ascontiguousarray(
            np.asarray(noise_mult_ub, dtype=np.float64))
        return {
            "tables": self.reach_tables(r_excess),
            "seg": seg,
            "kept": kept,
            "nu": nu,
            "dom_sort": reach_dom_sort(seg["dom"]),
        }

    def reach_state_subset(self, state, keep):
        """Incremental reach-state update: the state of
        :meth:`reach_state` restricted to the kept-candidate subset
        ``keep`` ([K] bool over the state's candidate axis).

        The expensive pieces of a from-scratch rebuild — the O(P·H²)
        prefix tables and (upstream of this op) the scenario store's
        segment-overlay synthesis — depend only on the forecast window,
        not on which candidates survive, so a shrinking fleet at an
        unchanged wall-clock step reuses them verbatim and pays only
        O(segments) column compactions. Bit-parity contract: segments
        are per-candidate properties gathered in ascending-candidate CSR
        order, so compacting the survivors equals a fresh
        :meth:`reach_state` over the subset inputs exactly (pinned by
        tests/test_service.py); the ``dom_sort`` grouping is rebuilt by
        a stable filter of the old order — identical to a fresh stable
        argsort because compaction renumbers segments monotonically.
        Caller contract: the survivors' per-candidate columns (``sigma``
        in particular) must be unchanged since the state was built —
        the service keys its cache on a sigma generation counter for
        exactly this reason.
        """
        self._tick("reach_state_subset")
        keep = np.asarray(keep, dtype=bool)
        seg, kept = state["seg"], state["kept"]
        segkeep = keep[seg["owner"]]
        # old kept position -> compacted position (valid at kept rows)
        newpos = np.cumsum(keep) - 1
        nseg = {k: (newpos[v[segkeep]] if k == "owner" else v[segkeep])
                for k, v in seg.items()}
        nkept = {k: v[keep] for k, v in kept.items()}
        # stable filter of the old domain-ascending order == fresh stable
        # argsort of the compacted dom column (monotone renumbering)
        order, _starts, _uniq = state["dom_sort"]
        segpos = np.cumsum(segkeep) - 1
        osel = order[segkeep[order]]
        norder = segpos[osel]
        counts = np.bincount(nseg["dom"])
        nuniq = np.nonzero(counts)[0]
        nstarts = np.zeros(nuniq.size + 1, dtype=np.int64)
        np.cumsum(counts[nuniq], out=nstarts[1:])
        return {
            "tables": state["tables"],
            "seg": nseg,
            "kept": nkept,
            "nu": state["nu"],
            "dom_sort": (norder, nstarts, nuniq),
        }

    def probe_segment_w(self, state, dd):
        """(w[N], a[N], b[N], j[N]) — the per-segment thresholds, step
        bounds clipped to the probed duration, and host breakpoint ranks
        for a probe at duration ``dd``.

        Per-window noise bound: segment *s* only overlaps the probed
        window up to step ``min(b_s, dd)``, so its spare upper bound
        needs only ``ν[min(b_s, dd) − 1]`` — the sup noise multiplier
        over the leads it can actually occupy — rather than the global
        ``ν[dd − 1]``. Any per-segment threshold yields a valid concave
        upper bound (each segment's reach is evaluated independently),
        so admissions are unchanged while far-future segments stop
        inflating near-term probes (see docs/architecture.md).

        Host in every backend: ``w`` feeds the host breakpoint rank
        (integer comparisons) and must match the reference bits.
        """
        seg, nu = state["seg"], state["nu"]
        a = np.minimum(seg["a"], dd)
        b = np.minimum(seg["b"], dd)
        nu_s = 1.0 if nu is None else nu[b - 1]
        w = np.minimum(seg["x"] * nu_s, 1.0) * seg["capd"]
        j = _reach_rank(state["tables"]["vals"], seg["dom"], w,
                        state["dom_sort"])
        return w, a, b, j

    def probe_scores(self, state, dd, excess_col):
        """(ub handle, n_viable) — reach-evaluator score upper bounds at
        duration ``dd`` over the kept candidates.

        Fuses the per-probe chain (segment thresholds → PWL reach
        queries → per-candidate sums → viability → scores) behind one
        op so accelerated backends can run the float-heavy middle as a
        fixed small number of device dispatches against the resident
        :meth:`reach_state`. The per-candidate segment sum and the
        ``/δ·SLACK`` tail stay host-side (float reductions, parity
        point 3): bits must equal this reference exactly.
        """
        self._tick("probe_scores")
        seg, kept = state["seg"], state["kept"]
        w, a, b, j = self.probe_segment_w(state, dd)
        tables = state["tables"]
        H1 = tables["cnt"].shape[1]
        base = (seg["dom"] * H1 + j) * H1
        fa = base + a
        fb = base + b
        cntf = tables["cnt"].reshape(-1)
        csumf = tables["csum"].reshape(-1)
        ga = csumf[fa] + w * (a - cntf[fa])
        gb = csumf[fb] + w * (b - cntf[fb])
        g = gb - ga
        return self._probe_tail(state, dd, excess_col, g)

    def _probe_tail(self, state, dd, excess_col, g):
        """Host tail shared by every backend: per-candidate segment sums
        → reach bound → viability → scores. ``np.bincount`` is the one
        float reduction; its (CSR) order is part of the reference bits,
        so no backend may reorder it."""
        kept = state["kept"]
        sums = np.bincount(state["seg"]["owner"], weights=g,
                           minlength=kept["delta"].size)
        reach_ub = sums / kept["delta"] * REACH_SLACK
        ex = excess_col[kept["dom"]]
        ok = (reach_ub >= kept["m_min"]) & (ex > 0)
        ub = np.where(ok, kept["sigma"] * np.minimum(reach_ub,
                                                     kept["m_max"]),
                      -np.inf)
        return ub, int(np.isfinite(ub).sum())

    # -- chunked admission ------------------------------------------------
    def margin_prefix_ok(self, drain, dom_sel, budgets):
        """[B] bool: cumulative pre-cap drains of each row's prefix stay
        under its domain's budget by the 1e-9 relative margin.

        Per-domain prefix scan — clients of different domains never
        contend. Rows of a domain with ±ulp-negative budget residue
        degrade to the sequential fallback (all False). Decision-safe
        under any summation order (see module docstring), which is what
        lets accelerated backends batch the scan over domains.
        """
        self._tick("margin_prefix_ok")
        return self._margin_prefix(drain, dom_sel, budgets)

    def _margin_prefix(self, drain, dom_sel, budgets):
        """Un-ticked margin-scan core: :meth:`admit_domains` fuses the
        scan into its own single ledger entry, so it calls this instead
        of the public op (which ticks ``margin_prefix_ok``)."""
        ok = np.empty(drain.shape[0], dtype=bool)
        for pi in np.unique(dom_sel):
            mask = dom_sel == pi
            if (budgets[pi] >= 0.0).all():
                cd = np.cumsum(drain[mask], axis=0)
                ok[mask] = (cd <= budgets[pi][None, :] * MARGIN).all(axis=1)
            else:
                ok[mask] = False
        return ok

    def admit_domains(self, spare, budgets, dom_sel, delta, m_min, m_max):
        """(feas[B], ok[B], capped[B, d]) — one fused admission chunk
        pass: optimistic takes, feasibility, overshoot capping, and the
        per-domain margin prefix-check, in chunk order.

        ``spare`` is the [B, d] spare block of the chunk rows,
        ``budgets`` the [P, d] residual domain budgets, ``dom_sel``/
        ``delta``/``m_min``/``m_max`` the per-row columns. Infeasible
        rows contribute exactly-zero drain to the margin scan (adding
        +0.0 preserves every prefix bit), so ``ok`` over the feasible
        rows equals the reference's filtered-subset scan; ``ok`` at
        infeasible rows is meaningless and must be ignored.

        The take/cap math is elementwise (bit-portable); the row-wise
        ``cumsum`` bits feed admissions, so accelerated backends scan it
        sequentially per column like :meth:`take_reach`; the margin scan
        is decision-safe (see :meth:`margin_prefix_ok`).
        """
        self._tick("admit_domains")
        take = np.minimum(spare, budgets[dom_sel] / delta[:, None])
        cum = np.cumsum(take, axis=1)
        total = np.minimum(cum[:, -1], m_max)
        feas = total >= m_min
        overshoot = cum - m_max[:, None]
        capped = np.where(overshoot > 0.0, np.maximum(take - overshoot, 0.0),
                          take)
        drain = np.where(feas[:, None], take * delta[:, None], 0.0)
        ok = self._margin_prefix(drain, dom_sel, budgets)
        return feas, ok, capped

    # -- misc -------------------------------------------------------------
    def asnumpy(self, x):
        """Backend array → host ndarray (no-op for the reference)."""
        return np.asarray(x)

    def __repr__(self):
        return f"<ArrayBackend {self.name}>"
