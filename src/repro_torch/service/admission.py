"""Online admission pricing for the always-on scheduler.

:class:`AdmissionCache` answers ``admit(n, d_max)`` requests against the
live fleet view by running FedZero's Algorithm 1 over the current
candidate set — through the byte-identical input construction the batch
strategy uses (:func:`repro_torch.core.strategies.fedzero_selection_inputs`)
— while reusing the expensive per-step evaluation state across the many
requests that arrive between virtual-clock ticks.

Reuse ladder (lazy / sharded inputs, the million-client path):

1. **Same candidates** — the held :class:`~repro_torch.core.selection._LazyGreedy`
   engine answers directly: evaluations, bound memos and the segment-
   reach state all persist, so the binary search replays walks instead
   of re-gathering forecasts.
2. **Candidates shrank** (rows admitted-and-now-busy, or deregistered) —
   the vanished positions are :meth:`~_LazyGreedy.deactivate`\\ d in
   O(excluded); admissions stay bit-identical to a fresh engine over the
   survivors (exactness argument in the engine's docstring).
3. **Dead fraction past** ``compact_frac`` — the engine is rebuilt over
   the survivors only, *without* re-gathering the segment overlay: the
   backend's ``reach_state_subset`` op compacts the existing reach state
   (on the device backend the prefix tables stay resident and only the
   compacted segment columns are uploaded).
4. **Candidates grew** (a registration or a blocklist release
   resurrected a row) or the request key changed (clock tick, new σ
   generation, different ``n``/``d_max``) — full rebuild.

Materialized (dense-store) inputs have no deactivation machinery; the
cache instead memoizes the built :class:`SelectionInputs` +
:class:`_ProbeCache` (+ :class:`_WarmMip`) and reuses them when the
exact same candidate set repeats under the same key — the retry /
repeated-probe case.

``incremental=False`` turns all of this off: every request builds
inputs from scratch and calls plain :func:`select_clients` — the batch
reference engine the service's determinism contract pins against
(docs/service.md).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.selection import (LazySelectionInputs, _LazyGreedy,
                                  _ProbeCache, _WarmMip, select_clients)
from ..core.strategies import fedzero_selection_inputs
from ..core.types import Selection

_MISS = object()   # sentinel: incremental reuse impossible, rebuild


class AdmissionCache:
    """Prices admission requests, reusing per-step state when allowed.

    ``gen`` is the σ-generation counter: the owning service bumps it via
    :meth:`invalidate` whenever statistical utilities or the blocklist
    change (a round report), which retires every cached engine. The
    request key is ``(now, n, d_max, gen)`` — anything cached is only
    ever consulted while all four are unchanged, so candidate-set
    comparison is the *only* per-request freshness check.
    """

    def __init__(self, registry, *, backend=None, solver: str = "mip",
                 search: str = "binary", sharded: Optional[bool] = None,
                 candidate_cap: int = 0,
                 exact_uncapped: Optional[bool] = None,
                 incremental: bool = True, compact_frac: float = 0.25,
                 metrics=None):
        self.registry = registry
        self.backend = backend
        self.solver = solver
        self.search = search
        self.sharded = sharded
        self.candidate_cap = candidate_cap
        self.exact_uncapped = exact_uncapped
        self.incremental = incremental
        self.compact_frac = compact_frac
        self.metrics = metrics
        self.gen = 0
        self._key = None
        self._engine: Optional[_LazyGreedy] = None
        self._rows: Optional[np.ndarray] = None   # built candidate rows, asc
        self._live: Optional[np.ndarray] = None   # bool over built axis
        self._live_rows: Optional[np.ndarray] = None  # rows[live], asc
        self._dense = None                        # (cand, inp, cache, model)
        # the last answer, tagged with the engine dead-generation it was
        # computed at: an identical repeat request against unchanged
        # state (same key, same candidates, no deactivations since) must
        # return the identical selection by the determinism contract, so
        # it is answered verbatim — the service's quote() path
        self._sel_memo = None                     # (dead_gen, selection)

    # ------------------------------------------------------------------
    def invalidate(self):
        """σ / blocklist changed: retire all cached pricing state."""
        self.gen += 1
        self._key = None
        self._engine = self._rows = self._live = self._dense = None
        self._live_rows = self._sel_memo = None

    def _count(self, key: str, n: int = 1):
        if self.metrics is not None:
            self.metrics.count(key, n)

    def _build_inputs(self, env, cand, sigma, excess_fc):
        return fedzero_selection_inputs(
            env, cand, sigma, excess_fc, registry=self.registry,
            backend=self.backend, solver=self.solver, sharded=self.sharded,
            candidate_cap=self.candidate_cap,
            exact_uncapped=self.exact_uncapped)

    # ------------------------------------------------------------------
    def admit(self, env, cand: np.ndarray, sigma: np.ndarray,
              excess_fc: np.ndarray, n: int,
              d_max: int) -> Optional[Selection]:
        """Price one request over candidate rows ``cand`` (ascending).

        ``sigma`` is the full [C] utility vector (blocked rows zeroed) —
        the same array the batch strategy would slice. Returns the
        :class:`Selection` or ``None`` (infeasible within ``d_max``).
        """
        if not self.incremental:
            self._count("engine_builds")
            inp = self._build_inputs(env, cand, sigma, excess_fc)
            return select_clients(inp, n, d_max, solver=self.solver,
                                  search=self.search)
        key = (int(env.now), int(n), int(d_max), self.gen)
        if self._key == key:
            sel = self._reuse(cand, n, d_max)
            if sel is not _MISS:
                return sel
        inp = self._build_inputs(env, cand, sigma, excess_fc)
        self._key = key
        self._count("engine_builds")
        if isinstance(inp, LazySelectionInputs):
            self._dense = None
            eng = _LazyGreedy(inp, n)
            self._engine = eng
            self._rows = np.asarray(cand, dtype=np.int64).copy()
            self._live = np.ones(self._rows.size, dtype=bool)
            self._live_rows = self._rows
            sel = select_clients(inp, n, d_max, solver=self.solver,
                                 search=self.search, engine=eng)
            self._sel_memo = (eng._dead_gen, sel)
            return sel
        self._engine = self._rows = self._live = self._live_rows = None
        cache = _ProbeCache(inp)
        model = _WarmMip(inp, cache, n) if self.solver == "mip" else None
        self._dense = (np.asarray(cand, dtype=np.int64).copy(),
                       inp, cache, model)
        sel = select_clients(inp, n, d_max, solver=self.solver,
                             search=self.search, cache=cache, model=model)
        self._sel_memo = (0, sel)
        return sel

    # ------------------------------------------------------------------
    def _reuse(self, cand: np.ndarray, n: int, d_max: int):
        """Serve off held state, or ``_MISS`` when a rebuild is needed."""
        if self._dense is not None:
            prev, inp, cache, model = self._dense
            if not np.array_equal(prev, cand):
                return _MISS
            if self._sel_memo is not None:
                self._count("engine_memo_hits")
                return self._sel_memo[1]
            self._count("engine_reuses")
            sel = select_clients(inp, n, d_max, solver=self.solver,
                                 search=self.search, cache=cache,
                                 model=model)
            self._sel_memo = (0, sel)
            return sel
        eng, rows, live = self._engine, self._rows, self._live
        if self._live_rows is not None and cand.size == self._live_rows.size \
                and np.array_equal(cand, self._live_rows):
            # request over exactly the surviving rows (the service's
            # request-rate steady state): nothing to kill, nothing
            # resurrected — skip the O(K log K) membership check, and
            # when no deactivation happened since the last answer,
            # return that answer verbatim
            if self._sel_memo is not None \
                    and self._sel_memo[0] == eng._dead_gen:
                self._count("engine_memo_hits")
                return self._sel_memo[1]
        else:
            pos = np.searchsorted(rows, cand)
            if np.any(pos >= rows.size) \
                    or not np.array_equal(rows[pos], cand):
                return _MISS                   # a row the build never saw
            if not np.all(live[pos]):
                return _MISS                   # resurrection: was excluded
            mark = np.zeros(rows.size, dtype=bool)
            mark[pos] = True
            kill = np.nonzero(live & ~mark)[0]
            if kill.size:
                eng.deactivate(kill)
                live[kill] = False
                self._live_rows = rows[live]
                self._count("engine_deactivations", int(kill.size))
        if (eng._n_dead > self.compact_frac * rows.size
                and eng._tables is not None
                and eng._kept.size == eng.sigma.size):
            self._compact()
            eng = self._engine
        self._count("engine_reuses")
        sel = select_clients(eng.inp, n, d_max, solver=self.solver,
                             search=self.search, engine=eng)
        self._sel_memo = (eng._dead_gen, sel)
        return sel

    # ------------------------------------------------------------------
    def _compact(self):
        """Rebuild the engine over survivors only, adopting the existing
        reach state through the backend's ``reach_state_subset`` — no
        overlay re-gather. Exact: compacting survivors of a per-candidate
        CSR segment layout equals a fresh gather over them (pinned by
        tests/test_service.py)."""
        eng = self._engine
        keep = ~eng._dead
        keep_idx = np.nonzero(keep)[0]
        old = eng.inp
        old_spare = old.spare_of
        if eng._spare_takes_h:
            def spare_of(pos, h=None):
                return old_spare(keep_idx[np.asarray(pos, dtype=np.int64)],
                                 h)
        else:
            def spare_of(pos):
                return old_spare(keep_idx[np.asarray(pos, dtype=np.int64)])
        state = eng.bk.reach_state_subset(eng._tables, keep)
        inp = LazySelectionInputs(
            registry=old.registry, spare_of=spare_of,
            m_spare_ub=old.m_spare_ub[keep], r_excess=old.r_excess,
            sigma=old.sigma[keep], rows=old.rows[keep], dom=old.dom[keep],
            block=old.block, candidate_cap=old.candidate_cap,
            backend=old.backend, seg_overlay=None,
            noise_mult_ub=old.noise_mult_ub)
        self._engine = _LazyGreedy(inp, eng.n, reach_state=state)
        self._rows = np.asarray(inp.rows, dtype=np.int64)
        self._live = np.ones(self._rows.size, dtype=bool)
        self._live_rows = self._rows
        self._count("engine_compactions")
