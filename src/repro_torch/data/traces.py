"""Chunked float32 scenario store + synthetic trace synthesis.

The paper uses Solcast solar (+forecast) data for two scenarios — ten
globally distributed cities and ten co-located German cities — plus 100
machines from the Alibaba GPU cluster trace for client load. Neither data
source is available in this offline container, so this module generates
seeded synthetic equivalents:

* solar: clear-sky diurnal curve (by city longitude/latitude phase) ×
  AR(1) cloud attenuation, 5-minute resolution, 800 W peak per domain
  (paper §5.1);
* load: regime-switching GPU utilisation (job bursts / idle periods)
  resembling Alibaba's gpu_wrk_util, 1-min resolution;
* forecasts: actual × multiplicative log-normal error whose std grows with
  lead time (≈5 % nowcast → ≈25 % day-ahead), matching the "realistic
  error" setting; `error="none"` gives the paper's *w/o error* ablation.

Storage architecture (:class:`ScenarioStore`)
---------------------------------------------
Traces are float32 **columns served in time chunks**, not monolithic
float64 slabs. Each field (``excess`` [P, T], ``util`` [C, T], ``carbon``
[P, T]) is either backed by a caller-provided array (drop-in real traces)
or synthesized lazily one chunk at a time from counter-seeded generators:
chunk *i* of a field is a pure function of ``(seed, field, i)`` plus a
tiny per-chunk boundary state (AR(1) cloud state, load-regime state) that
is computed once, pinned, and lets evicted chunks be regenerated
bit-identically. Client-heavy ``util`` chunks live in an element-budgeted
LRU, so a 7-day 100k-client scenario costs a few hundred MB of resident
chunks instead of a ~2.8 GB eager slab; ``excess``/``carbon`` are tiny
([P, T]) and stay resident. ``excess_at``/``spare_at``/``spare_window``/
``*_forecast`` serve views/gathers straight from the chunk cache, and the
``util``-backed accessors accept a registry-row array to gather only a
client subset — identity is integer rows end to end; client names never
enter this module.

Sparse-activity util mode (the million-client path)
---------------------------------------------------
The dense synthesizer above still materializes a full ``[C, chunk]``
slab per util chunk, which is what stopped the end-to-end gates at 100k
clients. ``util_mode="sparse"`` (:class:`_SparseUtil`) replaces it with a
**counter-based sparse-activity regime process**: each client's busy/idle
*segments* are defined by stateless integer hashes of ``(seed, row,
segment)`` — geometric segment gaps, per-segment levels, per-(row, step)
noise — so the value at any ``(row, step)`` is a pure function that never
depends on other rows. Dense values are materialized **only for the rows
a caller actually gathers** (``spare_at``/``spare_window``/
``spare_forecast``), per-chunk boundary states (segment counter + next
switch time, two [C] integer columns) are carried exactly like the dense
generators' states, and forecast noise is keyed per registry row, so a
row-subset gather is bit-identical to the same rows of a full-fleet
gather. A 1M-client simulated day never allocates a [C, T] slab (see
tests/test_sparse_util.py and benchmarks/e2e_simulation.py,
``1m_1day``). Dense mode is the default and stays bit-identical to the
pre-sparse store.

Everything is generated in batched NumPy draws — there are no per-row
Python RNG constructions anywhere on the million-client path.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.signal import lfilter

from ..backend import base as backend_base
from ..backend import get_backend

# (name, utc_offset_hours, typical cloudiness in [0,1])
GLOBAL_CITIES = [
    ("berlin", 1, 0.45), ("san_francisco", -8, 0.25), ("new_york", -5, 0.35),
    ("sao_paulo", -3, 0.40), ("lagos", 1, 0.50), ("mumbai", 5.5, 0.45),
    ("beijing", 8, 0.40), ("tokyo", 9, 0.40), ("sydney", 10, 0.30),
    ("cape_town", 2, 0.25),
]

CO_LOCATED_CITIES = [  # ten largest German cities — aligned diurnal phase
    ("berlin", 1, 0.45), ("hamburg", 1, 0.50), ("munich", 1, 0.40),
    ("cologne", 1, 0.48), ("frankfurt", 1, 0.45), ("stuttgart", 1, 0.42),
    ("duesseldorf", 1, 0.48), ("leipzig", 1, 0.44), ("dortmund", 1, 0.48),
    ("essen", 1, 0.48),
]

# stable ids for counter-based seeding (``hash(str)`` is salted per
# process and would make draws irreproducible across runs)
_KIND_IDS = {"excess": 1, "load": 2}
_FIELD_SALTS = {"excess": 101, "util": 102, "carbon": 103, "util_init": 104}
# forecast-noise folds per kind. "load" deliberately equals the sparse
# model's "fc_noise" salt: dense and sparse stores draw *identical* load
# noise for the same (seed, row, now, lead) — one per-row keying contract
# across util modes (see ScenarioStore._noise)
_FC_SALTS = {"load": 205, "excess": 206}

# forecast memo: bounded both by entry count and by total elements so a
# 100k-client fleet cannot pin hundreds of MB of [C, H] slabs
_FORECAST_CACHE_SIZE = 16
_FORECAST_CACHE_ELEMS = 1 << 25

# default synthesis chunking: client-heavy util chunks sized so one chunk
# is ~64 MB of float32 at any fleet size; [P, T] fields use day chunks
_UTIL_CHUNK_ELEMS = 1 << 24
_DAY_STEPS = 24 * 60

# ---------------------------------------------------------------------------
# counter-based hashing for the sparse-activity util model
#
# Every random quantity of the sparse model is a pure function of integer
# keys (seed, salt, row, counter), evaluated with a vectorized
# splitmix64-style mixer — no RNG object, no stream position, so a gather
# of any row subset reproduces exactly the values a full-fleet gather
# would produce for those rows.

_U64 = np.uint64
_SPARSE_SALTS = {"init": 201, "gap": 202, "level": 203, "noise": 204,
                 "fc_noise": 205}

# The mixers themselves live in repro_torch.backend.base (the reference impl of
# the pluggable-backend op surface); the thin wrappers here keep the
# str-salt signature this module's callers and tests use.
_sm64 = backend_base.sm64
_u01 = backend_base.u01
_cheap_u01 = backend_base.cheap_u01


def _hash64(seed: int, salt: str, *keys) -> np.ndarray:
    """Chained splitmix64 over broadcastable non-negative integer keys."""
    return backend_base.hash64(seed, _SPARSE_SALTS[salt], *keys)


class _SparseUtil:
    """Sparse-activity regime process: GPU utilisation without the slab.

    The dense ``_util_chunk`` realizes the Alibaba-like regime-switching
    process as a [C, chunk] array. This class realizes the *same process
    family* — busy/idle segments with geometric(p=1/180) durations,
    busy levels 0.5+0.45·U / idle levels 0.3·U, small per-step noise —
    as **activity segments**: client ``r``'s k-th segment gap, its level
    for segment ``s``, and its step-``t`` noise are all stateless hashes,
    so ``util(r, t)`` is computable for exactly the (row, step) pairs a
    caller gathers. Segment structure (gaps, levels, initial regime) is
    O(rows × segments) splitmix work; only the per-cell noise touches the
    full [rows, window] grid, as one cheap-mixer uniform per cell —
    bounded, matched to the dense model's 0.05 noise std — so a gather
    is a few float32 passes over the grid, not dozens of uint64 ones.

    Per-chunk boundary states — the segment counter ``seg`` (number of
    switches at or before the chunk's first step) and the absolute next
    switch time — are two [C] integer columns computed once per chunk
    boundary and pinned, exactly like the dense generators' carried
    states: any evicted intermediate is regenerable bit-identically
    because segment indices are global to the trace, not chunk-local.
    """

    P_SWITCH = 1.0 / 180.0
    NOISE_STD = 0.05
    # uniform per-cell noise: amp·(u − ½) with u ∈ [0,1) has std amp/√12
    _NOISE_AMP = NOISE_STD * math.sqrt(12.0)
    # boundary states every simulated day: a gather walks ≤ 8 expected
    # switches from the boundary to its window over the *gathered rows
    # only*, while each pinned state costs just 8 bytes/client (two
    # int32 columns) — ~56 MB for a 7-day 1M-client store
    _CHUNK_STEPS = _DAY_STEPS

    def __init__(self, seed: int, n_clients: int, n_steps: int,
                 chunk_steps: int = _CHUNK_STEPS, backend=None):
        self.seed = seed & 0xFFFFFFFF
        self.n_clients = n_clients
        self.n_steps = n_steps
        self.cs = max(1, min(chunk_steps, n_steps) if n_steps else 1)
        self.bk = get_backend(backend)
        self._log1mp = math.log1p(-self.P_SWITCH)
        # (seed, salt) folds for the per-cell cheap mixer
        self._noise_fold = _hash64(self.seed, "noise")
        self._fc_fold = _hash64(self.seed, "fc_noise")
        # boundary states: _states[i] = (seg[C] int64, next_switch[C] int64)
        # at step i*cs; built lazily, index 0 from the t=0 definition
        self._states: list = []
        # recently-advanced full-fleet states keyed by exact step
        # (see _state_at)
        self._adv_states: dict = {}

    # -- stateless draws -------------------------------------------------
    def _gap(self, rows: np.ndarray, seg: np.ndarray) -> np.ndarray:
        """Geometric(p) segment gap (≥ 1 step) for segment index ``seg``."""
        u = _u01(_hash64(self.seed, "gap", rows, seg))
        return 1 + np.floor(np.log1p(-u) / self._log1mp).astype(np.int64)

    def _busy0(self, rows: np.ndarray) -> np.ndarray:
        return _u01(_hash64(self.seed, "init", rows)) < 0.5

    # -- boundary-state machinery ----------------------------------------
    def _advance(self, rows: np.ndarray, seg: np.ndarray, nxt: np.ndarray,
                 t_target: int):
        """Walk (seg, nxt) in place until ``nxt > t_target`` per row —
        i.e. ``seg`` counts the switches at or before ``t_target``."""
        active = nxt <= t_target
        while active.any():
            idx = np.nonzero(active)[0]
            seg[idx] += 1
            nxt[idx] += self._gap(rows[idx], seg[idx])
            active[idx] = nxt[idx] <= t_target

    def _state(self, i: int):
        """(seg, next_switch) for all rows at step ``i*cs`` — pinned
        int32 columns (segment counts and switch times are bounded by
        the trace length plus one gap, far under 2^31)."""
        if not self._states:
            rows = np.arange(self.n_clients, dtype=np.int64)
            seg = np.zeros(self.n_clients, dtype=np.int64)
            nxt = self._gap(rows, seg)  # first switch ≥ 1: step 0 is seg 0
            self._states.append(self._pin(seg, nxt))
        while len(self._states) <= i:
            j = len(self._states)
            rows = np.arange(self.n_clients, dtype=np.int64)
            seg, nxt = (a.astype(np.int64) for a in self._states[j - 1])
            self._advance(rows, seg, nxt, j * self.cs)
            self._states.append(self._pin(seg, nxt))
        return self._states[i]

    @staticmethod
    def _pin(seg: np.ndarray, nxt: np.ndarray):
        out = (seg.astype(np.int32), nxt.astype(np.int32))
        for a in out:
            a.flags.writeable = False
        return out

    def _state_at(self, t: int):
        """Full-fleet pinned (seg, next_switch) at step ``t`` exactly
        (``seg`` counts the switches ≤ ``t``).

        Gathers used to walk their row subset here from the chunk
        boundary on every call — O(gathered rows × switches since the
        boundary), paid again each round. Simulation time only moves
        forward (and a round touches a couple of nearby steps: the
        selection gathers at ``now``, forecasts one lead later, the
        executor back at ``now``), so this memoizes the last few states
        by exact step and advances incrementally from the nearest one
        at or below the target: a round pays a couple of cheap
        fleet-wide steps instead of re-walking every gathered row from
        the chunk boundary. Bit-exact by construction — the state at
        ``t`` is the unique fixed point (#switches ≤ t, first switch
        > t) of the same stateless gap draws, regardless of which
        earlier state the walk started from; segment indices are global
        to the trace, so a cached state serves any later step in any
        chunk. Backward access beyond the memo (tests, cold reads)
        rebuilds from the pinned chunk checkpoint.
        """
        c = self._adv_states.get(t)
        if c is not None:
            return c
        lower = [tt for tt in self._adv_states if tt < t]
        if lower:
            s0, n0 = self._adv_states[max(lower)]
        else:
            s0, n0 = self._state(t // self.cs)
        seg = s0.astype(np.int64)
        nxt = n0.astype(np.int64)
        self._advance(np.arange(self.n_clients, dtype=np.int64),
                      seg, nxt, t)
        pinned = self._pin(seg, nxt)
        self._adv_states[t] = pinned
        while len(self._adv_states) > 4:    # a round's working set + slack
            del self._adv_states[min(self._adv_states)]
        return pinned

    # -- gathers ---------------------------------------------------------
    def window(self, rows: Optional[np.ndarray], start: int, stop: int
               ) -> np.ndarray:
        """[R, stop-start] float32 util values for the gathered rows.

        Bit-identical regardless of the gather pattern: the same (row,
        step) cell always hashes to the same value, whether it arrives
        via a single-step ``spare_at`` read, a forecast window, or a full
        materialization.
        """
        if rows is None:
            rows = np.arange(self.n_clients, dtype=np.int64)
        else:
            rows = np.asarray(rows, dtype=np.int64)
        w = stop - start
        out = np.empty((rows.size, max(w, 0)), dtype=np.float32)
        if w <= 0 or rows.size == 0:
            return out
        cs = self.cs
        for i in range(start // cs, (stop - 1) // cs + 1):
            a, b = max(start, i * cs), min(stop, (i + 1) * cs)
            out[:, a - start:b - start] = self._piece(rows, i, a, b)
        return out

    def noise_u(self, rows2d: np.ndarray, t2d: np.ndarray) -> np.ndarray:
        """float32 uniform [0,1) noise cell per (row, absolute step)."""
        key = (np.asarray(rows2d, dtype=np.uint64) << _U64(24)) \
            ^ np.asarray(t2d, dtype=np.uint64)
        return _cheap_u01(self._noise_fold, key)

    def _piece(self, rows: np.ndarray, i: int, a: int, b: int) -> np.ndarray:
        """One within-chunk window [a, b) for the gathered rows.

        Full-grid work is three float32 passes (level gather, noise,
        clip) plus the cheap-mixer hash; segment structure costs
        O(rows × switches), never O(rows × window).
        """
        # full-fleet state advanced to a: switches in (i*cs, a] happened
        # before the window and are already counted
        seg0, nxt0 = self._state_at(a)
        seg = seg0[rows].astype(np.int64)
        nxt = nxt0[rows].astype(np.int64)
        t_grid = np.arange(a, b, dtype=np.int64)
        seg_start = seg.copy()
        # slot[r, t] = how many switches of row r are in (a, t]; segment
        # indices are consecutive, so slot s means segment seg_start + s
        slot = np.zeros((rows.size, b - a), dtype=np.int64)
        n_slots = 1
        active = nxt < b
        while active.any():
            idx = np.nonzero(active)[0]
            slot[idx] += t_grid[None, :] >= nxt[idx, None]
            seg[idx] += 1
            nxt[idx] += self._gap(rows[idx], seg[idx])
            active[idx] = nxt[idx] < b
            n_slots += 1
        seg_tab = seg_start[:, None] \
            + np.arange(n_slots, dtype=np.int64)[None, :]
        u = _u01(_hash64(self.seed, "level", rows[:, None], seg_tab))
        busy = self._busy0(rows)[:, None] ^ ((seg_tab & 1) == 1)
        levels = np.where(busy, 0.5 + 0.45 * u, 0.3 * u).astype(np.float32)
        # grid-heavy tail (level gather + noise + clip) runs on the
        # configured array backend as one fused window op; it is
        # bit-exact across backends
        return self.bk.synth_window(levels, slot, self._noise_fold, rows, a,
                                    self._NOISE_AMP)

    def forecast_noise(self, rows: Optional[np.ndarray], now: int,
                       horizon: int, std: np.ndarray) -> np.ndarray:
        """[R, horizon] multiplicative forecast error keyed **per row**.

        Unlike the dense store's positional streams (row r of a slab is
        the r-th stream of that instant), sparse-mode noise hashes
        ``(row, now, lead)``, so any row subset draws exactly the rows it
        asks for — block-gathered probes and full-fleet gathers agree
        bit-for-bit. ``std`` is the per-lead error std; the unit-variance
        shape is uniform (matched mean/std, bounded support), one
        cheap-mixer draw per cell.
        """
        if rows is None:
            rows = np.arange(self.n_clients, dtype=np.int64)
        else:
            rows = np.asarray(rows, dtype=np.int64)
        # premix the row id into a full-width hash (O(rows), off the
        # grid), then fold the structured (now, lead) field in: no bit
        # budget for any field, so long traces/horizons cannot collide
        # across rows the way packed bit fields would. The backend draws
        # the pre-exp exponent; exp stays host-side (transcendentals are
        # not bit-portable across backends — see repro_torch.backend.base)
        z = self.bk.forecast_noise_z(self._fc_fold, rows, now, horizon, std)
        return np.exp(z, out=z)

    def spare_ub_segments(self, rows: Optional[np.ndarray], start: int,
                          stop: int):
        """Regime segments of the gathered rows over [start, stop), each
        carrying a certified upper bound on every spare-fraction cell
        (1 − util) the window can realize inside it.

        Returns CSR columns ``(ptr [R+1], a [N], b [N], x_ub [N])``:
        row ``r``'s segments are ``ptr[r]:ptr[r+1]``, consecutive with
        absolute step bounds clipped to the window (``a < b``). The
        bound chain uses only monotone rounded float32 ops, mirroring
        the realized grid: the per-cell noise is ≥ −amp/2 *exactly*
        (a power-of-two scale of the centered uniform), so
        ``util ≥ clip(level − amp/2)`` cell-wise and hence
        ``1 − clip(level − amp/2) ≥ 1 − util`` for every realizable
        cell — certified, not sampled. O(rows × switches) host work,
        never O(rows × window); this is the segment structure the exact
        uncapped reach evaluator prices (see ``core/selection.py``).
        """
        if rows is None:
            rows = np.arange(self.n_clients, dtype=np.int64)
        else:
            rows = np.asarray(rows, dtype=np.int64)
        R = rows.size
        if stop <= start or R == 0:
            z = np.zeros(0, dtype=np.int64)
            return (np.zeros(R + 1, dtype=np.int64), z, z,
                    np.zeros(0, dtype=np.float64))
        seg0, nxt0 = self._state_at(start)
        seg = seg0[rows].astype(np.int64)
        nxt = nxt0[rows].astype(np.int64)
        seg_start = seg.copy()
        cuts = []  # absolute end of slot s per row (stop once inactive)
        active = nxt < stop
        while active.any():
            idx = np.nonzero(active)[0]
            cut = np.full(R, stop, dtype=np.int64)
            cut[idx] = nxt[idx]
            cuts.append(cut)
            seg[idx] += 1
            nxt[idx] += self._gap(rows[idx], seg[idx])
            active[idx] = nxt[idx] < stop
        S = len(cuts) + 1
        bnd = np.empty((R, S + 1), dtype=np.int64)
        bnd[:, 0] = start
        for s, cut in enumerate(cuts):
            bnd[:, s + 1] = cut
        bnd[:, S] = stop
        a2, b2 = bnd[:, :-1], bnd[:, 1:]
        keep = a2 < b2
        ptr = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(keep.sum(axis=1), out=ptr[1:])
        # hash levels for the kept segments only: rows average ~1.33
        # live segments but the (row, slot) rectangle is S wide, so
        # flattening first cuts the level-hash grid ~S-fold. Same hash
        # inputs per surviving cell — bit-identical to hashing the
        # rectangle and filtering after
        flat = np.nonzero(keep.ravel())[0]
        r = flat // S
        seg_flat = seg_start[r] + (flat - r * S)
        u = _u01(_hash64(self.seed, "level", rows[r], seg_flat))
        busy = self._busy0(rows)[r] ^ ((seg_flat & 1) == 1)
        levels = np.where(busy, 0.5 + 0.45 * u, 0.3 * u).astype(np.float32)
        util_lb = np.clip(levels - np.float32(0.5 * self._NOISE_AMP),
                          0.0, 1.0)
        x = (np.float32(1.0) - util_lb).astype(np.float64)
        # a2[r, s] and b2[r, s] live at bnd.flat[flat + r] and +1 (the
        # bnd row is one wider than the keep grid) — index the flat
        # buffer instead of materializing strided ravel copies
        bf = bnd.ravel()
        return ptr, bf[flat + r], bf[flat + r + 1], x


def solar_curve(t_min: np.ndarray, utc_offset, peak_w,
                cloud: np.ndarray) -> np.ndarray:
    """Clear-sky diurnal curve in W at local solar time, × cloud factor.

    Broadcasts: ``t_min`` [n] with ``utc_offset``/``cloud`` of shape
    [P, 1] / [P, n] yields the whole [P, n] panel in one call.
    ``peak_w`` is a scalar or a per-domain [P, 1] column (fleets whose
    domains declare different ``max_output`` panels).
    """
    local_h = (t_min / 60.0 + utc_offset) % 24.0
    sunrise, sunset = 6.0, 20.0
    x = (local_h - sunrise) / (sunset - sunrise)
    clear = np.where((x > 0) & (x < 1), np.sin(np.pi * np.clip(x, 0, 1)) ** 1.3, 0.0)
    return peak_w * clear * cloud


class ScenarioStore:
    """Chunked float32 store of actual + forecastable scenario series.

    Construct either from explicit arrays (``excess``/``util``/``carbon``
    — drop-in real traces, any dtype; stored as float32 copies) or from a
    synthesis spec via :func:`make_scenario` (lazy chunked generation).

    Field access
    ------------
    * ``excess_at(step)`` → [P] view; ``spare_at(step, rows=None)`` → [C]
      (or [len(rows)] gather) fraction of capacity free;
    * ``excess_forecast(now, h)`` → [P, h]; ``spare_forecast(now, h,
      rows=None)`` → [C or len(rows), h] — pass the currently-eligible
      registry rows so the per-round noise draw is [k, h] instead of
      [C, h];
    * the ``excess``/``util``/``carbon`` properties materialize the full
      [R, T] float32 array once and pin it (chunks become views into it),
      so in-place mutation — e.g. the night-time ablations in the tests —
      behaves exactly like the old eager slabs. Avoid them on 100k-client
      fleets; the chunked accessors above are the hot path.

    Forecast contract (batched + memoized)
    --------------------------------------
    ``excess_forecast``/``spare_forecast`` return ``actual × noise`` slabs
    where the multiplicative log-normal error is drawn in **one batched
    RNG call** per ``(kind, now, rows)``: the generator is counter-seeded
    from ``(seed, kind, now)`` so any request is reproducible in isolation
    (no dependence on call order), and the rows of a slab are independent
    error streams. Results are memoized in a small element-budgeted LRU,
    so repeated ``EnvView`` builds within a round are free; cached arrays
    are returned **read-only** (the identical object every time) — copy
    before mutating. If you mutate ``excess``/``util`` after construction,
    call ``clear_forecast_cache()`` so memoized forecasts don't go stale.
    """

    def __init__(self, excess: Optional[np.ndarray] = None,
                 util: Optional[np.ndarray] = None,
                 domain_names: Optional[List[str]] = None, seed: int = 0,
                 error: str = "realistic", unlimited_domains: tuple = (),
                 carbon: Optional[np.ndarray] = None, *,
                 synth: Optional[dict] = None,
                 util_chunk_elems: int = _UTIL_CHUNK_ELEMS,
                 backend=None):
        self.domain_names = list(domain_names or [])
        self.seed = seed
        self.error = error                # realistic | none | no_load
        self.unlimited_domains = tuple(unlimited_domains)
        # array backend for the sparse-util gather grids and for the
        # dense chunk generators' RNG streams (``chunk_rng`` — host-pinned
        # PCG64 by contract in every backend, so dense goldens stay
        # bit-identical regardless of ``RunSection(backend=...)``)
        self.backend = get_backend(backend)
        self._synth = synth
        self._forecast_cache: "OrderedDict[Tuple, Tuple]" = OrderedDict()

        if synth is not None:
            self._n_clients = int(synth["n_clients"])
            self._n_steps = int(synth["n_steps"])
            self._has_carbon = True
            mode = synth.get("util_mode", "dense")
            if mode not in ("dense", "sparse"):
                raise ValueError(f"unknown util_mode {mode!r}")
        else:
            if excess is None or util is None:
                raise ValueError("provide excess+util arrays or a synth spec")
            self._n_clients = util.shape[0]
            self._n_steps = excess.shape[1]
            self._has_carbon = carbon is not None

        P = len(self.domain_names)
        T = self._n_steps
        cs_pt = min(T, _DAY_STEPS) or 1
        cs_util = max(64, min(T, _DAY_STEPS,
                              util_chunk_elems // max(self._n_clients, 1))) \
            if T else 1
        self._cs = {"excess": cs_pt, "util": cs_util, "carbon": cs_pt}
        self._cache: Dict[str, OrderedDict] = {
            f: OrderedDict() for f in self._cs}
        self._elems = {f: 0 for f in self._cs}
        # only client-heavy synthesized util chunks are eviction-managed
        self._budget = {"excess": 0, "carbon": 0,
                        "util": 4 * self._n_clients * cs_util}
        self._states: Dict[str, list] = {}

        def _adopt(field, arr):
            a = np.array(arr, dtype=np.float32)  # private float32 copy
            if a.shape[1] != T:
                raise ValueError(f"{field} has {a.shape[1]} steps, "
                                 f"expected {T}")
            return a

        self._util_sparse: Optional[_SparseUtil] = None
        if synth is not None:
            self._backing = {f: None for f in self._cs}
            z0 = np.zeros(P)
            if synth.get("util_mode", "dense") == "sparse":
                # sparse-activity util: no dense chunk generator, no
                # [C, chunk] slab — the regime process is gathered per row
                self._util_sparse = _SparseUtil(seed, self._n_clients,
                                                self._n_steps,
                                                backend=self.backend)
                self._states = {"excess": [z0], "carbon": [None]}
            else:
                busy0, lvl0 = self._util_init_state()
                self._states = {"excess": [z0], "util": [(busy0, lvl0)],
                                "carbon": [None]}
        else:
            self._backing = {
                "excess": _adopt("excess", excess),
                "util": _adopt("util", util),
                "carbon": _adopt("carbon", carbon) if self._has_carbon
                else None,
            }
            for name in self.unlimited_domains:
                i = self.domain_names.index(name)
                self._backing["excess"][i, :] = 1e9

    # ---- shape ---------------------------------------------------------
    @property
    def n_steps(self) -> int:
        return self._n_steps

    @property
    def n_clients(self) -> int:
        return self._n_clients

    @property
    def util_mode(self) -> str:
        """'sparse' when util is served by the sparse-activity model —
        the signal strategies use to pick the sharded selection path."""
        return "sparse" if self._util_sparse is not None else "dense"

    # ---- chunk machinery -----------------------------------------------
    def _chunk(self, field: str, i: int) -> np.ndarray:
        cache = self._cache[field]
        hit = cache.get(i)
        if hit is not None:
            cache.move_to_end(i)
            return hit
        backing = self._backing[field]
        cs = self._cs[field]
        if backing is not None:
            view = backing[:, i * cs:(i + 1) * cs]
            cache[i] = view  # views are free: no budget accounting
            return view
        gen = {"excess": self._excess_chunk, "util": self._util_chunk,
               "carbon": self._carbon_chunk}[field]
        states = self._states[field]
        while len(states) <= i:  # walk boundary states forward
            j = len(states) - 1
            data, nxt = gen(j, states[j])
            states.append(nxt)
            self._put(field, j, data)
        data, nxt = gen(i, states[i])
        if len(states) == i + 1:
            states.append(nxt)
        self._put(field, i, data)
        return data

    def _put(self, field: str, i: int, data: np.ndarray):
        data.flags.writeable = False  # shared via cache: copy to mutate
        cache = self._cache[field]
        cache[i] = data
        self._elems[field] += data.size
        budget = self._budget[field]
        while budget and self._elems[field] > budget and len(cache) > 2:
            _, old = cache.popitem(last=False)
            self._elems[field] -= old.size

    def _window(self, field: str, start: int, stop: int,
                rows: Optional[np.ndarray] = None) -> np.ndarray:
        """[R, stop-start] assembled from ≤ a few chunks; with ``rows``,
        gathers just those rows from each chunk (O(len(rows)·width)).

        In sparse util mode the window is hash-synthesized for exactly
        the gathered rows — no [C, chunk] slab exists to slice."""
        if field == "util" and self._util_sparse is not None \
                and self._backing["util"] is None:
            return self._util_sparse.window(rows, start, stop)
        cs = self._cs[field]
        parts = []
        for i in range(start // cs, (stop - 1) // cs + 1):
            c0 = i * cs
            lo, hi = max(start, c0) - c0, min(stop, c0 + cs) - c0
            ch = self._chunk(field, i)
            parts.append(ch[rows, lo:hi] if rows is not None
                         else ch[:, lo:hi])
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)

    def _materialize(self, field: str) -> np.ndarray:
        """Assemble the full [R, T] array once, pin it, and redirect the
        chunk cache to views of it so in-place mutation stays visible."""
        backing = self._backing[field]
        if backing is None:
            if field == "util" and self._util_sparse is not None:
                # full sparse materialization (tests / small fleets): the
                # same gather path, all rows — bit-identical to windowed
                # reads, mutable afterwards like any pinned backing
                backing = self._util_sparse.window(None, 0, self._n_steps)
            else:
                cs = self._cs[field]
                n_chunks = max(1, math.ceil(self._n_steps / cs))
                backing = np.concatenate(
                    [self._chunk(field, i) for i in range(n_chunks)], axis=1)
            self._backing[field] = backing
            self._cache[field].clear()
            self._elems[field] = 0
            self._budget[field] = 0
        return backing

    # eager full-array views — I/O/test boundary, not the round hot path
    @property
    def excess(self) -> np.ndarray:
        return self._materialize("excess")

    @property
    def util(self) -> np.ndarray:
        return self._materialize("util")

    @property
    def carbon(self) -> Optional[np.ndarray]:
        return self._materialize("carbon") if self._has_carbon else None

    # ---- chunk generators (pure in (seed, field, chunk, state)) --------
    def _rng(self, salt: int, i: int) -> np.random.Generator:
        return self.backend.chunk_rng(self.seed, salt, i)

    def _excess_chunk(self, i: int, z_state: np.ndarray):
        """Solar excess [P, n]: diurnal curve × AR(1) cloud attenuation,
        held in 5-minute blocks like the Solcast data. ``z_state`` is the
        AR(1) latent at the chunk boundary."""
        sp = self._synth
        cities, peak_w, rho = sp["cities"], sp["peak_w"], 0.97
        P = len(cities)
        peak_w = np.asarray(peak_w, dtype=float)
        if peak_w.ndim:  # per-domain [P] peaks → column for broadcasting
            if peak_w.shape != (P,):
                raise ValueError(
                    f"peak_w has shape {peak_w.shape}, expected scalar "
                    f"or ({P},)")
            peak_w = peak_w[:, None]
        c0 = i * self._cs["excess"]
        n = min(self._cs["excess"], self._n_steps - c0)
        n5 = -(-n // 5)
        eps = self._rng(_FIELD_SALTS["excess"], i).standard_normal((P, n5))
        if i == 0:
            eps[:, 0] = 0.0  # z starts at the boundary state exactly
        zi = (rho * z_state)[:, None]
        z, _ = lfilter([np.sqrt(1 - rho ** 2)], [1.0, -rho], eps,
                       axis=1, zi=zi)
        base = np.array([c[2] for c in cities])[:, None]
        atten = np.clip(1.0 - base * (1 / (1 + np.exp(-z))), 0.05, 1.0)
        t5 = c0 + 5.0 * np.arange(n5)
        offsets = np.array([c[1] for c in cities], dtype=float)[:, None]
        ex5 = solar_curve(t5, offsets, peak_w, atten)
        ex = np.repeat(ex5, 5, axis=1)[:, :n].astype(np.float32)
        for name in self.unlimited_domains:
            ex[self.domain_names.index(name), :] = 1e9
        return ex, z[:, -1]

    def _util_init_state(self):
        rng = self._rng(_FIELD_SALTS["util_init"], 0)
        busy = rng.random(self._n_clients) < 0.5
        u = rng.random(self._n_clients, dtype=np.float32)
        level = np.where(busy, 0.5 + 0.45 * u, 0.3 * u).astype(np.float32)
        return busy, level

    def _util_chunk(self, i: int, state):
        """Regime-switching GPU utilisation in [0, 1] (Alibaba-like),
        float32 throughout: per-chunk switch/level/noise draws, with the
        (busy regime, current level) per client carried across chunks."""
        busy, level = state
        C = self._n_clients
        c0 = i * self._cs["util"]
        n = min(self._cs["util"], self._n_steps - c0)
        rng = self._rng(_FIELD_SALTS["util"], i)
        switch = rng.random((C, n), dtype=np.float32) < (1 / 180.0)
        if i == 0:
            switch[:, 0] = False  # step 0 stays in the initial regime
        seg = np.cumsum(switch, axis=1, dtype=np.int32)
        n_seg = int(seg[:, -1].max()) + 1 if n else 1
        u = rng.random((C, n_seg), dtype=np.float32)
        parity = (np.arange(n_seg)[None, :] % 2) == 1
        busy_tab = busy[:, None] ^ parity
        levels = np.where(busy_tab, 0.5 + 0.45 * u, 0.3 * u).astype(np.float32)
        levels[:, 0] = level  # segment 0 continues the carried level
        util = np.take_along_axis(levels, seg, axis=1)
        noise = rng.standard_normal((C, n), dtype=np.float32)
        noise *= np.float32(0.05)
        util += noise
        np.clip(util, 0.0, 1.0, out=util)
        last = seg[:, -1] if n else np.zeros(C, np.int32)
        nxt = (busy ^ (last % 2 == 1), levels[np.arange(C), last])
        return util, nxt

    def _carbon_chunk(self, i: int, _state):
        """Grid carbon intensity (gCO2/kWh): anti-correlated with solar
        (fossil peakers at night) + noise — grid-fallback mode only."""
        sp = self._synth
        cities = sp["cities"]
        P = len(cities)
        c0 = i * self._cs["carbon"]
        n = min(self._cs["carbon"], self._n_steps - c0)
        t = c0 + np.arange(n)
        local_h = (t[None, :] / 60.0
                   + np.array([c[1] for c in cities])[:, None]) % 24.0
        base = 450.0 - 250.0 * np.exp(-((local_h - 13.0) ** 2) / 18.0)
        noise = self._rng(_FIELD_SALTS["carbon"], i).normal(0, 25, (P, n))
        return np.clip(base + noise, 80.0, 700.0).astype(np.float32), None

    # ---- forecasts -----------------------------------------------------
    def clear_forecast_cache(self):
        """Drop memoized forecast slabs (call after mutating actuals)."""
        self._forecast_cache.clear()

    def _noise(self, kind: str, now: int, n_rows: int, horizon: int,
               rows: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """[n_rows, horizon] multiplicative forecast error for lead 1..h.

        Keyed **per row** in every util mode: the cell for (seed, row,
        now, lead) is a stateless counter hash, so a gathered row subset
        draws exactly the rows it asks for and equals the full-fleet
        draw bit-for-bit — the contract the sharded selection path's
        block-gathered probes rely on. Load noise is keyed by registry
        row (sparse and dense stores share the fold, so both modes draw
        identical load noise), excess noise by domain row. The
        unit-variance shape is uniform (matched mean/std, bounded
        support), one cheap-mixer draw per cell.
        """
        if self.error == "none":
            return None  # exact forecast: no draw at all
        if kind == "load" and self.error == "no_load":
            return None  # no load forecast available
        lead = np.arange(1, horizon + 1, dtype=np.float32)
        std = 0.05 + 0.20 * np.minimum(lead / 1440.0, 1.0)
        if kind == "load" and self._util_sparse is not None:
            return self._util_sparse.forecast_noise(rows, now, horizon, std)
        fold = backend_base.hash64(self.seed & 0xFFFFFFFF, _FC_SALTS[kind])
        rows_arr = np.arange(n_rows, dtype=np.int64) if rows is None \
            else np.asarray(rows, dtype=np.int64)
        z = self.backend.forecast_noise_z(fold, rows_arr, now, horizon, std)
        return np.exp(z, out=z)

    def _forecast(self, kind: str, field: str, now: int, horizon: int,
                  invert: bool, rows: Optional[np.ndarray] = None
                  ) -> np.ndarray:
        """Memoized ``actual × noise`` float32 slab; ``invert`` turns a
        utilisation window into spare fraction (1 − util) first."""
        key = (kind, now, horizon, -1 if rows is None else len(rows))
        hit = self._forecast_cache.get(key)
        if hit is not None:
            crows, slab = hit
            if (rows is None and crows is None) or \
                    (rows is not None and crows is not None
                     and np.array_equal(rows, crows)):
                self._forecast_cache.move_to_end(key)
                return slab
        stop = min(now + 1 + horizon, self._n_steps)
        R = len(rows) if rows is not None else \
            (self._n_clients if field == "util" else len(self.domain_names))
        if stop <= now + 1:
            actual = np.zeros((R, 0), dtype=np.float32)
        else:
            actual = self._window(field, now + 1, stop, rows=rows)
        if invert:
            actual = np.float32(1.0) - actual
        n = actual.shape[1]
        noise = self._noise(kind, now, R, horizon, rows=rows)
        if n == horizon:
            out = actual.copy() if noise is None else actual * noise
        else:  # end of trace: zero-pad the short window
            out = np.zeros((R, horizon), dtype=np.float32)
            out[:, :n] = actual if noise is None else actual * noise[:, :n]
        if invert:
            np.clip(out, 0.0, 1.0, out=out)
        out.flags.writeable = False
        self._forecast_cache[key] = (
            None if rows is None else np.array(rows, copy=True), out)
        total = sum(v[1].size for v in self._forecast_cache.values())
        while len(self._forecast_cache) > 1 and (
                len(self._forecast_cache) > _FORECAST_CACHE_SIZE
                or total > _FORECAST_CACHE_ELEMS):
            _, (_, old) = self._forecast_cache.popitem(last=False)
            total -= old.size
        return out

    def excess_forecast(self, now: int, horizon: int) -> np.ndarray:
        """[P, horizon] forecast of excess power for steps now+1..now+h."""
        return self._forecast("excess", "excess", now, horizon, invert=False)

    def spare_forecast(self, now: int, horizon: int,
                       rows: Optional[np.ndarray] = None
                       ) -> Optional[np.ndarray]:
        """[C, horizon] (or [len(rows), horizon]) forecast *fraction* of
        capacity free; None under the no-load-forecast ablation. Pass the
        currently-eligible registry rows to gather before the noise draw."""
        if self.error == "no_load":
            return None
        return self._forecast("load", "util", now, horizon, invert=True,
                              rows=rows)

    def spare_ub_overlay(self, now: int, horizon: int,
                         rows: Optional[np.ndarray] = None
                         ) -> Optional[dict]:
        """Inputs of the exact uncapped reach evaluator: certified
        spare-fraction upper bounds as regime segments over the forecast
        window now+1..now+horizon, plus the per-lead noise-multiplier
        bound (consumed by ``core/selection.py``'s ``_LazyGreedy``).

        None when util is dense (no segment structure to expose) or
        under the no-load-forecast ablation (``spare_forecast`` is None
        and the lazy walk's capacity grant is already exact). Keys:
        ``ptr``/``a``/``b``/``x_ub`` — CSR segments with
        **window-relative** step bounds; segments past the trace end are
        absent, and forecasts zero-pad there, so absent means zero
        spare — and ``noise_mult_ub``, [horizon] float64 ν with ν[j] an
        upper bound on every realizable multiplicative forecast-noise
        factor at lead j+1 (ν is nondecreasing in lead, so ν at a probe
        duration bounds the whole prefix).
        """
        if self._util_sparse is None or self.error == "no_load":
            return None
        start = now + 1
        stop = min(start + horizon, self._n_steps)
        ptr, a, b, x = self._util_sparse.spare_ub_segments(rows, start,
                                                           stop)
        return {"ptr": ptr, "a": a - start, "b": b - start, "x_ub": x,
                "noise_mult_ub": self._noise_mult_ub(horizon)}

    def _noise_mult_ub(self, horizon: int) -> np.ndarray:
        """[horizon] certified upper bounds on the multiplicative
        forecast-noise factor per lead. The drawn float32 exponent is
        (u − ½)·√12·std with |u − ½| ≤ ½ and std nondecreasing in lead,
        so exp(√3·std) dominates every realizable factor; the 1e-6
        relative slack absorbs the few-ulp float32 roundings of the
        exponent chain, of the host exp, and of the forecast's
        actual × noise product (≲ 5e-7 combined)."""
        if self.error == "none":
            return np.ones(horizon)
        lead = np.arange(1, horizon + 1, dtype=np.float32)
        std = 0.05 + 0.20 * np.minimum(lead / 1440.0, 1.0)
        return np.exp(np.sqrt(3.0) * std.astype(np.float64)) * (1.0 + 1e-6)

    # ---- actuals -------------------------------------------------------
    def excess_at(self, step: int) -> np.ndarray:
        t = min(step, self._n_steps - 1)
        cs = self._cs["excess"]
        return self._chunk("excess", t // cs)[:, t % cs]

    def spare_at(self, step: int, rows: Optional[np.ndarray] = None
                 ) -> np.ndarray:
        """[C] (or [len(rows)]) fraction of capacity free at ``step``.

        Pass ``rows`` to gather just a client subset — the simulation step
        loop asks for only the selected clients, which turns an O(C)
        column read into an O(n_selected) gather (and, in sparse util
        mode, synthesizes only those rows).
        """
        t = min(step, self._n_steps - 1)
        return np.float32(1.0) - self._window("util", t, t + 1, rows)[:, 0]

    def spare_window(self, start: int, horizon: int,
                     rows: Optional[np.ndarray] = None) -> np.ndarray:
        """[R, w] spare-fraction columns for steps ``start .. start+h``
        (clipped to the trace end, ``w = min(horizon, n_steps - start)``).

        Column j equals ``spare_at(start + j, rows)`` exactly — the round
        executor gathers its selected rows' whole window once instead of
        issuing one ``spare_at`` per simulated minute.
        """
        stop = min(start + horizon, self._n_steps)
        if stop <= start:
            R = len(rows) if rows is not None else self._n_clients
            return np.zeros((R, 0), dtype=np.float32)
        return np.float32(1.0) - self._window("util", start, stop, rows)

    def carbon_at(self, step: int) -> np.ndarray:
        """[P] grid carbon intensity (gCO2/kWh) — used only by the
        grid-fallback mode (paper Alg. 1 line 19 / §7 future work)."""
        if not self._has_carbon:
            return np.full(len(self.domain_names), 400.0)
        t = min(step, self._n_steps - 1)
        cs = self._cs["carbon"]
        return self._chunk("carbon", t // cs)[:, t % cs]

    def carbon_window(self, start: int, horizon: int) -> np.ndarray:
        """[P, w] carbon-intensity columns for steps ``start .. start+h``
        (clipped to the trace end, ``w = min(horizon, n_steps - start)``).

        One chunk gather per round instead of a ``carbon_at`` read per
        step — column j equals ``carbon_at(start + j)`` exactly (see
        tests/test_grid_fallback.py for the per-step parity pin).
        """
        stop = min(start + horizon, self._n_steps)
        width = max(stop - start, 0)
        if not self._has_carbon:
            return np.full((len(self.domain_names), width), 400.0)
        if width == 0:
            return np.zeros((len(self.domain_names), 0), dtype=np.float32)
        return self._window("carbon", start, stop)


# Drop-in name for loading real traces / test fixtures from arrays.
ScenarioData = ScenarioStore


def make_scenario(name: str, n_clients: int = 100, days: int = 7, seed: int = 0,
                  peak_w=800.0, error: str = "realistic",
                  unlimited_domains: tuple = (),
                  util_mode: str = "dense",
                  backend=None) -> ScenarioStore:
    """name: 'global' or 'co_located' (paper Fig. 2).

    Returns a lazily-synthesized :class:`ScenarioStore`: nothing is
    generated until the first access, and generation happens in seeded
    per-chunk batched draws, so 100k-client multi-day scenarios cost
    resident-chunk memory (a few hundred MB) rather than eager slabs.
    ``util_mode="sparse"`` swaps the dense util chunk generator for the
    sparse-activity model (:class:`_SparseUtil`) — the million-client
    path, which synthesizes util values only for gathered rows.
    ``peak_w`` may be a scalar or a per-domain [P] array (satellite of
    per-domain ``max_output`` fleets); ``backend`` picks the array
    backend serving the sparse-util gather grids.
    """
    cities = GLOBAL_CITIES if name == "global" else CO_LOCATED_CITIES
    return ScenarioStore(
        domain_names=[c[0] for c in cities], seed=seed, error=error,
        unlimited_domains=unlimited_domains, backend=backend,
        synth={"cities": cities, "peak_w": peak_w, "n_clients": n_clients,
               "n_steps": days * 24 * 60, "util_mode": util_mode})
