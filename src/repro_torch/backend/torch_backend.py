"""PyTorch backend: the scheduling hot path as eager tensor ops on a device.

Overrides every op the reference's fused-jit backend accelerates, with
the NumPy reference's bits (the contract in :mod:`.base`). Every
overridden op runs on ``self.device`` at every size: there is no
host/device crossover and no shape bucketing (eager PyTorch does not
recompile per shape), so each op works on exact-length tensors. The host
control flow around it (``core``, ``data``) stays NumPy, as in the
reference; ``chunk_rng`` and ``reach_tables`` stay host-pinned by
contract.

The two synthesis-grid ops go to the hand-written CUDA kernels of
:mod:`repro_torch.kernels.counter_hash`: ``synth_window`` to
``piece_window`` (K1) and ``forecast_noise_z`` to ``forecast_z`` (K2),
one launch and one tick per window. On a CPU device the kernel wrappers
run their plain PyTorch versions, which is how the CPU tests reach them.
``window_shapes`` counts the (op, R, W) shape of every window served, so
a run can show what the kernels were given.

Where PyTorch could break bit parity, and what this module does:

* **uint64 hashing** — torch has no uint64 add, shift or multiply on the
  CPU, so the mixers run on int64-held bits
  (:mod:`repro_torch.kernels.counter_hash`: add, multiply and xor wrap
  identically; logical shifts are masked arithmetic shifts).
* **FMA and reassociation** — every float multiply and add is its own
  eager op, which rounds, so no multiply→add or multiply→multiply seam
  can be contracted. No ``addcmul``, no ``torch.compile``.
* **cumulative sums** — ``take_reach`` and ``admit_domains`` feed
  NumPy's left-to-right ``np.cumsum`` bits into admissions, so they scan
  the W ≤ d_max columns sequentially, one add per column, on every
  device (``torch.cumsum`` on CUDA has no specified order). The
  per-domain margin scan is decision-safe under any order and uses
  ``torch.cumsum``.
* **top-M ties** — a stable descending sort of the reversed scores puts
  equal values largest-position first, the contract's tie rule
  (``torch.topk`` has no specified tie order).
* **transcendentals** — ``forecast_noise_z`` returns the exponent before
  ``exp``; callers apply ``np.exp`` on the host.

Dispatch ledger: ops tick ``ArrayBackend._tick`` as the reference's
fused-jit backend does (one per synthesis window, two per reach probe,
one per admission chunk), so the ledgers compare; eager PyTorch enqueues
several CUDA kernels behind one tick.

Fleet columns, score handles and the per-round reach state (prefix
tables and segment columns) stay on the device across probes; each probe
uploads only its per-duration thresholds and ranks.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import counter_hash
from ..kernels.counter_hash import cheap_u01_t, i64, sm64_t, srl
from .base import MARGIN, _reach_rank
from .base import sm64 as host_sm64
from .numpy_backend import NumpyBackend

_U64 = np.uint64


def _cumsum_cols(x: torch.Tensor) -> torch.Tensor:
    """[B, W] row-wise cumulative sum with NumPy's bit order: one add per
    column, left to right, over a column-major copy (so each add reads
    and writes contiguous memory)."""
    xt = x.t().contiguous()
    cols = xt.unbind(0)
    for c in range(1, len(cols)):
        cols[c].add_(cols[c - 1])
    return xt.t()


def _nonneg(x: torch.Tensor) -> torch.Tensor:
    """``np.maximum(x, 0.0)`` for non-NaN ``x``, signed zeros included
    (numpy returns the second operand on a tie)."""
    return torch.where(x > 0.0, x, 0.0)


class TorchBackend(NumpyBackend):
    """The reference op surface as PyTorch ops on ``device``.

    ``device=None`` means ``cuda:0`` and raises ``RuntimeError`` where
    CUDA is absent; pass ``device="cpu"`` to run on the CPU."""

    name = "torch"

    def __init__(self, device=None):
        self.device = resolve_device(
            device, f"to run backend {self.name!r} on the CPU pass an "
            f"instance, e.g. {type(self).__name__}(device='cpu')")
        self.window_shapes: Counter = Counter()

    def __repr__(self):
        return f"<ArrayBackend {self.name} on {self.device}>"

    # -- host <-> device ----------------------------------------------------
    def _t(self, a, dtype=None) -> torch.Tensor:
        """Host array (or a tensor handle) → tensor on this device.
        uint64 arrays travel as their int64 bits."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        a = np.asarray(a, dtype=dtype)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    @staticmethod
    def _np(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    # -- counter-hash synthesis primitives -------------------------------
    def sm64(self, x):
        x = np.asarray(x, dtype=np.uint64)
        self._tick("sm64")
        return self._np(sm64_t(self._t(x))).view(np.uint64)

    def u01(self, h):
        self._tick("u01")
        h = self._t(np.asarray(h, dtype=np.uint64))
        return self._np(srl(h, 11).to(torch.float64) * 2.0 ** -53)

    def cheap_u01(self, fold, key):
        self._tick("cheap_u01")
        key = self._t(np.asarray(key, dtype=np.uint64))
        return self._np(cheap_u01_t(key ^ i64(fold)))

    def hash64(self, seed, salt, *keys):
        h0 = host_sm64(np.asarray(_U64(seed) ^ host_sm64(
            np.asarray(_U64(salt)))))
        if not keys:
            return h0
        h = torch.tensor(i64(h0), dtype=torch.int64, device=self.device)
        for k in keys:
            self._tick("hash64")
            h = sm64_t(h ^ self._t(np.asarray(k, dtype=np.uint64)))
        return self._np(h).view(np.uint64)

    # -- fused synthesis grids -------------------------------------------
    def cell_noise(self, fold, rows, t_grid):
        self._tick("cell_noise")
        rows = self._t(np.asarray(rows, dtype=np.uint64))
        t_grid = self._t(np.asarray(t_grid, dtype=np.uint64))
        key = (rows[:, None] << 24) ^ t_grid[None, :]
        return self._np(cheap_u01_t(key ^ i64(fold)))

    def _window_args(self, levels, slot, rows):
        return (self._t(levels, np.float32), self._t(slot, np.int64),
                self._t(np.asarray(rows, dtype=np.uint64)))

    def _forecast_args(self, rows, horizon, std):
        std = np.broadcast_to(np.asarray(std, dtype=np.float32), (horizon,))
        return self._t(np.asarray(rows, dtype=np.uint64)), self._t(std)

    def synth_window(self, levels, slot, fold, rows, t0, amp):
        lv, sl, rw = self._window_args(levels, slot, rows)
        self._tick("synth_window")
        self.window_shapes["synth_window", *sl.shape] += 1
        return self._np(counter_hash.piece_window(lv, sl, fold, rw, t0, amp))

    def forecast_noise_z(self, fc_fold, rows, now, horizon, std):
        rw, sd = self._forecast_args(rows, horizon, std)
        self._tick("forecast_noise_z")
        self.window_shapes["forecast_noise_z", rw.shape[0], horizon] += 1
        # a fresh writable array: callers apply np.exp(z, out=z) in place
        return self._np(counter_hash.forecast_z(fc_fold, rw, now, sd))

    # -- greedy-solver elementwise math ----------------------------------
    def _takes(self, spare, budget_rows, delta):
        return torch.minimum(self._t(spare),
                             self._t(budget_rows) / self._t(delta)[:, None])

    def take_matrix(self, spare, budget_rows, delta):
        self._tick("take_matrix")
        return self._np(self._takes(spare, budget_rows, delta))

    def take_reach(self, spare, budget_rows, delta):
        self._tick("take_reach")
        return self._np(_cumsum_cols(self._takes(spare, budget_rows, delta)))

    def greedy_scores(self, sigma, reach, m_min, m_max):
        self._tick("greedy_scores")
        total = torch.minimum(self._t(reach), self._t(m_max))
        score = self._t(sigma) * total
        return self._np(score), self._np(total >= self._t(m_min))

    # -- lazy-greedy candidate scoring / selection ------------------------
    def fleet_cols(self, **cols):
        """Move the per-round fleet columns device-resident (exact
        length)."""
        self._tick("fleet_cols")
        return {k: self._t(v) for k, v in cols.items()}

    def score_ub(self, cols, excess_col, dd):
        self._tick("score_ub")
        ex = self._t(excess_col)[cols["dom"]]
        reach_ub = torch.minimum(cols["spare_ub"] * dd, ex / cols["delta"])
        ok = (reach_ub >= cols["m_min"]) & (ex > 0)
        ub = torch.where(ok, cols["sigma"] * torch.minimum(reach_ub,
                                                           cols["m_max"]),
                         -torch.inf)
        return ub, int(torch.isfinite(ub).sum())

    def viable_positions(self, ub):
        return self._np(torch.nonzero(torch.isfinite(self._t(ub)))[:, 0])

    def top_m(self, ub, M):
        self._tick("top_m")
        ub = self._t(ub)
        n = ub.shape[0]
        # stable sort of the reversed scores: equal values keep reversed
        # order, i.e. largest original position first
        vals, ridx = torch.sort(ub.flip(0), descending=True, stable=True)
        return self._np((n - 1) - ridx[:M]), float(vals[M])

    def adopt_scores(self, ub):
        self._tick("adopt_scores")
        return self._t(np.asarray(ub, dtype=np.float64))

    # -- segment-domain reach evaluator ----------------------------------
    @staticmethod
    def _reach_g(cnt, csum, dom, a, b, j, w, dd):
        """Per-segment ``G(min(b, dd), w) − G(min(a, dd), w)`` against
        device prefix tables. The float64 product and the adds are
        separate ops, so each rounds as the reference does."""
        ai = torch.clamp(a, max=dd)
        bi = torch.clamp(b, max=dd)
        H1 = cnt.shape[1]
        base = (dom * H1 + j) * H1
        fa, fb = base + ai, base + bi
        cntf, csumf = cnt.reshape(-1), csum.reshape(-1)
        pa = w * (ai - cntf[fa])
        pb = w * (bi - cntf[fb])
        return (csumf[fb] + pb) - (csumf[fa] + pa)

    def segment_reach(self, tables, dom, a, b, w, dom_sort=None):
        w = np.asarray(w, dtype=np.float64)
        dom = np.asarray(dom, dtype=np.int64)
        # the integer breakpoint rank stays host-side in every backend
        j = _reach_rank(tables["vals"], dom, w, dom_sort)
        H = tables["cnt"].shape[1] - 1
        self._tick("segment_reach", 2)
        g = self._reach_g(self._t(tables["cnt"]), self._t(tables["csum"]),
                          self._t(dom), self._t(a, np.int64),
                          self._t(b, np.int64), self._t(j), self._t(w), H)
        return self._np(g)

    # -- fused probe pipeline ---------------------------------------------
    def _seg_dev(self, seg):
        return {k: self._t(seg[k]) for k in ("dom", "a", "b")}

    def reach_state(self, r_excess, seg, kept, noise_mult_ub=None):
        state = super().reach_state(r_excess, seg, kept, noise_mult_ub)
        dev = self._seg_dev(state["seg"])
        dev["cnt"] = self._t(state["tables"]["cnt"])
        dev["csum"] = self._t(state["tables"]["csum"])
        state["_dev"] = dev
        return state

    def reach_state_subset(self, state, keep):
        new = super().reach_state_subset(state, keep)
        dev = self._seg_dev(new["seg"])
        # the prefix tables are subset-invariant: keep the resident
        # device buffers, upload only the compacted segment columns
        dev["cnt"], dev["csum"] = state["_dev"]["cnt"], state["_dev"]["csum"]
        new["_dev"] = dev
        return new

    def probe_scores(self, state, dd, excess_col):
        # host: per-window thresholds + integer breakpoint ranks (the
        # reference bits); device: the float middle against the
        # resident tables — only w and j cross per probe
        dev = state["_dev"]
        w, _a, _b, j = self.probe_segment_w(state, dd)
        self._tick("probe_scores", 2)
        g = self._reach_g(dev["cnt"], dev["csum"], dev["dom"], dev["a"],
                          dev["b"], self._t(j), self._t(w), int(dd))
        return self._probe_tail(state, dd, excess_col, self._np(g))

    # -- chunked admission ------------------------------------------------
    @staticmethod
    def _margin_scan(drain, dom_sel, budgets):
        """Per-domain cumulative drains under budget·MARGIN: one masked
        [P, B, W] row scan, batched over the P domains as the
        reference's jit backend does (decision-safe under any add
        order). A domain with a negative budget residue admits no row
        by margin."""
        doms = torch.arange(budgets.shape[0], device=drain.device)
        mask = dom_sel[None, :] == doms[:, None]                    # [P, B]
        cd = torch.cumsum(torch.where(mask[:, :, None], drain[None], 0.0),
                          dim=1)
        okp = (cd <= (budgets * MARGIN)[:, None, :]).all(dim=2)
        okp = okp & (budgets >= 0.0).all(dim=1)[:, None]
        return torch.where(mask, okp, True).all(dim=0)

    def margin_prefix_ok(self, drain, dom_sel, budgets):
        self._tick("margin_prefix_ok")
        return self._np(self._margin_scan(
            self._t(drain), self._t(dom_sel, np.int64), self._t(budgets)))

    def admit_domains(self, spare, budgets, dom_sel, delta, m_min, m_max):
        self._tick("admit_domains")
        bu = self._t(budgets)
        dom = self._t(dom_sel, np.int64)
        delta = self._t(delta)
        m_max = self._t(m_max)
        take = torch.minimum(self._t(spare), bu[dom] / delta[:, None])
        cum = _cumsum_cols(take)
        total = torch.minimum(cum[:, -1], m_max)
        feas = total >= self._t(m_min)
        overshoot = cum - m_max[:, None]
        capped = torch.where(overshoot > 0.0, _nonneg(take - overshoot), take)
        drain = torch.where(feas[:, None], take * delta[:, None], 0.0)
        ok = self._margin_scan(drain, dom, bu)
        return self._np(feas), self._np(ok), self._np(capped)

    # -- misc -------------------------------------------------------------
    def asnumpy(self, x):
        if isinstance(x, torch.Tensor):
            return self._np(x)
        return np.asarray(x)
