"""Port backends vs the reference NumPy backend, op by op, bit for bit.

Every op ``TorchBackend`` overrides (and ``CudaBackend`` inherits or
routes to its kernels) runs here on ``device="cpu"`` against the JAX
package's ``get_backend("numpy")`` — the ground truth of the scheduling
contract — with ``assert_array_equal``. The layers mirror the reference's
own backend-parity tests: hash primitives, fused grids, sparse-util
synthesis, take/greedy ops, ``score_ub`` + ``top_m``, margin decisions,
reach tables and probes, ``admit_domains``, and whole greedy admissions.
"""
import numpy as np
import pytest
import torch

from repro.backend import get_backend
from repro.core import make_paper_registry as ref_registry
from repro.core.selection import LazySelectionInputs as RefLazy
from repro.core.selection import SelectionInputs as RefInputs
from repro.core.selection import select_clients as ref_select
from repro.data.traces import _SparseUtil as RefSparseUtil
from repro_torch.backend import available_backends
from repro_torch.backend import get_backend as port_get_backend
from repro_torch.backend.cuda_backend import CudaBackend
from repro_torch.backend.torch_backend import TorchBackend
from repro_torch.core import make_paper_registry
from repro_torch.core.selection import (LazySelectionInputs, SelectionInputs,
                                        select_clients)
from repro_torch.data.traces import _SparseUtil

NP = get_backend("numpy")
BACKENDS = {"torch": TorchBackend(device="cpu"),
            "cuda": CudaBackend(device="cpu")}
SIZES = [(7, 13), (300, 40), (5000, 64)]


@pytest.fixture(params=sorted(BACKENDS))
def bk(request):
    return BACKENDS[request.param]


def test_registry_names_and_device_default():
    assert available_backends() == ("cuda", "numpy", "torch")
    assert port_get_backend("numpy").name == "numpy"
    cpu = CudaBackend(device="cpu")
    assert port_get_backend(cpu) is cpu          # instance passthrough
    with pytest.raises(KeyError):
        port_get_backend("jax")
    # no name given means the card; "torch" names the same backend
    for name in (None, "torch", "cuda"):
        if torch.cuda.is_available():
            got = port_get_backend(name)
            assert got.device == torch.device("cuda:0")
            assert got is port_get_backend("cuda")  # one singleton
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port_get_backend(name)


# ---------------------------------------------------------------------------
# 1. primitives


@pytest.mark.parametrize("n", [1, 17, 4096, 70000])
def test_hash_primitives_bit_identical(n, bk, rng):
    x = rng.integers(0, 2 ** 63, n, dtype=np.int64).astype(np.uint64)
    x[0] = np.uint64(2 ** 64 - 1)                # top bit set
    np.testing.assert_array_equal(NP.sm64(x), bk.sm64(x))
    np.testing.assert_array_equal(NP.u01(x), bk.u01(x))
    fold = np.uint64(0x9E3779B97F4A7C15)
    a, b = NP.cheap_u01(fold, x), bk.cheap_u01(fold, x)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_hash64_chain_bit_identical(bk, rng):
    rows = rng.integers(0, 10 ** 9, (257, 3)).astype(np.uint64)
    seg = rng.integers(0, 10 ** 6, (257, 3)).astype(np.uint64)
    got = bk.hash64(42, 201, rows, seg)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(NP.hash64(42, 201, rows, seg), got)
    # broadcast keys, and the scalar chain (no keys) stays host-exact
    np.testing.assert_array_equal(NP.hash64(3, 203, rows[:, :1], seg[0]),
                                  bk.hash64(3, 203, rows[:, :1], seg[0]))
    assert NP.hash64(7, 203) == bk.hash64(7, 203)


@pytest.mark.parametrize("R,W", SIZES)
def test_fused_grids_bit_identical(R, W, bk, rng):
    fold = np.uint64(rng.integers(0, 2 ** 62))
    rows = np.sort(rng.choice(10 ** 6, R, replace=False)).astype(np.int64)
    t_grid = (10_000 + np.arange(W)).astype(np.int64)
    np.testing.assert_array_equal(NP.cell_noise(fold, rows, t_grid),
                                  bk.cell_noise(fold, rows, t_grid))
    levels = rng.random((R, 5), dtype=np.float32)
    slot = rng.integers(0, 5, (R, W)).astype(np.int64)
    np.testing.assert_array_equal(
        NP.piece_grid(levels.copy(), slot, fold, rows, 10_000, 0.1732),
        bk.piece_grid(levels.copy(), slot, fold, rows, 10_000, 0.1732))
    std = (0.05 + 0.2 * np.minimum(np.arange(1, W + 1) / 1440.0, 1.0)
           ).astype(np.float32)
    a = NP.forecast_noise_z(fold, rows, 777, W, std)
    b = bk.forecast_noise_z(fold, rows, 777, W, std)
    np.testing.assert_array_equal(a, b)
    assert b.flags.writeable  # callers apply np.exp in place


def test_synthesis_ops_tick_once_per_window(bk, rng):
    bk.reset_dispatch_counts()
    levels = rng.random((40, 3), dtype=np.float32)
    slot = rng.integers(0, 3, (40, 60)).astype(np.int64)
    rows = np.arange(40)
    bk.synth_window(levels, slot, np.uint64(9), rows, 0, 0.17)
    bk.forecast_noise_z(np.uint64(9), rows, 5, 60, np.float32(0.1))
    assert bk.dispatch_counts == {"synth_window": 1, "forecast_noise_z": 1}
    bk.reset_dispatch_counts()


# ---------------------------------------------------------------------------
# 2. sparse-util synthesis through the port's store


@pytest.mark.parametrize("n_clients", [64, 20000])
def test_sparse_window_parity(n_clients, bk, rng):
    a = RefSparseUtil(11, n_clients, 2880, backend="numpy")
    b = _SparseUtil(11, n_clients, 2880, backend=bk)
    rows = np.sort(rng.choice(n_clients, min(n_clients, 4000),
                              replace=False))
    np.testing.assert_array_equal(a.window(rows, 100, 460),
                                  b.window(rows, 100, 460))
    # full-fleet gather and a chunk-boundary-crossing window
    np.testing.assert_array_equal(a.window(None, 1400, 1500),
                                  b.window(None, 1400, 1500))


def test_sparse_forecast_noise_parity(bk, rng):
    a = RefSparseUtil(5, 30000, 1440, backend="numpy")
    b = _SparseUtil(5, 30000, 1440, backend=bk)
    rows = np.sort(rng.choice(30000, 6000, replace=False))
    std = (0.05 + 0.2 * np.minimum(np.arange(1, 61) / 1440.0, 1.0)
           ).astype(np.float32)
    np.testing.assert_array_equal(a.forecast_noise(rows, 33, 60, std),
                                  b.forecast_noise(rows, 33, 60, std))


# ---------------------------------------------------------------------------
# 3. solver ops + admission decisions


def test_solver_elementwise_ops_bit_identical(bk, rng):
    B, d, P = 6000, 48, 10
    spare = (rng.random((B, d)) * 5).astype(np.float64)
    budgets = rng.random((P, d)) * 300
    dom = rng.integers(0, P, B)
    delta = 0.5 + rng.random(B) * 3
    np.testing.assert_array_equal(
        NP.take_matrix(spare, budgets[dom], delta),
        bk.take_matrix(spare, budgets[dom], delta))
    # the cumulative reach must carry np.cumsum's left-to-right bits
    np.testing.assert_array_equal(
        NP.take_reach(spare, budgets[dom], delta),
        bk.take_reach(spare, budgets[dom], delta))
    # float32 spares promote exactly as numpy promotes them
    np.testing.assert_array_equal(
        NP.take_reach(spare.astype(np.float32), budgets[dom], delta),
        bk.take_reach(spare.astype(np.float32), budgets[dom], delta))

    sigma = rng.random(B)
    reach = rng.random(B) * 100
    m_min, m_max = rng.random(B) * 20, 20 + rng.random(B) * 80
    sa, fa = NP.greedy_scores(sigma, reach, m_min, m_max)
    sb, fb = bk.greedy_scores(sigma, reach, m_min, m_max)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(fa, fb)


def test_score_ub_top_m_parity(bk, rng):
    K, P, M = 9000, 10, 256
    cols = dict(delta=0.5 + rng.random(K) * 3,
                m_min=rng.random(K) * 12,
                m_max=30 + rng.random(K) * 50,
                sigma=rng.random(K),
                spare_ub=rng.random(K) * 4,
                dom=rng.integers(0, P, K))
    excess = rng.random(P) * 400
    excess[0] = 0.0  # a dead domain: its candidates must score -inf
    for dd in (1.0, 17.0, 60.0):
        ub_a, nva = NP.score_ub(NP.fleet_cols(**cols), excess, dd)
        hb, nvb = bk.score_ub(bk.fleet_cols(**cols), excess, dd)
        ub_b = bk.asnumpy(hb)
        assert ub_b.shape == (K,)                # exact length, no pads
        np.testing.assert_array_equal(ub_a, ub_b)
        assert nva == nvb
        np.testing.assert_array_equal(NP.viable_positions(ub_a),
                                      bk.viable_positions(hb))
        ia, ba = NP.top_m(ub_a, M)
        ib, bb = bk.top_m(hb, M)
        # deterministic tie rule → identical SETS (the admission walk
        # re-sorts by score, so the return order is backend-local)
        assert len(ia) == len(ib) == M
        np.testing.assert_array_equal(np.sort(ia), np.sort(ib))
        assert ba == bb


@pytest.mark.parametrize("M", [1, 5, 40])
def test_top_m_forced_ties_take_largest_positions(M, bk, rng):
    """Ties straddling position M: the contract keeps the largest
    positions among the tied values, and the bound is the (M+1)-th
    value exactly."""
    K = 200
    ub = np.where(rng.random(K) < 0.5, 3.5, 1.25)
    ub[rng.integers(0, K, 10)] = -np.inf
    ub[[3, 50, 120]] = 9.0
    ia, ba = NP.top_m(ub, M)
    ib, bb = bk.top_m(bk.adopt_scores(ub), M)
    np.testing.assert_array_equal(np.sort(ia), np.sort(ib))
    assert ba == bb


def test_top_m_parity_degenerate_all_ties(bk, rng):
    """A wall-to-wall tie plateau: both backends select the same M
    positions (the LARGEST, per the position-descending tie rule) and
    report the identical remainder bound."""
    K, M = 20000, 512
    ub = np.full(K, 36.75)                  # dyadic: no rounding slack
    ub[rng.integers(0, K, 64)] = -np.inf    # a few non-viable holes
    ia, ba = NP.top_m(NP.adopt_scores(ub), M)
    ib, bb = bk.top_m(bk.adopt_scores(ub), M)
    assert ba == bb == 36.75                # bound == plateau value
    np.testing.assert_array_equal(np.sort(ia), np.sort(ib))
    finite = np.nonzero(np.isfinite(ub))[0]
    np.testing.assert_array_equal(np.sort(ib), finite[-M:])


def test_adopt_scores_roundtrip_parity(bk, rng):
    K, M = 6000, 128
    ub = np.where(rng.random(K) < 0.1, -np.inf, rng.random(K) * 50)
    ha, hb = NP.adopt_scores(ub), bk.adopt_scores(ub)
    assert isinstance(hb, torch.Tensor) and hb.shape == (K,)
    np.testing.assert_array_equal(NP.asnumpy(ha), bk.asnumpy(hb))
    np.testing.assert_array_equal(NP.viable_positions(ha),
                                  bk.viable_positions(hb))
    ia, ba = NP.top_m(ha, M)
    ib, bb = bk.top_m(hb, M)
    assert ba == bb
    np.testing.assert_array_equal(np.sort(ia), np.sort(ib))


def test_margin_prefix_decisions_agree(bk, rng):
    B, d, P = 5000, 32, 8
    drain = (rng.random((B, d)) * 2).astype(np.float64)
    dom_sel = np.sort(rng.integers(0, P, B))
    budgets = rng.random((P, d)) * drain.sum(0).mean() * 0.1
    np.testing.assert_array_equal(
        NP.margin_prefix_ok(drain, dom_sel, budgets),
        bk.margin_prefix_ok(drain, dom_sel, budgets))
    # a ±ulp-negative budget residue degrades that domain to all-False
    budgets[3, 5] = -1e-12
    np.testing.assert_array_equal(
        NP.margin_prefix_ok(drain, dom_sel, budgets),
        bk.margin_prefix_ok(drain, dom_sel, budgets))


@pytest.mark.parametrize("B,d", [(1, 1), (64, 7), (3000, 60)])
def test_admit_domains_bit_identical(B, d, bk, rng):
    P = 6
    spare = rng.random((B, d)) * 4
    budgets = rng.random((P, d)) * 40
    budgets[2, 3 % d] = -1e-13              # residue: domain 2 margin-fails
    dom_sel = rng.integers(0, P, B)
    delta = 0.5 + rng.random(B)
    m_min = rng.random(B) * 30
    m_max = m_min + rng.random(B) * 60
    fa, oa, ca = NP.admit_domains(spare, budgets, dom_sel, delta, m_min,
                                  m_max)
    fb, ob, cb = bk.admit_domains(spare, budgets, dom_sel, delta, m_min,
                                  m_max)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(oa[fa], ob[fa])   # ok only where feasible
    np.testing.assert_array_equal(ca, cb)


def test_reach_tables_and_segment_reach_bit_identical(bk, rng):
    """Including zero rows, duplicated breakpoints and w at breakpoints."""
    P, H, N = 8, 60, 9000
    excess = (rng.integers(0, 64, size=(P, H)) / 8.0)
    excess[2] = 0.0                        # dead domain
    excess[3, :10] = excess[3, 10]         # duplicated breakpoints
    ta, tb = NP.reach_tables(excess), bk.reach_tables(excess)
    for k in ("vals", "cnt", "csum"):
        np.testing.assert_array_equal(ta[k], tb[k])
    dom = rng.integers(0, P, N)
    a = rng.integers(0, H + 1, N).astype(np.int64)
    b = np.minimum(a + rng.integers(0, H + 1, N), H).astype(np.int64)
    w = rng.integers(0, 80, N) / 8.0
    w[:P * 4] = excess[dom[:P * 4], rng.integers(0, H, P * 4)]  # on-breakpoint
    w[N - 16:] = 0.0
    np.testing.assert_array_equal(NP.segment_reach(ta, dom, a, b, w),
                                  bk.segment_reach(tb, dom, a, b, w))
    np.testing.assert_array_equal(
        NP.segment_reach(ta, dom[:100], a[:100], b[:100], w[:100]),
        bk.segment_reach(tb, dom[:100], a[:100], b[:100], w[:100]))


def _reach_inputs(rng, K, P=3, H=24):
    lens = rng.integers(1, 4, size=K)
    owner = np.repeat(np.arange(K), lens)
    S = owner.size
    a = rng.integers(0, H, size=S)
    b = np.minimum(a + rng.integers(1, H, size=S), H)
    kept_dom = rng.integers(0, P, size=K)
    seg = {"a": a, "b": b, "x": rng.random(S), "owner": owner,
           "dom": kept_dom[owner], "capd": 1.0 + rng.random(S)}
    kept = {"delta": 1.0 + rng.random(K), "m_min": 1.0 + rng.random(K),
            "m_max": 5.0 + rng.random(K), "sigma": rng.random(K) + 0.1,
            "dom": kept_dom}
    return rng.random((P, H)) * 100, seg, kept, 1.0 + 0.1 * rng.random(H)


@pytest.mark.parametrize("K", [64, 5000])
def test_reach_state_probe_and_subset_bit_identical(K, bk):
    """probe_scores against the device-resident reach state, and against
    its incremental subset, equal the reference's probes."""
    rng = np.random.default_rng(7)
    r_excess, seg, kept, nu = _reach_inputs(rng, K)
    H = r_excess.shape[1]
    sa = NP.reach_state(r_excess, seg=seg, kept=kept, noise_mult_ub=nu)
    sb = bk.reach_state(r_excess, seg=seg, kept=kept, noise_mult_ub=nu)
    keep = rng.random(K) > 0.4
    suba, subb = NP.reach_state_subset(sa, keep), bk.reach_state_subset(sb,
                                                                        keep)
    for dd in (1, H // 2, H):
        for (st_a, st_b) in ((sa, sb), (suba, subb)):
            ua, na = NP.probe_scores(st_a, dd, r_excess[:, dd - 1])
            ub, nb = bk.probe_scores(st_b, dd, r_excess[:, dd - 1])
            assert na == nb
            np.testing.assert_array_equal(ua, ub)


def _random_inputs(mod_inputs, registry_fn, backend, seed, K=3000, P=10,
                   H=60):
    rng = np.random.default_rng(seed)
    reg = registry_fn(n_clients=K, seed=seed)
    return mod_inputs(
        registry=reg,
        m_spare=(rng.random((K, H)) * reg.capacity_arr[:, None]),
        r_excess=rng.random((P, H)) * 500,
        sigma=rng.random(K),
        rows=np.arange(K),
        dom=rng.integers(0, P, K),
        backend=backend)


def _assert_same_selection(sa, sb):
    assert (sa is None) == (sb is None)
    if sa is not None:
        assert sa.expected_duration == sb.expected_duration
        np.testing.assert_array_equal(sa.rows, sb.rows)
        np.testing.assert_array_equal(sa.expected_batches,
                                      sb.expected_batches)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_admission_parity_materialized(seed, bk):
    sa = ref_select(_random_inputs(RefInputs, ref_registry, "numpy", seed),
                    n=20, d_max=60, solver="greedy")
    sb = select_clients(_random_inputs(SelectionInputs, make_paper_registry,
                                       bk, seed),
                        n=20, d_max=60, solver="greedy")
    _assert_same_selection(sa, sb)


def _lazy_inputs(mod_inputs, registry_fn, backend, seed, K=20000, P=10,
                 H=60, cap=0):
    rng = np.random.default_rng(seed)
    reg = registry_fn(n_clients=K, seed=seed)
    spare_frac = rng.random((K, H))
    cap_col = reg.capacity_arr

    def spare_of(pos):
        return spare_frac[pos] * cap_col[pos][:, None]

    return mod_inputs(
        registry=reg, spare_of=spare_of, m_spare_ub=cap_col,
        r_excess=rng.random((P, H)) * 800, sigma=rng.random(K),
        rows=np.arange(K), dom=rng.integers(0, P, K),
        candidate_cap=cap, backend=backend)


@pytest.mark.parametrize("seed,cap", [(0, 0), (1, 0), (2, 2048)])
def test_greedy_admission_parity_lazy(seed, cap, bk):
    sa = ref_select(_lazy_inputs(RefLazy, ref_registry, "numpy", seed,
                                 cap=cap),
                    n=24, d_max=60, solver="greedy")
    sb = select_clients(_lazy_inputs(LazySelectionInputs, make_paper_registry,
                                     bk, seed, cap=cap),
                        n=24, d_max=60, solver="greedy")
    _assert_same_selection(sa, sb)


# ---------------------------------------------------------------------------
# 4. dispatch ledger shape, and exact uncapped selection on a real store


def test_dispatch_ledger_shape(bk, rng):
    """One tick per fused op call, two per reach probe — the ledger the
    reference's jit backend keeps, so the two compare."""
    r_excess, seg, kept, nu = _reach_inputs(rng, 300)
    state = bk.reach_state(r_excess, seg=seg, kept=kept, noise_mult_ub=nu)
    bk.reset_dispatch_counts()
    for dd in (1, 12, 24):
        bk.probe_scores(state, dd, r_excess[:, dd - 1])
    assert bk.dispatch_counts == {"probe_scores": 6}
    bk.reset_dispatch_counts()
    spare = rng.random((50, 24))
    budgets = rng.random((3, 24)) * 10
    dom = rng.integers(0, 3, 50)
    delta = 1 + rng.random(50)
    bk.take_reach(spare, budgets[dom], delta)
    bk.admit_domains(spare, budgets, dom, delta, rng.random(50),
                     2 + rng.random(50))
    assert bk.dispatch_counts == {"take_reach": 1, "admit_domains": 1}
    bk.reset_dispatch_counts()


def _store_inputs(n_clients, seed, now, bk):
    """Reference materialized inputs and the port's lazy overlay inputs
    over the same seeded sparse store (each package builds its own)."""
    from repro.data.traces import make_scenario as ref_scenario
    from repro_torch.data.traces import make_scenario

    d_max = 60
    sides = []
    for scen, reg_fn, backend in ((ref_scenario, ref_registry, "numpy"),
                                  (make_scenario, make_paper_registry, bk)):
        sc = scen("global", n_clients=n_clients, days=1, seed=seed,
                  util_mode="sparse", backend=backend)
        reg = reg_fn(n_clients=n_clients, domain_names=sc.domain_names)
        dom_rows = np.arange(n_clients) % len(sc.domain_names)
        excess_fc = sc.excess_forecast(now, d_max)
        cand = np.nonzero((excess_fc.sum(axis=1) > 0)[dom_rows])[0]
        sides.append((sc, reg, dom_rows, excess_fc, cand))
    sc, reg, dom_rows, excess_fc, cand = sides[0]
    cap = reg.capacity_arr
    mat = RefInputs(registry=reg,
                    m_spare=sc.spare_forecast(now, d_max, rows=cand)
                    * cap[cand][:, None],
                    r_excess=excess_fc, sigma=np.ones(cand.size),
                    rows=cand, dom=dom_rows[cand])
    sc, reg, dom_rows, excess_fc, cand = sides[1]
    cap = reg.capacity_arr

    def spare_of(pos, h=None):
        rows = cand[pos]
        return sc.spare_forecast(now, h or d_max, rows=rows) \
            * cap[rows][:, None]

    ov = sc.spare_ub_overlay(now, d_max, cand)
    lazy = LazySelectionInputs(
        registry=reg, spare_of=spare_of, m_spare_ub=cap[cand].astype(float),
        r_excess=excess_fc, sigma=np.ones(cand.size), rows=cand,
        dom=dom_rows[cand], seg_overlay=ov,
        noise_mult_ub=ov["noise_mult_ub"], backend=bk)
    return mat, lazy


@pytest.mark.parametrize("seed,now,n", [(3, 540, 20), (1, 300, 10)])
def test_uncapped_lazy_on_port_matches_reference_greedy_50k(seed, now, n):
    """The port's exact uncapped lazy walk (reach evaluator on the
    device backend) admits exactly what the reference's materialized
    greedy admits on a 50k-client sparse store."""
    mat, lazy = _store_inputs(50_000, seed, now, BACKENDS["cuda"])
    ref = ref_select(mat, n, 60, solver="greedy")
    got = select_clients(lazy, n, 60, solver="greedy")
    assert ref is not None
    _assert_same_selection(ref, got)
