"""The port's always-on scheduling service (``repro_torch.service``) against
the JAX package's ``repro.service``.

One config is built in the reference and carried over with
``config_from_reference``; the reference runs it on its NumPy backend,
the port on ``CudaBackend(device="cpu")`` (its K1/K2 kernels' plain
versions), both driven by the same ``run_synthetic`` arguments. Every
comparison is exact (tolerance 0): admissions decision by decision, the
event log field by field, every executed round, the metrics counters and
the final fleet state.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.experimental

# this jax names the x64 context manager jax.enable_x64; the reference's
# jax and pallas backends import it from jax.experimental (set before any
# of them is imported, as tests/test_torch_counter_hash.py does)
jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

import repro.service.executors as ref_executors
import repro_torch.service.executors as port_executors
from repro import core as ref_core
from repro.backend import get_backend as ref_get_backend
from repro.service import build_service as ref_build
from repro.service import run_synthetic as ref_run
from repro_torch.backend.cuda_backend import CudaBackend
from repro_torch.core import ExperimentConfig, config_from_reference
from repro_torch.service import build_service as port_build
from repro_torch.service import run_synthetic as port_run

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the counters of ServiceMetrics.snapshot() that no clock reads
COUNTERS = ("admitted", "rejected", "engine_builds", "engine_reuses",
            "engine_memo_hits", "engine_deactivations",
            "engine_compactions")
WORKER_FAULTS = ("worker_crashes", "worker_restarts", "shard_retries")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops are many and small: one intra-op thread keeps
    them from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_config(n_clients=400, util_mode="sparse", solver="greedy", n=8,
               d_max=30, seed=0, backend="numpy", **service_kw):
    """A reference-package service config (the reference tests' own)."""
    return ref_core.ExperimentConfig(
        scenario=ref_core.ScenarioSection(days=1, seed=seed,
                                          util_mode=util_mode),
        fleet=ref_core.FleetSection(n_clients=n_clients, seed=seed),
        strategy=ref_core.StrategySection(n=n, d_max=d_max, seed=seed,
                                          options={"solver": solver}),
        run=ref_core.RunSection(backend=backend),
        service=ref_core.ServiceSection(seed=seed, **service_kw))


def port_config(ref_cfg, backend=None) -> ExperimentConfig:
    """``ref_cfg`` carried over, on ``backend`` (default: the cuda
    backend on the CPU)."""
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    bk = CudaBackend(device="cpu") if backend is None else backend
    return dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                            backend=bk))


def drive(build, run, cfg, steps=12, churn=0.02, admits_per_step=3,
          quotes_per_step=0, seed=0, **overrides):
    svc = build(cfg, **overrides)
    try:
        run(svc, steps=steps, churn=churn, admits_per_step=admits_per_step,
            quotes_per_step=quotes_per_step, seed=seed)
    finally:
        svc.close()
    return svc


def drive_both(ref_cfg, port_backend=None, **kw):
    """(reference service, port service) after the same drive."""
    return (drive(ref_build, ref_run, ref_cfg, **kw),
            drive(port_build, port_run, port_config(ref_cfg, port_backend),
                  **kw))


@pytest.fixture
def rounds(monkeypatch):
    """Every round the in-process executors run, per package, as
    ``(start_step, duration, contributor_idx, energy_used)``."""
    out = {"ref": [], "port": []}
    for key, mod in (("ref", ref_executors), ("port", port_executors)):
        def rec(*a, _orig=mod.execute_round, _key=key, **k):
            rr = _orig(*a, **k)
            out[_key].append((rr.start_step, rr.duration,
                              rr.contributor_idx.tolist(), rr.energy_used))
            return rr
        monkeypatch.setattr(mod, "execute_round", rec)
    return out


def same_rows(a, b) -> bool:
    """Two admissions (row arrays or selections; None = infeasible)."""
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(getattr(a, "rows", a)),
                          np.asarray(getattr(b, "rows", b)))


def assert_same_history(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert same_rows(x, y), f"admit {i}: {x} != {y}"


def assert_same_log(la, lb):
    assert len(la) == len(lb)
    for i, (ea, eb) in enumerate(zip(la, lb)):
        assert (ea.kind, ea.step, ea.n, ea.d_max, ea.round_id) == \
            (eb.kind, eb.step, eb.n, eb.d_max, eb.round_id), i
        assert (ea.rows is None) == (eb.rows is None), i
        if ea.rows is not None:
            assert np.array_equal(ea.rows, eb.rows), i
        assert (ea.payload is None) == (eb.payload is None), i
        if ea.payload is not None:
            pa, pb = ea.payload, eb.payload
            assert set(pa) == set(pb), i
            for k in ("contributors", "participants"):
                assert np.array_equal(pa[k], pb[k]), (i, k)
            assert pa["duration"] == pb["duration"], i
            assert len(pa["sample_losses"]) == len(pb["sample_losses"]), i
            for x, y in zip(pa["sample_losses"], pb["sample_losses"]):
                assert np.array_equal(x, y), i


def assert_services_identical(a, b):
    """History, log, counters, fleet masks, σ/blocklist and trainer."""
    assert_same_history(a.history, b.history)
    assert_same_log(a.log, b.log)
    sa = a.metrics.snapshot()
    sb = b.metrics.snapshot()
    for k in COUNTERS:
        assert sa[k] == sb[k], k
    # the rest of the counters read no clock either; a worker's death
    # and retry leave no other trace (the kill and crash tests)
    other = [k for k in a.metrics.counters if k not in WORKER_FAULTS]
    assert {k: a.metrics.counters[k] for k in other} == \
        {k: b.metrics.counters[k] for k in other}
    for f in ("active", "busy"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(a.blocklist.blocked, b.blocklist.blocked)
    assert np.array_equal(a.utility.participation_arr,
                          b.utility.participation_arr)
    assert np.array_equal(a.utility.sigmas(), b.utility.sigmas())
    if a.trainer is not None:
        assert a.trainer.progress == b.trainer.progress
        assert np.array_equal(a.trainer.counts, b.trainer.counts)


# the reference's replay cases (tests/test_service.py:71; the MIP one at
# its 120 clients: at 400 the reference's own MIP run takes minutes), and
# sparse/greedy at 10,000
LIVE_CASES = [(400, "sparse", "greedy", 12), (400, "dense", "greedy", 12),
              (120, "dense", "mip", 12), (10_000, "sparse", "greedy", 6)]


# ---------------------------------------------------------------------------
# live parity


@pytest.mark.parametrize("n_clients,util_mode,solver,steps", LIVE_CASES)
def test_live_service_matches_reference(n_clients, util_mode, solver, steps,
                                        rounds):
    ref, port = drive_both(ref_config(n_clients, util_mode, solver),
                           steps=steps, quotes_per_step=2)
    assert ref.metrics.counters["admitted"] > 0
    assert ref.metrics.counters["quote_requests"] == 2 * steps
    assert rounds["ref"] and rounds["port"] == rounds["ref"]
    assert_services_identical(ref, port)


# ---------------------------------------------------------------------------
# replay: across the packages, and incremental against from scratch


@pytest.mark.parametrize("n_clients,util_mode,solver,steps",
                         [c[:3] + (min(c[3], 8),) for c in LIVE_CASES[:3]])
def test_cross_replay(n_clients, util_mode, solver, steps):
    """The port replays the reference's log and the reference the
    port's, each with ``executor="none"``, to the same admissions."""
    rc = ref_config(n_clients, util_mode, solver)
    ref, port = drive_both(rc, steps=steps)
    ref_twin = ref_build(rc, scenario=ref.scenario, registry=ref.registry,
                         executor="none")
    port_twin = port_build(port_config(rc), executor="none")
    assert_same_history(ref.history, port_twin.replay(ref.log))
    assert_same_history(port.history, ref_twin.replay(port.log))
    assert_services_identical(ref_twin, port_twin)


@pytest.mark.parametrize("n_clients,util_mode",
                         [(400, "sparse"), (400, "dense"), (10_000, "sparse")])
def test_churn_parity_incremental_vs_scratch(n_clients, util_mode):
    rc = ref_config(n_clients, util_mode)
    steps = 10 if n_clients >= 10_000 else 25
    ref, port = drive_both(rc, steps=steps)
    assert port.metrics.counters["engine_reuses"] > 0 \
        or util_mode == "dense"
    scratch = port_build(port_config(rc), scenario=port.scenario,
                         registry=port.registry, executor="none",
                         incremental=False)
    assert_same_history(port.history, scratch.replay(port.log))
    assert scratch.metrics.counters["engine_reuses"] == 0
    assert_same_history(ref.history, port.history)


def test_compaction_parity_and_backend_identity(monkeypatch):
    """``compact_frac=0`` compacts after every exclusion burst through
    the backend's ``reach_state_subset``: the port stays identical to
    the reference, and each compacted engine runs on the service's own
    backend object."""
    from repro_torch.service.admission import AdmissionCache
    engines = []

    def compact(cache, _orig=AdmissionCache._compact):
        _orig(cache)
        engines.append((cache._engine, cache.backend))
    monkeypatch.setattr(AdmissionCache, "_compact", compact)
    rc = ref_config(compact_frac=0.0)
    ref, port = drive_both(rc, steps=25)
    assert port.metrics.counters["engine_compactions"] == len(engines) > 0
    assert_services_identical(ref, port)
    for eng, bk in engines:
        assert bk is port.backend and isinstance(bk, CudaBackend)
        assert eng.inp.backend is bk and eng.bk is bk


def test_quote_matches_admit_and_leaves_no_trace():
    rc = ref_config()
    ref = ref_build(rc)
    svc = port_build(port_config(rc))
    committed = 0
    for _ in range(20):
        pre_log, pre_hist = len(svc.log), len(svc.history)
        pre_busy = svc.busy.copy()
        q1, q2 = svc.quote(), svc.quote()
        assert same_rows(q1, ref.quote()) and same_rows(q2, ref.quote())
        assert len(svc.log) == pre_log and len(svc.history) == pre_hist
        assert np.array_equal(svc.busy, pre_busy)
        out, ref_out = svc.admit(), ref.admit()
        assert same_rows(q1, q2)
        assert same_rows(q1, None if out is None else out[1])
        assert same_rows(None if out is None else out[1],
                         None if ref_out is None else ref_out[1])
        committed += out is not None
        svc.advance(1)
        ref.advance(1)
    assert committed > 0
    assert svc.metrics.counters["quote_requests"] == 40
    assert svc.metrics.counters["engine_memo_hits"] > 0
    assert_services_identical(ref, svc)


# ---------------------------------------------------------------------------
# the reference on its Pallas backend (interpret mode on the CPU)


def test_matches_reference_on_pallas_backend(monkeypatch, rounds):
    from repro.kernels import ops
    calls = {"forecast_z": 0}

    def counted(*a, _orig=ops.forecast_z, **k):
        calls["forecast_z"] += 1
        return _orig(*a, **k)
    monkeypatch.setattr(ops, "forecast_z", counted)
    rc = ref_config(backend="pallas")
    ref, port = drive_both(rc, steps=6)
    assert calls["forecast_z"] > 0          # the Pallas K2 ran
    assert ref.metrics.counters["admitted"] > 0
    assert rounds["port"] == rounds["ref"]
    assert_services_identical(ref, port)


# ---------------------------------------------------------------------------
# reach_state_subset: the cases of tests/test_service.py


def _reach_case(K, rng):
    P, H = 3, 24
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
    r_excess = rng.random((P, H)) * 100
    nu = 1.0 + 0.1 * rng.random(H)
    keep = rng.random(K) > 0.4
    segkeep = keep[owner]
    fresh_seg = {k: (np.cumsum(keep)[owner[segkeep]] - 1 if k == "owner"
                     else v[segkeep]) for k, v in seg.items()}
    fresh_kept = {k: v[keep] for k, v in kept.items()}
    return H, seg, kept, r_excess, nu, keep, fresh_seg, fresh_kept


@pytest.mark.parametrize("K", [64, 5000])
def test_reach_state_subset_matches_fresh_build_and_reference(K):
    H, seg, kept, r_excess, nu, keep, fresh_seg, fresh_kept = \
        _reach_case(K, np.random.default_rng(7))
    bk = CudaBackend(device="cpu")
    ref = ref_get_backend("numpy")
    sub = bk.reach_state_subset(
        bk.reach_state(r_excess, seg=seg, kept=kept, noise_mult_ub=nu), keep)
    fresh = bk.reach_state(r_excess, seg=fresh_seg, kept=fresh_kept,
                           noise_mult_ub=nu)
    ref_sub = ref.reach_state_subset(
        ref.reach_state(r_excess, seg=seg, kept=kept, noise_mult_ub=nu), keep)
    for dd in (1, H // 2, H):
        ex = r_excess[:, dd - 1]
        got, n_got = bk.probe_scores(sub, dd, ex)
        want, n_want = bk.probe_scores(fresh, dd, ex)
        ref_got, n_ref = ref.probe_scores(ref_sub, dd, ex)
        assert n_got == n_want == n_ref
        assert np.array_equal(np.asarray(got), np.asarray(want))
        assert np.array_equal(np.asarray(got), np.asarray(ref_got))


# ---------------------------------------------------------------------------
# the device default, in the API and on the command line


def test_build_service_default_backend_is_the_card():
    cfg = config_from_reference(dataclasses.asdict(ref_config(n_clients=60)))
    cfg = dataclasses.replace(cfg, run=ExperimentConfig().run)
    assert cfg.run.backend == "cuda"
    if torch.cuda.is_available():
        svc = port_build(cfg)
        assert svc.backend.device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_build(cfg)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.service", "--clients", "400",
         "--steps", "5", "--json", *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_cli_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("checks the CLI on a host without CUDA")
    out = _cli()
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr and "--device cpu" in out.stderr
    assert out.stdout == ""


def test_cli_on_cpu_matches_reference_cli(capsys):
    from repro.service.__main__ import main as ref_main
    from repro_torch.service.__main__ import main as port_main
    args = ["--clients", "400", "--steps", "5", "--json"]
    got = port_main(args + ["--device", "cpu"])
    snap = json.loads(capsys.readouterr().out)
    want = ref_main(args + ["--backend", "numpy"])
    capsys.readouterr()
    assert snap["replay_ok"] is True and want["replay_ok"] is True
    assert snap["admitted"] > 0
    for k in ("admitted", "rejected", "admit_requests", "engine_builds",
              "engine_reuses", "reports"):
        assert snap[k] == got[k] == want[k], k


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_10k_service_on_cuda_matches_numpy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.backend import get_backend
    from repro_torch.kernels import counter_hash as ch
    bk = get_backend("cuda")
    ch.piece_window.launches = ch.forecast_z.launches = 0
    ref, port = drive_both(ref_config(n_clients=10_000), port_backend=bk,
                           steps=10, quotes_per_step=2)
    assert ch.piece_window.launches > 0 and ch.forecast_z.launches > 0
    assert ref.metrics.counters["admitted"] > 0
    assert_services_identical(ref, port)
