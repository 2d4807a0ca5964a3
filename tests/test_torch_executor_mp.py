"""The port's multiprocess round executor (``repro_torch.service.executors``)
against its in-process executor and the reference's.

Workers start with ``spawn``; each gets the config with its backend
instance, ``CudaBackend(device="cpu")``, pickled, and rebuilds its
scenario and registry from it. Every comparison is exact (tolerance 0).
Beside parity: a worker killed outright is restarted within the retry
budget; a worker that cannot start, or whose task raises, makes the
parent raise instead of counting a crash; ``fork`` with a CUDA backend
is refused; and a worker loads nothing of JAX or of the reference.
"""
import dataclasses
import os
import pickle
import signal

import numpy as np
import pytest
import torch

from repro.core.experiment import build_registry as ref_build_registry
from repro.core.experiment import build_scenario as ref_build_scenario
from repro.core.simulation import execute_round as ref_execute_round
from repro.core.types import Selection as RefSelection
from repro_torch.backend.cuda_backend import CudaBackend
from repro_torch.core.experiment import build_registry, build_scenario
from repro_torch.core.simulation import (execute_round_shard,
                                         merge_round_shards)
from repro_torch.core.types import Selection
from repro_torch.service import build_service as port_build
from repro_torch.service import run_synthetic as port_run
from repro_torch.service.executors import _WorkerSlot

from test_torch_service import (assert_services_identical, drive,
                                port_config, ref_build, ref_config, ref_run)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def drive_mp(cfg, steps, **kw):
    """Drive a 2-worker multiprocess port service; returns it and each
    worker's start-up report, read before the workers stop."""
    svc = port_build(cfg, executor="multiprocess", workers=2)
    try:
        port_run(svc, steps=steps, churn=0.02, admits_per_step=3, seed=0,
                 **kw)
        infos = [s.info for s in svc.executor._slots]
    finally:
        svc.close()
    return svc, infos


def test_backend_pickles_to_a_working_backend():
    bk = CudaBackend(device="cpu")
    bk.synth_window(np.ones((2, 3), np.float32), np.zeros((2, 4), np.int64),
                    7, np.arange(2), 0, 0.1)
    got = pickle.loads(pickle.dumps(bk))
    assert type(got) is CudaBackend and got.device == bk.device
    assert got.dispatch_counts == bk.dispatch_counts
    assert got.window_shapes == bk.window_shapes
    args = (11, np.arange(5, dtype=np.uint64), 300, 4,
            np.full(4, 0.1, np.float32))
    assert np.array_equal(got.forecast_noise_z(*args),
                          bk.forecast_noise_z(*args))


def test_merge_round_shards_matches_reference_execute_round():
    rc = ref_config(n_clients=400)
    sc, ref_sc = build_scenario(port_config(rc)), ref_build_scenario(rc)
    reg = build_registry(port_config(rc), sc)
    ref_reg = ref_build_registry(rc, ref_sc)
    dom_rows = reg.domain_rows(sc.domain_names)
    rng = np.random.default_rng(0)
    for trial in range(12):
        n = int(rng.integers(3, 14))
        rows = rng.choice(len(reg), size=n, replace=False)
        now = (int(rng.integers(0, sc.n_steps - 5)) if trial % 4
               else int(sc.n_steps - rng.integers(1, 10)))
        d_max = int(rng.integers(5, 40))
        drop = np.where(rng.random(n) < 0.4, rng.integers(0, 10, n),
                        -1).astype(np.int64) if trial % 3 == 1 else None
        speed = (np.where(rng.random(n) < 0.4, 0.25, 1.0)
                 if trial % 3 == 2 else None)
        want = ref_execute_round(
            ref_reg, ref_sc, ref_reg.domain_rows(ref_sc.domain_names),
            RefSelection(rows=rows, expected_duration=d_max,
                         expected_batches=np.zeros(n)),
            now, d_max, round_idx=trial, drop_step=drop, speed=speed)
        dom = dom_rows[rows]
        groups = [np.nonzero(dom == p)[0] for p in dict.fromkeys(dom.tolist())]
        nsh = max(1, min(3, len(groups)))
        shards = [execute_round_shard(
            reg, sc, dom_rows, rows[p], now, d_max,
            drop_step=None if drop is None else drop[p],
            speed=None if speed is None else speed[p])
            for p in (np.concatenate(groups[i::nsh]) for i in range(nsh))]
        got = merge_round_shards(
            Selection(rows=rows, expected_duration=d_max,
                      expected_batches=np.zeros(n)),
            shards, now, d_max, n_steps=sc.n_steps, round_idx=trial)
        assert got.duration == want.duration, trial
        for f in ("contributors", "contributor_idx", "stragglers",
                  "batches"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.energy_used == want.energy_used, trial


@pytest.mark.parametrize("n_clients,steps", [(400, 12), (10_000, 6)])
def test_mp_matches_inprocess_and_reference(n_clients, steps):
    rc = ref_config(n_clients=n_clients)
    ref = drive(ref_build, ref_run, rc, steps=steps)
    inproc = drive(port_build, port_run, port_config(rc), steps=steps)
    mp_svc, infos = drive_mp(port_config(rc), steps)
    assert ref.metrics.counters["admitted"] > 0
    assert mp_svc.metrics.counters["worker_crashes"] == 0
    assert_services_identical(ref, mp_svc)
    assert_services_identical(inproc, mp_svc)
    snap = mp_svc.metrics.snapshot(backend=mp_svc.backend)
    # each worker ran on its pickled backend's device; on the CPU the
    # kernels' plain versions run, which count no launch
    assert snap["worker_devices"] == {0: "cpu", 1: "cpu"}
    assert snap["worker_kernel_launches"] == {
        w: {"piece_window": 0, "forecast_z": 0} for w in (0, 1)}
    for info in infos:
        assert info["device"] == "cpu"
        pk = set(info["packages"])
        assert "repro_torch" in pk and "torch" in pk
        assert not pk & {"jax", "jaxlib", "repro"}, pk & {"jax", "jaxlib",
                                                          "repro"}


def test_mp_survives_worker_kill_mid_run():
    rc = ref_config(n_clients=400)
    # reference: in-process, driven with the same two-half sequence
    # (run_synthetic reseeds per call, so halves are comparable)
    ref = ref_build(rc)
    ref_run(ref, steps=5, churn=0.02, admits_per_step=3, seed=0)
    ref_run(ref, steps=5, churn=0.02, admits_per_step=3, seed=0)
    svc = port_build(port_config(rc), executor="multiprocess", workers=2)
    try:
        port_run(svc, steps=5, churn=0.02, admits_per_step=3, seed=0)
        svc.executor._ensure_slots()
        victim = svc.executor._slots[0]._proc
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(timeout=10)
        port_run(svc, steps=5, churn=0.02, admits_per_step=3, seed=0)
    finally:
        svc.close()
    assert svc.metrics.counters["worker_restarts"] >= 1
    assert svc.metrics.counters["rounds_degraded"] == 0
    assert_services_identical(ref, svc)


def test_worker_that_cannot_start_makes_the_parent_raise():
    """The workers' config names ``"cuda"`` on a host without CUDA: the
    parent raises with the worker's traceback; no crash is counted and
    no round closes degraded."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    rc = ref_config(n_clients=400)
    cpu_cfg = port_config(rc)
    sc = build_scenario(cpu_cfg)
    reg = build_registry(cpu_cfg, sc)
    cfg = port_config(rc, backend="cuda")
    svc = port_build(cfg, scenario=sc, registry=reg,
                     backend=CudaBackend(device="cpu"),
                     executor="multiprocess", workers=2)
    try:
        with pytest.raises(RuntimeError, match="failed to start") as e:
            port_run(svc, steps=12, churn=0.02, admits_per_step=3, seed=0)
        assert "no CUDA device" in str(e.value)
    finally:
        svc.close()
    m = svc.metrics.counters
    assert m["worker_crashes"] == m["worker_restarts"] == 0
    assert m["rounds_degraded"] == m["reports"] == 0
    assert svc.executor._slots is None


def test_worker_whose_task_raises_makes_the_parent_raise():
    cfg = port_config(ref_config(n_clients=60))
    slot = _WorkerSlot(cfg, 0, None, "spawn")
    try:
        slot.wait_ready()
        slot.submit({"round_id": 0, "shard": 0, "attempt": 0,
                     "rows": np.array([10 ** 6]), "now": 0, "d_max": 5,
                     "constrained": True, "drop_step": None,
                     "speed": None})
        with pytest.raises(RuntimeError, match="IndexError"):
            slot.collect()
    finally:
        slot.close()


def test_fork_with_a_cuda_backend_raises():
    rc = ref_config(n_clients=60)
    cpu_cfg = port_config(rc)
    sc = build_scenario(cpu_cfg)
    reg = build_registry(cpu_cfg, sc)
    on_card = CudaBackend(device="cpu")
    on_card.device = torch.device("cuda:0")    # a CUDA device, faked
    for workers_bk, svc_bk in ((on_card, CudaBackend(device="cpu")),
                               ("cuda", CudaBackend(device="cpu")),
                               ("numpy", on_card)):
        cfg = dataclasses.replace(cpu_cfg, run=dataclasses.replace(
            cpu_cfg.run, backend=workers_bk))
        with pytest.raises(ValueError, match="fork"):
            port_build(cfg, scenario=sc, registry=reg, backend=svc_bk,
                       executor="multiprocess", mp_context="fork")
    # without CUDA on either side, fork is the caller's choice
    svc = port_build(cpu_cfg, scenario=sc, registry=reg,
                     executor="multiprocess", mp_context="fork")
    assert svc.executor._ctx_name == "fork"
    svc.close()
