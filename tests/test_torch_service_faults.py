"""The port's deterministic fault injection (``repro_torch.service.faults``)
and its executors' retry and degradation against the reference's.

Every plan draw is a host counter hash and equals the reference's bit for
bit; a config carrying a reference ``FaultPlan`` crosses over as the
port's (``config_from_reference``); faulted runs equal the reference's
and replay; a recovered crash leaves no trace; a degraded round is an
explicit zero-utility report. Tolerance 0 throughout.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.experiment import build_registry as ref_build_registry
from repro.core.experiment import build_scenario as ref_build_scenario
from repro.service import executors as ref_executors
from repro.service.faults import FaultPlan as RefFaultPlan
from repro.service.faults import RetryPolicy as RefRetryPolicy
from repro_torch.core import config_from_reference
from repro_torch.core.experiment import build_registry, build_scenario
from repro_torch.service import build_service as port_build
from repro_torch.service import run_synthetic as port_run
from repro_torch.service.executors import (WorkerDied,
                                           run_sharded_with_retries)
from repro_torch.service.faults import FaultPlan, RetryPolicy

from test_torch_service import (assert_same_history,
                                assert_services_identical, drive, drive_both,
                                port_config, ref_build, ref_config, ref_run)

FAULTY = dict(seed=5, dropout_rate=0.5, straggler_rate=0.3,
              report_delay_rate=0.4, report_delay_steps=2,
              report_loss_rate=0.3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# plan draws and parsing: equal to the reference's


@pytest.mark.parametrize("seed", [0, 3, 64, 2 ** 40 + 17])
def test_fault_plan_draws_equal_reference(seed):
    kw = dict(seed=seed, worker_crash_rate=0.3, report_loss_rate=0.3,
              report_delay_rate=0.3, dropout_rate=0.5, straggler_rate=0.4)
    port, ref = FaultPlan(**kw), RefFaultPlan(**kw)
    grid = [(r, s, k) for r in range(40) for s in range(3) for k in range(3)]
    want = [(ref.worker_crash(*g), ref.report_lost(g[0], g[2]),
             ref.report_delay(g[0])) for g in grid]
    assert [(port.worker_crash(*g), port.report_lost(g[0], g[2]),
             port.report_delay(g[0])) for g in grid] == want
    assert any(w[0] for w in want) and not all(w[0] for w in want)
    # client effects over rows, on each package's own scenario
    rc = ref_config(n_clients=400)
    sc, ref_sc = build_scenario(port_config(rc)), ref_build_scenario(rc)
    dom = build_registry(port_config(rc), sc).domain_rows(sc.domain_names)
    ref_dom = ref_build_registry(rc, ref_sc).domain_rows(ref_sc.domain_names)
    rng = np.random.default_rng(seed % 2 ** 32)
    fired = 0
    for rid, now in enumerate(range(0, sc.n_steps - 30, 97)):
        rows = rng.choice(400, size=12, replace=False)
        drop, speed = port.round_effects(sc, dom, rows, now, 30, rid)
        ref_drop, ref_speed = ref.round_effects(ref_sc, ref_dom, rows, now,
                                                30, rid)
        assert np.array_equal(drop, ref_drop) and drop.dtype == ref_drop.dtype
        assert np.array_equal(speed, ref_speed)
        fired += int((drop >= 0).sum())
    assert fired > 0


@pytest.mark.parametrize("spec", [
    "crash=0.01,dropout=0.05,straggler=0.1,slowdown=0.5,delay=0.2,"
    "delay_steps=4,loss=0.02,seed=7,retries=3,backoff=2,timeout=20",
    "crash=0.005,dropout=0.05,straggler=0.05,delay=0.2,loss=0.05,seed=64",
    ""])
def test_fault_plan_parse_equals_reference(spec):
    port, ref = FaultPlan.parse(spec), RefFaultPlan.parse(spec)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert isinstance(port.retry, RetryPolicy)
    assert port.any_faults == ref.any_faults
    with pytest.raises(ValueError, match="unknown fault spec key"):
        FaultPlan.parse(spec + ",crashes=0.5")


def test_config_from_reference_carries_the_fault_plan():
    plan = RefFaultPlan(crash_schedule=((1, 0, 0), (2, 1, 1)),
                        retry=RefRetryPolicy(max_retries=3, backoff_steps=2,
                                             timeout_steps=9), **FAULTY)
    got = config_from_reference(dataclasses.asdict(
        ref_config(faults=plan))).service.faults
    assert type(got) is FaultPlan and type(got.retry) is RetryPolicy
    assert dataclasses.asdict(got) == dataclasses.asdict(plan)
    assert got.crash_schedule == ((1, 0, 0), (2, 1, 1))
    assert got.worker_crash(2, 1, 1) and not got.worker_crash(2, 1, 0)
    assert config_from_reference(dataclasses.asdict(
        ref_config())).service.faults is None


# ---------------------------------------------------------------------------
# faulted runs: equal to the reference's, deterministic, replayable


def test_same_plan_same_log_and_replay_as_reference():
    rc = ref_config(faults=RefFaultPlan(**FAULTY))
    ref, port = drive_both(rc, steps=15)
    assert isinstance(port.executor.faults, FaultPlan)
    fired = sum(port.metrics.counters[k] for k in
                ("client_dropouts", "stragglers_injected",
                 "reports_delayed", "reports_lost"))
    assert port.metrics.counters["admitted"] > 0 and fired > 0
    assert_services_identical(ref, port)
    again = drive(port_build, port_run, port_config(rc), steps=15)
    assert_services_identical(port, again)
    for increm in (True, False):
        twin = port_build(port_config(rc), scenario=port.scenario,
                          registry=port.registry, executor="none",
                          incremental=increm)
        assert_same_history(port.history, twin.replay(port.log))
        assert np.array_equal(twin.utility.sigmas(), port.utility.sigmas())
        assert np.array_equal(twin.blocklist.blocked, port.blocklist.blocked)


def test_report_loss_past_budget_closes_with_no_information():
    plan = RefFaultPlan(seed=0, report_loss_rate=1.0,
                        retry=RefRetryPolicy(max_retries=2, backoff_steps=1))
    ref, svc = drive_both(ref_config(faults=plan), steps=12, churn=0.0,
                          admits_per_step=1)
    m = svc.metrics.counters
    assert m["admitted"] > 0 and m["rounds_degraded"] > 0
    assert m["reports_lost"] >= 3 * m["rounds_degraded"]
    assert np.all(svc.utility.participation_arr == 0)
    assert not svc.blocklist.blocked.any()
    assert_services_identical(ref, svc)


def test_crash_then_retry_equals_no_crash():
    rc = ref_config(n_clients=400)
    ref = drive(ref_build, ref_run, rc, steps=10)
    # the first attempt of round 1 kills worker 1; the default budget (2
    # retries) recovers it
    plan = FaultPlan(crash_schedule=((1, 1, 0),))
    svc = drive(port_build, port_run, port_config(rc), steps=10,
                executor="multiprocess", workers=2, faults=plan)
    m = svc.metrics.counters
    assert m["worker_crashes"] == m["worker_restarts"] == 1
    assert m["shard_retries"] >= 1 and m["rounds_degraded"] == 0
    assert_services_identical(ref, svc)


def test_degraded_round_matches_explicit_zero_utility_report():
    rc = ref_config(n_clients=400)
    # slot 0 dies on the only attempt (budget 0) of round 0: it closes
    # partial, slot 1's shard surviving
    kw = dict(crash_schedule=((0, 0, 0),))
    svc = port_build(port_config(rc), executor="multiprocess", workers=2,
                     faults=FaultPlan(retry=RetryPolicy(max_retries=0), **kw))
    ref = ref_build(rc, executor="multiprocess", workers=2,
                    faults=RefFaultPlan(retry=RefRetryPolicy(max_retries=0),
                                        **kw))
    try:
        for s, run in ((svc, port_run), (ref, ref_run)):
            run(s, steps=6, churn=0.0, admits_per_step=1, seed=0)
            s.advance(40)       # past every degraded round's full window
    finally:
        svc.close()
        ref.close()
    degraded = dict(svc.executor.degraded_rounds)
    assert sorted(degraded) == [0]
    assert svc.metrics.counters["rounds_degraded"] == 1
    assert svc.metrics.counters["worker_crashes"] == 1
    assert_services_identical(ref, svc)
    all_dead = np.concatenate(list(degraded.values()))
    assert np.all(svc.utility.sigmas()[all_dead] == 0.0)
    assert np.all(svc.utility.participation_arr[all_dead] >= 1)
    # twin: the same log, each degraded round closed by an explicit
    # zero-utility report built here (dead rows with all-zero losses)
    twin = port_build(port_config(rc), scenario=svc.scenario,
                      registry=svc.registry, executor="none")
    for ev in svc.log:
        if ev.kind == "advance":
            twin.advance(ev.n)
        elif ev.kind in ("register", "deregister"):
            getattr(twin, ev.kind)(ev.rows)
        elif ev.kind == "admit":
            twin.admit(ev.n, ev.d_max)
        else:
            p = ev.payload
            contributors, losses = p["contributors"], p["sample_losses"]
            if ev.round_id in degraded:
                dead = np.sort(degraded[ev.round_id])
                surv = contributors[:contributors.size - dead.size]
                contributors = np.concatenate([surv, dead])
                losses = (list(losses[:surv.size])
                          + [np.zeros(1)] * dead.size)
            twin.report_round(ev.round_id, contributors, p["participants"],
                              losses, duration=p["duration"])
    assert np.array_equal(twin.utility.sigmas(), svc.utility.sigmas())
    assert np.array_equal(twin.utility.participation_arr,
                          svc.utility.participation_arr)
    assert np.array_equal(twin.blocklist.blocked, svc.blocklist.blocked)
    assert_same_history(twin.history, svc.history)


# ---------------------------------------------------------------------------
# the retry state machine against the reference's, swept (no processes)


class FakeSlot:
    """An in-memory worker slot: a scheduled ``(shard, attempt)`` crash
    kills it and loses the rest of its queue, like a dead pipe."""

    def __init__(self, crashes, died):
        self.crashes, self.died = crashes, died
        self.queue, self.dead, self.restarts = [], False, 0

    def submit(self, task):
        if not self.dead:
            self.queue.append(dict(task))

    def collect(self):
        if self.dead or not self.queue:
            raise self.died(0)
        t = self.queue.pop(0)
        if (t["shard"], t["attempt"]) in self.crashes:
            self.dead = True
            self.queue.clear()
            raise self.died(0)
        return {"shard": t["shard"], "attempt": t["attempt"]}

    def restart(self):
        self.dead, self.queue = False, []
        self.restarts += 1


def test_retry_machine_equals_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n_slots = int(rng.integers(1, 5))
        n_tasks = int(rng.integers(1, 8))
        crashes = {(int(t), int(a)) for t, a in zip(
            rng.integers(0, n_tasks, 4), rng.integers(0, 3, 4))}
        assignment = [list(range(w, n_tasks, n_slots))
                      for w in range(n_slots)]
        tasks = [{"shard": i} for i in range(n_tasks)]
        budget = int(rng.integers(0, 3))
        out = []
        for fn, died in ((run_sharded_with_retries, WorkerDied),
                         (ref_executors.run_sharded_with_retries,
                          ref_executors.WorkerDied)):
            slots = [FakeSlot(crashes, died) for _ in range(n_slots)]
            calls = []
            res, dead = fn(slots, assignment, tasks, max_retries=budget,
                           on_restart=lambda: calls.append("restart"),
                           on_retry=lambda: calls.append("retry"))
            out.append((res, dead, calls, [s.restarts for s in slots]))
        assert out[0] == out[1]
