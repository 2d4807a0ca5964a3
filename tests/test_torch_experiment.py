"""The port's slice as a whole: ``repro_torch.core.run_experiment`` against
the JAX package's ``repro.core.run_experiment`` on the NumPy backend.

The reference config is carried over with ``config_from_reference`` and
run on ``CudaBackend(device="cpu")`` (its kernels' plain versions run on
the CPU). Round results and summaries must be identical — no tolerance:
every scheduling decision is bit-exact by contract.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import experiment as ref_exp
from repro_torch.backend.cuda_backend import CudaBackend
from repro_torch.core import config_from_reference, run_experiment

from test_experiment_api import GOLDEN_CASES, golden_config
from test_rowid_parity import GOLDEN

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops are many and small: one intra-op thread keeps
    them from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_run(ref_cfg, bk):
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                           backend=bk))
    sims = []
    summary = run_experiment(cfg, sim_out=sims)
    return summary, sims[0]


def _rounds(sim):
    return [(r.start_step, r.duration, r.contributor_idx.tolist(),
             r.energy_used) for r in sim.results]


def test_config_from_reference_carries_every_field():
    cfg = golden_config("fedzero", "none", {"solver": "greedy"})
    port = config_from_reference(dataclasses.asdict(cfg))
    for name in ("scenario", "fleet", "strategy", "trainer", "run",
                 "service"):
        want = dataclasses.asdict(getattr(cfg, name))
        got = dataclasses.asdict(getattr(port, name))
        assert set(want) == set(got), name
        for k, v in want.items():
            np.testing.assert_equal(got[k], v, err_msg=f"{name}.{k}")


def test_run_defaults_to_the_card():
    """A run that names no backend runs on ``cuda:0``, and raises where
    there is none: it never falls back to the host."""
    from repro_torch.core import (ExperimentConfig, FleetSection, RunSection,
                                  ScenarioSection, build_experiment)
    assert RunSection().backend == "cuda"
    cfg = ExperimentConfig(
        scenario=ScenarioSection(name="global", days=1, util_mode="sparse"),
        fleet=FleetSection(n_clients=50), run=RunSection(until_step=30))
    if torch.cuda.is_available():
        sim = build_experiment(cfg)
        assert sim.scenario.backend.device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_experiment(cfg)


def test_sparse_exact_uncapped_fedzero_matches_reference():
    """The 1M gate's configuration (sparse util, exact uncapped greedy
    FedZero) at 5000 clients over half a simulated day."""
    ref_cfg = ref_exp.ExperimentConfig(
        scenario=ref_exp.ScenarioSection(name="global", days=1, seed=0,
                                         util_mode="sparse"),
        fleet=ref_exp.FleetSection(n_clients=5000, seed=0),
        strategy=ref_exp.StrategySection(name="fedzero", n=10, d_max=60,
                                         seed=0,
                                         options={"solver": "greedy"}),
        trainer=ref_exp.TrainerSection(k=0.0004, seed=0),
        run=ref_exp.RunSection(until_step=720, eval_every=5, seed=0,
                               backend="numpy"))
    ref_sims = []
    want = ref_exp.run_experiment(ref_cfg, sim_out=ref_sims)
    bk = CudaBackend(device="cpu")
    got, sim = _port_run(ref_cfg, bk)
    assert want["rounds"] == len(sim.results) > 100
    assert _rounds(sim) == _rounds(ref_sims[0])
    assert got == want
    assert bk.dispatch_counts["synth_window"] > 0
    assert bk.dispatch_counts["forecast_noise_z"] > 0


def _names_summary(sim):
    # goldens predate row-keyed summaries: compare the name-keyed view
    return json.loads(json.dumps(sim.summary(names=True)))


def test_golden_fedzero_greedy_noerr_on_port():
    """The 60-client dense golden (explicit float32 traces, exact
    forecasts), carried across with ``config_from_reference`` and held to
    the committed summary field by field."""
    _, sim = _port_run(golden_config("fedzero", "none", {"solver": "greedy"}),
                       CudaBackend(device="cpu"))
    s = _names_summary(sim)
    golden = GOLDEN["fedzero_greedy_noerr"]
    assert set(s) == set(golden)
    for field in sorted(golden):
        assert s[field] == golden[field], field


@pytest.mark.parametrize("key,strategy,error,kw", GOLDEN_CASES)
def test_golden_configs_match_reference_run(key, strategy, error, kw):
    """Every golden configuration on the port equals the reference's own
    run of it on this host (the realistic-error cases draw forecast noise
    through the port's ``forecast_noise_z``)."""
    cfg = golden_config(strategy, error, kw)
    ref_sims = []
    ref_exp.run_experiment(cfg, sim_out=ref_sims)
    _, sim = _port_run(cfg, CudaBackend(device="cpu"))
    assert _rounds(sim) == _rounds(ref_sims[0])
    assert _names_summary(sim) == _names_summary(ref_sims[0])


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                               'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "for m in ('repro_torch.backend.cuda_backend',\n"
        "          'repro_torch.models.moe', 'repro_torch.kernels.moe_gemm',\n"
        "          'repro_torch.service.engine',\n"
        "          'repro_torch.service.executors',\n"
        "          'repro_torch.optim.optimizers',\n"
        "          'repro_torch.data.federated',\n"
        "          'repro_torch.models.paper_models',\n"
        "          'repro_torch.checkpoint.checkpoint',\n"
        "          'repro_torch.sharding.specs', 'repro_torch.tree',\n"
        "          'repro_torch.launch.mesh', 'repro_torch.launch.steps',\n"
        "          'repro_torch.launch.train', 'repro_torch.launch.dryrun',\n"
        "          'repro_torch.configs.llava_next_34b',\n"
        "          'repro_torch.configs.seamless_m4t_large_v2',\n"
        "          'repro_torch.launch.inference_demo',\n"
        "          'repro_torch.launch.serve',\n"
        "          'repro_torch.kernels._shards'):\n"
        "    assert m in sys.modules, m\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
