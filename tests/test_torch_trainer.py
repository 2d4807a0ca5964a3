"""The port's federated training (``repro_torch.data.federated``,
``repro_torch.core.TorchTrainer``) against the JAX package's, on the CPU,
and the guard that keeps training off the kernels without a backward.

* The three synthetic tasks and the Dirichlet partition equal the
  reference's array for array (``synthetic_chars`` seeds its clients from
  ``hash(name)``, salted per process: both sides run in this process).
* ``TorchTrainer`` against ``JaxTrainer`` on the same weights (carried
  across with ``paper_params_from_reference``) and the same NumPy seed:
  two local updates, ``aggregate``, ``evaluate``. Tolerance
  ``TRAIN_TOL`` = 1e-5 of the largest value for each mean loss, each
  probe's per-sample losses and each aggregated parameter: float32
  rounding differences grow over the local steps to ~1e-6 here. The
  accuracy may differ by one test sample (an argmax near a tie).
* The reference's behaviour tests (tests/test_data_tasks.py,
  tests/test_system.py) on the port, the default device, and the example
  ``examples/train_federated_torch.py`` on the CPU.
* K3, K4 and K5 have no backward: off the CPU, each wrapper raises before
  it builds or launches when autograd would differentiate its output
  (``meta`` tensors here, with ``load_library`` replaced by a failure; a
  ``cuda``-marked twin runs on the card).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import JaxTrainer
from repro.data import federated as RF
from repro.models import paper_models as RP
from repro_torch.backend.cuda_backend import CudaBackend
from repro_torch.configs import get_config
from repro_torch.core import (FLSimulation, TorchTrainer,
                              make_paper_registry, make_strategy)
from repro_torch.data import federated as F
from repro_torch.data.traces import make_scenario
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import moe_gemm as k5
from repro_torch.kernels import rwkv_scan as k4
from repro_torch.models import ConvNet, DecoderLM, KWTModel, LSTMModel
from repro_torch.models.convert import (_flatten,
                                        paper_params_from_reference)

TRAIN_TOL = 1e-5
ROOT = os.path.join(os.path.dirname(__file__), "..")
NAMES = [f"c{i}" for i in range(8)]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Small CPU ops: two intra-op threads keep them from contending with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the data -----------------------------------------------------------------

TASKS = {
    "classification": lambda M: M.synthetic_classification(
        8, NAMES, n_classes=6, n_samples=700, hw=8, seed=3),
    "chars": lambda M: M.synthetic_chars(8, NAMES, vocab=32, seq_len=16,
                                         seed=3, n_test=64),
    "speech": lambda M: M.synthetic_speech(8, NAMES, n_classes=6,
                                           n_samples=500, n_patches=8,
                                           seed=3),
}


@pytest.mark.parametrize("task", sorted(TASKS))
def test_synthetic_tasks_equal_reference(task):
    want, got = TASKS[task](RF), TASKS[task](F)
    assert got.task == want.task
    assert list(got.client_data) == list(want.client_data)
    for name, arrays in want.client_data.items():
        assert list(got.client_data[name]) == list(arrays)
        for k, a in arrays.items():
            b = got.client_data[name][k]
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)
    for k, a in want.test_data.items():
        np.testing.assert_array_equal(got.test_data[k], a)
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    for name in NAMES:
        b = got.sample_batch(name, 7, rng_b)
        for k, a in want.sample_batch(name, 7, rng_a).items():
            np.testing.assert_array_equal(b[k], a)


def test_dirichlet_partition_equals_reference():
    labels = np.random.default_rng(0).integers(0, 10, 3000)
    want = RF.dirichlet_partition(labels, 25, 0.3, np.random.default_rng(1))
    got = F.dirichlet_partition(labels, 25, 0.3, np.random.default_rng(1))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- TorchTrainer against JaxTrainer ------------------------------------------

# name -> (task, reference model, port model, trainer kwargs)
TRAINERS = {
    "convnet": ("classification",
                lambda: RP.ConvNet(n_classes=6, channels=(8, 16), hw=8),
                lambda: ConvNet(n_classes=6, channels=(8, 16), hw=8,
                                device="cpu"), {}),
    "convnet_momentum": ("classification",
                         lambda: RP.ConvNet(n_classes=6, channels=(4,), hw=8),
                         lambda: ConvNet(n_classes=6, channels=(4,), hw=8,
                                         device="cpu"),
                         dict(momentum=0.9, weight_decay=1e-3, prox_mu=0.0)),
    "kwt": ("speech",
            lambda: RP.KWTModel(n_classes=6, d=32, layers=2, heads=2,
                                mlp=64, n_patches=8),
            lambda: KWTModel(n_classes=6, d=32, layers=2, heads=2, mlp=64,
                             n_patches=8, device="cpu"), {}),
    "lstm": ("chars", lambda: RP.LSTMModel(vocab=32, embed=8, hidden=32),
             lambda: LSTMModel(vocab=32, embed=8, hidden=32, device="cpu"),
             {}),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _trainers(name, seed=4, **extra):
    task, make_ref, make_port, kw = TRAINERS[name]
    kw = dict(dict(lr=0.05, prox_mu=0.1, seed=seed, max_steps_per_round=8),
              **kw, **extra)
    jt = JaxTrainer(make_ref(), TASKS[task](RF), **kw)
    tt = TorchTrainer(make_port(), TASKS[task](F), device="cpu", **kw)
    tt.model.load_state_dict(paper_params_from_reference(
        tt.model, jax.tree_util.tree_map(np.asarray, jt.params)))
    return jt, tt


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_matches_jax_trainer(name):
    jt, tt = _trainers(name)
    for rnd in range(2):
        ju = [jt.local_update(row, nb) for row, nb in ((rnd, 8), (5, 3.4))]
        tu = [tt.local_update(row, nb) for row, nb in ((rnd, 8), (5, 3.4))]
        for a, b in zip(ju, tu):
            assert (b["row"], b["weight"]) == (a["row"], a["weight"])
            assert len(b["losses"]) == a["weight"] / 10
            assert abs(b["mean_loss"] - a["mean_loss"]) <= \
                TRAIN_TOL * abs(a["mean_loss"])
            assert np.mean(b["losses"]) == b["mean_loss"]
            assert isinstance(b["sample_losses"], np.ndarray)
            assert b["sample_losses"].shape == a["sample_losses"].shape == (
                40,)
            assert _rel(b["sample_losses"], a["sample_losses"]) <= TRAIN_TOL
        jt.aggregate(ju)
        tt.aggregate(tu)
        want = dict(_flatten(jax.tree_util.tree_map(np.asarray, jt.params)))
        for n, p in tt.params.items():
            assert _rel(p.numpy(), want[n]) <= TRAIN_TOL, (rnd, n)
        take = min(jt.eval_batch, len(next(iter(jt.data.test_data.values()))))
        assert abs(tt.evaluate() - jt.evaluate()) <= 1.0 / take + 1e-7


def test_local_update_leaves_the_global_model():
    _, tt = _trainers("convnet")
    before = {n: p.clone() for n, p in tt.params.items()}
    upd = tt.local_update(0, 5)
    for n, p in tt.params.items():
        assert torch.equal(p, before[n]), n
        assert not p.requires_grad and upd["params"][n].shape == p.shape
    assert any(not torch.equal(upd["params"][n], before[n]) for n in before)


def test_trainer_defaults_to_the_card():
    """A trainer given no device trains on ``cuda:0``, and raises where
    there is none: it never falls back to the host."""
    data = TASKS["classification"](F)
    model = ConvNet(n_classes=6, channels=(4,), hw=8, device="cpu")
    if torch.cuda.is_available():
        tt = TorchTrainer(model, data)
        assert tt.device == torch.device("cuda:0")
        assert next(tt.model.parameters()).device == tt.device
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchTrainer(model, data)


# -- the reference's behaviour tests, on the port -----------------------------


def test_chars_task_shakespeare_like_imbalance():
    fd = F.synthetic_chars(20, [f"c{i}" for i in range(20)], vocab=32,
                           seq_len=16)
    sizes = [fd.n_samples(f"c{i}") for i in range(20)]
    assert max(sizes) > 3 * min(sizes)  # heavy imbalance, like Shakespeare
    d = fd.client_data["c0"]
    # labels are next-token shifted inputs
    np.testing.assert_array_equal(d["tokens"][:, 1:], d["labels"][:, :-1])


def test_speech_task_structure():
    fd = F.synthetic_speech(8, NAMES, n_classes=6, n_samples=500,
                            n_patches=8)
    assert fd.client_data["c0"]["mfcc"].shape[1:] == (8, 40)


def test_trainer_aggregate_is_weighted_mean():
    fd = F.synthetic_classification(8, NAMES, n_classes=4, n_samples=400,
                                    hw=8)
    model = ConvNet(n_classes=4, channels=(4,), hw=8, device="cpu")
    tr = TorchTrainer(model, fd, lr=0.0, device="cpu")  # local == global
    p0 = {n: p.clone() for n, p in tr.params.items()}
    u1 = tr.local_update(0, 3)   # row 0 -> "c0"
    u2 = tr.local_update(1, 3)
    tr.aggregate([u1, u2])
    # with lr=0, aggregated params must equal the originals exactly
    for n, p in tr.params.items():
        np.testing.assert_allclose(p.numpy(), p0[n].numpy(), atol=1e-6)


def test_trainer_learns_locally():
    fd = F.synthetic_classification(8, NAMES, n_classes=4, n_samples=800,
                                    hw=8)
    model = ConvNet(n_classes=4, channels=(8,), hw=8, device="cpu")
    tr = TorchTrainer(model, fd, lr=0.1, prox_mu=0.0, max_steps_per_round=40,
                      device="cpu")
    acc0 = tr.evaluate()
    for _ in range(4):
        updates = [tr.local_update(row, 30) for row in range(4)]
        tr.aggregate(updates)
    assert tr.evaluate() > acc0 + 0.1


def build_real_fl(strategy_name="fedzero", n_clients=12, seed=0):
    """tests/test_system.py's miniature FedZero loop on the port (the
    scheduling backend and the trainer on the CPU)."""
    bk = CudaBackend(device="cpu")
    sc = make_scenario("global", n_clients=n_clients, days=1, seed=seed,
                       backend=bk)
    reg = make_paper_registry(
        n_clients=n_clients, seed=seed, domain_names=sc.domain_names,
        samples_per_client=np.full(n_clients, 120))
    data = F.synthetic_classification(
        n_clients, reg.client_names, n_classes=8, n_samples=1600,
        hw=8, alpha=0.5, seed=seed)
    # keep registry sample counts consistent with actual data
    for c in reg.client_names:
        reg.clients[c].n_samples = data.n_samples(c)
        reg.clients[c].batches_per_epoch = max(1, data.n_samples(c) // 10)
    model = ConvNet(n_classes=8, channels=(8, 16), hw=8, device="cpu")
    trainer = TorchTrainer(model, data, lr=0.05, prox_mu=0.1, seed=seed,
                           max_steps_per_round=20, device="cpu")
    strat = make_strategy(strategy_name, reg, n=4, d_max=60, seed=seed,
                          backend=bk)
    return FLSimulation(reg, sc, strat, trainer, eval_every=2, seed=seed)


def test_federated_training_learns():
    """Global model accuracy rises well above chance (1/8) under FedZero
    scheduling with FedProx local training."""
    sim = build_real_fl("fedzero")
    summary = sim.run(until_step=14 * 60, max_rounds=12)
    assert summary["rounds"] >= 3
    assert summary["best_metric"] > 0.30, summary


def test_aggregation_moves_global_model():
    sim = build_real_fl("random")
    p0 = sim.trainer.params["head"].clone()
    sim.run(until_step=14 * 60, max_rounds=2)
    assert sim.results, "no rounds ran"
    assert not np.allclose(p0.numpy(), sim.trainer.params["head"].numpy())


def test_oort_utility_updates_from_training():
    sim = build_real_fl("oort")
    sim.run(until_step=14 * 60, max_rounds=3)
    ut = sim.strategy.utility
    participated = np.nonzero(ut.participation_arr > 0)[0]
    assert participated.size
    # participated clients have measured (non-default) utility
    assert any(ut.sigma(int(row)) != 1.0 for row in participated)


def test_fedzero_blocklist_cycles_clients():
    sim = build_real_fl("fedzero")
    sim.run(until_step=14 * 60, max_rounds=6)
    assert sim.round_idx >= 4
    # with 12 clients, n=4 and a blocklist, >= 6 distinct clients
    # participate within 4+ rounds
    seen = {c for r in sim.results for c in r.contributors}
    assert len(seen) >= 6


def test_example_runs_on_the_cpu():
    """examples/train_federated_torch.py at a tiny size, scheduling and
    training on the CPU."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT,
                                                                   "src")))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "train_federated_torch.py"),
         "--device", "cpu", "--rounds", "2", "--clients", "6"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rounds = [ln for ln in out.stdout.splitlines()
              if ln.startswith("[fedzero] round")]
    assert len(rounds) == 2, out.stdout
    for ln in rounds:
        loss = float(ln.split("loss=")[1].split()[0])
        assert np.isfinite(loss), ln
    assert "device:        cpu" in out.stdout
    assert "over 2 rounds" in out.stdout


# -- no silent gradients through K3, K4 or K5 ----------------------------------


class _Reached(Exception):
    """``load_library`` was reached: the wrapper went on to build."""


@pytest.fixture
def no_library(monkeypatch):
    def reached():
        raise _Reached
    for mod in (k3, k4, k5):
        monkeypatch.setattr(mod, "load_library", reached)


def _kernel_inputs(device, requires_grad):
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device).requires_grad_(
            requires_grad)
    return {
        "flash_attention": lambda: k3.flash_attention(
            t(1, 4, 16, 64), t(1, 2, 16, 64), t(1, 2, 16, 64)),
        "rwkv_scan": lambda: k4.rwkv_scan(
            t(1, 16, 2, 64), t(1, 16, 2, 64), t(1, 16, 2, 64),
            t(1, 16, 2, 64), t(2, 64)),
        "moe_gemm": lambda: k5.moe_gemm(t(2, 80, 64), t(2, 64, 32)),
        "moe_gemm_launch": lambda: k5.launch(t(2, 8, 64, dtype=torch.bfloat16),
                                             t(2, 64, 32, dtype=torch.bfloat16),
                                             "narrow"),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "rwkv_scan",
                                    "moe_gemm", "moe_gemm_launch"])
def test_kernel_refuses_grad_before_building(kernel, no_library):
    call = _kernel_inputs("meta", True)[kernel]
    with pytest.raises(RuntimeError, match="has no backward"):
        call()
    # no gradient asked for: on to the build (K3, K4), or to K5's check
    # that its tensors are CUDA tensors, which comes before its build
    onward = ((ValueError, "needs CUDA tensors") if kernel.startswith("moe")
              else (_Reached, None))
    with torch.no_grad(), pytest.raises(onward[0], match=onward[1]):
        call()
    with pytest.raises(onward[0], match=onward[1]):
        _kernel_inputs("meta", False)[kernel]()


def test_moe_layer_with_kernels_refuses_grad(no_library):
    """The MoE layer's expert products on K5 (the model reaches K3 first)."""
    from repro_torch.models import moe as moe_mod
    cfg = get_config("mixtral-8x22b", reduced=True)
    model = DecoderLM(cfg, device="meta")
    x = torch.zeros((2, 16, cfg.d_model), device="meta")
    with pytest.raises(RuntimeError, match="moe_gemm: .* no backward"):
        moe_mod.moe_ffn(model.blocks[0].moe, x, cfg, use_kernels=True)


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b"])
def test_decoder_loss_with_kernels_refuses_grad(arch, no_library):
    """``DecoderLM.loss`` on the kernel route, off the CPU, raises instead
    of returning gradients that miss the kernels' inputs; on the
    reference's route (``use_kernels=False``) it differentiates."""
    cfg = get_config(arch, reduced=True)
    toks = torch.zeros((2, 16), dtype=torch.long, device="meta")
    batch = {"tokens": toks, "labels": toks}
    model = DecoderLM(cfg, device="meta")
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        model.loss(batch)
    model.use_kernels = False
    model.loss(batch).backward()
    assert all(p.grad is not None for p in model.parameters())


def test_plain_versions_stay_differentiable():
    """On CPU tensors the wrappers run their plain versions, which
    autograd differentiates as before."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, 8, 64), generator=g, requires_grad=True)
    kv = torch.randn((1, 2, 8, 64), generator=g, requires_grad=True)
    k3.flash_attention(q, kv, kv).sum().backward()
    x = torch.randn((2, 5, 16), generator=g, requires_grad=True)
    w = torch.randn((2, 16, 8), generator=g, requires_grad=True)
    k5.moe_gemm(x, w).sum().backward()
    assert q.grad is not None and kv.grad is not None
    assert x.grad is not None and w.grad is not None


@pytest.mark.cuda
def test_kernels_refuse_grad_on_card():
    """The twin of the tests above on CUDA tensors: each wrapper raises
    under grad, and launches without it; ``DecoderLM.loss`` raises with
    kernels, and with ``use_kernels=False`` gives the CPU's gradients
    (within 1e-4 of each gradient's largest value)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    for kernel in ("flash_attention", "rwkv_scan", "moe_gemm",
                   "moe_gemm_launch"):
        with pytest.raises(RuntimeError, match="has no backward"):
            _kernel_inputs(dev, True)[kernel]()
        with torch.no_grad():
            _kernel_inputs(dev, True)[kernel]()
    torch.cuda.synchronize()
    cfg = get_config("smollm-360m", reduced=True)
    cpu = DecoderLM(cfg, use_kernels=False, device="cpu").init(
        torch.Generator().manual_seed(0))
    card = DecoderLM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        card.loss({"tokens": toks.to(dev), "labels": toks.to(dev)})
    card.use_kernels = False
    card.zero_grad()
    card.loss({"tokens": toks.to(dev), "labels": toks.to(dev)}).backward()
    cpu.loss({"tokens": toks, "labels": toks}).backward()
    for (n, a), b in zip(card.named_parameters(), cpu.parameters()):
        assert _rel(a.grad.float().cpu().numpy(),
                    b.grad.float().numpy()) <= 1e-4, n
