"""The port's launch layer (``repro_torch.launch``: the step factories,
the train driver, the dry run) against the JAX package's, on the CPU.

* ``make_train_step`` on the reduced float32 smollm-360m (dense),
  mixtral-8x22b (moe), rwkv6-1.6b (ssm) and hymba-1.5b (hybrid: the Mamba
  branch's per-token loop under autograd) with the reference's weights
  carried across: the loss and every gradient within ``TOL`` (atol = rtol
  = 1e-5) of ``jax.value_and_grad(model.loss)`` (rwkv6's gradients
  within ``GRAD_TOL``, 1e-4 of the largest), three AdamW steps against the
  reference's ``make_train_step`` (losses within ``TOL``, parameters by
  ``STEP_RHO``: see the test), and remat on equal to remat off bit for
  bit.
* The train step as a DTensor program on the gloo 1×1 mesh of
  ``fit_mesh`` equals the step on plain tensors bit for bit.
* ``make_prefill_step``/``make_decode_step`` (the kernel route: K3, K4 and
  K5 run their plain versions on the CPU) against the reference's
  factories: the prefill's logits and two decode steps within ``TOL``.
* The driver: it runs and resumes (``resumed from step 6``), granite
  reduced loses more than 1.0 of its loss over 60 steps (as
  tests/test_launch_drivers.py checks the reference), and
  ``synthetic_lm_batch`` equals the reference's array for array.
* The dry run: ``params``, ``active_params`` and
  ``state_bytes_per_device`` equal the reference's (computed here from
  ``repro.sharding``, ``repro.models.params_spec`` and
  ``make_abstract_mesh``; ``repro.launch.dryrun`` is not imported: it sets
  ``XLA_FLAGS`` when imported); a meta run proves the steps' shapes; the
  hybrid's train and prefill FLOPs are the quadratic through three short
  meta runs, which a fourth run at another length equals exactly.
* The encoder-decoder's and the vlm's step factories against the
  reference's; the dry run's rows of both families.
* The batched inference example (its vlm and encoder-decoder branches
  too), and a ``cuda``-marked twin of the card against the CPU.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro.configs import all_archs as ref_all_archs
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.launch.train import synthetic_lm_batch as ref_synthetic_lm_batch
from repro.models import build_model as ref_build_model
from repro.models import input_specs as ref_input_specs
from repro.models import params_spec as ref_params_spec
from repro.optim import adamw as ref_adamw
from repro.sharding import STRATEGIES as REF_STRATEGIES
from repro.sharding import cache_specs as ref_cache_specs
from repro.sharding import make_abstract_mesh
from repro.sharding import param_specs as ref_param_specs
from repro.sharding.specs import _axis_size as ref_axis_size
from repro_torch.configs import all_archs, get_config
from repro_torch.launch import dryrun, steps, train
from repro_torch.models import SHAPES, DecoderLM, EncDecLM, input_specs
from repro_torch.models.convert import (model_config_from_reference,
                                        params_from_reference)
from repro_torch.optim import Optimizer, adamw
from repro_torch.sharding import step_placements

TOL = dict(atol=1e-5, rtol=1e-5)
# a step's gradients against the reference's, relative to each tensor's
# largest: dense and moe agree to 2.3e-6. The rwkv6 float32 scan's
# gradients are ill-conditioned (a per-head norm over small outputs): port
# and reference differ by 6.8e-5 of the largest, each ~3e-5 off a run in
# float64 outside the scan
GRAD_TOL = {"smollm-360m": 1e-5, "mixtral-8x22b": 1e-5, "rwkv6-1.6b": 1e-4,
            "hymba-1.5b": 1e-5}
# three AdamW steps: |p_port - p_ref| / |p_ref - p_0| per tensor
STEP_RHO = 0.05
ARCHS = ["smollm-360m", "mixtral-8x22b", "rwkv6-1.6b", "hymba-1.5b"]
ROOT = os.path.join(os.path.dirname(__file__), "..")
# an "optimizer" whose update returns the gradients as the new parameters
GRADS = Optimizer(init=lambda params: {}, update=lambda g, s, p: (g, s),
                  name="grads")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def own_process_group():
    """Ends a process group that the test started (the driver and
    ``fit_mesh`` start one of world size 1 where none exists)."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _ref(arch):
    cfg = ref_get_config(arch, reduced=True)
    params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, params


def _port_params(params):
    return params_from_reference(jax.tree_util.tree_map(np.asarray, params))


def _batches(vocab, n, B=2, S=16, seed=3):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
            for _ in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _assert_close_named(got: dict, want_tree, **tol):
    want = _port_params(want_tree)
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   err_msg=n, **tol)


def _rel_to_max(got: dict, want: dict) -> dict:
    """Per tensor: max |got - want| over max |want|."""
    return {n: float((got[n] - want[n]).abs().max())
            / (float(want[n].abs().max()) or 1.0) for n in want}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The loss and every gradient of one step against
    ``jax.value_and_grad(model.loss)``: the loss within ``TOL``; each
    gradient within ``GRAD_TOL[arch]`` of its tensor's largest value, and,
    for dense and moe, element by element within ``TOL``."""
    cfg, params = _ref(arch)
    batch = _batches(cfg.vocab, 1)[0]
    want_loss, want_grads = jax.value_and_grad(ref_build_model(cfg).loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    port_cfg = model_config_from_reference(cfg)
    _, _, step = steps.make_train_step(port_cfg, GRADS, remat=False,
                                       device="cpu")
    grads, _, loss = step(_port_params(params), {}, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    want = _port_params(want_grads)
    assert grads.keys() == want.keys()
    rel = _rel_to_max(grads, want)
    assert max(rel.values()) <= GRAD_TOL[arch], max(rel.items(),
                                                   key=lambda kv: kv[1])
    if cfg.family != "ssm":
        _assert_close_named(grads, want_grads, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_reference(arch):
    """Three AdamW steps against the reference's ``make_train_step``: each
    step's loss within ``TOL``, the step counts equal, and per tensor the
    parameters' distance from the reference's under ``STEP_RHO`` of the
    distance the reference's moved them. Elementwise 1e-5 cannot hold for
    AdamW in float32: where a gradient is near zero, ``g / (sqrt(v) +
    eps)`` takes its sign and size from rounding (2e-9 against -3e-10 in
    smollm's ffn), and such elements move by up to ``lr`` either way (14 of
    1.38M elements for smollm, 0.28% for rwkv6, whose gradients agree to
    6.8e-5). Sound runs read at most 4.3e-4 (smollm), 5.4e-3 (mixtral) and
    1.8e-2 (rwkv6); a tensor left out of the update reads 1."""
    cfg, params = _ref(arch)
    p0 = _port_params(params)
    _, ref_opt, ref_step = ref_steps.make_train_step(
        cfg, optimizer=ref_adamw(1e-3, weight_decay=0.1), remat=False)
    ref_step = jax.jit(ref_step)
    ref_state = ref_opt.init(params)
    _, opt, step = steps.make_train_step(
        model_config_from_reference(cfg), adamw(1e-3, weight_decay=0.1),
        remat=False, device="cpu")
    port = _port_params(params)
    state = opt.init(port)
    for b in _batches(cfg.vocab, 3):
        params, ref_state, want = ref_step(
            params, ref_state, {k: jnp.asarray(v) for k, v in b.items()})
        port, state, loss = step(port, state, _torch_batch(b))
        np.testing.assert_allclose(float(loss), float(want), **TOL)
    assert int(state["step"]) == int(ref_state["step"]) == 3
    want = _port_params(params)
    assert port.keys() == want.keys()
    for n in want:
        rho = float((port[n] - want[n]).norm() / (want[n] - p0[n]).norm())
        assert rho <= STEP_RHO, (n, rho)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_bit_for_bit(arch):
    cfg, params = _ref(arch)
    port_cfg = model_config_from_reference(cfg)
    out = {}
    for remat in (False, True):
        model, opt, step = steps.make_train_step(
            port_cfg, adamw(1e-3, weight_decay=0.1), remat=remat,
            device="cpu")
        assert model.remat is remat and model.use_kernels is False
        p = _port_params(params)
        s = opt.init(p)
        losses = []
        for b in _batches(cfg.vocab, 2):
            p, s, loss = step(p, s, _torch_batch(b))
            losses.append(loss)
        _, _, grads = steps.make_train_step(port_cfg, GRADS, remat=remat,
                                            device="cpu")
        g, _, _ = grads(p, {}, _torch_batch(_batches(cfg.vocab, 1)[0]))
        out[remat] = (p, s, losses, g)
    (p0, s0, l0, g0), (p1, s1, l1, g1) = out[False], out[True]
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for a, b in ((p0, p1), (s0["m"], s1["m"]), (s0["v"], s1["v"]), (g0, g1)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[n], b[n]) for n in a), arch


def test_default_optimizer_matches_reference():
    for arch in all_archs():
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        assert (steps.default_optimizer(cfg).name
                == ref_steps.default_optimizer(ref_cfg).name)
    assert steps.BIG_MODEL_PARAMS == ref_steps.BIG_MODEL_PARAMS
    state = steps.default_optimizer(get_config("mixtral-8x22b")).init(
        {"w": torch.zeros(2, device="meta")})
    assert state["mu"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_step_on_dtensors_equals_plain(arch, own_process_group):
    """The train step as a DTensor program (``make_train_step(...,
    mesh=)``) on the 1×1 gloo mesh of ``fit_mesh`` (one process) against
    the plain step, two AdamW steps: the loss comes out replicated, the
    parameters and state stay DTensors on their placements, and every
    value equals the plain step's bit for bit."""
    cfg, params = _ref(arch)
    port_cfg = model_config_from_reference(cfg)
    _, opt, step = steps.make_train_step(
        port_cfg, adamw(1e-3, weight_decay=0.1), remat=True, device="cpu")
    mesh = train.fit_mesh("cpu")
    assert dist.get_backend() == "gloo" and mesh.mesh_dim_names == (
        "data", "model") and tuple(mesh.shape) == (1, 1)
    _, _, mesh_step = steps.make_train_step(
        port_cfg, adamw(1e-3, weight_decay=0.1), remat=True, device="cpu",
        mesh=mesh)
    plain = _port_params(params)
    plain_s = opt.init(plain)
    batches = [_torch_batch(b) for b in _batches(cfg.vocab, 2)]
    pl, ol, bpl = step_placements("train", mesh, params=plain,
                                  opt_state=plain_s, batch=batches[0])["in"]
    p = train.distribute(_port_params(params), pl, mesh)
    s = train.distribute(opt.init(plain), ol, mesh)
    assert isinstance(p["embed"], DTensor)
    for tb in batches:
        plain, plain_s, want = step(plain, plain_s, tb)
        p, s, loss = mesh_step(p, s, train.distribute(tb, bpl, mesh))
        assert tuple(loss.placements) == (Replicate(), Replicate())
        assert torch.equal(loss.full_tensor(), want)
    assert all(isinstance(t, DTensor) and t.placements == pl[n]
               for n, t in p.items())
    got_p, got_s = train.gather(p), train.gather(s)
    assert all(torch.equal(got_p[n], plain[n]) for n in plain)
    for k in ("m", "v"):
        assert all(torch.equal(got_s[k][n], plain_s[k][n]) for n in plain)
    assert torch.equal(got_s["step"], plain_s["step"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_factories_match_reference(arch):
    cfg, params = _ref(arch)
    port_cfg = model_config_from_reference(cfg)
    _, ref_prefill = ref_steps.make_prefill_step(cfg, "prefill_32k")
    _, ref_decode = ref_steps.make_decode_step(cfg, "decode_32k")
    model, prefill = steps.make_prefill_step(port_cfg, "prefill_32k",
                                             device="cpu")
    dec_model, decode = steps.make_decode_step(port_cfg, "decode_32k",
                                               device="cpu")
    assert model.use_kernels and dec_model.use_kernels
    sd = _port_params(params)
    model.load_state_dict(sd)
    dec_model.load_state_dict(sd)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 12))
    want, ref_cache = ref_prefill(params, jnp.asarray(tokens, jnp.int32))
    got, cache = prefill(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None]
    for _ in range(2):
        want, ref_cache = ref_decode(params, ref_cache,
                                     jnp.asarray(tok, jnp.int32))
        got, cache = decode(cache, torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None]


def test_encdec_prefill_step_raises():
    """The step factories build the hybrid's steps (a ``DecoderLM`` with
    the Mamba branch, on the kernels, whose decode step takes the
    (KVCache, MambaState) cache) and an encoder-decoder's steps (an
    ``EncDecLM``)."""
    hybrid = model_config_from_reference(ref_get_config("hymba-1.5b",
                                                        reduced=True))
    model, prefill = steps.make_prefill_step(hybrid, "prefill_32k",
                                             device="cpu")
    dec_model, decode = steps.make_decode_step(hybrid, "decode_32k",
                                               device="cpu")
    for m in (model, dec_model):
        assert isinstance(m, DecoderLM) and m.use_kernels
        assert "blocks.0.mamba.logA" in dict(m.named_parameters())
    gen = torch.Generator().manual_seed(0)
    model.init(gen)
    dec_model.load_state_dict(model.state_dict())
    tokens = torch.randint(0, hybrid.vocab, (2, 80), generator=gen)
    logits, (kv, m) = prefill(tokens)
    assert kv.k.shape[2] == hybrid.window and m.h.dtype == torch.float32
    logits, (kv, m) = decode((kv, m), logits[:, -1].argmax(-1)[:, None])
    assert logits.shape == (2, 1, hybrid.vocab_padded)
    assert kv.length.tolist() == [81] * hybrid.n_layers
    encdec = get_config("seamless-m4t-large-v2", reduced=True)
    for make, shape in ((steps.make_prefill_step, "prefill_32k"),
                        (steps.make_decode_step, "decode_32k")):
        model, _ = make(encdec, shape, device="cpu")
        assert isinstance(model, EncDecLM) and model.use_kernels


def test_encdec_step_factories_match_reference():
    """The encoder-decoder's prefill step (``encode``, then
    ``precompute_enc_kv``) and three decode steps against the reference's
    factories, within ``TOL``."""
    cfg, params = _ref("seamless-m4t-large-v2")
    port_cfg = model_config_from_reference(cfg)
    _, ref_prefill = ref_steps.make_prefill_step(cfg, "prefill_32k")
    ref_dec_model, ref_decode = ref_steps.make_decode_step(cfg, "decode_32k")
    model, prefill = steps.make_prefill_step(port_cfg, "prefill_32k",
                                             device="cpu")
    dec_model, decode = steps.make_decode_step(port_cfg, "decode_32k",
                                               device="cpu")
    sd = _port_params(params)
    model.load_state_dict(sd)
    dec_model.load_state_dict(sd)
    frames = (0.1 * np.random.default_rng(5).standard_normal(
        (2, 40, cfg.d_model))).astype(np.float32)
    ref_kv = ref_prefill(params, jnp.asarray(frames))
    kv = prefill(torch.from_numpy(frames))
    for got, want in zip(kv, ref_kv):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref_cache, cache = ref_dec_model.init_cache(2, 8), dec_model.init_cache(2, 8)
    tok = np.zeros((2, 1), np.int32)
    for _ in range(3):
        want, ref_cache = ref_decode(params, ref_cache, jnp.asarray(tok),
                                     ref_kv)
        got, cache = decode(cache, torch.from_numpy(tok), kv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)


def test_vlm_step_factories_match_reference():
    """The vlm's prefill step with ``frontend_embeds`` (its default cache
    of the shape's seq) and two decode steps against the reference's."""
    cfg, params = _ref("llava-next-34b")
    port_cfg = model_config_from_reference(cfg)
    _, ref_prefill = ref_steps.make_prefill_step(cfg, "prefill_32k")
    _, ref_decode = ref_steps.make_decode_step(cfg, "decode_32k")
    model, prefill = steps.make_prefill_step(port_cfg, "prefill_32k",
                                             device="cpu")
    dec_model, decode = steps.make_decode_step(port_cfg, "decode_32k",
                                               device="cpu")
    sd = _port_params(params)
    model.load_state_dict(sd)
    dec_model.load_state_dict(sd)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab, (2, 12))
    fe = (0.02 * rng.standard_normal(
        (2, cfg.n_frontend_embeds, cfg.d_model))).astype(np.float32)
    want, ref_cache = ref_prefill(params, jnp.asarray(tokens, jnp.int32),
                                  frontend_embeds=jnp.asarray(fe))
    got, cache = prefill(torch.from_numpy(tokens),
                         frontend_embeds=torch.from_numpy(fe))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache.k.shape == ref_cache.k.shape
    tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None]
    for _ in range(2):
        want, ref_cache = ref_decode(params, ref_cache,
                                     jnp.asarray(tok, jnp.int32))
        got, cache = decode(cache, torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None]


def test_synthetic_lm_batch_matches_reference():
    a = train.synthetic_lm_batch(np.random.default_rng(7), 3, 40, 512)
    b = ref_synthetic_lm_batch(np.random.default_rng(7), 3, 40, 512)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == torch.int32
        np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_train_driver_runs_and_resumes(tmp_path, capsys, own_process_group):
    ckpt = str(tmp_path / "ckpt")
    first = train.main(["--arch", "smollm-360m", "--reduced", "--steps", "6",
                        "--batch", "2", "--seq", "32", "--ckpt-dir", ckpt,
                        "--ckpt-every", "3", "--device", "cpu"])
    out1 = capsys.readouterr().out
    assert "done: final loss" in out1 and not dist.is_initialized()
    assert first["start"] == 0 and len(first["losses"]) == 6
    assert sorted(os.listdir(ckpt)) == [
        "ckpt_00000003.json", "ckpt_00000003.npz", "ckpt_00000006.json",
        "ckpt_00000006.npz"]
    # the checkpoint holds the run's final state, bit for bit
    p, o, extra = train.load_state(ckpt, first["params"], first["opt_state"],
                                   torch.device("cpu"), step=6)
    assert extra == {"step": 6, "arch": "smollm-360m"}
    assert all(torch.equal(p[n], first["params"][n]) for n in p)
    assert all(torch.equal(o["m"][n], first["opt_state"]["m"][n]) for n in p)
    assert torch.equal(o["step"], first["opt_state"]["step"])
    second = train.main(["--arch", "smollm-360m", "--reduced", "--steps",
                         "8", "--batch", "2", "--seq", "32", "--ckpt-dir",
                         ckpt, "--device", "cpu"])
    out2 = capsys.readouterr().out
    assert "resumed from step 6" in out2
    assert second["start"] == 6 and len(second["losses"]) == 2
    assert int(second["opt_state"]["step"]) == 8


def test_train_driver_loss_decreases(capsys, own_process_group):
    train.main(["--arch", "granite-3-2b", "--reduced", "--steps", "60",
                "--batch", "8", "--seq", "64", "--lr", "5e-3",
                "--log-every", "59", "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(l.split("loss")[1].split()[0])
              for l in out.splitlines() if l.startswith("step")]
    # the bigram structure is learnable: expect a clear drop from ln(512)
    assert len(losses) == 2 and losses[-1] < losses[0] - 1.0, out


def test_train_driver_defaults_to_the_card(own_process_group):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    assert not dist.is_initialized()


def _ref_sharded_bytes(struct, spec_tree, mesh):
    """The reference dry run's ``_sharded_bytes`` (dryrun.py:83-104)."""
    def leaf_bytes(leaf, spec):
        n = int(np.prod(leaf.shape)) if leaf.shape else 1
        denom = 1
        for entry in spec:
            if entry is None:
                continue
            for a in entry if isinstance(entry, tuple) else (entry,):
                denom *= ref_axis_size(mesh, a)
        return n * leaf.dtype.itemsize // max(denom, 1)

    flat_l = jax.tree_util.tree_leaves(struct)
    flat_s = jax.tree_util.tree_leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return sum(leaf_bytes(l, s) for l, s in zip(flat_l, flat_s))


def _ref_state_bytes(arch, shape, mesh, strategy):
    """What the reference's dry run records as ``state_bytes_per_device``
    (dryrun.py:107-183)."""
    cfg = ref_get_config(arch)
    kind, specs = ref_input_specs(cfg, shape)
    skw = REF_STRATEGIES[strategy]
    pstruct = ref_params_spec(cfg, shape)
    total = _ref_sharded_bytes(pstruct, ref_param_specs(pstruct, mesh, **skw),
                               mesh)
    if kind == "train":
        ostruct = jax.eval_shape(ref_steps.default_optimizer(cfg).init,
                                 pstruct)
        total += _ref_sharded_bytes(
            ostruct, ref_param_specs(ostruct, mesh, **skw), mesh)
    elif kind == "decode":
        cspec = ref_cache_specs(specs["cache"], mesh,
                                seq_over_model=skw.get("seq_over_model", True))
        total += _ref_sharded_bytes(specs["cache"], cspec, mesh)
    return total


@pytest.mark.parametrize("strategy", ["tp_fsdp", "tp_only_seqkv",
                                      "tp_fsdp_inpod"])
@pytest.mark.parametrize("arch", all_archs())
def test_dryrun_accounting_matches_reference(arch, strategy):
    cfg = get_config(arch)
    for mesh_kind, sizes, axes in (
            ("single_pod", (16, 16), ("data", "model")),
            ("multi_pod", (2, 16, 16), ("pod", "data", "model"))):
        mesh = dryrun.make_production_mesh(multi_pod=mesh_kind == "multi_pod")
        ref_mesh = make_abstract_mesh(sizes, axes)
        for shape in SHAPES:
            got = dryrun.state_bytes(cfg, shape, mesh, strategy)
            assert got == _ref_state_bytes(arch, shape, ref_mesh, strategy), (
                mesh_kind, shape)
    ref_cfg = ref_get_config(arch)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()


def test_dryrun_records_and_error_rows(tmp_path):
    steps_cache = {}
    rec = dryrun.dryrun_one("smollm-360m", "train_4k", "multi_pod",
                            steps=steps_cache, verbose=False)
    cfg = get_config("smollm-360m")
    assert rec["chips"] == 512 and rec["kind"] == "train"
    assert rec["optimizer"] == "adamw" and rec["shapes_ok"]
    assert rec["params"] == cfg.param_count()
    # 6 N T for the weights' products, plus attention and the remat forward
    assert rec["step_flops"] > 6 * cfg.param_count() * 256 * 4096 * 0.9
    again = dryrun.dryrun_one("smollm-360m", "train_4k", "single_pod",
                              steps=steps_cache, verbose=False)
    assert again["step_flops"] == rec["step_flops"] and len(steps_cache) == 1
    ssm = dryrun.dryrun_one("rwkv6-1.6b", "prefill_32k", "single_pod",
                            verbose=False)
    assert ssm["shapes_ok"] and ssm["flops_method"] == (
        "linear in seq from meta runs at 16 and 32")
    dec = dryrun.dryrun_one("mixtral-8x22b", "long_500k", "single_pod",
                            verbose=False)
    assert dec["shapes_ok"] and dec["kind"] == "decode"
    # the hybrid, the last family ported: no error rows; its prefill's
    # FLOPs from three meta runs, quadratic in seq
    out = str(tmp_path / "dry.json")
    assert dryrun.main(["--arch", "hymba-1.5b,smollm-360m", "--shape",
                        "prefill_32k,decode_32k", "--mesh", "single_pod",
                        "--out", out]) == 0
    with open(out) as f:
        rows = json.load(f)
    assert [(r["arch"], r["shape"]) for r in rows] == [
        ("hymba-1.5b", "prefill_32k"), ("hymba-1.5b", "decode_32k"),
        ("smollm-360m", "prefill_32k"), ("smollm-360m", "decode_32k")]
    assert all("error" not in r and r["shapes_ok"] for r in rows)
    assert rows[0]["flops_method"] == (
        "quadratic in seq from meta runs at 16, 32 and 48")
    assert rows[1]["flops_method"] == "meta run"
    assert all_archs() == list(dryrun.all_archs())
    assert set(all_archs()) == set(ref_all_archs())


def test_dryrun_hybrid_fit_equals_a_direct_run():
    """The quadratic through the hybrid prefill's three meta runs (16, 32
    and 48 tokens) equals a direct meta run at a fourth length, 64, exactly;
    the rwkv6 line through its two runs does the same at 48."""
    for arch, seqs in (("hymba-1.5b", (16, 32, 48)), ("rwkv6-1.6b",
                                                       (16, 32))):
        cfg = get_config(arch)
        assert dryrun.PROBE_SEQ[dryrun.probe_family(cfg)] == seqs
        kind, specs = input_specs(cfg, "prefill_32k")
        runs = [(s, dryrun._run_step(cfg, "prefill_32k", kind,
                                     dryrun.cut_specs(specs, kind, s))[0])
                for s in seqs + (seqs[-1] + 16,)]
        fit = dryrun.through(runs[:-1], runs[-1][0])
        assert fit.denominator == 1 and fit == runs[-1][1], (arch, runs)


def test_batched_inference_example_runs(capsys):
    path = os.path.join(ROOT, "examples", "inference_demo_batched_torch.py")
    spec = importlib.util.spec_from_file_location("demo_batched_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for arch in ARCHS:
        gen = mod.main(["--arch", arch, "--batch", "2", "--prompt-len", "8",
                        "--gen", "4", "--device", "cpu"])
        assert gen.shape == (2, 4)
    out = capsys.readouterr().out
    assert out.count("decoded 4 tokens × 2 seqs") == len(ARCHS)


def test_batched_inference_example_runs_vlm_and_encdec(capsys):
    """The example's vlm branch (random frontend embeddings before the
    prompt) and encoder-decoder branch (P random frames encoded, decoding
    from token 0)."""
    path = os.path.join(ROOT, "examples", "inference_demo_batched_torch.py")
    spec = importlib.util.spec_from_file_location("demo_batched_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for arch in ("llava-next-34b", "seamless-m4t-large-v2"):
        gen = mod.main(["--arch", arch, "--batch", "2", "--prompt-len", "8",
                        "--gen", "4", "--device", "cpu"])
        assert gen.shape == (2, 4) and (gen >= 0).all() and (gen < 512).all()
    out = capsys.readouterr().out
    assert out.count("decoded 4 tokens × 2 seqs") == 2
    assert out.count("prefill 2×8") == 1  # the encoder-decoder has none


def test_dryrun_vlm_and_encdec_rows():
    """llava's and seamless's dry-run rows: every kind runs on the meta
    device with the shapes the steps take (no error row)."""
    for arch, shape in (("llava-next-34b", "prefill_32k"),
                        ("llava-next-34b", "decode_32k"),
                        ("seamless-m4t-large-v2", "train_4k"),
                        ("seamless-m4t-large-v2", "prefill_32k"),
                        ("seamless-m4t-large-v2", "decode_32k")):
        rec = dryrun.dryrun_one(arch, shape, "single_pod", verbose=False)
        assert rec["shapes_ok"] and rec["step_flops"] > 0, (arch, shape)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu():
    """The twin of chip_smoke.py's launch check at the reduced width: three
    AdamW steps of the reduced float32 smollm on ``cuda:0`` and on the CPU
    from the same weights (TF32 off): the first step's gradients within
    1e-4 of each tensor's largest, the losses within 1e-4, and per tensor
    the parameters' distance under ``STEP_RHO`` of the distance moved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, params = _ref("smollm-360m")
        port_cfg = model_config_from_reference(cfg)
        p0 = _port_params(params)
        batches = _batches(cfg.vocab, 3)
        out = {}
        for device in (torch.device("cuda:0"), torch.device("cpu")):
            def on(b, device=device):
                return {k: v.to(device) for k, v in _torch_batch(b).items()}
            _, _, grads = steps.make_train_step(port_cfg, GRADS,
                                                device=device)
            _, opt, step = steps.make_train_step(
                port_cfg, adamw(1e-3, weight_decay=0.1), device=device)
            p = {n: t.to(device) for n, t in p0.items()}
            g, _, _ = grads(p, {}, on(batches[0]))
            s, losses = opt.init(p), []
            for b in batches:
                p, s, loss = step(p, s, on(b))
                losses.append(float(loss))
            out[device.type] = ({n: t.cpu() for n, t in g.items()},
                                {n: t.cpu() for n, t in p.items()}, losses)
        (gc, pc, lc), (gh, ph, lh) = out["cuda"], out["cpu"]
        assert max(_rel_to_max(gc, gh).values()) <= 1e-4
        np.testing.assert_allclose(lc, lh, rtol=1e-4)
        for n in ph:
            rho = float((pc[n] - ph[n]).norm() / (ph[n] - p0[n]).norm())
            assert rho <= STEP_RHO, (n, rho)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
