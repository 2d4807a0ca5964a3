"""The port's hybrid family (hymba-1.5b: parallel attention and Mamba
heads) against the JAX package, on the CPU.

The reference's own weights (``init`` from a PRNG key) carry across with
``repro_torch.models.convert``, and the inputs are made from a seed with
NumPy, so both sides compute on the same numbers, in float32 at the
reduced config (2 layers, d 256, 4 heads of 64, KV 2, window 64, state 8).
Tolerance atol = rtol = 1e-5 (``TOL``), as tests/test_torch_models.py and
tests/test_torch_vlm_encdec.py hold the other families: the two sides
differ in float32 summation order only.

* the Mamba branch: ``_mamba_core`` from a non-zero conv state and ``h0``
  (its output, conv state and final ``h``), over one scan chunk and over
  several, with autograd recording and without (the two loops of
  ``_selective_scan``); ``mamba_train``; ``mamba_decode`` over three
  tokens against ``_mamba_core`` over the same three;
* ``DecoderLM``: ``logits_fn``; ``prefill`` of a prompt of 100, longer
  than the window of 64, so the KV cache is rolled into its ring buffer
  (the logits, the KV cache, every layer's Mamba state, the lengths bit for
  bit); three ``decode_step``s after it (logits and both halves of the
  cache), on K3's route (its plain version here) and the einsum route;
* the loss and every gradient of a step through ``make_train_step``,
  remat on equal to remat off bit for bit;
* ``logA`` stays float32 in a bfloat16 model: through ``convert``, a
  checkpoint round trip and ``params_to_reference``;
* ``input_specs`` and ``params_spec`` of the full-width config against
  the reference's, shape and dtype, for every shape;
* the planted fault ``hybrid_mamba_state_not_carried``
  (tools/plant_faults.py) fails chip_smoke.py's decode-against-prefill
  check of the Mamba state, which the sound tree passes.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import input_specs as ref_input_specs
from repro.models import params_spec as ref_params_spec
from repro.models import ssm as RS
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import SHAPES, DecoderLM, input_specs, params_spec
from repro_torch.models import ssm as S
from repro_torch.models.convert import (model_config_from_reference,
                                        params_from_reference,
                                        params_to_reference, to_tensor,
                                        torch_dtype)
from repro_torch.optim import Optimizer

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "hymba-1.5b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# an "optimizer" whose update returns the gradients as the new parameters
GRADS = Optimizer(init=lambda params: {}, update=lambda g, s, p: (g, s),
                  name="grads")


def _ref(**replace):
    cfg = dataclasses.replace(ref_get_config(ARCH, reduced=True), **replace)
    model = ref_build_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0))


def _state(params):
    return params_from_reference(jax.tree_util.tree_map(np.asarray, params))


def _port(ref_cfg, params, use_kernels=True):
    m = DecoderLM(model_config_from_reference(ref_cfg),
                  use_kernels=use_kernels, device="cpu")
    m.load_state_dict(_state(params))
    return m


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **TOL)


def _cache_close(ref_cache, cache):
    (ref_kv, ref_m), (kv, m) = ref_cache, cache
    _close(kv.k, ref_kv.k)
    _close(kv.v, ref_kv.v)
    np.testing.assert_array_equal(kv.length.numpy(),
                                  np.asarray(ref_kv.length))
    assert m.h.dtype == torch.float32
    _close(m.conv, ref_m.conv)
    _close(m.h, ref_m.h)


def _mamba_params(ref_cfg):
    params = jax.tree_util.tree_map(
        np.asarray, RS.init_mamba_params(jax.random.PRNGKey(1), ref_cfg))
    return params, {n: to_tensor(a) for n, a in params.items()}


def _normal(seed, shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# the Mamba branch


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("S_", [7, 2 * S.SCAN_CHUNK + 9])
def test_mamba_core_matches_reference(S_, grad):
    """From a non-zero conv state and ``h0``: the output, the new conv
    state and the final ``h``, over one chunk and over three (the last
    ragged), with autograd recording each state and without."""
    ref_cfg, _, _ = _ref()
    d, n = ref_cfg.d_model, ref_cfg.ssm_state
    ref_p, p = _mamba_params(ref_cfg)
    B = 2
    xz = _normal(2, (B, S_, 2 * d))
    conv = _normal(3, (B, S.CONV_K - 1, d))
    h0 = _normal(4, (B, d, n))
    want = RS._mamba_core(ref_p, jnp.asarray(xz), jnp.asarray(conv),
                          jnp.asarray(h0))
    if grad:
        p = {k: v.requires_grad_() for k, v in p.items()}
    with torch.set_grad_enabled(grad):
        got = S._mamba_core(p, torch.from_numpy(xz), torch.from_numpy(conv),
                            torch.from_numpy(h0))
    assert got[0].requires_grad is grad
    assert got[2].dtype == torch.float32
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_mamba_train_and_decode_match_reference():
    """``mamba_train`` from the zero state; ``mamba_decode`` token by token
    over three tokens, against the reference's and against
    ``_mamba_core`` over the same three at once."""
    ref_cfg, _, _ = _ref()
    cfg = model_config_from_reference(ref_cfg)
    ref_p, p = _mamba_params(ref_cfg)
    x = _normal(5, (2, 40, cfg.d_model))
    with torch.no_grad():
        _close(S.mamba_train(p, torch.from_numpy(x), cfg),
               RS.mamba_train(ref_p, jnp.asarray(x), ref_cfg))
        ref_st = RS.init_mamba_state(ref_cfg, 2)
        st = S.init_mamba_state(cfg, 2)
        ys = []
        for t in range(3):
            xt = x[:, t:t + 1]
            want, ref_st = RS.mamba_decode(ref_p, jnp.asarray(xt), ref_st,
                                           ref_cfg)
            got, new = S.mamba_decode(p, torch.from_numpy(xt), st, cfg)
            assert not torch.equal(new.h, st.h)  # the old state is kept
            st = new
            _close(got, want)
            _close(st.conv, ref_st.conv)
            _close(st.h, ref_st.h)
            ys.append(got)
        st0 = S.init_mamba_state(cfg, 2)
        y3, conv3, h3 = S._mamba_core(
            p, torch.from_numpy(x[:, :3]) @ p["in_proj"], st0.conv, st0.h)
    _close(torch.cat(ys, 1), y3.numpy())
    _close(st.conv, conv3.numpy())
    _close(st.h, h3.numpy())


# ---------------------------------------------------------------------------
# the hybrid DecoderLM


@pytest.mark.parametrize("flash", [True, False])
def test_hybrid_decoder_matches_reference(flash):
    """``logits_fn``; ``prefill`` of a prompt longer than the window (the
    KV ring buffer rolled by ``S % C``), its logits, KV cache and Mamba
    states; three decode steps, the logits and both halves of the cache."""
    ref_cfg, ref_model, ref_params = _ref()
    model = _port(ref_cfg, ref_params, use_kernels=flash)
    B, P, steps_ = 2, 100, 3
    C = ref_cfg.window
    assert P > C
    tokens = np.random.default_rng(6).integers(0, ref_cfg.vocab,
                                               (B, P + steps_))
    prompt = tokens[:, :P]
    with torch.no_grad():
        _close(model.logits_fn({"tokens": torch.from_numpy(prompt)}),
               ref_model.logits_fn(ref_params,
                                   {"tokens": jnp.asarray(prompt)}))
        want, ref_cache = ref_model.prefill(ref_params, jnp.asarray(prompt),
                                            P + steps_)
        got, cache = model.prefill(torch.from_numpy(prompt), P + steps_)
        _close(got, want)
        _cache_close(ref_cache, cache)
        kv, m = cache
        L = ref_cfg.n_layers
        assert kv.k.shape == (L, B, C, ref_cfg.n_kv_heads_padded,
                              ref_cfg.d_head)
        assert m.conv.shape == (L, B, S.CONV_K - 1, ref_cfg.d_model)
        assert m.h.shape == (L, B, ref_cfg.d_model, ref_cfg.ssm_state)
        assert kv.length.tolist() == [P] * L
        for i in range(steps_):
            tok = tokens[:, P + i:P + i + 1]
            want, ref_cache = ref_model.decode_step(ref_params, ref_cache,
                                                    jnp.asarray(tok))
            before = kv.k.clone()
            got, cache = model.decode_step(cache, torch.from_numpy(tok))
            _close(got, want)
            _cache_close(ref_cache, cache)
            kv, m = cache
            # the step writes slot pos % C of the ring buffer, in place
            changed = (kv.k != before).any(dim=(0, 1, 3, 4))
            assert torch.nonzero(changed).flatten().tolist() == [(P + i) % C]


def test_hybrid_loss_and_grads_match_reference():
    """The loss and every gradient of a step through ``make_train_step``
    against ``jax.value_and_grad(model.loss)``, within ``TOL``; remat on
    equals remat off bit for bit."""
    ref_cfg, ref_model, ref_params = _ref()
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, ref_cfg.vocab, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, ref_cfg.vocab, (2, 16)).astype(np.int32)}
    want_loss, want_grads = jax.value_and_grad(ref_model.loss)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = _state(want_grads)
    cfg = model_config_from_reference(ref_cfg)
    out = {}
    for remat in (False, True):
        model, _, step = steps.make_train_step(cfg, GRADS, remat=remat,
                                               device="cpu")
        assert model.use_kernels is False and model.remat is remat
        grads, _, loss = step(_state(ref_params), {},
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
        assert grads.keys() == want.keys()
        assert any(".mamba." in n for n in grads)
        for n in want:
            np.testing.assert_allclose(grads[n].numpy(), want[n].numpy(),
                                       err_msg=n, **TOL)
        out[remat] = grads
    assert all(torch.equal(out[False][n], out[True][n]) for n in out[False])


def test_logA_stays_float32(tmp_path):
    """In a bfloat16 model ``logA`` is float32, as the reference builds it:
    the port's parameter, ``params_from_reference`` of the reference's tree,
    a checkpoint round trip, and ``params_to_reference``, bit for bit."""
    ref_cfg, _, ref_params = _ref(dtype=jnp.bfloat16,
                                  param_dtype=jnp.bfloat16)
    assert ref_params["blocks"]["mamba"]["logA"].dtype == jnp.float32
    assert ref_params["blocks"]["mamba"]["in_proj"].dtype == jnp.bfloat16
    model = _port(ref_cfg, ref_params)
    sd = model.state_dict()
    assert sd["blocks.0.mamba.logA"].dtype == torch.float32
    assert sd["blocks.0.mamba.in_proj"].dtype == torch.bfloat16
    want = _state(ref_params)
    assert all(torch.equal(sd[n], want[n]) and sd[n].dtype == want[n].dtype
               for n in want)
    tree = params_to_reference(sd)
    assert tree["blocks"]["mamba"]["logA"].dtype == torch.float32
    save_checkpoint(str(tmp_path), 1, tree)
    got, _ = load_checkpoint(str(tmp_path), tree)
    assert got["blocks"]["mamba"]["logA"].dtype == torch.float32
    back = params_from_reference(got)
    assert all(torch.equal(back[n], sd[n]) and back[n].dtype == sd[n].dtype
               for n in sd)
    fresh = DecoderLM(model_config_from_reference(ref_cfg), device="cpu")
    fresh.init(torch.Generator().manual_seed(0))
    assert fresh.blocks[0].mamba["logA"].dtype == torch.float32
    np.testing.assert_allclose(
        fresh.blocks[0].mamba["logA"].detach().numpy(),
        np.asarray(ref_params["blocks"]["mamba"]["logA"][0]), rtol=1e-6)


# ---------------------------------------------------------------------------
# the catalogue


def _meta_specs(tree):
    return {jax.tree_util.keystr(path): (tuple(leaf.shape),
                                         torch_dtype(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_specs(tree, prefix=""):
    """{path: (shape, dtype)} of a tree of meta tensors in the reference's
    key-path form (``['a']['b']``, ``[0]`` for a tuple entry, ``.name``
    for a named tuple's field)."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _port_specs(sub, f"{prefix}['{name}']").items()}
    if hasattr(tree, "_fields"):
        return {k: v for name, sub in zip(tree._fields, tree)
                for k, v in _port_specs(sub, f"{prefix}.{name}").items()}
    if isinstance(tree, tuple):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _port_specs(sub, f"{prefix}[{i}]").items()}
    return {prefix: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_and_param_specs_match_reference(shape):
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    kind, specs = input_specs(cfg, shape)
    ref_kind, ref_specs = ref_input_specs(ref_cfg, shape)
    assert kind == ref_kind
    assert _port_specs(specs) == _meta_specs(ref_specs)
    if kind == "decode":  # (KVCache, MambaState), the window's 1024 slots
        kv, m = specs["cache"]
        assert kv.k.shape[2] == 1024 and m.h.dtype == torch.float32
    params = params_spec(cfg, shape)
    flat = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            ref_params_spec(ref_cfg, shape)):
        keys = [p.key for p in path]
        stacked = keys[0] == "blocks"
        for i in range(leaf.shape[0] if stacked else 1):
            name = ".".join([keys[0], str(i), *keys[1:]] if stacked else keys)
            flat[name] = (tuple(leaf.shape[1:] if stacked else leaf.shape),
                          torch_dtype(leaf.dtype))
    assert {n: (tuple(t.shape), t.dtype) for n, t in params.items()} == flat
    assert params["blocks.0.mamba.logA"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the planted fault


_CHECK = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, "src")
import chip_smoke
from repro_torch.configs import get_config
from repro_torch.models import DecoderLM
cfg = get_config("hymba-1.5b", reduced=True)
model = DecoderLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
prompts = torch.as_tensor(np.random.default_rng(0).integers(
    0, cfg.vocab, (2, 100)))
with torch.inference_mode():
    print(json.dumps(chip_smoke.hybrid_decode_vs_prefill(
        torch, model, prompts, 104)))
"""


def _plant_faults():
    spec = importlib.util.spec_from_file_location(
        "plant_faults", os.path.join(ROOT, "tools", "plant_faults.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decode_check(tree):
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=tree,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": "src"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.splitlines()[-1])


def test_planted_mamba_state_fault_fails_decode_check(tmp_path):
    """chip_smoke.py's decode-against-prefill check at the reduced config
    on the CPU (a prompt of 100 over a window of 64): the sound tree
    passes it; with ``hybrid_mamba_state_not_carried`` planted (decode
    starts each layer from a zeroed ``MambaState``) the Mamba state check
    fails."""
    pf = _plant_faults()
    path, sound, faulty, phases = pf.FAULTS["hybrid_mamba_state_not_carried"]
    assert phases == ("hybrid",)
    good = _decode_check(ROOT)
    assert good["logits"]["ok"] and good["kv"]["ok"] and good["mamba"]["ok"]
    bad = _decode_check(pf.copy_tree(tmp_path / "planted", path, sound,
                                     faulty))
    assert not bad["mamba"]["ok"]
    assert bad["mamba"]["worst"] > 10 * good["mamba"]["worst"]
