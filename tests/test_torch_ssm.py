"""The port's rwkv6 model (``repro_torch.models.ssm`` and the ssm family of
``DecoderLM``) against the JAX package, on the CPU.

The reference's own weights (``init`` from a PRNG key) carry across with
``repro_torch.models.convert``, and the inputs are made from a seed with
NumPy, so both sides compute on the same numbers:

* ``rwkv_time_mix_train`` on both of the port's routes (K4 and the
  per-token recurrence) against the reference's ``use_kernel=False``
  (``lax.scan``) and ``use_kernel=True`` (its Pallas kernel in interpreter
  mode), at the reference's rwkv tolerance (atol 1e-4, rtol 1e-3, as in
  tests/test_kernels.py); ``rwkv_channel_mix`` and one
  ``rwkv_time_mix_decode`` step (output and every state tensor);
* ``DecoderLM`` on the reduced rwkv6 config in float32, both routes:
  ``logits_fn``, ``prefill`` of a ragged 31-token prompt (its logits and
  every state tensor: shift, shift_cm, S), then three ``decode_step``s,
  and ``loss``. Tolerance atol = rtol = 1e-5, as for the dense models
  (tests/test_torch_models.py): the two sides differ only in float32
  summation order. The state tensors are larger than the logits (~1.3
  here): the normed hidden states ``shift`` and ``shift_cm`` reach ~3.3 and
  ``S`` ~10, and their measured gaps reach 1.4e-5 (``shift_cm``) and
  2.7e-5 (``S``), about 3e-6 of their largest element (the projections'
  summation order, carried through the layers and the decay). So each state
  tensor is held to atol 1e-5 times its largest element, rtol 1e-5;
* the rwkv6 config, full and reduced, field for field, and the
  converter's ``tm`` and ``cm`` groups.
"""
import jax
import jax.experimental

# this jax names the x64 context manager jax.enable_x64; the reference
# kernels import it from jax.experimental. Set here, before the reference's
# kernel route imports repro.kernels, so this file does not depend on
# collection order.
jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import shape_for_long_context as ref_long_context
from repro.models import ssm as RS
from repro_torch.configs import get_config
from repro_torch.models import build_model, shape_for_long_context
from repro_torch.models import ssm as S
from repro_torch.models.convert import (model_config_from_reference,
                                        params_from_reference, to_tensor)

MODEL_TOL = dict(atol=1e-5, rtol=1e-5)
SCAN_TOL = dict(atol=1e-4, rtol=1e-3)
ARCH = "rwkv6-1.6b"


def _ref_cfg():
    return ref_get_config(ARCH, reduced=True)


def _tensors(tree):
    return {n: to_tensor(np.asarray(a)) for n, a in tree.items()}


def _x(seed, B, S_, d, scale=0.5):
    return scale * np.random.default_rng(seed).standard_normal(
        (B, S_, d), dtype=np.float32)


# ---------------------------------------------------------------------------
# the layers


def test_time_mix_train_matches_reference_routes():
    ref_cfg = _ref_cfg()
    cfg = model_config_from_reference(ref_cfg)
    params = RS.init_rwkv_params(jax.random.PRNGKey(0), ref_cfg)
    x = _x(1, 2, 64, cfg.d_model)
    want_scan = np.asarray(RS.rwkv_time_mix_train(params, jnp.asarray(x),
                                                  ref_cfg, use_kernel=False))
    want_kern = np.asarray(RS.rwkv_time_mix_train(params, jnp.asarray(x),
                                                  ref_cfg, use_kernel=True))
    tp = _tensors(params)
    with torch.no_grad():
        for use_kernel in (True, False):
            got = S.rwkv_time_mix_train(tp, torch.from_numpy(x), cfg,
                                        use_kernel=use_kernel).numpy()
            np.testing.assert_allclose(got, want_scan, **MODEL_TOL)
            np.testing.assert_allclose(got, want_kern, **SCAN_TOL)


def test_channel_mix_matches_reference():
    ref_cfg = _ref_cfg()
    params = RS.init_rwkv_cm_params(jax.random.PRNGKey(1), ref_cfg)
    x = _x(2, 2, 9, ref_cfg.d_model)
    x_prev = _x(3, 2, 9, ref_cfg.d_model)
    want = RS.rwkv_channel_mix(params, jnp.asarray(x), jnp.asarray(x_prev))
    with torch.no_grad():
        got = S.rwkv_channel_mix(_tensors(params), torch.from_numpy(x),
                                 torch.from_numpy(x_prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_time_mix_decode_matches_reference():
    ref_cfg = _ref_cfg()
    cfg = model_config_from_reference(ref_cfg)
    params = RS.init_rwkv_params(jax.random.PRNGKey(2), ref_cfg)
    B, d = 3, cfg.d_model
    H, dh = S._heads(cfg)
    rng = np.random.default_rng(4)
    shift, shift_cm = (rng.standard_normal((B, d), dtype=np.float32)
                       for _ in range(2))
    state_S = 0.3 * rng.standard_normal((B, H, dh, dh), dtype=np.float32)
    x = _x(5, B, 1, d)
    ref_state = RS.RWKVState(jnp.asarray(shift), jnp.asarray(shift_cm),
                             jnp.asarray(state_S))
    want, want_st = RS.rwkv_time_mix_decode(params, jnp.asarray(x),
                                            ref_state, ref_cfg)
    state = S.RWKVState(*(torch.from_numpy(a)
                          for a in (shift, shift_cm, state_S)))
    with torch.no_grad():
        got, st = S.rwkv_time_mix_decode(_tensors(params),
                                         torch.from_numpy(x), state, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    for name in S.RWKVState._fields:
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(want_st, name)),
                                   **MODEL_TOL)
    assert np.array_equal(state.S.numpy(), state_S)  # the input is kept


# ---------------------------------------------------------------------------
# the whole model


def _models(use_kernels):
    ref_cfg = _ref_cfg()
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(model_config_from_reference(ref_cfg),
                        use_kernels=use_kernels, device="cpu")
    model.load_state_dict(params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params)))
    return ref_cfg, ref_model, ref_params, model


def _state_close(ref_state, state):
    for name in S.RWKVState._fields:
        got, want = getattr(state, name), np.asarray(getattr(ref_state, name))
        assert got.shape == want.shape
        assert str(got.dtype).split(".")[-1] == want.dtype.name
        # relative to the tensor's scale: see the module docstring
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_decoder_matches_reference(use_kernels):
    B, S_, steps = 2, 31, 3   # a ragged prompt: no chunk multiple
    ref_cfg, ref_model, ref_params, model = _models(use_kernels)
    tokens = np.random.default_rng(2).integers(0, ref_cfg.vocab,
                                               (B, S_ + steps))
    prompt = tokens[:, :S_]
    with torch.no_grad():
        want = ref_model.logits_fn(ref_params, {"tokens": jnp.asarray(prompt)})
        got = model.logits_fn({"tokens": torch.from_numpy(prompt)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)

        want, ref_state = ref_model.prefill(ref_params, jnp.asarray(prompt),
                                            S_ + steps)
        got, state = model.prefill(torch.from_numpy(prompt), S_ + steps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        _state_close(ref_state, state)

        for i in range(steps):
            tok = tokens[:, S_ + i:S_ + i + 1]
            want, ref_state = ref_model.decode_step(ref_params, ref_state,
                                                    jnp.asarray(tok))
            got, state = model.decode_step(state, torch.from_numpy(tok))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **MODEL_TOL)
            _state_close(ref_state, state)

        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        want = ref_model.loss(ref_params, {n: jnp.asarray(a)
                                           for n, a in batch.items()})
        got = model.loss({n: torch.from_numpy(a) for n, a in batch.items()})
        np.testing.assert_allclose(float(got), float(want), **MODEL_TOL)


def test_init_cache_matches_reference():
    _, ref_model, _, model = _models(True)
    _state_close(ref_model.init_cache(2, 40), model.init_cache(2, 40))


# ---------------------------------------------------------------------------
# the config and the converter


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    mine = get_config(ARCH, reduced=reduced)
    ref = ref_get_config(ARCH, reduced)
    assert mine == model_config_from_reference(ref)
    assert mine.source == "arXiv:2404.05892"
    assert mine.param_count() == ref.param_count()
    assert shape_for_long_context(mine) == model_config_from_reference(
        ref_long_context(ref))


def test_converter_carries_tm_and_cm_groups():
    ref_cfg = _ref_cfg()
    ref_params = jax.tree_util.tree_map(
        np.asarray, ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    sd = params_from_reference(ref_params)
    model = build_model(model_config_from_reference(ref_cfg), device="cpu")
    assert set(sd) == set(model.state_dict())
    blocks = ref_params["blocks"]
    for i in range(ref_cfg.n_layers):
        for group in ("tm", "cm"):
            for name, a in blocks[group].items():
                t = sd[f"blocks.{i}.{group}.{name}"]
                assert tuple(t.shape) == a.shape[1:]
                np.testing.assert_array_equal(t.numpy(), a[i])
    # the constant inits are the reference's
    tm, cm = blocks["tm"], blocks["cm"]
    assert np.all(tm["mu"] == 0.5) and np.all(tm["w0"] == -0.5)
    assert np.all(tm["ln_out"] == 1.0) and np.all(cm["mu_k"] == 0.5)
    mine = build_model(get_config(ARCH, reduced=True), device="cpu").init(
        torch.Generator().manual_seed(0))
    blk = mine.blocks[0]
    assert torch.all(blk.tm["mu"] == 0.5) and torch.all(blk.tm["w0"] == -0.5)
    assert torch.all(blk.tm["ln_out"] == 1)
    assert torch.all(blk.cm["mu_k"] == 0.5)
    assert torch.all(blk.ln1 == 1) and torch.all(mine.final_norm == 1)
    # bf16 (the full config's type) crosses bit for bit
    u = tm["u"][0].astype(jnp.bfloat16)
    np.testing.assert_array_equal(to_tensor(u).view(torch.int16).numpy(),
                                  u.view(np.int16))
