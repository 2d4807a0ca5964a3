"""The port's dense model stack against the JAX package, on the CPU.

The reference's own weights (``repro.models`` ``init`` from a PRNG key)
carry across with ``repro_torch.models.convert``, and the inputs are made
from a seed with NumPy, so both sides compute on the same numbers:

* ``attend_train``, both of the port's routes (K3 and einsum), against the
  reference's ``attend_train`` with ``use_flash_kernel=True`` (its Pallas
  kernel in interpreter mode) and its einsum route, at the tolerance of
  tests/test_kernel_model_integration.py (atol 3e-5, rtol 3e-4);
* ``DecoderLM``: ``logits_fn``, ``prefill`` (its logits and every cache
  tensor), then three ``decode_step``s, on the reduced configs of the four
  dense archs and the two moe archs (mixtral-8x22b, kimi-k2-1t-a32b, whose
  expert products run on K5's route) in float32, against the reference's
  einsum route. Tolerance
  atol = rtol = 1e-5: the two sides differ only in float32 summation order
  (about 2e-6 on logits of magnitude ~1.4 here), and the cache lengths
  must be equal (a float8 cache too, compared as float32); ``loss`` (with and without a token mask and a vocab
  mask) at the same tolerance;
* the configs, ``SHAPES`` and ``shape_for_long_context`` field for field,
  the converter (a bfloat16 array crosses bit for bit), every parameter's
  shape and dtype at full width against the reference's (the moe router
  stays float32 in a bf16 model, as does the hybrid's ``logA``; llava's,
  seamless's and hymba's too), the default device (the card, which raises
  on a host without CUDA), and the registry, which holds the reference's
  ten archs (the rwkv6 model has its own file, tests/test_torch_ssm.py;
  the vlm and encoder-decoder models theirs, tests/test_torch_vlm_encdec.py;
  the hybrid its own, tests/test_torch_hybrid.py).
"""
import jax
import jax.experimental

# this jax names the x64 context manager jax.enable_x64; the reference
# kernels import it from jax.experimental. Set here, before the reference's
# flash route imports repro.kernels, so this file does not depend on
# collection order.
jax.experimental.enable_x64 = jax.enable_x64

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as ref_all_archs
from repro.configs import get_config as ref_get_config
from repro.models import SHAPES as REF_SHAPES
from repro.models import attention as RA
from repro.models import build_model as ref_build_model
from repro.models import shape_for_long_context as ref_long_context
from repro_torch.configs import all_archs, get_config
from repro_torch.models import attention as A
from repro_torch.models import (SHAPES, DecoderLM, EncDecLM, build_model,
                                shape_for_long_context)
from repro_torch.models.convert import (model_config_from_reference,
                                        params_from_reference, to_tensor,
                                        torch_dtype)

MODEL_TOL = dict(atol=1e-5, rtol=1e-5)


def _ref_cfg(arch, variant=None):
    cfg = ref_get_config(arch, reduced=True)
    if variant == "swa":
        cfg = dataclasses.replace(cfg, attn_variant="swa", window=16)
    elif variant == "vocab":  # padded vocab: the logits get the vocab mask
        cfg = dataclasses.replace(cfg, vocab=500)
    elif variant == "fp8":    # the cache stored in float8
        cfg = dataclasses.replace(cfg, cache_dtype=jnp.float8_e4m3fn)
    return cfg


# ---------------------------------------------------------------------------
# the attention layer


@pytest.mark.parametrize("arch,variant,S", [
    ("granite-3-2b", None, 128),
    ("llama3.2-3b", None, 128),     # padded heads: 4 physical, 3 logical
    ("granite-3-2b", "swa32", 128),
])
def test_attend_train_matches_reference_routes(arch, variant, S):
    ref_cfg = ref_get_config(arch, reduced=True)
    if variant == "swa32":
        ref_cfg = dataclasses.replace(ref_cfg, attn_variant="swa", window=32)
    cfg = model_config_from_reference(ref_cfg)
    params = jax.tree_util.tree_map(
        np.asarray, RA.init_attn_params(jax.random.PRNGKey(0), ref_cfg))
    x = 0.3 * np.random.default_rng(1).standard_normal(
        (2, S, cfg.d_model), dtype=np.float32)
    ref_flash = np.asarray(RA.attend_train(params, jnp.asarray(x), ref_cfg,
                                           use_flash_kernel=True))
    ref_einsum = np.asarray(RA.attend_train(params, jnp.asarray(x), ref_cfg))
    tp = {n: to_tensor(a) for n, a in params.items()}
    with torch.no_grad():
        for flash in (True, False):
            out = A.attend_train(tp, torch.from_numpy(x), cfg,
                                 use_flash_kernel=flash).numpy()
            for want in (ref_flash, ref_einsum):
                np.testing.assert_allclose(out, want, atol=3e-5, rtol=3e-4)
    if variant == "swa32":  # the window is applied
        full = np.asarray(RA.attend_train(params, jnp.asarray(x), ref_cfg,
                                          window=0))
        assert np.max(np.abs(full - ref_einsum)) > 1e-4


# ---------------------------------------------------------------------------
# the whole model


def _cache_close(ref_cache, cache):
    for name in ("k", "v"):
        got, want = getattr(cache, name), getattr(ref_cache, name)
        assert str(got.dtype).split(".")[-1] == np.dtype(want.dtype).name
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   **MODEL_TOL)
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(ref_cache.length))


@pytest.mark.parametrize("arch,variant,flash", [
    *[(a, None, True) for a in ("granite-3-2b", "llama3.2-3b", "smollm-360m",
                                "stablelm-3b")],
    ("llama3.2-3b", None, False),     # the port's einsum route
    ("granite-3-2b", "swa", True),    # ring-buffer cache, rolled at prefill
    ("granite-3-2b", "vocab", True),  # vocab mask on the logits
    ("granite-3-2b", "fp8", True),    # float8 cache, written in place
    ("mixtral-8x22b", None, True),    # moe on K5's route, window 64
    ("mixtral-8x22b", None, False),   # moe on the einsum route
    ("kimi-k2-1t-a32b", None, True),  # moe with a shared expert
])
def test_decoder_matches_reference(arch, variant, flash):
    B, S, steps = 2, 32, 3
    ref_cfg = _ref_cfg(arch, variant)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(model_config_from_reference(ref_cfg),
                        use_kernels=flash, device="cpu")
    model.load_state_dict(params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params)))
    tokens = np.random.default_rng(2).integers(0, ref_cfg.vocab,
                                               (B, S + steps))
    prompt = tokens[:, :S]
    with torch.no_grad():
        want = ref_model.logits_fn(ref_params, {"tokens": jnp.asarray(prompt)})
        got = model.logits_fn({"tokens": torch.from_numpy(prompt)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)

        cache_len = S + steps
        want, ref_cache = ref_model.prefill(ref_params, jnp.asarray(prompt),
                                            cache_len)
        got, cache = model.prefill(torch.from_numpy(prompt), cache_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        _cache_close(ref_cache, cache)
        if variant == "swa":
            assert cache.k.shape[2] == 16 < S

        for i in range(steps):
            tok = tokens[:, S + i:S + i + 1]
            want, ref_cache = ref_model.decode_step(ref_params, ref_cache,
                                                    jnp.asarray(tok))
            got, cache = model.decode_step(cache, torch.from_numpy(tok))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **MODEL_TOL)
            _cache_close(ref_cache, cache)


def test_registry_equals_reference():
    """The registry holds the reference's ten archs, the hybrid
    (hymba-1.5b) among them, and each builds (on the meta device)."""
    assert sorted(all_archs()) == sorted(ref_all_archs()) == [
        "granite-3-2b", "hymba-1.5b", "kimi-k2-1t-a32b", "llama3.2-3b",
        "llava-next-34b", "mixtral-8x22b", "rwkv6-1.6b",
        "seamless-m4t-large-v2", "smollm-360m", "stablelm-3b"]
    for arch in all_archs():
        model = build_model(get_config(arch), device="meta")
        assert model.cfg == model_config_from_reference(
            ref_get_config(arch))
    hybrid = build_model(get_config("hymba-1.5b"), device="meta")
    assert isinstance(hybrid, DecoderLM) and hybrid.cfg.hybrid


def test_model_defaults_to_the_card():
    """A model built with no device is on ``cuda:0``, and raises where
    there is none: it never falls back to the host."""
    cfg = get_config("smollm-360m", reduced=True)
    if torch.cuda.is_available():
        assert build_model(cfg).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)


@pytest.mark.parametrize("arch", ["llava-next-34b", "seamless-m4t-large-v2"])
def test_vlm_and_encdec_models_default_to_the_card(arch):
    """The same for the vlm and the encoder-decoder: ``build_model`` of the
    registry's config (a ``DecoderLM``, an ``EncDecLM``) is on ``cuda:0``
    or raises."""
    cfg = get_config(arch, reduced=True)
    want = EncDecLM if cfg.encoder_layers else DecoderLM
    assert type(build_model(cfg, device="meta")) is want
    if torch.cuda.is_available():
        assert build_model(cfg).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b",
                                  "llama3.2-3b", "llava-next-34b",
                                  "seamless-m4t-large-v2", "hymba-1.5b"])
def test_full_width_parameters_match_reference(arch):
    """Every parameter of the full-width model, allocated on the meta
    device, has the reference's shape and dtype (``jax.eval_shape`` of its
    ``init``: nothing is allocated on either side)."""
    ref_cfg = ref_get_config(arch)
    tree = jax.eval_shape(ref_build_model(ref_cfg).init,
                          jax.random.PRNGKey(0))
    stacks = ("blocks", "enc_blocks", "dec_blocks")
    want = {n: a for n, a in tree.items() if n not in stacks}
    for stack in (s for s in stacks if s in tree):
        for key, val in tree[stack].items():
            group = val.items() if isinstance(val, dict) else [("", val)]
            for name, a in group:
                for i in range(a.shape[0]):
                    want[".".join(filter(None, (stack, str(i), key,
                                                name)))] = (
                        jax.ShapeDtypeStruct(a.shape[1:], a.dtype))
    want = {n: (tuple(a.shape), torch_dtype(a.dtype)) for n, a in want.items()}
    model = build_model(get_config(arch), device="meta")
    got = {n: (tuple(t.shape), t.dtype) for n, t in model.state_dict().items()}
    assert got == want
    if ref_cfg.n_experts:
        assert got["blocks.0.moe.router"][1] == torch.float32
        assert got["blocks.0.moe.w1"][1] == torch.bfloat16
    if ref_cfg.hybrid:
        assert got["blocks.0.mamba.logA"][1] == torch.float32
        assert got["blocks.0.mamba.in_proj"][1] == torch.bfloat16


# ---------------------------------------------------------------------------
# configs and the converter


@pytest.mark.parametrize("arch", ["granite-3-2b", "llama3.2-3b",
                                  "smollm-360m", "stablelm-3b",
                                  "mixtral-8x22b", "kimi-k2-1t-a32b",
                                  "llava-next-34b", "seamless-m4t-large-v2",
                                  "hymba-1.5b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference(arch, reduced):
    mine, ref = get_config(arch, reduced=reduced), ref_get_config(arch, reduced)
    assert mine == model_config_from_reference(ref)
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()
    assert shape_for_long_context(mine) == model_config_from_reference(
        ref_long_context(ref))
    assert SHAPES == REF_SHAPES


@pytest.mark.parametrize("arch,masked", [("smollm-360m", False),
                                         ("granite-3-2b", True)])
def test_loss_matches_reference(arch, masked):
    ref_cfg = _ref_cfg(arch, "vocab" if masked else None)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(model_config_from_reference(ref_cfg), device="cpu")
    model.load_state_dict(params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params)))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, ref_cfg.vocab, (2, 16)),
             "labels": rng.integers(0, ref_cfg.vocab, (2, 16))}
    if masked:
        batch["mask"] = (rng.random((2, 16)) < 0.7).astype(np.float32)
    want = ref_model.loss(ref_params, {n: jnp.asarray(a)
                                       for n, a in batch.items()})
    with torch.no_grad():
        got = model.loss({n: torch.from_numpy(a) for n, a in batch.items()})
    np.testing.assert_allclose(float(got), float(want), **MODEL_TOL)


def test_bf16_round_trip_through_converter():
    a = (np.random.default_rng(3).standard_normal((5, 7), dtype=np.float32)
         * 1e3).astype(jnp.bfloat16)
    a[0, :3] = [np.inf, -0.0, np.nan]
    t = to_tensor(a)
    assert t.dtype == torch.bfloat16 and t.shape == a.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    full = model_config_from_reference(ref_get_config("llama3.2-3b"))
    assert full.dtype == torch.bfloat16 and full.param_dtype == torch.bfloat16
    fp8 = dataclasses.replace(ref_get_config("llama3.2-3b"),
                              cache_dtype=jnp.float8_e4m3fn)
    assert (model_config_from_reference(fp8).cache_dtype
            == torch.float8_e4m3fn)
