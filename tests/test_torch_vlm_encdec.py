"""The port's vlm (llava-next-34b) and encoder-decoder
(seamless-m4t-large-v2) families against the JAX package, on the CPU.

The reference's own weights (``init`` from a PRNG key) carry across with
``repro_torch.models.convert``, and the inputs are made from a seed with
NumPy, so both sides compute on the same numbers, in float32 at the
reduced configs. Tolerance atol = rtol = 1e-5 (``TOL``), as
tests/test_torch_models.py holds the other families: the two sides differ
in float32 summation order only.

* ``attend_train`` with the reference's full signature (a window that
  overrides the config's, non-causal, cross attention through ``kv_x``
  without RoPE, explicit positions), both of the port's routes against the
  reference's einsum route and, where it serves the call (causal self
  attention), its Pallas kernel in interpreter mode, at the tolerance
  tests/test_torch_models.py holds ``attend_train`` to (atol 3e-5, rtol
  3e-4, tests/test_kernel_model_integration.py's); the K3 route calls the
  kernel for causal self attention only;
* vlm: ``logits_fn``, ``loss``, ``prefill`` with ``frontend_embeds`` (its
  logits and every cache tensor) and three decode steps, on K3's route
  (its plain version on the CPU) and on the einsum route; the loss and its
  gradients through ``make_train_step``; the reference demo's short cache
  (``prompt_len + gen``), which the prefill overfills and the decode steps
  overwrite from the oldest slot;
* encoder-decoder: ``encode``, ``precompute_enc_kv``, ``loss`` and three
  decode steps from ``init_cache`` (as tests/test_arch_smoke.py runs
  them), on both routes; the loss and its gradients, remat on equal to
  remat off; the unpadded embedding beside the padded head; the cross
  attention's cache without a head mask;
* ``input_specs`` and ``params_spec`` of both full-width configs against
  the reference's, shape and dtype, for every shape;
* the train driver on an encoder-decoder fails in both packages on the
  batch's missing ``frontend_embeds``.
"""
import jax
import jax.experimental

# this jax names the x64 context manager jax.enable_x64; the reference
# kernels import it from jax.experimental. Set here, before the reference's
# flash route imports repro.kernels, so this file does not depend on
# collection order.
jax.experimental.enable_x64 = jax.enable_x64

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_get_config
from repro.launch import train as ref_train
from repro.models import attention as RA
from repro.models import build_model as ref_build_model
from repro.models import input_specs as ref_input_specs
from repro.models import params_spec as ref_params_spec
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import steps, train
from repro_torch.models import SHAPES, EncDecLM, input_specs, params_spec
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.convert import (model_config_from_reference,
                                        params_from_reference, to_tensor,
                                        torch_dtype)
from repro_torch.optim import Optimizer

TOL = dict(atol=1e-5, rtol=1e-5)
VLM, ENCDEC = "llava-next-34b", "seamless-m4t-large-v2"
# an "optimizer" whose update returns the gradients as the new parameters
GRADS = Optimizer(init=lambda params: {}, update=lambda g, s, p: (g, s),
                  name="grads")


def _ref(arch, **replace):
    cfg = dataclasses.replace(ref_get_config(arch, reduced=True), **replace)
    model = ref_build_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0))


def _state(params):
    return params_from_reference(jax.tree_util.tree_map(np.asarray, params))


def _port(ref_cfg, params, use_kernels=True):
    model = T.EncDecLM if ref_cfg.encoder_layers else T.DecoderLM
    m = model(model_config_from_reference(ref_cfg), use_kernels=use_kernels,
              device="cpu")
    m.load_state_dict(_state(params))
    return m


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **TOL)


def _cache_close(ref_cache, cache):
    _close(cache.k, ref_cache.k)
    _close(cache.v, ref_cache.v)
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(ref_cache.length))


def _frontend(cfg, B, N, seed=1, scale=0.02):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, N, cfg.d_model))).astype(np.float32)


# ---------------------------------------------------------------------------
# the attention layer's full signature


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
@pytest.mark.parametrize("case", ["window override", "non-causal",
                                  "cross", "cross causal", "positions"])
def test_attend_train_signature_matches_reference(arch, case):
    """Each argument of the reference's ``attend_train`` on both of the
    port's routes: K3's (its plain version here) serves causal self
    attention only, as the reference's kernel route does, and every call
    it does not serve runs the einsum chain."""
    ref_cfg = dataclasses.replace(ref_get_config(arch, reduced=True),
                                  attn_variant="swa", window=24)
    cfg = model_config_from_reference(ref_cfg)
    params = jax.tree_util.tree_map(
        np.asarray, RA.init_attn_params(jax.random.PRNGKey(0), ref_cfg))
    rng = np.random.default_rng(1)
    x = 0.3 * rng.standard_normal((2, 40, cfg.d_model), dtype=np.float32)
    kw = {"window override": dict(window=8),
          "non-causal": dict(causal=False),
          "cross": dict(causal=False, kv_x=0.3 * rng.standard_normal(
              (2, 56, cfg.d_model), dtype=np.float32)),
          "cross causal": dict(kv_x=0.3 * rng.standard_normal(
              (2, 40, cfg.d_model), dtype=np.float32)),
          "positions": dict(positions=np.arange(40)[None, :] + 7)}[case]
    ref_kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
    port_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
    want = [np.asarray(RA.attend_train(params, jnp.asarray(x), ref_cfg,
                                       **ref_kw))]
    if kw.get("causal", True) and "kv_x" not in kw:
        want.append(np.asarray(RA.attend_train(
            params, jnp.asarray(x), ref_cfg, use_flash_kernel=True,
            **ref_kw)))
    tp = {n: to_tensor(a) for n, a in params.items()}
    for flash in (True, False):
        with torch.no_grad():
            got = A.attend_train(tp, torch.from_numpy(x), cfg,
                                 use_flash_kernel=flash, **port_kw).numpy()
        for w in want:
            np.testing.assert_allclose(got, w, atol=3e-5, rtol=3e-4)
    if case == "window override":  # the override wins over cfg.window
        cfg_window = np.asarray(RA.attend_train(params, jnp.asarray(x),
                                                ref_cfg))
        assert np.max(np.abs(cfg_window - want[0])) > 1e-4


def test_k3_serves_causal_self_attention_only(monkeypatch):
    """The K3 route calls the kernel for causal self attention, with the
    caller's window, and never for cross or non-causal attention."""
    calls = []

    def record(q, k, v, causal, window):
        calls.append((tuple(q.shape), tuple(k.shape), causal, window))
        return fa.flash_attention_plain(q, k, v, causal, window)

    monkeypatch.setattr(A, "flash_attention", record)
    cfg = get_config(ENCDEC, reduced=True)
    gen = torch.Generator().manual_seed(0)
    p = A.init_attn_params(gen, cfg)
    x = torch.randn((2, 40, cfg.d_model), generator=gen)
    kv_x = torch.randn((2, 9, cfg.d_model), generator=gen)
    with torch.no_grad():
        A.attend_train(p, x, cfg, window=16, use_flash_kernel=True)
        A.attend_train(p, x, cfg, causal=False, use_flash_kernel=True)
        A.attend_train(p, x, cfg, kv_x=kv_x, causal=False,
                       use_flash_kernel=True)
        A.attend_train(p, x, cfg, kv_x=kv_x[:, :40], use_flash_kernel=True)
    assert calls == [((2, 4, 40, 32), (2, 4, 40, 32), True, 16)]


# ---------------------------------------------------------------------------
# vlm: llava-next-34b


@pytest.mark.parametrize("flash", [True, False])
def test_vlm_matches_reference(flash):
    B, S, steps_ = 2, 12, 3
    ref_cfg, ref_model, ref_params = _ref(VLM)
    model = _port(ref_cfg, ref_params, use_kernels=flash)
    N = ref_cfg.n_frontend_embeds
    fe = _frontend(ref_cfg, B, N)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, ref_cfg.vocab, (B, S + steps_))
    labels = rng.integers(0, ref_cfg.vocab, (B, S))
    prompt = tokens[:, :S]
    ref_batch = {"tokens": jnp.asarray(prompt), "labels": jnp.asarray(labels),
                 "frontend_embeds": jnp.asarray(fe)}
    batch = {"tokens": torch.from_numpy(prompt),
             "labels": torch.from_numpy(labels),
             "frontend_embeds": torch.from_numpy(fe)}
    with torch.no_grad():
        logits = model.logits_fn(batch)
        assert logits.shape == (B, S, ref_cfg.vocab_padded)  # N dropped
        _close(logits, ref_model.logits_fn(ref_params, ref_batch))
        _close(model.loss(batch), ref_model.loss(ref_params, ref_batch))

        cache_len = N + S + steps_
        want, ref_cache = ref_model.prefill(
            ref_params, jnp.asarray(prompt), cache_len,
            frontend_embeds=jnp.asarray(fe))
        got, cache = model.prefill(torch.from_numpy(prompt), cache_len,
                                   frontend_embeds=torch.from_numpy(fe))
        _close(got, want)
        _cache_close(ref_cache, cache)
        assert int(cache.length[0]) == N + S
        for i in range(steps_):
            tok = tokens[:, S + i:S + i + 1]
            want, ref_cache = ref_model.decode_step(ref_params, ref_cache,
                                                    jnp.asarray(tok))
            got, cache = model.decode_step(cache, torch.from_numpy(tok))
            _close(got, want)
            _cache_close(ref_cache, cache)


def test_vlm_demo_cache_overfilled_as_in_reference():
    """The reference demo's cache of ``prompt_len + gen`` is shorter than
    a vlm prefill's N + prompt_len positions: the prefill keeps all of
    them (the cache is full), and each decode step overwrites slot
    ``pos % C``, the oldest frontend position first. The port does the
    same: the same cache shape and lengths and the same slot written at
    each step, bit for bit; the values within ``TOL``."""
    B, P, gen = 2, 10, 4
    ref_cfg, ref_model, ref_params = _ref(VLM)
    model = _port(ref_cfg, ref_params)
    N = ref_cfg.n_frontend_embeds
    fe = _frontend(ref_cfg, B, N)
    tokens = np.random.default_rng(3).integers(0, ref_cfg.vocab,
                                               (B, P + gen))
    cache_len = P + gen  # the reference demo's (inference_demo.py:45)
    with torch.no_grad():
        want, ref_cache = ref_model.prefill(
            ref_params, jnp.asarray(tokens[:, :P]), cache_len,
            frontend_embeds=jnp.asarray(fe))
        got, cache = model.prefill(torch.from_numpy(tokens[:, :P]),
                                   cache_len,
                                   frontend_embeds=torch.from_numpy(fe))
        _close(got, want)
        C = N + P
        assert cache.k.shape == ref_cache.k.shape == (
            ref_cfg.n_layers, B, C, ref_cfg.n_kv_heads_padded,
            ref_cfg.d_head)
        for i in range(gen - 1):
            tok = tokens[:, P + i:P + i + 1]
            ref_before = np.asarray(ref_cache.k).copy()
            before = cache.k.clone()
            want, ref_cache = ref_model.decode_step(ref_params, ref_cache,
                                                    jnp.asarray(tok))
            got, cache = model.decode_step(cache, torch.from_numpy(tok))
            _close(got, want)
            _cache_close(ref_cache, cache)
            changed = (cache.k != before).any(dim=(0, 1, 3, 4)).numpy()
            ref_changed = (np.asarray(ref_cache.k) != ref_before).any(
                axis=(0, 1, 3, 4))
            np.testing.assert_array_equal(changed, ref_changed)
            assert np.flatnonzero(changed).tolist() == [(C + i) % C]


def _grads_match(ref_cfg, ref_params, ref_batch):
    want_loss, want_grads = jax.value_and_grad(ref_build_model(
        ref_cfg).loss)(ref_params, {k: jnp.asarray(v)
                                    for k, v in ref_batch.items()})
    cfg = model_config_from_reference(ref_cfg)
    out = {}
    for remat in (False, True):
        model, _, step = steps.make_train_step(cfg, GRADS, remat=remat,
                                               device="cpu")
        assert model.use_kernels is False and model.remat is remat
        grads, _, loss = step(_state(ref_params), {},
                              {k: torch.from_numpy(v)
                               for k, v in ref_batch.items()})
        np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
        want = _state(want_grads)
        assert grads.keys() == want.keys()
        for n in want:
            np.testing.assert_allclose(grads[n].numpy(), want[n].numpy(),
                                       err_msg=n, **TOL)
        out[remat] = grads
    assert all(torch.equal(out[False][n], out[True][n]) for n in out[False])


def test_vlm_loss_and_grads_match_reference():
    """The loss and every gradient of a step through ``make_train_step``
    (a batch with ``frontend_embeds``) against
    ``jax.value_and_grad(model.loss)``; remat on equals remat off bit for
    bit."""
    ref_cfg, _, ref_params = _ref(VLM)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, ref_cfg.vocab, (2, 12)).astype(np.int32),
             "labels": rng.integers(0, ref_cfg.vocab, (2, 12)).astype(np.int32),
             "frontend_embeds": _frontend(ref_cfg, 2,
                                          ref_cfg.n_frontend_embeds)}
    _grads_match(ref_cfg, ref_params, batch)


# ---------------------------------------------------------------------------
# encoder-decoder: seamless-m4t-large-v2


@pytest.mark.parametrize("flash", [True, False])
def test_encdec_matches_reference(flash):
    """``encode``, ``precompute_enc_kv``, ``loss`` (and the teacher-forced
    ``logits_fn`` it scores) and three decode steps from ``init_cache``,
    as tests/test_arch_smoke.py runs the reference's."""
    B, Se, Sd, C = 2, 48, 10, 32
    ref_cfg, ref_model, ref_params = _ref(ENCDEC)
    model = _port(ref_cfg, ref_params, use_kernels=flash)
    assert isinstance(model, EncDecLM)
    rng = np.random.default_rng(5)
    frames = (0.1 * rng.standard_normal((B, Se, ref_cfg.d_model))).astype(
        np.float32)
    tokens = rng.integers(0, ref_cfg.vocab, (B, Sd))
    labels = rng.integers(0, ref_cfg.vocab, (B, Sd))
    with torch.no_grad():
        enc_ref = ref_model.encode(ref_params, jnp.asarray(frames))
        enc = model.encode(torch.from_numpy(frames))
        _close(enc, enc_ref)
        kv_ref = ref_model.precompute_enc_kv(ref_params, enc_ref)
        kv = model.precompute_enc_kv(enc)
        assert kv[0].shape == kv_ref[0].shape == (
            ref_cfg.n_layers, B, Se, ref_cfg.n_kv_heads_padded,
            ref_cfg.d_head)
        _close(kv[0], kv_ref[0])
        _close(kv[1], kv_ref[1])
        batch = {"frontend_embeds": frames, "tokens": tokens,
                 "labels": labels}
        _close(model.loss({k: torch.from_numpy(v) for k, v in batch.items()}),
               ref_model.loss(ref_params, {k: jnp.asarray(v)
                                           for k, v in batch.items()}))

        ref_cache = ref_model.init_cache(B, C)
        cache = model.init_cache(B, C)
        tok = np.zeros((B, 1), np.int32)
        fed, dec = [], []
        for _ in range(3):
            want, ref_cache = ref_model.decode_step(
                ref_params, ref_cache, jnp.asarray(tok), kv_ref)
            got, cache = model.decode_step(cache, torch.from_numpy(tok), kv)
            _close(got, want)
            _cache_close(ref_cache, cache)
            fed.append(tok)
            dec.append(got)
            tok = np.asarray(jnp.argmax(want[:, -1:], -1)).reshape(
                B, 1).astype(np.int32)
        # the decode steps against the decoder teacher-forced over the
        # same tokens, as chip_smoke.py's encdec phase holds them
        forced = model.logits_fn({"frontend_embeds": torch.from_numpy(frames),
                                  "tokens": torch.from_numpy(
                                      np.concatenate(fed, 1))})
        np.testing.assert_allclose(torch.cat(dec, 1).numpy(),
                                   forced.numpy(), atol=2e-5, rtol=1e-4)


def test_encdec_loss_and_grads_match_reference():
    ref_cfg, _, ref_params = _ref(ENCDEC)
    rng = np.random.default_rng(6)
    batch = {"frontend_embeds": (0.1 * rng.standard_normal(
                 (2, 40, ref_cfg.d_model))).astype(np.float32),
             "tokens": rng.integers(0, ref_cfg.vocab, (2, 10)).astype(np.int32),
             "labels": rng.integers(0, ref_cfg.vocab, (2, 10)).astype(np.int32)}
    _grads_match(ref_cfg, ref_params, batch)


def test_encdec_padded_vocab_and_heads_match_reference():
    """A vocab of 500: ``embed`` keeps 500 rows while ``lm_head`` is padded
    to 512 columns (masked), as the reference's. Three of four heads
    padded: ``attend_train`` masks the padded head's output, but the
    decode step's cached cross attention does not, in either package."""
    B, Se = 2, 40
    ref_cfg, ref_model, ref_params = _ref(
        ENCDEC, vocab=500, n_heads=3, n_kv_heads=3, n_heads_padded=4,
        n_kv_heads_padded=4)
    model = _port(ref_cfg, ref_params)
    assert model.embed.shape == ref_params["embed"].shape == (500, 128)
    assert model.lm_head.shape == ref_params["lm_head"].shape == (128, 512)
    frames = (0.1 * np.random.default_rng(7).standard_normal(
        (B, Se, ref_cfg.d_model))).astype(np.float32)
    with torch.no_grad():
        enc_ref = ref_model.encode(ref_params, jnp.asarray(frames))
        kv_ref = ref_model.precompute_enc_kv(ref_params, enc_ref)
        kv = model.precompute_enc_kv(model.encode(torch.from_numpy(frames)))
        tok = np.full((B, 1), 499, np.int32)
        want, _ = ref_model.decode_step(ref_params, ref_model.init_cache(
            B, 4), jnp.asarray(tok), kv_ref)
        got, _ = model.decode_step(model.init_cache(B, 4),
                                   torch.from_numpy(tok), kv)
        _close(got, want)
        assert float(got[..., 500:].max()) < -1e29  # the masked columns
        # the cached cross attention keeps the padded head's share
        blk = model.dec_blocks[0]
        hx = torch.from_numpy(frames[:, :1])
        layer_kv = (kv[0][0], kv[1][0])
        unmasked = T._cross_attend_cached(blk.xattn, hx, layer_kv,
                                          model.cfg)
        ref_layer = {k: v[0] for k, v in
                     ref_params["dec_blocks"]["xattn"].items()}
        ref_unmasked = RT._cross_attend_cached(
            ref_layer, jnp.asarray(frames[:, :1]),
            (kv_ref[0][0], kv_ref[1][0]), ref_cfg)
        _close(unmasked, ref_unmasked)
        wo = blk.xattn["wo"].clone()
        wo[3:] = 0  # what a head mask would leave
        masked = T._cross_attend_cached({**blk.xattn, "wo": wo}, hx,
                                        layer_kv, model.cfg)
        assert float((unmasked - masked).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the catalogue, the train driver


def _meta_specs(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[jax.tree_util.keystr(path)] = (tuple(leaf.shape),
                                           torch_dtype(leaf.dtype))
    return out


def _port_specs(tree, prefix=""):
    """{path: (shape, dtype)} of a tree of meta tensors in the reference's
    key-path form (``['a']['b']``, ``[0]`` for a tuple entry)."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _port_specs(sub, f"{prefix}['{name}']").items()}
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _port_specs(sub, f"{prefix}[{i}]").items()}
    if hasattr(tree, "_fields"):  # a named tuple: the reference's .name
        return {k: v for name, sub in zip(tree._fields, tree)
                for k, v in _port_specs(sub, f"{prefix}.{name}").items()}
    return {prefix: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_input_and_param_specs_match_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    kind, specs = input_specs(cfg, shape)
    ref_kind, ref_specs = ref_input_specs(ref_cfg, shape)
    assert kind == ref_kind
    assert _port_specs(specs) == _meta_specs(ref_specs)
    params = params_spec(cfg, shape)
    ref_tree = ref_params_spec(ref_cfg, shape)
    flat = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_tree):
        keys = [p.key for p in path]
        stacked = keys[0] in ("blocks", "enc_blocks", "dec_blocks")
        for i in range(leaf.shape[0] if stacked else 1):
            name = ".".join([keys[0], str(i), *keys[1:]] if stacked else keys)
            flat[name] = (tuple(leaf.shape[1:] if stacked else leaf.shape),
                          torch_dtype(leaf.dtype))
    assert {n: (tuple(t.shape), t.dtype) for n, t in params.items()} == flat


@pytest.fixture
def own_process_group():
    """Ends a process group that the test started (the driver starts one
    of world size 1 where none exists)."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_train_driver_needs_frontend_embeds_on_encdec(monkeypatch,
                                                      own_process_group):
    """Both train drivers feed token batches only, and an encoder-decoder's
    loss reads the frames of ``batch["frontend_embeds"]``: both fail there,
    the same way."""
    argv = ["--arch", ENCDEC, "--reduced", "--steps", "1", "--batch", "2",
            "--seq", "16"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(KeyError, match="frontend_embeds"):
        ref_train.main()
    with pytest.raises(KeyError, match="frontend_embeds"):
        train.main(argv + ["--device", "cpu"])
    assert not dist.is_initialized()
