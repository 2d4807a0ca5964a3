"""Kimi-K2-Instruct's architecture on the port (latent attention with
YaRN, sigmoid routing with a selection-only bias, a held share of the
experts, a leading dense layer) against the plain reference
``tests/plain_mla_moe.py``, at a tiny size on the CPU, seeded.

Both sides compute in float32 on the same weights and differ only in
float32 summation order: the logits agree within atol = rtol = 1e-4 (the
largest logit is ~1, and three layers' float32 rounding ~1e-6 of it),
a layer's output within 1e-5. The routed top-k is the same on both sides
(no near tie at these seeds): a flipped expert would miss by the size of
an expert's output, ~1.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.models.common import (ModelConfig, Yarn, yarn_freqs,
                                       yarn_softmax_scale)
from tests import plain_mla_moe as P

# Kimi-K2-Instruct's rope_scaling
KIMI_YARN = Yarn(factor=32.0, original_max=4096, beta_fast=1.0,
                 beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0)
TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
SEED = 2 ** 31 + 7


def _cfg(**kw) -> ModelConfig:
    """Tiny widths, Kimi-K2's mechanisms and its rope scaling: a dense
    layer, then two expert layers of 16 experts, top 4, one shared."""
    base = dict(
        name="tiny-mla-moe", family="moe", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=96, vocab=128, d_head=16,
        n_experts=16, top_k=4, moe_d_ff=32, n_shared_experts=1,
        capacity_factor=4.0, router_score="sigmoid", routed_scale=2.827, first_dense_layers=1, q_lora_rank=32,
        kv_lora_rank=16, qk_rope_dim=8, v_head_dim=16, rope_yarn=KIMI_YARN,
        rope_theta=50000.0, norm_eps=1e-6, dtype=torch.float32,
        param_dtype=torch.float32)
    base.update(kw)
    return ModelConfig(**base)


def _sizes(cfg: ModelConfig) -> P.Sizes:
    y = cfg.rope_yarn
    return P.Sizes(
        d=cfg.d_model, n_heads=cfg.n_heads, q_lora=cfg.q_lora_rank,
        kv_lora=cfg.kv_lora_rank, d_nope=cfg.d_head, d_rope=cfg.qk_rope_dim,
        d_v=cfg.v_head_dim, vocab=cfg.vocab, n_layers=cfg.n_layers,
        first_dense=cfg.first_dense_layers, d_ff=cfg.d_ff,
        d_expert=cfg.moe_d_ff, n_experts=cfg.n_experts, top_k=cfg.top_k,
        n_shared=cfg.n_shared_experts, routed_scale=cfg.routed_scale,
        rope_theta=cfg.rope_theta, yarn_factor=y.factor,
        yarn_original_max=y.original_max, yarn_beta_fast=y.beta_fast,
        yarn_beta_slow=y.beta_slow, yarn_mscale=y.mscale,
        yarn_mscale_all_dim=y.mscale_all_dim, eps=cfg.norm_eps)


def _model(cfg, use_kernels=False, seed=SEED):
    """The port's model with seeded weights; the selection bias drawn
    N(0, 0.1^2) so that it reorders some selections."""
    g = torch.Generator().manual_seed(seed)
    model = build_model(cfg, use_kernels=use_kernels, device="cpu").init(g)
    with torch.no_grad():
        for blk in model.blocks:
            if hasattr(blk, "moe"):
                blk.moe["router_bias"].normal_(0.0, 0.1, generator=g)
    return model


def _plain_weights(model):
    """The port's weights as the plain reference names them."""
    st = dict(model.state_dict())
    outer = {n: st[n] for n in ("embed", "final_norm", "lm_head")}
    layers = []
    for i in range(model.cfg.n_layers):
        pre = f"blocks.{i}."
        layers.append({k[len(pre):]: v for k, v in st.items()
                       if k.startswith(pre)})
    return outer, layers


def _tokens(B, S, vocab, seed=3):
    return torch.randint(0, vocab, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _held(cfg):
    return range(cfg.experts_first, cfg.experts_first + cfg.n_held)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("held,first", [(0, 0), (4, 8)])
def test_prefill_logits_match_the_plain_forward(use_kernels, held, first):
    cfg = _cfg(experts_held=held, experts_first=first)
    model = _model(cfg, use_kernels)
    outer, layers = _plain_weights(model)
    toks = _tokens(2, 24, cfg.vocab)
    with torch.no_grad():
        logits, cache = model.prefill(toks, 24 + 1)
    assert cache.ckv.shape == (3, 2, 25, 16 + 8)
    assert cache.length.tolist() == [24] * 3
    for b in range(2):
        want = P.forward(_sizes(cfg), outer, layers, toks[b], _held(cfg))
        torch.testing.assert_close(logits[b, -1], want[-1], **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_through_the_latent_cache_matches_the_full_forward(
        use_kernels):
    cfg = _cfg(experts_held=8, experts_first=0)
    model = _model(cfg, use_kernels)
    outer, layers = _plain_weights(model)
    P0, steps = 20, 4
    toks = _tokens(2, P0 + steps, cfg.vocab, seed=4)
    with torch.no_grad():
        logits, cache = model.prefill(toks[:, :P0], P0 + steps)
        got = [logits[:, -1]]
        for j in range(steps):
            step, cache = model.decode_step(cache, toks[:, P0 + j:P0 + j + 1])
            got.append(step[:, 0])
    assert cache.length.tolist() == [P0 + steps] * cfg.n_layers
    for b in range(2):
        want = P.forward(_sizes(cfg), outer, layers, toks[b], _held(cfg))
        # the prefill's last position, then each step's token's
        for j, g in enumerate(got):
            torch.testing.assert_close(g[b], want[P0 - 1 + j], **TOL)


def test_yarn_frequencies_and_softmax_scale_are_kimis():
    """rope dim 64: frequency i is 50000^(-2i/64) for i < 20 and that over
    32 for i >= 20 (the correction range is floor / ceil of 64 ln(4096 /
    2 pi) / (2 ln 50000) = 19.16); cos and sin unscaled (mscale /
    mscale_all_dim = 1); s = 192^-0.5 (0.1 ln 32 + 1)^2 = 0.1308608."""
    corr = 64 * math.log(4096 / (2 * math.pi)) / (2 * math.log(50000))
    assert corr == pytest.approx(19.16, abs=0.005)
    want = np.array([50000.0 ** (-2 * i / 64) / (32 if i >= 20 else 1)
                     for i in range(32)])
    freqs, m = yarn_freqs(64, 50000.0, KIMI_YARN)
    np.testing.assert_allclose(freqs, want, rtol=1e-12)
    assert m == 1.0
    s = yarn_softmax_scale(192, KIMI_YARN)
    assert s == pytest.approx(0.1308608, rel=1e-6)
    a = _sizes(_cfg(qk_rope_dim=64, d_head=128))
    np.testing.assert_allclose(P.yarn(a)[0], want, rtol=1e-12)
    assert P.softmax_scale(a) == pytest.approx(0.1308608, rel=1e-6)


def test_bias_selects_and_never_weighs():
    cfg = _cfg()
    model = _model(cfg)
    p = model.blocks[1].moe
    x = torch.randn(256, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    with torch.no_grad():
        s, gate, idx = M._route(x, p["router"], cfg.top_k, p["router_bias"],
                                True, cfg.routed_scale)
        _, gate0, idx0 = M._route(x, p["router"], cfg.top_k, None, True,
                                  cfg.routed_scale)
    # the bias changes some selections
    assert (idx.sort(-1).values != idx0.sort(-1).values).any(-1).sum() > 10
    # the gates are the unbiased scores of the chosen experts
    chosen = torch.gather(s, 1, idx)
    want = chosen / chosen.sum(-1, keepdim=True) * cfg.routed_scale
    torch.testing.assert_close(gate, want, **LAYER_TOL)
    torch.testing.assert_close(gate.sum(-1), torch.full((256,), 2.827),
                               **LAYER_TOL)
    # a gate planted from s + b is not the program's
    biased = torch.gather(s + p["router_bias"], 1, idx)
    planted = biased / biased.sum(-1, keepdim=True) * cfg.routed_scale
    assert not torch.allclose(gate, planted, **LAYER_TOL)
    # and the plain reference routes as the port does
    pg, pidx = P.route(x, {"moe.router": p["router"],
                           "moe.router_bias": p["router_bias"]},
                       _sizes(cfg))
    assert torch.equal(pidx, idx)
    torch.testing.assert_close(pg, gate, **LAYER_TOL)


def _share_params(full, first, n):
    out = {k: v for k, v in full.items()}
    for w in ("w1", "w3", "w2"):
        out[w] = full[w][first:first + n]
    return out


@pytest.mark.parametrize("route", ["einsum", "k5", "routed"])
@pytest.mark.parametrize("B,S", [(2, 64), (3, 1)])  # grouped, flat
def test_the_shares_add_up_to_the_uncut_layer(route, B, S, monkeypatch):
    """Four shares of 4 experts: each share's output is the plain
    reference's for that share; their sum, with the shared expert that
    every share adds counted once, is the uncut layer's. ``routed``: the
    CPU stands in for K5's device, so the grouped dispatch packs each held
    expert's routed rows (K5 as its plain version), as on the card."""
    use_kernels = route != "einsum"
    if route == "routed":
        monkeypatch.setattr(M, "_KERNEL_DEVICE", "cpu")
    cfg = _cfg()
    model = _model(cfg)
    full = {k: v.detach() for k, v in model.blocks[1].moe.items()}
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(7))
    a = _sizes(cfg)
    with torch.no_grad():
        uncut, _ = M.moe_ffn(full, x, cfg, use_kernels)
        parts = []
        for first in range(0, 16, 4):
            c = dataclasses.replace(cfg, experts_held=4, experts_first=first)
            y, _ = M.moe_ffn(_share_params(full, first, 4), x, c,
                             use_kernels)
            want = P.experts(x.reshape(-1, cfg.d_model),
                             {f"moe.{k}": v for k, v in
                              _share_params(full, first, 4).items()},
                             a, range(first, first + 4))
            torch.testing.assert_close(y.reshape(-1, cfg.d_model), want,
                                       **LAYER_TOL)
            parts.append(y)
        shared = P.swiglu(x.reshape(-1, cfg.d_model), full["shared_w1"],
                          full["shared_w3"], full["shared_w2"])
    total = sum(parts).reshape(-1, cfg.d_model) - 3 * shared
    torch.testing.assert_close(total, uncut.reshape(-1, cfg.d_model),
                               **LAYER_TOL)
    whole = P.experts(x.reshape(-1, cfg.d_model),
                      {f"moe.{k}": v for k, v in full.items()}, a, range(16))
    torch.testing.assert_close(uncut.reshape(-1, cfg.d_model), whole,
                               **LAYER_TOL)


def test_the_leading_layer_is_dense():
    cfg = _cfg()
    model = _model(cfg)
    assert hasattr(model.blocks[0], "ffn") and not hasattr(
        model.blocks[0], "moe")
    assert all(hasattr(b, "moe") and not hasattr(b, "ffn")
               for b in model.blocks[1:])
    assert model.blocks[0].ffn["w1"].shape == (64, 96)
    assert model.blocks[1].moe["w1"].shape == (16, 64, 32)
    outer, layers = _plain_weights(model)
    from repro_torch.models.transformer import block_train
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(8))
    with torch.no_grad():
        y, _, lat = block_train(model.blocks[0], x, cfg, return_kv=True)
    assert lat.shape == (2, 12, 24)
    for b in range(2):
        want = P.block(x[b], layers[0], _sizes(cfg), 0, range(16))
        torch.testing.assert_close(y[b], want, **LAYER_TOL)


@pytest.mark.parametrize("B,S", [(2, 64), (4, 1)])
def test_kept_and_assigned_under_a_share(B, S):
    cfg = _cfg(experts_held=4, experts_first=4)
    model = _model(cfg)
    p = {k: v.detach() for k, v in model.blocks[1].moe.items()}
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(9))
    _, _, idx = M._route(x.reshape(-1, cfg.d_model), p["router"], cfg.top_k,
                         p["router_bias"], True, cfg.routed_scale)
    held = int(((idx >= 4) & (idx < 8)).sum())
    assert 0 < held < idx.numel()
    from torch.profiler import ProfilerActivity, profile
    spans.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        M.moe_ffn(p, x, cfg)
    c = spans.collected()["counters"]
    spans.clear()
    # dropless over the held experts: every held assignment kept
    assert c["moe.assigned"] == B * S * cfg.top_k
    assert c["moe.kept"] == held
    # the buffers hold the 4 held experts' slots
    assert c["moe.rows"] % 4 == 0


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_at_unequal_widths(causal):
    """q/k 24 against v 16, GQA 2:1: the plain version (what the wrapper
    runs on CPU tensors) against the textbook computation."""
    g = torch.Generator().manual_seed(10)
    q = torch.randn(2, 4, 9, 24, generator=g)
    k = torch.randn(2, 2, 13, 24, generator=g)
    v = torch.randn(2, 2, 13, 16, generator=g)
    got = fa.flash_attention(q, k, v, causal=causal, scale=0.3)
    assert got.shape == (2, 4, 9, 16)
    kk, vv = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
    s = q @ kk.transpose(-1, -2) * 0.3
    if causal:  # queries aligned to the end of the keys
        qpos = torch.arange(9)[:, None] + 4
        s = s.masked_fill(torch.arange(13)[None, :] > qpos, float("-inf"))
    want = torch.softmax(s, -1) @ vv
    torch.testing.assert_close(got, want, **LAYER_TOL)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, k, v[..., :8, :])
