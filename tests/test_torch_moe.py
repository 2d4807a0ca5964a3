"""The port's MoE layer (``repro_torch.models.moe``) against the JAX package.

The reference's own weights (``repro.models.moe.init_moe_params`` from a
PRNG key) carry across as tensors, and the inputs are made from a seed
with NumPy, so both sides compute on the same numbers:

* ``moe_ffn_flat``, ``moe_ffn_grouped`` and ``moe_ffn`` (its adaptive
  choice: grouped at 128 tokens, flat at 3) on the reduced mixtral-8x22b
  and kimi-k2-1t-a32b configs (the latter with its shared expert), on both
  of the port's routes (K5, whose wrapper runs its plain version on CPU
  tensors, and the einsum route): ``y`` and both aux values (``lb_loss``,
  ``dropped``) in float32 within atol = rtol = 1e-5 (the two sides differ
  only in float32 summation order);
* a capacity that drops (capacity factor 0.5, as the reference's
  ``test_moe_capacity_drops_bounded``): the same tokens dropped;
* a router of zero weights, where every probability ties: both packages
  pick experts 0..K-1 (``jax.lax.top_k``'s tie rule);
* at ample capacity, the port against a dense oracle (every token's
  gate-weighted sum of its top-k experts, the reference's own property).

The whole mixtral and kimi models are held to the reference in
tests/test_torch_models.py.
"""
import jax
import jax.experimental

# this jax names the x64 context manager jax.enable_x64; the reference
# kernels import it from jax.experimental. Set here so this file does not
# depend on collection order.
jax.experimental.enable_x64 = jax.enable_x64

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as RM
from repro_torch.models import moe as M
from repro_torch.models.convert import model_config_from_reference, to_tensor

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("mixtral-8x22b", "kimi-k2-1t-a32b")


def _setup(arch, **overrides):
    ref_cfg = dataclasses.replace(ref_get_config(arch, reduced=True),
                                  **overrides)
    params = jax.tree_util.tree_map(
        np.asarray, RM.init_moe_params(jax.random.PRNGKey(0), ref_cfg))
    return ref_cfg, model_config_from_reference(ref_cfg), params


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)


def _both(fn, ref_cfg, cfg, params, x, use_kernels):
    want_y, want_aux = getattr(RM, fn)(params, jnp.asarray(x), ref_cfg)
    tp = {n: to_tensor(a) for n, a in params.items()}
    with torch.no_grad():
        got_y, got_aux = getattr(M, fn)(tp, torch.from_numpy(x), cfg,
                                        use_kernels=use_kernels)
    return (got_y.numpy(), {k: float(v) for k, v in got_aux.items()},
            np.asarray(want_y), {k: float(v) for k, v in want_aux.items()})


def _close(got_y, got_aux, want_y, want_aux):
    np.testing.assert_allclose(got_y, want_y, **TOL)
    assert set(got_aux) == set(want_aux) == {"lb_loss", "dropped"}
    for name in want_aux:
        np.testing.assert_allclose(got_aux[name], want_aux[name], **TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fn,B,S", [
    ("moe_ffn_flat", 2, 64),
    ("moe_ffn_grouped", 2, 64),   # 32 groups of 4 tokens
    ("moe_ffn", 2, 64),           # picks grouped
    ("moe_ffn", 3, 1),            # decode shape: picks flat
])
def test_moe_matches_reference(fn, B, S, arch, use_kernels):
    ref_cfg, cfg, params = _setup(arch)
    got_y, got_aux, want_y, want_aux = _both(fn, ref_cfg, cfg, params,
                                             _x(cfg, B, S), use_kernels)
    _close(got_y, got_aux, want_y, want_aux)
    if fn == "moe_ffn_grouped":  # groups of 4 tokens, C = 8: no drops
        assert want_aux["dropped"] == 0.0


@pytest.mark.parametrize("fn", ["moe_ffn_flat", "moe_ffn_grouped"])
def test_moe_capacity_drops_match_reference(fn):
    ref_cfg, cfg, params = _setup("mixtral-8x22b", capacity_factor=0.5)
    # 4 groups of 25 tokens, C = 8 (grouped), or one of 100, C = 32
    # (flat): about 12.5 or 50 assignments per expert
    got_y, got_aux, want_y, want_aux = _both(fn, ref_cfg, cfg, params,
                                             _x(cfg, 2, 50, seed=7), True)
    assert want_aux["dropped"] > 0.1
    _close(got_y, got_aux, want_y, want_aux)


@pytest.mark.parametrize("fn", ["moe_ffn_flat", "moe_ffn_grouped"])
def test_all_tied_router_picks_lowest_experts(fn):
    ref_cfg, cfg, params = _setup("kimi-k2-1t-a32b")
    params["router"] = np.zeros_like(params["router"])
    x = _x(cfg, 2, 64, seed=3)
    probs = torch.full((3, cfg.n_experts), 1.0 / cfg.n_experts)
    _, idx = M._top_k(probs, cfg.top_k)
    want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.top_k)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(idx.numpy(),
                                  np.tile(np.arange(cfg.top_k), (3, 1)))
    # every token on experts 0 and 1 only: the others get nothing
    got_y, got_aux, want_y, want_aux = _both(fn, ref_cfg, cfg, params, x,
                                             True)
    _close(got_y, got_aux, want_y, want_aux)


@pytest.mark.parametrize("fn", ["moe_ffn_flat", "moe_ffn_grouped"])
def test_ample_capacity_equals_dense_oracle(fn):
    _, cfg, params = _setup("mixtral-8x22b", capacity_factor=4.0)
    x = _x(cfg, 2, 64, seed=5)
    p = {n: to_tensor(a) for n, a in params.items()}
    with torch.no_grad():
        y, aux = getattr(M, fn)(p, torch.from_numpy(x), cfg, use_kernels=True)
        xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
        probs = torch.softmax(xt @ p["router"], -1)
        gate, idx = torch.topk(probs, cfg.top_k)
        gate = gate / gate.sum(-1, keepdim=True)
        h = (torch.nn.functional.silu(torch.einsum("td,edf->tef", xt, p["w1"]))
             * torch.einsum("td,edf->tef", xt, p["w3"]))
        w = torch.zeros_like(probs).scatter_(1, idx, gate)
        oracle = torch.einsum("tef,efd,te->td", h, p["w2"], w)
    assert float(aux["dropped"]) == 0.0
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(),
                               oracle.numpy(), atol=1e-4, rtol=1e-4)


def test_capacity_and_groups_match_reference():
    ref_cfg = ref_get_config("mixtral-8x22b")
    cfg = model_config_from_reference(ref_cfg)
    for T in (1, 4, 8, 100, 256, 4095, 4096, 8188, 8192, 65536):
        assert M.expert_capacity(T, cfg) == RM.expert_capacity(T, ref_cfg)
        assert M._pick_groups(T) == RM._pick_groups(T)
