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

With K5 on as a kernel on one device the grouped dispatch packs routed
rows, expert by expert in 128-row segments, where that takes fewer row
tiles at worst (``_routed``). K5 is a kernel only on the card; here the
CPU stands in for its device (``k5_device``), K5 running its plain
version, so that the routed path runs as on the card: the cases above at 2 x 64 tokens take it (``dropped`` 0,
the tied router's empty experts, the dense oracle), 16 groups of 9 tokens
keep the capacity slots, and a dropping capacity runs it forced (its rule
never picks it there), to hold the same tokens dropped. The choice itself
follows the shapes: mixtral's prefill batch takes it; a DTensor on a 1×1
mesh and many experts with few tokens each keep the capacity slots; and
on the CPU, where K5 is its plain version only, every shape keeps them.

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
from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.models import moe as M
from repro_torch.models.common import use_mesh
from repro_torch.models.convert import model_config_from_reference, to_tensor

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("mixtral-8x22b", "kimi-k2-1t-a32b")
# the cases of test_moe_matches_reference that K5 runs on routed rows
ROUTED = {("moe_ffn_grouped", 2, 64), ("moe_ffn", 2, 64)}


@pytest.fixture
def k5_device(monkeypatch):
    """The CPU as the device on which K5 is a kernel, so that the grouped
    dispatch may choose routed rows here (K5 runs its plain version)."""
    monkeypatch.setattr(M, "_KERNEL_DEVICE", "cpu")


@pytest.fixture
def packed(monkeypatch, k5_device):
    """The routed buffers' segment starts (tiles), one entry a routed
    dispatch, with the CPU as K5's device."""
    seen, pack = [], M._pack_routed

    def spy(E, C, K):
        def run(*args):
            out = pack(E, C, K)(*args)
            seen.append(out[2].tolist())
            return out
        return run
    monkeypatch.setattr(M, "_pack_routed", spy)
    return seen


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
    ("moe_ffn_grouped", 3, 48),   # 16 groups of 9: capacity slots
])
def test_moe_matches_reference(fn, B, S, arch, use_kernels, packed):
    ref_cfg, cfg, params = _setup(arch)
    got_y, got_aux, want_y, want_aux = _both(fn, ref_cfg, cfg, params,
                                             _x(cfg, B, S), use_kernels)
    _close(got_y, got_aux, want_y, want_aux)
    if (fn, B, S) == ("moe_ffn_grouped", 2, 64):  # groups of 4, C = 8
        assert want_aux["dropped"] == 0.0
    assert bool(packed) == (use_kernels and (fn, B, S) in ROUTED)


@pytest.mark.parametrize("fn", ["moe_ffn_flat", "moe_ffn_grouped", "routed"])
def test_moe_capacity_drops_match_reference(fn, packed, monkeypatch):
    ref_cfg, cfg, params = _setup("mixtral-8x22b", capacity_factor=0.5)
    if fn == "routed":  # the grouped dispatch on routed rows, forced
        monkeypatch.setattr(M, "_routed", lambda *args: True)
        fn = "moe_ffn_grouped"
    # 4 groups of 25 tokens, C = 8 (grouped), or one of 100, C = 32
    # (flat): about 12.5 or 50 assignments per expert
    got_y, got_aux, want_y, want_aux = _both(fn, ref_cfg, cfg, params,
                                             _x(cfg, 2, 50, seed=7), True)
    assert want_aux["dropped"] > 0.1
    _close(got_y, got_aux, want_y, want_aux)
    if packed:  # at most C = 8 kept an expert a group: 4 * 8 = 32 rows
        assert packed == [[0, 1, 2, 3, 4]]


@pytest.mark.parametrize("fn", ["moe_ffn_flat", "moe_ffn_grouped"])
def test_all_tied_router_picks_lowest_experts(fn, packed):
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
    if fn == "moe_ffn_grouped":  # 128 rows each on 0 and 1, 2.. empty
        assert packed == [[0, 1, 2] + [2] * (cfg.n_experts - 2)]


@pytest.mark.parametrize("fn", ["moe_ffn_flat", "moe_ffn_grouped"])
def test_ample_capacity_equals_dense_oracle(fn, packed):
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
    assert bool(packed) == (fn == "moe_ffn_grouped")


def test_capacity_and_groups_match_reference():
    ref_cfg = ref_get_config("mixtral-8x22b")
    cfg = model_config_from_reference(ref_cfg)
    for T in (1, 4, 8, 100, 256, 4095, 4096, 8188, 8192, 65536):
        assert M.expert_capacity(T, cfg) == RM.expert_capacity(T, ref_cfg)
        assert M._pick_groups(T) == RM._pick_groups(T)


def _rows(cfg, B, S, mesh=None, seed=4):
    """``moe.rows`` and the capacity slots E*G*C of one ``moe_ffn`` with
    K5 on, at d = 16."""
    g = torch.Generator().manual_seed(0)
    params = {n: torch.empty(sh, dtype=dt)
              for n, (sh, dt) in M.moe_param_shapes(cfg).items()}
    M.init_moe_params(g, cfg, params)
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(seed))
    spans.clear()
    with torch.no_grad(), use_mesh(mesh), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        M.moe_ffn(params, x, cfg, use_kernels=True)
    rows = spans.collected()["counters"]["moe.rows"]
    spans.clear()
    T = B * S
    G = M._pick_groups(T)
    return rows, cfg.n_experts * G * M.expert_capacity(T // G, cfg)


def test_routed_mode_follows_the_shapes(k5_device):
    """mixtral's prefill batch (8192 tokens in 32 groups, 8 experts top-2,
    capacity 4: C 256) takes the routed rows, 136 row tiles at worst
    against 512; a DTensor on a 1×1 mesh keeps the capacity slots; so do
    384 experts top-8 over 8192 tokens (C 8: 768 tiles against 896)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    mixtral = dataclasses.replace(get_config("mixtral-8x22b"), d_model=16,
                                  moe_d_ff=16, capacity_factor=4.0,
                                  dtype=torch.float32,
                                  param_dtype=torch.float32)
    assert M._routed(torch.zeros(1), 16384, 8, 32 * 256, True)
    assert not M._routed(torch.zeros(1), 16384, 8, 32 * 256, False)
    rows, slots = _rows(mixtral, 8, 1024)
    assert slots == 65536 and rows <= 16384 + 8 * 127 and rows % 128 == 0
    many = dataclasses.replace(mixtral, n_experts=384, top_k=8,
                               capacity_factor=1.25)
    assert _rows(many, 8, 1024) == (384 * 32 * 8,) * 2
    # off a mesh these 4 experts would take routed rows (20 tiles, not 64)
    small = dataclasses.replace(mixtral, n_experts=4)
    assert M._routed(torch.zeros(1), 2048, 4, 32 * 64, True)
    assert not dist.is_initialized()
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        rows, slots = _rows(small, 2, 512, mesh)
    finally:
        dist.destroy_process_group()
    assert rows == slots == 4 * 32 * 64


@pytest.mark.parametrize("B,S", [(2, 64), (8, 1024)])
def test_cpu_keeps_the_capacity_slots(B, S):
    """Off K5's device (here the CPU, where K5 is its plain version) the
    grouped dispatch keeps the capacity slots with K5 on, at shapes that
    take routed rows on the card: 128 tokens in 32 groups over 4 experts
    (6 row tiles at worst against 8) and mixtral's prefill batch."""
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), d_model=16,
                              moe_d_ff=16, capacity_factor=4.0,
                              dtype=torch.float32, param_dtype=torch.float32)
    if B == 2:
        cfg = dataclasses.replace(cfg, n_experts=4, capacity_factor=2.0)
    T, K, E = B * S, cfg.top_k, cfg.n_experts
    G = M._pick_groups(T)
    C = M.expert_capacity(T // G, cfg)
    assert -(-T * K // 128) + E < E * -(-G * C // 128)  # routed on the card
    assert M._KERNEL_DEVICE != "cpu"
    assert not M._routed(torch.zeros(1), T * K, E, G * C, True)
    rows, slots = _rows(cfg, B, S)
    assert rows == slots == E * G * C
