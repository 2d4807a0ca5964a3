"""RWKV6 ("Finch", arXiv:2404.05892) time mix and channel mix.

A copy of the RWKV6 half of ``repro/models/ssm.py`` in PyTorch:
data-dependent-decay linear attention whose per-head state is a
(d_head × d_head) matrix. The parameters are the reference's, in its
shapes (``mu`` [5, d], ``shift_lora_b`` [32, 5, d], ``u`` [H, dh], …), so a
reference tree carries across as a plain copy. As in the reference, the
five ddlerp token-shift mixes share one LoRA and the output groupnorm is a
per-head RMS norm; the recurrence itself is exact.

``rwkv_time_mix_train(..., use_kernel=True)`` runs the scan through K4
(:mod:`repro_torch.kernels.rwkv_scan`); ``use_kernel=False`` is the
reference's per-token recurrence, :func:`rwkv_recurrence` (K4's plain
version). Both compute the same function. The Mamba half of the
reference module belongs to the hybrid family, which the port has not
reached.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv_scan import rwkv_scan, rwkv_scan_plain

from .common import ModelConfig, dense_init

LORA_DIM = 32


def _heads(cfg: ModelConfig):
    return cfg.n_heads_padded, cfg.d_model // cfg.n_heads_padded


def token_shift(x):
    """x delayed by one position, zero first: [B,S,d] -> [B,S,d]."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def init_rwkv_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dt, dev = cfg.d_model, cfg.param_dtype, gen.device
    H, dh = _heads(cfg)
    return {
        "mu": torch.full((5, d), 0.5, dtype=dt, device=dev),  # r,k,v,w,g lerp
        "shift_lora_a": dense_init(gen, d, (d, LORA_DIM), dt),
        "shift_lora_b": dense_init(gen, LORA_DIM, (LORA_DIM, 5, d), dt),
        "wr": dense_init(gen, d, (d, d), dt),
        "wk": dense_init(gen, d, (d, d), dt),
        "wv": dense_init(gen, d, (d, d), dt),
        "wg": dense_init(gen, d, (d, d), dt),
        "wo": dense_init(gen, d, (d, d), dt),
        "w0": torch.full((d,), -0.5, dtype=dt, device=dev),  # decay logit
        "w_lora_a": dense_init(gen, d, (d, LORA_DIM), dt),
        "w_lora_b": dense_init(gen, LORA_DIM, (LORA_DIM, d), dt),
        "u": dense_init(gen, dh, (H, dh), dt),  # bonus
        "ln_out": torch.ones((d,), dtype=dt, device=dev),
    }


def _rwkv_inputs(params, x, x_prev, cfg: ModelConfig):
    """Token-shift ddlerp, then the projections to r, k, v, w, g. x: [B,S,d].
    r, k, v, g are in x's dtype, w = exp(-exp(logit)) in float32."""
    H, dh = _heads(cfg)
    xx = x_prev - x
    mix0 = x + xx * params["mu"][3]  # seed mix (reuses w's mu)
    delta = torch.einsum("bsl,lkd->bskd",
                         torch.tanh(mix0 @ params["shift_lora_a"]),
                         params["shift_lora_b"])  # [B,S,5,d]
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (params["mu"][None, None]
                                                     + delta)
    xr, xk, xv, xw, xg = mixed.unbind(2)

    B, S = x.shape[:2]
    r = (xr @ params["wr"]).reshape(B, S, H, dh)
    k = (xk @ params["wk"]).reshape(B, S, H, dh)
    v = (xv @ params["wv"]).reshape(B, S, H, dh)
    g = F.silu(xg @ params["wg"])
    w_logit = params["w0"] + torch.tanh(xw @ params["w_lora_a"]) \
        @ params["w_lora_b"]
    w = torch.exp(-torch.exp(w_logit.float())).reshape(B, S, H, dh)
    return r, k, v, w, g


# the reference's exact RWKV6 recurrence, one step per token (the plain
# route): r, k, v, w [B,S,H,dh]; u [H,dh]; state [B,H,dh,dh] key-major.
# Returns out [B,S,H,dh], final state.
rwkv_recurrence = rwkv_scan_plain


def _rwkv_out(params, wkv, g, cfg: ModelConfig):
    B, S = g.shape[:2]
    d = cfg.d_model
    y = wkv.reshape(B, S, d).float()
    # per-head rmsnorm stand-in for groupnorm
    yh = y.reshape(B, S, wkv.shape[2], -1)
    yh = yh * torch.rsqrt(torch.mean(yh * yh, dim=-1, keepdim=True) + 1e-5)
    y = yh.reshape(B, S, d) * params["ln_out"].float()
    return (y.to(g.dtype) * g) @ params["wo"]


def rwkv_time_mix_scan(params, x, cfg: ModelConfig, use_kernel: bool):
    """The time mix over a full sequence from a zero state, returning
    (y, final state [B,H,dh,dh] float32), as the reference's ssm prefill
    computes them. The scan is in float32: K4 reads r, k and v in x's dtype
    (bf16 -> float32 is exact), the plain route casts them first."""
    r, k, v, w, g = _rwkv_inputs(params, x, token_shift(x), cfg)
    u = params["u"].float()
    if use_kernel:
        wkv, state = rwkv_scan(r, k, v, w, u, return_state=True)
    else:
        wkv, state = rwkv_recurrence(r.float(), k.float(), v.float(), w, u)
    return _rwkv_out(params, wkv.to(x.dtype), g, cfg), state


def rwkv_time_mix_train(params, x, cfg: ModelConfig, use_kernel: bool = False):
    return rwkv_time_mix_scan(params, x, cfg, use_kernel)[0]


class RWKVState(NamedTuple):
    shift: torch.Tensor     # [B, d] last token (time mix)
    shift_cm: torch.Tensor  # [B, d] last token (channel mix)
    S: torch.Tensor         # [B, H, dh, dh] float32


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> RWKVState:
    H, dh = _heads(cfg)
    d = cfg.d_model
    return RWKVState(
        shift=torch.zeros((batch, d), dtype=cfg.dtype, device=device),
        shift_cm=torch.zeros((batch, d), dtype=cfg.dtype, device=device),
        S=torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device))


def rwkv_time_mix_decode(params, x, state: RWKVState, cfg: ModelConfig):
    """x: [B, 1, d] one token. Returns (y, the new state); ``state`` is
    left as it was."""
    x_prev = state.shift[:, None, :]
    r, k, v, w, g = _rwkv_inputs(params, x, x_prev, cfg)
    u = params["u"].float()
    r1, k1, v1, w1 = (t[:, 0].float() for t in (r, k, v, w))
    kv = k1[..., :, None] * v1[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", r1,
                       state.S + u[None, :, :, None] * kv)
    S_new = w1[..., None] * state.S + kv
    y = _rwkv_out(params, out[:, None].to(x.dtype), g, cfg)
    return y, state._replace(shift=x[:, 0], S=S_new)


# --- RWKV channel mix (replaces the FFN in rwkv blocks) ----------------

def init_rwkv_cm_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dt, device=gen.device),
        "wk": dense_init(gen, d, (d, f), dt),
        "wv": dense_init(gen, f, (f, d), dt),
    }


def rwkv_channel_mix(params, x, x_prev):
    xk = x + (x_prev - x) * params["mu_k"]
    h = torch.square(F.relu(xk @ params["wk"]))
    return h @ params["wv"]
