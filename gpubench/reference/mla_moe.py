"""Plain reference of the mla_moe family (Kimi-K2-Instruct's
architecture), from the benchmark's seeded weights, one prompt at a time.

The equations are ``tests/plain_mla_moe.py``'s, which states them and
where they depart from the published modelling code: pre-norm blocks of
latent attention (the low-rank q and kv paths with their RMSNorms, YaRN
rope on q's rope part and the one rope key a token, split-half rotation,
the softmax scale d_qk^-0.5 mscale^2, causal) and a SwiGLU FFN (the
leading dense layers) or the experts: sigmoid scores over every expert,
the top_k of score plus the selection bias (ties to the lower index),
gates the chosen scores normalised times the routed scale; the held
share's experts computed for the tokens routed to them, the others' terms
left out, the shared expert added; the final RMSNorm and the head.

Everything is float32 on the weights' bf16 values (TF32 off). Attention
runs in blocks of ``BLOCK`` queries against the keys up to the block's
last, so that a 16,384-token prompt's scores fit. With
``precision="fp8"`` every product's operands, the contraction's too, are
rounded to float8_e4m3fn first (the decoder family's rounding; the
router stays float32): the control that a lower precision has to fail.

There is no training cell of this family: :func:`train` raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.arch import mla_moe as arch
from gpubench.arch.mla_moe import Arch
from gpubench.core import weights as W
from gpubench.reference.decoder import mm, rmsnorm

BLOCK = 512  # queries a block: [64, 512, 16384] float32 scores are 2.1 GB


def _mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn(a: Arch):
    """(the rope's frequencies [d_rope / 2] float64, the factor on cos and
    sin)."""
    factor, original, fast, slow, m, m_all = a.yarn
    dr, theta = a.d_rope, a.rope_theta

    def corr(b):
        return dr * math.log(original / (b * 2 * math.pi)) / (
            2 * math.log(theta))
    lo = max(math.floor(corr(fast)), 0)
    hi = min(math.ceil(corr(slow)), dr - 1)
    if lo == hi:
        hi += 0.001
    base = 1.0 / theta ** (np.arange(0, dr, 2, dtype=np.float64) / dr)
    ramp = np.clip((np.arange(dr // 2) - lo) / (hi - lo), 0.0, 1.0)
    return (base / factor * ramp + base * (1.0 - ramp),
            _mscale(factor, m) / _mscale(factor, m_all))


def softmax_scale(a: Arch) -> float:
    factor, m_all = a.yarn[0], a.yarn[5]
    s = a.d_qk ** -0.5
    return s * _mscale(factor, m_all) ** 2 if m_all else s


def rope(x, a: Arch):
    """x [T, ..., d_rope] -> rotated (split halves), position t at row t."""
    T = x.shape[0]
    freqs, m = yarn(a)
    ang = np.arange(T, dtype=np.float64)[:, None] * freqs[None, :]
    shape = (T,) + (1,) * (x.dim() - 2) + (freqs.shape[0],)
    cos = torch.as_tensor(np.cos(ang) * m, dtype=torch.float32,
                          device=x.device).view(shape)
    sin = torch.as_tensor(np.sin(ang) * m, dtype=torch.float32,
                          device=x.device).view(shape)
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(x, p, a: Arch, precision: str):
    """x [T, d] float32 -> [T, d]."""
    T = x.shape[0]
    H, dn, dv, c = a.n_heads, a.d_nope, a.d_v, a.kv_lora
    cq = rmsnorm(mm(x, p["attn.wq_a"].float(), precision), p["attn.q_norm"],
                 a.norm_eps)
    q = mm(cq, p["attn.wq_b"].float().reshape(a.q_lora, -1),
           precision).view(T, H, a.d_qk)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], a)], dim=-1)
    kv = mm(x, p["attn.wkv_a"].float(), precision)
    lat = rmsnorm(kv[:, :c], p["attn.kv_norm"], a.norm_eps)
    k_pe = rope(kv[:, c:], a)
    kvb = mm(lat, p["attn.wkv_b"].float().reshape(c, -1),
             precision).view(T, H, dn + dv)
    k = torch.cat([kvb[..., :dn], k_pe[:, None].expand(T, H, a.d_rope)],
                  dim=-1).transpose(0, 1)                    # [H, T, d_qk]
    v = kvb[..., dn:].transpose(0, 1)                        # [H, T, d_v]
    q = q.transpose(0, 1)
    del kv, kvb
    scale = softmax_scale(a)
    out = torch.empty((H, T, dv), dtype=torch.float32, device=x.device)
    for q0 in range(0, T, BLOCK):
        q1 = min(q0 + BLOCK, T)
        s = mm(q[:, q0:q1], k[:, :q1].transpose(-1, -2), precision) * scale
        qpos = torch.arange(q0, q1, device=x.device)[:, None]
        s = s.masked_fill(torch.arange(q1, device=x.device)[None, :] > qpos,
                          float("-inf"))
        out[:, q0:q1] = mm(torch.softmax(s, dim=-1), v[:, :q1], precision)
        del s
    o = out.transpose(0, 1).reshape(T, H * dv)
    return mm(o, p["attn.wo"].float().reshape(H * dv, -1), precision)


def swiglu(x, w1, w3, w2, precision: str):
    return mm(F.silu(mm(x, w1.float(), precision)) * mm(x, w3.float(),
                                                        precision),
              w2.float(), precision)


def route(x, p, a: Arch):
    """x [T, d] -> gate [T, top_k], expert [T, top_k] (ids over every
    expert routed over)."""
    s = torch.sigmoid(x @ p["moe.router"].float())
    _, idx = torch.sort(s + p["moe.router_bias"].float(), dim=-1,
                        descending=True, stable=True)
    idx = idx[:, : a.top_k]
    g = torch.gather(s, 1, idx)
    return g / g.sum(-1, keepdim=True).clamp(min=1e-9) * a.routed_scale, idx


def experts(x, p, a: Arch, precision: str):
    """x [T, d] -> the held experts' part of the layer's output and the
    shared expert's."""
    gate, idx = route(x, p, a)
    out = torch.zeros_like(x)
    for e in range(a.n_held):
        tok, slot = torch.nonzero(idx == a.held_first + e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(x[tok], p["moe.w1"][e], p["moe.w3"][e], p["moe.w2"][e],
                   precision)
        out.index_add_(0, tok, y * gate[tok, slot][:, None])
    if a.n_shared:
        out += swiglu(x, p["moe.shared_w1"], p["moe.shared_w3"],
                      p["moe.shared_w2"], precision)
    return out


def block(x, p, a: Arch, i: int, precision: str):
    x = x + attention(rmsnorm(x, p["ln1"], a.norm_eps), p, a, precision)
    h = rmsnorm(x, p["ln2"], a.norm_eps)
    if i < a.first_dense:
        return x + swiglu(h, p["ffn.w1"], p["ffn.w3"], p["ffn.w2"], precision)
    return x + experts(h, p, a, precision)


@torch.no_grad()
def prefill_logits(a: Arch, seed: int, prompts, device,
                   precision: str = "f32") -> list[torch.Tensor]:
    """Each prompt's (a 1-d tensor of token ids) last-position logits
    [vocab] in float32. The layers are made from ``seed`` one at a time
    and run over every prompt before the next."""
    g = dict(W.outer(arch, a, seed, device))
    xs = [g["embed"][t.to(device)].float() for t in prompts]
    for i in range(a.n_layers):
        p = dict(W.layer(arch, a, seed, i, device))
        xs = [block(x, p, a, i, precision) for x in xs]
        del p
    head = g["embed"].T if a.tie_embeddings else g["lm_head"]
    return [mm(rmsnorm(x[-1:], g["final_norm"], a.norm_eps), head.float(),
               precision)[0] for x in xs]


def train(a: Arch, seed: int, batches, opt: dict, device,
          precision: str = "f32", chunk_tokens: int = 4096) -> dict:
    """No cell trains this family."""
    raise NotImplementedError("the mla_moe family has no training cell")
