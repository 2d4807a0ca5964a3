"""Plain reference of a DeepSeek-V3-style decoder (Kimi-K2-Instruct's
architecture): latent attention (MLA) with YaRN rope, leading dense
SwiGLU layers, then expert layers with sigmoid routing, a selection-only
bias and shared experts.

Plain ``torch`` operations in float32 on the CPU (no product rounds to
TF32 there), one prompt at a time, over every position, with no cache,
kernel or batching. It imports neither the program under test nor JAX.

The block, ``x += Attn(RMSNorm(x))``, ``x += FFN(RMSNorm(x))``, then the
final RMSNorm and the untied head:

* MLA over x [T, d]: ``cq = RMSNorm(x wq_a)``; ``q = cq wq_b`` [T, H,
  dn + dr] = [q_nope | q_pe]; ``x wkv_a = [c | k_pe]``; ``c =
  RMSNorm(c)``; ``c wkv_b = [k_nope | v]`` [T, H, dn + dv]; q_pe and the
  one k_pe a token get YaRN rope, k_pe broadcast to the heads; ``o =
  softmax(q k^T s + causal) v``, ``s = (dn + dr)^-0.5 mscale^2``; ``y =
  o wo``.
* YaRN: frequency ``i`` of the rope width ``dr`` is ``theta^(-2i/dr)``,
  divided by ``factor`` past the correction range [floor(c(beta_fast)),
  ceil(c(beta_slow))], ``c(b) = dr ln(original_max / (2 pi b)) / (2 ln
  theta)``, a linear ramp between; cos and sin times ``mscale(mscale) /
  mscale(mscale_all_dim)``, ``mscale(m) = 0.1 m ln(factor) + 1``.
* Routing (router and bias float32): ``s = sigmoid(x W_r)``; the top k of
  ``s + b`` (ties to the lower index); ``g = s[idx] / sum s[idx] *
  routed_scale``: the bias selects and never weighs.
* A share of the experts (``experts``, a range): only the assignments to
  those experts are computed, the others' terms left out; the shared
  experts are added where ``shared`` is set (the whole layer: every
  expert and the shared ones once).

Departures from the published modelling code (``modeling_deepseek.py``,
which Kimi-K2 uses):

* rope rotates split halves; the published checkpoints interleave the
  rope columns and the code de-interleaves them before rotating. With
  random weights that is a relabelling of the rope columns.
* the gates are normalised by ``max(sum, 1e-9)``; the published code adds
  1e-20 to the sum. Eight sigmoid scores never sum near either.
* ``seq_aux`` (a training loss) is not computed.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Sizes:
    d: int
    n_heads: int
    q_lora: int
    kv_lora: int
    d_nope: int
    d_rope: int
    d_v: int
    vocab: int
    n_layers: int
    first_dense: int
    d_ff: int             # the dense layers' width
    d_expert: int         # an expert's (and a shared expert's) width
    n_experts: int        # routed over
    top_k: int
    n_shared: int
    routed_scale: float
    rope_theta: float
    yarn_factor: float
    yarn_original_max: int
    yarn_beta_fast: float
    yarn_beta_slow: float
    yarn_mscale: float
    yarn_mscale_all_dim: float
    eps: float


def mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn(a: Sizes):
    """(the rope's frequencies [dr / 2] float64, the factor on cos/sin)."""
    dr, theta = a.d_rope, a.rope_theta

    def corr(b):
        return dr * math.log(a.yarn_original_max / (b * 2 * math.pi)) / (
            2 * math.log(theta))
    lo = max(math.floor(corr(a.yarn_beta_fast)), 0)
    hi = min(math.ceil(corr(a.yarn_beta_slow)), dr - 1)
    if lo == hi:
        hi += 0.001
    base = 1.0 / theta ** (np.arange(0, dr, 2, dtype=np.float64) / dr)
    ramp = np.clip((np.arange(dr // 2) - lo) / (hi - lo), 0.0, 1.0)
    freqs = base / a.yarn_factor * ramp + base * (1.0 - ramp)
    return freqs, (mscale(a.yarn_factor, a.yarn_mscale)
                   / mscale(a.yarn_factor, a.yarn_mscale_all_dim))


def softmax_scale(a: Sizes) -> float:
    s = (a.d_nope + a.d_rope) ** -0.5
    if a.yarn_mscale_all_dim:
        s *= mscale(a.yarn_factor, a.yarn_mscale_all_dim) ** 2
    return s


def rmsnorm(x, gain, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gain.float()


def rope(x, a: Sizes):
    """x [T, ..., dr] -> rotated (split halves), position t at row t."""
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


def mla(x, p: dict, a: Sizes):
    """x [T, d] float32 -> [T, d]."""
    T = x.shape[0]
    H, dn, dr, dv, c = a.n_heads, a.d_nope, a.d_rope, a.d_v, a.kv_lora
    cq = rmsnorm(x @ p["attn.wq_a"].float(), p["attn.q_norm"], a.eps)
    q = (cq @ p["attn.wq_b"].float().reshape(a.q_lora, -1)).view(T, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], a)], dim=-1)
    kv = x @ p["attn.wkv_a"].float()
    lat = rmsnorm(kv[:, :c], p["attn.kv_norm"], a.eps)
    k_pe = rope(kv[:, c:], a)                                    # [T, dr]
    kvb = (lat @ p["attn.wkv_b"].float().reshape(c, -1)).view(T, H, dn + dv)
    k = torch.cat([kvb[..., :dn], k_pe[:, None].expand(T, H, dr)], dim=-1)
    v = kvb[..., dn:]
    s = torch.einsum("shk,thk->hst", q, k) * softmax_scale(a)
    pos = torch.arange(T, device=x.device)
    s = s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    o = torch.einsum("hst,thk->shk", torch.softmax(s, dim=-1), v)
    return o.reshape(T, H * dv) @ p["attn.wo"].float().reshape(H * dv, -1)


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1.float()) * (x @ w3.float())) @ w2.float()


def route(x, p: dict, a: Sizes):
    """x [T, d] -> gate [T, k], expert [T, k] (ids over all n_experts)."""
    s = torch.sigmoid(x @ p["moe.router"].float())
    sel = s + p["moe.router_bias"].float()
    _, idx = torch.sort(sel, dim=-1, descending=True, stable=True)
    idx = idx[:, : a.top_k]
    g = torch.gather(s, 1, idx)
    return g / g.sum(-1, keepdim=True).clamp(min=1e-9) * a.routed_scale, idx


def experts(x, p: dict, a: Sizes, held: range, shared: bool = True):
    """x [T, d] -> the part of the expert layer's output that the experts
    in ``held`` give (their weights are ``moe.w1[e - held.start]``...),
    plus the shared experts' where ``shared``."""
    gate, idx = route(x, p, a)
    out = torch.zeros_like(x)
    for e in held:
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            i = e - held.start
            y = swiglu(x[tok], p["moe.w1"][i], p["moe.w3"][i], p["moe.w2"][i])
            out.index_add_(0, tok, y * gate[tok, slot][:, None])
    if shared and a.n_shared:
        out = out + swiglu(x, p["moe.shared_w1"], p["moe.shared_w3"],
                           p["moe.shared_w2"])
    return out


def block(x, p: dict, a: Sizes, layer: int, held: range, shared=True):
    x = x + mla(rmsnorm(x, p["ln1"], a.eps), p, a)
    h = rmsnorm(x, p["ln2"], a.eps)
    if layer < a.first_dense:
        return x + swiglu(h, p["ffn.w1"], p["ffn.w3"], p["ffn.w2"])
    return x + experts(h, p, a, held, shared)


@torch.no_grad()
def forward(a: Sizes, outer: dict, layers: list, tokens, held: range):
    """Logits [T, vocab] of the prompt ``tokens`` (1-d ids) at every
    position: ``outer`` holds ``embed`` [vocab, d], ``final_norm``,
    ``lm_head`` [d, vocab]; ``layers[i]`` layer i's weights, named as
    above, its experts those in ``held``."""
    x = outer["embed"][tokens].float()
    for i, p in enumerate(layers):
        x = block(x, p, a, i, held)
    x = rmsnorm(x, outer["final_norm"], a.eps)
    return x @ outer["lm_head"].float()
