"""Plain reference of a decoder-only LM: dense (SwiGLU) or with top-k
experts, dropless.

Pre-norm blocks: RMSNorm, grouped-query attention with rotary positions
(split-half rotation, angles in float64) under a causal mask (and a
window where the configuration gives one), the residual, RMSNorm, then a
SwiGLU FFN or the experts, the residual; a final RMSNorm and the head,
the embedding's transpose where the configuration ties them. Query head
``h`` reads kv head ``h // (heads / kv heads)``.

Experts: the router's softmax in float32 over all experts, the ``top_k``
largest (ties to the lower index) with their probabilities renormalised
to sum to 1; every token reaches each of its experts, as the source's
routing has no capacity.

Everything is float32 on the weights' bf16 values (TF32 off). With
``precision="fp8"`` every product's operands are rounded to
float8_e4m3fn first (a scale per row of the left operand and per column
of the right one, over the contracted dim; the router stays float32):
the control that a lower precision has to fail. In training the
rounding passes the gradient straight through.

:func:`prefill_logits` gives each prompt's last-position logits, the
layers made again one at a time from the seed. :func:`train` follows the
first steps of AdamW training from the seed's weights.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.arch import decoder as arch
from gpubench.arch.decoder import Arch
from gpubench.core import weights as W

F8_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t).detach()


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` in float32; ``fp8`` rounds the operands first."""
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w, -2)
    return x @ w


def rmsnorm(x, gain, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gain.float()


def rope(x, theta: float):
    """x [..., S, H, dh] -> rotated, position s at row s."""
    S, dh = x.shape[-3], x.shape[-1]
    inv = 1.0 / (theta ** (np.arange(0, dh, 2, dtype=np.float64) / dh))
    ang = np.arange(S, dtype=np.float64)[:, None] * inv[None, :]
    cos = torch.as_tensor(np.cos(ang), dtype=torch.float32,
                          device=x.device)[:, None, :]
    sin = torch.as_tensor(np.sin(ang), dtype=torch.float32,
                          device=x.device)[:, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(x, p, a: Arch, precision: str):
    """x [b, S, d] float32 -> [b, S, d]."""
    b, S, d = x.shape
    H, KV, dh = a.n_heads, a.n_kv_heads, a.d_head
    q = mm(x, p["attn.wq"].float().reshape(d, H * dh), precision)
    k = mm(x, p["attn.wk"].float().reshape(d, KV * dh), precision)
    v = mm(x, p["attn.wv"].float().reshape(d, KV * dh), precision)
    q = rope(q.view(b, S, H, dh), a.rope_theta).transpose(1, 2)
    k = rope(k.view(b, S, KV, dh), a.rope_theta).transpose(1, 2)
    v = v.view(b, S, KV, dh).transpose(1, 2)
    kv_of = torch.arange(H, device=x.device) // a.heads_per_kv
    k, v = k[:, kv_of], v[:, kv_of]                       # [b, H, S, dh]
    pos = torch.arange(S, device=x.device)
    keep = pos[None, :] <= pos[:, None]
    if a.window:
        keep &= pos[None, :] > pos[:, None] - a.window
    s = mm(q, k.transpose(-1, -2), precision) / math.sqrt(dh)
    s = s.masked_fill(~keep, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v, precision)        # [b, H, S, dh]
    o = o.transpose(1, 2).reshape(b, S, H * dh)
    return mm(o, p["attn.wo"].float().reshape(H * dh, d), precision)


def swiglu(x, w1, w3, w2, precision: str):
    return mm(F.silu(mm(x, w1, precision)) * mm(x, w3, precision), w2,
              precision)


def route(xt, router, a: Arch):
    """xt [T, d] -> gate [T, K], expert [T, K]."""
    probs = torch.softmax(xt @ router.float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, : a.top_k], idx[:, : a.top_k]
    return gate / gate.sum(-1, keepdim=True).clamp(min=1e-9), idx


def experts(x, p, a: Arch, precision: str):
    """x [b, S, d] -> [b, S, d]."""
    b, S, d = x.shape
    xt = x.reshape(b * S, d)
    gate, idx = route(xt, p["moe.router"], a)
    out = torch.zeros_like(xt)
    for e in range(a.n_experts):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(xt[tok], p["moe.w1"][e].float(), p["moe.w3"][e].float(),
                   p["moe.w2"][e].float(), precision)
        out.index_add_(0, tok, y * gate[tok, slot][:, None])
    return out.view(b, S, d)


def block(x, p, a: Arch, precision: str):
    x = x + attention(rmsnorm(x, p["ln1"], a.norm_eps), p, a, precision)
    h = rmsnorm(x, p["ln2"], a.norm_eps)
    if a.family == "moe":
        return x + experts(h, p, a, precision)
    return x + swiglu(h, p["ffn.w1"].float(), p["ffn.w3"].float(),
                      p["ffn.w2"].float(), precision)


def head(a: Arch, g: dict) -> torch.Tensor:
    return g["embed"].T if a.tie_embeddings else g["lm_head"]


@torch.no_grad()
def prefill_logits(a: Arch, seed: int, prompts, device,
                   precision: str = "f32") -> list[torch.Tensor]:
    """Each prompt's (a 1-d tensor of token ids) last-position logits
    [vocab] in float32. The layers are made from ``seed`` one at a time
    and run over every prompt before the next."""
    g = dict(W.outer(arch, a, seed, device))
    xs = [g["embed"][t.to(device)].float()[None] for t in prompts]
    for i in range(a.n_layers):
        p = dict(W.layer(arch, a, seed, i, device))
        xs = [block(x, p, a, precision) for x in xs]
        del p
    hw = head(a, g).float()
    return [mm(rmsnorm(x[0, -1:], g["final_norm"], a.norm_eps), hw,
               precision)[0] for x in xs]


def loss_fn(params: dict, tokens, labels, a: Arch, precision: str,
            n_total: int):
    """Cross entropy summed over the tokens of [b, S] and divided by
    ``n_total``: chunks of a batch add up to its mean."""
    x = params["embed"][tokens.long()]
    for i in range(a.n_layers):
        pre = f"blocks.{i}."
        p = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        x = block(x, p, a, precision)
    x = rmsnorm(x, params["final_norm"], a.norm_eps)
    logits = mm(x, head(a, params), precision)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.reshape(-1).long(), reduction="sum")
    return nll / n_total


def train(a: Arch, seed: int, batches, opt: dict, device,
          precision: str = "f32", chunk_tokens: int = 4096) -> dict:
    """``len(batches)`` AdamW steps from the seed's weights, each on one
    batch ({"tokens", "labels"} [B, S]), the gradient taken over chunks of
    about ``chunk_tokens`` tokens. The weights are kept in the
    configuration's dtype and the moments in float32; each update is
    computed in float32 and rounded to the weights' dtype.

    Returns each step's loss, every leaf's first gradient norm and every
    leaf's change over all the steps (float64 lists / dicts)."""
    p0 = {n: t for n, t in W.every(arch, a, seed, device)}
    params = {n: t.clone() for n, t in p0.items()}
    m = {n: torch.zeros_like(t, dtype=torch.float32) for n, t in p0.items()}
    v = {n: torch.zeros_like(t, dtype=torch.float32) for n, t in p0.items()}
    b1, b2, eps, lr, wd = (opt["b1"], opt["b2"], opt["eps"], opt["lr"],
                           opt["weight_decay"])
    losses, grad_norm = [], None
    for step, batch in enumerate(batches, start=1):
        leaves = {n: t.float().requires_grad_() for n, t in params.items()}
        B, S = batch["tokens"].shape
        rows = max(1, chunk_tokens // S)
        total = 0.0
        for r in range(0, B, rows):
            loss = loss_fn(leaves, batch["tokens"][r:r + rows].to(device),
                           batch["labels"][r:r + rows].to(device), a,
                           precision, B * S)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            if grad_norm is None:
                grad_norm = {n: float(torch.linalg.vector_norm(t.grad))
                             for n, t in leaves.items()}
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for n, leaf in leaves.items():
                g = leaf.grad
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[n] / bc1) / ((v[n] / bc2).sqrt() + eps)
                p32 = params[n].float()
                params[n] = (p32 - lr * (upd + wd * p32)).to(params[n].dtype)
        del leaves
    change = {n: float(torch.linalg.vector_norm(
        params[n].float() - p0[n].float())) for n in params}
    return {"loss": losses, "grad_norm": grad_norm, "change": change}
