"""Mixture-of-Experts layer: top-k router + capacity-bounded expert products.

A copy of ``repro/models/moe.py`` in PyTorch, without its sharding
constraints (one device). Tokens are sorted by expert id and packed into a
fixed-capacity buffer, the experts run as one batched SwiGLU, and the
outputs are gathered back weighted by the router's gates. Tokens beyond
an expert's capacity are dropped (Switch/GShard semantics).

``use_kernels=True`` sends the three expert products of a layer through
K5 (:mod:`repro_torch.kernels.moe_gemm`); ``False`` is the reference's
einsum route. Both compute the same function. Where JAX has no torch
twin, the port keeps the reference's result:

* ``jax.lax.top_k`` breaks ties toward the lower expert index:
  :func:`_top_k` is a stable descending sort; ``jnp.argsort`` is stable:
  ``torch.argsort(stable=True)``.
* ``.at[dest].set(mode="drop")`` with ``dest = E*C`` for a dropped
  assignment: the pack buffer has one spare row at ``E*C``, sliced off;
  ``.at[dest].get(mode="fill")``: a gather masked by ``keep``.
* ``.at[token].add`` sums a token's K contributions: the port gathers
  them as [T, K, d] and adds them in order k = 0, 1, … (no atomics, the
  same bits on every run; for K = 2 the reference's bits).

The grouped dispatch packs expert-major, [E, G, C, d] (slot
``e*G*C + g*C + rank``) where the reference packs [G, E, C, d], so that the
expert products read [E, G*C, d] without a copy; each slot holds the same
row either way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm import moe_gemm

from .common import ModelConfig, dense_init


def moe_param_shapes(cfg: ModelConfig) -> dict:
    """name -> (shape, dtype) of a layer's MoE weights, in the reference's
    shapes; the router is float32 whatever ``param_dtype`` is."""
    d, E, f, dt = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.param_dtype
    shapes = {"router": ((d, E), torch.float32), "w1": ((E, d, f), dt),
              "w3": ((E, d, f), dt), "w2": ((E, f, d), dt)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shapes.update(shared_w1=((d, fs), dt), shared_w3=((d, fs), dt),
                      shared_w2=((fs, d), dt))
    return shapes


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, out) -> None:
    """Normal fan-in init of every weight (the fan-in is the second-last
    dim: d for the router, w1, w3; f for w2), written into ``out`` (name ->
    the parameter): each weight is drawn in float32 and copied straight
    into its parameter, so a layer's experts (kimi-k2's are three of 10.5
    GiB) are never held twice."""
    for name, (shape, _) in moe_param_shapes(cfg).items():
        out[name].copy_(dense_init(gen, shape[-2], shape, torch.float32))


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    # the reference rounds up to a multiple of 64 (shardable, MXU-aligned)
    mult = 64 if n_tokens >= 4096 else 8
    return max(8, -(-c // mult) * mult)


def _pick_groups(T: int) -> int:
    """Dispatch groups, as the reference picks them (the data shards the
    token dim can carry on its meshes)."""
    for g in (32, 16, 8, 4, 2):
        if T % g == 0 and T // g >= 2:
            return g
    return 1


def moe_ffn(params, x, cfg: ModelConfig, use_kernels: bool = False):
    """x: [B, S, d] -> ([B, S, d], aux) where aux has router stats.

    Dispatch is adaptive, as in the reference: grouped on big token
    counts, flat where assignments per expert are few (decode shapes)."""
    T = x.shape[0] * x.shape[1]
    grouped_ok = (T * cfg.top_k) / max(cfg.n_experts, 1) >= 64
    if cfg.moe_dispatch == "grouped" and grouped_ok and _pick_groups(T) > 1:
        return moe_ffn_grouped(params, x, cfg, use_kernels)
    return moe_ffn_flat(params, x, cfg, use_kernels)


def _top_k(probs, K: int):
    """Values and indices of the K largest along the last dim, ties to the
    lower index (``jax.lax.top_k``'s rule; ``torch.topk`` has none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def _route(xt, router, K: int):
    """Router in float32: (probs [..., E], gate [..., K], idx [..., K])."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate, idx = _top_k(probs, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def _slots(flat_e, C: int):
    """Per-row slot assignment of expert ids ``flat_e`` [..., N]: sort
    order, (sorted) expert, rank within its expert, and keep = rank < C."""
    sort = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, sort)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(flat_e.shape[-1], device=flat_e.device) - first
    return sort, sorted_e, rank, rank < C


def _experts(buf, params, use_kernels: bool):
    """SwiGLU of every expert over its rows: buf [E, N, d] -> [E, N, d]."""
    if use_kernels:
        h = F.silu(moe_gemm(buf, params["w1"])) * moe_gemm(buf, params["w3"])
        return moe_gemm(h, params["w2"])
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, params["w1"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, params["w3"])
    return torch.einsum("ecf,efd->ecd", h, params["w2"])


def _unsort(sort, v):
    """``v`` given in sorted order -> in assignment order."""
    return torch.empty_like(v).scatter_(-1, sort, v)


def _shared(params, xt):
    hs = F.silu(xt @ params["shared_w1"]) * (xt @ params["shared_w3"])
    return hs @ params["shared_w2"]


def _aux(probs, idx, keep, cfg: ModelConfig, T: int):
    E, K = cfg.n_experts, cfg.top_k
    me = probs.reshape(-1, E).mean(0)
    flat = idx.reshape(-1)
    # tokens per expert (bincount, which has no meta-device kernel)
    counts = torch.zeros(E, dtype=torch.int64, device=flat.device)
    ce = counts.index_add_(0, flat, torch.ones_like(flat)).float() / (T * K)
    return {"lb_loss": E * torch.sum(me * ce),
            "dropped": 1.0 - keep.float().mean()}


def moe_ffn_grouped(params, x, cfg: ModelConfig, use_kernels: bool = False):
    """GShard-style grouped dispatch: each group of Tg tokens has its own
    capacity C per expert. The buffer is packed expert-major, [E, G, C, d],
    and the experts read it as [E, G*C, d]."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G = _pick_groups(T)
    Tg = T // G
    xt = x.reshape(G, Tg, d)
    probs, gate, idx = _route(xt, params["router"], K)       # [G, Tg, ·]
    C = expert_capacity(Tg, cfg)

    sort, sorted_e, rank, keep = _slots(idx.reshape(G, Tg * K), C)
    grp = torch.arange(G, device=x.device)[:, None]
    dest = torch.where(keep, sorted_e * (G * C) + grp * C + rank, E * G * C)
    token = grp * Tg + torch.div(sort, K, rounding_mode="floor")
    buf = x.new_zeros((E * G * C + 1, d))                    # + the drop row
    buf.index_copy_(0, dest.reshape(-1), x.reshape(T, d)[token.reshape(-1)])
    out = _experts(buf[:-1].view(E, G * C, d), params, use_kernels)
    out = out.reshape(E * G * C, d)

    # combine, in assignment order [T, K]: gate * keep, cast to the
    # activation dtype before the product, as the reference does
    dest_u = _unsort(sort, dest).reshape(T * K)
    keep_u = _unsort(sort, keep).reshape(T * K)
    gathered = torch.where(keep_u[:, None],
                           out[dest_u.clamp(max=E * G * C - 1)], 0)
    w = (gate.reshape(T * K) * keep_u.float())[:, None]
    contrib = (gathered * w.to(out.dtype)).view(T, K, d)
    y = _sum_k(contrib).to(x.dtype)

    if cfg.n_shared_experts:
        y = y + _shared(params, x.reshape(T, d))
    return y.reshape(B, S, d), _aux(probs, idx, keep, cfg, T)


def moe_ffn_flat(params, x, cfg: ModelConfig, use_kernels: bool = False):
    """Single global capacity buffer [E, C, d]."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    probs, gate, idx = _route(xt, params["router"], K)       # [T, ·]
    C = expert_capacity(T, cfg)

    sort, sorted_e, rank, keep = _slots(idx.reshape(T * K), C)
    dest = torch.where(keep, sorted_e * C + rank, E * C)
    token = torch.div(sort, K, rounding_mode="floor")
    buf = x.new_zeros((E * C + 1, d))                        # + the drop row
    buf.index_copy_(0, dest, xt[token])
    out = _experts(buf[:-1].view(E, C, d), params, use_kernels)
    out = out.reshape(E * C, d)

    # combine, in assignment order [T, K]: the product in float32 (gate *
    # keep), cast to the activation dtype, as the reference does
    dest_u, keep_u = _unsort(sort, dest), _unsort(sort, keep)
    gathered = torch.where(keep_u[:, None], out[dest_u.clamp(max=E * C - 1)],
                           0)
    w = (gate.reshape(T * K) * keep_u.to(gate.dtype))[:, None]
    y = _sum_k((gathered * w).to(x.dtype).view(T, K, d))

    if cfg.n_shared_experts:
        y = y + _shared(params, xt)
    return y.reshape(B, S, d), _aux(probs, idx, keep, cfg, T)


def _sum_k(contrib):
    """[T, K, d] -> [T, d], adding k = 0, 1, … in order."""
    y = contrib[:, 0]
    for k in range(1, contrib.shape[1]):
        y = y + contrib[:, k]
    return y
