"""Grouped-query attention with RoPE, full / sliding-window masks, KV cache;
and latent attention (MLA) with its latent cache.

A copy of ``repro/models/attention.py`` in PyTorch. Three entry points
per layer:
  * ``attend_train``  — attention over a full sequence: causal self
    attention (a window from the config or the caller), non-causal, or
    cross attention (``kv_x``: keys and values from an encoder's output,
    no RoPE), by the einsum chain or, with ``use_flash_kernel=True``,
    through K3 (:mod:`repro_torch.kernels.flash_attention`, the same
    function) for the calls the reference's kernel route serves: causal
    self attention.
  * ``attend_decode`` — one new token against a KV cache (ring buffer for
    sliding-window configs), in plain torch ops as in the reference.
  * ``init_cache``    — allocate the cache for a decode shape.

Latent attention (``cfg.is_mla``: DeepSeek-V3's, which Kimi-K2 uses; the
reference has none) has its own: ``mla_train`` (the whole sequence,
returning the latent cache's entries) and ``mla_decode`` (one token
against a :class:`LatentCache`, in the absorbed form). Its contraction
runs on K3 at q/k ``d_head + qk_rope_dim`` and v ``v_head_dim``.

While a profiler records, the contraction, K3 or the einsum chain, is the
span ``repro_torch.attention.core`` (:mod:`repro_torch.spans`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import spans
from repro_torch.kernels._shards import is_dtensor, on_shards
from repro_torch.kernels.flash_attention import flash_attention

from .common import (BATCH_AXES, ModelConfig, apply_rope, constraint_spec,
                     dense_init, head_mask, maybe_shard, rmsnorm, summed,
                     yarn_softmax_scale)

CORE = "repro_torch.attention.core"

NEG_INF = -1e30


def init_attn_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H, KV, dh = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.d_head
    return {
        "wq": dense_init(gen, d, (d, H, dh), cfg.param_dtype),
        "wk": dense_init(gen, d, (d, KV, dh), cfg.param_dtype),
        "wv": dense_init(gen, d, (d, KV, dh), cfg.param_dtype),
        "wo": dense_init(gen, H * dh, (H, dh, d), cfg.param_dtype),
    }


def _project(x, w):
    """x [B, S, d] @ w [d, H, dh] -> [B, S, H, dh]. On a mesh the product
    is taken flat, [B, S, H*dh], pinned as the heads are pinned (over
    ``model`` where H divides it), then split: DTensor cannot split a flat
    dim it sharded over more ranks than H. The flat weight keeps its
    placements in the backward pass too (a redistribute to them brings its
    gradient back to them), so that its gradient splits as well."""
    if not is_dtensor(x):
        return torch.einsum("bsd,dhk->bshk", x, w)
    H, dh = w.shape[1], w.shape[2]
    wf = w.flatten(1)
    wf = wf.redistribute(wf.device_mesh, wf.placements)
    heads = constraint_spec((H,), ("model",), x.device_mesh)[0]
    y = maybe_shard(x @ wf, BATCH_AXES, None, heads)
    return y.unflatten(-1, (H, dh))


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _causal_mask(sq, sk, q_offset, window, device=None):
    """[sq, sk] additive mask. window<=0 -> full causal."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    ok = kpos <= qpos
    if window and window > 0:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF)


def _masked_heads(out, cfg: ModelConfig):
    hm = head_mask(cfg, out.device)
    if hm is None:
        return out
    return out * hm[None, None, :, None].to(out.dtype)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def attend_train(params, x, cfg: ModelConfig, positions=None, window=None,
                 causal=True, kv_x=None, use_flash_kernel=False):
    """x: [B, S, d]. Returns [B, S, d].

    ``kv_x`` [B, Sk, d] enables cross attention (keys and values from an
    encoder's output; RoPE is applied to self attention only). A
    ``window`` overrides the config's (``cfg.window`` for ``swa``
    configs, else none). ``use_flash_kernel`` routes the softmax(QKᵀ)V
    contraction of causal self attention through K3 instead of the einsum
    chain — the same function; cross and non-causal attention stay on the
    einsum chain, as in the reference."""
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.d_head
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    src = kv_x if kv_x is not None else x
    Sk = src.shape[1]

    q = _project(x, params["wq"])
    k = _project(src, params["wk"])
    v = _project(src, params["wv"])
    if kv_x is None:  # self attention -> rope
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    w = window if window is not None else (
        cfg.window if cfg.attn_variant == "swa" else 0)

    if use_flash_kernel and causal and kv_x is None:
        # on a mesh K3 runs on each rank's heads and batch rows: the
        # placements the einsum route pins below
        q = maybe_shard(q, BATCH_AXES, None, "model", None)
        k = maybe_shard(k, BATCH_AXES, None, "model", None)
        v = maybe_shard(v, BATCH_AXES, None, "model", None)
        with spans.span(CORE):
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True, window=w)
        out = _masked_heads(out.transpose(1, 2), cfg)
        return summed(torch.einsum("bshk,hkd->bsd", out, params["wo"]))

    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)
    # pin head sharding (on a mesh), as the reference does
    q = maybe_shard(q, BATCH_AXES, None, "model", None)
    k = maybe_shard(k, BATCH_AXES, None, "model", None)
    v = maybe_shard(v, BATCH_AXES, None, "model", None)

    def core(q, k, v):
        # the reference divides the x.dtype scores by a float32 sqrt(dh),
        # which promotes them to float32
        scores = torch.einsum("bshk,bthk->bhst", q, k).float() / math.sqrt(dh)
        if causal:
            scores = scores + _causal_mask(S, Sk, 0, w, q.device)[None, None]
        p = torch.softmax(scores, dim=-1).to(x.dtype)
        return torch.einsum("bhst,bthk->bshk", p, v)

    # on a mesh each rank attends over its own batch rows and heads (the
    # placements pinned above), as DTensor does with no collective: a
    # DTensor einsum flattens the batch and the heads into one dim, which
    # torch 2.11's DTensor refuses when both are sharded. The local
    # gradients leave contiguous: a projection's reshape views them
    with spans.span(CORE):
        out = (on_shards(lambda *t: core(*map(_ContiguousGrad.apply, t)),
                         q.placements, q, k, v) if is_dtensor(q)
               else core(q, k, v))
    out = _masked_heads(out, cfg)
    return summed(torch.einsum("bshk,hkd->bsd", out, params["wo"]))


class KVCache(NamedTuple):
    k: torch.Tensor       # [B, C, KV, dh]  (C = cache length or window)
    v: torch.Tensor
    length: torch.Tensor  # [] int32 — number of valid tokens seen so far


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device=None):
    """A layer's empty cache: a :class:`KVCache`, or for latent attention a
    :class:`LatentCache`."""
    if cfg.is_mla:
        return LatentCache(
            ckv=torch.zeros((batch, cache_len,
                             cfg.kv_lora_rank + cfg.qk_rope_dim),
                            dtype=cfg.cache_dtype or dtype, device=device),
            length=torch.zeros((), dtype=torch.int32, device=device))
    KV, dh = cfg.n_kv_heads_padded, cfg.d_head
    C = min(cache_len, cfg.window) if cfg.attn_variant == "swa" else cache_len
    store = cfg.cache_dtype or dtype
    return KVCache(
        k=torch.zeros((batch, C, KV, dh), dtype=store, device=device),
        v=torch.zeros((batch, C, KV, dh), dtype=store, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def _write_slot(buf, slot, new):
    """``buf[:, slot] = new`` in place. A one-byte cache (float8) is written
    through its bytes: torch has no ``index_copy_`` for float8. A DTensor
    cache may shard its slots (the sequence over ``model``): the slot is
    selected by a mask, so each rank writes it where it lies."""
    new = new.to(buf.dtype)
    if is_dtensor(buf):
        C = buf.shape[1]
        hit = (torch.arange(C, device=slot.device) == slot).reshape(1, C, 1, 1)
        buf.copy_(torch.where(hit, new, buf))
        return
    if buf.element_size() == 1:
        buf, new = buf.view(torch.uint8), new.view(torch.uint8)
    buf.index_copy_(1, slot, new)


def _bmm_f32(a, b):
    """``a @ b`` of two 3-d tensors as float32, accumulated in float32.
    On the card a bf16 product takes bf16 operands and returns float32;
    torch has no such product on the CPU, where the operands are upcast."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def attend_decode(params, x, cache: KVCache, cfg: ModelConfig):
    """x: [B, 1, d]; one-step decode against the cache. Returns (out, cache).

    The new token's K/V are written into ``cache.k``/``cache.v`` in place
    (the reference returns updated copies); the returned cache holds the
    same tensors and ``length + 1``. The slot and the valid-slot mask are
    computed on the device from ``cache.length``, so a step never waits
    for the host."""
    B = x.shape[0]
    H, KV, dh = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.d_head
    C = cache.k.shape[1]
    pos = cache.length  # scalar position of the new token

    q = _project(x, params["wq"])
    k_new = _project(x, params["wk"])
    v_new = _project(x, params["wv"])
    positions = pos.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)

    slot = (pos % C).reshape(1).long()  # ring buffer; % is a no-op when full
    k, v = cache.k, cache.v
    _write_slot(k, slot, k_new)
    _write_slot(v, slot, v_new)

    # GQA-aware decode attention: K/V stay at their KV heads (no repeat);
    # query groups contract against them directly, one batch row at a time,
    # so that each product reads the cache through a strided view (a
    # batched product over (b, kv) would copy the cache). Both products
    # accumulate and return float32, as the reference's
    # preferred_element_type does, without a float32 copy of the cache.
    # On a mesh the products are the reference's einsums over the batch
    # (a row of a batch-sharded cache is on one rank), in float32.
    G = H // KV
    q = maybe_shard(q, BATCH_AXES, None, None, None)
    qg = q.reshape(B, KV, G, dh)
    k_read = k.to(x.dtype) if cfg.cache_dtype is not None else k
    v_read = v.to(x.dtype) if cfg.cache_dtype is not None else v
    if is_dtensor(k):
        scores = torch.einsum("bkgd,bckd->bkgc", qg.float(), k_read.float())
    else:
        kt = k_read.permute(0, 2, 3, 1)  # [B, KV, dh, C]
        scores = torch.stack([_bmm_f32(qg[b], kt[b]) for b in range(B)])
    scores = scores / math.sqrt(dh)
    # mask out slots that have never been written
    valid = torch.arange(C, device=x.device) <= torch.clamp(pos, max=C - 1)
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(x.dtype)
    if is_dtensor(k):
        out = torch.einsum("bkgc,bckd->bkgd", p.float(), v_read.float())
    else:
        vt = v_read.permute(0, 2, 1, 3)  # [B, KV, C, dh]
        out = torch.stack([_bmm_f32(p[b], vt[b]) for b in range(B)])
    out = out.reshape(B, 1, H, dh).to(x.dtype)
    out = _masked_heads(out, cfg)
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return out, KVCache(k=k, v=v, length=pos + 1)


# ---------------------------------------------------------------------------
# latent attention (MLA)
#
# x [B, S, d] -> cq = RMSNorm(x wq_a) [B, S, q_lora]; q = cq wq_b [B, S, H,
# dn + dr] = [q_nope | q_pe]; x wkv_a = [c | k_pe] [B, S, kv_lora + dr];
# c = RMSNorm(c); c wkv_b = [k_nope | v] [B, S, H, dn + dv]; q_pe and the
# one k_pe a token get YaRN rope (split-half); k = [k_nope | k_pe], k_pe
# broadcast to the heads; o = softmax(q k^T s + causal) v, s the YaRN
# softmax scale; y = o wo. The latent cache holds [c | k_pe] a token.


def mla_param_shapes(cfg: ModelConfig) -> dict:
    """name -> (shape, fan_in or None for a gain of ones) of a layer's
    latent attention."""
    d, H, dn = cfg.d_model, cfg.n_heads, cfg.d_head
    r, c, dr, dv = (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_dim,
                    cfg.v_head_dim)
    return {"wq_a": ((d, r), d), "q_norm": ((r,), None),
            "wq_b": ((r, H, dn + dr), r), "wkv_a": ((d, c + dr), d),
            "kv_norm": ((c,), None), "wkv_b": ((c, H, dn + dv), c),
            "wo": ((H, dv, d), H * dv)}


def init_mla_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = cfg.param_dtype
    return {n: (torch.ones(s, dtype=dt, device=gen.device) if fan is None
                else dense_init(gen, fan, s, dt))
            for n, (s, fan) in mla_param_shapes(cfg).items()}


class LatentCache(NamedTuple):
    ckv: torch.Tensor     # [B, C, kv_lora + qk_rope]: c (normed), k_pe (roped)
    length: torch.Tensor  # [] int32 — number of valid tokens seen so far


def _mla_latent(params, x, cfg: ModelConfig, positions):
    """x [B, S, d] -> q [B, S, H, dn + dr] (q_pe roped) and the latent
    [B, S, kv_lora + dr] ([c normed | k_pe roped])."""
    dn, c = cfg.d_head, cfg.kv_lora_rank
    cq = rmsnorm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["wq_b"])
    q_pe = apply_rope(q[..., dn:], positions, cfg.rope_theta, cfg.rope_yarn)
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    kv = x @ params["wkv_a"]
    k_pe = apply_rope(kv[..., None, c:], positions, cfg.rope_theta,
                      cfg.rope_yarn)[..., 0, :]
    lat = torch.cat([rmsnorm(kv[..., :c], params["kv_norm"], cfg.norm_eps),
                     k_pe], dim=-1)
    return q, lat


def mla_train(params, x, cfg: ModelConfig, use_flash_kernel=False):
    """Causal latent attention over x [B, S, d] -> ([B, S, d], the latent
    cache's entries [B, S, kv_lora + qk_rope]). ``use_flash_kernel`` runs
    the contraction on K3 at q/k ``d_head + qk_rope_dim`` and v
    ``v_head_dim``, v read in place from the ``wkv_b`` product."""
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.d_head, cfg.qk_rope_dim
    c = cfg.kv_lora_rank
    positions = torch.arange(S, device=x.device)[None, :]
    q, lat = _mla_latent(params, x, cfg, positions)
    kv = torch.einsum("bsc,chk->bshk", lat[..., :c], params["wkv_b"])
    k = torch.cat([kv[..., :dn],
                   lat[..., None, c:].expand(B, S, H, dr)], dim=-1)
    v = kv[..., dn:]
    scale = yarn_softmax_scale(dn + dr, cfg.rope_yarn)
    with spans.span(CORE):
        if use_flash_kernel:
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True,
                                  scale=scale).transpose(1, 2)
        else:
            s = torch.einsum("bshk,bthk->bhst", q, k).float() * scale
            s = s + _causal_mask(S, S, 0, 0, x.device)[None, None]
            p = torch.softmax(s, dim=-1).to(x.dtype)
            out = torch.einsum("bhst,bthk->bshk", p, v)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), lat


def mla_decode(params, x, cache: LatentCache, cfg: ModelConfig):
    """x [B, 1, d]: one token against the latent cache, in the absorbed
    form: q_nope goes into the latent through ``wkv_b``'s k half, the
    scores are taken over c and k_pe, and the output p c leaves through
    its v half. The products are float32. The token's latent is written
    into ``cache.ckv`` in place; returns (out, the cache with length + 1)."""
    B = x.shape[0]
    dn, c = cfg.d_head, cfg.kv_lora_rank
    C = cache.ckv.shape[1]
    pos = cache.length
    q, lat_new = _mla_latent(params, x, cfg, pos.reshape(1, 1).expand(B, 1))
    _write_slot(cache.ckv, pos.reshape(1).long(), lat_new)
    lat = cache.ckv.float()                                 # [B, C, c + dr]
    w = params["wkv_b"].float()                             # [c, H, dn + dv]
    q = q[:, 0].float()                                     # [B, H, dn + dr]
    q_lat = torch.einsum("bhk,chk->bhc", q[..., :dn], w[..., :dn])
    s = (torch.einsum("bhc,btc->bht", q_lat, lat[..., :c])
         + torch.einsum("bhr,btr->bht", q[..., dn:], lat[..., c:]))
    s = s * yarn_softmax_scale(dn + cfg.qk_rope_dim, cfg.rope_yarn)
    valid = torch.arange(C, device=x.device) <= torch.clamp(pos, max=C - 1)
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    o = torch.einsum("bht,btc->bhc", p, lat[..., :c])
    o = torch.einsum("bhc,chk->bhk", o, w[..., dn:]).to(x.dtype)
    out = torch.einsum("bhk,hkd->bd", o, params["wo"])[:, None]
    return out, LatentCache(ckv=cache.ckv, length=pos + 1)
