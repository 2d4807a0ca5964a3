"""Decoder-only transformer assembly: the dense family.

A copy of the dense part of ``repro/models/transformer.py`` in PyTorch:
pre-norm residual blocks of GQA attention and a SwiGLU FFN. The model is
an ``nn.Module`` that holds its weights in the reference's shapes
(``wq`` [d, H, dh], ``wo`` [H, dh, d], ``w1`` [d, f], …), one block per
layer, so a reference parameter tree carries across as a plain copy
(:mod:`.convert`). The layers are a Python loop where the reference
scans.

``DecoderLM(cfg, use_flash_kernel=True)`` runs prefill attention through
K3; ``use_flash_kernel=False`` is the reference's einsum route. Both
compute the same function. Families other than dense raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import attention as attn
from .common import (ModelConfig, cross_entropy_loss, dense_init, embed_init,
                     rmsnorm, swiglu, vocab_mask)

# families the port has not reached -> the ROADMAP item that ports them
NOT_PORTED = {
    "ssm": "item 1 (the rwkv6-1.6b path on K4 rwkv_scan)",
    "moe": "item 2 (the MoE family on K5 moe_gemm)",
    "hybrid": "item 5 (the hybrid, vlm and encoder-decoder families)",
    "vlm": "item 5 (the hybrid, vlm and encoder-decoder families)",
    "encdec": "item 5 (the hybrid, vlm and encoder-decoder families)",
}


def check_dense(cfg: ModelConfig):
    """Raise ``NotImplementedError`` unless ``cfg`` is a plain dense
    decoder-only model."""
    family = cfg.family
    if cfg.hybrid:
        family = "hybrid"
    elif cfg.n_experts:
        family = "moe"
    elif cfg.encoder_layers:
        family = "encdec"
    elif cfg.n_frontend_embeds and family == "dense":
        family = "vlm"
    if family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {family} family is not ported yet; see "
            f"ROADMAP.md, modules still to port, "
            f"{NOT_PORTED.get(family, 'section 1')}")


# ---------------------------------------------------------------------------
# per-layer parameters


def init_ffn_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": dense_init(gen, d, (d, f), cfg.param_dtype),
        "w3": dense_init(gen, d, (d, f), cfg.param_dtype),
        "w2": dense_init(gen, f, (f, d), cfg.param_dtype),
    }


def init_block_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    ones = torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device)
    return {"ln1": ones, "ln2": ones.clone(),
            "attn": attn.init_attn_params(gen, cfg),
            "ffn": init_ffn_params(gen, cfg)}


def _empty(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Block(nn.Module):
    """One dense block's weights: ``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}``,
    ``ffn.{w1,w3,w2}``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
        H, KV, dh = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.d_head
        self.ln1 = _empty((d,), dt, device)
        self.ln2 = _empty((d,), dt, device)
        self.attn = nn.ParameterDict({
            "wq": _empty((d, H, dh), dt, device),
            "wk": _empty((d, KV, dh), dt, device),
            "wv": _empty((d, KV, dh), dt, device),
            "wo": _empty((H, dh, d), dt, device)})
        self.ffn = nn.ParameterDict({
            "w1": _empty((d, f), dt, device), "w3": _empty((d, f), dt, device),
            "w2": _empty((f, d), dt, device)})


# ---------------------------------------------------------------------------
# block forward (training / prefill path)


def block_train(p: Block, x, cfg: ModelConfig, return_kv=False,
                use_flash_kernel=False):
    """One residual block over the full sequence. Returns (x, aux, kv)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    kv = None
    y = attn.attend_train(p.attn, h, cfg, use_flash_kernel=use_flash_kernel)
    if return_kv:
        # re-derive K/V for the cache, as the reference does
        kv = _project_kv(p.attn, h, cfg)
    x = x + y
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    y = swiglu(h, p.ffn["w1"], p.ffn["w3"], p.ffn["w2"])
    return x + y, aux, kv


def _project_kv(ap, x, cfg: ModelConfig):
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None, :]
    k = torch.einsum("bsd,dhk->bshk", x, ap["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, ap["wv"])
    k = attn.apply_rope(k, pos, cfg.rope_theta)
    if cfg.attn_variant == "swa":
        k, v = k[:, -cfg.window:], v[:, -cfg.window:]
    return k, v


# ---------------------------------------------------------------------------
# block decode (one token)


def block_decode(p: Block, x, cache: attn.KVCache, cfg: ModelConfig):
    """x: [B,1,d]; cache is the layer's KVCache (updated in place)."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    y, new_cache = attn.attend_decode(p.attn, h, cache, cfg)
    x = x + y
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    y = swiglu(h, p.ffn["w1"], p.ffn["w3"], p.ffn["w2"])
    return x + y, new_cache


# ---------------------------------------------------------------------------
# the model


class DecoderLM(nn.Module):
    """Dense decoder-only LM.

    The weights are allocated on ``device`` uninitialised; :meth:`init`
    fills them from a ``torch.Generator`` (as the reference's ``init`` does
    from a key), or ``load_state_dict`` takes them from
    :func:`repro_torch.models.convert.params_from_reference`. The KV cache
    of :meth:`init_cache`/:meth:`prefill` stacks the layers as the
    reference's scanned cache does: k, v [L, B, C, KV, dh], length [L].
    """

    def __init__(self, cfg: ModelConfig, use_flash_kernel: bool = True,
                 device=None):
        super().__init__()
        check_dense(cfg)
        self.cfg = cfg
        self.use_flash_kernel = use_flash_kernel
        dt, d, vp = cfg.param_dtype, cfg.d_model, cfg.vocab_padded
        self.embed = _empty((vp, d), dt, device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _empty((d,), dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = _empty((d, vp), dt, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- params ---------------------------------------------------------
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "DecoderLM":
        """Fill the weights from ``gen`` (a generator on the model's
        device); returns the model."""
        cfg = self.cfg
        self.embed.copy_(embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                    cfg.param_dtype))
        for blk in self.blocks:
            p = init_block_params(gen, cfg)
            blk.ln1.copy_(p["ln1"])
            blk.ln2.copy_(p["ln2"])
            for name, t in p["attn"].items():
                blk.attn[name].copy_(t)
            for name, t in p["ffn"].items():
                blk.ffn[name].copy_(t)
        self.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            self.lm_head.copy_(embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                          cfg.param_dtype).T)
        return self

    # -- shared trunk ----------------------------------------------------
    def _embed(self, tokens):
        return self.embed[tokens].to(self.cfg.dtype)

    def _trunk(self, x):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            x, a, _ = block_train(blk, x, self.cfg,
                                  use_flash_kernel=self.use_flash_kernel)
            aux = aux + a
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps), aux

    def _logits(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        logits = x @ head.to(x.dtype)
        vm = vocab_mask(self.cfg, x.device)
        if vm is not None:
            logits = logits + vm.to(logits.dtype)
        return logits

    # -- training --------------------------------------------------------
    def loss(self, batch):
        """batch: {tokens [B,S], labels [B,S], (mask [B,S])}."""
        x, aux = self._trunk(self._embed(batch["tokens"]))
        logits = self._logits(x)
        return cross_entropy_loss(logits, batch["labels"],
                                  batch.get("mask")) + 0.01 * aux

    def logits_fn(self, batch):
        x, _ = self._trunk(self._embed(batch["tokens"]))
        return self._logits(x)

    # -- decode -----------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int) -> attn.KVCache:
        one = attn.init_cache(self.cfg, batch, cache_len, self.cfg.dtype,
                              self.device)
        L = self.cfg.n_layers
        return attn.KVCache(*(t.expand(L, *t.shape).clone() for t in one))

    def decode_step(self, cache: attn.KVCache, tokens):
        """tokens: [B, 1] -> (logits [B,1,V], cache). The cache's k/v are
        updated in place; the returned cache has ``length + 1``."""
        x = self._embed(tokens)
        lengths = []
        for i, blk in enumerate(self.blocks):
            layer = attn.KVCache(cache.k[i], cache.v[i], cache.length[i])
            x, layer = block_decode(blk, x, layer, self.cfg)
            lengths.append(layer.length)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x), attn.KVCache(cache.k, cache.v,
                                             torch.stack(lengths))

    def prefill(self, tokens, cache_len: int):
        """Full forward returning (last-position logits, populated cache)."""
        cfg = self.cfg
        x = self._embed(tokens)
        S = x.shape[1]
        ks, vs = [], []
        for blk in self.blocks:
            x, _, (k, v) = block_train(blk, x, cfg, return_kv=True,
                                       use_flash_kernel=self.use_flash_kernel)
            ks.append(k)
            vs.append(v)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        ks_, vs_ = torch.stack(ks), torch.stack(vs)
        del ks, vs
        C = min(cache_len, cfg.window) if cfg.attn_variant == "swa" else cache_len
        pad = C - ks_.shape[2]
        if pad > 0:
            ks_ = F.pad(ks_, (0, 0, 0, 0, 0, pad))
            vs_ = F.pad(vs_, (0, 0, 0, 0, 0, pad))
        elif cfg.attn_variant == "swa" and S > C:
            # align the sliced window with the ring-buffer slot convention
            # (token t lives at slot t % C)
            ks_ = torch.roll(ks_, S % C, dims=2)
            vs_ = torch.roll(vs_, S % C, dims=2)
        if cfg.cache_dtype is not None:
            ks_ = ks_.to(cfg.cache_dtype)
            vs_ = vs_.to(cfg.cache_dtype)
        length = torch.full((cfg.n_layers,), S, dtype=torch.int32,
                            device=x.device)
        return self._logits(x[:, -1:]), attn.KVCache(k=ks_, v=vs_,
                                                     length=length)
