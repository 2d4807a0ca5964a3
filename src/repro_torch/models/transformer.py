"""Decoder-only / encoder-decoder transformer assembly: the dense, vlm,
moe, ssm (rwkv6) and hybrid families, and the encoder-decoder.

A copy of ``repro/models/transformer.py`` in PyTorch: pre-norm residual
blocks of GQA attention and a SwiGLU FFN (dense, vlm) or a top-k expert
FFN (moe, :mod:`.moe`), of RWKV6 time mix and channel mix (ssm,
attention-free), or of parallel GQA attention and Mamba heads, averaged,
and a SwiGLU FFN (hybrid, Hymba-style; the Mamba branch is
:mod:`.ssm`'s). A vlm model puts frontend embeddings (the stubbed vision
tower's patch embeddings) before its token embeddings. ``EncDecLM`` is a
local-attention encoder over frontend embeddings (audio frames) and a
causal decoder whose blocks add cross attention to the encoder's output.
A moe model may open with dense layers (``cfg.first_dense_layers``), and
its attention may be latent (MLA, ``cfg.is_mla``; :mod:`.attention`),
whose prefill returns a stacked :class:`.attention.LatentCache` and whose
decode attends against it (Kimi-K2; the reference has neither).
The models are ``nn.Module``s that hold their weights in the reference's
shapes (``wq`` [d, H, dh], ``wo`` [H, dh, d], ``w1`` [d, f], ``moe.w1``
[E, d, f], ``tm.mu`` [5, d], …), one block per layer, so a reference
parameter tree carries across as a plain copy (:mod:`.convert`). The
layers are a Python loop where the reference scans.

``use_kernels=True`` runs the hand-written kernels: causal self attention
over a sequence (prefill, the encoder, the decoder's teacher-forced pass)
through K3, the RWKV6 scan through K4, and the three expert products of
every MoE layer, in prefill and decode, through K5. ``use_kernels=False``
is the reference's route (einsum attention, the per-token recurrence, the
expert einsums). Both compute the same function. The kernels have no
backward, so training takes the reference's route
(``launch.steps.make_train_step``). ``remat=True`` recomputes each
block's activations in the backward pass, as the reference's
``jax.checkpoint`` of its scanned layer body does. The models' weights
live on ``cuda:0`` unless the caller names another device.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .. import spans
from ..device import resolve_device
from ..kernels._shards import is_dtensor
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import (BATCH_AXES, ModelConfig, as_dtensor, cross_entropy_loss,
                     dense_init, embed_init, maybe_shard, rmsnorm, swiglu,
                     vocab_mask)

class _Lookup(torch.autograd.Function):
    """``table[tokens]`` on DTensors, the forward DTensor's own index; the
    backward scatters each rank's rows of the output's gradient into a
    table of its own (``index_put``, accumulating) and states the result's
    placements: a partial sum over a mesh dim the tokens are split on, the
    columns split where the gradient's are. DTensor's own ``index_put``
    for that gradient fails on torch 2.11 where the gradient comes in as a
    partial sum (it names a shard dim -1)."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table = (table.shape, table.stride(), table.dtype)
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        tokens, = ctx.saved_tensors
        shape, stride, dtype = ctx.table
        mesh = g.device_mesh
        gp, tp, wp = [], [], []
        for pg, pt in zip(g.placements, tokens.placements):
            if pg == Shard(2):        # the columns: a table's column shard
                gp.append(pg), tp.append(Replicate()), wp.append(Shard(1))
            elif isinstance(pt, Shard):   # the tokens' rows: a partial sum
                gp.append(pt), tp.append(pt), wp.append(Partial())
            else:
                gp.append(Replicate()), tp.append(Replicate())
                wp.append(Replicate())
        gl = g.contiguous().redistribute(mesh, gp).to_local()
        tl = tokens.redistribute(mesh, tp).to_local()
        wl = torch.zeros((shape[0], gl.shape[-1]), dtype=dtype,
                         device=gl.device)
        wl.index_put_((tl,), gl.to(dtype), accumulate=True)
        return DTensor.from_local(wl, mesh, wp, run_check=False,
                                  shape=shape, stride=stride), None


def lookup(table, tokens):
    """``table[tokens]``: the rows of an embedding table; on a mesh (a
    DTensor table) through :class:`_Lookup`."""
    if not is_dtensor(table):
        return table[tokens]
    return _Lookup.apply(table, as_dtensor(tokens, table.device_mesh))


# ---------------------------------------------------------------------------
# per-layer parameters


def init_ffn_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": dense_init(gen, d, (d, f), cfg.param_dtype),
        "w3": dense_init(gen, d, (d, f), cfg.param_dtype),
        "w2": dense_init(gen, f, (f, d), cfg.param_dtype),
    }


def init_block_params(gen: torch.Generator, cfg: ModelConfig,
                      cross_attention: bool = False, layer: int = 0) -> dict:
    """Layer ``layer``'s weights, but for a moe layer's expert weights:
    ``DecoderLM.init`` draws those next, straight into their parameters
    (``moe.init_moe_params``). ``cross_attention`` adds a decoder block's
    ``xattn`` and ``ln_x``."""
    ones = torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device)
    p = {"ln1": ones, "ln2": ones.clone()}
    if cfg.family == "ssm":
        p["tm"] = ssm_mod.init_rwkv_params(gen, cfg)
        p["cm"] = ssm_mod.init_rwkv_cm_params(gen, cfg)
        return p
    p["attn"] = (attn.init_mla_params(gen, cfg) if cfg.is_mla
                 else attn.init_attn_params(gen, cfg))
    if cfg.hybrid:
        p["mamba"] = ssm_mod.init_mamba_params(gen, cfg)
    if cross_attention:
        p["xattn"] = attn.init_attn_params(gen, cfg)
        p["ln_x"] = ones.clone()
    if not cfg.has_experts(layer):
        p["ffn"] = init_ffn_params(gen, cfg)
    return p


def _empty(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _attn_params(cfg: ModelConfig, device) -> nn.ParameterDict:
    d, dt = cfg.d_model, cfg.param_dtype
    if cfg.is_mla:
        return nn.ParameterDict({
            n: _empty(shape, dt, device)
            for n, (shape, _) in attn.mla_param_shapes(cfg).items()})
    H, KV, dh = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.d_head
    return nn.ParameterDict({
        "wq": _empty((d, H, dh), dt, device),
        "wk": _empty((d, KV, dh), dt, device),
        "wv": _empty((d, KV, dh), dt, device),
        "wo": _empty((H, dh, d), dt, device)})


class Block(nn.Module):
    """One dense, moe or hybrid block's weights: ``ln1``, ``ln2``,
    ``attn.{wq,wk,wv,wo}`` (latent attention: ``attn.{wq_a, q_norm, wq_b,
    wkv_a, kv_norm, wkv_b, wo}``), and ``ffn.{w1,w3,w2}`` (dense, or a
    moe model's leading dense layer ``layer``) or ``moe.{router,w1,w3,w2}``
    with, given sigmoid routing, ``moe.router_bias`` and, given shared
    experts, ``moe.{shared_w1,shared_w3,shared_w2}`` (moe; the router and
    its bias float32).
    A hybrid block adds ``mamba.{in_proj, conv, w_bc, w_dt, dt_bias, logA,
    D, out_proj}`` (``logA`` float32). A decoder block of an
    encoder-decoder (``cross_attention``) adds ``xattn.{wq,wk,wv,wo}`` and
    ``ln_x``."""

    def __init__(self, cfg: ModelConfig, device=None,
                 cross_attention: bool = False, layer: int = 0):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.ln1 = _empty((d,), dt, device)
        self.ln2 = _empty((d,), dt, device)
        self.attn = _attn_params(cfg, device)
        if cfg.hybrid:
            self.mamba = nn.ParameterDict({
                name: _empty(shape, t, device)
                for name, (shape, t) in ssm_mod.mamba_param_shapes(cfg).items()})
        if cross_attention:
            self.xattn = _attn_params(cfg, device)
            self.ln_x = _empty((d,), dt, device)
        if cfg.has_experts(layer):
            self.moe = nn.ParameterDict({
                name: _empty(shape, t, device)
                for name, (shape, t) in moe_mod.moe_param_shapes(cfg).items()})
        else:
            self.ffn = nn.ParameterDict({
                "w1": _empty((d, f), dt, device),
                "w3": _empty((d, f), dt, device),
                "w2": _empty((f, d), dt, device)})


class RWKVBlock(nn.Module):
    """One rwkv6 block's weights: ``ln1``, ``ln2``, the time mix
    ``tm.{mu, shift_lora_a, shift_lora_b, wr, wk, wv, wg, wo, w0,
    w_lora_a, w_lora_b, u, ln_out}`` and the channel mix ``cm.{mu_k, wk,
    wv}``, in the reference's shapes."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
        H, dh = ssm_mod._heads(cfg)
        r = ssm_mod.LORA_DIM
        self.ln1 = _empty((d,), dt, device)
        self.ln2 = _empty((d,), dt, device)
        self.tm = nn.ParameterDict({
            "mu": _empty((5, d), dt, device),
            "shift_lora_a": _empty((d, r), dt, device),
            "shift_lora_b": _empty((r, 5, d), dt, device),
            **{n: _empty((d, d), dt, device)
               for n in ("wr", "wk", "wv", "wg", "wo")},
            "w0": _empty((d,), dt, device),
            "w_lora_a": _empty((d, r), dt, device),
            "w_lora_b": _empty((r, d), dt, device),
            "u": _empty((H, dh), dt, device),
            "ln_out": _empty((d,), dt, device)})
        self.cm = nn.ParameterDict({
            "mu_k": _empty((d,), dt, device), "wk": _empty((d, f), dt, device),
            "wv": _empty((f, d), dt, device)})


# ---------------------------------------------------------------------------
# block forward (training / prefill path)


def block_train(p, x, cfg: ModelConfig, enc_out=None, return_kv=False,
                use_kernels=False):
    """One residual block over the full sequence. Returns (x, aux, kv).
    ``enc_out`` (a decoder block of an encoder-decoder) adds cross
    attention to it after the self attention. A hybrid block averages the
    attention and the Mamba branch; its ``kv`` is ((k, v), the
    ``MambaState`` after the last token)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    kv = None
    if cfg.family == "ssm":
        # the "kv" of an rwkv block is its state after the last token
        y, S_final = ssm_mod.rwkv_time_mix_scan(p.tm, h, cfg, use_kernels)
        x = x + y
        h2 = rmsnorm(x, p.ln2, cfg.norm_eps)
        if return_kv:
            kv = ssm_mod.RWKVState(shift=h[:, -1], shift_cm=h2[:, -1],
                                   S=S_final)
        y = ssm_mod.rwkv_channel_mix(p.cm, h2, ssm_mod.token_shift(h2))
        return x + y, aux, kv
    with spans.span("repro_torch.attention"):
        if cfg.is_mla:  # the cache's latent is attention's own
            y, kv = attn.mla_train(p.attn, h, cfg,
                                   use_flash_kernel=use_kernels)
        else:
            y = attn.attend_train(p.attn, h, cfg, use_flash_kernel=use_kernels)
            if return_kv:
                # re-derive K/V for the cache, as the reference does
                kv = _project_kv(p.attn, h, cfg)
    if cfg.hybrid:
        ym, m_state = ssm_mod.mamba_scan(p.mamba, h, cfg)
        y = 0.5 * (y + ym)
        if return_kv:
            kv = (kv, m_state)
    x = x + y
    if enc_out is not None:
        hx = rmsnorm(x, p.ln_x, cfg.norm_eps)
        x = x + attn.attend_train(p.xattn, hx, cfg, kv_x=enc_out,
                                  causal=False)
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    if hasattr(p, "moe"):
        y, moe_aux = moe_mod.moe_ffn(p.moe, h, cfg, use_kernels)
        aux = moe_aux["lb_loss"]
    else:
        y = swiglu(h, p.ffn["w1"], p.ffn["w3"], p.ffn["w2"])
    return x + y, aux, kv


def _project_kv(ap, x, cfg: ModelConfig):
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None, :]
    k = attn._project(x, ap["wk"])
    v = attn._project(x, ap["wv"])
    k = attn.apply_rope(k, pos, cfg.rope_theta)
    if cfg.attn_variant == "swa":
        k, v = k[:, -cfg.window:], v[:, -cfg.window:]
    return k, v


def _layer_view(names, tensors) -> SimpleNamespace:
    """A block's parameters as ``block_train`` reads them (``p.ln1``,
    ``p.attn["wq"]``, ...) from its dotted names and tensors."""
    p = {}
    for name, t in zip(names, tensors):
        group, _, leaf = name.partition(".")
        if leaf:
            p.setdefault(group, {})[leaf] = t
        else:
            p[group] = t
    return SimpleNamespace(**p)


def encoder_block(p, x, cfg: ModelConfig, window: int, use_kernels=False):
    """One encoder block of an encoder-decoder: causal self attention
    within ``window`` (no cross attention), then the SwiGLU FFN."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    x = x + attn.attend_train(p.attn, h, cfg, window=window, causal=True,
                              use_flash_kernel=use_kernels)
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    return x + swiglu(h, p.ffn["w1"], p.ffn["w3"], p.ffn["w2"])


def remat(body, blk, x, *extra):
    """``body(p, x, *extra)`` of block ``blk``'s parameters ``p`` under
    ``torch.utils.checkpoint``: the block's activations are recomputed in
    the backward pass. The block's tensors (and ``extra``, tensors or
    not) go in as arguments, so the recomputation reads the ones of the
    forward pass even where ``torch.func.functional_call`` swapped them
    in for that pass only."""
    names, tensors = zip(*blk.named_parameters())
    n = len(extra)

    def run(x, *args):
        return body(_layer_view(names, args[n:]), x, *args[:n])

    return torch.utils.checkpoint.checkpoint(run, x, *extra, *tensors,
                                             use_reentrant=False)


# ---------------------------------------------------------------------------
# block decode (one token)


def block_decode(p, x, cache, cfg: ModelConfig, enc_kv=None,
                 use_kernels=False):
    """x: [B,1,d]; cache is the layer's KVCache (updated in place), for
    ssm its RWKVState (left as it was; the new state is returned), for
    hybrid (KVCache, MambaState) (the KV cache updated in place, the new
    MambaState returned).
    ``enc_kv`` (a decoder block of an encoder-decoder) is the layer's
    cross-attention (k, v) of the encoder's output. ``use_kernels`` sends
    a moe block's expert products through K5."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    if cfg.family == "ssm":
        y, st = ssm_mod.rwkv_time_mix_decode(p.tm, h, cache, cfg)
        x = x + y
        h2 = rmsnorm(x, p.ln2, cfg.norm_eps)
        y2 = ssm_mod.rwkv_channel_mix(p.cm, h2, st.shift_cm[:, None, :])
        return x + y2, st._replace(shift_cm=h2[:, 0])
    if cfg.hybrid:
        kv_cache, m_state = cache
        ya, kv_cache = attn.attend_decode(p.attn, h, kv_cache, cfg)
        ym, m_state = ssm_mod.mamba_decode(p.mamba, h, m_state, cfg)
        x = x + 0.5 * (ya + ym)
        new_cache = (kv_cache, m_state)
    elif cfg.is_mla:
        y, new_cache = attn.mla_decode(p.attn, h, cache, cfg)
        x = x + y
    else:
        y, new_cache = attn.attend_decode(p.attn, h, cache, cfg)
        x = x + y
    if enc_kv is not None:
        hx = rmsnorm(x, p.ln_x, cfg.norm_eps)
        x = x + _cross_attend_cached(p.xattn, hx, enc_kv, cfg)
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    if hasattr(p, "moe"):
        y, _ = moe_mod.moe_ffn(p.moe, h, cfg, use_kernels)
    else:
        y = swiglu(h, p.ffn["w1"], p.ffn["w3"], p.ffn["w2"])
    return x + y, new_cache


def _cross_attend_cached(ap, x, enc_kv, cfg: ModelConfig):
    """Cross attention against precomputed encoder K/V: enc_kv = (k, v).
    As the reference's, it applies no head mask."""
    k, v = enc_kv
    H, KV, dh = cfg.n_heads_padded, cfg.n_kv_heads_padded, cfg.d_head
    q = torch.einsum("bsd,dhk->bshk", x, ap["wq"])
    kk = attn._repeat_kv(k, H // KV)
    vv = attn._repeat_kv(v, H // KV)
    s = torch.einsum("bshk,bthk->bhst", q, kk).float() / math.sqrt(dh)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthk->bshk", pr, vv)
    return torch.einsum("bshk,hkd->bsd", out, ap["wo"])


# ---------------------------------------------------------------------------
# the model


def _fill_block(gen: torch.Generator, cfg: ModelConfig, blk: nn.Module,
                cross_attention: bool = False, layer: int = 0):
    """Fill layer ``layer``'s ``blk`` from ``gen`` (``init_block_params``,
    then a moe block's experts)."""
    for key, val in init_block_params(gen, cfg, cross_attention,
                                      layer).items():
        if isinstance(val, dict):  # a group: attn, xattn, ffn, mamba, tm, cm
            for name, t in val.items():
                getattr(blk, key)[name].copy_(t)
        else:
            getattr(blk, key).copy_(val)
    if cfg.has_experts(layer):
        moe_mod.init_moe_params(gen, cfg, blk.moe)


def _head_logits(x, head, cfg: ModelConfig):
    logits = x @ head.to(x.dtype)
    vm = vocab_mask(cfg, x.device)
    if vm is not None:
        logits = logits + vm.to(logits.dtype)
    return logits


def _stacked(one, n_layers: int):
    """A layer's cache or state (a named tuple of tensors), each tensor
    repeated over ``n_layers`` as the reference's scanned cache stacks
    them: [L, ...]."""
    return type(one)(*(t.expand(n_layers, *t.shape).clone() for t in one))


def _stacked_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
                      n_layers: int) -> attn.KVCache:
    return _stacked(attn.init_cache(cfg, batch, cache_len, cfg.dtype, device),
                    n_layers)


def _roll_slots(kv, r: int):
    """``torch.roll(kv, r, dims=2)`` (a stacked K or V [L, B, C, KV, dh]
    rolled ``r`` slots along C) as two slices concatenated: torch 2.11's
    DTensor has no strategy for ``aten.roll``."""
    return torch.cat([kv[:, :, -r:], kv[:, :, :-r]], dim=2) if r else kv


def _decode_layers(blocks, x, cache, cfg: ModelConfig, enc_kv=None,
                   use_kernels=False):
    """``block_decode`` of each block on its layer of the stacked KV
    cache (and of ``enc_kv`` (k, v) [L, ...]); returns x and the cache
    with each layer's new length. A hybrid's cache is (KVCache,
    MambaState), each stacked; each layer's new Mamba state is written
    over its old one."""
    kv, m = cache if cfg.hybrid else (cache, None)
    lengths = []
    for i, blk in enumerate(blocks):
        layer = type(kv)(*(t[i] for t in kv))
        if cfg.hybrid:
            layer = (layer, ssm_mod.MambaState(*(t[i] for t in m)))
        x, layer = block_decode(
            blk, x, layer, cfg,
            enc_kv=None if enc_kv is None else (enc_kv[0][i], enc_kv[1][i]),
            use_kernels=use_kernels)
        if cfg.hybrid:
            layer, new = layer
            for old, t in zip(m, new):
                old[i].copy_(t)
        lengths.append(layer.length)
    kv = kv._replace(length=torch.stack(lengths))
    return x, (kv, m) if cfg.hybrid else kv


class DecoderLM(nn.Module):
    """Decoder-only LM of the dense, the vlm, the moe, the ssm (rwkv6) or
    the hybrid family.

    The weights are allocated on ``device`` uninitialised (``None``:
    ``cuda:0``, which raises ``RuntimeError`` on a host without CUDA; the
    CPU runs only when named); :meth:`init`
    fills them from a ``torch.Generator`` (as the reference's ``init`` does
    from a key), or ``load_state_dict`` takes them from
    :func:`repro_torch.models.convert.params_from_reference`. The cache of
    :meth:`init_cache`/:meth:`prefill` stacks the layers as the
    reference's scanned cache does: a KV cache k, v [L, B, C, KV, dh],
    length [L] (dense), an ``RWKVState`` shift, shift_cm [L, B, d],
    S [L, B, H, dh, dh] float32 (ssm, whose prefill ignores ``cache_len``,
    as the reference's does), or (KV cache, ``MambaState`` conv
    [L, B, CONV_K - 1, d], h [L, B, d, n] float32) (hybrid), or a latent
    cache ckv [L, B, C, kv_lora + qk_rope], length [L] (latent attention).
    :meth:`decode_step` updates each in place. A sliding-window cache is a
    ring buffer of ``min(cache_len, window)`` slots, token t at slot
    ``t % C``: a prefill longer than the window rolls its last ``C`` K/V
    into place.

    A vlm's ``frontend_embeds`` [B, N, d] (:meth:`loss`, :meth:`logits_fn`,
    :meth:`prefill`) go before the token embeddings; the loss and the
    logits drop their N positions. As in the reference, a full-attention
    prefill's cache holds every position it saw even where ``cache_len``
    is shorter (the vlm demo's ``prompt_len + gen``): the cache is then
    full, and each decode step overwrites the oldest slot (``pos % C``).

    ``remat=True`` runs each block of :meth:`loss` and :meth:`logits_fn`
    under ``torch.utils.checkpoint`` while autograd records (the
    reference's ``jax.checkpoint`` of its layer body): the same values, one
    layer's activations live at a time in the backward pass. Calling the
    model is :meth:`loss`, so ``torch.func.functional_call(model, params,
    (batch,))`` gives the loss at ``params``.
    """

    def __init__(self, cfg: ModelConfig, use_kernels: bool = True,
                 device=None, remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.remat = remat
        dt, d, vp = cfg.param_dtype, cfg.d_model, cfg.vocab_padded
        self.embed = _empty((vp, d), dt, device)
        self.blocks = nn.ModuleList(
            RWKVBlock(cfg, device) if cfg.family == "ssm"
            else Block(cfg, device, layer=i) for i in range(cfg.n_layers))
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
        for i, blk in enumerate(self.blocks):
            _fill_block(gen, cfg, blk, layer=i)
        self.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            self.lm_head.copy_(embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                          cfg.param_dtype).T)
        return self

    # -- shared trunk ----------------------------------------------------
    def _embed(self, tokens, frontend_embeds=None):
        x = lookup(self.embed, tokens).to(self.cfg.dtype)
        if frontend_embeds is not None:
            x = torch.cat([frontend_embeds.to(self.cfg.dtype), x], dim=1)
        return x

    def _trunk(self, x):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        checkpointed = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if checkpointed:
                x, a = remat(self._block, blk, x)
            else:
                x, a = self._block(blk, x)
            aux = aux + a
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps), aux

    def _block(self, p, x):
        x, aux, _ = block_train(p, x, self.cfg, use_kernels=self.use_kernels)
        return x, aux

    def _logits(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return maybe_shard(_head_logits(x, head, self.cfg), BATCH_AXES, None,
                           "model")

    # -- training --------------------------------------------------------
    def loss(self, batch):
        """batch: {tokens [B,S], labels [B,S], (mask [B,S]),
        (frontend_embeds [B,N,d])}."""
        fe = batch.get("frontend_embeds")
        x, aux = self._trunk(self._embed(batch["tokens"], fe))
        n_fe = 0 if fe is None else fe.shape[1]
        logits = self._logits(x[:, n_fe:])
        return cross_entropy_loss(logits, batch["labels"],
                                  batch.get("mask")) + 0.01 * aux

    def forward(self, batch):
        """The training loss of ``batch``: :meth:`loss`."""
        return self.loss(batch)

    def logits_fn(self, batch):
        fe = batch.get("frontend_embeds")
        x, _ = self._trunk(self._embed(batch["tokens"], fe))
        n_fe = 0 if fe is None else fe.shape[1]
        return self._logits(x[:, n_fe:])

    # -- decode -----------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int):
        cfg, L = self.cfg, self.cfg.n_layers
        if cfg.family == "ssm":
            return _stacked(ssm_mod.init_rwkv_state(cfg, batch, self.device),
                            L)
        kv = _stacked_kv_cache(cfg, batch, cache_len, self.device, L)
        if cfg.hybrid:
            return kv, _stacked(
                ssm_mod.init_mamba_state(cfg, batch, self.device), L)
        return kv

    def decode_step(self, cache, tokens):
        """tokens: [B, 1] -> (logits [B,1,V], cache). The cache's tensors
        are updated in place (a KV cache's k/v, every tensor of an
        ``RWKVState`` or a ``MambaState``); a returned KV cache has
        ``length + 1``."""
        x = self._embed(tokens)
        if self.cfg.family == "ssm":
            for i, blk in enumerate(self.blocks):
                layer = ssm_mod.RWKVState(*(t[i] for t in cache))
                x, new = block_decode(blk, x, layer, self.cfg)
                for old, t in zip(layer, new):
                    old.copy_(t)
            x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
            return self._logits(x), cache
        x, cache = _decode_layers(self.blocks, x, cache, self.cfg,
                                  use_kernels=self.use_kernels)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x), cache

    def prefill(self, tokens, cache_len: int, frontend_embeds=None):
        """Full forward returning (last-position logits, populated cache).
        A vlm's ``frontend_embeds`` [B, N, d] go before the tokens. A
        hybrid's cache is (KV cache, the stacked ``MambaState``)."""
        with spans.span("repro_torch.prefill"):
            return self._prefill(tokens, cache_len, frontend_embeds)

    def _prefill(self, tokens, cache_len: int, frontend_embeds):
        cfg = self.cfg
        x = self._embed(tokens, frontend_embeds)
        S = x.shape[1]
        if cfg.family == "ssm":
            states = []
            for blk in self.blocks:
                x, _, st = block_train(blk, x, cfg, return_kv=True,
                                       use_kernels=self.use_kernels)
                states.append(st)
            x = rmsnorm(x, self.final_norm, cfg.norm_eps)
            return self._logits(x[:, -1:]), ssm_mod.RWKVState(
                *(torch.stack(t) for t in zip(*states)))
        if cfg.is_mla:
            return self._prefill_latent(x, cache_len)
        ks, vs, ms = [], [], []
        for blk in self.blocks:
            x, _, kv = block_train(blk, x, cfg, return_kv=True,
                                   use_kernels=self.use_kernels)
            if cfg.hybrid:
                kv, m = kv
                ms.append(m)
            ks.append(kv[0])
            vs.append(kv[1])
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
            ks_ = _roll_slots(ks_, S % C)
            vs_ = _roll_slots(vs_, S % C)
        if cfg.cache_dtype is not None:
            ks_ = ks_.to(cfg.cache_dtype)
            vs_ = vs_.to(cfg.cache_dtype)
        length = torch.full((cfg.n_layers,), S, dtype=torch.int32,
                            device=x.device)
        cache = attn.KVCache(k=ks_, v=vs_, length=length)
        if cfg.hybrid:
            cache = (cache, ssm_mod.MambaState(
                *(torch.stack(t) for t in zip(*ms))))
        return self._logits(x[:, -1:]), cache

    def _prefill_latent(self, x, cache_len: int):
        """Latent attention's prefill: each layer's [c | k_pe] a token
        stacked into a :class:`.attention.LatentCache` of ``cache_len``
        slots (at least the prompt's)."""
        cfg = self.cfg
        S = x.shape[1]
        lats = []
        for blk in self.blocks:
            x, _, lat = block_train(blk, x, cfg, return_kv=True,
                                    use_kernels=self.use_kernels)
            lats.append(lat)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        ckv = torch.stack(lats)
        del lats
        if cache_len > S:
            ckv = F.pad(ckv, (0, 0, 0, cache_len - S))
        if cfg.cache_dtype is not None:
            ckv = ckv.to(cfg.cache_dtype)
        length = torch.full((cfg.n_layers,), S, dtype=torch.int32,
                            device=x.device)
        return self._logits(x[:, -1:]), attn.LatentCache(ckv=ckv,
                                                         length=length)


class EncDecLM(nn.Module):
    """Encoder-decoder (audio) model: a local-attention encoder over
    frontend embeddings (frames), a causal decoder with cross attention.

    The weights, as the reference's ``EncDecLM.init`` tree: ``embed``
    [vocab, d] (unpadded, unlike ``lm_head`` [d, vocab_padded]),
    ``enc_blocks``, ``enc_norm``, ``dec_blocks`` (each with ``xattn`` and
    ``ln_x``), ``final_norm``, ``lm_head``; allocated on ``device``
    (``None``: ``cuda:0``, which raises ``RuntimeError`` without CUDA).
    :meth:`encode` runs causal self attention within ``encoder_window``
    (1024 when the config gives none) on K3 with ``use_kernels``; so do
    the decoder's self attention in :meth:`logits_fn` and :meth:`loss`,
    whose cross attention stays on the einsum chain, as do
    :meth:`decode_step`'s. :meth:`loss` reads ``batch["frontend_embeds"]``
    (the frames), as the reference's does. ``remat`` checkpoints each
    encoder and decoder block while autograd records.
    """

    def __init__(self, cfg: ModelConfig, use_kernels: bool = True,
                 device=None, remat: bool = False):
        super().__init__()
        if cfg.encoder_layers <= 0:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                             "encoder_layers > 0")
        device = resolve_device(device)
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.remat = remat
        dt, d = cfg.param_dtype, cfg.d_model
        self.embed = _empty((cfg.vocab, d), dt, device)
        self.enc_blocks = nn.ModuleList(Block(cfg, device)
                                        for _ in range(cfg.encoder_layers))
        self.enc_norm = _empty((d,), dt, device)
        self.dec_blocks = nn.ModuleList(
            Block(cfg, device, cross_attention=True)
            for _ in range(cfg.n_layers))
        self.final_norm = _empty((d,), dt, device)
        self.lm_head = _empty((d, cfg.vocab_padded), dt, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "EncDecLM":
        """Fill the weights from ``gen`` (a generator on the model's
        device); returns the model."""
        cfg = self.cfg
        self.embed.copy_(embed_init(gen, cfg.vocab, cfg.d_model,
                                    cfg.param_dtype))
        for blk in self.enc_blocks:
            _fill_block(gen, cfg, blk)
        self.enc_norm.fill_(1.0)
        for blk in self.dec_blocks:
            _fill_block(gen, cfg, blk, cross_attention=True)
        self.final_norm.fill_(1.0)
        self.lm_head.copy_(embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                      cfg.param_dtype).T)
        return self

    def _checkpointed(self):
        return self.remat and torch.is_grad_enabled()

    def _enc_block(self, p, x):
        return encoder_block(p, x, self.cfg, self.cfg.encoder_window or 1024,
                             self.use_kernels)

    def _dec_block(self, p, x, enc):
        x, _, _ = block_train(p, x, self.cfg, enc_out=enc,
                              use_kernels=self.use_kernels)
        return x

    def encode(self, frames):
        """frames [B, Se, d] -> the encoder's output [B, Se, d]."""
        x = frames.to(self.cfg.dtype)
        for blk in self.enc_blocks:
            x = (remat(self._enc_block, blk, x) if self._checkpointed()
                 else self._enc_block(blk, x))
        return rmsnorm(x, self.enc_norm, self.cfg.norm_eps)

    def logits_fn(self, batch):
        """The decoder's teacher-forced logits [B, Sd, V] of
        ``batch["tokens"]`` [B, Sd] given ``batch["frontend_embeds"]``
        [B, Se, d]: what :meth:`loss` scores."""
        enc = self.encode(batch["frontend_embeds"])
        x = lookup(self.embed, batch["tokens"]).to(self.cfg.dtype)
        for blk in self.dec_blocks:
            x = (remat(self._dec_block, blk, x, enc) if self._checkpointed()
                 else self._dec_block(blk, x, enc))
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return _head_logits(x, self.lm_head, self.cfg)

    def loss(self, batch):
        """batch: {frontend_embeds [B,Se,d], tokens [B,Sd], labels [B,Sd],
        (mask [B,Sd])}."""
        return cross_entropy_loss(self.logits_fn(batch), batch["labels"],
                                  batch.get("mask"))

    def forward(self, batch):
        """The training loss of ``batch``: :meth:`loss`."""
        return self.loss(batch)

    def init_cache(self, batch: int, cache_len: int) -> attn.KVCache:
        """The decoder's self-attention cache, stacked over its layers."""
        return _stacked_kv_cache(self.cfg, batch, cache_len, self.device,
                                 self.cfg.n_layers)

    def precompute_enc_kv(self, enc_out):
        """Per decoder layer, the cross attention's K/V of the encoder's
        output: (k, v), each [L, B, Se, KV, dh]."""
        ks = [torch.einsum("bsd,dhk->bshk", enc_out, blk.xattn["wk"])
              for blk in self.dec_blocks]
        vs = [torch.einsum("bsd,dhk->bshk", enc_out, blk.xattn["wv"])
              for blk in self.dec_blocks]
        return torch.stack(ks), torch.stack(vs)

    def decode_step(self, cache, tokens, enc_kv):
        """tokens: [B, 1] -> (logits [B,1,V], cache), attending to the
        encoder through ``enc_kv`` (:meth:`precompute_enc_kv`). The cache's
        k/v are updated in place; the returned cache has ``length + 1``."""
        x = lookup(self.embed, tokens).to(self.cfg.dtype)
        x, cache = _decode_layers(self.dec_blocks, x, cache, self.cfg,
                                  enc_kv=enc_kv, use_kernels=self.use_kernels)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return _head_logits(x, self.lm_head, self.cfg), cache
