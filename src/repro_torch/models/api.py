"""Unified model API + input-shape catalogue.

``build_model(cfg)`` returns a :class:`DecoderLM` (or, for a config with
encoder layers, an :class:`EncDecLM`) exposing
    init(generator) -> the model, weights filled
    loss(batch) -> scalar                    (train path)
    prefill(tokens, cache_len, frontend_embeds=None) -> (logits, cache)
    decode_step(cache, tokens) -> (logits, cache)
or, for the encoder-decoder, ``encode(frames)``,
``precompute_enc_kv(enc_out)`` and ``decode_step(cache, tokens, enc_kv)``.

``input_specs(cfg, shape_name)`` and ``params_spec(cfg)`` give the
inputs of the step a shape exercises, and the parameters, as tensors on
the meta device: shapes and dtypes, no memory (the dry run runs the steps
on them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .common import ModelConfig
from .transformer import DecoderLM, EncDecLM

# the four assigned input shapes
SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    {"kind": "train",   "seq": 4096,   "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768,  "batch": 32},
    "decode_32k":  {"kind": "decode",  "seq": 32768,  "batch": 128},
    "long_500k":   {"kind": "decode",  "seq": 524288, "batch": 1},
}

# decoder context given to the encoder-decoder (audio) model: the encoder
# consumes `seq` frontend frames; the decoder trains on seq // DEC_RATIO
# text tokens (speech-to-text length ratio).
DEC_RATIO = 4
ENC_CTX_DECODE = 4096  # encoder frames cached during decode shapes


def shape_spec(shape) -> Dict[str, Any]:
    """A shape's ``{"kind", "seq", "batch"}``: the entry of :data:`SHAPES`
    that ``shape`` names, or ``shape`` itself, a dict of those keys (a step
    of any batch and length)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def shape_for_long_context(cfg: ModelConfig) -> ModelConfig:
    """Sub-quadratic variant used for long_500k: SSM/hybrid run natively;
    full-attention families switch to the sliding-window variant."""
    if cfg.family == "ssm" or cfg.attn_variant == "swa":
        return cfg
    return dataclasses.replace(cfg, attn_variant="swa", window=8192)


def build_model(cfg: ModelConfig, use_kernels: bool = True,
                device=None, remat: bool = False, unroll: bool = False):
    """The model of ``cfg`` with its weights allocated on ``device``
    (uninitialised: call ``init`` or ``load_state_dict``): an
    :class:`EncDecLM` when ``cfg`` has encoder layers, else a
    :class:`DecoderLM`. The device defaults to ``cuda:0`` and raises
    ``RuntimeError`` on a host without CUDA: the CPU runs only when named
    (``device="cpu"``). With ``use_kernels`` (the default) the model runs
    on the hand-written kernels (K3 causal self attention, K4 rwkv scan,
    K5 expert products in prefill and decode); ``False`` is the
    reference's route. ``remat`` recomputes each block's activations in
    the backward pass. ``unroll`` is the reference's choice between a
    scan over the layers and an unrolled loop; the port's layers are
    always a Python loop, so it changes nothing."""
    cls = EncDecLM if cfg.encoder_layers > 0 else DecoderLM
    return cls(cfg, use_kernels=use_kernels, device=device, remat=remat)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str):
    """Returns (kind, specs) for the shape ``shape_name`` (a name of
    :data:`SHAPES`, or a dict of its keys: :func:`shape_spec`): specs maps
    the step's inputs to meta tensors of their shapes and dtypes (int32
    tokens, as the reference's):
    ``{"batch": {"tokens", "labels"}}`` [B, S] (train), ``{"tokens"}``
    [B, S] (prefill), or ``{"cache", "tokens"}`` with the model's stacked
    cache ``seq`` long and tokens [B, 1] (decode, for
    ``shape_for_long_context(cfg)``; a hybrid's cache is the tuple
    (KVCache of its window's slots, MambaState)). A vlm's tokens are ``seq`` less its
    N frontend positions, beside ``frontend_embeds`` [B, N, d] (train and
    prefill). The encoder-decoder's rows: ``{"batch": {"frontend_embeds"
    [B, S, d], "tokens", "labels" [B, S // DEC_RATIO]}}`` (train),
    ``{"frames"}`` [B, S, d] (prefill: encode, then the cross K/V), and
    ``{"cache", "tokens", "enc_kv"}`` with the cross K/V of
    ``ENC_CTX_DECODE`` frames (decode)."""
    spec = shape_spec(shape_name)
    kind, S, B = spec["kind"], spec["seq"], spec["batch"]
    if kind == "decode":
        cfg = shape_for_long_context(cfg)
    model = build_model(cfg, device="meta")
    tok = torch.int32

    if cfg.encoder_layers > 0:  # encoder-decoder (audio)
        frames = _meta((B, S, cfg.d_model), cfg.dtype)
        if kind == "train":
            Sd = S // DEC_RATIO
            return kind, {"batch": {"frontend_embeds": frames,
                                    "tokens": _meta((B, Sd), tok),
                                    "labels": _meta((B, Sd), tok)}}
        if kind == "prefill":
            # serving prefill = encode the audio + precompute cross K/V
            return kind, {"frames": frames}
        enc_kv = model.precompute_enc_kv(
            _meta((B, ENC_CTX_DECODE, cfg.d_model), cfg.dtype))
        return kind, {"cache": model.init_cache(B, S),
                      "tokens": _meta((B, 1), tok), "enc_kv": enc_kv}

    n_fe = cfg.n_frontend_embeds
    fe = {"frontend_embeds": _meta((B, n_fe, cfg.d_model), cfg.dtype)} \
        if n_fe else {}
    if kind == "train":
        return kind, {"batch": {"tokens": _meta((B, S - n_fe), tok),
                                "labels": _meta((B, S - n_fe), tok), **fe}}
    if kind == "prefill":
        return kind, {"tokens": _meta((B, S - n_fe), tok), **fe}
    return kind, {"cache": model.init_cache(B, S),
                  "tokens": _meta((B, 1), tok)}


def params_spec(cfg: ModelConfig, shape_name: str = "train_4k") -> dict:
    """The model's parameters as meta tensors, by name (no allocation)."""
    if shape_spec(shape_name)["kind"] == "decode":
        cfg = shape_for_long_context(cfg)
    return dict(build_model(cfg, device="meta").named_parameters())
