"""Unified model API + input-shape catalogue (the dense, moe and ssm
families).

``build_model(cfg)`` returns a :class:`DecoderLM` exposing
    init(generator) -> the model, weights filled
    loss(batch) -> scalar                    (train path)
    prefill(tokens, cache_len) -> (logits, cache)
    decode_step(cache, tokens) -> (logits, cache)

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
from .transformer import DecoderLM

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


def shape_for_long_context(cfg: ModelConfig) -> ModelConfig:
    """Sub-quadratic variant used for long_500k: SSM/hybrid run natively;
    full-attention families switch to the sliding-window variant."""
    if cfg.family == "ssm" or cfg.attn_variant == "swa":
        return cfg
    return dataclasses.replace(cfg, attn_variant="swa", window=8192)


def build_model(cfg: ModelConfig, use_kernels: bool = True,
                device=None, remat: bool = False) -> DecoderLM:
    """The model of ``cfg`` with its weights allocated on ``device``
    (uninitialised: call ``init`` or ``load_state_dict``). The device
    defaults to ``cuda:0`` and raises ``RuntimeError`` on a host without
    CUDA: the CPU runs only when named (``device="cpu"``). With
    ``use_kernels`` (the default) the model runs on the hand-written
    kernels (K3 prefill attention, K4 rwkv scan, K5 expert products in
    prefill and decode); ``False`` is the reference's route. ``remat``
    recomputes each block's activations in the backward pass. Raises
    ``NotImplementedError`` for a family the port has not reached."""
    return DecoderLM(cfg, use_kernels=use_kernels, device=device,
                     remat=remat)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str):
    """Returns (kind, specs): specs maps the step's inputs to meta tensors
    of their shapes and dtypes (int32 tokens, as the reference's), for the
    dense, moe and ssm families (the others raise
    ``NotImplementedError``): ``{"batch": {"tokens", "labels"}}`` [B, S]
    (train), ``{"tokens"}`` [B, S] (prefill), or ``{"cache", "tokens"}``
    with the model's stacked cache ``seq`` long and tokens [B, 1]
    (decode, for ``shape_for_long_context(cfg)``)."""
    spec = SHAPES[shape_name]
    kind, S, B = spec["kind"], spec["seq"], spec["batch"]
    if kind == "decode":
        cfg = shape_for_long_context(cfg)
    model = build_model(cfg, device="meta")
    tok = torch.int32
    if kind == "train":
        return kind, {"batch": {"tokens": _meta((B, S), tok),
                                "labels": _meta((B, S), tok)}}
    if kind == "prefill":
        return kind, {"tokens": _meta((B, S), tok)}
    return kind, {"cache": model.init_cache(B, S),
                  "tokens": _meta((B, 1), tok)}


def params_spec(cfg: ModelConfig, shape_name: str = "train_4k") -> dict:
    """The model's parameters as meta tensors, by name (no allocation)."""
    if SHAPES[shape_name]["kind"] == "decode":
        cfg = shape_for_long_context(cfg)
    return dict(build_model(cfg, device="meta").named_parameters())
