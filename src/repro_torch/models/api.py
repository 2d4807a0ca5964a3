"""Unified model API + input-shape catalogue (the dense, moe and ssm
families).

``build_model(cfg)`` returns a :class:`DecoderLM` exposing
    init(generator) -> the model, weights filled
    loss(batch) -> scalar                    (train path)
    prefill(tokens, cache_len) -> (logits, cache)
    decode_step(cache, tokens) -> (logits, cache)

The reference's ``input_specs``/``params_spec`` are dry-run tooling and
are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

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
                device=None) -> DecoderLM:
    """The model of ``cfg`` with its weights allocated on ``device``
    (uninitialised: call ``init`` or ``load_state_dict``). The device
    defaults to ``cuda:0`` and raises ``RuntimeError`` on a host without
    CUDA: the CPU runs only when named (``device="cpu"``). With
    ``use_kernels`` (the default) the model runs on the hand-written
    kernels (K3 prefill attention, K4 rwkv scan, K5 expert products in
    prefill and decode); ``False`` is the reference's route. Raises
    ``NotImplementedError`` for a family the port has not reached."""
    return DecoderLM(cfg, use_kernels=use_kernels, device=device)
