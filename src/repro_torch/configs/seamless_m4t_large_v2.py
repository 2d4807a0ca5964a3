"""seamless-m4t-large-v2 [audio] — enc-dec multimodal. [arXiv:2308.11596]

The reference's config. Transformer backbone only: a 24-layer
local-attention encoder over precomputed audio-frame embeddings (the
mel + conv frontend is stubbed, as in the reference) and a 24-layer
causal decoder with cross attention (``EncDecLM``). 16 heads, kv 16
(MHA), d 1024, ff 8192, vocab 256,206 (the embedding unpadded, the head
padded to 256,256). The encoder's causal window of 1024 runs on K3 at
d_head 64. ≈ 2.04B parameters, ≈ 4.1 GB in bf16: the whole model fits
one card.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=24, encoder_layers=24, encoder_window=1024,
        d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=256206, d_head=64,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        rope_theta=10000.0,
        source="arXiv:2308.11596",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, encoder_layers=2, encoder_window=32,
        d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        vocab_padded=0, d_head=32,
        dtype=torch.float32, param_dtype=torch.float32,
        n_heads_padded=0, n_kv_heads_padded=0,
    )
