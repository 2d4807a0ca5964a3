"""llava-next-34b [vlm] — anyres tiling. [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The reference's config. Language backbone only: the vision tower and its
projector are stubbed, as in the reference — 2880 precomputed patch
embeddings (anyres: 4 tiles + 1 base image × 576 patches) go before the
text tokens (``DecoderLM.prefill(..., frontend_embeds=)``). 56 query
heads are padded to 64 physical (masked). Full width on one card:
prefill attention through K3 (d_head 128, GQA 8:1) over the frontend
positions and the prompt. The 60 layers (≈ 70.5 GB in bf16 with the
embedding and head) leave no room for activations on one 80 GB card; a
caller cuts the depth (``dataclasses.replace(config(), n_layers=...)``).
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab=64000, d_head=128,
        n_heads_padded=64, n_kv_heads_padded=8,
        n_frontend_embeds=2880,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        rope_theta=5000000.0,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, vocab_padded=0, d_head=64, n_frontend_embeds=16,
        dtype=torch.float32, param_dtype=torch.float32,
        n_heads_padded=4, n_kv_heads_padded=2,
    )
