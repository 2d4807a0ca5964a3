"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]

The reference's config. Full width on one card: attention through K3
(d_head 128, window 4096), the expert products through K5. The 56 layers
(140.6 B parameters, 281 GB in bf16) do not fit one card; a caller cuts
the depth (``dataclasses.replace(config(), n_layers=...)``).
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=32768, d_head=128,
        n_experts=8, top_k=2, moe_d_ff=16384,
        attn_variant="swa", window=4096,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        rope_theta=1000000.0,
        source="arXiv:2401.04088",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, vocab_padded=0, d_head=64,
        n_experts=4, top_k=2, moe_d_ff=512, window=64,
        dtype=torch.float32, param_dtype=torch.float32,
        n_heads_padded=0, n_kv_heads_padded=0,
    )
