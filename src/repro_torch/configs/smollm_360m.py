"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M]

15 query heads / 5 kv heads padded to 16/8 physical (masked), as in the
reference.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
        d_ff=2560, vocab=49152, d_head=64,
        n_heads_padded=16, n_kv_heads_padded=8,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        rope_theta=10000.0,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=3, n_kv_heads=1,
        d_ff=512, vocab=512, vocab_padded=0, d_head=64,
        dtype=torch.float32, param_dtype=torch.float32,
        n_heads_padded=4, n_kv_heads_padded=1,
    )
