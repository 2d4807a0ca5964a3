"""llama3.2-3b [dense] — small llama3, GQA. [hf:meta-llama/Llama-3.2-1B]

24 query heads are padded to 32 physical heads (masked), as in the
reference; logical math is unchanged.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, d_head=128,
        n_heads_padded=32, n_kv_heads_padded=8,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        rope_theta=500000.0,
        source="hf:meta-llama/Llama-3.2-1B",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=3, n_kv_heads=1,
        d_ff=512, vocab=512, vocab_padded=0, d_head=64,
        dtype=torch.float32, param_dtype=torch.float32,
        n_heads_padded=4, n_kv_heads_padded=1,
    )
