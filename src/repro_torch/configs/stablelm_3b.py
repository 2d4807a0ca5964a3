"""stablelm-3b [dense] — MHA (kv=32). [hf:stabilityai/stablelm-2-1_6b]"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab=50304, d_head=80,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        rope_theta=10000.0,
        source="hf:stabilityai/stablelm-2-1_6b",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab=512, vocab_padded=0, d_head=64,
        dtype=torch.float32, param_dtype=torch.float32,
        n_heads_padded=0, n_kv_heads_padded=0,
    )
