"""granite-3-2b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base]"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab=49155,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, vocab_padded=0, d_head=64,
        dtype=torch.float32, param_dtype=torch.float32,
        n_heads_padded=0, n_kv_heads_padded=0,
    )
