"""rwkv6-1.6b [ssm] — Finch, data-dependent decay linear attention,
attention-free. [arXiv:2404.05892]

32 RWKV heads of size 64 (d_model 2048); channel mix hidden 7168.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=7168, vocab=65536, d_head=64,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        source="arXiv:2404.05892",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab=512, vocab_padded=0, d_head=64,
        dtype=torch.float32, param_dtype=torch.float32,
        n_heads_padded=0, n_kv_heads_padded=0,
    )
