"""hymba-1.5b [hybrid] — parallel attention + mamba heads. [arXiv:2411.13676]

The reference's config. 25 query heads / 5 kv heads are padded to 32/8
physical (masked) for shardability. The attention branch uses
sliding-window attention (Hymba uses SWA in most layers) with a window of
1024, on K3 in prefill (d_head 64, GQA 4:1) and on a ring buffer of 1024
slots in decode; the SSM branch runs a selective scan with state 16 in
torch ops (``models.ssm._mamba_core``). Full width and depth on one card:
≈ 1.46B parameters, 2.9 GB in bf16.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="dense", hybrid=True,
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001, d_head=64, ssm_state=16,
        n_heads_padded=32, n_kv_heads_padded=8,
        attn_variant="swa", window=1024,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        source="arXiv:2411.13676",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, vocab_padded=0, d_head=64, ssm_state=8, window=64,
        dtype=torch.float32, param_dtype=torch.float32,
        n_heads_padded=4, n_kv_heads_padded=2,
    )
