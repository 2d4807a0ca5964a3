"""kimi-k2-1t-a32b [moe] — trillion-param MoE: 384 experts, top-8, one
shared expert, moe_ff=2048. [arXiv:2501.kimi2 — paper-table entry]

The reference's config, mirrored so that the registry stays equal to the
JAX package's: a paper-table guess (GQA 64/8 heads of 112, softmax
routing, rope theta 1e6, no leading dense layer), not the published
model. The published Kimi-K2-Instruct (latent attention with q/k 192 and
v 128, YaRN, sigmoid routing with a selection bias, a leading dense
layer) is ``gpubench/configs/kimi-k2-instruct.json``, which
``gpubench/port/mla_moe.py`` turns into its ``ModelConfig``.
d_head = 7168/64 = 112, which K3 takes, so the full-width model's prefill
attention runs on K3 on the card; its reduced config has d_head 64.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab=163840, d_head=112,
        n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=1,
        capacity_factor=1.25,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        rope_theta=1000000.0,
        source="arXiv:2501.kimi2",
    )


def reduced_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512, vocab_padded=0, d_head=64,
        n_experts=4, top_k=2, moe_d_ff=256, n_shared_experts=1,
        dtype=torch.float32, param_dtype=torch.float32,
        n_heads_padded=0, n_kv_heads_padded=0,
    )
