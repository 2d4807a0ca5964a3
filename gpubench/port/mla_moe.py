"""The mla_moe family's configuration file as the program's model
configuration."""
from __future__ import annotations

from gpubench.arch.mla_moe import Arch, check_config
from gpubench.core.weights import dtype


def model_config(config: dict):
    """The ``repro_torch.models.ModelConfig`` the configuration file
    states: latent attention with YaRN, the leading dense layers, the
    router over every expert with its selection bias and scaled gates,
    the held share, and the port's settings (``config["port"]``): its
    family and a capacity factor of at least experts / top_k, at which a
    held expert can take every token of its group, so that the port drops
    none of the held assignments, as the source's routing drops none."""
    from repro_torch.models.common import ModelConfig, Yarn
    check_config(config)
    a = Arch.from_config(config)
    port = config["port"]
    capacity = port["capacity_factor"]
    if capacity * a.top_k < a.n_experts:
        raise ValueError(f"capacity_factor {capacity} drops tokens: the "
                         f"source is dropless (needs >= "
                         f"{a.n_experts / a.top_k})")
    dt = dtype(a.dtype)
    return ModelConfig(
        name=a.name, family=port["family"], n_layers=a.n_layers,
        d_model=a.d_model, n_heads=a.n_heads, n_kv_heads=a.n_heads,
        d_ff=a.d_ff, vocab=a.vocab, d_head=a.d_nope,
        n_experts=a.n_experts, top_k=a.top_k, moe_d_ff=a.d_expert,
        n_shared_experts=a.n_shared, capacity_factor=capacity,
        router_score="sigmoid", routed_scale=a.routed_scale,
        experts_held=a.n_held, experts_first=a.held_first,
        first_dense_layers=a.first_dense,
        q_lora_rank=a.q_lora, kv_lora_rank=a.kv_lora, qk_rope_dim=a.d_rope,
        v_head_dim=a.d_v, rope_yarn=Yarn(*a.yarn), rope_theta=a.rope_theta,
        norm_eps=a.norm_eps, dtype=dt, param_dtype=dt,
        tie_embeddings=a.tie_embeddings, source=config["source"])
