"""The decoder family's configuration file as the program's model
configuration."""
from __future__ import annotations

from gpubench.arch.decoder import Arch, check_config
from gpubench.core.weights import dtype


def model_config(config: dict):
    """The ``repro_torch.models.ModelConfig`` the configuration file
    states, with the source's heads unpadded and the port's settings
    (``config["port"]``): its family and, for experts, a capacity factor
    of at least experts / top_k, at which every expert can take every
    token of its group, so that the port drops none, as the source's
    routing drops none."""
    from repro_torch.models.common import ModelConfig
    check_config(config)
    a = Arch.from_config(config)
    port = config["port"]
    dt = dtype(a.dtype)
    capacity = port.get("capacity_factor", 0.0)
    if a.n_experts and capacity * a.top_k < a.n_experts:
        raise ValueError(f"capacity_factor {capacity} drops tokens: the "
                         f"source is dropless (needs >= "
                         f"{a.n_experts / a.top_k})")
    return ModelConfig(
        name=a.name, family=port["family"], n_layers=a.n_layers,
        d_model=a.d_model, n_heads=a.n_heads, n_kv_heads=a.n_kv_heads,
        d_ff=a.d_ff, vocab=a.vocab, d_head=a.d_head,
        attn_variant="swa" if a.window else "full", window=a.window or 4096,
        n_experts=a.n_experts, top_k=a.top_k,
        moe_d_ff=a.d_ff if a.n_experts else 0,
        capacity_factor=capacity or 1.25,
        dtype=dt, param_dtype=dt, rope_theta=a.rope_theta,
        norm_eps=a.norm_eps, tie_embeddings=a.tie_embeddings,
        source=config["source"])
