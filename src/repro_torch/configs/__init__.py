"""Architecture registry of the port: the dense decoder-only archs,
mixtral-8x22b and kimi-k2-1t-a32b (moe), rwkv6-1.6b (ssm),
llava-next-34b (vlm) and seamless-m4t-large-v2 (encoder-decoder).

Copies of the reference's configs (``repro/configs``) with torch dtypes.
The reference's hybrid architecture needs a model family the port has
not reached yet; asking for it raises ``NotImplementedError`` naming
the ROADMAP item that ports it.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig

# arch id -> module name
ARCHS = {
    "granite-3-2b": "granite_3_2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama3.2-3b": "llama3_2_3b",
    "llava-next-34b": "llava_next_34b",
    "mixtral-8x22b": "mixtral_8x22b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "smollm-360m": "smollm_360m",
    "stablelm-3b": "stablelm_3b",
}

# the reference's other arch -> its family (transformer.NOT_PORTED names
# the ROADMAP item that ports it)
NOT_PORTED = {
    "hymba-1.5b": "hybrid",
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch in NOT_PORTED:
        family = NOT_PORTED[arch]
        raise NotImplementedError(
            f"{arch} is not ported yet: the {family} family; see ROADMAP.md, "
            f"modules still to port, {transformer.NOT_PORTED[family]}")
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}; known: {sorted(ARCHS)}")
    mod = import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.reduced_config() if reduced else mod.config()


def all_archs():
    return list(ARCHS)
