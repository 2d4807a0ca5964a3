"""Architecture registry of the port: the dense decoder-only archs,
mixtral-8x22b and kimi-k2-1t-a32b (moe), rwkv6-1.6b (ssm),
llava-next-34b (vlm), seamless-m4t-large-v2 (encoder-decoder) and
hymba-1.5b (hybrid): every arch of the reference's registry.

Copies of the reference's configs (``repro/configs``) with torch dtypes.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.common import ModelConfig

# arch id -> module name
ARCHS = {
    "granite-3-2b": "granite_3_2b",
    "hymba-1.5b": "hymba_1_5b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama3.2-3b": "llama3_2_3b",
    "llava-next-34b": "llava_next_34b",
    "mixtral-8x22b": "mixtral_8x22b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "smollm-360m": "smollm_360m",
    "stablelm-3b": "stablelm_3b",
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}; known: {sorted(ARCHS)}")
    mod = import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.reduced_config() if reduced else mod.config()


def all_archs():
    return list(ARCHS)


def paper_model(name: str, **kw):
    """The paper's own evaluation models (Section 5.1): ``"shakespeare-lstm"``,
    ``"kwt1"`` or ``"convnet"``, built with ``kw`` (their widths, and
    ``device``: ``cuda:0`` unless named)."""
    from repro_torch.models.paper_models import ConvNet, KWTModel, LSTMModel
    builders = {
        "shakespeare-lstm": lambda: LSTMModel(**kw),
        "kwt1": lambda: KWTModel(**kw),
        "convnet": lambda: ConvNet(**kw),
    }
    return builders[name]()
