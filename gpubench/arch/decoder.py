"""The decoder family's sizes and weights: a decoder-only LM, dense
(SwiGLU) or with top-k softmax-routed experts, grouped-query attention,
every layer alike. Plain Python: imports nothing of the program."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str            # dense | moe
    n_layers: int
    d_model: int
    n_heads: int           # query heads that reach the output
    n_kv_heads: int
    d_head: int
    d_ff: int              # the FFN's width, or each expert's
    vocab: int
    n_experts: int = 0
    top_k: int = 0
    window: int = 0        # 0: full causal attention
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def heads_per_kv(self) -> int:
        """Query head h reads kv head h // heads_per_kv."""
        return self.n_heads // self.n_kv_heads

    @classmethod
    def from_config(cls, c: dict) -> "Arch":
        H, KV = c["num_attention_heads"], c["num_key_value_heads"]
        experts = c.get("num_local_experts", 0)
        return cls(
            name=c["name"], family="moe" if experts else "dense",
            n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
            n_heads=H, n_kv_heads=KV,
            d_head=c.get("head_dim") or c["hidden_size"] // H,
            d_ff=c["intermediate_size"], vocab=c["vocab_size"],
            n_experts=experts, top_k=c.get("num_experts_per_tok", 0),
            window=c.get("sliding_window") or 0,
            rope_theta=c["rope_theta"], norm_eps=c["rms_norm_eps"],
            tie_embeddings=c["tie_word_embeddings"],
            dtype=c["torch_dtype"])


sizes = Arch.from_config


def layer_shapes(a: Arch, i: int) -> dict:
    """name -> (shape, fan_in or None for a gain of ones, dtype) of layer
    ``i``'s weights, in the order they are drawn: the same for every
    layer."""
    d, H, KV, dh, f = a.d_model, a.n_heads, a.n_kv_heads, a.d_head, a.d_ff
    out = {"ln1": ((d,), None, a.dtype), "ln2": ((d,), None, a.dtype),
           "attn.wq": ((d, H, dh), d, a.dtype),
           "attn.wk": ((d, KV, dh), d, a.dtype),
           "attn.wv": ((d, KV, dh), d, a.dtype),
           "attn.wo": ((H, dh, d), H * dh, a.dtype)}
    if a.family == "moe":
        E = a.n_experts
        out.update({"moe.router": ((d, E), d, "float32"),
                    "moe.w1": ((E, d, f), d, a.dtype),
                    "moe.w3": ((E, d, f), d, a.dtype),
                    "moe.w2": ((E, f, d), f, a.dtype)})
    else:
        out.update({"ffn.w1": ((d, f), d, a.dtype),
                    "ffn.w3": ((d, f), d, a.dtype),
                    "ffn.w2": ((f, d), f, a.dtype)})
    return out


EMBED_STD = 0.02


def global_shapes(a: Arch) -> dict:
    """name -> (shape, std or None for ones, dtype) of the weights outside
    the layers, in the order they are drawn."""
    out = {"embed": ((a.vocab, a.d_model), EMBED_STD, a.dtype),
           "final_norm": ((a.d_model,), None, a.dtype)}
    if not a.tie_embeddings:
        out["lm_head"] = ((a.d_model, a.vocab), EMBED_STD, a.dtype)
    return out


def port_name(name: str) -> str:
    """The port's parameter of a benchmark weight: the same name, as the
    port runs the source's heads unpadded."""
    return name


def check_config(config: dict) -> None:
    """The port runs the source's heads unpadded: the heads' widths add up
    to the model's."""
    a = sizes(config)
    if a.n_heads * a.d_head != a.d_model:
        raise ValueError(f"{a.name}: {a.n_heads} heads of {a.d_head} are "
                         f"not the model's width {a.d_model}")


MOE = dict(hidden_size=64, intermediate_size=64, num_attention_heads=4,
           num_key_value_heads=2, num_hidden_layers=2, num_local_experts=4,
           vocab_size=128, torch_dtype="float32")
DENSE = dict(hidden_size=96, intermediate_size=64, num_attention_heads=3,
             num_key_value_heads=1, num_hidden_layers=2, vocab_size=128,
             torch_dtype="float32")


def tiny(config: dict) -> dict:
    """The keys that cut ``config`` to a CPU test's size, in float32."""
    return MOE if config.get("num_local_experts") else DENSE
