"""The mla_moe family's sizes and weights: a DeepSeek-V3-style decoder
(Kimi-K2-Instruct): latent attention (MLA) with YaRN rope, leading dense
SwiGLU layers, then expert layers with sigmoid scores, a selection-only
bias (``noaux_tc``, one group), top-k gates normalised and scaled, shared
experts, and a held share of the routed experts (one expert-parallel
rank's). Plain Python: imports nothing of the program."""
from __future__ import annotations

import dataclasses

# the router's selection bias is drawn N(0, 1 / BIAS_FAN_IN) = N(0, 0.05^2)
# (a trained bias is not published; at this size it reorders selections
# near ties)
BIAS_FAN_IN = 400


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    q_lora: int
    kv_lora: int
    d_nope: int            # a q/k head's rope-free width
    d_rope: int            # its rope width: one key a token for all heads
    d_v: int
    vocab: int
    first_dense: int       # leading dense layers
    d_ff: int              # their SwiGLU width
    d_expert: int          # an expert's (and the shared expert's) width
    n_experts: int         # routed over
    n_held: int            # held (computed) here: experts held_first..
    held_first: int
    top_k: int
    n_shared: int
    routed_scale: float
    rope_theta: float
    yarn: tuple            # (factor, original_max, beta_fast, beta_slow,
                           #  mscale, mscale_all_dim)
    norm_eps: float
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def d_qk(self) -> int:
        return self.d_nope + self.d_rope

    @classmethod
    def from_config(cls, c: dict) -> "Arch":
        y = c["rope_scaling"]
        return cls(
            name=c["name"], n_layers=c["num_hidden_layers"],
            d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
            q_lora=c["q_lora_rank"], kv_lora=c["kv_lora_rank"],
            d_nope=c["qk_nope_head_dim"], d_rope=c["qk_rope_head_dim"],
            d_v=c["v_head_dim"], vocab=c["vocab_size"],
            first_dense=c["first_k_dense_replace"],
            d_ff=c["intermediate_size"], d_expert=c["moe_intermediate_size"],
            n_experts=c["router_experts"], n_held=c["n_routed_experts"],
            held_first=c["held_experts_first"],
            top_k=c["num_experts_per_tok"], n_shared=c["n_shared_experts"],
            routed_scale=c["routed_scaling_factor"],
            rope_theta=float(c["rope_theta"]),
            yarn=(float(y["factor"]), int(y["original_max_position_embeddings"]),
                  float(y["beta_fast"]), float(y["beta_slow"]),
                  float(y["mscale"]), float(y["mscale_all_dim"])),
            norm_eps=c["rms_norm_eps"],
            tie_embeddings=c["tie_word_embeddings"], dtype=c["torch_dtype"])


sizes = Arch.from_config


def layer_shapes(a: Arch, i: int) -> dict:
    """name -> (shape, fan_in or None for a gain of ones, dtype) of layer
    ``i``'s weights, in the order they are drawn: latent attention, then
    the dense FFN (``i < first_dense``) or the router, its selection bias,
    the held experts and the shared expert."""
    d, H, r, c, dt = a.d_model, a.n_heads, a.q_lora, a.kv_lora, a.dtype
    out = {"ln1": ((d,), None, dt), "ln2": ((d,), None, dt),
           "attn.wq_a": ((d, r), d, dt), "attn.q_norm": ((r,), None, dt),
           "attn.wq_b": ((r, H, a.d_qk), r, dt),
           "attn.wkv_a": ((d, c + a.d_rope), d, dt),
           "attn.kv_norm": ((c,), None, dt),
           "attn.wkv_b": ((c, H, a.d_nope + a.d_v), c, dt),
           "attn.wo": ((H, a.d_v, d), H * a.d_v, dt)}
    if i < a.first_dense:
        f = a.d_ff
        out.update({"ffn.w1": ((d, f), d, dt), "ffn.w3": ((d, f), d, dt),
                    "ffn.w2": ((f, d), f, dt)})
        return out
    E, f, fs = a.n_held, a.d_expert, a.d_expert * a.n_shared
    out.update({"moe.router": ((d, a.n_experts), d, "float32"),
                "moe.router_bias": ((a.n_experts,), BIAS_FAN_IN, "float32"),
                "moe.w1": ((E, d, f), d, dt), "moe.w3": ((E, d, f), d, dt),
                "moe.w2": ((E, f, d), f, dt)})
    if a.n_shared:
        out.update({"moe.shared_w1": ((d, fs), d, dt),
                    "moe.shared_w3": ((d, fs), d, dt),
                    "moe.shared_w2": ((fs, d), fs, dt)})
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
    """The port's parameter of a benchmark weight: the same name."""
    return name


def check_config(config: dict) -> None:
    """What the family describes: latent attention with a compressed q,
    YaRN, sigmoid scores chosen by score plus bias in one group and
    normalised, a held share within the experts routed over."""
    want = {"scoring_func": "sigmoid", "topk_method": "noaux_tc",
            "n_group": 1, "topk_group": 1, "norm_topk_prob": True}
    for key, value in want.items():
        if config.get(key) != value:
            raise ValueError(f"{config['name']}: {key} {config.get(key)!r}; "
                             f"the family routes as {key} {value!r}")
    if config["rope_scaling"].get("type") != "yarn":
        raise ValueError(f"{config['name']}: rope_scaling is not YaRN")
    a = sizes(config)
    if a.q_lora <= 0 or a.kv_lora <= 0:
        raise ValueError(f"{a.name}: q_lora_rank and kv_lora_rank must be "
                         "> 0 (latent attention)")
    if not 0 <= a.held_first <= a.held_first + a.n_held <= a.n_experts:
        raise ValueError(f"{a.name}: experts {a.held_first}.."
                         f"{a.held_first + a.n_held} are not a share of the "
                         f"{a.n_experts} routed over")


TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, intermediate_size=96,
            moe_intermediate_size=32, router_experts=16, n_routed_experts=4,
            held_experts_first=4, num_experts_per_tok=4, num_hidden_layers=3,
            vocab_size=128, torch_dtype="float32")


def tiny(config: dict) -> dict:
    """The keys that cut ``config`` to a CPU test's size, in float32: a
    dense layer and two expert layers holding 4 of 16 experts, top 4;
    the rope scaling as published (at rope width 8 both sides of its
    correction range are reached)."""
    return TINY
