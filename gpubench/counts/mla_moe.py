"""The mla_moe family's operations and bytes of a batch, counted from the
configuration.

Model FLOPs count each product as 2 operations a multiply-add. Latent
attention's five products: x wq_a, cq wq_b, x wkv_a, c wkv_b and o wo,
at every position; its contraction, ``softmax(q k^T) v``, is ``2 (d_qk +
d_v)`` operations a head and kept query-key pair (q k^T over the 192
q/k columns, p v over the 128 v columns). A dense layer's SwiGLU; an
expert layer's router over every expert, the shared expert at every
position and the held experts over the held share's expected
assignments, ``T top_k n_held / n_experts`` (the router spreads them as
it will; the counts describe the work the share is dealt on average).
Prefill counts the head at the last position only; training counts the
forward pass at every position and its backward as twice the forward.

K5 is the held experts' three products a layer, each over those
expected assignments: its bytes are the held experts' weights read once
and the rows in and out. K3 is one contraction a layer: its bytes are q
and k (d_qk wide) and v and the output (d_v wide), each once.
"""
from __future__ import annotations

from gpubench.arch.mla_moe import Arch
from gpubench.counts.work import BYTES, kept_pairs


def mla_flops(a: Arch, B: int, S: int) -> int:
    """Latent attention's forward FLOPs over a batch [B, S]: the five
    products and the contraction."""
    T, d, H = B * S, a.d_model, a.n_heads
    proj = (d * a.q_lora + a.q_lora * H * a.d_qk
            + d * (a.kv_lora + a.d_rope) + a.kv_lora * H * (a.d_nope + a.d_v)
            + H * a.d_v * d)
    return 2 * T * proj + 2 * (a.d_qk + a.d_v) * H * B * kept_pairs(S)


def held_rows(a: Arch, B: int, S: int) -> float:
    """The held share's expected assignments: T top_k n_held / n_experts."""
    return B * S * a.top_k * a.n_held / a.n_experts


def layer_flops(a: Arch, i: int, B: int, S: int) -> int:
    """Layer ``i``'s forward FLOPs over a batch [B, S]."""
    T, d = B * S, a.d_model
    if i < a.first_dense:
        ffn = 3 * 2 * T * d * a.d_ff
    else:
        ffn = (2 * T * d * a.n_experts
               + 3 * 2 * T * d * a.d_expert * a.n_shared
               + round(3 * 2 * held_rows(a, B, S) * d * a.d_expert))
    return mla_flops(a, B, S) + ffn


def prefill_flops(a: Arch, B: int, S: int) -> int:
    """A prefill's model FLOPs: every layer, and the head at the last
    position of each prompt."""
    return (sum(layer_flops(a, i, B, S) for i in range(a.n_layers))
            + 2 * B * a.d_model * a.vocab)


def train_flops(a: Arch, B: int, S: int) -> int:
    """A training step's model FLOPs: 3 x (every layer and the head at
    every position)."""
    fwd = (sum(layer_flops(a, i, B, S) for i in range(a.n_layers))
           + 2 * B * S * a.d_model * a.vocab)
    return 3 * fwd


def k5_launches(a: Arch, B: int, S: int) -> list[tuple[int, int]]:
    """(operations, bytes) of each expert product a prefill of [B, S]
    launches: three an expert layer (w1, w3, w2) over the held share's
    expected assignments."""
    n = BYTES[a.dtype]
    rows = held_rows(a, B, S)
    d, f = a.d_model, a.d_expert
    ops = round(2 * rows * d * f)
    byts = round(a.n_held * d * f * n + rows * (d + f) * n)
    return [(ops, byts)] * (3 * (a.n_layers - a.first_dense))


def k3_launches(a: Arch, B: int, S: int) -> list[tuple[int, int]]:
    """(operations, bytes) of each attention a prefill of [B, S]
    launches: one a layer, at q/k ``d_qk`` and v ``d_v``."""
    n = BYTES[a.dtype]
    H = a.n_heads
    ops = 2 * (a.d_qk + a.d_v) * H * B * kept_pairs(S)
    byts = B * S * H * (2 * a.d_qk + 2 * a.d_v) * n
    return [(ops, byts)] * a.n_layers
