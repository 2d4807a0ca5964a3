"""The decoder family's operations and bytes of a batch, counted from
the configuration.

Model FLOPs count each product as 2 operations a multiply-add, with the
published query heads (a padded head does no work), the query-key pairs
that the causal mask (and window) keeps, the ``top_k`` experts each token
is routed to, and no recomputation. Prefill counts the head at the last
position only (all the first token needs); training counts the forward
pass at every position and its backward as twice the forward.

K5 is the expert products: three a layer, each over every routed
assignment (``top_k`` a token; capacity slots are not counted). Its bytes
are the experts' weights read once and the routed rows in and out. K3 is
attention's ``softmax(q k^T) v``: ``4 * d_head * heads * kept pairs``
operations; its bytes are q, k and v read once and the output written
once.
"""
from __future__ import annotations

from gpubench.arch.decoder import Arch
from gpubench.counts.work import BYTES, kept_pairs


def layer_flops(a: Arch, B: int, S: int) -> int:
    """One layer's forward FLOPs over a batch [B, S]."""
    T = B * S
    d, H, KV, dh, f = a.d_model, a.n_heads, a.n_kv_heads, a.d_head, a.d_ff
    proj = 2 * T * d * (H * dh + 2 * KV * dh) + 2 * T * H * dh * d
    attn = 4 * dh * H * B * kept_pairs(S, a.window)
    if a.family == "moe":
        ffn = 2 * T * d * a.n_experts + 3 * 2 * T * a.top_k * d * f
    else:
        ffn = 3 * 2 * T * d * f
    return proj + attn + ffn


def prefill_flops(a: Arch, B: int, S: int) -> int:
    """A prefill's model FLOPs: every layer, and the head at the last
    position of each prompt."""
    return a.n_layers * layer_flops(a, B, S) + 2 * B * a.d_model * a.vocab


def train_flops(a: Arch, B: int, S: int) -> int:
    """A training step's model FLOPs: 3 x (every layer and the head at every
    position)."""
    T = B * S
    fwd = a.n_layers * layer_flops(a, B, S) + 2 * T * a.d_model * a.vocab
    return 3 * fwd


def k5_launches(a: Arch, B: int, S: int) -> list[tuple[int, int]]:
    """(operations, bytes) of each expert product a prefill of [B, S]
    launches: three a layer (w1, w3, w2)."""
    n = BYTES[a.dtype]
    routed = B * S * a.top_k
    d, f, E = a.d_model, a.d_ff, a.n_experts
    ops = 2 * routed * d * f
    byts = E * d * f * n + routed * (d + f) * n
    return [(ops, byts)] * (3 * a.n_layers)


def k3_launches(a: Arch, B: int, S: int) -> list[tuple[int, int]]:
    """(operations, bytes) of each attention a prefill of [B, S] launches:
    one a layer."""
    n = BYTES[a.dtype]
    H, KV, dh = a.n_heads, a.n_kv_heads, a.d_head
    ops = 4 * dh * H * B * kept_pairs(S, a.window)
    byts = B * S * dh * (2 * H + 2 * KV) * n
    return [(ops, byts)] * a.n_layers
