"""Mixture-of-Experts layer: top-k router + capacity-bounded expert products.

A copy of ``repro/models/moe.py`` in PyTorch. Tokens are sorted by expert id and packed into a
fixed-capacity buffer, the experts run as one batched SwiGLU, and the
outputs are gathered back weighted by the router's gates. Tokens beyond
an expert's capacity are dropped (Switch/GShard semantics).

Beyond the reference (DeepSeek-V3's router, which Kimi-K2 uses): with
``cfg.router_score == "sigmoid"`` the scores are ``sigmoid(x W)``, the
top_k are chosen by score plus a selection-only bias (the layer's
``router_bias``; ``noaux_tc`` with one group) and their scores,
normalised to sum to 1 and times ``routed_scale``, are the gates. A
layer may hold a share of the experts (``cfg.experts_held`` from
``experts_first``: one expert-parallel rank's): it routes over all
``n_experts`` and computes the assignments to the experts it holds; the
absent experts' terms are left out, and the shared experts, which every
rank holds, are added once. Buffers, the capacity and the routed tiles
count the held experts; ``moe.kept`` counts the held assignments kept,
``moe.assigned`` every assignment.

``use_kernels=True`` sends the three expert products of a layer through
K5 (:mod:`repro_torch.kernels.moe_gemm`); ``False`` is the reference's
einsum route. Both compute the same function. Where JAX has no torch
twin, the port keeps the reference's result:

* ``jax.lax.top_k`` breaks ties toward the lower expert index:
  :func:`_top_k` is a stable descending sort; ``jnp.argsort`` is stable:
  ``torch.argsort(stable=True)``.
* ``.at[dest].set(mode="drop")`` with ``dest = E*C`` for a dropped
  assignment: the pack buffer has one spare row at ``E*C``, sliced off;
  ``.at[dest].get(mode="fill")``: a gather masked by ``keep``.
* ``.at[token].add`` sums a token's K contributions: the port gathers
  them as [T, K, d] and adds them in order k = 0, 1, … (no atomics, the
  same bits on every run; for K = 2 the reference's bits).

The grouped dispatch packs expert-major, [E, G, C, d] (slot
``e*G*C + g*C + rank``) where the reference packs [G, E, C, d], so that the
expert products read [E, G*C, d] without a copy; each slot holds the same
row either way. Where K5 runs as a kernel on one device and fewer row
tiles suffice at worst (:func:`_routed`), it packs only the kept rows
instead, expert by expert in 128-row aligned segments
(:func:`_pack_routed`), and K5 walks just those (:func:`.kernels.moe_gemm.moe_gemm_routed`): the same tokens
kept, each row's product the same, the buffer's empty capacity slots not
multiplied (the dropless prefill's three in four). The segments' starts
stay on the device: the dispatch never waits for it.

On a mesh (:func:`.common.use_mesh`) the reference's constraints apply at
its sites, in the port's layout: the groups over the data axes, the
buffer's experts over ``model`` (its [E, G*C] rows over the data axes),
the experts' hidden activations over ``model`` by experts where ``E %
16 == 0``, else by their hidden dim. Each group lives on one data shard,
so the scatter into the buffer and the gather back run rank-local
(``local_map``, on the groups' placements); a flat (decode) dispatch packs
all tokens, replicated. K5 takes the buffer and the weights on the
placements of the products (:func:`_experts`).

While a profiler records, the layer is the span ``repro_torch.moe`` and its
expert products ``repro_torch.moe.experts`` (:mod:`repro_torch.spans`);
the dispatch counts K5's rows, the assignments kept and those made
(:func:`_count`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels._shards import is_dtensor, on_shards
from repro_torch.kernels.moe_gemm import (ROUTE_ROWS, moe_gemm,
                                          moe_gemm_routed)

from .common import (BATCH_AXES, ModelConfig, _ambient_mesh, as_dtensor,
                     dense_init, maybe_shard, summed)

# The device on which K5 launches a kernel (on the CPU it runs its plain
# version): the grouped dispatch packs routed rows only there (_routed)
_KERNEL_DEVICE = "cuda"


def moe_param_shapes(cfg: ModelConfig) -> dict:
    """name -> (shape, dtype) of a layer's MoE weights, in the reference's
    shapes (the held experts' only); the router, and a sigmoid router's
    selection bias, are float32 whatever ``param_dtype`` is."""
    d, E, f, dt = cfg.d_model, cfg.n_held, cfg.moe_d_ff, cfg.param_dtype
    shapes = {"router": ((d, cfg.n_experts), torch.float32)}
    if cfg.router_score == "sigmoid":
        shapes["router_bias"] = ((cfg.n_experts,), torch.float32)
    shapes.update(w1=((E, d, f), dt), w3=((E, d, f), dt), w2=((E, f, d), dt))
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shapes.update(shared_w1=((d, fs), dt), shared_w3=((d, fs), dt),
                      shared_w2=((fs, d), dt))
    return shapes


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, out) -> None:
    """Normal fan-in init of every weight (the fan-in is the second-last
    dim: d for the router, w1, w3; f for w2), written into ``out`` (name ->
    the parameter): each weight is drawn in float32 and copied straight
    into its parameter, so a layer's experts (kimi-k2's are three of 10.5
    GiB) are never held twice. The selection bias starts at zeros."""
    for name, (shape, _) in moe_param_shapes(cfg).items():
        if name == "router_bias":
            out[name].zero_()
            continue
        out[name].copy_(dense_init(gen, shape[-2], shape, torch.float32))


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    # the reference rounds up to a multiple of 64 (shardable, MXU-aligned)
    mult = 64 if n_tokens >= 4096 else 8
    return max(8, -(-c // mult) * mult)


def _pick_groups(T: int) -> int:
    """Dispatch groups, as the reference picks them (the data shards the
    token dim can carry on its meshes)."""
    for g in (32, 16, 8, 4, 2):
        if T % g == 0 and T // g >= 2:
            return g
    return 1


def moe_ffn(params, x, cfg: ModelConfig, use_kernels: bool = False):
    """x: [B, S, d] -> ([B, S, d], aux) where aux has router stats.

    Dispatch is adaptive, as in the reference: grouped on big token
    counts, flat where assignments per expert are few (decode shapes)."""
    T = x.shape[0] * x.shape[1]
    grouped_ok = (T * cfg.top_k) / max(cfg.n_experts, 1) >= 64
    with spans.span("repro_torch.moe"):
        if (cfg.moe_dispatch == "grouped" and grouped_ok
                and _pick_groups(T) > 1):
            return moe_ffn_grouped(params, x, cfg, use_kernels)
        return moe_ffn_flat(params, x, cfg, use_kernels)


def _top_k(probs, K: int):
    """Values and indices of the K largest along the last dim, ties to the
    lower index (``jax.lax.top_k``'s rule; ``torch.topk`` has none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def _route(xt, router, K: int, bias=None, sigmoid: bool = False,
           scale: float = 1.0):
    """Router in float32: (probs [..., E], gate [..., K], idx [..., K]).
    Softmax: the K largest probabilities, renormalised. ``sigmoid``: the
    scores s = sigmoid(x W) (returned as ``probs``), idx the K largest of
    s + ``bias`` (ties to the lower index), gate = s[idx] renormalised
    times ``scale``: the bias selects and never weighs."""
    if not sigmoid:
        probs = torch.softmax(xt.float() @ router, dim=-1)
        gate, idx = _top_k(probs, K)
    else:
        probs = torch.sigmoid(xt.float() @ router)
        _, idx = _top_k(probs if bias is None else probs + bias, K)
        gate = torch.gather(probs, -1, idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate * scale if scale != 1.0 else gate, idx


def _route_cfg(xt, params, cfg: ModelConfig):
    """:func:`_route` as ``cfg`` routes."""
    return _route(xt, params["router"], cfg.top_k, params.get("router_bias"),
                  cfg.router_score == "sigmoid", cfg.routed_scale)


def _held(idx, cfg: ModelConfig):
    """Expert ids ``idx`` as the held share's: e - experts_first for a held
    expert, ``n_held`` (after every held one) for an absent one; ``idx``
    itself where the layer holds every expert."""
    if cfg.n_held == cfg.n_experts:
        return idx
    e = idx - cfg.experts_first
    return torch.where((e >= 0) & (e < cfg.n_held), e, cfg.n_held)


def _slots(flat_e, C: int, held=None):
    """Per-row slot assignment of expert ids ``flat_e`` [..., N]: sort
    order, (sorted) expert, rank within its expert, and keep = rank < C
    (and, given the number of experts ``held``, the expert held)."""
    sort = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, sort)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(flat_e.shape[-1], device=flat_e.device) - first
    keep = rank < C
    if held is not None:
        keep = keep & (sorted_e < held)
    return sort, sorted_e, rank, keep


def _experts(buf, params, use_kernels: bool, pin_out: bool = True):
    """SwiGLU of every expert over its rows: buf [E, N, d] -> [E, N, d].
    On a mesh: the buffer's experts over ``model`` and its rows over the
    data axes; the hidden activations over ``model`` by experts where ``E
    % 16 == 0``, else by their hidden dim; the output as the buffer
    (``pin_out``, the grouped dispatch). K5 takes the weights gathered over
    the data axes, sharded as its products: by experts, or w1/w3 by their
    columns and w2 by its rows (a partial sum)."""
    E = buf.shape[0]
    ep = E % 16 == 0
    buf = maybe_shard(buf, "model", BATCH_AXES, None)
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
    if _ambient_mesh() is not None:
        # the weights gathered over the data axes, as the products take
        # them, in the backward pass too (their gradients reduce-scattered
        # there): left on their data shards, the backward's products
        # split the buffer's model dim over data instead
        w1, w3 = (maybe_shard(w, "model", None, None) if ep
                  else maybe_shard(w, None, None, "model")
                  for w in (w1, w3))
        w2 = maybe_shard(w2, "model" if ep else None,
                         None if ep else "model", None)
    if use_kernels:
        if _ambient_mesh() is not None:
            buf = maybe_shard(buf, "model" if ep else None, BATCH_AXES, None)
        h = F.silu(moe_gemm(buf, w1)) * moe_gemm(buf, w3)
    else:
        h = F.silu(torch.einsum("ecd,edf->ecf", buf, w1))
        h = h * torch.einsum("ecd,edf->ecf", buf, w3)
    h = maybe_shard(h, "model", BATCH_AXES, None) if ep else \
        maybe_shard(h, None, BATCH_AXES, "model")
    out = moe_gemm(h, w2) if use_kernels else \
        torch.einsum("ecf,efd->ecd", h, w2)
    return maybe_shard(out, "model", BATCH_AXES, None) if pin_out else out


def _experts_routed(buf, tiles, params):
    """SwiGLU of every expert over its segment of the routed buffer
    (:func:`_pack_routed`): buf [R, d] -> [R, d], on K5's routed product."""
    h = (F.silu(moe_gemm_routed(buf, params["w1"], tiles))
         * moe_gemm_routed(buf, params["w3"], tiles))
    return moe_gemm_routed(h, params["w2"], tiles)


def _count(rows, keep, assigned: int) -> None:
    """On the record of :mod:`repro_torch.spans`, while a profiler
    records: ``moe.rows``, the buffer's rows that the expert products
    multiply (capacity slots; under the routed mode each expert's kept
    rows rounded up to 128, a device tensor); ``moe.kept``, the
    assignments that hold one; ``moe.assigned``, the assignments made
    (tokens x top_k)."""
    if spans.enabled():
        spans.count("moe.rows", rows)
        spans.count("moe.kept", keep.sum())
        spans.count("moe.assigned", assigned)


def _unsort(sort, v):
    """``v`` given in sorted order -> in assignment order."""
    return torch.empty_like(v).scatter_(-1, sort, v)


def _shared(params, xt):
    hs = F.silu(xt @ params["shared_w1"]) * (xt @ params["shared_w3"])
    return summed(hs @ params["shared_w2"])


def _aux(probs, idx, keep, cfg: ModelConfig, T: int):
    E, K = cfg.n_experts, cfg.top_k
    me = probs.reshape(-1, E).mean(0)
    # tokens per expert (bincount, which has no meta-device kernel); on a
    # mesh each rank counts its own assignments, summed over the ranks
    # that hold different ones
    ce = _on_groups(_expert_counts(E), idx, partial=True).float() / (T * K)
    return {"lb_loss": E * torch.sum(me * ce),
            "dropped": 1.0 - keep.float().mean()}


def _expert_counts(E: int):
    def counts(idx):
        flat = idx.reshape(-1)
        out = torch.zeros(E, dtype=torch.int64, device=flat.device)
        return out.index_add_(0, flat, torch.ones_like(flat))
    return counts


def _on_groups(fn, *args, out=None, partial=False):
    """``fn(*args)`` of the dispatch, rank-local on a mesh. The first
    argument sets the placements: each output is sharded as it, on the dims
    ``out`` names (one entry per output: the dim its groups lie on), or is
    a sum over its shards (``partial``: one output, replicated
    elsewhere). Without a mesh, ``fn(*args)``."""
    if not is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    pl = args[0].placements

    def place(dim):
        return tuple(Shard(dim) if isinstance(p, Shard) else Replicate()
                     for p in pl)

    if partial:
        outs = tuple(Partial() if isinstance(p, Shard) else Replicate()
                     for p in pl)
    else:
        outs = tuple(place(d) for d in out)
    return on_shards(fn, outs, *args)


def _like(t, ref):
    """``t`` on ``ref``'s placements (on a mesh)."""
    if not is_dtensor(ref):
        return t
    return as_dtensor(t, ref.device_mesh).redistribute(ref.device_mesh,
                                                       ref.placements)


def moe_ffn_grouped(params, x, cfg: ModelConfig, use_kernels: bool = False):
    """GShard-style grouped dispatch: each group of Tg tokens has its own
    capacity C per expert. The buffer is packed expert-major, [E, G, C, d],
    and the experts read it as [E, G*C, d]. On a mesh the groups lie on the
    data axes and each rank packs and combines its own."""
    B, S, d = x.shape
    E, K = cfg.n_held, cfg.top_k
    T = B * S
    G = _pick_groups(T)
    Tg = T // G
    xt = maybe_shard(x.reshape(G, Tg, d), BATCH_AXES, None, None)
    probs, gate, idx = _route_cfg(xt, params, cfg)           # [G, Tg, ·]
    C = expert_capacity(Tg, cfg)
    idx, gate = _like(idx, xt), _like(gate, xt)

    sort, sorted_e, rank, keep = _on_groups(
        lambda i: _slots(_held(i, cfg).reshape(i.shape[0], Tg * K), C, E),
        idx, out=(0, 0, 0, 0))
    if _routed(xt, T * K, E, G * C, use_kernels):
        buf, dest, tiles, rows = _pack_routed(E, C, K)(xt, sort, sorted_e,
                                                        rank, keep)
        _count(rows, keep, T * K)
        with spans.span("repro_torch.moe.experts"):
            out = _experts_routed(buf, tiles, params)
    else:
        _count(E * G * C, keep, T * K)
        buf, dest = _on_groups(_pack_grouped(E, C, K), xt, sort, sorted_e,
                               rank, keep, out=(1, 0))
        with spans.span("repro_torch.moe.experts"):
            out = _experts(buf, params, use_kernels)
    y = _on_groups(_combine_grouped(K), _like(out, buf), sort, dest, keep,
                   gate, out=(0,))
    y = maybe_shard(y, BATCH_AXES, None, None).reshape(T, d).to(x.dtype)

    if cfg.n_shared_experts:
        y = y + _shared(params, x.reshape(T, d))
    return y.reshape(B, S, d), _aux(probs, idx, keep, cfg, T)


def _pack_grouped(E: int, C: int, K: int):
    def pack(xt, sort, sorted_e, rank, keep):
        """xt [G, Tg, d] -> the buffer [E, G*C, d] and each sorted
        assignment's slot (``E*G*C``, the drop row, where not kept)."""
        G, Tg, d = xt.shape
        grp = torch.arange(G, device=xt.device)[:, None]
        dest = torch.where(keep, sorted_e * (G * C) + grp * C + rank,
                           E * G * C)
        token = grp * Tg + torch.div(sort, K, rounding_mode="floor")
        buf = xt.new_zeros((E * G * C + 1, d))               # + the drop row
        buf.index_copy_(0, dest.reshape(-1),
                        xt.reshape(G * Tg, d)[token.reshape(-1)])
        return buf[:-1].view(E, G * C, d), dest
    return pack


def _routed(xt, assigned: int, E: int, slots: int, use_kernels: bool):
    """Whether the grouped dispatch packs routed rows (:func:`_pack_routed`)
    rather than capacity slots: K5 on, as a kernel (``xt`` a plain tensor
    on ``_KERNEL_DEVICE``: on the CPU K5 is its plain version, whose routed
    form reads the segments on the host), and fewer row tiles at worst,
    ceil(T*K / 128) + E, than the capacity buffer's, E * ceil(G*C / 128)
    (``slots`` = G*C)."""
    def tiles(n):
        return -(-n // ROUTE_ROWS)
    return (use_kernels and not is_dtensor(xt)
            and xt.device.type == _KERNEL_DEVICE
            and tiles(assigned) + E < E * tiles(slots))


def _pack_routed(E: int, C: int, K: int):
    def pack(xt, sort, sorted_e, rank, keep):
        """xt [G, Tg, d] -> the routed buffer [R, d], R = T*K + E*128 (a
        bound fixed by the shapes): expert e's kept rows from row
        ``128 * tiles[e]``, group by group, each group's in rank order,
        its segment padded to a multiple of 128 (the padding rows left
        unwritten); each sorted assignment's row (R, the drop row, where not
        kept); the segments' starts in 128-row tiles, ``tiles`` [E + 1]
        int32; and the rows they hold, 128 * tiles[E], a 0-d tensor. The
        kept set is the capacity path's (``keep``); nothing is read on the
        host."""
        G, Tg, d = xt.shape
        R = G * Tg * K + E * ROUTE_ROWS
        experts = torch.arange(E + 1, device=xt.device)
        bounds = torch.searchsorted(sorted_e,
                                    experts.expand(G, E + 1).contiguous())
        cnt = (bounds[:, 1:] - bounds[:, :-1]).clamp_(max=C)  # kept [G, E]
        seg = torch.div(cnt.sum(0) + ROUTE_ROWS - 1, ROUTE_ROWS,
                        rounding_mode="floor") * ROUTE_ROWS
        end = torch.cumsum(seg, 0)
        first = end - seg + torch.cumsum(cnt, 0) - cnt         # [G, E]
        # an absent expert's assignments (id E under a held share, never
        # kept) look up expert E - 1's start
        dest = torch.where(keep, torch.gather(
            first, 1, sorted_e.clamp(max=E - 1)) + rank, R)
        grp = torch.arange(G, device=xt.device)[:, None]
        token = grp * Tg + torch.div(sort, K, rounding_mode="floor")
        buf = xt.new_empty((R + 1, d))                         # + the drop row
        buf.index_copy_(0, dest.reshape(-1),
                        xt.reshape(G * Tg, d)[token.reshape(-1)])
        tiles = torch.cat([end.new_zeros(1), end // ROUTE_ROWS])
        return buf[:-1], dest, tiles.to(torch.int32), end[-1]
    return pack


def _combine_grouped(K: int):
    def combine(out, sort, dest, keep, gate):
        """The experts' rows back to their tokens, in assignment order [T,
        K]: gate * keep, cast to the activation dtype before the product,
        as the reference does. ``out`` is the capacity buffer's [E, G*C,
        d] or the routed one's [R, d]. -> [G, Tg, d]."""
        d = out.shape[-1]
        G, Tg = gate.shape[:2]
        T = G * Tg
        out = out.reshape(-1, d)
        dest_u = _unsort(sort, dest).reshape(T * K)
        keep_u = _unsort(sort, keep).reshape(T * K)
        gathered = torch.where(keep_u[:, None],
                               out[dest_u.clamp(max=out.shape[0] - 1)], 0)
        w = (gate.reshape(T * K) * keep_u.float())[:, None]
        contrib = (gathered * w.to(out.dtype)).view(T, K, d)
        return _sum_k(contrib).view(G, Tg, d)
    return combine


def moe_ffn_flat(params, x, cfg: ModelConfig, use_kernels: bool = False):
    """Single global capacity buffer [E, C, d]. On a mesh every rank packs
    all tokens (replicated) and the buffer's rows go over the data axes."""
    B, S, d = x.shape
    E, K = cfg.n_held, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    mesh = _ambient_mesh()
    if mesh is not None:
        xt = maybe_shard(xt, None, None)
    probs, gate, idx = _route_cfg(xt, params, cfg)           # [T, ·]
    C = expert_capacity(T, cfg)
    if mesh is not None:
        idx, gate = _like(idx, xt), _like(gate, xt)

    sort, sorted_e, rank, keep = _on_groups(
        lambda i: _slots(_held(i, cfg).reshape(T * K), C, E), idx,
        out=(0, 0, 0, 0))
    _count(E * C, keep, T * K)
    buf, dest = _on_groups(_pack_flat(E, C, K), xt, sort, sorted_e, rank,
                           keep, out=(0, 0))
    with spans.span("repro_torch.moe.experts"):
        out = _experts(buf, params, use_kernels, pin_out=False)
    y = _on_groups(_combine_flat(K), _like(out, buf), sort, dest, keep, gate,
                   out=(0,))

    if cfg.n_shared_experts:
        y = y + _shared(params, xt)
    return y.reshape(B, S, d), _aux(probs, idx, keep, cfg, T)


def _pack_flat(E: int, C: int, K: int):
    def pack(xt, sort, sorted_e, rank, keep):
        dest = torch.where(keep, sorted_e * C + rank, E * C)
        token = torch.div(sort, K, rounding_mode="floor")
        buf = xt.new_zeros((E * C + 1, xt.shape[1]))         # + the drop row
        buf.index_copy_(0, dest, xt[token])
        return buf[:-1].view(E, C, xt.shape[1]), dest
    return pack


def _combine_flat(K: int):
    def combine(out, sort, dest, keep, gate):
        """In assignment order [T, K]: the product in float32 (gate *
        keep), cast to the activation dtype, as the reference does."""
        E, C, d = out.shape
        T = gate.shape[0]
        out = out.reshape(E * C, d)
        dest_u, keep_u = _unsort(sort, dest), _unsort(sort, keep)
        gathered = torch.where(keep_u[:, None],
                               out[dest_u.clamp(max=E * C - 1)], 0)
        w = (gate.reshape(T * K) * keep_u.to(gate.dtype))[:, None]
        return _sum_k((gathered * w).to(out.dtype).view(T, K, d))
    return combine


def _sum_k(contrib):
    """[T, K, d] -> [T, d], adding k = 0, 1, … in order."""
    y = contrib[:, 0]
    for k in range(1, contrib.shape[1]):
        y = y + contrib[:, k]
    return y
