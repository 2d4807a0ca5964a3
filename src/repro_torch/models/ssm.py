"""RWKV6 ("Finch", arXiv:2404.05892) time mix and channel mix, and the
Mamba-style selective SSM branch of the hybrid family (hymba-1.5b).

A copy of ``repro/models/ssm.py`` in PyTorch. The RWKV6 half:
data-dependent-decay linear attention whose per-head state is a
(d_head × d_head) matrix. The parameters are the reference's, in its
shapes (``mu`` [5, d], ``shift_lora_b`` [32, 5, d], ``u`` [H, dh], …), so a
reference tree carries across as a plain copy. As in the reference, the
five ddlerp token-shift mixes share one LoRA and the output groupnorm is a
per-head RMS norm; the recurrence itself is exact.

``rwkv_time_mix_train(..., use_kernel=True)`` runs the scan through K4
(:mod:`repro_torch.kernels.rwkv_scan`); ``use_kernel=False`` is the
reference's per-token recurrence, :func:`rwkv_recurrence` (K4's plain
version). Both compute the same function.

The Mamba half (``init_mamba_params``, ``_mamba_core``, ``MambaState``,
``mamba_train``, ``mamba_decode``) has no kernel in the reference: its
recurrence is a ``jax.lax.scan`` over tokens. Here it is torch ops
(:func:`_selective_scan`): everything but the recurrence is computed for a
chunk of ``SCAN_CHUNK`` tokens at once, and the loop over the chunk's
tokens carries only the float32 state, one ``addcmul`` a token.
``logA`` is float32 in every config, as the reference builds it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._shards import (evenly_sharded, is_dtensor,
                                         on_shards, refuse, stand_in)
from repro_torch.kernels.rwkv_scan import (on_mesh, rwkv_scan, rwkv_scan_plain,
                                           u_like)

from .common import (BATCH_AXES, ModelConfig, as_dtensor, constraint_spec,
                     dense_init, maybe_shard, summed)

LORA_DIM = 32


def _heads(cfg: ModelConfig):
    return cfg.n_heads_padded, cfg.d_model // cfg.n_heads_padded


def token_shift(x):
    """x delayed by one position, zero first: [B,S,d] -> [B,S,d]. A
    DTensor's shift is a concatenation: torch 2.11's DTensor pads one
    into a malformed spec (one placement on a 2-d mesh)."""
    if is_dtensor(x):
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def init_rwkv_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dt, dev = cfg.d_model, cfg.param_dtype, gen.device
    H, dh = _heads(cfg)
    return {
        "mu": torch.full((5, d), 0.5, dtype=dt, device=dev),  # r,k,v,w,g lerp
        "shift_lora_a": dense_init(gen, d, (d, LORA_DIM), dt),
        "shift_lora_b": dense_init(gen, LORA_DIM, (LORA_DIM, 5, d), dt),
        "wr": dense_init(gen, d, (d, d), dt),
        "wk": dense_init(gen, d, (d, d), dt),
        "wv": dense_init(gen, d, (d, d), dt),
        "wg": dense_init(gen, d, (d, d), dt),
        "wo": dense_init(gen, d, (d, d), dt),
        "w0": torch.full((d,), -0.5, dtype=dt, device=dev),  # decay logit
        "w_lora_a": dense_init(gen, d, (d, LORA_DIM), dt),
        "w_lora_b": dense_init(gen, LORA_DIM, (LORA_DIM, d), dt),
        "u": dense_init(gen, dh, (H, dh), dt),  # bonus
        "ln_out": torch.ones((d,), dtype=dt, device=dev),
    }


def _rwkv_inputs(params, x, x_prev, cfg: ModelConfig):
    """Token-shift ddlerp, then the projections to r, k, v, w, g. x: [B,S,d].
    r, k, v, g are in x's dtype, w = exp(-exp(logit)) in float32."""
    H, dh = _heads(cfg)
    xx = x_prev - x
    mix0 = x + xx * params["mu"][3]  # seed mix (reuses w's mu)
    lora = torch.tanh(mix0 @ params["shift_lora_a"])
    lora_b = params["shift_lora_b"]
    if is_dtensor(lora_b) and any(p.is_shard(2) for p in lora_b.placements):
        # the einsum flattens (5, d), which torch 2.11's DTensor refuses
        # where d is split (over the data axes: FSDP): one product a mix
        delta = torch.stack([lora @ lora_b[:, i] for i in range(5)], dim=2)
    else:
        delta = torch.einsum("bsl,lkd->bskd", lora, lora_b)  # [B,S,5,d]
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (params["mu"][None, None]
                                                     + delta)
    xr, xk, xv, xw, xg = (mixed[:, :, i] for i in range(5))

    B, S = x.shape[:2]
    r = (xr @ params["wr"]).reshape(B, S, H, dh)
    k = (xk @ params["wk"]).reshape(B, S, H, dh)
    v = (xv @ params["wv"]).reshape(B, S, H, dh)
    g = F.silu(xg @ params["wg"])
    w_logit = params["w0"] + torch.tanh(xw @ params["w_lora_a"]) \
        @ params["w_lora_b"]
    w = torch.exp(-torch.exp(w_logit.float())).reshape(B, S, H, dh)
    r = maybe_shard(r, BATCH_AXES, None, "model", None)
    k = maybe_shard(k, BATCH_AXES, None, "model", None)
    v = maybe_shard(v, BATCH_AXES, None, "model", None)
    w = maybe_shard(w, BATCH_AXES, None, "model", None)
    return r, k, v, w, g


# the reference's exact RWKV6 recurrence, one step per token (the plain
# route): r, k, v, w [B,S,H,dh]; u [H,dh]; state [B,H,dh,dh] key-major.
# Returns out [B,S,H,dh], final state.
rwkv_recurrence = rwkv_scan_plain


def _rwkv_out(params, wkv, g, cfg: ModelConfig):
    B, S = g.shape[:2]
    d = cfg.d_model
    y = wkv.reshape(B, S, d).float()
    # per-head rmsnorm stand-in for groupnorm
    yh = y.reshape(B, S, wkv.shape[2], -1)
    yh = yh * torch.rsqrt(torch.mean(yh * yh, dim=-1, keepdim=True) + 1e-5)
    y = yh.reshape(B, S, d) * params["ln_out"].float()
    return summed((y.to(g.dtype) * g) @ params["wo"])


def rwkv_time_mix_scan(params, x, cfg: ModelConfig, use_kernel: bool):
    """The time mix over a full sequence from a zero state, returning
    (y, final state [B,H,dh,dh] float32), as the reference's ssm prefill
    computes them. The scan is in float32: K4 reads r, k and v in x's dtype
    (bf16 -> float32 is exact), the plain route casts them first."""
    r, k, v, w, g = _rwkv_inputs(params, x, token_shift(x), cfg)
    u = params["u"].float()
    if is_dtensor(r):
        # each rank scans its streams: the batch rows and heads r, k, v and
        # w are pinned to
        u = u_like(u, r)
    if use_kernel:
        wkv, state = rwkv_scan(r, k, v, w, u, return_state=True)
    elif is_dtensor(r):
        wkv, state = on_mesh(rwkv_recurrence, r.float(), k.float(),
                             v.float(), w, u)
    else:
        wkv, state = rwkv_recurrence(r.float(), k.float(), v.float(), w, u)
    return _rwkv_out(params, wkv.to(x.dtype), g, cfg), state


def rwkv_time_mix_train(params, x, cfg: ModelConfig, use_kernel: bool = False):
    return rwkv_time_mix_scan(params, x, cfg, use_kernel)[0]


class RWKVState(NamedTuple):
    shift: torch.Tensor     # [B, d] last token (time mix)
    shift_cm: torch.Tensor  # [B, d] last token (channel mix)
    S: torch.Tensor         # [B, H, dh, dh] float32


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> RWKVState:
    H, dh = _heads(cfg)
    d = cfg.d_model
    return RWKVState(
        shift=torch.zeros((batch, d), dtype=cfg.dtype, device=device),
        shift_cm=torch.zeros((batch, d), dtype=cfg.dtype, device=device),
        S=torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device))


def rwkv_time_mix_decode(params, x, state: RWKVState, cfg: ModelConfig):
    """x: [B, 1, d] one token. Returns (y, the new state); ``state`` is
    left as it was."""
    x_prev = state.shift[:, None, :]
    r, k, v, w, g = _rwkv_inputs(params, x, x_prev, cfg)
    u = params["u"].float()
    r1, k1, v1, w1 = (t[:, 0].float() for t in (r, k, v, w))
    kv = k1[..., :, None] * v1[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", r1,
                       state.S + u[None, :, :, None] * kv)
    S_new = w1[..., None] * state.S + kv
    y = _rwkv_out(params, out[:, None].to(x.dtype), g, cfg)
    return y, state._replace(shift=x[:, 0], S=S_new)


# --- RWKV channel mix (replaces the FFN in rwkv blocks) ----------------

def init_rwkv_cm_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dt, device=gen.device),
        "wk": dense_init(gen, d, (d, f), dt),
        "wv": dense_init(gen, f, (f, d), dt),
    }


def rwkv_channel_mix(params, x, x_prev):
    xk = x + (x_prev - x) * params["mu_k"]
    h = torch.square(F.relu(xk @ params["wk"]))
    h = maybe_shard(h, BATCH_AXES, None, "model")
    return summed(h @ params["wv"])


# =====================================================================
# Mamba-style selective SSM branch (Hymba hybrid)
# =====================================================================

CONV_K = 4
# tokens of the scan's [B, T, d, n] float32 temporaries: 105 MB each at
# hymba-1.5b's prefill (B 4, d 1600, n 16), where the whole sequence's
# would be 0.84 GB
SCAN_CHUNK = 256


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, n, dt, dev = cfg.d_model, cfg.ssm_state, cfg.param_dtype, gen.device
    return {
        "in_proj": dense_init(gen, d, (d, 2 * d), dt),   # x, z
        "conv": dense_init(gen, CONV_K, (CONV_K, d), dt),
        "w_bc": dense_init(gen, d, (d, 2 * n), dt),
        "w_dt": dense_init(gen, d, (d,), dt),
        "dt_bias": torch.zeros((d,), dtype=dt, device=dev),
        # float32 in every config, as the reference's jnp.log(linspace)
        "logA": torch.log(torch.linspace(1.0, float(n), n, device=dev))[None, :]
        * torch.ones((d, 1), device=dev),
        "D": torch.ones((d,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, d, (d, d), dt),
    }


def mamba_param_shapes(cfg: ModelConfig) -> dict:
    """name -> (shape, dtype) of a block's ``mamba`` group."""
    d, n, dt = cfg.d_model, cfg.ssm_state, cfg.param_dtype
    return {"in_proj": ((d, 2 * d), dt), "conv": ((CONV_K, d), dt),
            "w_bc": ((d, 2 * n), dt), "w_dt": ((d,), dt),
            "dt_bias": ((d,), dt), "logA": ((d, n), torch.float32),
            "D": ((d,), dt), "out_proj": ((d, d), dt)}


def _selective_scan(x, dt, Bm, Cm, A, h):
    """The reference's recurrence over tokens, in float32: per token t,
    ``h = exp(dt_t A) * h + (dt_t x_t) B_t`` and ``y_t = h . C_t``.
    x, dt [B,S,d], Bm, Cm [B,S,n], A [d,n], h [B,d,n]. Returns (y [B,S,d],
    the final h).

    Per chunk of ``SCAN_CHUNK`` tokens, ``exp(dt A)`` and ``(dt x) B`` are
    computed at once, the loop takes one ``addcmul`` a token, and ``h . C``
    is one contraction over the chunk's states. Where autograd records
    (an input requires grad) each state is a new tensor; else each is
    written over its own ``(dt x) B``."""
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, Bm, Cm, A, h))
    ys = []
    for c0 in range(0, x.shape[1], SCAN_CHUNK):
        c = slice(c0, c0 + SCAN_CHUNK)
        dA = torch.exp(dt[:, c, :, None] * A)                  # [B,T,d,n]
        hs = (dt[:, c] * x[:, c])[..., None] * Bm[:, c, None, :]
        if record:
            steps = []
            for t in range(hs.shape[1]):
                h = torch.addcmul(hs[:, t], dA[:, t], h)
                steps.append(h)
            hs = torch.stack(steps, 1)
        else:
            for t in range(hs.shape[1]):
                h = torch.addcmul(hs[:, t], dA[:, t], h, out=hs[:, t])
        ys.append(torch.einsum("btdn,btn->btd", hs, Cm[:, c]))
        del dA, hs
    return torch.cat(ys, 1), h.clone()


def selective_scan_cost(x, dt, Bm, Cm, A, h, needs=(False,) * 6):
    """The dry run's count (``launch/dryrun.py``: FLOPs, matmul FLOPs,
    bytes) of :func:`_selective_scan` on float32 inputs of these shapes:
    ((flops, matmul, bytes) forward, the same backward), the backward from
    ``y`` alone (the final state's gradient unused, as in a train step),
    with ``needs`` the inputs whose gradients autograd takes: x, dt, Bm, Cm
    and A (a train step's; the first state is zeros), or none.

    Per chunk of ``SCAN_CHUNK`` tokens (T of them; ``J`` chunks) the
    forward makes ``exp(dt A)`` and ``(dt x) B`` [B, T, d, n], one
    ``addcmul`` a token, the states stacked where autograd records, and
    ``h . C`` as one ``bmm`` (the chunk of C, and in the backward of y,
    copied where there are several chunks); the chunks' y concatenated and
    the last state copied. The backward per chunk: the ``bmm``'s two, the
    ``addcmul``'s products a token, each token's gradients written into
    whole chunk tensors and added up, the products and reductions of
    ``(dt x) B`` and ``exp(dt A)``, and (with several chunks) each chunk's
    gradients of x, dt, B and C written into whole [B, S, .] tensors and
    added up; each state's gradient summed from its two uses."""
    B, S, d = x.shape
    n = Bm.shape[-1]
    f32, C = 4, SCAN_CHUNK
    lens = [min(C, S - c0) for c0 in range(0, S, C)]
    J, P, dn = len(lens), B * d * n, d * n
    Sd, Sn = B * S * d, B * S * n
    record = any(needs)

    def copied(T):  # a chunk of C (and of y's gradient) as the bmm takes it
        return B > 1 and 1 < T < S

    fl = mm = nb = 0
    for T in lens:
        X, Xd, Xn = B * T * d * n, B * T * d, B * T * n
        fl += 3 * X + Xd + T * P + 2 * X
        mm += 2 * X
        nb += ((Xd + dn + X) + 2 * X + 3 * Xd + (Xd + Xn + X) + 4 * T * P
               + 2 * X * record + 2 * Xn * copied(T) + (X + Xn + Xd))
    fwd = (fl, mm, f32 * (nb + 2 * Sd + 2 * P))
    if not record:
        return fwd, (0, 0, 0)
    if tuple(needs) != (True,) * 5 + (False,):
        raise NotImplementedError(f"the scan's backward for gradients of "
                                  f"{needs} (x, dt, Bm, Cm, A, h) is not "
                                  "counted")
    sliced = J > 1
    fl = mm = nb = 0
    for T in lens:
        X, Xd, Xn = B * T * d * n, B * T * d, B * T * n
        fl += 4 * X + 2 * T * P + 2 * (T - 1) * X + 4 * X + 2 * Xd + X + 4 * X
        mm += 4 * X
        nb += (2 * Xd * copied(T) + 2 * (X + Xd + Xn)
               + T * 5 * P + 2 * T * (P + X) + 6 * (T - 1) * X
               + (2 * X + Xd) + (2 * X + Xn) + (X + Xd) + (X + Xn)
               + 6 * Xd + 3 * X
               + (2 * X + Xd) + (2 * X + dn) + (X + Xd) + (X + dn)
               + sliced * (2 * (Xn + Sn) + 3 * (Xd + Sd)))
    fl += ((S - 1) * 3 * P + 2 * (J - 1) * Sn + (J - 1) * Sd
           + (2 * J - 1) * Sd + (J - 1) * dn)
    nb += ((S - 1) * (5 * P + 3 * P) + 6 * (J - 1) * Sn + 3 * (J - 1) * Sd
           + 3 * (2 * J - 1) * Sd + 3 * (J - 1) * dn)
    return fwd, (fl, mm, f32 * nb)


def _meta_selective_scan(x, dt, Bm, Cm, A, h):
    """The scan's stand-in on meta tensors: (y [B,S,d], h [B,d,n]) float32,
    each a function of every input, so that a meta run's autograd graph
    reaches them all; a few ops a call, where the scan loops over the
    tokens, counted by the dry run as the scan
    (:func:`selective_scan_cost`)."""
    def ops(x, dt, Bm, Cm, A, h):
        y = x * dt * ((Bm * Cm).sum(-1, keepdim=True) + A.sum(-1))
        return y, h * A + torch.einsum("bsd,bsn->bdn", x * dt, Bm + Cm)

    return stand_in(ops, selective_scan_cost, x, dt, Bm, Cm, A, h)


def _moved(name, t, want):
    """DTensor ``t`` on the placements ``want`` by moves that gather
    nothing: a replica sliced to a shard (local), a partial sum reduced;
    any other move raises ``ValueError``."""
    from torch.distributed.tensor import Partial, Replicate
    for have, w in zip(t.placements, want):
        if not (have == w or isinstance(have, (Replicate, Partial))):
            raise refuse("selective_scan", f"{name} is {have} where the scan "
                         f"takes {w}", t)
    return t.redistribute(t.device_mesh, tuple(want))


def selective_scan_on_mesh(x, dt, Bm, Cm, A, h):
    """:func:`_selective_scan` on DTensors (``h`` may be a plain tensor,
    counted as replicated): each rank scans its own rows of the batch or
    its own channels of d, on the placements its inputs have. The
    recurrence is elementwise in d and ``h . C`` sums over n alone, so a
    rank's channels need no other rank's. Per mesh dim, x and dt [B,S,d]
    and the state h [B,d,n] name the scan's split: the batch (x, dt
    ``Shard(0)``, h ``Shard(0)``; Bm, Cm ``Shard(0)``, A replicated), d (x,
    dt ``Shard(2)``, h ``Shard(1)``; Bm, Cm replicated, A ``Shard(0)``) or
    none (all replicated); where none names a split, the batch is split
    over the data axes it divides (as ``maybe_shard`` pins a batch) and
    nothing over the others. An input replicated where the split wants a
    shard is sliced locally and a partial sum is reduced; a placement the
    split cannot take without a gather raises ``ValueError``. Under
    autograd an input replicated over ranks that hold different parts of
    the others gets a partial gradient there: A's over the batch split,
    Bm's and Cm's over the d split. On meta tensors (the dry run's
    DTensor programs) the scan is :func:`_meta_selective_scan`."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    h = as_dtensor(h, mesh)

    def role(d_dim, p):  # the split a placement names
        if isinstance(p, Replicate):
            return None
        return {Shard(0): "batch", Shard(d_dim): "d"}.get(p, "bad")

    # the axes the batch goes over, as the model's pins name them
    batch_axes = constraint_spec(x.shape[:1], (BATCH_AXES,), mesh)[0] or ()
    roles = []
    for axis, px, ph in zip(mesh.mesh_dim_names, x.placements, h.placements):
        named = {role(2, px), role(1, ph)} - {None}
        if len(named) > 1 or "bad" in named:
            raise refuse("selective_scan", f"x is {px} and h {ph} on one mesh "
                         "dim: the scan splits the batch or d", x, h)
        roles.append(named.pop() if named else
                     "batch" if axis in batch_axes else None)
    split = {"batch": (Shard(0), Shard(0), Shard(0), Replicate()),
             "d": (Shard(2), Shard(1), Replicate(), Shard(0)),
             None: (Replicate(),) * 4}
    xs, hs, bc, a = (tuple(split[r][i] for r in roles) for i in range(4))
    x, dt, h = (_moved(n, t, p) for n, t, p in
                (("x", x, xs), ("dt", dt, xs), ("h", h, hs)))
    Bm, Cm = _moved("Bm", Bm, bc), _moved("Cm", Cm, bc)
    A = _moved("A", as_dtensor(A, mesh), a)
    for name, t in (("x", x), ("h", h)):
        evenly_sharded(f"selective_scan {name}", t)
    bc_grad = tuple(Partial() if r == "d" else p for r, p in zip(roles, bc))
    a_grad = tuple(Partial() if r == "batch" else p for r, p in zip(roles, a))
    scan = _meta_selective_scan if x.is_meta else _selective_scan
    return on_shards(scan, (xs, hs), x, dt, Bm, Cm, A, h,
                     grad_placements=(None, None, bc_grad, bc_grad, a_grad,
                                      None))


def _mamba_core(params, xz, conv_state, h0):
    """xz: [B,S,2d]; conv_state: [B,CONV_K-1,d]; h0: [B,d,n] float32.
    Returns (out [B,S,d], the new conv state, the final h)."""
    d = params["D"].shape[0]
    x, z = xz[..., :d], xz[..., d:]
    # depthwise causal conv1d, summed as the reference's Python sum
    xc = torch.cat([conv_state, x], dim=1)
    S = x.shape[1]
    conv_out = sum(xc[:, i:i + S] * params["conv"][i] for i in range(CONV_K))
    x = F.silu(conv_out)
    new_conv_state = xc[:, -(CONV_K - 1):].clone()

    bc = x @ params["w_bc"]
    n = bc.shape[-1] // 2
    Bm, Cm = bc[..., :n], bc[..., n:]                       # [B,S,n]
    # F.softplus is x itself above 20; the reference's logaddexp(x, 0)
    # differs there by log1p(exp(-x)) < 2.1e-9
    dt = F.softplus(x * params["w_dt"] + params["dt_bias"])  # [B,S,d]
    A = -torch.exp(params["logA"].float())                   # [d,n]
    scan = selective_scan_on_mesh if is_dtensor(x) else _selective_scan
    y, h = scan(x.float(), dt.float(), Bm.float(), Cm.float(), A, h0)
    y = y.to(x.dtype)
    y = y + x * params["D"]
    return (y * F.silu(z)) @ params["out_proj"], new_conv_state, h


class MambaState(NamedTuple):
    conv: torch.Tensor  # [B, CONV_K-1, d]
    h: torch.Tensor     # [B, d, n] float32


def init_mamba_state(cfg: ModelConfig, batch: int, device=None) -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, CONV_K - 1, cfg.d_model), dtype=cfg.dtype,
                         device=device),
        h=torch.zeros((batch, cfg.d_model, cfg.ssm_state),
                      dtype=torch.float32, device=device))


def mamba_scan(params, x, cfg: ModelConfig):
    """The branch over a full sequence from a zero state: (y, the
    ``MambaState`` after the last token), as the reference's hybrid
    prefill computes them."""
    st = init_mamba_state(cfg, x.shape[0], x.device)
    y, conv, h = _mamba_core(params, x @ params["in_proj"], st.conv, st.h)
    return y, MambaState(conv=conv, h=h)


def mamba_train(params, x, cfg: ModelConfig):
    return mamba_scan(params, x, cfg)[0]


def mamba_decode(params, x, state: MambaState, cfg: ModelConfig):
    """x: [B, 1, d] one token. Returns (y, the new state); ``state`` is
    left as it was."""
    y, conv, h = _mamba_core(params, x @ params["in_proj"], state.conv,
                             state.h)
    return y, MambaState(conv=conv, h=h)
