"""K4: the RWKV6 WKV scan (data-dependent-decay linear attention).

A kernel written by hand in CUDA C++ (``csrc/rwkv_scan.cu``), beside a
plain PyTorch version of the same function in this module. It replaces
the Pallas kernel ``repro/kernels/rwkv_scan.py::rwkv_scan`` and computes,
for each (batch, head) stream from a zero state ``S`` [dh, dh]
(key-major),

    out_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ

over r, k, v, w [B, S, H, dh] and u [H, dh]: r, k and v float32 or
bfloat16 (one dtype), w and u float32, the scan in float32. It returns out
[B, S, H, dh] float32 and, with ``return_state=True``, also the final
state [B, H, dh, dh] float32, as ``repro/models/ssm.py::rwkv_recurrence``
does (the Pallas kernel keeps that state only in its scratch memory).

The wrapper takes tensors: on CPU tensors it runs :func:`rwkv_scan_plain`
(on r, k and v cast to float32), on CUDA tensors it launches the kernel or
raises — there is no fallback between the two. ``rwkv_scan.launches``
counts the kernels' launches: three a call (each group's own state, the
carry across groups, the outputs), one at one group a stream
(:func:`kernel_launches`). The kernels work in parallel over (stream,
group of whole chunks), about as many groups as fill the card's SMs
(:func:`groups`; one at the rwkv6-1.6b prefill's 128 streams), in chunks
of ``CHUNK`` tokens with the products on the tensor cores, and divide by
no cumulative decay (the TPU kernel's ``k / a`` overflows under strong
decay);
:func:`rwkv_scan_chunked_plain` is their decomposition in plain PyTorch,
for the CPU tests. They read the inputs through their strides (dh
contiguous) and, unlike the reference's launcher, take any S >= 1.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _shards

_SRC = _build.CSRC / "rwkv_scan.cu"
HEAD_DIMS = (16, 32, 64)
# the dtypes K4 reads r, k and v in (w and u are float32)
RKV_DTYPES = (torch.float32, torch.bfloat16)


def rwkv_scan_plain(r, k, v, w, u, state=None):
    """Plain PyTorch version of :func:`rwkv_scan`: the exact recurrence of
    the reference's ``ref.rwkv_scan_ref`` (and of its model's
    ``rwkv_recurrence``), one step per token, from ``state`` [B, H, dh, dh]
    (zero if None). Returns (out [B, S, H, dh], final state)."""
    B, S, H, dh = r.shape
    if state is None:
        state = torch.zeros((B, H, dh, dh), dtype=torch.float32,
                            device=r.device)
    ub = u[None, :, :, None]
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + ub * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


# the kernel's chunk and sub-chunk lengths, and its floor on log2 w
CHUNK = 32
SUB = 16
LOG2_FLOOR = -150.0


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as the kernel's ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b as the kernel forms it on the tensor cores: three TF32
    products of the hi + lo parts of both operands (lo·hi + hi·lo + hi·hi),
    summed in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _suffix(x):
    """Exclusive suffix sums along dim 2: out[j] = sum_{i > j} x[i]."""
    inc = torch.flip(torch.cumsum(torch.flip(x, [2]), 2), [2])
    return torch.nn.functional.pad(inc[:, :, 1:], (0, 0, 0, 1))


def rwkv_scan_chunked_plain(r, k, v, w, u, group=None):
    """The kernels' decomposition of :func:`rwkv_scan` in plain PyTorch
    (float32 in and out; nothing on the main path calls it). The tokens
    split into groups of ``group`` tokens, a multiple of ``CHUNK`` (None:
    one group):

    * each group g but the last, from a zero state: ``dS_g = (k_j
      2^E_j)ᵀ V``, summed chunk by chunk, E_j the exclusive suffix sum of
      log2 w to the group's end, and its decay ``D_g = 2^(Σ log2 w)``; then
      ``S_in[g + 1] = diag(D_g) S_in[g] + dS_g`` from ``S_in[0] = 0``;
    * each group from ``S_in[g]``, per chunk of ``CHUNK`` tokens, with L
      the inclusive cumulative log2 decay from the chunk's start: cross
      ``(r_t 2^L_{t-1}) · S_in`` and state ``S_out = diag(2^L_last) S_in +
      (k_j 2^(L_last - L_j))ᵀ V``; intra ``A V`` with A's diagonal
      ``SUB``-blocks pairwise, ``A[t, j] = Σ_c r_tc k_jc Π_{j<i<t} w_ic`` (a
      running product of w) for j < t and the bonus ``Σ_c r_tc u_c k_tc``
      at j = t, and its blocks below the diagonal as products anchored at
      the query block's start p: ``(r_t 2^(L_{t-1} - L_p)) · (k_j 2^(L_p -
      L_j))``;

    log2 w floored at ``LOG2_FLOOR``, every exponent <= 0, and every product
    (cross, intra, state, the anchored scores and dS) in three TF32 parts
    (:func:`_mm3`). Returns (out [B, S, H, dh], final state [B, H, dh,
    dh])."""
    B, S, H, dh = r.shape
    pad = -S % CHUNK

    def streams(x, fill):  # [B, S, H, dh] -> [B, H, S + pad, dh]
        x = x.float().transpose(1, 2)
        return torch.nn.functional.pad(x, (0, 0, 0, pad), value=fill)

    r, k, v, w = (streams(x, fill) for x, fill in
                  ((r, 0.0), (k, 0.0), (v, 0.0), (w, 1.0)))
    group = S + pad if group is None else group
    if group % CHUNK:
        raise ValueError(f"group {group}: want a multiple of {CHUNK}")
    lw = torch.clamp(torch.log2(w), min=LOG2_FLOOR)
    s_in = [torch.zeros((B, H, dh, dh), dtype=torch.float32,
                        device=r.device)]
    for g0 in range(0, S + pad - group, group):
        grp = slice(g0, g0 + group)
        E = _suffix(lw[:, :, grp])
        kd = (k[:, :, grp] * torch.exp2(E)).transpose(-1, -2)
        dS = torch.zeros_like(s_in[0])
        for c in reversed(range(0, group, CHUNK)):  # from the group's end
            dS += _mm3(kd[..., c:c + CHUNK], v[:, :, g0 + c:g0 + c + CHUNK])
        D = torch.exp2(E[:, :, :1] + lw[:, :, g0:g0 + 1])
        s_in.append(D.transpose(-1, -2) * s_in[-1] + dS)
    ub = u.float()[None, :, None, :]
    t_ = torch.arange(SUB, device=r.device)
    outs = []
    for c0 in range(0, S + pad, CHUNK):
        if c0 % group == 0:
            state = s_in[c0 // group]
        rc, kc, vc = (x[:, :, c0:c0 + CHUNK] for x in (r, k, v))
        L = torch.cumsum(lw[:, :, c0:c0 + CHUNK], dim=2)
        Lprev = torch.nn.functional.pad(L, (0, 0, 1, 0))[:, :, :-1]
        Llast = L[:, :, -1:]
        A = torch.zeros((B, H, CHUNK, CHUNK), dtype=torch.float32,
                        device=r.device)
        for a in range(0, CHUNK, SUB):
            q = slice(a, a + SUB)
            rq, kq, wq = rc[:, :, q], kc[:, :, q], w[:, :, c0 + a:c0 + a + SUB]
            # the diagonal block, pair by pair: j = t - d, its decay
            # F[t] = prod_{j<i<t} w_i grown by one factor per step of d
            blk = torch.diag_embed((rq * ub * kq).sum(-1))
            F = torch.ones_like(rq)
            for d in range(1, SUB):
                if d > 1:
                    F[:, :, d:] = F[:, :, d:] * wq[:, :, 1:SUB - d + 1]
                blk[:, :, t_[d:], t_[:SUB - d]] = (
                    rq[:, :, d:] * kq[:, :, :SUB - d] * F[:, :, d:]).sum(-1)
            A[:, :, q, q] = blk
            if a:  # the blocks left of it, anchored at token a - 1
                Lp = L[:, :, a - 1:a]
                qp = rc[:, :, q] * torch.exp2(Lprev[:, :, q] - Lp)
                kp = kc[:, :, :a] * torch.exp2(Lp - L[:, :, :a])
                A[:, :, q, :a] = _mm3(qp, kp.transpose(-1, -2))
        qd = rc * torch.exp2(Lprev)
        kd = kc * torch.exp2(Llast - L)
        outs.append(_mm3(qd, state) + _mm3(A, vc))
        state = (torch.exp2(Llast).transpose(-1, -2) * state
                 + _mm3(kd.transpose(-1, -2), vc))
    out = torch.cat(outs, dim=2)[:, :, :S].transpose(1, 2)
    return out, state


_LIB = None


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _build.load(_SRC)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rwkv_scan_launch.argtypes = ([vp] * 9 + [ctypes.POINTER(i32)]
                                     + [i32] * 5 + [i64] * 12 + [vp])
    lib.rwkv_scan_launch.restype = ctypes.c_int
    lib.rwkv_scan_groups.argtypes = [i32] * 3 + [ctypes.POINTER(i32)]
    lib.rwkv_scan_groups.restype = ctypes.c_int
    lib.rwkv_scan_error_string.argtypes = [ctypes.c_int]
    lib.rwkv_scan_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def _check(r, k, v, w, u):
    if r.dim() != 4:
        raise ValueError(f"r has shape {tuple(r.shape)}: want [B, S, H, dh]")
    B, S, H, dh = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, r "
                             f"{tuple(r.shape)}: want the same")
    if u.shape != (H, dh):
        raise ValueError(f"u has shape {tuple(u.shape)}: want ({H}, {dh})")
    if r.dtype not in RKV_DTYPES:
        raise ValueError(f"r is {r.dtype}: want one of {RKV_DTYPES}")
    for name, t, dtype in (("k", k, r.dtype), ("v", v, r.dtype),
                           ("w", w, torch.float32), ("u", u, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}: want {dtype}")
    for t in (k, v, w, u):
        if t.device != r.device:
            raise ValueError("r, k, v, w and u must be on one device")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if min(B, S, H) < 1:
        raise ValueError(f"B {B}, S {S}, H {H}: want each >= 1")


def groups(B: int, H: int, S: int) -> int:
    """The groups a stream the kernels split S tokens into, for B H
    streams on the current CUDA device (about its SMs / (B H))."""
    lib = load_library()
    G = ctypes.c_int(0)
    err = lib.rwkv_scan_groups(B, H, S, ctypes.byref(G))
    if err != 0:
        msg = lib.rwkv_scan_error_string(err).decode()
        raise RuntimeError(f"rwkv_scan_groups failed: CUDA error {err} "
                           f"({msg})")
    return G.value


def kernel_launches(B: int, H: int, S: int) -> int:
    """The kernels one CUDA call of :func:`rwkv_scan` launches: one at one
    group a stream, else three."""
    return 1 if groups(B, H, S) == 1 else 3


def rwkv_scan(r, k, v, w, u, return_state: bool = False):
    """r, k, v: float32 or bfloat16 (one dtype), w: float32, each
    [B, S, H, dh], any S >= 1, dh in {16, 32, 64}; u: float32 [H, dh].
    Returns out [B, S, H, dh] float32, and with ``return_state`` (out,
    final state [B, H, dh, dh] float32).

    CPU tensors run :func:`rwkv_scan_plain` on r, k and v cast to float32
    (exact from bf16); CUDA tensors launch the kernels
    (:func:`kernel_launches`), which read r, k, v and w through their
    strides (the head dim contiguous) and in their own dtype. Anything else
    raises ``ValueError``; off the CPU, inputs that autograd would
    differentiate raise ``RuntimeError`` (the kernels have no backward:
    :func:`._build.refuse_grad`)."""
    _check(r, k, v, w, u)
    if _shards.is_dtensor(r):
        return on_mesh(lambda *a: rwkv_scan(*a, return_state=return_state),
                       r, k, v, w, u, return_state)
    if r.device.type == "cpu":
        out, state = rwkv_scan_plain(r.float(), k.float(), v.float(), w, u)
        return (out, state) if return_state else out
    _build.refuse_grad("rwkv_scan", r, k, v, w, u)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(3) != 1:
            raise ValueError(f"the head dim of {name} must be contiguous")
    B, S, H, dh = r.shape
    u = u.contiguous()
    out = torch.empty((B, S, H, dh), dtype=torch.float32, device=r.device)
    state = (torch.empty((B, H, dh, dh), dtype=torch.float32,
                         device=r.device) if return_state else None)
    lib = load_library()
    n_launches = ctypes.c_int(0)
    with torch.cuda.device(r.device):
        # scratch of the carry across groups: each group's state (then the
        # state entering the next) and its decay
        n_carry = B * H * (groups(B, H, S) - 1) * dh
        carry = torch.empty(n_carry * (dh + 1), dtype=torch.float32,
                            device=r.device) if n_carry else None
        err = lib.rwkv_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(),
            state.data_ptr() if return_state else None,
            carry.data_ptr() if n_carry else None,
            carry[n_carry * dh:].data_ptr() if n_carry else None,
            ctypes.byref(n_launches), B, S, H, dh,
            int(r.dtype == torch.bfloat16),
            r.stride(0), r.stride(1), r.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            w.stride(0), w.stride(1), w.stride(2),
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        msg = lib.rwkv_scan_error_string(err).decode()
        raise RuntimeError(f"rwkv_scan launch failed: CUDA error {err} "
                           f"({msg})")
    rwkv_scan.launches += n_launches.value
    return (out, state) if return_state else out


def u_like(u, r):
    """The bonus ``u`` [H, dh] on the placements :func:`on_mesh` takes
    beside DTensor ``r``: sharded on its heads where r's heads are,
    replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    want = [Shard(0) if p == Shard(2) else Replicate() for p in r.placements]
    if not isinstance(u, DTensor):
        u = DTensor.from_local(u, r.device_mesh,
                               [Replicate()] * r.device_mesh.ndim,
                               run_check=False)
    return u.redistribute(r.device_mesh, want)


def plain_cost(r, k, v, w, u, needs=(False,) * 5):
    """The dry run's count (``launch/dryrun.py``: FLOPs, matmul FLOPs,
    bytes) of :func:`rwkv_scan_plain` on float32 inputs of these shapes
    from a zero state, forward and backward: ((flops, matmul, bytes)
    forward, the same backward), the backward from ``out`` alone (the
    final state's gradient unused, as in a train step) with ``needs`` the
    inputs whose gradients autograd takes: all five, or none.

    Per token the forward multiplies k v^T, u (k v^T), adds the state, and
    takes r's product with it (a copy of r's token, one ``bmm``), then
    updates the state (a product and a sum); the outputs are stacked. The
    backward per token: the product's two ``bmm`` (and a copy of the
    output's gradient), u's and k's and v's products and reductions,
    w's for every token but the last (whose state no output reads), a
    token's gradient written into a whole [B, S, H, dh] zero tensor
    (``select_backward``) and added to the ones before it, and the
    state's gradient carried back (a product and a sum a token)."""
    B, S, H, K = r.shape
    f32 = 4
    vec, M, HK, X = B * H * K, B * H * K * K, H * K, B * S * H * K
    # r's token as the bmm takes it: a copy unless B, H or S is 1
    cp = 2 * vec if (B > 1 and H > 1 and S > 1) else 0
    fwd = (7 * S * M, 2 * S * M,
           f32 * (S * (5 * vec + 12 * M + HK + cp) + 2 * S * vec + M))
    if not any(needs):
        return fwd, (0, 0, 0)
    if not all(needs):
        raise NotImplementedError(f"the scan's backward for gradients of "
                                  f"{needs} (r, k, v, w, u) is not counted")
    T = S
    w_t, mid = max(T - 1, 0), max(T - 2, 0)   # tokens w and the state reach
    flops = (4 * T * M                          # the product's two bmm
             + 3 * T * M + (T - 1) * HK         # u: its products, its sums
             + (T - 1) * X                      # r's gradients summed
             + 4 * T * M + 2 * (T - 1) * X      # k's and v's
             + 2 * w_t * M + max(w_t - 1, 0) * X  # w's
             + 2 * mid * M                      # the state's, carried
             + w_t * M)                         # k v^T's, summed
    nbytes = (T * cp + 2 * T * (2 * vec + M)
              + T * (2 * M + HK) + 3 * T * M + T * (M + HK)
              + 3 * (T - 1) * HK
              + T * (vec + X) + 3 * (T - 1) * X
              + 2 * T * (2 * M + vec) + 2 * T * (M + vec)
              + 2 * T * (vec + X) + 6 * (T - 1) * X
              + w_t * (3 * M + M + vec + vec + X)
              + 3 * max(w_t - 1, 0) * X
              + mid * (2 * M + vec + 3 * M)
              + 3 * w_t * M)
    return fwd, (flops, 4 * T * M, f32 * nbytes)


def _meta_scan(r, k, v, w, u):
    """The scan's stand-in on meta tensors: (out [B, S, H, dh], state
    [B, H, dh, dh]) float32, each a function of every input, so that a
    meta run's autograd graph reaches them all; a few ops a call, where
    the recurrence loops over the tokens, counted by the dry run as the
    recurrence (:func:`plain_cost`)."""
    def ops(r, k, v, w, u):
        out = (r * k * v).float() * w * u
        state = torch.einsum("bshk,bshv->bhkv", k.float() * w, v.float())
        return out, state

    return _shards.stand_in(ops, plain_cost, r, k, v, w, u)


def on_mesh(scan, r, k, v, w, u, return_state=True):
    """``scan(r, k, v, w, u)`` (K4 or the plain recurrence; it returns
    (out, state) when ``return_state``, else out) on DTensors: each rank
    scans its own streams. Per mesh dim, r, k, v and w may be replicated,
    or sharded alike and evenly on the batch (``Shard(0)``; u replicated)
    or on the heads (``Shard(2)``; u ``Shard(0)``); anything else raises
    ``ValueError``. The state comes out sharded as its streams: batch
    ``Shard(0)``, heads ``Shard(1)``. On meta tensors (the dry run's DTensor
    programs) the scan, which issues no collective, is :func:`_meta_scan`:
    the same shapes and placements, without a loop over the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    ts = (r, k, v, w)
    if not (all(_shards.is_dtensor(t) and t.placements == r.placements
                for t in ts) and _shards.is_dtensor(u)):
        raise _shards.refuse("rwkv_scan", "r, k, v, w and u must be DTensors, "
                             "r, k, v and w with one placement", r)
    # u's gradient sums over the batch rows: partial where they are split
    state_pl, u_pl, u_grad = [], [], []
    for p in r.placements:
        if isinstance(p, Replicate):
            state_pl.append(p)
            u_pl.append(p)
            u_grad.append(p)
        elif isinstance(p, Shard) and p.dim in (0, 2):
            state_pl.append(Shard(0 if p.dim == 0 else 1))
            u_pl.append(Replicate() if p.dim == 0 else Shard(0))
            u_grad.append(Partial() if p.dim == 0 else Shard(0))
        else:
            raise _shards.refuse("rwkv_scan", f"placement {p}: only the batch "
                                 "and the heads may be sharded", *ts)
    if tuple(u.placements) != tuple(u_pl):
        raise _shards.refuse("rwkv_scan", f"u must be {tuple(u_pl)}", r, u)
    _shards.evenly_sharded("rwkv_scan", r)
    out_pl = (r.placements, tuple(state_pl)) if return_state else r.placements
    if r.is_meta:  # a dry run: the rank-local scan's shapes alone
        scan = _meta_scan if return_state else (
            lambda *a: _meta_scan(*a)[0])
    return _shards.on_shards(scan, out_pl, r, k, v, w, u,
                             grad_placements=(None,) * 4 + (tuple(u_grad),))


rwkv_scan.launches = 0
