"""K3: flash attention (causal / sliding-window / non-causal), GQA-aware.

A kernel written by hand in CUDA C++ (``csrc/flash_attention.cu``),
beside a plain PyTorch version of the same function in this module. It
replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention`` and computes ``softmax(q·kᵀ·scale + mask)·v``:

* q, k [B, H or KV, S or Sk, dh]; v [B, KV, Sk, dv] with dv = dh, or
  narrower where latent attention's q/k carry a rope part that v lacks;
  query head ``h`` reads kv head ``h // (H // KV)``;
* queries are aligned to the end of the keys (``q_offset = Sk - S``);
  causal keeps ``kpos <= qpos``, a window ``w > 0`` also
  ``kpos > qpos - w``; masked scores are the finite ``NEG_INF``;
* scores, the running max and denominator (floored at 1e-30) and the
  accumulator are float32; the output is in q's dtype (bf16 or f32).

The wrapper takes tensors: on CPU tensors it runs
:func:`flash_attention_plain`, on CUDA tensors it launches the kernel or
raises — there is no fallback between the two. ``flash_attention.launches``
counts the kernel's launches. The kernel takes any strides with a
contiguous last dim, so ``[B, S, H, dh]`` activations pass as transposed
views without a copy; unlike the reference's launcher it takes a ragged S
and Sk (no block multiple).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _shards

_SRC = _build.CSRC / "flash_attention.cu"
NEG_INF = -1e30
# the head dims the kernel takes where q, k and v are alike: those of the
# registry's configs, full and reduced (the Pallas kernel takes any dh)
HEAD_DIMS = (32, 64, 80, 112, 128)
# (q/k, v) widths it takes where they differ, in bfloat16 only: latent
# attention's 128 + 64 rope against v 128 (DeepSeek-V3, Kimi-K2)
QK_V_DIMS = ((192, 128),)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _keep(S: int, Sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """[S, Sk] bool: which keys each query may see."""
    qpos = torch.arange(S, device=device)[:, None] + (Sk - S)
    kpos = torch.arange(Sk, device=device)[None, :]
    if not causal:
        return torch.ones((S, Sk), dtype=torch.bool, device=device)
    ok = kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return ok


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0,
                          scale=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: expand the kv
    heads, then float32 scores, mask, softmax and output (v's width)."""
    H, dh = q.shape[1], q.shape[3]
    S, Sk = q.shape[2], k.shape[2]
    g = H // k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kk) * scale
    s = torch.where(_keep(S, Sk, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vv).to(q.dtype)


_LIB = None


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _build.load(_SRC)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [vp, vp, vp, vp] + [i32] * 8 + [i64] * 12
        + [i32, i32, ctypes.c_float, vp])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    scale=None) -> torch.Tensor:
    """q: [B, H, S, dh]; k: [B, KV, Sk, dh]; v: [B, KV, Sk, dv] with
    H % KV == 0.

    Returns [B, H, S, dv] in q's dtype. CPU tensors run
    :func:`flash_attention_plain`; CUDA tensors launch the kernel, which
    takes float32 (on the CUDA cores) or bfloat16 (on the tensor cores,
    through TMA: 16-byte aligned, strides multiples of 8), dh = dv in
    ``HEAD_DIMS`` or, in bfloat16, (dh, dv) in ``QK_V_DIMS``, and Sk >= S
    when causal. Off the CPU, inputs that autograd would differentiate
    raise ``RuntimeError`` (the kernel has no backward:
    :func:`._build.refuse_grad`)."""
    B, H, S, dh = q.shape
    KV, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape != (B, KV, Sk, dh) or v.shape != (B, KV, Sk, dv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if _shards.is_dtensor(q):
        return _on_mesh(q, k, v, causal, window, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, scale)
    _build.refuse_grad("flash_attention", q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want all "
                         "float32 or all bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if dh == dv and dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if dh != dv and ((dh, dv) not in QK_V_DIMS or q.dtype != torch.bfloat16):
        raise ValueError(f"q/k width {dh} and v width {dv}: want them equal "
                         f"or, in bfloat16, one of {QK_V_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"the head dim of {name} must be contiguous")
        # the bf16 kernel reads through TMA tensor maps: 16-byte aligned
        # base and strides
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"bfloat16 {name} must be 16-byte aligned with "
                             "strides that are multiples of 8")
    if S < 1 or Sk < 1 or (causal and Sk < S):
        raise ValueError(f"S {S}, Sk {Sk}: want both >= 1 and Sk >= S when "
                         "causal")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty((B, H, S, dv), dtype=q.dtype, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, KV, S, Sk, dh, dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(bool(causal)), int(window), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: error {err} "
                           f"({msg})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _on_mesh(q, k, v, causal, window, scale):
    """K3 on DTensors: each rank runs the kernel on its shard. Per mesh
    dim, q, k and v may be replicated, or sharded alike and evenly on the
    batch (dim 0) or the heads (dim 1). On one mesh dim q may be sharded
    on its heads while k and v are replicated there (the kv heads do not
    divide it, as the einsum route leaves them): each rank then takes the
    kv heads its query heads group over, which needs a rank's query heads
    to span whole groups or to lie within one. The sequence and the head
    dim may not be sharded. Anything else raises ``ValueError``. On meta
    tensors (the dry run's DTensor programs) the kernel is stood in for
    by its plain version, on the same shards."""
    from torch.distributed.tensor import Replicate, Shard
    if not (_shards.is_dtensor(k) and _shards.is_dtensor(v)
            and k.placements == v.placements):
        raise _shards.refuse("flash_attention", "q, k and v must be DTensors, "
                             "k and v with one placement", q)
    sliced = None  # the mesh dim on which each rank takes its own kv heads
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if pq == pk and (isinstance(pq, Replicate)
                         or (isinstance(pq, Shard) and pq.dim in (0, 1))):
            continue
        if pq == Shard(1) and isinstance(pk, Replicate) and sliced is None:
            sliced = i
            continue
        raise _shards.refuse("flash_attention", f"placements ({pq}, {pk}) of "
                             "q and k on one mesh dim: only the batch and the "
                             "heads may be sharded", q, k, v)
    for t in (q, k):
        _shards.evenly_sharded("flash_attention", t)
    lo, n = 0, k.shape[1]
    if sliced is not None:
        if Shard(1) in k.placements:
            raise _shards.refuse("flash_attention", "the kv heads are sharded "
                                 "on one mesh dim and not on another", q, k, v)
        h = q.shape[1] // q.device_mesh.size(sliced)  # query heads a rank
        group = q.shape[1] // k.shape[1]
        if h % group and group % h:
            raise _shards.refuse("flash_attention", f"a rank's {h} query heads "
                                 f"straddle groups of {group}", q, k, v)
        lo = q.device_mesh.get_local_rank(sliced) * h // group
        n = max(h // group, 1)
    kernel = flash_attention_plain if q.is_meta else flash_attention

    def local(q, k, v):
        return kernel(q, k[:, lo:lo + n], v[:, lo:lo + n], causal, window,
                      scale)

    return _shards.on_shards(local, q.placements, q, k, v)
