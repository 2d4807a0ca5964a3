"""K5: the grouped (per-expert) matrix product of the MoE layer.

A kernel written by hand in CUDA C++ (``csrc/moe_gemm.cu``), beside a
plain PyTorch version of the same function in this module. It replaces
the Pallas kernel ``repro/kernels/moe_gemm.py::moe_gemm`` and computes
``out[e] = x[e] @ w[e]`` for the capacity-packed expert buffer x [E, C, d]
and the expert weights w [E, d, f], out [E, C, f], with a float32
accumulator over the whole d loop and the output in x's dtype, as
``repro/kernels/ref.py::moe_gemm_ref`` does.

The wrapper takes tensors: on CPU tensors it runs :func:`moe_gemm_plain`,
on CUDA tensors it launches a kernel or raises — there is no fallback
between the two. bf16 runs on the tensor cores in one of two kernels,
chosen by shape alone (:func:`pick_variant`): ``wide`` (persistent, TMA and
``wgmma`` on 128 × 256 tiles; prefill) above ``NARROW_MAX_C`` rows and
``narrow`` (``out^T = w^T x^T``, the weights streamed; decode) up to it.
float32 runs on the CUDA cores (variant ``f32``). ``moe_gemm.launches``
counts the kernels' launches, ``moe_gemm.variant_launches`` the same per
variant. Unlike the reference's launcher it takes any C >= 1 (no block
multiple); d and f must be multiples of 8 (16-byte rows) on every device.

:func:`moe_gemm_routed` is the same product over a routed buffer x [R, d]:
each expert's rows in one segment, 128-row aligned (``ROUTE_ROWS``), whose
starts in 128-row tiles a device array gives (``tiles`` [E + 1], int32);
the host never reads it. bf16 runs on ``wide``, float32 on ``f32``, each
walking only the segments' tiles; both count as that variant's launches.
:func:`moe_gemm_routed_plain` is its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _shards

_SRC = _build.CSRC / "moe_gemm.cu"
_DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = {"f32": 0, "wide": 1, "narrow": 2}  # the kernel's `kind`
# The largest C the narrow kernel takes (its N: C rounded up to 8, 16, 32
# or 64); up to it, narrow is as fast as wide or faster (chip_smoke.py's
# k5_crossover lines measure both).
NARROW_MAX_C = 64
# A routed segment's alignment: the wide kernel's row tile
ROUTE_ROWS = 128


def pick_variant(C: int) -> str:
    """The bf16 kernel for C rows an expert: ``narrow`` up to
    ``NARROW_MAX_C`` (the product is bound by w's bytes, and ``narrow``
    computes no padded row), ``wide`` above. d and f do not enter: both
    kernels read w once at every d and f."""
    return "narrow" if C <= NARROW_MAX_C else "wide"


def moe_gemm_plain(x, w):
    """Plain PyTorch version of :func:`moe_gemm`: both inputs in float32,
    one batched product, the result cast back to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def moe_gemm_routed_plain(x, w, tiles):
    """Plain PyTorch version of :func:`moe_gemm_routed`: each expert's
    segment in float32, one product an expert, the result cast back to x's
    dtype; the rows past the last segment are zeros. Reads ``tiles`` on
    the host."""
    out = x.new_zeros((x.shape[0], w.shape[2]))
    rows = [ROUTE_ROWS * int(t) for t in tiles.tolist()]
    for e in range(w.shape[0]):
        a, b = rows[e], rows[e + 1]
        if b > a:
            out[a:b] = (x[a:b].float() @ w[e].float()).to(x.dtype)
    return out


_LIB = None


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _build.load(_SRC)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moe_gemm_launch.argtypes = [vp, vp, vp] + [i32] * 5 + [vp]
    lib.moe_gemm_launch.restype = ctypes.c_int
    lib.moe_gemm_routed_launch.argtypes = [vp] * 4 + [i32] * 5 + [vp]
    lib.moe_gemm_routed_launch.restype = ctypes.c_int
    lib.moe_gemm_error_string.argtypes = [ctypes.c_int]
    lib.moe_gemm_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def _check(x, w):
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}: want "
                         "[E, C, d] and [E, d, f]")
    E, C, d = x.shape
    if w.shape[0] != E or w.shape[1] != d:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "share E and d")
    f = w.shape[2]
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype}: want both float32 "
                         "or both bfloat16")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    if min(E, C) < 1 or d < 8 or f < 8 or d % 8 or f % 8:
        raise ValueError(f"E {E}, C {C}, d {d}, f {f}: want E, C >= 1 and d, "
                         "f positive multiples of 8")


def moe_gemm(x, w):
    """x: [E, C, d]; w: [E, d, f] -> [E, C, f] in x's dtype.

    CPU tensors run :func:`moe_gemm_plain`; CUDA tensors launch the kernel
    that :func:`pick_variant` names (bf16) or the float32 one. Anything
    the kernels do not take raises ``ValueError``; inputs that autograd
    would differentiate raise ``RuntimeError`` (the kernels have no
    backward: :func:`._build.refuse_grad`)."""
    _check(x, w)
    if _shards.is_dtensor(x):
        return _on_mesh(x, w)
    if x.device.type == "cpu":
        return moe_gemm_plain(x, w)
    variant = "f32" if x.dtype == torch.float32 else pick_variant(x.shape[1])
    return launch(x, w, variant)


def launch(x, w, variant: str):
    """Launch one kernel on CUDA tensors: ``variant`` is ``f32`` for
    float32, ``wide`` or ``narrow`` (C <= ``NARROW_MAX_C``) for bfloat16.
    :func:`moe_gemm` picks it; measuring the crossover names it. Inputs
    contiguous and 16-byte aligned; anything else raises ``ValueError``."""
    _check(x, w)
    E, C, d = x.shape
    f = w.shape[2]
    if variant not in VARIANTS or (variant == "f32") != (x.dtype ==
                                                         torch.float32):
        raise ValueError(f"variant {variant!r} does not take {x.dtype}")
    if variant == "narrow" and C > NARROW_MAX_C:
        raise ValueError(f"the narrow kernel takes C <= {NARROW_MAX_C}, "
                         f"not {C}")
    _ready(x, w)
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    return _enqueue("moe_gemm_launch", x, out, variant, x.data_ptr(),
                    w.data_ptr(), out.data_ptr(), VARIANTS[variant], E, C,
                    d, f)


def _ready(x, w, tiles=None):
    """What every launch needs: no gradient asked for, CUDA tensors,
    contiguous, x and w 16-byte aligned (TMA); else it raises."""
    _build.refuse_grad("moe_gemm", x, w)
    if x.device.type != "cuda":
        raise ValueError(f"launch needs CUDA tensors, not {x.device}")
    for name, t in (("x", x), ("w", w), ("tiles", tiles)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "tiles" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _enqueue(entry: str, x, out, variant: str, *args):
    """The library's ``entry`` called with ``args`` and x's current
    stream, on x's device; its error code raised; the launch counted."""
    lib = load_library()
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(
            *args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.moe_gemm_error_string(err).decode()
        raise RuntimeError(f"moe_gemm launch failed: error {err} ({msg})")
    moe_gemm.launches += 1
    moe_gemm.variant_launches[variant] += 1
    return out


def _check_routed(x, w, tiles):
    if _shards.is_dtensor(x) or x.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)}: want a plain [R, d] tensor")
    _check(x[None], w[:1])
    E = w.shape[0]
    if (tiles.dim() != 1 or tiles.shape[0] != E + 1
            or tiles.dtype != torch.int32 or tiles.device != x.device):
        raise ValueError(f"tiles {tuple(tiles.shape)} {tiles.dtype}: want "
                         f"int32 [{E + 1}] on {x.device}")


def moe_gemm_routed(x, w, tiles):
    """x: [R, d], expert e's rows from ``tiles[e] * ROUTE_ROWS`` to
    ``tiles[e + 1] * ROUTE_ROWS`` (``tiles``: [E + 1] int32 on x's device,
    0 first, non-decreasing, its last entry at most R / ``ROUTE_ROWS``);
    w: [E, d, f] -> [R, f] in x's dtype. The rows past the last segment
    are not stored on the card (zeros on the CPU); a padding row inside a
    segment holds its own row's product.

    CPU tensors run :func:`moe_gemm_routed_plain`; CUDA tensors launch
    ``wide`` (bf16) or ``f32``. Checks and refusals as :func:`moe_gemm`;
    a DTensor raises ``ValueError``."""
    _check_routed(x, w, tiles)
    if x.device.type == "cpu":
        return moe_gemm_routed_plain(x, w, tiles)
    return launch_routed(x, w, tiles)


def launch_routed(x, w, tiles):
    """Launch the routed product on CUDA tensors (:func:`moe_gemm_routed`);
    inputs contiguous, x and w 16-byte aligned."""
    _check_routed(x, w, tiles)
    _ready(x, w, tiles)
    (R, d), (E, _, f) = x.shape, w.shape
    variant = "f32" if x.dtype == torch.float32 else "wide"
    out = torch.empty((R, f), dtype=x.dtype, device=x.device)
    return _enqueue("moe_gemm_routed_launch", x, out, variant, x.data_ptr(),
                    w.data_ptr(), out.data_ptr(), tiles.data_ptr(),
                    VARIANTS[variant], E, R, d, f)


def _on_mesh(x, w):
    """K5 on DTensors: each rank multiplies its shard. Per mesh dim, (x,
    w) may be (replicated, replicated), the experts (``Shard(0)``, both),
    x's rows (``Shard(1)``, w replicated), w's columns (x replicated,
    ``Shard(2)``: the out's columns) or the contraction (x ``Shard(2)``, w
    ``Shard(1)``: the out is a partial sum), evenly; anything else raises
    ``ValueError``. On meta tensors (the dry run's DTensor programs) the
    kernel is stood in for by its plain version, on the same shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not _shards.is_dtensor(w) or w.device_mesh != x.device_mesh:
        raise _shards.refuse("moe_gemm", "x and w must be DTensors of one "
                             "mesh", x)
    rules = {(None, None): Replicate(), (0, 0): Shard(0), (1, None): Shard(1),
             (None, 2): Shard(2), (2, 1): Partial()}

    def dim(p):
        return p.dim if isinstance(p, Shard) else (
            None if isinstance(p, Replicate) else "partial")

    out = []
    for px, pw in zip(x.placements, w.placements):
        if (dim(px), dim(pw)) not in rules:
            raise _shards.refuse("moe_gemm", f"placements ({px}, {pw}) on one "
                                 "mesh dim", x, w)
        out.append(rules[dim(px), dim(pw)])
    for t in (x, w):
        _shards.evenly_sharded("moe_gemm", t)
    kernel = moe_gemm_plain if x.is_meta else moe_gemm
    return _shards.on_shards(kernel, tuple(out), x, w)


def reset_counts():
    """Set ``moe_gemm.launches`` and every variant's count to 0."""
    moe_gemm.launches = 0
    moe_gemm.variant_launches = dict.fromkeys(VARIANTS, 0)


reset_counts()
