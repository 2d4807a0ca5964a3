"""K4: the RWKV6 WKV scan (data-dependent-decay linear attention).

A kernel written by hand in CUDA C++ (``csrc/rwkv_scan.cu``), beside a
plain PyTorch version of the same function in this module. It replaces
the Pallas kernel ``repro/kernels/rwkv_scan.py::rwkv_scan`` and computes,
for each (batch, head) stream from a zero state ``S`` [dh, dh]
(key-major),

    out_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ

over r, k, v, w [B, S, H, dh] and u [H, dh], all float32. It returns out
[B, S, H, dh] float32 and, with ``return_state=True``, also the final
state [B, H, dh, dh] float32, as ``repro/models/ssm.py::rwkv_recurrence``
does (the Pallas kernel keeps that state only in its scratch memory).

The wrapper takes tensors: on CPU tensors it runs :func:`rwkv_scan_plain`,
on CUDA tensors it launches the kernel or raises — there is no fallback
between the two. ``rwkv_scan.launches`` counts the kernel's launches. The
kernel runs the recurrence token by token (the TPU kernel's chunked form
divides by the cumulative decay; this one divides by nothing), reads the
inputs through their strides (dh contiguous), and, unlike the reference's
launcher, takes any S >= 1 (no chunk multiple).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_SRC = _build.CSRC / "rwkv_scan.cu"
HEAD_DIMS = (16, 32, 64)


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


_LIB = None


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _build.load(_SRC)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rwkv_scan_launch.argtypes = ([vp] * 7 + [i32] * 4 + [i64] * 12
                                     + [vp])
    lib.rwkv_scan_launch.restype = ctypes.c_int
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
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: want torch.float32")
        if t.device != r.device:
            raise ValueError("r, k, v, w and u must be on one device")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if min(B, S, H) < 1:
        raise ValueError(f"B {B}, S {S}, H {H}: want each >= 1")


def rwkv_scan(r, k, v, w, u, return_state: bool = False):
    """r, k, v, w: float32 [B, S, H, dh], any S >= 1, dh in {16, 32, 64};
    u: float32 [H, dh]. Returns out [B, S, H, dh] float32, and with
    ``return_state`` (out, final state [B, H, dh, dh] float32).

    CPU tensors run :func:`rwkv_scan_plain`; CUDA tensors launch the
    kernel, which reads r, k, v and w through their strides (the head dim
    contiguous). Anything else raises ``ValueError``."""
    _check(r, k, v, w, u)
    if r.device.type == "cpu":
        out, state = rwkv_scan_plain(r, k, v, w, u)
        return (out, state) if return_state else out
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(3) != 1:
            raise ValueError(f"the head dim of {name} must be contiguous")
    B, S, H, dh = r.shape
    u = u.contiguous()
    out = torch.empty((B, S, H, dh), dtype=torch.float32, device=r.device)
    state = (torch.empty((B, H, dh, dh), dtype=torch.float32,
                         device=r.device) if return_state else None)
    lib = load_library()
    with torch.cuda.device(r.device):
        err = lib.rwkv_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(),
            state.data_ptr() if return_state else None, B, S, H, dh,
            r.stride(0), r.stride(1), r.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            w.stride(0), w.stride(1), w.stride(2),
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        msg = lib.rwkv_scan_error_string(err).decode()
        raise RuntimeError(f"rwkv_scan launch failed: CUDA error {err} "
                           f"({msg})")
    rwkv_scan.launches += 1
    return (out, state) if return_state else out


rwkv_scan.launches = 0
