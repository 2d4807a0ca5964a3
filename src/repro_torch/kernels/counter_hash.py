"""Counter-hash synthesis kernels for the scheduler hot path.

Two kernels written by hand in CUDA C++ (``csrc/counter_hash.cu``), each
with a plain PyTorch version of the same function in this module:

* :func:`piece_window` — the [R, W] sparse-utilisation window (level
  gather + cheap-mixer cell noise + clip); replaces the Pallas kernel
  ``repro/kernels/counter_hash.py::piece_window``.
* :func:`forecast_z` — the [R, W] forecast-error exponent before
  ``exp``; replaces ``repro/kernels/counter_hash.py::forecast_z``.

Both must equal the NumPy reference (:mod:`repro_torch.backend.base`) bit
for bit. The wrappers take tensors: on a CPU tensor they run the plain
version, on a CUDA tensor they launch the kernel or raise — there is no
fallback between the two. Each wrapper counts its kernel launches in
``<wrapper>.launches``.

The plain versions emulate uint64 in int64 (torch has no uint64 add,
shift or multiply on the CPU): add, multiply and xor wrap identically, a
logical right shift is an arithmetic shift masked to the low ``64 - s``
bits, and uint64 constants are reinterpreted as their int64 bits. Every
float32 multiply and add is its own eager op, so nothing is contracted
into an FMA.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use, from
the source in the package, into ``build/repro_torch_kernels/`` at the
repository root, and loaded with ``ctypes`` (a plain C interface: no
PyTorch headers, so the build takes seconds).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "counter_hash.cu"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_U64_MOD = 1 << 64
# np.float32(np.sqrt(12.0)) as an exact Python float
SQRT12_F32 = float(np.float32(np.sqrt(12.0)))


# --------------------------------------------------------------------------
# uint64 arithmetic emulated in int64


def i64(c: int) -> int:
    """A uint64 value (0 <= c < 2**64) as the int64 with the same bits."""
    c = int(c) % _U64_MOD
    return c - _U64_MOD if c >= 1 << 63 else c


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 tensor bits by ``s`` (1 <= s < 64)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


_GOLDEN = i64(0x9E3779B97F4A7C15)
_SM_M1 = i64(0xBF58476D1CE4E5B9)
_SM_M2 = i64(0x94D049BB133111EB)
_MIX_M1 = i64(0xFF51AFD7ED558CCD)
_MIX_M2 = i64(0xC4CEB9FE1A85EC53)


def sm64_t(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over int64-held uint64 bits."""
    x = x + _GOLDEN
    x = (x ^ srl(x, 30)) * _SM_M1
    x = (x ^ srl(x, 27)) * _SM_M2
    return x ^ srl(x, 31)


def cheap_u01_t(h: torch.Tensor) -> torch.Tensor:
    """Two-round multiply–xorshift mixer of ``h`` (the key already xored
    with the fold) → float32 uniform in [0, 1)."""
    h = h * _MIX_M1
    h = h ^ srl(h, 32)
    h = h * _MIX_M2
    h = h ^ srl(h, 29)
    return srl(h, 40).to(torch.float32) * 2.0 ** -24


# --------------------------------------------------------------------------
# plain PyTorch versions


def piece_window_plain(levels, slot, fold, rows, t0, amp) -> torch.Tensor:
    """Plain PyTorch version of :func:`piece_window` (same arguments)."""
    util = torch.gather(levels, 1, slot)
    t = int(t0) + torch.arange(slot.shape[1], dtype=torch.int64,
                               device=slot.device)
    key = (rows[:, None] << 24) ^ t[None, :]
    noise = cheap_u01_t(key ^ i64(fold))
    noise = noise - 0.5
    noise = noise * float(np.float32(amp))
    util = util + noise
    # np.clip's order: max with the floor, then min with the ceiling
    util = torch.where(util > 0.0, util, 0.0)
    return torch.where(util < 1.0, util, 1.0)


def forecast_z_plain(fold, rows, now, std) -> torch.Tensor:
    """Plain PyTorch version of :func:`forecast_z` (same arguments)."""
    fold = i64(fold)
    row_h = sm64_t(rows ^ fold)[:, None]
    leads = torch.arange(1, std.shape[0] + 1, dtype=torch.int64,
                         device=rows.device)
    key = row_h ^ (i64(int(now) << 20) + leads)[None, :]
    z = cheap_u01_t(key ^ fold)
    z = z - 0.5
    z = z * SQRT12_F32
    return z * std[None, :]


# --------------------------------------------------------------------------
# build + bind


_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the shared library of the current source is (to be) built;
    keyed by the source's hash, so an edited source builds anew."""
    tag = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"counter_hash_{tag}.so"


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library. The
    compiler's report (``-Xptxas -v``: registers, spills) is kept beside
    it as ``.log``."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {_SRC}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i64c, u64c = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong
    lib.piece_window_launch.argtypes = [vp, vp, vp, vp, i64c, i64c, i64c, u64c,
                                        i64c, ctypes.c_float, vp]
    lib.piece_window_launch.restype = ctypes.c_int
    lib.forecast_z_launch.argtypes = [vp, vp, vp, i64c, i64c, u64c, u64c, vp]
    lib.forecast_z_launch.restype = ctypes.c_int
    lib.counter_hash_error_string.argtypes = [ctypes.c_int]
    lib.counter_hash_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(lib, err: int, what: str):
    if err != 0:
        msg = lib.counter_hash_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


# --------------------------------------------------------------------------
# wrappers


def piece_window(levels, slot, fold, rows, t0, amp) -> torch.Tensor:
    """[R, W] float32 sparse-utilisation window.

    levels: [R, S] float32 per-slot levels; slot: [R, W] int64 slot of
    each step, each in [0, S); rows: [R] int64 holding the uint64 row
    keys; fold: uint64 scalar; t0: first absolute step; amp: float32
    noise amplitude. CPU tensors run :func:`piece_window_plain`; CUDA
    tensors launch the kernel (all on one device, contiguous)."""
    if levels.device.type == "cpu":
        return piece_window_plain(levels, slot, fold, rows, t0, amp)
    R, S = levels.shape
    W = slot.shape[1]
    dev = levels.device
    _check(levels, "levels", torch.float32, (R, S), dev)
    _check(slot, "slot", torch.int64, (R, W), dev)
    _check(rows, "rows", torch.int64, (R,), dev)
    out = torch.empty((R, W), dtype=torch.float32, device=dev)
    if R * W == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.piece_window_launch(
            levels.data_ptr(), slot.data_ptr(), rows.data_ptr(),
            out.data_ptr(), R, S, W, int(fold) % _U64_MOD, int(t0),
            float(np.float32(amp)), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "piece_window")
    piece_window.launches += 1
    return out


def forecast_z(fold, rows, now, std) -> torch.Tensor:
    """[R, W] float32 forecast-error exponent (before ``exp``).

    rows: [R] int64 holding the uint64 registry rows; std: [W] float32
    per-lead spread; fold/now: uint64 scalars. CPU tensors run
    :func:`forecast_z_plain`; CUDA tensors launch the kernel."""
    if rows.device.type == "cpu":
        return forecast_z_plain(fold, rows, now, std)
    R, W = rows.shape[0], std.shape[0]
    dev = rows.device
    _check(rows, "rows", torch.int64, (R,), dev)
    _check(std, "std", torch.float32, (W,), dev)
    out = torch.empty((R, W), dtype=torch.float32, device=dev)
    if R * W == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.forecast_z_launch(
            rows.data_ptr(), std.data_ptr(), out.data_ptr(), R, W,
            int(fold) % _U64_MOD, int(now) % _U64_MOD,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "forecast_z")
    forecast_z.launches += 1
    return out


piece_window.launches = 0
forecast_z.launches = 0
