"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface (no PyTorch headers, so a
build takes seconds) and becomes its own shared library, compiled for
``sm_90a`` at first use into ``build/repro_torch_kernels/`` at the
repository root (git-ignored). The library's name carries a hash of its
source and of the shared headers (``csrc/*.cuh``, which a source includes
by a relative path), so an edited source or header builds anew. The flags
are ``NVCC_FLAGS``: ``sm_90a`` (``wgmma`` and ``setmaxnreg`` exist only
there), C++17, ``-O3``, a position-independent shared library, and
``-Xptxas -v``; no library is linked beyond the CUDA runtime that
``nvcc`` links by default (libcuda's ``cuTensorMapEncodeTiled`` is
reached through ``cudaGetDriverEntryPoint``). The compiler's report
(``-Xptxas -v``: registers, shared memory, spills) is kept beside it as
``.log``. :func:`build` starts one ``nvcc`` per source that is not built
yet, all at once, and waits for them together. :func:`refuse_grad` is the
check each wrapper of a kernel without a backward makes before it loads
its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def library_path(src: Path) -> Path:
    """Where the shared library of the current ``src`` and headers is (to
    be) built."""
    digest = hashlib.sha1(Path(src).read_bytes())
    for header in sorted(Path(src).parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:12]
    return BUILD_DIR / f"{Path(src).stem}_{tag}.so"


def build(*sources: Path) -> list[Path]:
    """Build every source whose library is missing, with one ``nvcc`` per
    source started together; return the libraries' paths. Raises with the
    compiler's output if any build fails."""
    sos = [library_path(s) for s in sources]
    jobs = []
    for src, so in zip(sources, sos):
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return sos


def load(src: Path) -> ctypes.CDLL:
    """Build ``src`` if needed and load its library."""
    return ctypes.CDLL(str(build(src)[0]))


def all_sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` if autograd would need the gradient of
    ``kernel``'s output: grad mode is on and an input requires grad. The
    kernels write into a fresh tensor with no ``grad_fn``, so training
    through one would silently treat it as a constant. Each wrapper calls
    this for tensors off the CPU, before it loads its library; the plain
    version on CPU tensors is differentiable and never comes here."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an input "
            "requires grad; to train, pass use_kernels=False (the "
            "reference's route), or run under torch.no_grad()")
