"""Batched small symmetric eigh: the hand-written Hopper Jacobi kernel.

Replaces ``sella_tpu/ops/pallas_eigh.py::_jacobi_kernel`` (driven there by
``jacobi_eigh_tpu``). The kernel source is ``sella_tpu_torch/csrc/
jacobi_eigh.cu``: one thread block per matrix, A and V in shared memory,
8 sweeps of parallel-order cyclic Jacobi in float32. Its cost on the card
is the latency and shared-memory traffic of about 568 dependent rounds per
(72, 72) matrix, not FLOPs; keeping the whole solve in shared memory means
device memory is touched once on the way in and once on the way out.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, under ``build/`` at the repository
root, and loaded with ``ctypes``.

Dispatch is on the tensor's device: :func:`jacobi_eigh` sends a CPU
tensor to the plain version :func:`jacobi_eigh_ref` and a CUDA tensor to
the kernel. There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .linalg import jacobi_eigh as jacobi_eigh_ref

__all__ = ["jacobi_eigh", "jacobi_eigh_cuda", "jacobi_eigh_ref",
           "build", "MAX_N"]

MAX_N = 128
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "jacobi_eigh.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sella_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
build_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source and flag set) and load it.

    The library name carries a hash of the source and the flags, so a
    changed source never loads a stale build. ``build_log`` keeps the
    compiler's output (``-Xptxas=-v``: registers and shared memory)."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"jacobi_eigh-{tag[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                capture_output=True, text=True,
            )
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{build_log}"
                )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(out))
    fn = lib.sella_jacobi_eigh_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def jacobi_eigh_cuda(A: torch.Tensor, sweeps: int = 8):
    """Launch the CUDA kernel on ``A`` (B, n, n), a contiguous floating
    CUDA tensor with n <= 128. Returns eigenvalues ascending (B, n) and
    eigenvector columns (B, n, n) in A's dtype; the solve runs in
    float32. Launches on the current stream and does not synchronise."""
    if A.device.type != "cuda":
        raise ValueError(f"jacobi_eigh_cuda needs a CUDA tensor, got "
                         f"{A.device}")
    if not A.is_floating_point():
        raise TypeError(f"jacobi_eigh_cuda needs a floating tensor, got "
                        f"{A.dtype}")
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"jacobi_eigh_cuda needs (B, n, n), got "
                         f"{tuple(A.shape)}")
    B, n = A.shape[0], A.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"jacobi_eigh_cuda supports 1 <= n <= {MAX_N}, "
                         f"got n={n}")
    if not A.is_contiguous():
        raise ValueError("jacobi_eigh_cuda needs a contiguous tensor")
    lib = build()
    with torch.cuda.device(A.device):
        Af = A.to(torch.float32)
        w = torch.empty((B, n), dtype=torch.float32, device=A.device)
        V = torch.empty((B, n, n), dtype=torch.float32, device=A.device)
        if B > 0:
            stream = torch.cuda.current_stream(A.device).cuda_stream
            err = lib.sella_jacobi_eigh_f32(
                Af.data_ptr(), w.data_ptr(), V.data_ptr(), B, n, sweeps,
                stream,
            )
            if err != 0:
                raise RuntimeError(
                    f"jacobi_eigh kernel launch failed: cudaError {err}"
                )
            jacobi_eigh_cuda.launches += 1
    return w.to(A.dtype), V.to(A.dtype)


jacobi_eigh_cuda.launches = 0


def jacobi_eigh(A: torch.Tensor, sweeps: int = 8):
    """Batched symmetric eigh (eigenvalues ascending, float32 accuracy,
    A's dtype): the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    if A.device.type == "cuda":
        return jacobi_eigh_cuda(A, sweeps)
    if A.device.type == "cpu":
        return jacobi_eigh_ref(A, sweeps)
    raise ValueError(f"jacobi_eigh: unsupported device {A.device}")
