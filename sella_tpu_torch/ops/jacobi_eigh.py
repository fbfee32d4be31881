"""Batched small symmetric eigh: the hand-written Hopper Jacobi kernel.

Replaces ``sella_tpu/ops/pallas_eigh.py::_jacobi_kernel`` (driven there by
``jacobi_eigh_tpu``). The kernel source is ``sella_tpu_torch/csrc/
jacobi_eigh.cu``: one thread block per matrix, 8 sweeps of
parallel-order cyclic Jacobi in float32, A in shared memory and, at the
main path's size (n = 71, 72), V in registers. By the card's peaks
it is bound by operations (:func:`kernel_work` counts them); what holds it
in practice is the shared-memory traffic and instruction count of the 568
rounds per (72, 72) matrix, and the note at the top of the source says
what the design does about both. The kernel reads float32 or float64
through the caller's strides and writes the caller's dtype, so device
memory is touched once on the way in and once on the way out.

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
           "build", "pair_schedule", "kernel_work", "occupancy", "MAX_N"]

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
    fn = lib.sella_jacobi_eigh
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = lib.sella_jacobi_eigh_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    _lib = lib
    return lib


def pair_schedule(m: int, r: int):
    """The ``m // 2`` rotation pairs ``(p, q)`` of round ``r`` (``m``
    even), in the order and orientation the kernel applies them.

    Round-robin tournament: slot 0 always holds label 0; the other
    ``m - 1`` labels move one slot to the right each round, so slot
    ``j >= 1`` holds ``1 + (j - 1 - r) mod (m - 1)``. Pair ``i`` is
    (slot ``i``, slot ``m - 1 - i``). This is the plain version's
    interleaved layout read back in original labels: its positions
    ``2i`` and ``2i + 1`` after ``r`` re-pairings."""
    if m < 2 or m % 2:
        raise ValueError(f"pair_schedule needs an even m >= 2, got {m}")

    def player(j):
        return 0 if j == 0 else 1 + (j - 1 - r) % (m - 1)

    return [(player(i), player(m - 1 - i)) for i in range(m // 2)]


def kernel_work(batch: int, n: int, sweeps: int = 8, itemsize: int = 4):
    """Floating-point operations and device-memory bytes of one kernel
    call on ``(batch, n, n)``: ``(flop, bytes_in, bytes_out)``.

    A round rotates every 2x2 block of A from both sides (24 flop each,
    ``(m/2)^2`` blocks) and ``m * m/2`` pairs of V entries (6 flop each);
    there are ``sweeps * (m - 1)`` rounds with ``m`` = ``n`` rounded up to
    even. Bytes count each input entry read once and each output entry
    (eigenvalues and eigenvectors) written once, in the caller's
    ``itemsize``. The angles, the sort and the padding are left out: they
    are below a percent of the rotations."""
    m = n + (n % 2)
    h = m // 2
    rounds = sweeps * (m - 1)
    flop = batch * rounds * (h * h * 24 + m * h * 6)
    bytes_in = batch * n * n * itemsize
    bytes_out = batch * (n * n + n) * itemsize
    return flop, bytes_in, bytes_out


def _check_input(A):
    """Validate what the kernel takes: a CUDA tensor (B, n, n), float32 or
    float64, n <= MAX_N, any strides. Returns ``(B, n)``."""
    if A.device.type != "cuda":
        raise ValueError(f"jacobi_eigh_cuda needs a CUDA tensor, got "
                         f"{A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"jacobi_eigh_cuda needs a float32 or float64 "
                        f"tensor, got {A.dtype}")
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"jacobi_eigh_cuda needs (B, n, n), got "
                         f"{tuple(A.shape)}")
    B, n = A.shape[0], A.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"jacobi_eigh_cuda supports 1 <= n <= {MAX_N}, "
                         f"got n={n}")
    if B >= 2 ** 31:
        raise ValueError(f"jacobi_eigh_cuda supports fewer than 2**31 "
                         f"matrices, got {B}")
    return B, n


def jacobi_eigh_cuda(A: torch.Tensor, sweeps: int = 8):
    """Launch the CUDA kernel on ``A`` (B, n, n), a float32 or float64
    CUDA tensor of any strides with n <= 128. Returns eigenvalues
    ascending (B, n) and eigenvector columns (B, n, n) in A's dtype; the
    solve runs in float32, and the kernel itself reads through the
    strides and converts both ways. Launches on the current stream and
    does not synchronise."""
    B, n = _check_input(A)
    lib = build()
    with torch.cuda.device(A.device):
        w = torch.empty((B, n), dtype=A.dtype, device=A.device)
        V = torch.empty((B, n, n), dtype=A.dtype, device=A.device)
        if B > 0:
            stream = torch.cuda.current_stream(A.device).cuda_stream
            err = lib.sella_jacobi_eigh(
                A.data_ptr(), A.stride(0), A.stride(1), A.stride(2),
                w.data_ptr(), V.data_ptr(), B, n, sweeps,
                int(A.dtype == torch.float64), stream,
            )
            if err != 0:
                raise RuntimeError(
                    f"jacobi_eigh kernel launch failed: cudaError {err}"
                )
            jacobi_eigh_cuda.launches += 1
    return w, V


jacobi_eigh_cuda.launches = 0


def occupancy(n: int, dtype=torch.float32):
    """What a launch of size ``n`` runs with on the current card:
    resident blocks per SM, registers per thread, dynamic shared bytes
    and threads per block (asked of the CUDA runtime)."""
    out = (ctypes.c_int * 4)()
    err = build().sella_jacobi_eigh_occupancy(
        n, int(dtype == torch.float64), out)
    if err != 0:
        raise RuntimeError(f"jacobi_eigh occupancy query: cudaError {err}")
    return {"blocks_per_sm": out[0], "registers": out[1],
            "shared_bytes": out[2], "threads": out[3]}


def jacobi_eigh(A: torch.Tensor, sweeps: int = 8):
    """Batched symmetric eigh (eigenvalues ascending, float32 accuracy,
    A's dtype): the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    if A.device.type == "cuda":
        return jacobi_eigh_cuda(A, sweeps)
    if A.device.type == "cpu":
        return jacobi_eigh_ref(A, sweeps)
    raise ValueError(f"jacobi_eigh: unsupported device {A.device}")
