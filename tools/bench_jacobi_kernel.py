#!/usr/bin/env python3
"""Time the CUDA Jacobi eigh kernel on one GPU and say what it runs with.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/bench_jacobi_kernel.py [--parent-source OLD.cu] [--reps 20]

Prints the card and its power limit, the compiler's resource report
(``-Xptxas -v``), the registers, shared memory, threads and resident
blocks per SM of the compile-time-size kernel (n = 72) and of the
run-time-size one (n = 70 and 74), a check of each against the plain
version, and CUDA-event times (warm, mean of ``--reps`` launches) at
(1024, 72, 72) and (4096, 72, 72): float32 contiguous, float64 contiguous
and float64 through a non-contiguous view, beside the run-time-size kernel
at the neighbouring sizes (B, 70, 70) and (B, 74, 74). With
``--parent-source`` it also builds an earlier revision of the kernel source
that exports ``sella_jacobi_eigh_f32(A, w, V, batch, n, sweeps, stream)``,
compares its output with the current kernel's on the same input, and times
the two in turns (old, new, new, old), so they are compared on one card
within one process. The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from sella_tpu_torch.ops import jacobi_eigh as je  # noqa: E402

cuda_ms = cs._cuda_ms  # CUDA events, warm, mean of reps


def rand_sym(B, n, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn((B, n, n), generator=g, device="cuda", dtype=dtype)
    return A + A.transpose(1, 2)


def build_parent(source: Path):
    """Build an earlier revision of the kernel with the first plain C
    interface (float32, contiguous) and return a callable on a tensor."""
    out = Path(tempfile.mkdtemp(dir=je.BUILD_DIR)) / "parent.so"
    proc = subprocess.run([je._nvcc(), *je.NVCC_FLAGS, "-o", str(out),
                           str(source)], capture_output=True, text=True)
    print(proc.stdout + proc.stderr)
    proc.check_returncode()
    lib = ctypes.CDLL(str(out))
    fn = lib.sella_jacobi_eigh_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(A):
        B, n = A.shape[0], A.shape[-1]
        w = torch.empty((B, n), dtype=torch.float32, device=A.device)
        V = torch.empty((B, n, n), dtype=torch.float32, device=A.device)
        err = fn(A.data_ptr(), w.data_ptr(), V.data_ptr(), B, n, 8,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent kernel: cudaError {err}")
        return w, V

    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_jacobi_kernel: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    je.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    je.build()
    print(je.build_log.strip())
    out = {"card": smi, "torch": torch.__version__}
    for n in (72, 70, 74):
        out[f"launch_n{n}"] = je.occupancy(n, torch.float32)
        print(f"n = {n}:", out[f"launch_n{n}"])

    # each kernel against the plain version before any timing
    for n in (72, 70, 74):
        A_small = rand_sym(64, n, 0, torch.float64)
        w_p, _ = je.jacobi_eigh_ref(A_small)
        for name, A_in in (("f64", A_small), ("f32", A_small.float()),
                           ("f64 transposed view",
                            A_small.transpose(1, 2))):
            w, V = je.jacobi_eigh_cuda(A_in)
            torch.cuda.synchronize()
            err = float((w.double() - w_p).abs().max())
            res = float((A_small @ V.double() - V.double()
                         * w.double()[:, None, :]).abs().max())
            print(f"check n = {n} {name}: |w - w_plain| {err:.3e}, "
                  f"residual {res:.3e}")
            if not (err < 5e-4 and res < 5e-3):
                raise AssertionError(f"kernel disagrees with plain: {name}")

    for B in (1024, 4096):
        A64 = rand_sym(B, 72, 1, torch.float64)
        A32 = A64.float()
        big = rand_sym(B, 75, 2, torch.float64)
        view = big[:, 3:, :72].transpose(1, 2)   # non-contiguous, float64
        cases = {
            "f32": lambda: je.jacobi_eigh_cuda(A32),
            "f64": lambda: je.jacobi_eigh_cuda(A64),
            "f64_view": lambda: je.jacobi_eigh_cuda(view),
        }
        for n in (70, 74):
            An = rand_sym(B, n, 3, torch.float32)
            cases[f"f32_n{n}_run_time_m"] = (
                lambda An=An: je.jacobi_eigh_cuda(An))
        row = {k: cuda_ms(f, args.reps) for k, f in cases.items()}
        b_ms, by = cs._kernel_bound_ms(B, 72, 8, 4)
        row["bound_ms"], row["bound_by"] = b_ms, by
        row["share_of_bound"] = b_ms / row["f32"]
        if args.parent_source is not None:
            if B == 1024:
                parent = build_parent(args.parent_source)
                w_o, V_o = parent(A32)
                w_n, V_n = je.jacobi_eigh_cuda(A32)
                torch.cuda.synchronize()
                row["parent_vs_new"] = {
                    "w_max_abs_diff": float((w_o - w_n).abs().max()),
                    "V_max_abs_diff": float((V_o.abs() - V_n.abs())
                                            .abs().max()),
                    "w_identical": bool(torch.equal(w_o, w_n)),
                }
            turns = []
            for who in ("parent", "new", "new", "parent"):
                f = (lambda: parent(A32)) if who == "parent" \
                    else cases["f32"]
                turns.append((who, cuda_ms(f, args.reps)))
            row["turns"] = turns
            row["parent_f32"] = min(t for w_, t in turns if w_ == "parent")
            row["speedup"] = row["parent_f32"] / min(
                t for w_, t in turns if w_ == "new")
        out[f"B{B}"] = row
        print(f"(B={B}, 72, 72):", json.dumps(row))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
