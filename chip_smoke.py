#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sella_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (each prints its wall time; any failure raises and exits non-zero):

1. environment: the card, its power limit, and the build of every kernel
   of the main path from the sources in the checkout;
2. kernel vs plain: the CUDA Jacobi eigh against its plain PyTorch
   version and float64 ``eigvalsh`` on the same card (even, odd and
   largest n, more than two waves of blocks, a non-contiguous float64
   view, phase 16a's n = 6 and 15, repeat launches bit for bit), with
   its timing beside the plain version, ``torch.linalg.eigh`` and the
   card's bound;
3. potential: EMT energy, gradient and HVP on the card against a CPU copy;
4. the slice: the headline ensemble (Cu(111) 3x4x2 slab + adatom, 1024
   lanes, fmax 1e-3) with ``prfo_eigh="jacobi"``, counting kernel launches
   (its final state feeds phase 15);
5. the same headline with the benchmark's own ``prfo_eigh="eigh"``, at
   256 lanes (cut for time);
6. the served EMT headline: 2048 starts (cut from 4096 for time) through
   a 1024-lane work queue (``run_ensemble_queue``, fmax 0.02) with
   ``prfo_eigh="jacobi"``, gated on at least one refill;
7. the LJ4 composite queue: a 1024-lane fast phase with retries and a
   drain handoff, then a 128-lane tail, with the stagnation/dissociation
   restarts and the ``conv_inertia`` gate, and an inertia census of the
   converged saddles (cut to 1024 searches and a tail of one attempt, so
   the tail's growing step budgets never act here; held to the JAX
   package's run of that size);
8. constraints at 1024 lanes: an LJ4 bond pinned at 1.3 as an equality
   (minimization and saddle) and as a ``"gt"`` inequality, 100 steps
   (cut from 200), held to the JAX package's converged counts;
9. checkpoints on the card: a live queue state saved and loaded bit for
   bit, and a queue resumed from its first cycle's checkpoint;
10. the atom+cell tier: the bench's config 3 (bulk Cu EMT 2x2x2, 32
    atoms + 9 cell DOF, 512 lanes, fmax 1e-3) held to BENCH_r04.json's
    counts and the EMT lattice constant, with the prep eigh's share of a
    step; then ``run_cell_ensemble(niggli=True)`` on skewed lattices and
    ``run_cell_ensemble_queue`` on 128 inputs (cut from 256 for time),
    64 lanes each;
11. the precision split: ``F32Potential(EMT)`` against float64 EMT on
    the card (agreement and the f64/f32 time ratio of the batched eval
    and HVP), and the 453-DOF emt151 config in both precisions (cut to
    a 60-step cap), the float32 run held to the float64 run's counts;
12. the internal-coordinate tier: (a) the bench's Morse Xe4 config at
    1024 lanes and 40 steps with the chord back-transform, with the
    Gram eigh's, the Newton back-transform's and Davidson's shares of
    the step; (b) the ``"robust"`` float64 eigh of its 1024 Gram
    matrices (zero cluster of multiplicity 5); (c) the repave of
    near-linear lanes at 256 lanes and the dummy-atom and fixed-bond
    configs at 1024 lanes; (d) the served internal queue with the
    Cartesian spill, a checkpoint and a resume (256 inputs through 128
    lanes, cut from 512 for time, gated on at least one refill). 12a,
    12c and 12d are held to the JAX package's runs at the same sizes;
13. the large-system path: (a) the bench's largescale block at 10,000
    atoms (a Cu(111) 50x50x4 slab): matrix-free MMF through binned and
    row-chunked LJ (order 0, held to each other), ``BinnedEMT`` (order
    0, held to the CPU, and chunked against unchunked) and the
    committed MLFF behind ``F32Potential`` (order 1, held to float64),
    each with s/step, force and HVP times, HVPs and host syncs per step,
    peak memory and no bin overflow; (b) an LJ7 saddle, a Cu slab and a
    1024-atom binned-EMT minimization held to the JAX package's counts
    and energies;
14. the internal+cell tier: (a) phase 10's bulk Cu EMT system in 192
    redundant bonds + 9 cell parameters (nz = 201), order 0, fmax 1e-3,
    at 8 lanes (cut from 64 for time) until every lane converges, with
    the Gram eigh's, the Newton back-transform's and the restricted
    step's CUDA-event times and the Newton iterations and host syncs a
    step; (b) ``run_cell_internal_ensemble`` with its Niggli rebase and
    its repave, ``run_cell_internal_ensemble_queue`` and one
    ``rigid_fragments=True`` run on the configs of the JAX package's
    tests, at step caps; all held to the JAX package's runs;
15. batched IRC: (a) both directions from the first 128 converged
    transition states of phase 4 (256 paths through a 256-lane queue,
    Cu masses), every endpoint a minimum below its TS, the first 8 TSs'
    paths run again on the CPU; (b) the IRC stage of
    examples/04_irc_pipeline.py from the JAX run's transition states,
    held to the JAX package's counts and energies;
16. the heterogeneous queue: (a) 256 LJ4 + 256 LJ7 starts drawn as
    examples/09_heterogeneous_sweep.py draws them through 128-lane
    queues (cut from 512 + 512 through 256 lanes for time), order 0,
    with ``prfo_eigh="jacobi"`` (the kernel at n = 6 and 15), held per
    bucket to the JAX package's run and gated on a refill in each
    bucket; (b) the example's internal campaign, every result equal to
    its bucket's direct ``run_internal_ensemble_queue``.

Phases 13, 14, 15 and 16 and phases 1-16 together are gated on their
budgets in seconds.

The JAX package's numbers for phases 7, 8, 12, 13b, 14, 15b and 16a come
from ``tools/jax_reference_counts.py`` (run on a CPU; the card's host has
no JAX); phases 10-13 print the JAX package's TPU figures beside their
own. The last seven lines of standard output are the kernels' JSON
record, the large-system summary, the batched-tier summary (14a, 15a and
16a beside the JAX package's counts, and the gated phases' times beside
their budgets), the LJ4 summary, the card's name and power limit, and ``{"ok":
true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# device-independent counts of the JAX package's headline run at fmax 1e-3
# (BENCH_r05.json, extra.emt_fmax_1e-3)
BENCH_R05_COUNTS = {"mean_steps_converged": 27.2, "mean_matvecs": 42.7,
                    "mean_force_calls": 28.2}
# eigenvalue gate (relative to the spectral radius), residual and
# orthonormality gates: tests/test_pallas_eigh.py:65-109
EIG_RTOL = 5e-5
RES_TOL = 5e-4
# EMT on the card vs on the CPU, float64: only summation order differs
POT_RTOL = 1e-10
CONV_FRAC_MIN = 0.99
MAX_STEPS = 120
# the jacobi headline's counts on this card with the first version of the
# kernel (1024 lanes, seed 0); a change to the kernel moves them by
# float32 rounding carried through 35 steps, and by no more than this
JACOBI_COUNTS = {"mean_steps_converged": 27.1416, "mean_matvecs": 42.6855,
                 "mean_force_calls": 28.1416}
COUNTS_RTOL = 5e-3
# device-independent counts of the JAX package's full-size LJ4 composite
# queue (BENCH_r05.json, extra.lj4: total 4096, 4 tail retries, tail
# budgets capped at 600 steps), printed beside the port's cut run
LJ4_COUNTS = {"mean_steps_converged": 105.1, "mean_matvecs": 109.9,
              "mean_force_calls": 108.6}
# the LJ4 composite's sizes here: total cut from 4096 and tail retries
# from 4 to 0 to fit the script's time (PERF.md section 4): a search that
# never converges runs its whole retry chain in series. With no tail
# retry the step-budget growth (retry_step_growth, retry_step_cap) never
# acts on the card; tests/test_torch_queue.py holds it to the JAX package
LJ4_SIZE = {"total": 1024, "batch": 1024, "tail_batch": 128,
            "max_steps": 150, "max_retries": 0, "retry_step_cap": 600}
# steps of each phase-8 run (the tests run 200; cut for time)
CONSTRAINT_MAX_STEPS = 100
# the JAX package on the phase-7 and phase-8 configurations, each beside
# the sizes it was computed at (tools/jax_reference_counts.py prints both
# dicts, on a CPU; the card's host has no JAX). A run at other sizes
# raises rather than compare with a stale reference. The kick and
# Davidson draws come from other generators, so only statistics can
# match: the counts within LJ4_COUNTS_RTOL, and a converged share within
# three standard deviations of the difference of two independent runs
# (sqrt(2 p (1 - p) / n); 1024 searches: 0.04 at p = 0.91, 55 lanes at
# p = 0.79)
JAX_LJ4_REF = {"size": {"total": 1024, "batch": 1024, "tail_batch": 128,
                        "max_steps": 150, "max_retries": 0,
                        "retry_step_cap": 600},
               "converged_frac": 0.9141, "mean_steps_converged": 57.4,
               "mean_matvecs": 92.4, "mean_force_calls": 83.5}
LJ4_COUNTS_RTOL = 0.10
LJ4_CONV_ATOL = 0.04
JAX_CONSTRAINT_REF = {
    "size": {"batch": 1024, "max_steps": 100},
    "eq_min": {"converged": 1024, "mean_steps_converged": 15.4013671875},
    "gt_min": {"converged": 968, "mean_steps_converged": 39.450413223140494},
    "eq_saddle": {"converged": 811,
                  "mean_steps_converged": 43.519112207151665}}
# lanes the port may differ from the JAX package's converged count: on a
# run without Davidson float64 on the card vs LAPACK on the CPU can tip a
# lane that converges at the last step; the saddle draws its Davidson
# probes from another generator (three standard deviations, as above)
CONSTRAINT_LANES_ATOL = {"eq_min": 5, "gt_min": 5, "eq_saddle": 55}
# at most this share of converged LJ4 saddles may have another count than
# one of exact-Hessian eigenvalues below -1e-3 (the audit checks only the
# leftmost mode, so the JAX package does not promise 0 either)
INERTIA_BAD_MAX = 0.01
# the eigh headline (phase 5) runs at this batch, cut from 1024 for time
EIGH_HEADLINE_BATCH = 256
# the served EMT headline (phase 6) streams this many starts, cut from the
# bench's 4096 so that phase 12 fits the script's time
SERVED_TOTAL = 2048
# the bench's atom+cell config (bench.py:1067-1130, BASELINE config 3) at
# its full width: its device-independent counts from the JAX package's run
# (BENCH_r04.json, "cell" block; 100% converged, every lane by step 40)
CELL_BATCH = 512
CELL_MAX_STEPS = 250
BENCH_R04_CELL = {"mean_steps_converged": 34.8, "mean_force_calls": 35.8}
CELL_COUNTS_RTOL = 0.05
# the EMT equilibrium lattice constant the relaxed 2x2x2 supercells
# recover (tests/test_ensemble_cell.py:56-62)
CELL_LATTICE_A = 3.593
# the two other atom+cell entry points, on the card (phase 10b)
CELL_ENTRY_SIZE = {"niggli_batch": 64, "queue_batch": 64,
                   "queue_total": 128}
# emt151 (bench.py:249-290, 380-395; the bench runs 32 lanes, 120 steps)
# in float64 and behind F32Potential (bench.py:422-427); the JAX
# package's counts on the TPU (BENCH_r05.json), printed, not gated
EMT151_SIZE = {"batch": 32, "max_steps": 60}
BENCH_R05_EMT151 = {
    "f64": {"mean_steps_converged": 32.1, "mean_matvecs": 32.3,
            "mean_force_calls": 33.1},
    "f32": {"mean_steps_converged": 31.8, "mean_matvecs": 32.3,
            "mean_force_calls": 32.8}}
F32_COUNTS_RTOL = 0.05
# published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside
# the tensor cores, and device memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _sync_for(dev):
    return (torch.cuda.synchronize if torch.device(dev).type == "cuda"
            else (lambda: None))


class _Refills:
    """Counts, by lane width, the refills a work queue makes while in
    the ``with`` block (a queue refills only when a lane reloads a fresh
    input), by wrapping ``module.name``; ``require(what)`` raises unless
    every width refilled at least once."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.by_dim: dict = {}

    def __enter__(self):
        inner = self.inner = getattr(self.module, self.name)

        def counted(state, *a, **k):
            d = int(state.x.shape[1])
            self.by_dim[d] = self.by_dim.get(d, 0) + 1
            return inner(state, *a, **k)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)

    def require(self, what, dims=None):
        for d in (dims if dims is not None else [None]):
            n = (sum(self.by_dim.values()) if d is None
                 else self.by_dim.get(d, 0))
            if n == 0:
                where = "" if d is None else f" (dim {d})"
                raise AssertionError(f"{what}: the queue never refilled a "
                                     f"lane{where}")


def headline_setup(batch, seed=0):
    """The bench headline system (bench.py:225-246): Cu(111) 3x4x2 slab
    plus one adatom nudged off the fcc hollow, 25 atoms; ``batch`` starts
    jittered by 0.02 A from ``np.random.RandomState(seed)``."""
    from sella_tpu_torch.potentials import EMT, fcc111_slab

    a = 3.59
    slab = fcc111_slab("Cu", a, size=(3, 4, 2))
    d = a / np.sqrt(2)
    top_z = slab.positions[:, 2].max()
    base = slab.positions[slab.positions[:, 2] > top_z - 0.1][0]
    ad = base + np.array(
        [d / 2 + 0.3, d / (2 * np.sqrt(3)) + 0.1, a / np.sqrt(3)]
    )
    pos0 = np.vstack([slab.positions, ad])
    nat = len(pos0)
    pot = EMT(np.array([29] * nat), pbc=True)
    rng = np.random.RandomState(seed)
    x0 = np.stack([
        (pos0 + 0.02 * rng.normal(size=pos0.shape)).ravel()
        for _ in range(batch)
    ])
    return pot, x0, np.asarray(slab.cell), nat


def headline_config(nat, batch, prfo_eigh):
    """The bench headline EnsembleConfig (bench.py:356-363) at fmax 1e-3."""
    from sella_tpu_torch import EnsembleConfig

    return EnsembleConfig(
        natoms=nat, order=1, nproj=3, fmax=1e-3, gamma=0.3,
        davidson_max=25, delta0=5e-3,
        diag_budget=max(batch // 8, 1), eigh_f32=True,
        rs_maxiter=12, absb="ns",
        eval_chunk=256 if batch >= 1024 else 0,
        davidson_seed="grad", prfo_eigh=prfo_eigh,
    )


def _rand_sym(B, n, seed):
    rng = np.random.RandomState(seed)
    A = rng.normal(size=(B, n, n))
    return A + np.swapaxes(A, 1, 2)


def _spread_spectrum(seed, d, neg):
    """Eigenvalues spanning 1e-4..30 with ``neg`` negatives
    (tests/test_pallas_eigh.py:25-34)."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    lam = np.concatenate([
        -(10.0 ** rng.uniform(-4, 1.5, neg)),
        10.0 ** rng.uniform(-4, 1.5, d - neg),
    ])
    return (Q * lam) @ Q.T


def _cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the card (CUDA events, warm)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_env():
    from sella_tpu_torch.ops import jacobi_eigh as je

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}, "
          f"capability {torch.cuda.get_device_capability(0)}")
    print(_card(), flush=True)
    t = time.perf_counter()
    je.build()
    print(f"jacobi_eigh build: {time.perf_counter() - t:.2f} s")
    if je.build_log.strip():
        print(je.build_log.strip())


def _kernel_bound_ms(batch, n, sweeps, itemsize):
    """Least time the card could take for one kernel call: the larger of
    operations over the float32 peak and bytes over the memory rate."""
    from sella_tpu_torch.ops.jacobi_eigh import kernel_work

    flop, b_in, b_out = kernel_work(batch, n, sweeps, itemsize)
    t_ops = flop / PEAK_F32_FLOPS * 1e3
    t_bytes = (b_in + b_out) / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_kernel():
    """Kernel vs plain version vs float64 eigvalsh, on the card."""
    from sella_tpu_torch.ops.jacobi_eigh import jacobi_eigh_cuda, \
        jacobi_eigh_ref, occupancy

    dev = torch.device("cuda", 0)
    cases = {
        "rand_1024x72": _rand_sym(1024, 72, 0),
        "rand_8x20": _rand_sym(8, 20, 1),
        "odd_4x9": _rand_sym(4, 9, 3),
        "hard_3x72": np.stack([_spread_spectrum(s, 72, 3)
                               for s in range(3)]),
        "odd_64x71": _rand_sym(64, 71, 4),
        "max_8x128": _rand_sym(8, 128, 5),
        "waves_1500x72": _rand_sym(1500, 72, 6),
        # what the step hands the kernel: float64 through strides
        "view_16x72": _rand_sym(16, 80, 7),
        # what phase 16a's buckets hand it: the LJ4 and LJ7 free
        # subspaces (n = 3 * natoms - 6) at the queue's lanes
        f"hetero_{HETERO_SIZE['batch']}x6": _rand_sym(
            HETERO_SIZE["batch"], 6, 9),
        f"hetero_{HETERO_SIZE['batch']}x15": _rand_sym(
            HETERO_SIZE["batch"], 15, 10),
    }
    max_abs_err = 0.0
    for name, A_np in cases.items():
        A = torch.as_tensor(A_np, device=dev)
        if name.startswith("view"):
            A = A[:, 5:77, 5:77].transpose(1, 2)
            if A.is_contiguous():
                raise AssertionError("the view case must not be contiguous")
        w_k, V_k = jacobi_eigh_cuda(A)
        w_2, V_2 = jacobi_eigh_cuda(A)
        w_p, V_p = jacobi_eigh_ref(A)
        w_ref = torch.linalg.eigvalsh(A)
        torch.cuda.synchronize()
        if not (torch.equal(w_k, w_2) and torch.equal(V_k, V_2)):
            raise AssertionError(f"two launches on {name} differ")
        if w_k.dtype != A.dtype or V_k.dtype != A.dtype:
            raise AssertionError(f"{name}: output dtype {w_k.dtype}")
        scale = float(w_ref.abs().max())
        err_ref = float((w_k - w_ref).abs().max()) / scale
        err_plain = float((w_k - w_p).abs().max())
        res = torch.linalg.norm(A @ V_k - V_k * w_k[:, None, :],
                                dim=(1, 2)) / torch.linalg.norm(A, dim=(1, 2))
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=dev)
        orth = float((V_k.transpose(1, 2) @ V_k - eye).abs().max())
        print(f"  {name}: eig rel err vs eigvalsh {err_ref:.3e}, "
              f"|w_kernel - w_plain| {err_plain:.3e}, "
              f"residual {float(res.max()):.3e}, orth {orth:.3e}, "
              f"repeat launch identical")
        if not (err_ref < EIG_RTOL and err_plain / scale < EIG_RTOL
                and float(res.max()) < RES_TOL and orth < RES_TOL):
            raise AssertionError(f"jacobi_eigh kernel fails its gates on "
                                 f"{name}")
        if name.startswith("hard"):
            nneg = (w_k < 0).sum(dim=1)
            if not bool((nneg == 3).all()):
                raise AssertionError(f"negative count {nneg.tolist()} != 3")
        max_abs_err = max(max_abs_err, err_plain)

    # timing at the main path's shape and dtype (float64 in and out; the
    # solve is float32), beside the plain version on the same input and
    # the one library call that computes the same function in float32
    A = torch.as_tensor(cases["rand_1024x72"], device=dev)
    A32 = A.float()
    ms = _cuda_ms(lambda: jacobi_eigh_cuda(A), 20)
    ms_f32 = _cuda_ms(lambda: jacobi_eigh_cuda(A32), 20)
    plain_ms = _cuda_ms(lambda: jacobi_eigh_ref(A), 2)
    library_ms = _cuda_ms(lambda: torch.linalg.eigh(A32), 2)
    A4 = torch.as_tensor(_rand_sym(4096, 72, 8), device=dev)
    ms_4096 = _cuda_ms(lambda: jacobi_eigh_cuda(A4), 20)
    bound_ms, bound_by = _kernel_bound_ms(1024, 72, 8, A.element_size())
    print(f"  launch of n = 72: {occupancy(72, A.dtype)}")
    print(f"  (1024, 72, 72): kernel {ms:.3f} ms (float32 input "
          f"{ms_f32:.3f} ms), plain {plain_ms:.3f} ms, torch.linalg.eigh "
          f"float32 {library_ms:.3f} ms, bound {bound_ms:.3f} ms by "
          f"{bound_by} ({bound_ms / ms:.3f} of the kernel's time)")
    print(f"  (4096, 72, 72): kernel {ms_4096:.3f} ms")
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ms_f32_input": ms_f32,
            "ms_4096": ms_4096}


def phase_potential():
    """EMT energy, gradient and HVP of 4 headline lanes: card vs CPU.

    Each device is evaluated twice and the second results are compared.
    In one run on an H100 host (torch 2.11) the first vmapped CPU
    gradient of the process came out 4.5e-10 relative away from every
    later call, which agreed with the card to 1e-14; other runs showed
    no such difference. The first-call difference is printed, not
    gated."""
    from sella_tpu_torch.parallel.ensemble import _batched_eval, \
        _batched_hvp_full

    pot, x0, cell, _ = headline_setup(4)
    v = np.random.RandomState(1).normal(size=x0.shape)
    out = {}
    for dev in ("cpu", "cuda:0"):
        p = pot.to(dev)
        c = torch.as_tensor(cell, device=dev)
        x = torch.as_tensor(x0, device=dev)
        vt = torch.as_tensor(v, device=dev)
        runs = []
        for _ in range(2):
            f, g = _batched_eval(p, c)(x)
            hv = _batched_hvp_full(p, c)(x, vt)
            runs.append([t.cpu() for t in (f, g, hv)])
        first = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(*runs))
        print(f"  {dev}: first call vs second, max rel diff {first:.3e}")
        out[dev] = runs[1]
    for name, a, b in zip(("energy", "gradient", "hvp"), out["cpu"],
                          out["cuda:0"]):
        rel = float((a - b).abs().max() / a.abs().max())
        print(f"  {name}: max rel diff card vs cpu {rel:.3e}")
        if not (torch.isfinite(b).all() and rel < POT_RTOL):
            raise AssertionError(f"EMT {name} on the card disagrees")


def run_headline(prfo_eigh, dev="cuda:0", batch=1024, keep_state=False):
    """The headline ensemble on ``dev``; returns its stats (and with
    ``keep_state`` its final state too)."""
    from sella_tpu_torch import run_ensemble
    from sella_tpu_torch.ops.jacobi_eigh import jacobi_eigh_cuda
    from sella_tpu_torch.parallel.ensemble import _batched_eval, free_basis

    dev = torch.device(dev)
    pot, x0, cell, nat = headline_setup(batch)
    cfg = headline_config(nat, batch, prfo_eigh)
    pot = pot.to(dev)
    cell_t = torch.as_tensor(cell, device=dev)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    jacobi_eigh_cuda.launches = 0
    t = time.perf_counter()
    # a numpy x0: the entry point places the search on ``dev`` itself
    state = run_ensemble(pot, x0, cfg, max_steps=MAX_STEPS, cell=cell_t,
                         device=dev)
    sync()
    wall = time.perf_counter() - t
    launches = jacobi_eigh_cuda.launches

    for name, tns in zip(state._fields, state):
        if tns.device != dev:
            raise AssertionError(f"state.{name} is on {tns.device}")
        if tns.is_floating_point() and not bool(torch.isfinite(tns).all()) \
                and name != "best_fmax":
            raise AssertionError(f"state.{name} has non-finite values")
    if tuple(state.x.shape) != (batch, 3 * nat):
        raise AssertionError(f"state.x has shape {tuple(state.x.shape)}")

    conv = state.converged
    nconv = int(conv.sum())
    steps_run = int(state.nsteps.max())
    # the repo's own convergence criterion, recomputed at the final
    # geometry: max projected per-atom force below fmax
    _, g = _batched_eval(pot, cell_t, cfg.eval_chunk)(state.x)
    U = free_basis(state.x, cfg.nproj)
    gp = U @ (U.transpose(1, 2) @ g[:, :, None])
    fmax = gp[:, :, 0].reshape(batch, nat, 3).norm(dim=2).amax(dim=1)
    bad = conv & ~(fmax < cfg.fmax)
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} converged lanes have fmax "
                             f">= {cfg.fmax} at their final geometry")
    stats = {
        "prfo_eigh": prfo_eigh,
        "batch": batch,
        "converged_frac": nconv / batch,
        "steps_run": steps_run,
        "mean_steps_converged": (
            float(state.nsteps[conv].double().mean()) if nconv else None),
        "mean_matvecs": float(state.nmatvec.double().mean()),
        "mean_force_calls": float(state.neval.double().mean()),
        "wall_s": wall,
        "s_per_step": wall / max(steps_run, 1),
        "jacobi_eigh_launches": launches,
    }
    print(json.dumps(stats), flush=True)
    if stats["converged_frac"] < CONV_FRAC_MIN:
        raise AssertionError(f"converged_frac {stats['converged_frac']} < "
                             f"{CONV_FRAC_MIN}")
    return (stats, state) if keep_state else stats


class _SnapshotClock:
    """Wraps a queue's ``snapshot`` to time each harvest's device-to-host
    copy (after a synchronize, so the step chunk's queued work is not
    counted) and to keep, on the device, the largest restart count seen
    in each cycle."""

    def __init__(self, snapshot):
        self.snapshot = snapshot
        self.seconds = []
        self.restarts = []

    def __call__(self, state):
        self.restarts.append(state.nrestarts.amax())
        if state.x.is_cuda:
            torch.cuda.synchronize(state.x.device)
        t = time.perf_counter()
        buf = self.snapshot(state)
        self.seconds.append(time.perf_counter() - t)
        return buf

    def stats(self):
        return {"harvest_cycles": len(self.seconds),
                "snapshot_ms_mean": (1e3 * float(np.mean(self.seconds))
                                     if self.seconds else None)}

    def max_restarts(self):
        return int(torch.stack(self.restarts).max()) if self.restarts else 0


def _clocked(fns):
    step, refill, refresh, snapshot = fns
    clock = _SnapshotClock(snapshot)
    return (step, refill, refresh, clock), clock


def _fmax_at(pot, cell_t, xs, nproj, natoms):
    """The repo's convergence criterion, recomputed at ``xs``: the max
    per-atom norm of the gradient projected on the free basis."""
    from sella_tpu_torch.parallel.ensemble import _batched_eval, free_basis

    _, g = _batched_eval(pot, cell_t)(xs)
    U = free_basis(xs, nproj)
    gp = U @ (U.transpose(1, 2) @ g[:, :, None])
    return gp[:, :, 0].reshape(len(xs), natoms, 3).norm(dim=2).amax(dim=1)


def _queue_means(results):
    conv = [r for r in results if r[3]]
    return {
        "converged_frac": len(conv) / len(results),
        "mean_steps_converged": (float(np.mean([r[2] for r in conv]))
                                 if conv else None),
        "mean_matvecs": float(np.mean([r[4] for r in results])),
        "mean_force_calls": float(np.mean([r[5] for r in results])),
    }


def run_queue_headline(dev="cuda:0", batch=1024, total=4096):
    """The served EMT headline (bench.py ``--headline queue``,
    bench.py:726-742 and ``_run_queue_common``): ``total`` fresh starts
    (rows batch..batch+total of the bench's start set) through a
    ``batch``-lane queue at fmax 0.02, harvested every 5 steps, with
    ``prfo_eigh="jacobi"`` (the bench's is ``"eigh"``) so that the kernel
    serves the queue; gated on at least one refill."""
    import sella_tpu_torch.parallel.ensemble as ens
    from sella_tpu_torch import EnsembleConfig, make_queue_fns, \
        run_ensemble_queue
    from sella_tpu_torch.ops.jacobi_eigh import jacobi_eigh_cuda

    dev = torch.device(dev)
    pot, x0_all, cell, nat = headline_setup(total + batch)
    pot = pot.to(dev)
    cell_t = torch.as_tensor(cell, device=dev)
    cfg = EnsembleConfig(
        natoms=nat, order=1, nproj=3, fmax=0.02, gamma=0.3,
        davidson_max=15, delta0=5e-3, diag_budget=max(batch // 8, 1),
        eigh_f32=True, rs_maxiter=12, absb="ns",
        eval_chunk=256 if batch >= 1024 else 0, prfo_eigh="jacobi",
    )
    fns, clock = _clocked(make_queue_fns(pot, cfg, cell_t, refill_every=5))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    jacobi_eigh_cuda.launches = 0
    t = time.perf_counter()
    with _Refills(ens, "refill_converged") as refills:
        results = run_ensemble_queue(
            pot, x0_all[batch:], cfg, batch, max_steps_per_search=80,
            cell=cell_t, refill_every=5, fns=fns, device=dev)
    sync()
    wall = time.perf_counter() - t
    launches = jacobi_eigh_cuda.launches

    if len(results) != total:
        raise AssertionError(f"{len(results)} results for {total} inputs")
    stats = {"batch": batch, "total": total, "prfo_eigh": cfg.prfo_eigh,
             **_queue_means(results), "wall_s": wall,
             "searches_per_s": sum(r[3] for r in results) / wall,
             **clock.stats(), "refills": sum(refills.by_dim.values()),
             "jacobi_eigh_launches": launches}
    conv = [r for r in results if r[3]]
    if conv:
        xs = torch.as_tensor(np.stack([r[0] for r in conv]), device=dev)
        fmax = _fmax_at(pot, cell_t, xs, cfg.nproj, nat)
        stats["fmax_max_converged"] = float(fmax.max())
        if not bool((fmax < cfg.fmax).all()):
            raise AssertionError(f"{int((fmax >= cfg.fmax).sum())} converged "
                                 f"results have fmax >= {cfg.fmax}")
    print(json.dumps(stats), flush=True)
    if stats["converged_frac"] < CONV_FRAC_MIN:
        raise AssertionError(f"served headline converged_frac "
                             f"{stats['converged_frac']} < {CONV_FRAC_MIN}")
    if dev.type == "cuda" and launches == 0:
        raise AssertionError("the served headline never launched the kernel")
    refills.require("the served headline")
    return stats


LJ4_TET = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                    [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * 1.12


def lj4_starts(n, seed=0, jitter=0.1):
    """LJ4 tetrahedra jittered from ``np.random.RandomState(seed)``
    (``bench._lj4_starts`` with the defaults)."""
    rng = np.random.RandomState(seed)
    return (LJ4_TET[None] + jitter * rng.normal(size=(n, 4, 3))).reshape(
        n, 12)


def inertia_census(pot, xs, cell_t, nproj=6, thresh=-1e-3):
    """Per geometry, the count of eigenvalues below ``thresh`` of the
    exact Hessian projected on the free basis."""
    from torch.func import hessian, vmap

    from sella_tpu_torch.parallel.ensemble import free_basis

    H = vmap(hessian(lambda x: pot.energy(x, cell_t)))(xs)
    U = free_basis(xs, nproj)
    w = torch.linalg.eigvalsh(U.transpose(1, 2) @ H @ U)
    return (w < thresh).sum(dim=1)


def run_lj4_composite(dev="cuda:0", total=4096, batch=1024, tail_batch=128,
                      max_steps=150, max_retries=4, retry_step_cap=600):
    """The LJ4 composite queue of ``bench.run_lj4_queue`` (bench.py:792-949):
    a ``batch``-lane fast phase (2 kick retries, drain handoff of the last
    ``tail_batch`` stragglers), then a ``tail_batch``-lane tail re-running
    the handed-off searches, with ``max_retries`` kick retries on step
    budgets that grow up to ``retry_step_cap``; every search's cost is
    summed over both phases. The gates hold the run to ``JAX_LJ4_REF``,
    and raise unless it was computed at these sizes."""
    from sella_tpu_torch import EnsembleConfig, LennardJones, \
        make_queue_fns, run_ensemble_queue

    dev = torch.device(dev)
    pot = LennardJones()
    cell_t = torch.zeros((3, 3), dtype=torch.float64, device=dev)
    x0_all = lj4_starts(total + batch)
    cfg = EnsembleConfig(
        natoms=4, order=1, fmax=1e-3, gamma=1e-3,
        diag_budget=max(batch // 8, 1), restart_after=30,
        conv_inertia=True, dmax_restart=3.5,
    )
    fns, clock = _clocked(make_queue_fns(pot, cfg, refill_every=10))
    x0_work = x0_all[batch:]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fast = run_ensemble_queue(
        pot, x0_work, cfg, batch, max_steps_per_search=max_steps,
        refill_every=10, fns=fns, max_retries=2, retry_kick=0.15,
        drain_handoff=tail_batch, device=dev)
    t_fast = time.perf_counter() - t0
    unconv = [i for i, r in enumerate(fast) if not r[3]]
    tail = []
    if unconv:
        # pad to tail_batch with starts of converged searches (results
        # discarded), cycling the tail inputs if those run short
        pad = []
        if len(unconv) < tail_batch:
            us = set(unconv)
            pad = [i for i in range(total) if i not in us][
                : tail_batch - len(unconv)]
            k = 0
            while len(unconv) + len(pad) < tail_batch:
                pad.append(unconv[k % len(unconv)])
                k += 1
        tail = run_ensemble_queue(
            pot, x0_work[np.asarray(unconv + pad)], cfg, tail_batch,
            max_steps_per_search=max_steps, refill_every=10, fns=fns,
            max_retries=max_retries, retry_kick=0.15, retry_step_growth=1.0,
            retry_step_cap=retry_step_cap, device=dev)
    sync()
    elapsed = time.perf_counter() - t0

    # composite accounting (bench.py:909-937): a tail search's cost is
    # its fast-phase cost plus every tail attempt
    tot_steps = np.array([r[2] for r in fast], dtype=float)
    tot_mv = np.array([r[4] for r in fast], dtype=float)
    tot_ev = np.array([r[5] for r in fast], dtype=float)
    conv = np.array([r[3] for r in fast], dtype=bool)
    xs = np.stack([r[0] for r in fast])
    for j, i in enumerate(unconv):
        tot_steps[i] += tail[j][2]
        tot_mv[i] += tail[j][4]
        tot_ev[i] += tail[j][5]
        conv[i] = tail[j][3]
        xs[i] = tail[j][0]
    nconv = int(conv.sum())
    stats = {
        "total": total, "batch": batch, "tail_batch": tail_batch,
        "max_retries": max_retries, "retry_step_cap": retry_step_cap,
        "converged_frac": nconv / total,
        "mean_steps_converged": (float(tot_steps[conv].mean())
                                 if nconv else None),
        "mean_matvecs": float(tot_mv.mean()),
        "mean_force_calls": float(tot_ev.mean()),
        "wall_s": elapsed, "fast_wall_s": t_fast,
        "tail_wall_s": elapsed - t_fast, "handed_off": len(unconv),
        "searches_per_s": nconv / elapsed,
        "max_nrestarts": clock.max_restarts(), **clock.stats(),
    }
    if nconv:
        xc = torch.as_tensor(xs[conv], device=dev)
        fmax = _fmax_at(pot, cell_t, xc, 6, 4)
        stats["fmax_max_converged"] = float(fmax.max())
        counts = inertia_census(pot, xc, cell_t)
        hist = torch.bincount(counts.cpu(), minlength=4).tolist()
        stats["inertia_census"] = {str(k): n for k, n in enumerate(hist)
                                   if n}
        stats["inertia_not_one_frac"] = float((counts != 1).double().mean())
    print(json.dumps(stats), flush=True)
    ref = JAX_LJ4_REF
    size = dict(total=total, batch=batch, tail_batch=tail_batch,
                max_steps=max_steps, max_retries=max_retries,
                retry_step_cap=retry_step_cap)
    if size != ref["size"]:
        raise AssertionError(f"JAX_LJ4_REF was computed at {ref['size']}, "
                             f"not at {size}: rerun "
                             "tools/jax_reference_counts.py")
    if stats["converged_frac"] < ref["converged_frac"] - LJ4_CONV_ATOL:
        raise AssertionError(f"LJ4 converged_frac {stats['converged_frac']} "
                             f"is below the JAX package's "
                             f"{ref['converged_frac']} by more than "
                             f"{LJ4_CONV_ATOL}")
    if not stats.get("fmax_max_converged", 0.0) < cfg.fmax:
        raise AssertionError("a converged LJ4 result has fmax >= 1e-3")
    if stats["max_nrestarts"] == 0:
        raise AssertionError("no LJ4 lane restarted: the restart branch did "
                             "not run")
    for k in LJ4_COUNTS:
        if abs(stats[k] - ref[k]) > LJ4_COUNTS_RTOL * ref[k]:
            raise AssertionError(f"LJ4 {k} = {stats[k]} is more than "
                                 f"{LJ4_COUNTS_RTOL:.0%} from the JAX "
                                 f"package's {ref[k]}")
    if stats["inertia_not_one_frac"] > INERTIA_BAD_MAX:
        raise AssertionError(f"{stats['inertia_not_one_frac']:.4f} of the "
                             "converged LJ4 saddles are not index 1")
    return stats


def _bond(rt):
    def cons(x):
        p = x.reshape(-1, 3)
        return torch.linalg.norm(p[0] - p[1]).reshape(1) - rt

    return cons


def run_constraints(dev="cuda:0", batch=1024):
    """The constrained LJ4 configs of tests/test_ensemble.py:319-463 at
    ``batch`` lanes and ``CONSTRAINT_MAX_STEPS`` steps: the 0-1 bond
    pinned at 1.3 as an equality (minimization, saddle) and as a ``"gt"``
    inequality. Every run is printed before the gates, which hold the
    runs to ``JAX_CONSTRAINT_REF`` and raise unless it was computed at
    these sizes."""
    from sella_tpu_torch import EnsembleConfig, LennardJones, run_ensemble

    def starts(seed):
        return lj4_starts(batch, seed, jitter=0.05)

    minim = dict(natoms=4, order=0, fmax=1e-4, ncons=1, ctol=1e-6,
                 eig=False, method="qn")
    # (name, config, starts, comparators, bond tolerance): the saddle
    # config's ctol is 1e-4, which is all its convergence test promises
    # about the bond
    runs = [
        ("eq_min", minim, starts(3), None, 1e-5),
        ("gt_min", minim, starts(3), ("gt",), 1e-4),
        ("eq_saddle", dict(natoms=4, order=1, fmax=1e-3, ncons=1),
         starts(0), None, 1e-4),
    ]
    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" \
        else (lambda: None)
    out = {}
    for name, kw, x0, comp, _ in runs:
        t = time.perf_counter()
        st = run_ensemble(LennardJones(), x0, EnsembleConfig(**kw),
                          max_steps=CONSTRAINT_MAX_STEPS,
                          constraints=_bond(1.3), comparators=comp,
                          device=dev)
        sync()
        conv = st.converged
        p = st.x.reshape(-1, 4, 3)
        dev_bond = ((p[:, 0] - p[:, 1]).norm(dim=1) - 1.3).abs()[conv]
        nconv = int(conv.sum())
        out[name] = {
            "wall_s": time.perf_counter() - t, "converged": nconv,
            "jax_converged": JAX_CONSTRAINT_REF[name]["converged"],
            "steps_run": int(st.nsteps.max()),
            "mean_steps_converged": (float(st.nsteps[conv].double().mean())
                                     if nconv else None),
            "bond_dev_max": float(dev_bond.max()) if nconv else None}
        print(json.dumps({name: out[name]}), flush=True)

    size = {"batch": batch, "max_steps": CONSTRAINT_MAX_STEPS}
    if size != JAX_CONSTRAINT_REF["size"]:
        raise AssertionError(f"JAX_CONSTRAINT_REF was computed at "
                             f"{JAX_CONSTRAINT_REF['size']}, not at {size}: "
                             "rerun tools/jax_reference_counts.py")
    for name, _, _, _, bond_tol in runs:
        res, nconv = out[name], out[name]["converged"]
        # every lane the JAX package converges, less the run's margin;
        # the minimization with the bond as an equality converges them all
        # and the saddle at least half of them
        ok = nconv >= res["jax_converged"] - CONSTRAINT_LANES_ATOL[name]
        if name == "eq_min":
            ok = ok and nconv == batch
        if name == "eq_saddle":
            ok = ok and nconv >= batch / 2
        if not ok:
            raise AssertionError(f"constraints {name}: {nconv} of {batch} "
                                 f"converged (JAX: {res['jax_converged']})")
        if not res["bond_dev_max"] < bond_tol:
            raise AssertionError(f"constraints {name}: bond off by "
                                 f"{res['bond_dev_max']} >= {bond_tol}")
    return out


def run_checkpoint(dev="cuda:0", batch=64, total=256):
    """Checkpoints on ``dev``: a live queue state through save_queue and
    load_queue (every field bit-identical, same device and dtype), then
    the queue of test_queue_resume_from_checkpoint (LJ4 order 0, qn, no
    Davidson) resumed from its first cycle's checkpoint."""
    import os
    import shutil
    import tempfile

    import sella_tpu_torch.parallel.checkpoint as ckpt
    from sella_tpu_torch import EnsembleConfig, LennardJones, \
        make_queue_fns, run_ensemble_queue
    from sella_tpu_torch.parallel.ensemble import init_state

    dev = torch.device(dev)
    pot = LennardJones()
    cfg = EnsembleConfig(natoms=4, order=0, fmax=1e-3, gamma=1e-3,
                         eig=False, method="qn", sigma_dec=0.90,
                         rho_dec=100.0)
    x0 = lj4_starts(total, seed=3)
    tmp = tempfile.mkdtemp()
    try:
        step, _, _, _ = make_queue_fns(pot, cfg, refill_every=20)
        gen = torch.Generator(device=dev).manual_seed(0)
        live = step(init_state(pot, x0[:batch], cfg, device=dev), gen)
        path = os.path.join(tmp, "live.pt")
        ckpt.save_queue(path, live, np.arange(batch), batch, {}, it=20,
                        rng_state=gen.get_state())
        back = ckpt.load_queue(path, device=dev)[0]
        for name, a, b in zip(live._fields, live, back):
            if not (a.device == b.device and a.dtype == b.dtype
                    and torch.equal(a, b)):
                raise AssertionError(f"checkpointed {name} came back changed")

        path = os.path.join(tmp, "queue.pt")
        first = os.path.join(tmp, "queue_first.pt")
        orig = ckpt.save_queue

        def capture(p, *a, **kw):
            orig(p, *a, **kw)
            if not os.path.exists(first):
                shutil.copy(p, first)

        args = dict(batch=batch, max_steps_per_search=300, refill_every=20,
                    checkpoint_every=1, device=dev)
        ckpt.save_queue = capture
        try:
            t = time.perf_counter()
            full = run_ensemble_queue(pot, x0, cfg, checkpoint_path=path,
                                      **args)
            wall = time.perf_counter() - t
        finally:
            ckpt.save_queue = orig
        done_first = len(ckpt.load_queue(first, device=dev)[3])
        resumed = run_ensemble_queue(pot, x0, cfg, checkpoint_path=first,
                                     resume=True, **args)
    finally:
        shutil.rmtree(tmp)
    bad = [i for i, (a, b) in enumerate(zip(full, resumed))
           if a[3] != b[3] or (a[3] and abs(a[1] - b[1]) > 1e-8)]
    stats = {"batch": batch, "total": total, "wall_s": wall,
             "harvested_at_checkpoint": done_first,
             "converged": sum(r[3] for r in full), "mismatched": len(bad)}
    print(json.dumps(stats), flush=True)
    if len(resumed) != total or bad or not 0 < done_first < total:
        raise AssertionError(f"resumed queue differs on inputs {bad[:10]}")
    return stats


def cell_setup(batch, seed=0):
    """The bench's atom+cell system (bench.py:1085-1096): bulk Cu EMT,
    2x2x2 conventional supercell 3% over-expanded (32 atoms, 9 cell
    DOF), positions rattled by 0.05 A and cell parameters drawn at
    0.02, both from ``np.random.RandomState(seed)``."""
    from sella_tpu_torch.potentials import EMT, fcc_bulk

    atoms = fcc_bulk("Cu", 3.59 * 1.03, reps=(2, 2, 2))
    nat = len(atoms)
    rng = np.random.RandomState(seed)
    x0 = np.stack([
        (atoms.positions
         + 0.05 * rng.normal(size=atoms.positions.shape)).ravel()
        for _ in range(batch)
    ])
    s0 = 0.02 * rng.normal(size=(batch, 9))
    return EMT(np.array([29] * nat), pbc=True), x0, s0, \
        np.asarray(atoms.cell), nat


def cell_config(nat):
    """The bench's CellEnsembleConfig (bench.py:1098-1099)."""
    from sella_tpu_torch import CellEnsembleConfig

    return CellEnsembleConfig(natoms=nat, ncell=9, order=0, nproj=3,
                              fmax=1e-3, delta0=0.1, absb="ns")


def _cell_fmax_smax(pot, cfg, state, cell_mask=None):
    """The tier's convergence criterion recomputed at the final geometry:
    max per-atom projected force and max |dE/ds| per lane."""
    from sella_tpu_torch.parallel.ensemble_cell import (
        _batched_cell_eval, _const_free_basis, make_ext_energy_c0)

    if cell_mask is None:
        cell_mask = np.ones((3, 3), dtype=bool)
    ext, _ = make_ext_energy_c0(pot, cfg, cell_mask)
    _, g = _batched_cell_eval(ext)(state.z, state.cell0)
    U = torch.as_tensor(_const_free_basis(cfg.natoms, cfg.ncell, cfg.nproj),
                        device=g.device)
    gp = (g @ U) @ U.T
    nr3 = 3 * cfg.natoms
    fmax = gp[:, :nr3].reshape(len(g), cfg.natoms, 3).norm(dim=2).amax(dim=1)
    return fmax, g[:, nr3:].abs().amax(dim=1)


def run_cell_headline(dev="cuda:0", batch=CELL_BATCH):
    """The bench's atom+cell config (phase 10) through ``run_cell_ensemble``
    at ``batch`` lanes, 10 steps a chunk; gates its converged share, its
    counts against BENCH_r04.json, the convergence criterion at the final
    geometry and the relaxed lattice. On the card, times one step's P-RFO
    prep eigh against the whole step (CUDA events)."""
    from sella_tpu_torch import cells_of, make_cell_step_fn, \
        run_cell_ensemble
    from sella_tpu_torch.ops.jacobi_eigh import jacobi_eigh_cuda
    from sella_tpu_torch.parallel.ensemble import prfo_prepare_batched
    from sella_tpu_torch.parallel.ensemble_cell import _const_free_basis

    dev = torch.device(dev)
    pot, x0, s0, cell0, nat = cell_setup(batch)
    cfg = cell_config(nat)
    pot = pot.to(dev)
    sync = _sync_for(dev)
    sync()
    jacobi_eigh_cuda.launches = 0
    t = time.perf_counter()
    state = run_cell_ensemble(pot, x0, cfg, cell0, s0=s0,
                              max_steps=CELL_MAX_STEPS, steps_per_call=10,
                              device=dev)
    sync()
    wall = time.perf_counter() - t
    launches = jacobi_eigh_cuda.launches

    for name, tns in zip(state._fields, state):
        if tns.device != dev:
            raise AssertionError(f"cell state.{name} is on {tns.device}")
        if tns.is_floating_point() and not bool(torch.isfinite(tns).all()):
            raise AssertionError(f"cell state.{name} has non-finite values")
    if tuple(state.z.shape) != (batch, cfg.dim):
        raise AssertionError(f"cell state.z has shape {tuple(state.z.shape)}")
    conv = state.converged
    nconv = int(conv.sum())
    steps_run = int(state.nsteps.max())
    fmax, smax = _cell_fmax_smax(pot, cfg, state)
    bad = conv & ~((fmax < cfg.fmax) & (smax < cfg.fmax))
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} converged cell lanes fail "
                             "the convergence criterion at their geometry")
    cells = cells_of(state, cfg)[conv].cpu().numpy()
    lat = np.linalg.norm(cells, axis=2) / 2.0       # 2x2x2 supercell
    ortho = cells @ np.swapaxes(cells, 1, 2)
    off = np.abs(ortho - ortho * np.eye(3)).max(axis=(1, 2))
    stats = {
        "batch": batch, "converged_frac": nconv / batch,
        "steps_run": steps_run,
        "mean_steps_converged": (float(state.nsteps[conv].double().mean())
                                 if nconv else None),
        "mean_force_calls": float(state.neval.double().mean()),
        "wall_s": wall, "searches_per_s": nconv / wall,
        "s_per_step": wall / max(steps_run, 1),
        "lattice_max_dev": (float(np.abs(lat - CELL_LATTICE_A).max())
                            if nconv else None),
        "offdiag_CCt_max": float(off.max()) if nconv else None,
        "jacobi_eigh_launches": launches,
    }
    if dev.type == "cuda":
        # one step's calls on a live state (converged flags cleared, so
        # every lane steps): the whole step against its prep eigh
        step = make_cell_step_fn(pot, cfg)
        live = state._replace(converged=torch.zeros_like(state.converged))
        U = torch.as_tensor(_const_free_basis(nat, cfg.ncell, cfg.nproj),
                            device=dev)
        g_free = live.g @ U
        Hproj = torch.einsum("ji,bjk,kl->bil", U, live.H, U)
        step_ms = _cuda_ms(lambda: step(live), 3)
        prep_ms = _cuda_ms(
            lambda: prfo_prepare_batched(g_free, Hproj, cfg.order), 3)
        stats.update(step_ms=step_ms, prep_eigh_ms=prep_ms,
                     prep_eigh_share=prep_ms / step_ms, card=_card())
    print(json.dumps(stats), flush=True)
    if stats["converged_frac"] < CONV_FRAC_MIN:
        raise AssertionError(f"cell converged_frac {stats['converged_frac']} "
                             f"< {CONV_FRAC_MIN}")
    for k, ref in BENCH_R04_CELL.items():
        if abs(stats[k] - ref) > CELL_COUNTS_RTOL * ref:
            raise AssertionError(f"cell {k} = {stats[k]} is more than "
                                 f"{CELL_COUNTS_RTOL:.0%} from BENCH_r04's "
                                 f"{ref}")
    if not (stats["lattice_max_dev"] < 0.01
            and stats["offdiag_CCt_max"] < 0.05):
        raise AssertionError("a relaxed cell misses the EMT lattice: "
                             f"{stats['lattice_max_dev']}, "
                             f"{stats['offdiag_CCt_max']}")
    return stats


SKEW = np.array([[1, 0, 0], [1, 1, 0], [0, 0, 1]], dtype=float)


def _angle_dev(cell):
    """Largest deviation from 90 degrees between two rows of ``cell``."""
    n = np.linalg.norm(cell, axis=1)
    c = [cell[i] @ cell[j] / (n[i] * n[j])
         for i, j in ((0, 1), (0, 2), (1, 2))]
    return max(abs(np.degrees(np.arccos(np.clip(v, -1, 1))) - 90.0)
               for v in c)


def run_cell_entry_points(dev="cuda:0", niggli_batch=64, queue_batch=64,
                          queue_total=128):
    """Phase 10b: the atom+cell tier's two other entry points on the card.

    ``run_cell_ensemble(niggli=True)`` on the skewed-lattice setup of
    tests/test_cell_niggli_batched.py (periodic LJ, 108 atoms): half the
    lanes start on the cubic cell, half on a 45-degree-skewed basis of
    the same lattice; the skewed lanes must be rebased and converge to
    the pristine lanes' enthalpy. Then ``run_cell_ensemble_queue``: the
    LJ bulk of tests/test_ensemble_cell.py:142-169 with ``queue_total``
    starts through ``queue_batch`` lanes, one converged result each."""
    from sella_tpu_torch import CellEnsembleConfig, run_cell_ensemble, \
        run_cell_ensemble_queue
    from sella_tpu_torch.potentials import LennardJones, fcc_bulk

    dev = torch.device(dev)
    sync = _sync_for(dev)
    atoms = fcc_bulk("Cu", 1.55, reps=(3, 3, 3))
    cell = np.asarray(atoms.cell)
    rng = np.random.RandomState(0)
    x0 = np.stack([
        (atoms.positions
         + 0.01 * rng.normal(size=atoms.positions.shape)).ravel()
        for _ in range(niggli_batch)
    ])
    half = niggli_batch // 2
    cell0 = np.stack([cell] * half + [SKEW @ cell] * (niggli_batch - half))
    cfg = CellEnsembleConfig(natoms=len(atoms), ncell=9, order=0, fmax=5e-3,
                             delta0=0.1)
    sync()
    t = time.perf_counter()
    st = run_cell_ensemble(LennardJones(pbc=True, rc=1.4), x0, cfg, cell0,
                           max_steps=150, steps_per_call=5, niggli=True,
                           device=dev)
    sync()
    t_niggli = time.perf_counter() - t
    f = st.f.cpu().numpy()
    c0 = st.cell0.cpu().numpy()
    f_ref = float(np.median(f[:half]))
    stats = {
        "niggli_batch": niggli_batch, "niggli_wall_s": t_niggli,
        "niggli_converged": int(st.converged.sum()),
        "niggli_steps_run": int(st.nsteps.max()),
        "skewed_rebased": int(sum(_angle_dev(c) < 5.0 for c in c0[half:])),
        "skewed_f_rel_dev_max": float(np.abs(f[half:] - f_ref).max()
                                      / abs(f_ref)),
        "pristine_f_rel_dev_max": float(np.abs(f[:half] - f_ref).max()
                                        / abs(f_ref)),
    }

    atoms = fcc_bulk("Cu", 1.55, reps=(2, 2, 2))
    rng = np.random.RandomState(0)
    xq = np.stack([
        (atoms.positions
         + 0.02 * rng.normal(size=atoms.positions.shape)).ravel()
        for _ in range(queue_total)
    ])
    sq = 0.02 * rng.normal(size=(queue_total, 9))
    cfgq = CellEnsembleConfig(natoms=len(atoms), ncell=9, order=0,
                              fmax=5e-3, delta0=0.1)
    sync()
    t = time.perf_counter()
    res = run_cell_ensemble_queue(LennardJones(pbc=True), xq, cfgq,
                                  np.asarray(atoms.cell), queue_batch,
                                  s0_all=sq, max_steps_per_search=200,
                                  refill_every=10, device=dev)
    sync()
    t_queue = time.perf_counter() - t
    fq = np.array([r["f"] for r in res])
    stats.update({
        "queue_batch": queue_batch, "queue_total": queue_total,
        "queue_wall_s": t_queue, "queue_results": len(res),
        "queue_converged": sum(r["converged"] for r in res),
        "queue_mean_steps": float(np.mean([r["nsteps"] for r in res])),
        "queue_searches_per_s": sum(r["converged"] for r in res) / t_queue,
        "queue_f_rel_spread": float(np.std(fq) / abs(np.mean(fq))),
    })
    if dev.type == "cuda":
        stats["card"] = _card()
    print(json.dumps(stats), flush=True)
    if not (stats["niggli_converged"] == niggli_batch
            and stats["skewed_rebased"] == niggli_batch - half
            and stats["skewed_f_rel_dev_max"] < 1e-6):
        raise AssertionError("the Niggli run did not rebase and converge "
                             "every skewed lane to the pristine enthalpy")
    if not (stats["queue_results"] == queue_total
            and stats["queue_converged"] == queue_total):
        raise AssertionError("the cell queue did not return one converged "
                             "result per input")
    return stats


def run_precision_split(dev="cuda:0", slab_lanes=1024,
                        bulk_lanes=CELL_BATCH):
    """Phase 11a: F32Potential(EMT) against float64 EMT on the card at the
    headline slab (1024 lanes) and the phase-10 bulk (512 lanes): per-lane
    energy, gradient and HVP within tests/test_pot_f32.py's tolerances,
    and the batched eval and HVP timed in each precision (CUDA events)."""
    from sella_tpu_torch.parallel.ensemble import _batched_eval, \
        _batched_hvp_full
    from sella_tpu_torch.potentials import F32Potential

    dev = torch.device(dev)
    timed = _cuda_ms if dev.type == "cuda" else (lambda fn, reps: None)
    pot_s, x_s, cell_s, _ = headline_setup(slab_lanes)
    pot_b, x_b, _, cell_b, _ = cell_setup(bulk_lanes)
    out = {}
    for name, pot, x_np, cell in (
            (f"headline_slab_{slab_lanes}", pot_s, x_s, cell_s),
            (f"cell_bulk_{bulk_lanes}", pot_b, x_b, cell_b)):
        n = x_np.shape[1] // 3
        v_np = np.random.RandomState(1).normal(size=x_np.shape)
        v_np /= np.linalg.norm(v_np, axis=1, keepdims=True)
        x = torch.as_tensor(x_np, device=dev)
        v = torch.as_tensor(v_np, device=dev)
        cell_t = torch.as_tensor(cell, device=dev)
        p64 = pot.to(dev)
        p32 = F32Potential(pot).to(dev)
        res = {}
        for tag, p in (("f64", p64), ("f32", p32)):
            ev = _batched_eval(p, cell_t, 256)
            hv = _batched_hvp_full(p, cell_t, 256)
            f, g = ev(x)
            h = hv(x, v)
            res[tag] = (f, g, h, timed(lambda: ev(x), 5),
                        timed(lambda: hv(x, v), 5))
        f64, g64, h64, e64_ms, h64_ms = res["f64"]
        f32, g32, h32, e32_ms, h32_ms = res["f32"]
        if not (f32.dtype == g32.dtype == h32.dtype == torch.float64):
            raise AssertionError("F32Potential left its float64 interface")
        de = float((f32 - f64).abs().max())
        dg = float((g32 - g64).abs().max())
        dh = float(((h32 - h64).norm(dim=1)
                    / h64.norm(dim=1).clamp(min=1.0)).max())
        out[name] = {
            "lanes": len(x_np), "natoms": n,
            "energy_abs_diff_max": de, "energy_gate": 1e-5 * 15.0 * n,
            "grad_abs_diff_max": dg, "grad_gate": 5e-5,
            "hvp_rel_diff_max": dh, "hvp_gate": 2e-4,
        }
        if dev.type == "cuda":
            out[name].update(
                eval_ms_f64=e64_ms, eval_ms_f32=e32_ms,
                eval_f64_over_f32=e64_ms / e32_ms,
                hvp_ms_f64=h64_ms, hvp_ms_f32=h32_ms,
                hvp_f64_over_f32=h64_ms / h32_ms, card=_card())
        print(json.dumps({name: out[name]}), flush=True)
        if not (de < 1e-5 * 15.0 * n and dg < 5e-5 and dh < 2e-4):
            raise AssertionError(f"F32Potential on {name} misses "
                                 "tests/test_pot_f32.py's tolerances")
    return out


def emt151_setup(batch):
    """bench.py:249-290: Cu(111) 5x5x6 slab on the primitive surface cell
    plus one adatom nudged off the fcc hollow, 151 atoms, 453 DOF;
    ``batch`` starts jittered by 0.02 A from ``RandomState(0)``."""
    from sella_tpu_torch.potentials import EMT, fcc111_primitive

    a = 3.59
    slab = fcc111_primitive("Cu", a, size=(5, 5, 6))
    d = a / np.sqrt(2.0)
    a1 = np.array([d, 0.0, 0.0])
    a2 = np.array([d / 2.0, d * np.sqrt(3.0) / 2.0, 0.0])
    top_z = slab.positions[:, 2].max()
    top = slab.positions[np.abs(slab.positions[:, 2] - top_z) < 0.1]
    base = top[np.lexsort((top[:, 1], top[:, 0]))][len(top) // 2]
    ad = (base + (a1 + a2) / 3.0 + np.array([0.3, 0.1, 0.0])
          + np.array([0.0, 0.0, a / np.sqrt(3.0)]))
    pos0 = np.vstack([slab.positions, ad])
    nat = len(pos0)
    rng = np.random.RandomState(0)
    x0 = np.stack([(pos0 + 0.02 * rng.normal(size=pos0.shape)).ravel()
                   for _ in range(batch)])
    return EMT(np.array([29] * nat), pbc=True), x0, \
        np.asarray(slab.cell), nat


def run_emt151_pair(dev="cuda:0", batch=32, max_steps=60):
    """Phase 11b: the emt151 config (bench.py:380-395) in float64 and
    behind F32Potential with the bench's pred_min (bench.py:422-427),
    each through ``run_ensemble``. Gates: both converge, and the float32
    run's counts stay within F32_COUNTS_RTOL of the float64 run's."""
    from sella_tpu_torch import EnsembleConfig, run_ensemble
    from sella_tpu_torch.potentials import F32Potential

    dev = torch.device(dev)
    pot, x0, cell, nat = emt151_setup(batch)
    cell_t = torch.as_tensor(cell, device=dev)
    cfg = EnsembleConfig(
        natoms=nat, order=1, nproj=3, fmax=1e-3, gamma=0.3,
        davidson_max=60, delta0=5e-3, diag_budget=max(batch // 8, 1),
        eigh_f32=True, rs_maxiter=12, absb="ns",
        eval_chunk=min(batch, 16), davidson_seed="pmode", prfo_eigh="eigh",
    )
    sync = _sync_for(dev)
    out = {}
    for tag in ("f64", "f32"):
        p, c = pot, cfg
        if tag == "f32":
            p = F32Potential(pot)
            c = cfg._replace(pred_min=3.0 * 1e-5 * 15.0 * nat)
        sync()
        t = time.perf_counter()
        st = run_ensemble(p.to(dev), x0, c, max_steps=max_steps,
                          cell=cell_t, device=dev)
        sync()
        wall = time.perf_counter() - t
        conv = st.converged
        nconv = int(conv.sum())
        if not bool(torch.isfinite(st.x).all()):
            raise AssertionError(f"emt151 {tag}: non-finite geometry")
        out[tag] = {
            "converged_frac": nconv / batch,
            "steps_run": int(st.nsteps.max()),
            "mean_steps_converged": (float(st.nsteps[conv].double().mean())
                                     if nconv else None),
            "mean_matvecs": float(st.nmatvec.double().mean()),
            "mean_force_calls": float(st.neval.double().mean()),
            "wall_s": wall, "searches_per_s": nconv / wall,
        }
        print(json.dumps({f"emt151_{tag}": out[tag],
                          "bench_r05": BENCH_R05_EMT151[tag],
                          "card": _card() if dev.type == "cuda" else None}),
              flush=True)
    for tag in ("f64", "f32"):
        if out[tag]["converged_frac"] < CONV_FRAC_MIN:
            raise AssertionError(f"emt151 {tag} converged_frac "
                                 f"{out[tag]['converged_frac']} < "
                                 f"{CONV_FRAC_MIN}")
    for k in BENCH_R05_EMT151["f64"]:
        ref = out["f64"][k]
        if abs(out["f32"][k] - ref) > F32_COUNTS_RTOL * ref:
            raise AssertionError(f"emt151 f32 {k} = {out['f32'][k]} is more "
                                 f"than {F32_COUNTS_RTOL:.0%} from the "
                                 f"float64 run's {ref}")
    return out


# ---------------------------------------------------------------------------
# phase 12: the internal-coordinate tier
# ---------------------------------------------------------------------------
# 12a: the bench's internal config (bench.py:552-640, 1327-1337; BASELINE
# config 2) at its full width and the bench block's 40 steps, not cut
INTERNAL_SIZE = {"batch": 1024, "max_steps": 40}
# 12c: the repave config of tests/test_repave.py:210-242 at 256 lanes,
# and the dummy-atom and fixed-bond configs of
# tests/test_ensemble_internal.py:125-228 at 1024 lanes
INT_REPAVE_SIZE = {"batch": 256, "max_steps": 150}
INT_CONS_SIZE = {"batch": 1024, "max_steps": 200}
# 12d: the served queue on 12a's config, inputs 2x the lanes (cut from
# 4x so that phase 13 fits the script's time: the step is launch-bound,
# so the queue's wall follows its cycles, ~2 searches a lane)
INT_QUEUE_SIZE = {"batch": 128, "total": 256, "max_steps_per_search": 60,
                  "refill_every": 5}
INT_COUNTS = ("mean_steps_converged", "mean_matvecs", "mean_force_calls")
INT_COUNTS_RTOL = 0.05
INT_CONV_ATOL = 0.04
# converged lanes the card may differ from the JAX package by on the
# minimizations of 12c (no random draw; float64 on the card vs LAPACK on
# the CPU can tip a lane that converges at the last step)
INT_CONS_LANES_ATOL = 5
# the largest constraint error at the final geometries may be the larger
# of the JAX tests' tolerance (the dummy's bond and angle, the fixed bond:
# tests/test_ensemble_internal.py:165-171, 215) and twice the JAX
# package's own largest error at the same size (a lane can converge in
# force before its Newton back-transform pins the bond to 1e-4)
INT_CONS_TOL = {"dummy": 1e-8, "fixed_bond": 1e-4}
# the JAX package on the 12a, 12c and 12d configurations at the sizes
# above, computed on a CPU (tools/jax_reference_counts.py); a run at other
# sizes raises
JAX_INTERNAL_REF = {
    "headline": {"size": {"batch": 1024, "max_steps": 40},
                 "converged_frac": 0.90625,
                 "mean_steps_converged": 25.148706896551722,
                 "mean_matvecs": 34.4287109375,
                 "mean_force_calls": 27.541015625},
    "dummy": {"size": {"batch": 1024, "max_steps": 200},
              "converged": 1024, "constraint_err": 9.591571981104607e-11},
    "fixed_bond": {"size": {"batch": 1024, "max_steps": 200},
                   "converged": 1024,
                   "constraint_err": 0.000598340508966011},
    "queue": {"size": {"batch": 128, "total": 256,
                       "max_steps_per_search": 60, "refill_every": 5},
              "converged_frac": 0.99609375,
              "mean_steps_converged": 27.643137254901962,
              "mean_matvecs": 36.58203125,
              "mean_force_calls": 29.0625}}
# the JAX package's figures on a TPU v5 lite (bench.py:134-142, 165-176):
# printed beside 12a, not compared, and not the port's goals
TPU_INTERNAL = {"s_per_step": 6.35, "searches_per_s": 3.68,
                "converged_frac": 0.912, "steps": 40,
                "pre_chord_150_steps": {"converged_frac": 0.988,
                                        "mean_steps_converged": 30.6,
                                        "mean_matvecs": 40.3}}


def xe4_setup(batch, seed=0):
    """The bench's Morse Xe4 system (bench.py:580-597): eps = 226.9 kB,
    r0 = 4.73, rho0 = 1.099 r0, ``pos0`` from RandomState(4) at scale 3,
    its redundant-internal topology (nint = 11), and ``batch`` starts
    ``pos0 + 0.3 N(0, 1)`` from RandomState(seed)."""
    from sella_tpu_torch import Atoms, Internals, MorsePotential
    from sella_tpu_torch.utils.units import kB

    r0 = 4.73
    pot = MorsePotential(epsilon=226.9 * kB, r0=r0, rho0=r0 * 1.099)
    pos0 = np.random.RandomState(4).normal(size=(4, 3), scale=3.0)
    ints = Internals(Atoms(["Xe"] * 4, pos0))
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    x0 = (pos0[None] + 0.3 * np.random.RandomState(seed).normal(
        size=(batch, 4, 3))).reshape(batch, 12)
    return pot, ints, x0


def xe4_config(ints):
    """The bench block's InternalEnsembleConfig (bench.py:604-617)."""
    from sella_tpu_torch import InternalEnsembleConfig

    return InternalEnsembleConfig(natoms=4, nint=ints.nint, order=1,
                                  fmax=1e-3, gamma=1e-3, restart_after=60,
                                  absb="eigh", newton_chord=True)


def int_stats(nsteps, nmatvec, neval, conv):
    """The internal tier's counts: steps over converged searches, matvecs
    and force calls over all searches (bench.py:648-660)."""
    nsteps, nmatvec, neval = (np.asarray(a, dtype=np.float64)
                              for a in (nsteps, nmatvec, neval))
    conv = np.asarray(conv, dtype=bool)
    return {"converged_frac": float(conv.mean()),
            "mean_steps_converged": (float(nsteps[conv].mean())
                                     if conv.any() else None),
            "mean_matvecs": float(nmatvec.mean()),
            "mean_force_calls": float(neval.mean())}


def _hold_to_jax(name, stats, size, keys=INT_COUNTS):
    """Raise unless the JAX reference of ``name`` was computed at
    ``size`` and ``stats`` meet it: converged share within INT_CONV_ATOL,
    counts within INT_COUNTS_RTOL."""
    if JAX_INTERNAL_REF is None or JAX_INTERNAL_REF[name]["size"] != size:
        raise AssertionError(f"no JAX reference for {name} at {size}; rerun "
                             "tools/jax_reference_counts.py")
    ref = JAX_INTERNAL_REF[name]
    if abs(stats["converged_frac"] - ref["converged_frac"]) > INT_CONV_ATOL:
        raise AssertionError(f"{name} converged_frac "
                             f"{stats['converged_frac']} vs JAX "
                             f"{ref['converged_frac']}")
    for k in keys:
        if abs(stats[k] - ref[k]) > INT_COUNTS_RTOL * ref[k]:
            raise AssertionError(f"{name} {k} = {stats[k]} is more than "
                                 f"{INT_COUNTS_RTOL:.0%} from JAX's {ref[k]}")


def run_internal_headline(dev="cuda:0", batch=INTERNAL_SIZE["batch"],
                          max_steps=INTERNAL_SIZE["max_steps"]):
    """12a: the bench's internal config, ``max_steps`` steps (stopping
    early once every lane converged), with the shares of the step in the
    Gram eigh, the Newton back-transform and Davidson (CUDA events)."""
    import sella_tpu_torch.parallel.ensemble_internal as TE

    dev = torch.device(dev)
    pot, ints, x0 = xe4_setup(batch)
    cfg = xe4_config(ints)
    pot = pot.to(dev)
    sync = _sync_for(dev)
    step = TE.make_internal_step_fn(pot, ints, cfg)
    state = TE.init_internal_state(pot, ints, x0, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    TE.SPANS = {} if dev.type == "cuda" else None
    sync()
    t = time.perf_counter()
    steps = 0
    try:
        for _ in range(max_steps):
            state = step(state, gen)
            steps += 1
            if bool(state.converged.all()):
                break
        sync()
        wall = time.perf_counter() - t
        spans = TE.span_ms(TE.SPANS) if TE.SPANS is not None else {}
    finally:
        TE.SPANS = None
    for name, tns in zip(state._fields, state):
        if tns.device != dev:
            raise AssertionError(f"internal state.{name} is on {tns.device}")
        if tns.is_floating_point() and not bool(
                torch.isfinite(tns).all()):
            raise AssertionError(f"internal state.{name} is not finite")
    stats = int_stats(state.nsteps.cpu(), state.nmatvec.cpu(),
                      state.neval.cpu(), state.converged.cpu())
    nconv = int(state.converged.sum())
    stats.update(batch=batch, steps_run=steps, wall_s=wall,
                 s_per_step=wall / max(steps, 1),
                 searches_per_s=nconv / wall,
                 span_ms=spans,
                 span_share={k: v / (1e3 * wall) for k, v in spans.items()},
                 tpu_figures=TPU_INTERNAL)
    if dev.type == "cuda":
        stats["card"] = _card()
    print(json.dumps(stats), flush=True)
    _hold_to_jax("headline", stats, {"batch": batch, "max_steps": max_steps})
    return stats


def run_robust_gram(dev="cuda:0", batch=INTERNAL_SIZE["batch"]):
    """12b: ``batched_eigh(G, "robust")`` of the 1024 Gram matrices B B^T
    of 12a's start geometries (zero cluster of multiplicity
    nint - nred = 5): finite eigenpairs, relative residual and
    orthonormality within 1e-12 (tests/test_eigh_refined.py:66-86), the
    eigenvalues within 1e-12 of LAPACK's on the host, and exactly 5
    eigenvalues below 1e-10 of the largest in every lane."""
    from sella_tpu_torch.ops.linalg import batched_eigh

    dev = torch.device(dev)
    _, ints, x0 = xe4_setup(batch)
    B = ints._get_engine()._jac_impl(
        torch.as_tensor(x0, device=dev).reshape(batch, 4, 3),
        torch.zeros((3, 3), dtype=torch.float64, device=dev))
    G = B @ B.transpose(1, 2)
    lams, V = batched_eigh(G, "robust")
    scale = lams[:, -1:].abs()
    eye = torch.eye(G.shape[1], dtype=G.dtype, device=dev)
    ref = np.linalg.eigvalsh(G.cpu().numpy())
    stats = {
        "batch": batch, "n": G.shape[1],
        "finite": bool(torch.isfinite(lams).all()
                       and torch.isfinite(V).all()),
        "residual": float(((G @ V - V * lams[:, None, :]).abs().amax((1, 2))
                           / scale[:, 0]).max()),
        "orthonormality": float((V.transpose(1, 2) @ V - eye).abs().max()),
        "lam_vs_host": float((np.abs(lams.cpu().numpy() - ref)
                              / np.abs(ref[:, -1:])).max()),
        "zero_counts": sorted(set(
            (lams < 1e-10 * scale).sum(1).cpu().tolist())),
    }
    if dev.type == "cuda":
        stats["eigh_ms"] = _cuda_ms(lambda: batched_eigh(G, "robust"), 5)
    print(json.dumps(stats), flush=True)
    if not (stats["finite"] and stats["residual"] <= 1e-12
            and stats["orthonormality"] <= 1e-12
            and stats["lam_vs_host"] <= 1e-12
            and stats["zero_counts"] == [5]):
        raise AssertionError(f"robust Gram eigh fails its gates: {stats}")
    return stats


def _repave_lanes_x0(batch):
    """tests/test_repave.py:210-242 at ``batch`` lanes: perturbed LJ
    tetrahedra (RandomState(0), 0.05) alternating with the 179.8-degree
    geometry whose angle lies in the 0.5-degree singular window."""
    r0 = 2.0 ** (1.0 / 6.0)
    tet = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                    [0.5, np.sqrt(3.0) / 2.0, 0.0],
                    [0.5, np.sqrt(3.0) / 6.0, np.sqrt(2.0 / 3.0)]]) * r0
    th = np.radians(0.2)
    b = np.array([r0, 0.0, 0.0])
    lin = np.stack([np.zeros(3), b,
                    b + r0 * np.array([np.cos(th), np.sin(th), 0.0]),
                    np.array([r0, 0.75 * r0, 0.6 * r0])])
    rng = np.random.RandomState(0)
    lanes = [lin.ravel() if i % 2 else
             tet.ravel() + 0.05 * rng.normal(size=12) for i in range(batch)]
    return tet, np.stack(lanes)


def _cons_setups(batch):
    """The dummy-atom and fixed-bond configs of
    tests/test_ensemble_internal.py:125-228 (order 0, delta0 0.05) at
    ``batch`` lanes: (name, potential, ints, x0, config kwargs)."""
    from sella_tpu_torch import Atoms, Internals, MorsePotential
    from sella_tpu_torch.coords import DuplicateInternalError
    from sella_tpu_torch.utils.units import kB

    r0 = 4.73
    out = []
    lin = np.array([[0.0, 0, 0], [r0, 0, 0], [2 * r0, 0, 0]])
    ints = Internals(Atoms(["Xe"] * 3, lin))
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    x0 = (lin[None] + 0.2 * np.random.RandomState(0).normal(
        size=(batch, 3, 3))).reshape(batch, 9)
    out.append(("dummy", ints, x0, dict(natoms=3, ndummies=1, ncons=2)))
    tet = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                    [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * r0
    ints = Internals(Atoms(["Xe"] * 4, tet))
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    try:
        ints.add_bond((0, 1))
    except DuplicateInternalError:
        pass
    ints.cons.fix_bond((0, 1), target=1.15 * r0)
    x0 = (tet[None] + 0.15 * np.random.RandomState(1).normal(
        size=(batch, 4, 3))).reshape(batch, 12)
    out.append(("fixed_bond", ints, x0, dict(natoms=4, ncons=1)))
    pot = MorsePotential(epsilon=226.9 * kB, r0=r0, rho0=r0 * 1.099)
    return pot, out


def constraint_error(name, x):
    """The largest constraint error over the lanes ``x`` (B, d) of the
    ``"dummy"`` config (the dummy's bond to 1 and its right angle) or the
    ``"fixed_bond"`` config (bond 0-1 at 1.15 r0)."""
    if name == "dummy":
        p = x.reshape(len(x), 4, 3)
        dvec = p[:, 3] - p[:, 1]
        return float(max(
            np.abs(np.linalg.norm(dvec, axis=1) - 1.0).max(),
            np.abs(np.einsum("bi,bi->b", p[:, 0] - p[:, 1], dvec)
                   / np.linalg.norm(p[:, 0] - p[:, 1], axis=1)).max()))
    return float(np.abs(np.linalg.norm(x[:, 3:6] - x[:, 0:3], axis=1)
                        - 1.15 * 4.73).max())


def run_internal_repave_and_constraints(dev="cuda:0",
                                        repave_batch=INT_REPAVE_SIZE["batch"],
                                        cons_batch=INT_CONS_SIZE["batch"]):
    """12c: ``run_internal_ensemble(repave=True)`` on the repave config
    (every lane converges, every near-linear lane is repaved), then the
    dummy-atom and fixed-bond configs held to the JAX package's converged
    counts, their constraints checked at the final geometries."""
    from sella_tpu_torch import (Atoms, InternalEnsembleConfig, Internals,
                                 LennardJones, run_internal_ensemble)

    dev = torch.device(dev)
    tet, x0 = _repave_lanes_x0(repave_batch)
    ints = Internals(Atoms(["He"] * 4, tet))
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    cfg = InternalEnsembleConfig(natoms=4, nint=ints.nint, order=0,
                                 fmax=1e-3, gamma=0.1, eig=False)
    t = time.perf_counter()
    st, ints2 = run_internal_ensemble(
        LennardJones().to(dev), ints, x0, cfg, repave=True, device=dev,
        max_steps=INT_REPAVE_SIZE["max_steps"])
    wall = time.perf_counter() - t
    qact = st.qact.cpu().numpy()
    near = np.arange(repave_batch) % 2 == 1
    stats = {"repave": {
        "batch": repave_batch, "wall_s": wall,
        "converged": int(st.converged.sum()),
        "near_linear_repaved": int((~qact[near].all(axis=1)).sum()),
        "nint": [ints.nint, ints2.nint],
        "steps_max": int(st.nsteps.max())}}
    if not (bool(st.converged.all())
            and stats["repave"]["near_linear_repaved"] == int(near.sum())):
        print(json.dumps(stats), flush=True)
        raise AssertionError(f"repave: {stats['repave']}")

    pot, setups = _cons_setups(cons_batch)
    pot = pot.to(dev)
    for name, ints, x0, kw in setups:
        cfg = InternalEnsembleConfig(nint=ints.nint, order=0, fmax=1e-3,
                                     delta0=0.05, **kw)
        t = time.perf_counter()
        st = run_internal_ensemble(pot, ints, x0, cfg, device=dev,
                                   max_steps=INT_CONS_SIZE["max_steps"])
        stats[name] = {"batch": cons_batch,
                       "wall_s": time.perf_counter() - t,
                       "converged": int(st.converged.sum()),
                       "steps_max": int(st.nsteps.max()),
                       "constraint_err": constraint_error(
                           name, st.x.cpu().numpy())}
    print(json.dumps(stats), flush=True)
    size = {"batch": cons_batch, "max_steps": INT_CONS_SIZE["max_steps"]}
    for name in ("dummy", "fixed_bond"):
        if JAX_INTERNAL_REF is None or \
                JAX_INTERNAL_REF[name]["size"] != size:
            raise AssertionError(f"no JAX reference for {name} at {size}")
        ref = JAX_INTERNAL_REF[name]["converged"]
        if abs(stats[name]["converged"] - ref) > INT_CONS_LANES_ATOL:
            raise AssertionError(f"{name}: {stats[name]['converged']} "
                                 f"converged vs JAX {ref}")
        tol = max(INT_CONS_TOL[name],
                  2.0 * JAX_INTERNAL_REF[name]["constraint_err"])
        if stats[name]["constraint_err"] > tol:
            raise AssertionError(f"{name}: constraint error "
                                 f"{stats[name]['constraint_err']} > {tol}")
    return stats


def run_internal_queue(dev="cuda:0", batch=INT_QUEUE_SIZE["batch"],
                       total=INT_QUEUE_SIZE["total"]):
    """12d: ``run_internal_ensemble_queue`` on 12a's config with
    ``spill="cartesian"`` and a checkpoint every cycle, then one resume
    from the checkpoint written at 80% of the cycles; the full run held
    to the JAX package's run at this size and gated on at least one
    refill, and the resumed run finishing every input, with the converged
    results harvested before the checkpoint unchanged."""
    import os
    import shutil
    import tempfile

    import sella_tpu_torch.parallel.checkpoint as ckpt
    import sella_tpu_torch.parallel.ensemble_internal as TE
    from sella_tpu_torch import run_internal_ensemble_queue

    dev = torch.device(dev)
    pot, ints, x0 = xe4_setup(total, seed=1)
    cfg = xe4_config(ints)
    kw = dict(batch=batch, device=dev, spill="cartesian",
              max_steps_per_search=INT_QUEUE_SIZE["max_steps_per_search"],
              refill_every=INT_QUEUE_SIZE["refill_every"])
    tmp = tempfile.mkdtemp()
    saved = []
    orig = ckpt.save_queue

    def keep(p, *a, **k):
        orig(p, *a, **k)
        copy = os.path.join(tmp, f"cycle{len(saved)}.pt")
        shutil.copy(p, copy)
        saved.append(copy)

    try:
        ckpt.save_queue = keep
        t = time.perf_counter()
        try:
            with _Refills(TE, "refill_converged_internal") as refills:
                full = run_internal_ensemble_queue(
                    pot.to(dev), ints, x0, cfg,
                    checkpoint_path=os.path.join(tmp, "q.pt"), **kw)
        finally:
            ckpt.save_queue = orig
        wall = time.perf_counter() - t
        mid = saved[(4 * len(saved)) // 5]
        done_mid = ckpt.load_queue(mid, TE.InternalSearchState,
                                   device=dev)[3]
        t = time.perf_counter()
        resumed = run_internal_ensemble_queue(
            pot.to(dev), ints, x0, cfg, checkpoint_path=mid, resume=True,
            **kw)
        wall_resume = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp)
    stats = int_stats([r[2] for r in full], [r[4] for r in full],
                      [r[5] for r in full], [r[3] for r in full])
    # unconverged harvests go on to the Cartesian spill after the resume
    same = all(np.array_equal(resumed[i][0], r[0]) and resumed[i][2:] ==
               tuple(r[2:]) for i, r in done_mid.items() if r[3])
    stats.update(batch=batch, total=total, wall_s=wall,
                 searches_per_s=sum(r[3] for r in full) / wall,
                 cycles=len(saved), harvested_at_resume=len(done_mid),
                 refills=sum(refills.by_dim.values()),
                 resume_wall_s=wall_resume,
                 resumed=int_stats([r[2] for r in resumed],
                                   [r[4] for r in resumed],
                                   [r[5] for r in resumed],
                                   [r[3] for r in resumed]))
    print(json.dumps(stats), flush=True)
    if not (len(full) == len(resumed) == total and same
            and 0 < len(done_mid) < total):
        raise AssertionError("the resumed internal queue lost or changed "
                             "harvested inputs")
    refills.require("12d")
    _hold_to_jax("queue", stats,
                 dict(INT_QUEUE_SIZE, batch=batch, total=total))
    return stats


# ---------------------------------------------------------------------------
# phase 13: the large-system path
# ---------------------------------------------------------------------------
# 13a: the bench's largescale block (bench.py:952-1064, BASELINE config 5)
# at its full 10,000 atoms: one warm step, then LARGE_TIMED_STEPS timed
LARGE_SLAB = {"symbol": "Cu", "a": 3.59, "size": (50, 50, 4)}
LARGE_LJ = {"sigma": 2.3, "epsilon": 0.4, "rc": 5.5}
LARGE_TIMED_STEPS = 3
LARGE_CHUNK = 1000
# binned and chunked LJ are one physical model (bench.py:981-982): at x0
# the energy to 1e-10 relative and the gradient to 1e-9 of its max-norm,
# and the positions after the steps within 1e-7 A
LJ_PAIR_E_RTOL = 1e-10
LJ_PAIR_G_RTOL = 1e-9
LJ_PAIR_X_ATOL = 1e-7
# BinnedEMT on the card vs the port's CPU float64 evaluation (summation
# order only), and row-chunked vs not (the same terms, another order)
LARGE_EMT_E_RTOL = 1e-10
LARGE_EMT_G_ATOL = 1e-9
CHUNK_RTOL = 1e-12
# F32Potential(MLPotential) forces vs float64 at x0: 3e-5 max(scale, 1)
# in tests/test_mlff.py:160, whose box spans 10.77 A. Float32 positions,
# and the minimum-image displacements made from them, are resolved to
# the float32 spacing of the coordinates, which grows with their size
# (7.6e-6 A at the 10,000-atom slab's 127 A; in the JAX package's
# F32Potential as here), so the bound scales with the largest coordinate
# over 10.77 A; the error of float64 itself at the float32-rounded
# positions is printed beside it
MLFF_F32_ATOL = 3e-5
MLFF_F32_BOX = 10.77
# 13b: three runs held to the JAX package's, at these sizes
LARGESCALE_RUNS = {
    # tests/test_largescale.py:69-97 from an injected mode
    "lj7_saddle": {"order": 1, "fmax": 1e-3, "max_move": 0.1,
                   "max_steps": 800, "rattle": 0.15, "rattle_seed": 5,
                   "v0_seed": 0},
    # tests/test_largescale.py:53-66
    "cu_slab_min": {"size": [3, 4, 3], "order": 0, "fmax": 5e-3,
                    "max_move": 0.2, "max_steps": 500, "rattle": 0.05,
                    "rattle_seed": 2},
    "binned_emt_min": {"size": [16, 16, 4], "vacuum": 12.0, "order": 0,
                       "fmax": 1e-3, "max_move": 0.2, "max_steps": 500,
                       "rattle": 0.05, "rattle_seed": 2},
}
# the JAX package's runs of LARGESCALE_RUNS on a CPU
# (tools/jax_reference_counts.py --only largescale)
JAX_LARGESCALE_REF = {
    "size": {"lj7_saddle": {"order": 1, "fmax": 0.001, "max_move": 0.1,
                            "max_steps": 800, "rattle": 0.15,
                            "rattle_seed": 5, "v0_seed": 0},
             "cu_slab_min": {"size": [3, 4, 3], "order": 0, "fmax": 0.005,
                             "max_move": 0.2, "max_steps": 500,
                             "rattle": 0.05, "rattle_seed": 2},
             "binned_emt_min": {"size": [16, 16, 4], "vacuum": 12.0,
                                "order": 0, "fmax": 0.001, "max_move": 0.2,
                                "max_steps": 500, "rattle": 0.05,
                                "rattle_seed": 2}},
    "lj7_saddle": {"converged": True, "nsteps": 50, "neval": 51,
                   "nmatvec": 2172, "energy": -15.026438105114599,
                   "lam": -6.763989545938207},
    "cu_slab_min": {"converged": True, "nsteps": 10, "neval": 11,
                    "nmatvec": 0, "energy": 8.621979275977367, "lam": 0.0},
    "binned_emt_min": {"converged": True, "nsteps": 33, "neval": 34,
                       "nmatvec": 0, "energy": 183.53106200058028,
                       "lam": 0.0}}
LARGESCALE_COUNTS_RTOL = 0.05
LARGESCALE_E_ATOL = 1e-5
# the seconds phases 13, 14, 15 and 16 and phases 1-16 together may take
# (each gated)
PHASE13_MAX_S = 150
PHASE14_MAX_S = 150
PHASE15_MAX_S = 60
PHASE16_MAX_S = 50
PHASES_MAX_S = 1000
# the JAX package's bench block on a TPU v5 lite (BENCH_r04.json), s/step:
# printed beside 13a, not compared, and not the port's goals
TPU_LARGESCALE = {"binned": 1.491, "chunked": 3.236, "binned_emt": 1.66,
                  "mlff_order1": 14.718}


def lj7_start():
    """The LJ7 start of tests/test_largescale.py:69-97 and a normalized
    numpy mode, from LARGESCALE_RUNS["lj7_saddle"]."""
    cfg = LARGESCALE_RUNS["lj7_saddle"]
    pos = np.array([
        [0.0, 0.0, 1.1], [0.0, 0.0, -1.1], [1.12, 0.0, 0.0],
        *[[1.12 * np.cos(2 * np.pi * k / 5),
           1.12 * np.sin(2 * np.pi * k / 5), 0] for k in range(1, 5)],
    ]) * 0.9
    pos = pos + cfg["rattle"] * np.random.RandomState(
        cfg["rattle_seed"]).normal(size=pos.shape)
    v0 = np.random.RandomState(cfg["v0_seed"]).normal(size=pos.size)
    return pos.ravel(), v0 / np.linalg.norm(v0)


def rattled_slab(name):
    """(x0, cell) of a slab run of LARGESCALE_RUNS, numpy."""
    from sella_tpu_torch.potentials import fcc111_slab

    cfg = LARGESCALE_RUNS[name]
    kw = {"vacuum": cfg["vacuum"]} if "vacuum" in cfg else {}
    slab = fcc111_slab("Cu", 3.59, size=tuple(cfg["size"]), **kw)
    pos = slab.positions + cfg["rattle"] * np.random.RandomState(
        cfg["rattle_seed"]).normal(size=slab.positions.shape)
    return pos.ravel(), np.asarray(slab.cell)


def _count_syncs(fn, dev):
    """``fn()`` and the host syncs the card reported meanwhile
    (``torch.cuda.set_sync_debug_mode``); None off the card."""
    if torch.device(dev).type != "cuda":
        return fn(), None
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(x.message) for x in w)


def _event_ms(fn, dev, reps=3):
    return _cuda_ms(fn, reps) if torch.device(dev).type == "cuda" else None


def _peak_reset(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(dev):
    if torch.device(dev).type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def _bins_of(pot):
    return getattr(getattr(pot, "_inner32", pot), "_bins", None)


def _overflow(pot, x, cell_t):
    bins = _bins_of(pot)
    return 0 if bins is None else int(bins.overflow_count(x.reshape(-1, 3),
                                                          cell_t))


def mmf_block(name, pot, x0, cell, order, dev, steps=LARGE_TIMED_STEPS):
    """The bench's timing of one potential (bench.py:987-999): ``mmf_init``
    on a numpy x0, one warm step, then ``steps`` timed steps; beside them
    the force call's and one HVP's time (CUDA events), HVPs and host
    syncs per step (the step's own count, and the card's), peak memory
    from before ``mmf_init``, and the bin overflow before and after."""
    from sella_tpu_torch.parallel.largescale import make_mmf_step, mmf_init

    sync = _sync_for(dev)
    pot = pot.to(dev)
    cell_t = torch.as_tensor(cell, device=dev)
    _peak_reset(dev)
    t = time.perf_counter()
    state = mmf_init(pot, x0, cell, device=dev)
    over0 = _overflow(pot, state.x, cell_t)
    step = make_mmf_step(pot, cell, order=order, fmax=1e-3)
    state = step(state)
    sync()
    warm_s = time.perf_counter() - t
    h0, s0 = step.hvp_calls, step.host_syncs

    def timed():
        st = state
        for _ in range(steps):
            st = step(st)
        sync()
        return st

    t = time.perf_counter()
    state, card_syncs = _count_syncs(timed, dev)
    s_per_step = (time.perf_counter() - t) / steps
    peak = _peak_gib(dev)
    x = state.x
    v = torch.as_tensor(np.random.RandomState(1).normal(size=x.shape),
                        device=dev)
    out = {
        "natoms": x.numel() // 3, "order": order, "s_per_step": s_per_step,
        "warm_step_s": warm_s,
        "force_ms": _event_ms(lambda: pot.energy_and_grad(x, cell_t), dev),
        "hvp_ms": _event_ms(lambda: pot.hvp(x, v, cell_t), dev),
        "hvps_per_step": (step.hvp_calls - h0) / steps,
        "host_syncs_per_step": (step.host_syncs - s0) / steps,
        "card_syncs_per_step": (None if card_syncs is None
                                else card_syncs / steps),
        "peak_gib": peak,
        "overflow_before": over0, "overflow_after": _overflow(pot, x,
                                                              cell_t),
        "nsteps": int(state.nsteps), "lam": float(state.lam),
    }
    finite = all(bool(torch.isfinite(t).all()) for t in
                 [state.x, state.f, state.g, state.mode, *state.mem])
    print(f"  13a {name}: " + json.dumps(out), flush=True)
    if not finite:
        raise AssertionError(f"13a {name}: a state field is not finite")
    if out["overflow_before"] or out["overflow_after"]:
        raise AssertionError(f"13a {name}: bins overflow")
    return out, state


def run_largescale_bench(dev="cuda:0", size=LARGE_SLAB["size"]):
    """Phase 13a: the bench's 10,000-atom block on the port."""
    from sella_tpu_torch.potentials import (BinnedEMT, BinnedPairPotential,
                                            ChunkedPairPotential,
                                            F32Potential, LennardJones,
                                            MLPotential, fcc111_slab)
    from sella_tpu_torch.potentials.mlff import WEIGHTS_CU_EMT

    slab = fcc111_slab(LARGE_SLAB["symbol"], LARGE_SLAB["a"], size=size)
    x0, cell = slab.positions.ravel(), np.asarray(slab.cell)
    n = x0.size // 3
    res = {"natoms": n}
    inner = LennardJones(pbc=True, **LARGE_LJ)
    binned = BinnedPairPotential(inner, rc=LARGE_LJ["rc"], x0=x0, cell=cell,
                                 shift=False)
    chunked = ChunkedPairPotential(inner, chunk=LARGE_CHUNK)
    lj = {}
    for name, pot in (("binned", binned), ("chunked", chunked)):
        out, st = mmf_block(f"lj_{name}", pot, x0, cell, 0, dev)
        xt, ct = (torch.as_tensor(a, device=dev) for a in (x0, cell))
        e, g = pot.energy_and_grad(xt, ct)
        lj[name] = (float(e), g.cpu(), st.x.cpu())
        res[f"lj_{name}"] = out
    (eb, gb, xb), (ec, gc, xc) = lj["binned"], lj["chunked"]
    d = {"energy_rel": abs(eb - ec) / abs(ec),
         "grad_rel_maxnorm": float((gb - gc).abs().max()
                                   / max(float(gc.abs().max()), 1.0)),
         "x_after_steps": float((xb - xc).abs().max())}
    res["lj_binned_vs_chunked"] = d
    print(f"  13a binned vs chunked LJ: {json.dumps(d)}", flush=True)
    if not (d["energy_rel"] < LJ_PAIR_E_RTOL
            and d["grad_rel_maxnorm"] < LJ_PAIR_G_RTOL
            and d["x_after_steps"] < LJ_PAIR_X_ATOL):
        raise AssertionError("13a: binned and chunked LJ disagree")

    slab_e = fcc111_slab(LARGE_SLAB["symbol"], LARGE_SLAB["a"], size=size,
                         vacuum=12.0)
    xe, ce = slab_e.positions.ravel(), np.asarray(slab_e.cell)
    z = np.array([29] * n)
    emt = BinnedEMT(z, xe, ce, capacity=32)
    res["binned_emt"], _ = mmf_block("binned_emt", emt, xe, ce, 0, dev)
    # the card against the port's own CPU float64 evaluation at x0
    xt, ct = (torch.as_tensor(a, device=dev) for a in (xe, ce))
    e_card, g_card = emt.energy_and_grad(xt, ct)
    cpu = BinnedEMT(z, xe, ce, capacity=32)
    e_cpu, g_cpu = cpu.energy_and_grad(torch.as_tensor(xe),
                                       torch.as_tensor(ce))
    v = torch.as_tensor(np.random.RandomState(1).normal(size=xe.shape),
                        device=dev)
    # row-chunked vs not: the same energy and gradient, a smaller peak
    emt_c = BinnedEMT(z, xe, ce, capacity=32, chunk=LARGE_CHUNK).to(dev)
    peaks = {}
    for key, pot in (("full", emt), ("chunk", emt_c)):
        _peak_reset(dev)
        eg = pot.energy_and_grad(xt, ct)
        peaks[f"force_{key}_gib"] = _peak_gib(dev)
        _peak_reset(dev)
        pot.hvp(xt, v, ct)
        peaks[f"hvp_{key}_gib"] = _peak_gib(dev)
        if key == "chunk":
            e_ch, g_ch = eg
    res["binned_emt_chunk"], _ = mmf_block(
        f"binned_emt_chunk{LARGE_CHUNK}", emt_c, xe, ce, 0, dev)
    d = {"card_vs_cpu_energy_rel": abs(float(e_card) - float(e_cpu))
         / abs(float(e_cpu)),
         "card_vs_cpu_grad_abs": float((g_card.cpu() - g_cpu).abs().max()),
         "chunk_vs_full_energy_rel": abs(float(e_ch) - float(e_card))
         / abs(float(e_card)),
         "chunk_vs_full_grad_rel": float((g_ch - g_card).abs().max()
                                         / g_card.abs().max()),
         **peaks}
    res["binned_emt_checks"] = d
    print(f"  13a BinnedEMT: {json.dumps(d)}", flush=True)
    if not (d["card_vs_cpu_energy_rel"] < LARGE_EMT_E_RTOL
            and d["card_vs_cpu_grad_abs"] < LARGE_EMT_G_ATOL):
        raise AssertionError("13a: BinnedEMT on the card disagrees with "
                             "the CPU")
    if not (d["chunk_vs_full_energy_rel"] < CHUNK_RTOL
            and d["chunk_vs_full_grad_rel"] < CHUNK_RTOL):
        raise AssertionError("13a: chunked BinnedEMT is another function")
    if torch.device(dev).type == "cuda" and not (
            peaks["hvp_chunk_gib"] < peaks["hvp_full_gib"]):
        raise AssertionError("13a: chunk did not lower the HVP's peak")
    del emt_c, cpu

    ml64 = MLPotential(z, xe, ce, rc=4.5, capacity=24,
                       params=MLPotential.params_from_npz(WEIGHTS_CU_EMT))
    ml = F32Potential(ml64)
    res["mlff_f32"], _ = mmf_block("mlff_f32_order1", ml, xe, ce, 1, dev)
    ml64 = ml64.to(dev)
    g64 = ml64.grad(xt, ct)
    g64_rounded = ml64.grad(xt.float().double(), ct)
    g32 = ml.grad(xt, ct)
    scale = float(g64.abs().max())
    err = float((g32 - g64).abs().max())
    tol = MLFF_F32_ATOL * max(scale, 1.0) * max(
        1.0, float(np.abs(xe).max()) / MLFF_F32_BOX)
    _peak_reset(dev)
    ml64.hvp(xt, v, ct)
    peak64 = _peak_gib(dev)
    _peak_reset(dev)
    ml.hvp(xt, v, ct)
    peak32 = _peak_gib(dev)
    d = {"f32_vs_f64_force_abs": err, "tolerance": tol,
         "force_scale": scale,
         "f32_vs_f64_rounded_force_abs": float((g32 - g64_rounded).abs()
                                               .max()),
         "f64_rounded_vs_x0_force_abs": float((g64_rounded - g64).abs()
                                              .max()),
         "hvp_peak_f32_gib": peak32, "hvp_peak_f64_gib": peak64}
    res["mlff_checks"] = d
    print(f"  13a MLFF: {json.dumps(d)}", flush=True)
    if not err < tol:
        raise AssertionError("13a: float32 MLFF forces disagree")
    return res


def run_largescale_held(dev="cuda:0"):
    """Phase 13b: three runs held to the JAX package's (counts within 5%,
    final energy within 1e-5 eV)."""
    from sella_tpu_torch.parallel.largescale import (drive_mmf,
                                                     make_mmf_step, mmf_init,
                                                     run_mmf)
    from sella_tpu_torch.potentials import EMT, BinnedEMT, LennardJones

    if JAX_LARGESCALE_REF is None or \
            JAX_LARGESCALE_REF["size"] != LARGESCALE_RUNS:
        raise AssertionError("no JAX reference at LARGESCALE_RUNS; rerun "
                             "tools/jax_reference_counts.py --only "
                             "largescale")
    res = {}
    for name, cfg in LARGESCALE_RUNS.items():
        kw = {k: cfg[k] for k in ("order", "fmax", "max_move", "max_steps")}
        t = time.perf_counter()
        if name == "lj7_saddle":
            x0, v0 = lj7_start()
            pot = LennardJones()
            step = make_mmf_step(pot, None, **{
                k: kw[k] for k in ("order", "fmax", "max_move")})
            st = mmf_init(pot, x0, device=dev)._replace(
                mode=torch.as_tensor(v0, device=dev))
            st = drive_mmf(step, st, kw["max_steps"])
        else:
            x0, cell = rattled_slab(name)
            z = [29] * (x0.size // 3)
            pot = EMT(z, pbc=True) if name == "cu_slab_min" \
                else BinnedEMT(z, x0, cell)
            st = run_mmf(pot.to(dev), x0, cell=cell, device=dev, **kw)
        _sync_for(dev)()
        out = {"converged": bool(st.converged), "nsteps": int(st.nsteps),
               "neval": int(st.neval), "nmatvec": int(st.nmatvec),
               "energy": float(st.f), "lam": float(st.lam),
               "wall_s": time.perf_counter() - t}
        ref = JAX_LARGESCALE_REF[name]
        print(f"  13b {name}: {json.dumps(out)} JAX {json.dumps(ref)}",
              flush=True)
        if not out["converged"]:
            raise AssertionError(f"13b {name} did not converge")
        for k in ("nsteps", "neval", "nmatvec"):
            if abs(out[k] - ref[k]) > LARGESCALE_COUNTS_RTOL * ref[k]:
                raise AssertionError(f"13b {name} {k} = {out[k]} is more "
                                     f"than 5% from JAX's {ref[k]}")
        if abs(out["energy"] - ref["energy"]) > LARGESCALE_E_ATOL:
            raise AssertionError(f"13b {name} energy {out['energy']} vs "
                                 f"JAX {ref['energy']}")
        if cfg["order"] == 1 and not out["lam"] < 0:
            raise AssertionError(f"13b {name}: lam {out['lam']} >= 0")
        res[name] = out
    return res


# ---------------------------------------------------------------------------
# phase 14: the internal+cell tier
# ---------------------------------------------------------------------------
# 14a: phase 10's system (bench.py:1085-1096, BASELINE config 3) in
# internal coordinates + cell, at CELL_INT_SIZE lanes. Cut from phase 10's
# 512 for time: every step runs the full-Newton back-transform to its 20
# iterations (the residual of a redundant-internal target stalls above
# newton_tol), each with a float64 (B, 192, 192) Gram eigh on cuSOLVER,
# ~1.5 ms a matrix, and the slowest lane needs ~220 steps
CELL_INT_SIZE = {"batch": 8, "max_steps": 250}
CELL_INT_COUNTS = ("mean_steps_converged", "mean_force_calls")
CELL_INT_COUNTS_RTOL = 0.05
# 14b: the other entry points on the configs of
# tests/test_cell_internal_events.py and tests/test_ensemble_cell_internal.py
# at a step cap each (cut for time: the Niggli run's lanes need 153 and
# 196 steps there), held to the JAX package's runs of the same caps lane by
# lane: steps, force calls and converged flags equal, energies within
# CELL_INT_F_ATOL
CELL_INT_EVENTS = {"niggli_steps": 30, "repave_steps": 60,
                   "queue_total": 4, "queue_batch": 2, "queue_steps": 10,
                   "rigid_steps": 10}
CELL_INT_F_ATOL = 1e-6
# the JAX package at the sizes above (tools/jax_reference_counts.py, CPU)
JAX_CELL_INT_REF = {
    "headline": {"size": {"batch": 8, "max_steps": 250},
                 "converged_frac": 1.0,
                 "mean_steps_converged": 148.125,
                 "mean_force_calls": 149.125, "steps_run": 220},
    "events": {
        "size": {"niggli_steps": 30, "repave_steps": 60, "queue_total": 4,
                 "queue_batch": 2, "queue_steps": 10, "rigid_steps": 10},
        "niggli": {"nsteps": [30, 30], "neval": [31, 32],
                   "converged": [False, False],
                   "f": [-103.47293447561033, -103.45065802359201]},
        "repave": {"nsteps": [12, 46], "neval": [13, 47],
                   "converged": [True, True],
                   "f": [-5.967123348901013, -5.967123349033134]},
        "queue": {"nsteps": [10, 10, 10, 10],
                  "converged": [False, False, False, False],
                  "f": [-219.66692486803487, -219.5741608950356,
                        -219.26652838628527, -218.8831513263739]},
        "rigid": {"nsteps": [10, 10], "neval": [11, 11],
                  "converged": [False, False],
                  "f": [0.19422328867046396, 0.2523624943719858]}}}


def cell_int_setup(batch):
    """14a: phase 10's bulk Cu EMT system (``cell_setup``) with its
    redundant-internal topology: every bond at the default scale (192
    with the periodic images), nz = 192 + 9."""
    from sella_tpu_torch import Internals
    from sella_tpu_torch.potentials import fcc_bulk

    pot, x0, s0, cell0, nat = cell_setup(batch)
    ints = Internals(fcc_bulk("Cu", 3.59 * 1.03, reps=(2, 2, 2)))
    ints.find_all_bonds()
    return pot, ints, x0, s0, cell0, nat


def cell_int_config(ints):
    """14a's config: order 0, fmax 1e-3, the full cell mask, the JAX
    package's defaults otherwise."""
    from sella_tpu_torch import CellInternalEnsembleConfig

    return CellInternalEnsembleConfig(natoms=ints.natoms, nint=ints.nint,
                                      ncell=9, order=0, fmax=1e-3)


def _hold_counts(name, stats, ref_all, size, keys, rtol):
    if ref_all is None or ref_all[name]["size"] != size:
        raise AssertionError(f"no JAX reference for {name} at {size}; rerun "
                             "tools/jax_reference_counts.py")
    ref = ref_all[name]
    for k in keys:
        if abs(stats[k] - ref[k]) > rtol * ref[k]:
            raise AssertionError(f"{name} {k} = {stats[k]} is more than "
                                 f"{rtol:.0%} from JAX's {ref[k]}")


def run_cell_internal_headline(dev="cuda:0", batch=CELL_INT_SIZE["batch"],
                               max_steps=CELL_INT_SIZE["max_steps"],
                               cell_stats=None):
    """14a: the bench's atom+cell system in internal coordinates + cell,
    ``make_cell_internal_step_fn`` driven until every lane converges (a
    convergence read every 10 steps, as ``run_cell_internal_ensemble``
    with ``steps_per_call=10``), with the Gram eigh's, the Newton
    back-transform's and the restricted step's CUDA-event times and the
    Newton iterations and host syncs per step."""
    import sella_tpu_torch.parallel.ensemble_internal as TE
    from sella_tpu_torch.parallel import ensemble_cell_internal as TC

    dev = torch.device(dev)
    pot, ints, x0, s0, cell0, nat = cell_int_setup(batch)
    cfg = cell_int_config(ints)
    pot = pot.to(dev)
    sync = _sync_for(dev)
    step = TC.make_cell_internal_step_fn(pot, ints, cfg)
    state = TC.init_cell_internal_state(pot, ints, x0, cfg, cell0, s0=s0,
                                        device=dev)
    TE.SPANS = {} if dev.type == "cuda" else None
    sync()
    t = time.perf_counter()
    steps = 0
    try:
        while steps < max_steps:
            for _ in range(min(10, max_steps - steps)):
                state = step(state)
                steps += 1
            if bool(state.converged.all()):
                break
        sync()
        wall = time.perf_counter() - t
        spans = TE.span_ms(TE.SPANS) if TE.SPANS is not None else {}
    finally:
        TE.SPANS = None
    for name, tns in zip(state._fields, state):
        if tns.device != dev:
            raise AssertionError(f"cell-internal state.{name} is on "
                                 f"{tns.device}")
        if tns.is_floating_point() and not bool(torch.isfinite(tns).all()):
            raise AssertionError(f"cell-internal state.{name} is not finite")
    conv = state.converged
    nconv = int(conv.sum())
    cells = TC.realized_cells(state, cfg)[conv].cpu().numpy()
    lat = np.linalg.norm(cells, axis=2) / 2.0       # 2x2x2 supercell
    ortho = cells @ np.swapaxes(cells, 1, 2)
    off = np.abs(ortho - ortho * np.eye(3)).max(axis=(1, 2))
    stats = {
        "batch": batch, "nint": cfg.nint, "nz": cfg.nz,
        "converged_frac": nconv / batch, "steps_run": steps,
        "mean_steps_converged": (float(state.nsteps[conv].double().mean())
                                 if nconv else None),
        "mean_force_calls": float(state.neval.double().mean()),
        "wall_s": wall, "s_per_step": wall / max(steps, 1),
        "searches_per_s": nconv / wall,
        "newton_iters_per_step": step.newton_iters / max(steps, 1),
        "host_syncs_per_step": step.host_syncs / max(steps, 1),
        "span_ms_per_step": {k: v / max(steps, 1) for k, v in spans.items()},
        "span_share": {k: v / (1e3 * wall) for k, v in spans.items()},
        "lattice_max_dev": (float(np.abs(lat - CELL_LATTICE_A).max())
                            if nconv else None),
        "offdiag_CCt_max": float(off.max()) if nconv else None,
    }
    if cell_stats is not None:
        stats["cartesian_cell_phase10"] = {
            k: cell_stats.get(k) for k in ("batch", "mean_steps_converged",
                                           "mean_force_calls", "s_per_step")}
    if dev.type == "cuda":
        stats["card"] = _card()
    print(json.dumps(stats), flush=True)
    if stats["converged_frac"] < CONV_FRAC_MIN:
        raise AssertionError(f"14a converged_frac {stats['converged_frac']} "
                             f"< {CONV_FRAC_MIN}")
    if not (stats["lattice_max_dev"] < 0.01
            and stats["offdiag_CCt_max"] < 0.05):
        raise AssertionError("a relaxed 14a cell misses the EMT lattice: "
                             f"{stats['lattice_max_dev']}, "
                             f"{stats['offdiag_CCt_max']}")
    _hold_counts("headline", stats, JAX_CELL_INT_REF,
                 {"batch": batch, "max_steps": max_steps}, CELL_INT_COUNTS,
                 CELL_INT_COUNTS_RTOL)
    return stats


R0_LJ = 2.0 ** (1.0 / 6.0)


def ci_lj_bulk(total, seed=0, a0=1.55, rattle=0.02, cell_scale=0.02):
    """The LJ bulk of tests/test_ensemble_cell_internal.py:23-36: fcc
    2x2x2 at a0 = 1.55, ``total`` starts rattled by ``rattle`` and cell
    parameters drawn at ``cell_scale`` from RandomState(seed). Returns
    (positions, cell, x0, s0), numpy."""
    from sella_tpu_torch.potentials import fcc_bulk

    atoms = fcc_bulk("Cu", a0, reps=(2, 2, 2))
    rng = np.random.RandomState(seed)
    x0 = np.stack([(atoms.positions + rattle * rng.normal(
        size=atoms.positions.shape)).ravel() for _ in range(total)])
    s0 = cell_scale * rng.normal(size=(total, 9))
    return atoms.positions, np.asarray(atoms.cell), x0, s0


def ci_event_setups():
    """14b's four runs as numpy data (the JAX reference builds its own
    topologies from the same numbers): name -> dict of symbols,
    positions, cell, discovery, x0, s0, mask, potential keywords, config
    keywords and run keywords."""
    ev = CELL_INT_EVENTS
    shear = np.zeros((3, 3))
    shear[1, 0] = 32.0                 # factor * logm of the unit shear
    pos, cell, _, _ = ci_lj_bulk(1)
    xn = (pos + 0.01 * np.random.RandomState(0).normal(
        size=pos.shape)).ravel()
    tet = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                    [0.5, np.sqrt(3.0) / 2.0, 0.0],
                    [0.5, np.sqrt(3.0) / 6.0, np.sqrt(2.0 / 3.0)]]) * R0_LJ
    th = np.radians(0.2)
    b = np.array([R0_LJ, 0.0, 0.0])
    near_linear = np.stack([np.zeros(3), b, b + R0_LJ * np.array(
        [np.cos(th), np.sin(th), 0.0]), np.array([R0_LJ, 0.75 * R0_LJ,
                                                  0.6 * R0_LJ])])
    off = np.array([4.0, 4.0, 4.0])
    rng = np.random.RandomState(0)
    xr = np.stack([(tet + off).ravel() + 0.05 * rng.normal(size=12),
                   (near_linear + off).ravel()])
    _, _, xq, sq = ci_lj_bulk(ev["queue_total"])
    dimer = np.array([[2.0, 2.0, 2.0], [2.0, 2.0, 4.0],
                      [7.0, 5.5, 3.0], [7.0, 7.5, 3.0]])
    rng = np.random.RandomState(3)
    xd = np.stack([dimer.ravel(), dimer.ravel() + 0.05 * rng.normal(
        size=12)])
    sd = 0.02 * rng.normal(size=(2, 9))
    lj_cfg = dict(order=0, fmax=5e-3, delta0=0.1, h0_cell=10.0)
    return {
        "niggli": dict(symbols=["Cu"] * 32, positions=pos, cell=cell,
                       pbc=True, bonds_scale=0.43, kinds=("bonds",),
                       x0=np.stack([xn, xn]),
                       s0=np.stack([np.zeros(9), shear.ravel()]),
                       mask=None, pot=dict(rc=1.4), cfg=lj_cfg,
                       run=dict(max_steps=ev["niggli_steps"],
                                steps_per_call=5, niggli=True)),
        "repave": dict(symbols=["He"] * 4, positions=tet + off,
                       cell=np.eye(3) * 12.0, pbc=True, bonds_scale=None,
                       kinds=("bonds", "angles", "dihedrals"), x0=xr,
                       s0=None, mask=np.eye(3, dtype=bool),
                       pot=dict(rc=3.0),
                       cfg=dict(nproj=6, order=0, fmax=1e-3, h0_cell=10.0),
                       run=dict(max_steps=ev["repave_steps"], repave=True)),
        "queue": dict(symbols=["Cu"] * 32, positions=pos, cell=cell,
                      pbc=True, bonds_scale=0.43, kinds=("bonds",), x0=xq,
                      s0=sq, mask=None, pot={}, cfg=lj_cfg,
                      run=dict(batch=ev["queue_batch"],
                               max_steps_per_search=ev["queue_steps"],
                               refill_every=5)),
        "rigid": dict(symbols=["Ar"] * 4, positions=dimer,
                      cell=np.eye(3) * 12.0, pbc=True, bonds_scale=None,
                      kinds=("bonds", "angles", "dihedrals"),
                      fragments=True, x0=xd, s0=sd, mask=None,
                      pot=dict(epsilon=0.0104, sigma=3.4),
                      cfg=dict(rigid_fragments=True, h0_cell=10.0),
                      run=dict(max_steps=ev["rigid_steps"])),
    }


def ci_event_ints(setup, Atoms, Internals):
    """The topology of a 14b setup, built with either package's classes."""
    at = Atoms(setup["symbols"], setup["positions"], cell=setup["cell"],
               pbc=setup["pbc"])
    ints = Internals(at, allow_fragments=setup.get("fragments", False))
    if setup["bonds_scale"] is None:
        ints.find_all_bonds()
    else:
        ints.find_all_bonds(scale=setup["bonds_scale"])
    if "angles" in setup["kinds"]:
        ints.find_all_angles()
    if "dihedrals" in setup["kinds"]:
        ints.find_all_dihedrals()
    return ints


def _event_result(st):
    return {"nsteps": st.nsteps.tolist(), "neval": st.neval.tolist(),
            "converged": st.converged.tolist(), "f": st.f.tolist()}


def run_cell_internal_entry_points(dev="cuda:0"):
    """14b: ``run_cell_internal_ensemble`` with its Niggli rebase (a lane
    started in the 45-degree-sheared representation) and its repave (a
    near-linear lane), ``run_cell_internal_ensemble_queue`` and one
    ``rigid_fragments=True`` run, each held lane by lane to the JAX
    package's run of the same size."""
    from sella_tpu_torch import Atoms, Internals, LennardJones
    from sella_tpu_torch.parallel import ensemble_cell_internal as TC

    dev = torch.device(dev)
    sync = _sync_for(dev)
    out = {}
    for name, su in ci_event_setups().items():
        ints = ci_event_ints(su, Atoms, Internals)
        pot = LennardJones(pbc=True, **su["pot"]).to(dev)
        ncell = 9 if su["mask"] is None else int(su["mask"].sum())
        cfg = TC.CellInternalEnsembleConfig(natoms=len(su["symbols"]),
                                            nint=ints.nint, ncell=ncell,
                                            **su["cfg"])
        sync()
        t = time.perf_counter()
        if name == "queue":
            res = TC.run_cell_internal_ensemble_queue(
                pot, ints, su["x0"], cfg, su["cell"], s0_all=su["s0"],
                device=dev, **su["run"])
            r = {"nsteps": [q["nsteps"] for q in res],
                 "converged": [q["converged"] for q in res],
                 "f": [q["f"] for q in res]}
        else:
            st = TC.run_cell_internal_ensemble(
                pot, ints, su["x0"], cfg, su["cell"], cell_mask=su["mask"],
                s0=su["s0"], device=dev, **su["run"])
            if su["run"].get("niggli") or su["run"].get("repave"):
                st, ints_fin = st
                r = _event_result(st)
                r["nint_final"] = ints_fin.nint
                r["qact_off"] = int((~st.qact).sum())
                if name == "niggli":
                    c0 = st.cell0.cpu().numpy()
                    r["rebased"] = [bool(_angle_dev(c) < 5.0) for c in c0]
            else:
                r = _event_result(st)
        sync()
        r["wall_s"] = time.perf_counter() - t
        if not np.all(np.isfinite(r["f"])):
            raise AssertionError(f"14b {name}: non-finite energies")
        out[name] = r
    print(json.dumps({"cell_internal_events": out}), flush=True)
    if JAX_CELL_INT_REF is None or \
            JAX_CELL_INT_REF["events"]["size"] != CELL_INT_EVENTS:
        raise AssertionError("no JAX reference for 14b at "
                             f"{CELL_INT_EVENTS}; rerun "
                             "tools/jax_reference_counts.py")
    for name, r in out.items():
        ref = JAX_CELL_INT_REF["events"][name]
        for k in ("nsteps", "neval", "converged"):
            if k in ref and r[k] != ref[k]:
                raise AssertionError(f"14b {name} {k} {r[k]} != JAX's "
                                     f"{ref[k]}")
        df = float(np.abs(np.array(r["f"]) - np.array(ref["f"])).max())
        if df > CELL_INT_F_ATOL:
            raise AssertionError(f"14b {name}: energies {df} eV from JAX's")
    if out["niggli"]["rebased"] != [True, True]:
        raise AssertionError("14b: the sheared lane was not rebased")
    if out["repave"]["qact_off"] == 0:
        raise AssertionError("14b: the near-linear lane was not repaved")
    return out


# ---------------------------------------------------------------------------
# phase 15: batched IRC
# ---------------------------------------------------------------------------
# 15a: the first IRC_TS converged transition states of phase 4's jacobi
# headline, both directions, through one IRC_BATCH-lane queue (the
# defaults of IRCEnsembleConfig otherwise: dx 0.1, fmax 0.05)
IRC_TS = 128
IRC_BATCH = 256
IRC_CONV_MIN = 0.95
IRC_CPU_TS = 8
IRC_X_ATOL = 1e-6
CU_MASS = 63.546
# 15b: examples/04_irc_pipeline.py at its full size, from the JAX run's
# transition states (tools/irc_lj4_ts.npz), held to the JAX package's
# queue: steps, force calls and converged flags equal, endpoint energies
# within IRC_PIPE_F_ATOL
IRC_PIPE_F_ATOL = 1e-8
IRC_PIPE_TS_FILE = "tools/irc_lj4_ts.npz"
JAX_IRC_REF = {"nsteps": [17, 17, 17, 17, 17, 17, 17, 17],
               "neval": [77, 79, 73, 76, 85, 75, 74, 70],
               "converged": [True] * 8,
               "f": [-5.999999984346555,
                     -5.999999567994307,
                     -5.999999947582844,
                     -5.999999100960313,
                     -5.999999937897373,
                     -5.999999956765527,
                     -5.999999964739195,
                     -5.9999999901536984]}


def _exact_lam0(pot, cell_t, xs, nproj):
    """Leftmost eigenvalue of each endpoint's exact rigid-projected
    Hessian (HVPs along every unit vector)."""
    from torch.func import grad, jvp, vmap

    from sella_tpu_torch.parallel.ensemble import free_basis

    d = xs.shape[1]
    eye = torch.eye(d, dtype=xs.dtype, device=xs.device)

    def hess(x):
        return vmap(lambda u: jvp(lambda y: grad(pot.energy)(y, cell_t),
                                  (x,), (u,))[1])(eye)

    H = vmap(hess)(xs)
    U = free_basis(xs, nproj)
    Hp = U.transpose(1, 2) @ (0.5 * (H + H.transpose(1, 2))) @ U
    return torch.linalg.eigvalsh(Hp)[:, 0]


def run_irc_headline(jac_state, dev="cuda:0", nts=IRC_TS, batch=IRC_BATCH,
                     cpu_ts=IRC_CPU_TS):
    """15a: ``run_irc_ensemble_queue(directions="both")`` from the first
    ``nts`` converged lanes (x, B) of phase 4's final state on the
    headline slab, with Cu masses and ``nproj=3``; the first ``cpu_ts``
    transition states' paths run again on the CPU."""
    import sella_tpu_torch.parallel.ensemble_internal as TE
    import sella_tpu_torch.parallel.ensemble_irc as TI
    from sella_tpu_torch import IRCEnsembleConfig, run_irc_ensemble_queue

    dev = torch.device(dev)
    pot, _, cell, nat = headline_setup(1)
    sel = torch.where(jac_state.converged)[0][:nts].cpu()
    if len(sel) < nts:
        raise AssertionError(f"phase 4 converged only {len(sel)} lanes")
    x_ts = jac_state.x[sel].to(dev)
    H_ts = jac_state.B[sel].to(dev)
    f_ts = jac_state.f[sel].cpu().numpy()
    cfg = IRCEnsembleConfig(natoms=nat, nproj=3)
    masses = np.full(nat, CU_MASS)
    pot_d = pot.to(dev)
    cell_d = torch.as_tensor(cell, device=dev)
    sync = _sync_for(dev)
    # count the queue's outer-step calls
    make_step = TI.make_irc_step_fn
    calls = []

    def counted(*a, **k):
        step = make_step(*a, **k)

        def run(state, generator=None):
            calls.append(1)
            return step(state)

        return run

    TE.SPANS = {} if dev.type == "cuda" else None
    TI.make_irc_step_fn = counted
    sync()
    t = time.perf_counter()
    try:
        res = run_irc_ensemble_queue(pot_d, x_ts, H_ts, cfg, masses, batch,
                                     directions="both", cell=cell_d)
        sync()
        wall = time.perf_counter() - t
        spans = TE.span_ms(TE.SPANS) if TE.SPANS is not None else {}
    finally:
        TE.SPANS = None
        TI.make_irc_step_fn = make_step
    xs = np.stack([r["x"] for r in res])
    fs = np.array([r["f"] for r in res])
    conv = np.array([r["converged"] for r in res])
    nsteps = np.array([r["nsteps"] for r in res])
    outer_steps = len(calls)
    lam0 = _exact_lam0(pot_d, cell_d, torch.as_tensor(xs[conv], device=dev),
                       3).cpu().numpy()
    ts_f = np.repeat(f_ts, 2)
    t = time.perf_counter()
    res_cpu = run_irc_ensemble_queue(
        headline_setup(1)[0], jac_state.x[sel[:cpu_ts]].cpu(),
        jac_state.B[sel[:cpu_ts]].cpu(),
        cfg, masses, 2 * cpu_ts, directions="both",
        cell=torch.as_tensor(cell))
    t_cpu = time.perf_counter() - t
    dx_cpu = max(float(np.abs(a["x"] - b["x"]).max())
                 for a, b in zip(res_cpu, res))
    same_steps = all(a["nsteps"] == b["nsteps"] for a, b in zip(res_cpu, res))
    stats = {
        "paths": len(res), "batch": batch, "wall_s": wall,
        "converged_frac": float(conv.mean()),
        "inner_fail": int(sum(r["inner_fail"] for r in res)),
        "mean_steps": float(nsteps.mean()), "max_steps": int(nsteps.max()),
        "mean_force_calls": float(np.mean([r["neval"] for r in res])),
        "outer_step_calls": outer_steps,
        "s_per_step": wall / max(outer_steps, 1),
        "paths_per_s": len(res) / wall,
        "eigh_ms_per_step": (spans.get("irc_eigh", 0.0)
                             / max(outer_steps, 1) if spans else None),
        "eigh_share": (spans.get("irc_eigh", 0.0) / (1e3 * wall)
                       if spans else None),
        "exact_lam0_min": float(lam0.min()) if len(lam0) else None,
        "endpoint_minus_ts_max": float((fs - ts_f).max()),
        "cpu_paths": len(res_cpu), "cpu_wall_s": t_cpu,
        "cpu_x_max_dev": dx_cpu, "cpu_same_nsteps": same_steps,
    }
    if dev.type == "cuda":
        stats["card"] = _card()
    print(json.dumps(stats), flush=True)
    if not np.all(np.isfinite(xs)) or not np.all(np.isfinite(fs)):
        raise AssertionError("15a: a path is not finite")
    if stats["converged_frac"] < IRC_CONV_MIN:
        raise AssertionError(f"15a converged_frac {stats['converged_frac']}"
                             f" < {IRC_CONV_MIN}")
    if not lam0.min() > 0:
        raise AssertionError(f"15a: an endpoint's leftmost rigid-free "
                             f"eigenvalue is {lam0.min()}")
    if not stats["endpoint_minus_ts_max"] < 0:
        raise AssertionError("15a: an endpoint lies above its TS")
    if not (same_steps and dx_cpu < IRC_X_ATOL):
        raise AssertionError(f"15a: the CPU run differs ({dx_cpu} A, same "
                             f"steps {same_steps})")
    return stats


def irc_pipeline_inputs():
    """15b's transition states: the JAX run of
    examples/04_irc_pipeline.py's saddle stage (its first four converged
    lanes' x and H), from IRC_PIPE_TS_FILE."""
    import os

    d = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             IRC_PIPE_TS_FILE))
    sel = d["sel"]
    return d["x"][sel], d["H"][sel]


def irc_pipeline_config():
    """examples/04_irc_pipeline.py's IRC stage."""
    return {"cfg": dict(natoms=4, fmax=1e-2, dx=0.4),
            "masses": np.full(4, 39.948), "batch": 4}


def run_irc_pipeline_held(dev="cuda:0"):
    """15b: the example's IRC stage on the card, held to the JAX package's
    queue on the same transition states."""
    from sella_tpu_torch import IRCEnsembleConfig, LennardJones, \
        run_irc_ensemble_queue

    dev = torch.device(dev)
    x_ts, H_ts = irc_pipeline_inputs()
    pc = irc_pipeline_config()
    res = run_irc_ensemble_queue(LennardJones().to(dev), x_ts, H_ts,
                                 IRCEnsembleConfig(**pc["cfg"]),
                                 pc["masses"], pc["batch"],
                                 directions="both", device=dev)
    out = {k: [r[k] for r in res] for k in ("nsteps", "neval", "converged",
                                             "f")}
    print(json.dumps({"irc_pipeline": out, "jax": JAX_IRC_REF}), flush=True)
    if JAX_IRC_REF is None:
        raise AssertionError("no JAX reference for 15b; rerun "
                             "tools/jax_reference_counts.py")
    for k in ("nsteps", "neval", "converged"):
        if out[k] != JAX_IRC_REF[k]:
            raise AssertionError(f"15b {k} {out[k]} != JAX's "
                                 f"{JAX_IRC_REF[k]}")
    df = float(np.abs(np.array(out["f"]) - np.array(JAX_IRC_REF["f"])).max())
    if df > IRC_PIPE_F_ATOL:
        raise AssertionError(f"15b: endpoint energies {df} eV from JAX's")
    return out


# ---------------------------------------------------------------------------
# phase 16: the heterogeneous queue
# ---------------------------------------------------------------------------
# 16a: examples/09_heterogeneous_sweep.py's interleaved LJ4 + LJ7 draws
# (RandomState(0)), HETERO_SIZE["per_kind"] of each, order 0, through
# HETERO_SIZE["batch"]-lane queues with prfo_eigh="jacobi"; held per
# bucket to the JAX package's run (prfo_eigh="eigh") of the same size.
# Cut for time from 512 + 512 starts (43x the example's 24 jobs) through
# 256 lanes, 300 steps a search, to half the starts and half the lanes (2
# searches a lane, so each bucket's queue refills) and 150 steps: the
# LJ7 bucket's slowest searches set the wall, and phase 16 has 50 s
HETERO_SIZE = {"per_kind": 256, "batch": 128, "refill_every": 10,
               "max_steps_per_search": 150}
HETERO_CONV_ATOL = 0.04
HETERO_COUNTS_RTOL = 0.05
JAX_HETERO_REF = {
    "size": {"per_kind": 256, "batch": 128, "refill_every": 10,
             "max_steps_per_search": 150},
    "LJ4": {"n": 256, "converged_frac": 1.0,
            "mean_steps_converged": 20.76953125,
            "mean_force_calls": 21.76953125},
    "LJ7": {"n": 256, "converged_frac": 0.90625,
            "mean_steps_converged": 70.80603448275862,
            "mean_force_calls": 79.23046875}}
# 16b: the example's internal campaign (Morse Xe4 + LJ He7) at its FAST
# size, 4 steps a search harvested every 4 (cut from 20 and 10 for time:
# two runs of three buckets, each an internal queue and its Cartesian
# spill, took 85.3 s on the card at 20 steps and 47.0 s at 8); the gate is
# the dispatch, bit for bit against each bucket's own queue, not
# convergence
HETERO_INT_SIZE = {"pairs": 2, "batch": 6, "max_steps_per_search": 4,
                   "refill_every": 4}


def lj_clusters():
    """The example's LJ4 tetrahedron and LJ7 pentagonal bipyramid."""
    tet = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                    [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * 1.12
    rstar = 2.0 ** (1.0 / 6.0)
    ring_r = rstar / (2.0 * np.sin(np.pi / 5.0))
    apex_z = np.sqrt(rstar ** 2 - ring_r ** 2)
    ang = 2.0 * np.pi * np.arange(5) / 5.0
    pbp = np.vstack([np.stack([ring_r * np.cos(ang), ring_r * np.sin(ang),
                               np.zeros(5)], axis=1),
                     [[0.0, 0.0, apex_z]], [[0.0, 0.0, -apex_z]]])
    return tet, pbp


def hetero_jobs(per_kind, rng=None):
    """examples/09_heterogeneous_sweep.py:47-50: interleaved LJ4 and LJ7
    starts, ``per_kind`` of each."""
    tet, pbp = lj_clusters()
    rng = np.random.RandomState(0) if rng is None else rng
    jobs = []
    for _ in range(per_kind):
        jobs.append((tet + 0.12 * rng.normal(size=(4, 3))).ravel())
        jobs.append((pbp + 0.2 * rng.normal(size=(7, 3))).ravel())
    return jobs


def hetero_config_kw():
    return dict(order=0, fmax=1e-3)


def _bucket_stats(results, jobs):
    out = {}
    for tag, nat in (("LJ4", 4), ("LJ7", 7)):
        sel = [r for r, x in zip(results, jobs) if len(x) == 3 * nat]
        conv = np.array([bool(r[3]) for r in sel])
        out[tag] = {
            "n": len(sel), "converged_frac": float(conv.mean()),
            "mean_steps_converged": float(np.mean(
                [r[2] for r, c in zip(sel, conv) if c])),
            "mean_force_calls": float(np.mean([r[5] for r in sel])),
        }
    return out


def run_hetero_campaign(dev="cuda:0", size=None):
    """16a: ``run_heterogeneous_queue`` on the example's interleaved
    LJ4/LJ7 campaign with ``prfo_eigh="jacobi"`` (the hand-written kernel
    at n = 6 and 15 through ``jacobi_eigh_any``); gated on at least one
    refill in each bucket."""
    import sella_tpu_torch.parallel.ensemble as ens
    from sella_tpu_torch import LennardJones, run_heterogeneous_queue
    from sella_tpu_torch.ops.jacobi_eigh import jacobi_eigh_cuda

    size = dict(HETERO_SIZE if size is None else size)
    dev = torch.device(dev)
    jobs = hetero_jobs(size["per_kind"])
    sync = _sync_for(dev)
    sync()
    jacobi_eigh_cuda.launches = 0
    t = time.perf_counter()
    with _Refills(ens, "refill_converged") as refills:
        res = run_heterogeneous_queue(
            LennardJones().to(dev), jobs, size["batch"],
            max_steps_per_search=size["max_steps_per_search"],
            refill_every=size["refill_every"], device=dev,
            prfo_eigh="jacobi", **hetero_config_kw())
    sync()
    wall = time.perf_counter() - t
    launches = jacobi_eigh_cuda.launches
    in_order = all(np.asarray(r[0]).shape == x.shape for r, x in
                   zip(res, jobs)) and len(res) == len(jobs)
    stats = {"jobs": len(jobs), "size": size, "wall_s": wall,
             "searches_per_s": sum(bool(r[3]) for r in res) / wall,
             "buckets": _bucket_stats(res, jobs), "in_order": in_order,
             "refills_by_dim": refills.by_dim,
             "jacobi_eigh_launches": launches}
    if dev.type == "cuda":
        stats["card"] = _card()
    print(json.dumps(stats), flush=True)
    if not in_order:
        raise AssertionError("16a: results are not in input order")
    if dev.type == "cuda" and launches == 0:
        raise AssertionError("16a never launched the Jacobi kernel")
    refills.require("16a", dims=(12, 21))
    if JAX_HETERO_REF is None or JAX_HETERO_REF["size"] != size:
        raise AssertionError(f"no JAX reference for 16a at {size}; rerun "
                             "tools/jax_reference_counts.py")
    for tag, b in stats["buckets"].items():
        ref = JAX_HETERO_REF[tag]
        if abs(b["converged_frac"] - ref["converged_frac"]) > \
                HETERO_CONV_ATOL:
            raise AssertionError(f"16a {tag} converged_frac "
                                 f"{b['converged_frac']} vs JAX "
                                 f"{ref['converged_frac']}")
        for k in ("mean_steps_converged", "mean_force_calls"):
            if abs(b[k] - ref[k]) > HETERO_COUNTS_RTOL * ref[k]:
                raise AssertionError(f"16a {tag} {k} = {b[k]} is more than "
                                     f"{HETERO_COUNTS_RTOL:.0%} from JAX's "
                                     f"{ref[k]}")
    return stats


def hetero_internal_jobs(pairs):
    """examples/09_heterogeneous_sweep.py's internal campaign at its FAST
    size: the example's RandomState(0) first draws its 4 + 4 Cartesian
    FAST starts, then ``pairs`` Morse Xe4 and LJ He7 starts. Returns
    (xe4 positions, he7 positions, [(kind, x0), ...])."""
    rng = np.random.RandomState(0)
    hetero_jobs(4, rng)
    xe4_pos = np.random.RandomState(4).normal(size=(4, 3), scale=3.0)
    _, pbp = lj_clusters()
    jobs = []
    for _ in range(pairs):
        jobs.append(("xe4", (xe4_pos + 0.3 * rng.normal(size=(4, 3))).ravel()))
        jobs.append(("he7", (pbp + 0.12 * rng.normal(size=(7, 3))).ravel()))
    return xe4_pos, pbp, jobs


def run_hetero_internal(dev="cuda:0", size=None):
    """16b: ``run_heterogeneous_internal_queue`` on the example's Morse Xe4
    + LJ He7 campaign; its buckets must be the topology signatures'
    grouping, its results in input order, and each equal bit for bit to
    the port's direct ``run_internal_ensemble_queue`` of its bucket."""
    from sella_tpu_torch import Atoms, InternalEnsembleConfig, \
        LennardJones, MorsePotential, run_heterogeneous_internal_queue, \
        run_internal_ensemble_queue
    from sella_tpu_torch.parallel.ensemble_internal import \
        fixed_internal_constraints
    from sella_tpu_torch.parallel import hetero
    from sella_tpu_torch.parallel.hetero import discover_internals, \
        internal_topology_signature
    from sella_tpu_torch.utils.units import kB

    size = dict(HETERO_INT_SIZE if size is None else size)
    dev = torch.device(dev)
    xe4_pos, pbp, spec = hetero_internal_jobs(size["pairs"])
    r0 = 4.73
    morse = MorsePotential(epsilon=226.9 * kB, r0=r0,
                           rho0=r0 * 1.099).to(dev)
    lj = LennardJones().to(dev)
    atoms = {"xe4": (morse, Atoms(["Xe"] * 4, xe4_pos)),
             "he7": (lj, Atoms(["He"] * 7, pbp))}
    jobs = [(atoms[k][0], atoms[k][1], x) for k, x in spec]
    cfg = InternalEnsembleConfig(natoms=1, nint=1, order=1, fmax=1e-3,
                                 gamma=1e-3)
    kw = dict(max_steps_per_search=size["max_steps_per_search"],
              refill_every=size["refill_every"], device=dev)
    sync = _sync_for(dev)
    # record the rows each bucket's queue is handed
    calls = []
    inner = hetero.run_internal_ensemble_queue

    def spy(pot, ints, x0, *a, **k):
        calls.append(np.asarray(x0))
        return inner(pot, ints, x0, *a, **k)

    hetero.run_internal_ensemble_queue = spy
    sync()
    t = time.perf_counter()
    try:
        res = run_heterogeneous_internal_queue(jobs, size["batch"], cfg=cfg,
                                               **kw)
    finally:
        hetero.run_internal_ensemble_queue = inner
    sync()
    wall = time.perf_counter() - t
    x_all = [np.asarray(j[2]) for j in jobs]
    used = [[next(i for i, x in enumerate(x_all)
                  if x.shape == row.shape and np.array_equal(x, row))
             for row in rows] for rows in calls]
    groups: dict = {}
    ints_of: dict = {}
    for i, (pot, at, x) in enumerate(jobs):
        ints = discover_internals(at, x)
        key = (id(pot), internal_topology_signature(ints))
        groups.setdefault(key, []).append(i)
        ints_of.setdefault(key, (pot, ints))
    same = True
    for key, idxs in groups.items():
        pot, ints = ints_of[key]
        bcfg = cfg._replace(natoms=ints.natoms, nint=ints.nint,
                            ndummies=ints.ndummies,
                            ncons=len(fixed_internal_constraints(ints)[0]))
        direct = run_internal_ensemble_queue(
            pot, ints, np.stack([jobs[i][2] for i in idxs]), bcfg,
            min(size["batch"], len(idxs)), **kw)
        for i, d in zip(idxs, direct):
            a = res[i]
            same &= (np.array_equal(a[0], d[0]) and a[1:] == d[1:])
    in_order = all(np.asarray(r[0]).shape == np.asarray(j[2]).shape
                   for r, j in zip(res, jobs))
    stats = {"jobs": len(jobs), "size": size, "wall_s": wall,
             "buckets": used, "signature_groups": list(groups.values()),
             "converged": [bool(r[3]) for r in res],
             "nsteps": [int(r[2]) for r in res], "in_order": in_order,
             "equal_to_direct_queues": bool(same)}
    print(json.dumps(stats), flush=True)
    if not in_order:
        raise AssertionError("16b: results are not in input order")
    if used != list(groups.values()):
        raise AssertionError(f"16b: buckets {used} are not the topology "
                             f"signatures' grouping {list(groups.values())}")
    if not same:
        raise AssertionError("16b: a result differs from its bucket's "
                             "direct queue")
    return stats


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on a GPU only")
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_all = time.perf_counter()
    t = time.perf_counter()
    phase_env()
    _phase("1 environment + build", t)

    t = time.perf_counter()
    kern = phase_kernel()
    _phase("2 kernel vs plain", t)

    t = time.perf_counter()
    phase_potential()
    _phase("3 potential", t)

    t = time.perf_counter()
    jac, jac_state = run_headline("jacobi", keep_state=True)
    if jac["jacobi_eigh_launches"] == 0:
        raise AssertionError("the jacobi headline never launched the kernel")
    for k, ref in JACOBI_COUNTS.items():
        if abs(jac[k] - ref) > COUNTS_RTOL * ref:
            raise AssertionError(f"jacobi headline {k} = {jac[k]} moved "
                                 f"from {ref}")
    _phase("4 headline, prfo_eigh=jacobi", t)

    t = time.perf_counter()
    print(f"cut: phase 5 runs {EIGH_HEADLINE_BATCH} lanes, not 1024",
          flush=True)
    eig = run_headline("eigh", batch=EIGH_HEADLINE_BATCH)
    print(json.dumps({"bench_r05_counts": BENCH_R05_COUNTS,
                      "eigh": {k: eig[k] for k in BENCH_R05_COUNTS},
                      "jacobi": {k: jac[k] for k in BENCH_R05_COUNTS}}))
    _phase("5 headline, prfo_eigh=eigh", t)

    t = time.perf_counter()
    print(f"cut: phase 6 runs {SERVED_TOTAL} starts through 1024 lanes, "
          "not 4096", flush=True)
    served = run_queue_headline(total=SERVED_TOTAL)
    _phase("6 served EMT headline, prfo_eigh=jacobi", t)

    t = time.perf_counter()
    print(f"cut: phase 7 runs {LJ4_SIZE}, not total 4096 with 4 tail "
          "retries", flush=True)
    lj4 = run_lj4_composite(**LJ4_SIZE)
    _phase("7 LJ4 composite queue", t)

    t = time.perf_counter()
    print(f"cut: phase 8 runs {CONSTRAINT_MAX_STEPS} steps, not 200",
          flush=True)
    run_constraints()
    _phase("8 constraints", t)

    t = time.perf_counter()
    run_checkpoint()
    _phase("9 checkpoint on the card", t)

    from sella_tpu_torch.ops.jacobi_eigh import jacobi_eigh_cuda

    t = time.perf_counter()
    cell = run_cell_headline()
    print(json.dumps({"cell": {k: cell[k] for k in BENCH_R04_CELL},
                      "bench_r04_cell": BENCH_R04_CELL}), flush=True)
    jacobi_eigh_cuda.launches = 0
    print(f"cut: phase 10b runs {CELL_ENTRY_SIZE}, not a queue of 256 "
          "inputs", flush=True)
    run_cell_entry_points(**CELL_ENTRY_SIZE)
    cell_launches = cell["jacobi_eigh_launches"] + jacobi_eigh_cuda.launches
    _phase("10 atom+cell tier", t)

    t = time.perf_counter()
    jacobi_eigh_cuda.launches = 0
    run_precision_split()
    print(f"cut: phase 11b runs emt151 at {EMT151_SIZE['batch']} lanes "
          f"(the bench's batch) for at most {EMT151_SIZE['max_steps']} "
          "steps, not 120", flush=True)
    run_emt151_pair(**EMT151_SIZE)
    split_launches = jacobi_eigh_cuda.launches
    _phase("11 precision split", t)

    t = time.perf_counter()
    jacobi_eigh_cuda.launches = 0
    run_internal_headline()
    _phase("12a internal tier, bench config", t)
    t12 = time.perf_counter()
    run_robust_gram()
    _phase("12b robust Gram eigh", t12)
    t12 = time.perf_counter()
    run_internal_repave_and_constraints()
    _phase("12c repave, dummies, constraints", t12)
    t12 = time.perf_counter()
    print(f"cut: phase 12d runs {INT_QUEUE_SIZE['total']} inputs through "
          f"{INT_QUEUE_SIZE['batch']} lanes, not 512",
          flush=True)
    run_internal_queue()
    _phase("12d served internal queue", t12)
    internal_launches = jacobi_eigh_cuda.launches
    _phase("12 internal tier", t)

    t = time.perf_counter()
    jacobi_eigh_cuda.launches = 0
    large = run_largescale_bench()
    _phase("13a large-system path, 10,000 atoms", t)
    t13 = time.perf_counter()
    held = run_largescale_held()
    _phase("13b large-system runs held to the JAX package", t13)
    large_launches = jacobi_eigh_cuda.launches
    t13 = time.perf_counter() - t
    _phase("13 large-system path", t)
    if t13 > PHASE13_MAX_S:
        raise AssertionError(f"phase 13 took {t13:.1f} s, over its "
                             f"{PHASE13_MAX_S} s")

    t = time.perf_counter()
    jacobi_eigh_cuda.launches = 0
    print(f"cut: phase 14a runs {CELL_INT_SIZE['batch']} lanes, not 64 "
          "(nor the 32 of the fallback): each step runs 20 full-Newton "
          "iterations with a (B, 192, 192) float64 Gram eigh each, ~1.5 ms "
          "a matrix on cuSOLVER, and the slowest lane needs ~220 steps",
          flush=True)
    ci = run_cell_internal_headline(cell_stats=cell)
    _phase("14a internal+cell tier, bench config", t)
    t14 = time.perf_counter()
    print(f"cut: phase 14b runs {CELL_INT_EVENTS} (step caps; the events "
          "tests run their lanes to convergence)", flush=True)
    run_cell_internal_entry_points()
    _phase("14b internal+cell entry points held to the JAX package", t14)
    ci_launches = jacobi_eigh_cuda.launches
    t14 = time.perf_counter() - t
    _phase("14 internal+cell tier", t)

    t = time.perf_counter()
    jacobi_eigh_cuda.launches = 0
    irc = run_irc_headline(jac_state)
    del jac_state
    _phase("15a batched IRC from the headline's transition states", t)
    t15 = time.perf_counter()
    run_irc_pipeline_held()
    _phase("15b IRC pipeline held to the JAX package", t15)
    irc_launches = jacobi_eigh_cuda.launches
    t15 = time.perf_counter() - t
    _phase("15 batched IRC", t)

    t = time.perf_counter()
    print(f"cut: phase 16a runs {HETERO_SIZE}, not 512 + 512 starts "
          "through 256 lanes, 300 steps a search", flush=True)
    hetero = run_hetero_campaign()
    hetero_launches = hetero["jacobi_eigh_launches"]
    _phase("16a heterogeneous Cartesian campaign", t)
    t16 = time.perf_counter()
    print(f"cut: phase 16b runs the example's FAST size, "
          f"{HETERO_INT_SIZE['max_steps_per_search']} steps a search, "
          f"harvested every {HETERO_INT_SIZE['refill_every']}", flush=True)
    run_hetero_internal()
    _phase("16b heterogeneous internal campaign", t16)
    t16 = time.perf_counter() - t
    _phase("16 heterogeneous queue", t)
    t_all = time.perf_counter() - t_all
    budgets = {ph: {"took_s": took, "budget_s": limit,
                    "within": took <= limit}
               for ph, took, limit in (("14", t14, PHASE14_MAX_S),
                                       ("15", t15, PHASE15_MAX_S),
                                       ("16", t16, PHASE16_MAX_S),
                                       ("1-16", t_all, PHASES_MAX_S))}
    print(f"[phase] 1-16 total: {t_all:.2f} s", flush=True)
    print(json.dumps({"phase_budgets": budgets}), flush=True)
    over = {ph: b for ph, b in budgets.items() if not b["within"]}
    if over:
        raise AssertionError(f"over budget: {over}")

    # phases 10-15 run no hand-written kernel (the cell tier's prep, the
    # emt151 config and the internal tier's Gram and prep eighs use
    # torch.linalg.eigh, as the JAX package does; the large-system path's
    # Lanczos eigh is (5, 5); the internal+cell tier's (B, 192, 192) Gram
    # and IRC's (B, 75, 75) eighs are float64 on torch.linalg.eigh); the
    # heterogeneous campaign's buckets (16a) run prfo_eigh="jacobi"
    launches = {"4": jac["jacobi_eigh_launches"],
                "6": served["jacobi_eigh_launches"],
                "10": cell_launches, "11": split_launches,
                "12": internal_launches, "13": large_launches,
                "14": ci_launches, "15": irc_launches,
                "16": hetero_launches}
    print(json.dumps({"kernels": [{
        "name": "jacobi_eigh",
        "route": "cuda",
        "source": "sella_tpu_torch/csrc/jacobi_eigh.cu",
        "replaces": "sella_tpu/ops/pallas_eigh.py:64",
        "launches": sum(launches.values()),
        "launches_by_phase": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
        "launches_per_step": (jac["jacobi_eigh_launches"]
                              / max(jac["steps_run"], 1)),
        "ms_f32_input": kern["ms_f32_input"],
        "ms_4096": kern["ms_4096"],
    }]}))
    card = _card()
    print(json.dumps({"largescale": {
        "card": card, "natoms": large["natoms"],
        **{k: {f: large[k][f] for f in (
            "s_per_step", "force_ms", "hvp_ms", "hvps_per_step",
            "host_syncs_per_step", "card_syncs_per_step", "peak_gib")}
           for k in ("lj_binned", "lj_chunked", "binned_emt",
                     "binned_emt_chunk", "mlff_f32")},
        "mlff_hvp_peak_gib": {"f32": large["mlff_checks"][
            "hvp_peak_f32_gib"], "f64": large["mlff_checks"][
            "hvp_peak_f64_gib"]},
        "binned_emt_hvp_peak_gib": {
            "full": large["binned_emt_checks"]["hvp_full_gib"],
            f"chunk{LARGE_CHUNK}": large["binned_emt_checks"][
                "hvp_chunk_gib"]},
        "held": {k: {f: held[k][f] for f in ("nsteps", "neval", "nmatvec",
                                             "energy")}
                 for k in held},
        "jax_cpu": {k: v for k, v in JAX_LARGESCALE_REF.items()
                    if k != "size"},
        "tpu_v5_lite_s_per_step_not_this_card": TPU_LARGESCALE}}))
    print(json.dumps({"batched_tiers": {
        "card": card,
        "cell_internal_14a": {k: ci[k] for k in (
            "batch", "converged_frac", "mean_steps_converged",
            "mean_force_calls", "s_per_step", "newton_iters_per_step",
            "host_syncs_per_step", "span_ms_per_step")},
        "cell_internal_14a_jax": JAX_CELL_INT_REF["headline"],
        "cartesian_cell_phase10": {k: cell[k] for k in (
            "batch", "mean_steps_converged", "mean_force_calls",
            "s_per_step")},
        "irc_15a": {k: irc[k] for k in (
            "paths", "converged_frac", "mean_steps", "mean_force_calls",
            "s_per_step", "paths_per_s", "eigh_ms_per_step")},
        "hetero_16a": {k: hetero[k] for k in ("buckets", "wall_s",
                                              "searches_per_s")},
        "hetero_16a_jax": {k: JAX_HETERO_REF[k] for k in ("LJ4", "LJ7")},
        "phase_budgets": budgets,
    }}), flush=True)
    print(json.dumps({"lj4_size": LJ4_SIZE, "lj4": {
        k: lj4[k] for k in ["converged_frac", *LJ4_COUNTS]},
        "jax_same_size": JAX_LJ4_REF, "bench_r05_full_size": LJ4_COUNTS}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
