#!/usr/bin/env python3
"""Time what bounds the port's internal+cell and IRC steps on the card.

Prints the card's name and power limit, then:

* float64 ``torch.linalg.eigh`` (and ``eigvalsh``) at the batched tiers'
  shapes: IRC's (B, 75, 75) / (B, 72, 72) at 256 lanes, the
  internal+cell tier's (B, 192, 192) Gram at 64 / 32 / 16 / 8 lanes and
  its (B, 102, 102) prep and (B, 201, 201) Hessian, each beside the
  same call on the host's CPU (CUDA events; 3 warm repetitions);
* the internal+cell step of ``chip_smoke.py`` phase 14a (bulk Cu EMT,
  192 bonds + 9 cell parameters) at 32, 16 and 8 lanes: seconds a step
  over 3 warm steps, with its ``"gram"``, ``"newton"`` and
  ``"restricted"`` CUDA-event spans and its Newton iterations;
* the IRC outer step of phase 15a (Cu(111) slab + adatom) at 256 and 64
  lanes from ``--ts`` transition states (an ``.npz`` with ``x`` and ``B``
  of converged headline lanes, replicated to fill the batch; without it
  the headline runs first at 64 lanes to make them).

Run on the card from the repository root:

    python3 tools/time_batched_tiers.py [--ts FILE.npz]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def _ms(fn, reps=3):
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


def eighs(dev):
    for B, n in [(256, 75), (256, 72), (64, 192), (32, 192), (16, 192),
                 (8, 192), (64, 102), (64, 201)]:
        A = torch.randn(B, n, n, dtype=torch.float64, device=dev)
        A = A + A.transpose(1, 2)
        g = _ms(lambda: torch.linalg.eigh(A))
        gv = _ms(lambda: torch.linalg.eigvalsh(A))
        Ac = A.cpu()
        t = time.perf_counter()
        for _ in range(3):
            torch.linalg.eigh(Ac)
        c = (time.perf_counter() - t) / 3 * 1e3
        print(f"({B}, {n}, {n}) float64: card eigh {g:.2f} ms, eigvalsh "
              f"{gv:.2f} ms; host CPU eigh {c:.2f} ms", flush=True)


def cell_internal_steps(dev):
    import sella_tpu_torch.parallel.ensemble_internal as TE
    from sella_tpu_torch.parallel import ensemble_cell_internal as TC

    for B in (32, 16, 8):
        pot, ints, x0, s0, cell0, _ = cs.cell_int_setup(B)
        cfg = cs.cell_int_config(ints)
        pot = pot.to(dev)
        st = TC.init_cell_internal_state(pot, ints, x0, cfg, cell0, s0=s0,
                                         device=dev)
        step = TC.make_cell_internal_step_fn(pot, ints, cfg)
        st = step(st)
        torch.cuda.synchronize()
        step.newton_iters = step.host_syncs = 0
        TE.SPANS = {}
        t = time.perf_counter()
        for _ in range(3):
            st = step(st)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / 3
        spans = TE.span_ms(TE.SPANS)
        TE.SPANS = None
        print(f"internal+cell step, {B} lanes: {wall:.3f} s; ms a step "
              + ", ".join(f"{k} {v / 3:.1f}" for k, v in spans.items())
              + f"; Newton iterations a step {step.newton_iters / 3:.1f}",
              flush=True)


def irc_steps(dev, ts_file):
    from sella_tpu_torch.parallel import ensemble_irc as TI

    if ts_file:
        d = np.load(ts_file)
        x_ts, H_ts = d["x"], d["B"]
    else:
        _, st = cs.run_headline("jacobi", batch=64, keep_state=True)
        sel = torch.where(st.converged)[0][:4]
        x_ts, H_ts = st.x[sel].cpu().numpy(), st.B[sel].cpu().numpy()
    pot, _, cell, nat = cs.headline_setup(1)
    pot = pot.to(dev)
    cell_t = torch.as_tensor(cell, device=dev)
    masses = np.full(nat, cs.CU_MASS)
    cfg = TI.IRCEnsembleConfig(natoms=nat, nproj=3)
    for B in (256, 64):
        rep = -(-B // len(x_ts))
        x = np.repeat(x_ts, rep, axis=0)[:B]
        H = np.repeat(H_ts, rep, axis=0)[:B]
        st = TI.init_irc_state(pot, x, H, cfg, masses,
                               np.tile([1.0, -1.0], B // 2), cell_t)
        step = TI.make_irc_step_fn(pot, cfg, masses, cell_t)
        st = step(st)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(4):
            st = step(st)
        torch.cuda.synchronize()
        print(f"IRC outer step, {B} lanes: "
              f"{(time.perf_counter() - t) / 4:.3f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ts", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_batched_tiers: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(cs._card(), flush=True)
    eighs(dev)
    cell_internal_steps(dev)
    irc_steps(dev, args.ts)


if __name__ == "__main__":
    main()
