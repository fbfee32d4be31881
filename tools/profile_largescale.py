#!/usr/bin/env python3
"""Where a large-system force call and HVP spend their card time.

Profiles, on the 10,000-atom slabs of ``chip_smoke.py`` phase 13a, one
force call (``energy_and_grad``) and one HVP of the binned LJ,
``BinnedEMT`` and the float32 MLFF, and prints for each the mean time
over 3 warm calls (CUDA events) and ``torch.profiler``'s table of the
operators with the most card time. Needs a CUDA device; run from the
repository root:

    python3 tools/profile_largescale.py
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from sella_tpu_torch.potentials import (BinnedEMT,  # noqa: E402
                                        BinnedPairPotential, F32Potential,
                                        LennardJones, MLPotential,
                                        fcc111_slab)
from sella_tpu_torch.potentials.mlff import WEIGHTS_CU_EMT  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_largescale: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs._card(), flush=True)
    slab = fcc111_slab("Cu", 3.59, size=cs.LARGE_SLAB["size"])
    slab_e = fcc111_slab("Cu", 3.59, size=cs.LARGE_SLAB["size"],
                         vacuum=12.0)
    x0, cell = slab.positions.ravel(), np.asarray(slab.cell)
    xe, ce = slab_e.positions.ravel(), np.asarray(slab_e.cell)
    z = [29] * (xe.size // 3)
    pots = {
        "binned_lj": (BinnedPairPotential(
            LennardJones(pbc=True, **cs.LARGE_LJ), rc=cs.LARGE_LJ["rc"],
            x0=x0, cell=cell, shift=False), x0, cell),
        "binned_emt": (BinnedEMT(z, xe, ce, capacity=32), xe, ce),
        "mlff_f32": (F32Potential(MLPotential(
            z, xe, ce, rc=4.5, capacity=24,
            params=MLPotential.params_from_npz(WEIGHTS_CU_EMT))), xe, ce),
    }
    v_np = np.random.RandomState(1).normal(size=xe.shape)
    for name, (pot, x_np, c_np) in pots.items():
        pot = pot.to(dev)
        x, c, v = (torch.as_tensor(a, device=dev) for a in (x_np, c_np,
                                                             v_np))
        for what, fn in (("force", lambda: pot.energy_and_grad(x, c)),
                         ("hvp", lambda: pot.hvp(x, v, c))):
            ms = cs._cuda_ms(fn, 3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            print(f"{name} {what}: {ms:.3f} ms", flush=True)
            print(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=8,
                max_name_column_width=50), flush=True)


if __name__ == "__main__":
    main()
