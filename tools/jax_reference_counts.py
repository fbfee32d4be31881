#!/usr/bin/env python3
"""The JAX package's results on the configurations of ``chip_smoke.py``
phases 7 and 8, computed on the CPU.

The card's host has no JAX, so ``chip_smoke.py`` holds the port to the
numbers this script prints: one JSON line, ``{"JAX_LJ4_REF": ...,
"JAX_CONSTRAINT_REF": ...}``, whose two values are copied over the
constants of those names. Each carries the sizes it was computed at
under ``"size"``, and ``chip_smoke.py`` raises when its own sizes differ:

* phase 7: the LJ4 composite queue of ``bench.run_lj4_queue`` at the
  sizes of ``chip_smoke.LJ4_SIZE`` (the bench caps tail budgets at 4x the
  per-search budget, so ``LJ4_SIZE`` must too);
* phase 8: the three constrained LJ4 configs of ``run_constraints`` at
  1024 lanes and ``chip_smoke.CONSTRAINT_MAX_STEPS`` steps: converged
  lanes, and the mean steps (printed, not gated).

Run from the repository root (a minute or two on one CPU):

    JAX_PLATFORMS=cpu python3 tools/jax_reference_counts.py
"""
from __future__ import annotations

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import sella_tpu  # noqa: E402,F401  (float64 before any jnp use)
import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
from sella_tpu.parallel.ensemble import EnsembleConfig, run_ensemble  # noqa
from sella_tpu.potentials import LennardJones  # noqa: E402


def lj4_composite():
    size = dict(cs.LJ4_SIZE)
    if size["retry_step_cap"] != 4 * size["max_steps"]:
        raise SystemExit("bench.run_lj4_queue caps tail budgets at 4x "
                         "max_steps")
    os.environ["BENCH_LJ4_RETRIES"] = str(size["max_retries"])
    os.environ["BENCH_LJ4_FAST_RETRIES"] = "2"
    os.environ["BENCH_LJ4_TAIL_BATCH"] = str(size["tail_batch"])
    _, stats = bench.run_lj4_queue(size["total"], size["batch"],
                                   size["max_steps"])
    return {"size": size, **{k: stats[k] for k in (
        "converged_frac", "mean_steps_converged", "mean_matvecs",
        "mean_force_calls")}}


def constraints(batch=1024):
    def bond(x):
        p = x.reshape(-1, 3)
        return jnp.array([jnp.linalg.norm(p[0] - p[1]) - 1.3])

    minim = dict(natoms=4, order=0, fmax=1e-4, ncons=1, ctol=1e-6,
                 eig=False, method="qn")
    runs = {
        "eq_min": (minim, 3, None),
        "gt_min": (minim, 3, ("gt",)),
        "eq_saddle": (dict(natoms=4, order=1, fmax=1e-3, ncons=1), 0, None),
    }
    out = {"size": {"batch": batch, "max_steps": cs.CONSTRAINT_MAX_STEPS}}
    for name, (kw, seed, comp) in runs.items():
        x0 = cs.lj4_starts(batch, seed, jitter=0.05)
        st = run_ensemble(LennardJones(), jnp.asarray(x0),
                          EnsembleConfig(**kw),
                          max_steps=cs.CONSTRAINT_MAX_STEPS,
                          constraints=bond, comparators=comp)
        conv = np.asarray(st.converged)
        out[name] = {"converged": int(conv.sum()),
                     "mean_steps_converged": float(
                         np.asarray(st.nsteps)[conv].mean())}
    return out


if __name__ == "__main__":
    print(json.dumps({"JAX_LJ4_REF": lj4_composite(),
                      "JAX_CONSTRAINT_REF": constraints()}))
