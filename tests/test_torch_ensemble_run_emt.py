"""Run parity of the port's ``run_ensemble`` with the JAX package on the
headline EMT config (bench.py:225-246, 356-363): Cu(111) 3x4x2 slab +
adatom, 4 lanes, fmax 1e-3, ``prfo_eigh="jacobi"``, diag_budget 1.

The gates are loose because the float32 Jacobi prep makes a run
sensitive to rounding. In the JAX package itself, perturbing ``x0`` by
1e-9 or 1e-6 moved per-lane steps by up to 1 (baseline 25/25/25/31) and
matvecs by up to 6 (baseline 62/51/63/18). So: identical ``converged``,
per-lane ``nsteps`` within 3, ``nmatvec`` within 12, and the converged
lanes' energies within 1e-5 eV.
"""
import jax.numpy as jnp
import numpy as np
import torch

import sella_tpu_torch as st
from sella_tpu.parallel.ensemble import EnsembleConfig as JConfig
from sella_tpu.parallel.ensemble import run_ensemble as jax_run_ensemble
from sella_tpu.potentials.emt import EMT as JEMT
from sella_tpu.potentials.emt import fcc111_slab

torch.set_num_threads(2)

STEPS_TOL = 3
MATVEC_TOL = 12
E_ATOL = 1e-5


def headline_starts(batch):
    a = 3.59
    slab = fcc111_slab("Cu", a, size=(3, 4, 2))
    d = a / np.sqrt(2)
    top_z = slab.positions[:, 2].max()
    base = slab.positions[slab.positions[:, 2] > top_z - 0.1][0]
    ad = base + np.array(
        [d / 2 + 0.3, d / (2 * np.sqrt(3)) + 0.1, a / np.sqrt(3)]
    )
    pos0 = np.vstack([slab.positions, ad])
    rng = np.random.RandomState(0)
    x0 = np.stack([(pos0 + 0.02 * rng.normal(size=pos0.shape)).ravel()
                   for _ in range(batch)])
    return x0, np.asarray(slab.cell), len(pos0)


def headline_kwargs(nat, batch):
    return dict(
        natoms=nat, order=1, nproj=3, fmax=1e-3, gamma=0.3,
        davidson_max=25, delta0=5e-3, diag_budget=max(batch // 8, 1),
        eigh_f32=True, rs_maxiter=12, absb="ns", eval_chunk=0,
        davidson_seed="grad", prfo_eigh="jacobi",
    )


def test_emt_headline_run_matches_jax():
    x0, cell, nat = headline_starts(4)
    kw = headline_kwargs(nat, 4)
    z = np.array([29] * nat)
    js = jax_run_ensemble(JEMT(z, pbc=True), jnp.asarray(x0), JConfig(**kw),
                          max_steps=120, cell=jnp.asarray(cell))
    ts = st.run_ensemble(st.EMT(z, pbc=True), torch.as_tensor(x0),
                         st.EnsembleConfig(**kw), max_steps=120,
                         cell=torch.as_tensor(cell))
    conv_j = np.asarray(js.converged)
    np.testing.assert_array_equal(ts.converged.numpy(), conv_j)
    assert np.abs(ts.nsteps.numpy() - np.asarray(js.nsteps)).max() \
        <= STEPS_TOL
    assert np.abs(ts.nmatvec.numpy() - np.asarray(js.nmatvec)).max() \
        <= MATVEC_TOL
    np.testing.assert_allclose(ts.f.numpy()[conv_j], np.asarray(js.f)[conv_j],
                               rtol=0, atol=E_ATOL)
