"""Lane-by-lane run parity of the port's ``run_ensemble`` with the JAX
package on the LJ4 config of ``__graft_entry__._setup`` (its first 8
lanes, ``prfo_eigh="eigh"``, float64, max_steps=150).

Only the lanes the JAX run converges are gated (6 of the 8: lanes 3 and
4 limit-cycle around index-2 regions). On those, ``converged``,
``nsteps``, ``nmatvec`` and ``neval`` must be identical and the final
energies agree to 1e-8. Identical counts are a fair gate there: a 1e-13
perturbation of ``x0`` leaves every converged lane's counts unchanged in
the JAX package itself. The limit-cycling lanes are not compared: the
same perturbation moves their final energies by 0.1 eV and their
``nmatvec`` by 2.
"""
import jax.numpy as jnp
import numpy as np
import torch

import sella_tpu_torch as st
from sella_tpu.parallel.ensemble import EnsembleConfig as JConfig
from sella_tpu.parallel.ensemble import run_ensemble as jax_run_ensemble
from sella_tpu.potentials import LennardJones as JLJ

torch.set_num_threads(2)

E_ATOL = 1e-8


def _graft_lj4_starts(batch=64, lanes=8):
    """x0 of ``__graft_entry__._setup(batch=64)``, first ``lanes`` lanes."""
    tet = np.array(
        [[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
         [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]
    ) * 1.12
    rng = np.random.RandomState(0)
    x0 = (tet[None] + 0.1 * rng.normal(size=(batch, 4, 3))).reshape(
        batch, 12)
    return x0[:lanes]


def test_lj4_run_matches_jax_lane_by_lane():
    x0 = _graft_lj4_starts()
    kw = dict(natoms=4, order=1, fmax=1e-3, gamma=1e-3)
    js = jax_run_ensemble(JLJ(), jnp.asarray(x0), JConfig(**kw),
                          max_steps=150)
    ts = st.run_ensemble(st.LennardJones(), torch.as_tensor(x0),
                         st.EnsembleConfig(**kw), max_steps=150)
    conv_j = np.asarray(js.converged)
    assert conv_j.sum() >= 6, conv_j
    lanes = np.flatnonzero(conv_j)
    for name in ("converged", "nsteps", "nmatvec", "neval"):
        np.testing.assert_array_equal(
            getattr(ts, name).numpy()[lanes],
            np.asarray(getattr(js, name))[lanes], err_msg=name)
    np.testing.assert_allclose(ts.f.numpy()[lanes],
                               np.asarray(js.f)[lanes], rtol=0,
                               atol=E_ATOL)
    # every lane ran on the state dtypes of the JAX package
    assert ts.x.dtype == torch.float64 and ts.nsteps.dtype == torch.int32
    assert ts.converged.dtype == torch.bool
