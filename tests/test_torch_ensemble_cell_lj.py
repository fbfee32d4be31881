"""The port's atom+cell tier on periodic Lennard-Jones against the JAX
package, lane by lane, in float64 on the CPU: the cell mask, the
pressure term and the saddle (Davidson) branch of ``make_cell_step_fn``,
in one configuration.

The lattice, diagonal ``cell_mask`` (ncell = 3) and ``scalar_pressure =
0.5`` of ``tests/test_ensemble_cell.py:116-140``, searched with
``eig=True, order=1``: the step-0 Davidson runs on every lane, its
probes (exact HVPs of the enthalpy, pressure term included) absorbed
into H, and again wherever the inertia is wrong. The configuration draws
no dead-vector restart (whose draw comes from another generator in each
package), so over 4 steps ``nsteps``, ``neval``, ``nmatvec`` and
``converged`` are identical per lane and ``z`` agrees within 1e-6; the
off-diagonal cell entries stay exactly zero, and ``f`` is the enthalpy
``E + P V`` of the realized cell. (The minimization under this mask and
pressure runs to convergence in the JAX package's own tests; here one
compile of each package's step serves all three features, to keep the
parallel test lane inside its time limit.)

The JAX reference is :func:`test_torch_ensemble_cell._jax_run` (its
jitted init and step in ``run_cell_ensemble``'s host loop).
"""
import numpy as np
import pytest
import torch

import sella_tpu.parallel.ensemble_cell as J
import sella_tpu_torch.parallel.ensemble_cell as T
from sella_tpu.potentials import LennardJones as JLJ
from sella_tpu.potentials.emt import fcc_bulk
from sella_tpu_torch.potentials import LennardJones as TLJ
from test_torch_ensemble_cell import _jax_run

torch.set_num_threads(1)

Z_ATOL = 1e-6
MASK = np.eye(3, dtype=bool)
PRESSURE = 0.5


@pytest.fixture(scope="module")
def saddle():
    """Both packages' 4-step runs of the masked, pressurized saddle
    configuration on ``tests/test_ensemble_cell.py:_lj_setup``'s bulk."""
    atoms = fcc_bulk("Cu", 1.55, reps=(2, 2, 2))
    rng = np.random.RandomState(1)
    x0 = np.stack([
        (atoms.positions
         + 0.02 * rng.normal(size=atoms.positions.shape)).ravel()
        for _ in range(2)
    ])
    cell0 = np.asarray(atoms.cell)
    kw = dict(natoms=len(atoms), ncell=3, order=1, eig=True,
              davidson_max=12, fmax=1e-3, delta0=0.05,
              scalar_pressure=PRESSURE)
    js, _, _ = _jax_run(JLJ(pbc=True), x0, J.CellEnsembleConfig(**kw),
                        cell0, cell_mask=MASK, max_steps=4, chunk=4)
    cfg = T.CellEnsembleConfig(**kw)
    ts = T.run_cell_ensemble(TLJ(pbc=True), torch.as_tensor(x0), cfg,
                             cell0, cell_mask=MASK, max_steps=4,
                             steps_per_call=4)
    return ts, js, cfg


@pytest.mark.parametrize("lane", [0, 1])
def test_saddle_lane_matches_jax(saddle, lane):
    ts, js, _ = saddle
    assert ts.nmatvec[lane].item() > 0
    for k in ("nsteps", "neval", "nmatvec", "converged"):
        assert getattr(ts, k)[lane].item() == np.asarray(
            getattr(js, k))[lane].item(), k
    np.testing.assert_allclose(ts.z[lane].numpy(), np.asarray(js.z)[lane],
                               rtol=0, atol=Z_ATOL)


def test_mask_and_pressure_hold(saddle):
    ts, _, cfg = saddle
    cells = T.cells_of(ts, cfg, cell_mask=MASK)
    for C in cells.numpy():
        assert np.abs(C - np.diag(np.diag(C))).max() == 0.0
    pot = TLJ(pbc=True)
    nr3 = 3 * cfg.natoms
    for b in range(2):
        e = pot.energy(ts.z[b, :nr3], cells[b])
        pv = PRESSURE * torch.abs(torch.linalg.det(cells[b]))
        np.testing.assert_allclose(float(ts.f[b]), float(e + pv),
                                   rtol=1e-12)
