"""The port's per-lane Niggli rebase, ``CellSearchState`` checkpoints and
the atom+cell entry points' device rule, against the JAX package where
it has a counterpart, in float64 on the CPU.

* The rebase event of ``tests/test_cell_niggli_batched.py:60-137`` (the
  same lattice as a pristine cubic lane and a 45-degree-skewed one): the
  rebased mask, the new base cells, the zeroed cell parameters and the
  exact chart transform of the Hessian (``T = J_old^{-1} (M^{-1} kron
  I) J_new``) agree with the JAX package's to 1e-12 on one state with a
  random symmetric Hessian and nonzero cell parameters; with the
  potential, the rebased lane's energy and atom gradient stay put and
  its cell gradient is ``T^T g_old``.
* A ``CellSearchState`` survives ``save_state`` / ``load_state``.
* The entry points follow the device rule, and ``mesh=`` raises.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.parallel.ensemble_cell as J
import sella_tpu_torch.parallel.checkpoint as ckpt
import sella_tpu_torch.parallel.ensemble_cell as T
from sella_tpu.potentials.emt import fcc_bulk
from sella_tpu_torch.pes.cell import _cell_param_jacobian
from sella_tpu_torch.potentials import LennardJones as TLJ
from sella_tpu_torch.utils.lattice import reduce_cell_basis

torch.set_num_threads(1)

H_ATOL = 1e-12
SKEW = np.array([[1, 0, 0], [1, 1, 0], [0, 0, 1]], dtype=float)


def _rebase_setup():
    """``tests/test_cell_niggli_batched.py:_setup``: lane 0 pristine cubic,
    lane 1 the same lattice sheared by a unimodular integer matrix; plus
    small cell parameters and a random symmetric Hessian."""
    atoms = fcc_bulk("Cu", 1.55, reps=(3, 3, 3))
    pot = TLJ(pbc=True, rc=1.4)
    cell = np.asarray(atoms.cell)
    rng = np.random.RandomState(0)
    x0 = np.stack([
        (atoms.positions
         + 0.01 * rng.normal(size=atoms.positions.shape)).ravel()
        for _ in range(2)
    ])
    cell0 = np.stack([cell, SKEW @ cell])
    nat = len(atoms)
    cfg = T.CellEnsembleConfig(natoms=nat, ncell=9, order=0, fmax=5e-3)
    s0 = 0.01 * rng.normal(size=(2, 9))
    st = T.init_cell_state(pot, x0, cfg, cell0, s0=s0, device="cpu")
    A = rng.normal(size=(2, cfg.dim, cfg.dim))
    H = 0.05 * (A + A.transpose(0, 2, 1)) + st.H.numpy()
    return pot, cfg, st._replace(H=torch.as_tensor(H))


def test_rebase_chart_transform_matches_jax():
    _, cfg, st = _rebase_setup()
    nr3 = 3 * cfg.natoms
    fields = {k: jnp.asarray(getattr(st, k).numpy()) for k in st._fields}
    js2, jhit = J.niggli_rebase_cell_lanes(
        J.CellSearchState(**fields), J.CellEnsembleConfig(*cfg))
    ts2, thit = T.niggli_rebase_cell_lanes(st, cfg)
    assert list(thit) == list(jhit) == [False, True]
    np.testing.assert_array_equal(ts2.cell0.numpy(), np.asarray(js2.cell0))
    np.testing.assert_array_equal(ts2.z.numpy(), np.asarray(js2.z))
    np.testing.assert_array_equal(ts2.z.numpy()[1, nr3:], 0.0)
    Hj = np.asarray(js2.H)
    np.testing.assert_allclose(ts2.H.numpy(), Hj, rtol=0,
                               atol=H_ATOL * np.abs(Hj).max())
    # the pristine lane and every lane's atom block are untouched
    np.testing.assert_array_equal(ts2.H.numpy()[0], st.H.numpy()[0])
    np.testing.assert_array_equal(ts2.H.numpy()[1, :nr3, :nr3],
                                  st.H.numpy()[1, :nr3, :nr3])
    # without a potential (f, g, neval) are left alone
    for k in ("f", "g", "neval"):
        assert torch.equal(getattr(ts2, k), getattr(st, k)), k


def test_rebase_refresh_keeps_the_physical_point():
    pot, cfg, st = _rebase_setup()
    nr3 = 3 * cfg.natoms
    ts2, hit = T.niggli_rebase_cell_lanes(st, cfg, potential=pot)
    assert list(hit) == [False, True]
    np.testing.assert_array_equal(ts2.neval.numpy(), [1, 2])
    f0, g0 = st.f.numpy(), st.g.numpy()
    f1, g1 = ts2.f.numpy(), ts2.g.numpy()
    assert f1[0] == f0[0] and np.array_equal(g1[0], g0[0])
    np.testing.assert_allclose(f1[1], f0[1], rtol=0, atol=1e-9)
    np.testing.assert_allclose(g1[1, :nr3], g0[1, :nr3], atol=1e-8)
    # chain rule of the chart change: g_new = T^T g_old
    factor = float(cfg.natoms)
    L_old = st.z.numpy()[1, nr3:].reshape(3, 3)
    from scipy.linalg import expm

    _, M = reduce_cell_basis(expm(L_old / factor) @ st.cell0.numpy()[1])
    J_old = _cell_param_jacobian(L_old, st.cell0.numpy()[1], factor)
    J_new = _cell_param_jacobian(np.zeros((3, 3)), ts2.cell0.numpy()[1],
                                 factor)
    Tm = np.linalg.solve(J_old, np.kron(np.linalg.inv(M), np.eye(3)) @ J_new)
    np.testing.assert_allclose(g1[1, nr3:], Tm.T @ g0[1, nr3:], rtol=1e-6,
                               atol=1e-9)
    # idempotent
    _, hit2 = T.niggli_rebase_cell_lanes(ts2, cfg, potential=pot)
    assert not hit2.any()


def test_cell_state_checkpoint_round_trip(tmp_path):
    _, _, st = _rebase_setup()
    path = os.path.join(tmp_path, "cell.pt")
    ckpt.save_state(path, st, step=7)
    back, step = ckpt.load_state(path, state_cls=T.CellSearchState,
                                 device="cpu")
    assert step == 7 and isinstance(back, T.CellSearchState)
    for name, a, b in zip(st._fields, st, back):
        assert a.dtype == b.dtype and a.device == b.device, name
        assert torch.equal(a, b), name


def _lj_bulk_one():
    atoms = fcc_bulk("Cu", 1.55, reps=(2, 2, 2))
    x0 = atoms.positions.reshape(1, -1) + 0.01
    return x0, np.asarray(atoms.cell), T.CellEnsembleConfig(natoms=32)


def test_numpy_x0_without_device_needs_a_gpu(monkeypatch):
    """The device rule of the Cartesian tier, for each entry point: a
    numpy x0 goes to the GPU by default and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x0, cell, cfg = _lj_bulk_one()
    for entry in ("init_cell_state", "run_cell_ensemble",
                  "run_cell_ensemble_queue"):
        args = (TLJ(pbc=True), x0, cfg, cell)
        if entry == "run_cell_ensemble_queue":
            args = args + (1,)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            getattr(T, entry)(*args)


def test_mesh_is_not_ported():
    x0, cell, cfg = _lj_bulk_one()
    for entry in ("run_cell_ensemble", "run_cell_ensemble_queue"):
        args = (TLJ(pbc=True), torch.as_tensor(x0), cfg, cell)
        if entry == "run_cell_ensemble_queue":
            args = args + (1,)
        with pytest.raises(NotImplementedError):
            getattr(T, entry)(*args, mesh=object())
