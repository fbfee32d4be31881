"""The atom+cell tier's building blocks in the port against the JAX
package, in float64 on the CPU: ``expm`` / ``expm_frechet`` /
``logm_host`` (``ops.linalg``), the lattice reduction (``utils.
lattice``), the cell chart's Jacobian (``pes.cell``), the strain
gradient / virial stress of ``Potential`` and the tier's extended
objective ``E + P V`` with a cell mask.

``expm`` is the same fixed Taylor-and-squaring arithmetic in both
packages, so it agrees to 1e-13 (3x3 matmul summation order only); the
lattice code is numpy in both and agrees exactly; the chart Jacobian and
the extended objective to 1e-12; the strain gradient of EMT and periodic
LJ to 1e-10 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import sella_tpu.ops.linalg as JL
import sella_tpu.potentials as JP
import sella_tpu.utils.lattice as JLat
import sella_tpu_torch.ops.linalg as TL
import sella_tpu_torch.potentials as TP
import sella_tpu_torch.utils.lattice as TLat
from sella_tpu.pes.cell import _cell_param_jacobian as jax_jacobian
from sella_tpu.potentials.emt import fcc_bulk
from sella_tpu_torch.pes.cell import _cell_param_jacobian as torch_jacobian

torch.set_num_threads(1)

EXPM_ATOL = 1e-13
JAC_ATOL = 1e-12
STRAIN_RTOL = 1e-10
SKEW = np.array([[1, 0, 0], [1, 1, 0], [0, 0, 1]], dtype=float)


def _rand_3x3(seed, norm):
    """A random 3x3 scaled to Frobenius norm ``norm``."""
    A = np.random.RandomState(seed).normal(size=(3, 3))
    return A * norm / np.linalg.norm(A)


def test_expm_frechet_and_logm_match_jax():
    """``expm`` and its Frechet derivative on random 3x3 of norm 0.1, 1
    and 3, against the JAX package and scipy; ``logm_host`` inverts it."""
    from scipy.linalg import expm as sexpm

    for norm in (0.1, 1.0, 3.0):
        A = _rand_3x3(int(10 * norm), norm)
        E = _rand_3x3(int(10 * norm) + 1, 1.0)
        e_j = np.asarray(JL.expm(jnp.asarray(A)))
        e_t = TL.expm(torch.as_tensor(A)).numpy()
        np.testing.assert_allclose(e_t, e_j, rtol=0,
                                   atol=EXPM_ATOL * max(1.0, np.abs(e_j).max()))
        fr_j = np.asarray(JL.expm_frechet(jnp.asarray(A), jnp.asarray(E)))
        fr_t = TL.expm_frechet(torch.as_tensor(A),
                               torch.as_tensor(E)).numpy()
        np.testing.assert_allclose(
            fr_t, fr_j, rtol=0, atol=EXPM_ATOL * max(1.0, np.abs(fr_j).max()))
        np.testing.assert_allclose(e_t, sexpm(A), rtol=1e-12, atol=1e-12)
    A = _rand_3x3(5, 0.5)
    F = TL.expm(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(TL.logm_host(F), A, atol=1e-12)
    np.testing.assert_allclose(TL.logm_host(F), JL.logm_host(F), atol=1e-14)


def test_det3_matches_det_under_hvp():
    """The pressure term's volume: the triple product equals
    ``torch.linalg.det`` and stays differentiable to second order under
    ``vmap``."""
    from torch.func import grad, jvp, vmap

    C = torch.as_tensor(np.random.RandomState(2).normal(size=(4, 3, 3)))
    V = torch.as_tensor(np.random.RandomState(3).normal(size=(4, 3, 3)))
    torch.testing.assert_close(vmap(TL.det3)(C), torch.linalg.det(C),
                               rtol=1e-13, atol=1e-13)
    h = vmap(lambda c, v: jvp(grad(TL.det3), (c,), (v,))[1])(C, V)
    assert h.shape == (4, 3, 3) and bool(torch.isfinite(h).all())


def test_lattice_reduction_matches_jax():
    rng = np.random.RandomState(4)
    cell = SKEW @ np.diag([3.1, 3.3, 3.6]) + 0.05 * rng.normal(size=(3, 3))
    for pbc in (None, (True, True, False)):
        c_t, M_t = TLat.reduce_cell_basis(cell, pbc=pbc)
        c_j, M_j = JLat.reduce_cell_basis(cell, pbc=pbc)
        np.testing.assert_array_equal(c_t, c_j)
        np.testing.assert_array_equal(M_t, M_j)
        p = (True, True, True) if pbc is None else pbc
        for _ in range(5):
            dx = rng.normal(size=3) * 6.0
            np.testing.assert_array_equal(TLat.mic_ncvec(dx, cell, p),
                                          JLat.mic_ncvec(dx, cell, p))


def test_cell_param_jacobian_matches_jax():
    L = _rand_3x3(6, 0.3)
    cell0 = SKEW @ np.diag([3.0, 3.2, 3.4])
    for Lk, factor in ((L, 32.0), (np.zeros((3, 3)), 8.0)):
        J_t = torch_jacobian(Lk, cell0, factor)
        J_j = jax_jacobian(Lk, cell0, factor)
        assert J_t.shape == (9, 9)
        np.testing.assert_allclose(J_t, J_j, rtol=0, atol=JAC_ATOL)


def _strain_case(name):
    """(jax potential, port potential, x, cell) on the CPU in float64."""
    if name == "emt_bulk32":
        atoms = fcc_bulk("Cu", 3.59 * 1.03, reps=(2, 2, 2))
        n = len(atoms)
        z = np.array([29] * n)
        jp, tp = JP.EMT(z, pbc=True), TP.EMT(z, pbc=True)
        rattle = 0.05
    else:
        atoms = fcc_bulk("Cu", 1.55, reps=(2, 2, 2))
        jp, tp = JP.LennardJones(pbc=True), TP.LennardJones(pbc=True)
        rattle = 0.02
    rng = np.random.RandomState(7)
    x = (atoms.positions + rattle * rng.normal(size=atoms.positions.shape))
    cell = np.asarray(atoms.cell) @ (np.eye(3) + 0.01 * rng.normal(
        size=(3, 3)))
    return jp, tp, x, cell


def test_strain_grad_and_stress_match_jax():
    for name in ("emt_bulk32", "lj_pbc"):
        _check_strain(name)


def _check_strain(name):
    from sella_tpu.atoms import Atoms as JAtoms
    from sella_tpu_torch.atoms import Atoms as TAtoms

    jp, tp, x, cell = _strain_case(name)
    e_j, d_j = jax.jit(jp.energy_and_strain_grad)(jnp.asarray(x.ravel()),
                                                  jnp.asarray(cell))
    e_t, d_t = tp.energy_and_strain_grad(torch.as_tensor(x.ravel()),
                                         torch.as_tensor(cell))
    assert e_t.dtype == torch.float64 and d_t.shape == (3, 3)
    d_j = np.asarray(d_j)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=STRAIN_RTOL)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=0,
                               atol=STRAIN_RTOL * np.abs(d_j).max())
    n = len(x)
    ev_j, s_j = jp.energy_and_stress(
        JAtoms(["Cu"] * n, x, cell=cell, pbc=True))
    ev_t, s_t = tp.energy_and_stress(
        TAtoms(["Cu"] * n, x, cell=cell, pbc=True))
    assert s_t.shape == (6,)
    np.testing.assert_allclose(ev_t, ev_j, rtol=STRAIN_RTOL)
    np.testing.assert_allclose(s_t, s_j, rtol=0,
                               atol=STRAIN_RTOL * np.abs(s_j).max())


def test_ext_energy_with_mask_and_pressure_matches_jax():
    """The extended objective ``E + P V`` of a diagonal cell mask with the
    base cell closed over (``make_ext_energy``): value and gradient
    against the JAX package's, and against the per-lane-base-cell form."""
    import sella_tpu.parallel.ensemble_cell as JC
    import sella_tpu_torch.parallel.ensemble_cell as TC
    from torch.func import grad_and_value

    atoms = fcc_bulk("Cu", 1.55, reps=(2, 2, 2))
    n = len(atoms)
    mask = np.eye(3, dtype=bool)
    kw = dict(natoms=n, ncell=3, scalar_pressure=0.5)
    rng = np.random.RandomState(8)
    z = np.concatenate([(atoms.positions + 0.02 * rng.normal(
        size=(n, 3))).ravel(), 0.05 * rng.normal(size=3)])
    cell0 = np.asarray(atoms.cell)
    e_j, c_j = JC.make_ext_energy(JP.LennardJones(pbc=True),
                                  JC.CellEnsembleConfig(**kw),
                                  jnp.asarray(cell0), mask)
    f_j, g_j = jax.jit(jax.value_and_grad(e_j))(jnp.asarray(z))
    cfg = TC.CellEnsembleConfig(**kw)
    e_t, c_t = TC.make_ext_energy(TP.LennardJones(pbc=True), cfg, cell0,
                                  mask)
    g_t, f_t = grad_and_value(e_t)(torch.as_tensor(z))
    np.testing.assert_allclose(float(f_t), float(f_j), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(g_j)).max())
    s = torch.as_tensor(z[3 * n:])
    cell = c_t(s).numpy()
    np.testing.assert_allclose(cell, np.asarray(c_j(jnp.asarray(z[3 * n:]))),
                               rtol=0, atol=1e-13)
    assert np.all(cell[~mask] == 0.0)
    e2, _ = TC.make_ext_energy_c0(TP.LennardJones(pbc=True), cfg, mask)
    assert float(e2(torch.as_tensor(z), torch.as_tensor(cell0))) == float(f_t)
