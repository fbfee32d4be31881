"""The port's Internals container and its torch engine against the JAX
package's: the discovered topology (bonds, angles, dihedrals with their
cell offsets, dummies, TRIC fragments) is identical, and the engine's
values, B matrix, ``hessian_rdot``, ``hessian_ldot`` and
``cell_jacobian`` and the Lindh guess Hessian agree within 1e-10 in
float64 on water, ethane, an ethanol-like chain, a skewed periodic cell,
a linear molecule with its dummy and two water fragments."""
import numpy as np
import pytest
import torch

import sella_tpu  # noqa: F401  (float64 before any jnp use)
from sella_tpu import Atoms as JAtoms
from sella_tpu.coords.internals import Internals as JInternals

from sella_tpu_torch import Atoms as TAtoms
from sella_tpu_torch.coords.internals import Internals as TInternals

torch.set_num_threads(1)

TOL = 1e-10


def _water(shift=(0.0, 0.0, 0.0)):
    r, ang = 0.9575, np.radians(104.51)
    return np.array([[0, 0, 0], [r, 0, 0],
                     [r * np.cos(ang), r * np.sin(ang), 0]]) + shift


def _ethane():
    cc, ch, a = 1.54, 1.09, np.radians(111.2)
    pos = [[0, 0, 0], [0, 0, cc]]
    for k in range(3):
        phi = 2 * np.pi * k / 3
        pos.append([ch * np.sin(a) * np.cos(phi),
                    ch * np.sin(a) * np.sin(phi), -ch * np.cos(a)])
    for k in range(3):
        phi = 2 * np.pi * k / 3 + np.pi / 3
        pos.append([ch * np.sin(a) * np.cos(phi),
                    ch * np.sin(a) * np.sin(phi), cc + ch * np.cos(a)])
    return np.array(pos)


# name -> (symbols, positions, cell, pbc, allow_fragments)
SYSTEMS = {
    "water": (["O", "H", "H"], _water(), None, False, False),
    "ethane": (["C", "C"] + ["H"] * 6, _ethane(), None, False, False),
    "ethanolish": (["C", "C", "O", "H", "H"], np.array([
        [0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [2.2, 1.2, 0.0],
        [-0.5, 0.9, 0.0], [-0.5, -0.9, 0.3]]), None, False, False),
    # a skewed periodic cell: bonds through images in a reduced basis
    "skewed_cell": (["Cu"] * 3, np.array([
        [0.2, 0.3, 0.1], [1.6, 1.1, 0.4], [2.9, 0.4, 1.3]]),
        np.array([[3.0, 0.0, 0.0], [2.6, 2.9, 0.0], [0.4, 0.3, 3.1]]),
        True, False),
    # a linear Xe3 chain: a dummy atom at the 2-coordinate center
    "linear_dummy": (["Xe"] * 3, np.array([
        [0.0, 0, 0], [4.73, 0, 0], [9.46, 0, 0]]), None, False, False),
    # two water fragments: translations and rotations (TRICs)
    "water_fragments": (["O", "H", "H"] * 2, np.vstack([
        _water(), _water((6.0, 0.2, 0.1))]), None, False, True),
}


def _pair(name):
    sym, pos, cell, pbc, frag = SYSTEMS[name]
    out = []
    for A, I in ((JAtoms, JInternals), (TAtoms, TInternals)):
        atoms = A(sym, pos, cell=cell, pbc=pbc)
        ints = I(atoms, allow_fragments=frag)
        ints.find_all_bonds()
        ints.find_all_angles()
        ints.find_all_dihedrals()
        out.append(ints)
    return out


def _same_records(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert np.array_equal(np.asarray(x), np.asarray(y)), (ra, rb)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_topology_and_engine_match_jax(name):
    ji, ti = _pair(name)
    _same_records(ji.bonds, ti.bonds)
    _same_records(ji.angles, ti.angles)
    _same_records(ji.dihedrals, ti.dihedrals)
    assert (ji.ntrans, ji.nrotations, ji.ndummies, ji.nint) == (
        ti.ntrans, ti.nrotations, ti.ndummies, ti.nint)
    np.testing.assert_array_equal(ji.dinds, ti.dinds)
    np.testing.assert_allclose(ji.dummies.positions, ti.dummies.positions,
                               atol=0, rtol=0)
    # constraints the dummy insertion adds (bond + one angle)
    np.testing.assert_allclose(ji.cons.targets, ti.cons.targets, atol=TOL)

    rng = np.random.RandomState(5)
    v = rng.normal(size=ji.ndof)
    w = rng.normal(size=ji.nint)
    np.testing.assert_allclose(ti.calc(), ji.calc(), atol=TOL)
    np.testing.assert_allclose(ti.jacobian(), ji.jacobian(), atol=TOL)
    np.testing.assert_allclose(ti.hessian_rdot(v), ji.hessian_rdot(v),
                               atol=TOL)
    np.testing.assert_allclose(ti.hessian_ldot(w), ji.hessian_ldot(w),
                               atol=TOL)
    np.testing.assert_allclose(ti.cell_jacobian(), ji.cell_jacobian(),
                               atol=TOL)
    np.testing.assert_allclose(ti.guess_hessian(), ji.guess_hessian(),
                               atol=TOL)
    d = rng.normal(size=ji.nint) * 4.0
    np.testing.assert_allclose(ti.wrap(d), ji.wrap(d), atol=TOL)
