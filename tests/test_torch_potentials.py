"""The port's potentials (sella_tpu_torch.potentials) against the JAX
package's, in float64 on the CPU.

The same numpy-seeded geometries and directions go through both. Both
sides evaluate the same formulas in float64 and differ only in summation
order and in the autodiff machinery: energy and gradient agree to 1e-10
relative, the forward-over-reverse HVP to 1e-9 relative (it chains one
more derivative through the same sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.potentials as J
import sella_tpu_torch.potentials as T
from sella_tpu.potentials.emt import fcc111_slab as jax_fcc111_slab
from sella_tpu_torch.parallel.ensemble import _batched_eval, \
    _batched_hvp_full

torch.set_num_threads(2)

EG_RTOL = 1e-10
HVP_RTOL = 1e-9


def _tet(seed, n=1, noise=0.1):
    tet = np.array(
        [[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
         [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]
    ) * 1.12
    rng = np.random.RandomState(seed)
    return (tet[None] + noise * rng.normal(size=(n, 4, 3))).reshape(n, 12)


def _headline_slab():
    """Cu(111) 3x4x2 slab + adatom, 25 atoms, periodic (bench.py:225-246)."""
    a = 3.59
    slab = jax_fcc111_slab("Cu", a, size=(3, 4, 2))
    d = a / np.sqrt(2)
    top_z = slab.positions[:, 2].max()
    base = slab.positions[slab.positions[:, 2] > top_z - 0.1][0]
    ad = base + np.array(
        [d / 2 + 0.3, d / (2 * np.sqrt(3)) + 0.1, a / np.sqrt(3)]
    )
    pos = np.vstack([slab.positions, ad])
    rng = np.random.RandomState(0)
    x = (pos + 0.02 * rng.normal(size=pos.shape)).ravel()
    return x, np.asarray(slab.cell), len(pos)


def _case(name):
    """(jax potential, torch potential, x, cell)."""
    if name == "lj4":
        return J.LennardJones(), T.LennardJones(), _tet(0)[0], np.zeros((3, 3))
    if name == "lj_pbc_cut":
        # periodic cubic box with a cutoff: exercises the minimum-image
        # displacements (inv3 + round) and the shifted pair energy
        x = _tet(1, noise=0.2)[0] + 0.3
        kw = dict(epsilon=0.7, sigma=1.1, rc=2.5, pbc=True)
        return (J.LennardJones(**kw), T.LennardJones(**kw), x,
                np.diag([3.0, 3.2, 3.4]))
    if name == "morse_xe4":
        from sella_tpu.utils.units import kB

        kw = dict(epsilon=226.9 * kB, r0=4.73, rho0=4.73 * 1.099)
        x = _tet(2)[0] * 4.73 / 1.12
        return J.MorsePotential(**kw), T.MorsePotential(**kw), x, \
            np.zeros((3, 3))
    if name == "emt_slab":
        x, cell, nat = _headline_slab()
        z = np.array([29] * nat)
        return J.EMT(z, pbc=True), T.EMT(z, pbc=True), x, cell
    if name == "emt_cluster":
        # small free cluster of mixed species, no periodicity
        rng = np.random.RandomState(4)
        base = np.array([[0, 0, 0], [2.5, 0, 0], [0, 2.5, 0], [0, 0, 2.5],
                         [2.5, 2.5, 0], [1.25, 1.25, 1.8]])
        x = (base + 0.1 * rng.normal(size=base.shape)).ravel()
        z = np.array([29, 29, 79, 47, 28, 29])
        return J.EMT(z), T.EMT(z), x, np.zeros((3, 3))
    raise KeyError(name)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


CASES = ["lj4", "lj_pbc_cut", "morse_xe4", "emt_slab", "emt_cluster"]


@pytest.mark.parametrize("name", CASES)
def test_energy_grad_hvp_match_jax(name):
    jp, tp, x, cell = _case(name)
    v = np.random.RandomState(7).normal(size=x.shape)
    e_j, g_j = jp.energy_and_grad(jnp.asarray(x), jnp.asarray(cell))
    hv_j = jp.hvp(jnp.asarray(x), jnp.asarray(v), jnp.asarray(cell))
    xt, ct = torch.as_tensor(x), torch.as_tensor(cell)
    e_t, g_t = tp.energy_and_grad(xt, ct)
    hv_t = tp.hvp(xt, torch.as_tensor(v), ct)
    assert e_t.dtype == torch.float64 and g_t.shape == xt.shape
    assert _rel(e_t, e_j) < EG_RTOL
    assert _rel(g_t, g_j) < EG_RTOL
    assert _rel(hv_t, hv_j) < HVP_RTOL
    assert torch.isfinite(hv_t).all()


@pytest.mark.parametrize("name", ["lj4", "emt_cluster"])
def test_hessian_matches_jax(name):
    jp, tp, x, cell = _case(name)
    H_j = jp.hessian(jnp.asarray(x), jnp.asarray(cell))
    H_t = tp.hessian(torch.as_tensor(x), torch.as_tensor(cell))
    assert _rel(H_t, H_j) < HVP_RTOL


def test_emt_parameters_bit_for_bit():
    x, cell, nat = _headline_slab()
    for z in (np.array([29] * nat), np.array([29, 79, 47, 28, 46, 78, 13])):
        jp, tp = J.EMT(z, pbc=True), T.EMT(z, pbc=True)
        for name, a in zip(T.EMT.PARAM_NAMES, jp._arrs):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(a), err_msg=name)
        assert tp.rc == jp.rc and tp.acut == jp.acut


def test_emt_unknown_species_and_cell_check():
    with pytest.raises(ValueError):
        T.EMT([92])
    pot = T.EMT([29] * 4, pbc=True)
    with pytest.raises(ValueError):
        pot.validate_cell(np.eye(3) * 3.0)


@pytest.mark.parametrize("chunk", [0, 2])
def test_batched_eval_and_hvp_match_jax(chunk):
    """The ensemble's vmapped evaluators (with and without lane chunking)
    against the JAX package's per-lane calls."""
    jp, tp, x1, cell = _case("emt_slab")
    rng = np.random.RandomState(3)
    X = x1[None] + 0.01 * rng.normal(size=(4, x1.size))
    Vd = rng.normal(size=X.shape)
    ct = torch.as_tensor(cell)
    f, g = _batched_eval(tp, ct, chunk)(torch.as_tensor(X))
    hv = _batched_hvp_full(tp, ct, chunk)(torch.as_tensor(X),
                                          torch.as_tensor(Vd))
    for b in range(4):
        e_j, g_j = jp.energy_and_grad(jnp.asarray(X[b]), jnp.asarray(cell))
        hv_j = jp.hvp(jnp.asarray(X[b]), jnp.asarray(Vd[b]),
                      jnp.asarray(cell))
        assert _rel(f[b], e_j) < EG_RTOL
        assert _rel(g[b], g_j) < EG_RTOL
        assert _rel(hv[b], hv_j) < HVP_RTOL


def test_module_moves_buffers_and_slabs_match():
    """Slab constructors return the same geometry as the JAX package's, and
    the potential's parameters are buffers that follow ``.to()``."""
    a = 3.59
    for jb, tb, kw in [
        (jax_fcc111_slab, T.fcc111_slab, dict(size=(3, 4, 2))),
        (J.emt.fcc111_primitive, T.fcc111_primitive, dict(size=(2, 3, 3))),
        (J.emt.fcc_bulk, T.fcc_bulk, dict(reps=(2, 2, 2))),
    ]:
        ja, ta = jb("Cu", a, **kw), tb("Cu", a, **kw)
        np.testing.assert_array_equal(ja.positions, ta.positions)
        np.testing.assert_array_equal(ja.cell, ta.cell)
        assert isinstance(ta.calc, T.EMT)
    pot = T.EMT([29] * 3).to(torch.float32)
    assert all(b.dtype == torch.float32 for n, b in pot.named_buffers()
               if n != "zero_img")
