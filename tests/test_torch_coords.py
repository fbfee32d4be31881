"""The port's coordinate primitives, constraints and ``"robust"`` eigh
against the JAX package: bond/angle/dihedral values, gradients and
Hessians, the quaternion rotation coordinate with its Jacobian and
Hessian on degenerate Kearsley spectra (``tests/test_coords.py:219``),
forward-over-reverse through it, the batched analytic kind functions,
the :class:`Constraints` container, the internal-coordinate engine's
rows of every coordinate kind, and the degenerate-cluster gates of
``tests/test_eigh_refined.py:42-86`` for ``batched_eigh(.., "robust")``.
Tolerance 1e-10 absolute in float64 unless stated."""
import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vmap

import jax
import jax.numpy as jnp

import sella_tpu  # noqa: F401  (float64 before any jnp use)
from sella_tpu import Atoms as JAtoms
from sella_tpu.coords import primitives as JP
from sella_tpu.coords.constraints import Constraints as JConstraints
from sella_tpu.coords.internals import Internals as JInternals

from sella_tpu_torch import Atoms as TAtoms
from sella_tpu_torch.coords import primitives as TP
from sella_tpu_torch.coords.constraints import Constraints as TConstraints
from sella_tpu_torch.coords.internals import Internals as TInternals
from sella_tpu_torch.ops.linalg import batched_eigh

torch.set_num_threads(1)

TOL = 1e-10


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _rotation_cases():
    ref = np.array([[1.0, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0]])
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    tet = np.array([[1.0, 1, 1], [1, -1, -1], [-1, 1, -1],
                    [-1, -1, 1]]) / np.sqrt(3)
    rng = np.random.RandomState(7)
    r = rng.normal(size=(5, 3))
    return {
        # degenerate Kearsley spectra (tests/test_coords.py:219)
        "square": (ref @ R.T, ref),
        "tetrahedron": (tet.copy(), tet),
        # a degenerate LEADING eigenvalue: the canonical-q branch
        "diatomic": (np.array([[0, 0, 0.0], [1.0, 0.1, 0.0]]),
                     np.array([[0, 0, 0.0], [1.0, 0.0, 0.0]])),
        "generic": (r + 0.1 * rng.normal(size=(5, 3)), r),
    }


def test_rotation_coordinate_matches_jax():
    """The square, the tetrahedron, the diatomic (a degenerate leading
    eigenvalue) and a generic fragment."""
    for case in ("square", "tetrahedron", "diatomic", "generic"):
        _check_rotation(*_rotation_cases()[case])


def _check_rotation(pos, ref):
    v_j = np.asarray(JP.rotation_value(jnp.asarray(pos), jnp.asarray(ref)))
    J_j = np.asarray(JP.rotation_jac(jnp.asarray(pos), jnp.asarray(ref)))
    H_j = np.asarray(JP.rotation_hess(jnp.asarray(pos), jnp.asarray(ref)))
    v_t = TP.rotation_value(_t(pos), _t(ref)).numpy()
    J_t = TP.rotation_jac(_t(pos), _t(ref)).numpy()
    H_t = TP.rotation_hess(_t(pos), _t(ref)).numpy()
    assert np.all(np.isfinite(H_t))
    np.testing.assert_allclose(v_t, v_j, atol=TOL)
    np.testing.assert_allclose(J_t, J_j, atol=TOL)
    np.testing.assert_allclose(H_t, H_j, atol=TOL)
    # forward-over-reverse (jvp of grad) through the rotation equals the
    # contraction of the forward-over-forward Hessian
    w = _t([0.7, -0.3, 1.1])
    v = _t(np.random.RandomState(3).normal(size=pos.shape))

    def f(x):
        return TP.rotation_value(x, _t(ref)) @ w

    hv = jvp(grad(f), (_t(pos),), (v,))[1].numpy()
    np.testing.assert_allclose(
        hv, np.einsum("a,aijkl,kl->ij", w.numpy(), H_t, v.numpy()),
        atol=TOL)


def test_rotation_hessian_fd_and_vmap():
    """The rotation Hessian is FD-exact on the degenerate square (the
    gate of ``tests/test_coords.py:219``), and the coordinate works
    under ``vmap`` over lanes."""
    pos, ref = _rotation_cases()["square"]
    H = TP.rotation_hess(_t(pos), _t(ref)).numpy()
    h = 1e-6
    fd = np.zeros_like(H)
    for a in range(pos.shape[0]):
        for c in range(3):
            pp, pm = pos.copy(), pos.copy()
            pp[a, c] += h
            pm[a, c] -= h
            fd[:, :, :, a, c] = (TP.rotation_jac(_t(pp), _t(ref)).numpy()
                                 - TP.rotation_jac(_t(pm), _t(ref)).numpy()
                                 ) / (2 * h)
    np.testing.assert_allclose(H, fd, atol=5e-9)
    P = _t(np.stack([pos, pos + 0.01]))
    Jb = vmap(TP.rotation_jac, in_dims=(0, None))(P, _t(ref))
    np.testing.assert_allclose(Jb[0].numpy(),
                               TP.rotation_jac(_t(pos), _t(ref)).numpy(),
                               atol=1e-14)


def test_kind_primitives_match_jax():
    """Per-coordinate bond/angle/dihedral values, gradients and Hessians
    against the JAX package, and the batched analytic forms (values,
    gradients, ``grad_and_jvp``) against ``torch.func`` autodiff."""
    rng = np.random.RandomState(0)
    for kind, k in (("bond", 2), ("angle", 3), ("dihedral", 4)):
        P = rng.normal(size=(6, k, 3))
        T = rng.normal(size=(6, k - 1, 3))
        V = rng.normal(size=(6, k, 3))
        vj = np.asarray(jax.vmap(getattr(JP, f"{kind}_value"))(
            jnp.asarray(P), jnp.asarray(T)))
        gj = np.asarray(jax.vmap(getattr(JP, f"{kind}_grad"))(
            jnp.asarray(P), jnp.asarray(T)))
        hj = np.asarray(jax.vmap(getattr(JP, f"{kind}_hess"))(
            jnp.asarray(P), jnp.asarray(T)))
        fn = getattr(TP, f"{kind}_value")
        np.testing.assert_allclose(vmap(fn)(_t(P), _t(T)).numpy(), vj,
                                   atol=TOL)
        np.testing.assert_allclose(
            vmap(getattr(TP, f"{kind}_grad"))(_t(P), _t(T)).numpy(), gj,
            atol=TOL)
        np.testing.assert_allclose(
            vmap(getattr(TP, f"{kind}_hess"))(_t(P), _t(T)).numpy(), hj,
            atol=TOL)
        np.testing.assert_allclose(
            TP.KIND_VALUES[kind](_t(P), _t(T)).numpy(), vj, atol=TOL)
        np.testing.assert_allclose(
            TP.KIND_GRADS[kind](_t(P), _t(T)).numpy(), gj, atol=TOL)
        hv = TP.grad_and_jvp(kind, _t(P), _t(T), _t(V))[1].numpy()
        np.testing.assert_allclose(
            hv, np.einsum("bijkl,bkl->bij", hj, V), atol=TOL)
        ref = jvp(lambda p: vmap(grad(fn))(p, _t(T)), (_t(P),),
                  (_t(V),))[1].numpy()
        np.testing.assert_allclose(hv, ref, atol=TOL)


def _constraints(A, C, norm):
    rng = np.random.RandomState(11)
    pos = rng.normal(size=(6, 3)) * 1.6
    atoms = A(["C", "C", "O", "H", "H", "N"], pos)
    cons = C(atoms)
    cons.fix_translation(0, dim=1)
    cons.fix_translation([1, 2])
    cons.fix_bond((0, 1))
    cons.fix_bond((2, 3), target=1.4, comparator="lt")
    cons.fix_angle((0, 1, 2), target=100.0)
    cons.fix_dihedral((0, 1, 2, 3))
    cons.fix_other(lambda p: norm(p[1] - p[0]) ** 2, [4, 5], target=3.0,
                   comparator="gt")
    cons.fix_rotation([1, 2, 3, 4])
    atoms.positions = pos + 0.05 * rng.normal(size=pos.shape)
    return cons


def test_constraints_match_jax():
    """``Constraints``: values, targets, residual (rotation rows zeroed,
    dihedrals wrapped), Jacobian and the curvature ``hessian_ldot``
    (rotation rows on a perturbed fragment), the inequality bookkeeping
    and ASE-constraint ingestion, against the JAX package."""
    cj = _constraints(JAtoms, JConstraints, jnp.linalg.norm)
    ct = _constraints(TAtoms, TConstraints, torch.linalg.norm)
    assert ct.ncons == cj.ncons == 12
    np.testing.assert_allclose(ct.targets, cj.targets, atol=TOL)
    np.testing.assert_allclose(ct.calc(), cj.calc(), atol=TOL)
    np.testing.assert_allclose(ct.residual(), cj.residual(), atol=TOL)
    np.testing.assert_allclose(ct.jacobian(), cj.jacobian(), atol=TOL)
    L = np.random.RandomState(2).normal(size=ct.ncons)
    np.testing.assert_allclose(ct.hessian_ldot(L), cj.hessian_ldot(L),
                               atol=TOL)
    ct.disable_satisfied_inequalities()
    cj.disable_satisfied_inequalities()
    assert ([r.active for r in ct._iter_records(False)]
            == [r.active for r in cj._iter_records(False)])
    assert ct.validate_inequalities() == cj.validate_inequalities()

    class FixAtoms:
        def __init__(self, index):
            self.index = index

    for c in (ct, cj):
        c.merge_ase_constraint(FixAtoms(index=[5]))
    np.testing.assert_allclose(ct.jacobian(), cj.jacobian(), atol=TOL)


def _check_eigh(A, lam_tol=1e-11, resid_tol=1e-11, orth_tol=1e-13):
    """The gates of ``tests/test_eigh_refined.py:_check``."""
    lams, V = batched_eigh(_t(A), "robust")
    lams, V = lams.numpy(), V.numpy()
    ln = np.linalg.eigh(A)[0]
    scale = max(np.max(np.abs(ln)), 1e-300)
    assert np.all(np.isfinite(lams)) and np.all(np.isfinite(V))
    assert np.max(np.abs(lams - ln)) / scale < lam_tol
    resid = np.einsum("...ij,...jk->...ik", A, V) - lams[..., None, :] * V
    assert np.max(np.abs(resid)) / scale < resid_tol
    gram = np.einsum("...ji,...jk->...ik", V, V)
    assert np.max(np.abs(gram - np.eye(A.shape[-1]))) < orth_tol
    assert np.all(np.diff(lams, axis=-1) >= -1e-12 * scale)


def test_robust_eigh_degenerate_cases():
    """``batched_eigh(.., "robust")`` (float64 ``torch.linalg.eigh``) on
    the degenerate-cluster, small-gap, scale and redundant-Gram cases of
    ``tests/test_eigh_refined.py:42-86``: the Gram matrices of the Xe4
    internal Jacobian with its multiplicity-5 zero cluster come from the
    port's own engine."""
    rng = np.random.RandomState(1)
    Q = np.linalg.qr(rng.normal(size=(16, 16)))[0]
    d = np.array([0, 0, 0, 0, 1, 1, 1, 2, 3.5, 3.5, 7, 9, 11, 13, 17, 100.0])
    _check_eigh(Q @ np.diag(d) @ Q.T)
    rng = np.random.RandomState(2)
    Q = np.linalg.qr(rng.normal(size=(5, 5)))[0]
    _check_eigh(Q @ np.diag([0.0, 1e-4, 1.0, 2.0, 3.0]) @ Q.T,
                lam_tol=1e-13, resid_tol=1e-12)
    rng = np.random.RandomState(3)
    Q = np.linalg.qr(rng.normal(size=(10, 10)))[0]
    d = np.array([0, 0, 0, 1, 2, 3, 5, 8, 13, 21.0])
    for s in (1e-8, 1.0, 1e8):
        _check_eigh(s * (Q @ np.diag(d) @ Q.T))

    rng = np.random.RandomState(4)
    pos0 = rng.normal(size=(4, 3), scale=3.0)
    ints = TInternals(TAtoms(["Xe"] * 4, pos0))
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    x = _t((pos0[None] + 0.3 * rng.normal(size=(6, 4, 3))))
    Bm = ints._get_engine()._jac_impl(x, torch.zeros(3, 3,
                                                     dtype=torch.float64))
    G = (Bm @ Bm.transpose(1, 2)).numpy()
    _check_eigh(G, lam_tol=1e-12, resid_tol=1e-12)
    lams = batched_eigh(_t(G), "robust")[0].numpy()
    assert np.all(np.sum(lams < 1e-10 * lams[:, -1:], axis=1) == 5)

    # the JAX package's own Gram matrices of the same geometries
    ji = JInternals(JAtoms(["Xe"] * 4, pos0))
    ji.find_all_bonds()
    ji.find_all_angles()
    ji.find_all_dihedrals()
    Bj = np.stack([np.asarray(ji._get_engine().jacobian(
        jnp.asarray(xx), jnp.zeros((3, 3)))) for xx in x.numpy()])
    np.testing.assert_allclose(Bm.numpy(), Bj, atol=TOL)


def test_rows_of_every_kind_off_equilibrium():
    """Engine rows of every coordinate kind at a perturbed geometry:
    translations, bonds, angles, dihedrals, a user coordinate and a
    displacement (``other``), and rotations, against the JAX engine,
    plus the FD self-checks of both packages' B and ``hessian_ldot``."""
    r, ang = 0.9575, np.radians(104.51)
    water = np.array([[0, 0, 0], [r, 0, 0],
                      [r * np.cos(ang), r * np.sin(ang), 0]])
    base = np.vstack([water, water + np.array([6.0, 0.2, 0.1])])
    sym = ["O", "H", "H"] * 2
    pos = base + 0.05 * np.random.RandomState(1).normal(size=base.shape)
    out = []
    for A, I, norm in ((JAtoms, JInternals, jnp.linalg.norm),
                       (TAtoms, TInternals, torch.linalg.norm)):
        ints = I(A(sym, base), allow_fragments=True)
        ints.find_all_bonds()
        ints.find_all_angles()
        ints.find_all_dihedrals()
        ints.add_dihedral((1, 0, 3, 4))
        ints.add_user_coordinate(lambda p, norm=norm: norm(p[1] - p[0]),
                                 np.array([1, 4]))
        ints.add_displacement()
        ints.atoms.positions = pos.copy()
        out.append(ints)
    ji, ti = out
    counts = (ti.ntrans, ti.nbonds, ti.nangles, ti.ndihedrals, ti.nother,
              ti.nrotations)
    assert all(c > 0 for c in counts), counts
    rng = np.random.RandomState(2)
    v = rng.normal(size=ji.ndof)
    w = rng.normal(size=ji.nint)
    np.testing.assert_allclose(ti.calc(), ji.calc(), atol=TOL)
    np.testing.assert_allclose(ti.jacobian(), ji.jacobian(), atol=TOL)
    np.testing.assert_allclose(ti.hessian_rdot(v), ji.hessian_rdot(v),
                               atol=TOL)
    np.testing.assert_allclose(ti.hessian_ldot(w), ji.hessian_ldot(w),
                               atol=TOL)
    assert ti.check_gradient() < 1e-6
    assert ti.check_hessian() < 1e-4
