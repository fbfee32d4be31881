"""Dummy atoms, fixed internal coordinates and rigid-water TRICs in the
port's batched internal tier, against the JAX package on the configs of
``tests/test_ensemble_internal.py:125-228, 436-548``: a linear Xe3 chain
with its dummy atom (order 0), an Xe4 tetrahedron with one bond fixed at
a stretched target (order 0), and two TIP3P waters held rigid by fixed
bonds and angles with per-fragment translation and rotation coordinates
(``nproj=0``). Per lane ``nsteps``, ``nmatvec``, ``neval`` and
``converged`` are identical and ``x`` agrees within 1e-6 on the lanes a
1e-13 perturbation leaves unchanged in the JAX package; the port's
results also meet the JAX tests' own physical gates. At most 6 cases;
each JAX configuration compiles once."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sella_tpu  # noqa: F401  (float64 before any jnp use)
from sella_tpu import Atoms as JAtoms
from sella_tpu.coords.internals import Internals as JInternals
from sella_tpu.parallel import ensemble_internal as JE
from sella_tpu.potentials import MorsePotential as JMorse
from sella_tpu.potentials.tip3p import TIP3P as JTIP3P
from sella_tpu.utils.units import kB

from sella_tpu_torch import Atoms as TAtoms
from sella_tpu_torch import MorsePotential as TMorse
from sella_tpu_torch.coords.constraints import DuplicateInternalError
from sella_tpu_torch.coords.internals import Internals as TInternals
from sella_tpu_torch.parallel import ensemble_internal as TE
from sella_tpu_torch.potentials import TIP3P as TTIP3P
from sella_tpu_torch.potentials.tip3p import angleHOH, rOH, water_cluster

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One OpenBLAS thread for the LAPACK calls of both packages (the JAX
    reference's eigh, numpy's pinv and svd): the test lane runs six
    workers on a few cores, where every worker's default thread pool
    spins against the others'. The results are the same to rounding."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


R0 = 4.73
COUNTS = ("nsteps", "nmatvec", "neval", "converged")
TET = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * R0


def _build(A, I, symbols, pos, frag=False, setup=None):
    ints = I(A(symbols, pos), allow_fragments=frag)
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    if setup is not None:
        setup(ints)
    return ints


def _fix_bond(ints):
    try:
        ints.add_bond((0, 1))
    except Exception:        # either package's DuplicateInternalError
        pass
    ints.cons.fix_bond((0, 1), target=1.15 * R0)


def _rigid_waters(ints):
    for i in range(2):
        ints.cons.fix_bond((3 * i, 3 * i + 1), target=rOH)
        ints.cons.fix_bond((3 * i, 3 * i + 2), target=rOH)
        ints.cons.fix_angle((3 * i + 1, 3 * i, 3 * i + 2), target=angleHOH)


def _morse(P):
    return P(epsilon=226.9 * kB, r0=R0, rho0=R0 * 1.099)


# name -> (symbols, base positions, start jitter, start seed, potentials,
#          fragments, setup, config, max steps)
CONFIGS = {
    "dummy": (["Xe"] * 3, np.array([[0.0, 0, 0], [R0, 0, 0], [2 * R0, 0, 0]]),
              0.2, 0, (_morse(JMorse), _morse(TMorse)), False, None,
              dict(natoms=3, order=0, fmax=1e-3, ndummies=1, ncons=2,
                   delta0=0.05), 40),
    "fixed_bond": (["Xe"] * 4, TET, 0.15, 1, (_morse(JMorse), _morse(TMorse)),
                   False, _fix_bond,
                   dict(natoms=4, order=0, fmax=1e-3, ncons=1, delta0=0.05),
                   80),
    "rigid_water": (["O", "H", "H"] * 2, water_cluster(nside=2)[:6], 0.01, 2,
                    (JTIP3P(nmol=2), TTIP3P(nmol=2)), True, _rigid_waters,
                    dict(natoms=6, order=0, nproj=0, ncons=6, fmax=1e-3,
                         delta0=1e-2, gamma=0.1), 150),
}


def _jax_run(step, init, x0, max_steps):
    st = init(jnp.asarray(x0))
    key = jax.random.PRNGKey(0)
    for i in range(max_steps):
        st = step(st, jax.random.fold_in(key, i))
        if bool(jnp.all(st.converged)):
            break
    return st


def _np(st, k):
    v = getattr(st, k)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _run_both(name):
    sym, pos, jit_, seed, (jpot, tpot), frag, setup, kw, nmax = \
        CONFIGS[name]
    ji = _build(JAtoms, JInternals, sym, pos, frag, setup)
    ti = _build(TAtoms, TInternals, sym, pos, frag, setup)
    idx_j, tgt_j = JE.fixed_internal_constraints(ji)
    idx_t, tgt_t = TE.fixed_internal_constraints(ti)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(tgt_t, tgt_j, atol=1e-12)
    assert ti.nint == ji.nint and ti.ndummies == ji.ndummies
    x0 = (pos[None] + jit_ * np.random.RandomState(seed).normal(
        size=(8,) + pos.shape)).reshape(8, -1)

    H0 = ji.guess_hessian()
    ji.guess_hessian = lambda *a, **k: H0
    jcfg = JE.InternalEnsembleConfig(nint=ji.nint, **kw)
    jinit = jax.jit(lambda x: JE.init_internal_state(jpot, ji, x, jcfg))
    jstep = jax.jit(JE.make_internal_step_fn(jpot, ji, jcfg))
    js = _jax_run(jstep, jinit, x0, nmax)
    jp = _jax_run(jstep, jinit, x0 + 1e-13 * np.random.RandomState(9).normal(
        size=x0.shape), nmax)
    stable = np.ones(len(x0), bool)
    for k in COUNTS:
        stable &= _np(js, k) == _np(jp, k)
    stable &= np.max(np.abs(_np(js, "x") - _np(jp, "x")), axis=1) < 1e-6
    assert stable.sum() >= 6, stable

    tcfg = TE.InternalEnsembleConfig(nint=ti.nint, **kw)
    ts = TE.run_internal_ensemble(tpot, ti, x0, tcfg, max_steps=nmax,
                                  device="cpu")
    for k in COUNTS:
        np.testing.assert_array_equal(_np(ts, k)[stable],
                                      _np(js, k)[stable], err_msg=k)
    np.testing.assert_allclose(_np(ts, "x")[stable], _np(js, "x")[stable],
                               atol=1e-6)
    assert bool(ts.converged.all()), _np(ts, "nsteps")
    return ti, ts, idx_t


def test_dummy_atoms_match_jax():
    ti, ts, idx = _run_both("dummy")
    assert ti.ndummies == 1 and len(idx) == 2
    x = ts.x.numpy()
    for b in range(x.shape[0]):
        p = x[b].reshape(-1, 3)        # 3 real + 1 dummy
        assert abs(np.linalg.norm(p[1] - p[0]) - R0) < 0.05
        assert abs(np.linalg.norm(p[2] - p[1]) - R0) < 0.05
        dvec = p[3] - p[1]
        np.testing.assert_allclose(np.linalg.norm(dvec), 1.0, atol=1e-8)
        cosang = np.dot(p[0] - p[1], dvec) / np.linalg.norm(p[0] - p[1])
        np.testing.assert_allclose(cosang, 0.0, atol=1e-8)
    assert int(ts.nsteps.max()) <= 20


def test_fixed_bond_matches_jax():
    ti, ts, idx = _run_both("fixed_bond")
    x = ts.x.numpy()
    d01 = np.linalg.norm(x[:, 3:6] - x[:, 0:3], axis=1)
    np.testing.assert_allclose(d01, 1.15 * R0, atol=1e-4)
    lam = ts.gq.numpy()[:, idx[0]]
    assert np.all(lam > 1e-3) and lam.std() < 0.2 * lam.mean()


def test_rigid_water_trics_match_jax():
    ti, ts, idx = _run_both("rigid_water")
    assert ti.nrotations == 6 and len(idx) == 6
    x = ts.x.numpy().reshape(8, 6, 3)
    for b in range(8):
        for i in range(2):
            d1 = np.linalg.norm(x[b, 3 * i] - x[b, 3 * i + 1])
            d2 = np.linalg.norm(x[b, 3 * i] - x[b, 3 * i + 2])
            np.testing.assert_allclose([d1, d2], rOH, atol=1e-6)
            v1 = x[b, 3 * i + 1] - x[b, 3 * i]
            v2 = x[b, 3 * i + 2] - x[b, 3 * i]
            ang = np.degrees(np.arccos(
                v1 @ v2 / (np.linalg.norm(v1) * np.linalg.norm(v2))))
            np.testing.assert_allclose(ang, angleHOH, atol=1e-4)


def test_fixed_constraint_mapping_and_errors():
    """The reversed-angle periodic offsets map onto the same q row
    (``tests/test_ensemble_internal.py:436``); a non-equality or an
    unmappable constraint raises; the config checks raise."""
    a = 3.0
    pos = np.array([[0.2, 0.5, 0.5], [1.5, 0.5, 0.5], [2.8, 0.5, 0.5]])
    ints = TInternals(TAtoms(["Xe"] * 3, pos, cell=np.eye(3) * a, pbc=True))
    ints.find_all_bonds()
    ints.find_all_angles()
    cand = [(m, rec) for m, rec in enumerate(ints.angles)
            if np.any(np.asarray(rec[3]) != 0)]
    assert cand
    m, (i, j, k, anc) = cand[0]
    ints.cons.fix_angle((k, j, i), ncvecs=-np.asarray(anc)[::-1])
    idx, _ = TE.fixed_internal_constraints(ints)
    assert (ints.ntrans + ints.nbonds + m) in list(idx)

    tet = TInternals(TAtoms(["Xe"] * 4, TET))
    tet.find_all_bonds()
    tet.cons.fix_bond((0, 1), target=5.0, comparator="lt")
    with pytest.raises(ValueError, match="equality"):
        TE.fixed_internal_constraints(tet)
    tet2 = TInternals(TAtoms(["Xe"] * 4, TET))
    tet2.find_all_bonds()
    tet2.cons.fix_dihedral((0, 1, 2, 3))
    with pytest.raises(ValueError, match="no matching"):
        TE.fixed_internal_constraints(tet2)
    with pytest.raises(DuplicateInternalError):
        tet2.add_bond((0, 1))
    cfg = TE.InternalEnsembleConfig(natoms=4, nint=tet2.nint + 1)
    with pytest.raises(ValueError, match="nint"):
        TE.make_internal_step_fn(_morse(TMorse), tet2, cfg)
