"""The per-lane repave of the port's internal tier against the JAX
package (``tests/test_repave.py``): the rebuilt lane topology, the union
merge and its layout maps, ``repave_lanes`` (activity rows, the Hessian
transferred through Cartesian space, q and gq re-derived) on the LJ
tetrahedron with a 179.8-degree lane and on the O=C=O dummy topology
(layout kept, and layout changed with the dummy re-attached;
``tests/test_repave.py:244``), and the
in-place convergence of a repaved lane, per lane against the JAX run.
At most 6 cases."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sella_tpu  # noqa: F401  (float64 before any jnp use)
from sella_tpu import Atoms as JAtoms
from sella_tpu.coords.internals import Internals as JInternals
from sella_tpu.parallel import ensemble_internal as JE
from sella_tpu.potentials import LennardJones as JLJ

from sella_tpu_torch import Atoms as TAtoms
from sella_tpu_torch import LennardJones as TLJ
from sella_tpu_torch.coords.internals import Internals as TInternals
from sella_tpu_torch.parallel import ensemble_internal as TE

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


R0 = 2.0 ** (1.0 / 6.0)     # LJ pair minimum for sigma=eps=1
COUNTS = ("nsteps", "nmatvec", "neval", "converged")


def _tet():
    return np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                     [0.5, np.sqrt(3.0) / 2.0, 0.0],
                     [0.5, np.sqrt(3.0) / 6.0, np.sqrt(2.0 / 3.0)]]) * R0


def _near_linear():
    """A-B-C at 179.8 deg, D off-axis: inside the 0.5-deg window of a
    tetrahedron-built topology."""
    th = np.radians(0.2)
    b = np.array([R0, 0.0, 0.0])
    c = b + R0 * np.array([np.cos(th), np.sin(th), 0.0])
    d = np.array([R0, 0.75 * R0, 0.6 * R0])
    return np.stack([np.zeros(3), b, c, d])


OCO = np.array([[-1.16, 0.0, 0.0], [0.0, 0.0, 0.0], [1.16, 0.0, 0.0],
                [1.6, 0.85, 0.0], [1.6, -0.85, 0.0]])


def _oco_folded():
    """H-O-H folded to 179.7 deg: the bend is covered by an improper,
    so the dummy layout survives the rebuild."""
    p = OCO.copy()
    u = np.array([0.0026, 1.0, 0.0])
    u /= np.linalg.norm(u)
    p[3] = OCO[2] + 0.957 * u
    p[4] = OCO[2] + 0.957 * np.array([u[0], -u[1], 0.0])
    return p


def _oco_bent():
    """O-C-O bent: rediscovery would lose the dummy center, so the lane
    repaves dummy-free with the original dummy re-attached."""
    p = OCO.copy()
    p[0] = [-1.0, 0.6, 0.0]
    return p


def _ints(A, I, symbols, pos):
    ints = I(A(symbols, pos))
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    return ints


def _same_topology(a, b):
    for ka in ("bonds", "angles", "dihedrals"):
        ra, rb = getattr(a, ka), getattr(b, ka)
        assert len(ra) == len(rb), ka
        for x, y in zip(ra, rb):
            for u, v in zip(x, y):
                assert np.array_equal(np.asarray(u), np.asarray(v)), (x, y)
    assert (a.ntrans, a.nother, a.nrotations, a.ndummies) == (
        b.ntrans, b.nother, b.nrotations, b.ndummies)
    np.testing.assert_array_equal(a.dinds, b.dinds)


def _jax_state(ts):
    """The port's state as the JAX package's (the same numbers)."""
    return JE.InternalSearchState(**{
        k: jnp.asarray(getattr(ts, k).numpy()) for k in ts._fields})


def test_rebuild_and_merge_match_jax():
    ji = _ints(JAtoms, JInternals, ["He"] * 4, _tet())
    ti = _ints(TAtoms, TInternals, ["He"] * 4, _tet())
    lj = JE.rebuild_internals_at(ji, _near_linear())
    lt = TE.rebuild_internals_at(ti, _near_linear())
    _same_topology(lj, lt)
    assert lt.ndummies == 0
    for (i, j, k, _) in lt.angles:
        assert {i, j, k} != {0, 1, 2}
    mj, nj = JE.merge_novel_internals(ji, lj)
    mt, nt = TE.merge_novel_internals(ti, lt)
    assert nj == nt and mt.nint == ti.nint + sum(nt)
    _same_topology(mj, mt)
    np.testing.assert_array_equal(TE._old_to_new_map(ti, mt),
                                  JE._old_to_new_map(ji, mj))
    np.testing.assert_array_equal(TE._membership_rows(mt, lt),
                                  JE._membership_rows(mj, lj))


CASES = {
    # name -> (symbols, base, lanes, bad mask or None (detect))
    "tetrahedron": (["He"] * 4, _tet(), [_tet(), _near_linear()], None),
    "dummy_kept": (["O", "C", "O", "H", "H"], OCO, [OCO, _oco_folded()],
                   None),
    "dummy_reattached": (["O", "C", "O", "H", "H"], OCO, [OCO, _oco_bent()],
                         [False, True]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_repave_lanes_matches_jax(name):
    symbols, base, lanes, bad = CASES[name]
    ji = _ints(JAtoms, JInternals, symbols, base)
    ti = _ints(TAtoms, TInternals, symbols, base)
    ncons = sum(1 for _ in ti.cons._iter_records(only_active=False))
    kw = dict(natoms=len(base), nint=ti.nint, ndummies=ti.ndummies,
              ncons=ncons, order=0, fmax=1e-3, gamma=0.1, eig=False)
    tcfg = TE.InternalEnsembleConfig(**kw)
    jcfg = JE.InternalEnsembleConfig(**kw)
    x0 = np.stack([p.ravel() for p in lanes])
    ts = TE.init_internal_state(TLJ(), ti, x0, tcfg, device="cpu")
    js = _jax_state(ts)
    if bad is None:
        bad = TE.bad_internals_mask(ts, ti, 0.5).numpy()
        np.testing.assert_array_equal(
            bad, np.asarray(JE.bad_internals_mask(js, ji, 0.5)))
        assert list(bad) == [False, True]
    bad = np.asarray(bad)
    ts2, ti2, tcfg2, tdone = TE.repave_lanes(ts, ti, tcfg, bad)
    js2, ji2, jcfg2, jdone = JE.repave_lanes(js, ji, jcfg, bad)
    np.testing.assert_array_equal(tdone, jdone)
    assert tdone[1:].all() and not tdone[0]
    _same_topology(ti2, ji2)
    assert tcfg2 == TE.InternalEnsembleConfig(**{**kw, "nint": ji2.nint})
    np.testing.assert_array_equal(ts2.qact.numpy(), np.asarray(js2.qact))
    for k in ("q", "gq"):
        np.testing.assert_allclose(getattr(ts2, k).numpy(),
                                   np.asarray(getattr(js2, k)), atol=1e-9)
    Hj = np.asarray(js2.H)
    assert np.max(np.abs(ts2.H.numpy() - Hj)) <= 1e-9 * np.abs(Hj).max()
    # every repaved lane: finite symmetric H, masked B spanning nred
    eng = ti2._get_engine()
    n = tcfg.natoms + tcfg.ndummies
    for lane in np.where(tdone)[0]:
        H = ts2.H[lane].numpy()
        assert np.all(np.isfinite(H))
        np.testing.assert_allclose(H, H.T, atol=1e-8)
        Bn = eng._jac_impl(ts2.x[lane].reshape(n, 3), torch.zeros(
            3, 3, dtype=torch.float64)).numpy() * ts2.qact[lane].numpy()[
                :, None]
        sv = np.linalg.svd(Bn, compute_uv=False)
        assert int(np.sum(sv > 1e-8 * sv[0])) == tcfg.nred


def test_lane_converges_in_place_after_repave():
    """The near-linear lane is repaved and converges in place, with the
    same per-lane counts and geometry as the JAX package's run."""
    rng = np.random.RandomState(0)
    lanes = [_tet().ravel() + 0.05 * rng.normal(size=12),
             _near_linear().ravel(),
             _tet().ravel() + 0.05 * rng.normal(size=12)]
    x0 = np.stack(lanes)
    out = []
    for A, I, E, P in ((JAtoms, JInternals, JE, JLJ),
                       (TAtoms, TInternals, TE, TLJ)):
        ints = _ints(A, I, ["He"] * 4, _tet())
        cfg = E.InternalEnsembleConfig(natoms=4, nint=ints.nint, order=0,
                                       fmax=1e-3, gamma=0.1, eig=False)
        kw = {} if E is JE else dict(device="cpu")
        out.append(E.run_internal_ensemble(
            P(), ints, jnp.asarray(x0) if E is JE else x0, cfg,
            max_steps=150, repave=True, **kw))
    (js, ji2), (ts, ti2) = out
    _same_topology(ti2, ji2)
    for k in COUNTS + ("qact",):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=1e-6)
    assert bool(ts.converged.all()) and not ts.qact[1].all()
    g = torch.func.grad(TLJ().energy)(ts.x[1], torch.zeros(
        3, 3, dtype=torch.float64))
    assert np.linalg.norm(g.reshape(4, 3).numpy(), axis=1).max() < 5e-3


def test_repave_with_fixed_bond():
    """A constrained lane whose angle goes singular is repaved in place
    and converges with the bond held at its target; the constrained row
    stays active (the gates of ``tests/test_repave.py:137``)."""
    ti = _ints(TAtoms, TInternals, ["He"] * 4, _tet())
    target = 1.1 * R0
    ti.cons.fix_bond((0, 1), target=target)
    cfg = TE.InternalEnsembleConfig(natoms=4, nint=ti.nint, order=0,
                                    fmax=1e-3, gamma=0.1, eig=False,
                                    ncons=1, delta0=0.05)
    rng = np.random.RandomState(2)
    x0 = np.stack([_tet().ravel() + 0.05 * rng.normal(size=12),
                   _near_linear().ravel()])
    state, ti2 = TE.run_internal_ensemble(TLJ(), ti, x0, cfg,
                                          max_steps=200, repave=True,
                                          device="cpu")
    assert bool(state.converged.all()), state.nsteps
    qact = state.qact.numpy()
    assert not qact[1].all()
    idx, _ = TE.fixed_internal_constraints(ti2)
    assert qact[:, idx].all()
    for lane in range(2):
        pos = state.x[lane].numpy().reshape(4, 3)
        np.testing.assert_allclose(np.linalg.norm(pos[1] - pos[0]), target,
                                   atol=2e-3)
