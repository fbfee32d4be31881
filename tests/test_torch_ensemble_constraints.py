"""Parity of the port's constrained ensemble with the JAX package on the
LJ4 configs of ``tests/test_ensemble.py``: the 0-1 bond pinned at 1.3 as
an equality (minimization and saddle) and as a ``"gt"`` inequality
(binding at 1.3, free at 1.0).

The minimizations run ``eig=False`` (no Davidson, so no random draw):
lane by lane, identical ``converged``, ``nsteps``, ``neval`` and
``nmatvec``, and ``x`` within 1e-8. The constrained saddle runs Davidson
on the Lagrangian Hessian (forward-mode ``jvp`` over ``jacfwd`` of the
constraint): identical counts and energies within 1e-8 on the lanes it
runs (see its docstring).
``constrained_free_basis`` is compared through its projector ``U U^T``
(the basis itself depends on the QR implementation) within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.parallel.ensemble as J
import sella_tpu_torch.parallel.ensemble as T
from sella_tpu.potentials import LennardJones as JLJ
from sella_tpu_torch.potentials import LennardJones as TLJ

torch.set_num_threads(1)

X_ATOL = 1e-8
P_ATOL = 1e-12
COUNTERS = ("converged", "nsteps", "neval", "nmatvec")

TET = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * 1.12


def _starts(seed, lanes=8):
    rng = np.random.RandomState(seed)
    return (TET[None] + 0.05 * rng.normal(size=(lanes, 4, 3))).reshape(
        lanes, 12)


def _bond_jax(rt):
    def cons(x):
        p = x.reshape(-1, 3)
        return jnp.array([jnp.linalg.norm(p[0] - p[1]) - rt])

    return cons


def _bond_torch(rt):
    def cons(x):
        p = x.reshape(-1, 3)
        return torch.linalg.norm(p[0] - p[1]).reshape(1) - rt

    return cons


def _bond_length(x):
    p = np.asarray(x).reshape(-1, 4, 3)
    return np.linalg.norm(p[:, 0] - p[:, 1], axis=1)


def _run_both(kw, x0, rt, comparators=None, max_steps=200):
    js = J.run_ensemble(JLJ(), jnp.asarray(x0), J.EnsembleConfig(**kw),
                        max_steps=max_steps, constraints=_bond_jax(rt),
                        comparators=comparators)
    ts = T.run_ensemble(TLJ(), torch.as_tensor(x0), T.EnsembleConfig(**kw),
                        max_steps=max_steps, constraints=_bond_torch(rt),
                        comparators=comparators)
    return js, ts


def _assert_lanes(ts, js, lanes):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(ts, f).numpy()[lanes],
                                      np.asarray(getattr(js, f))[lanes],
                                      err_msg=f)


@pytest.mark.parametrize("nproj", [0, 3, 6])
def test_constrained_free_basis_projector_matches_jax(nproj):
    rng = np.random.RandomState(nproj)
    x = rng.normal(size=(3, 12)) * 1.5
    jac_j = jax.jacfwd(_bond_jax(1.3))
    jac_t = torch.func.jacfwd(_bond_torch(1.3))
    U_t = T.constrained_free_basis(torch.as_tensor(x), nproj, jac_t).numpy()
    width = 12 - (3 if nproj == 3 else nproj) - 1
    assert U_t.shape == (3, 12, width)
    for b in range(3):
        U_j = np.asarray(J.constrained_free_basis(jnp.asarray(x[b]), nproj,
                                                  jac_j))
        np.testing.assert_allclose(U_t[b] @ U_t[b].T, U_j @ U_j.T,
                                   rtol=0, atol=P_ATOL)


def test_equality_minimization_matches_jax():
    """``test_ensemble_constrained_minimization``: every lane converges
    with the bond at 1.3."""
    kw = dict(natoms=4, order=0, fmax=1e-4, ncons=1, ctol=1e-6, eig=False,
              method="qn")
    js, ts = _run_both(kw, _starts(3), 1.3)
    assert bool(ts.converged.all())
    _assert_lanes(ts, js, slice(None))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=X_ATOL)
    assert np.abs(_bond_length(ts.x.numpy()) - 1.3).max() < 1e-5


@pytest.mark.parametrize("rt,binding", [(1.3, True), (1.0, False)])
def test_inequality_minimization_matches_jax(rt, binding):
    """``test_ensemble_inequality_constraints``: bond >= 1.3 binds and
    pins the bond at the boundary; bond >= 1.0 leaves the free minimum
    (2^(1/6)) untouched."""
    kw = dict(natoms=4, order=0, fmax=1e-4, ncons=1, ctol=1e-6, eig=False,
              method="qn")
    js, ts = _run_both(kw, _starts(3), rt, comparators=("gt",))
    assert bool(ts.converged.all())
    _assert_lanes(ts, js, slice(None))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=X_ATOL)
    target = 1.3 if binding else 2.0 ** (1 / 6)
    assert np.abs(_bond_length(ts.x.numpy()) - target).max() < (
        1e-4 if binding else 1e-3)


def test_constrained_saddle_matches_jax():
    """``test_ensemble_constrained_saddle``: order 1 with Davidson on the
    Lagrangian Hessian. Of its eight lanes (independent: no
    ``diag_budget``) the three that converge within 45 steps run here
    (lanes 1, 6, 7; 16-41 steps). Lanes 0, 3, 4 and 5 need 49-117 steps,
    too long for this file; lane 2 amplifies rounding: one step
    from a carried JAX state agrees to 6e-12 at every step, but free runs
    part by 1e-7 at step 60 and 2e-5 at step 70, and it converges at step
    118 in JAX and 190 in the port."""
    kw = dict(natoms=4, order=1, fmax=1e-3, ncons=1)
    js, ts = _run_both(kw, _starts(0)[[1, 6, 7]], 1.3, max_steps=60)
    assert bool(np.asarray(js.converged).all())
    _assert_lanes(ts, js, slice(None))
    np.testing.assert_allclose(ts.f.numpy(), np.asarray(js.f), rtol=0,
                               atol=X_ATOL)
    assert np.abs(_bond_length(ts.x.numpy()) - 1.3).max() < 1e-3


def test_lagrangian_hvp_matches_jax():
    """The Davidson operator with constraints, ``H v - (d/dv) J^T lam``,
    on random geometries and directions (forward over forward in both)."""
    rng = np.random.RandomState(1)
    x = _starts(1, 4) + 0.1 * rng.normal(size=(4, 12))
    v = rng.normal(size=(4, 12))
    lam = rng.normal(size=(4, 1))
    jac_j = jax.jacfwd(_bond_jax(1.3))
    jac_t = torch.func.jacfwd(_bond_torch(1.3))

    def corr_j(x1, v1, l1):
        return jax.jvp(lambda y: jac_j(y).T @ l1, (x1,), (v1,))[1]

    def corr_t(x1, v1, l1):
        return torch.func.jvp(lambda y: jac_t(y).T @ l1, (x1,), (v1,))[1]

    a = torch.func.vmap(corr_t)(*(torch.as_tensor(t) for t in (x, v, lam)))
    b = jax.vmap(corr_j)(*(jnp.asarray(t) for t in (x, v, lam)))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                               atol=1e-12)
