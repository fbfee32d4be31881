"""The port's batched internal-coordinate tier against the JAX package on
the bench's Morse Xe4 configuration (``bench.py:552-640``), 8 lanes:

* one step from the same start, with full Newton and with the chord
  back-transform: x, q, gq and f within 1e-9, H within 1e-9 of its
  scale, and the counts identical;
* the geodesic rescue of a large concerted step on a floppy chain
  (``tests/test_ensemble_internal.py:550``);
* whole runs at order 1 and order 0 (40 steps): per lane ``nsteps``,
  ``nmatvec``, ``neval`` and ``converged`` identical and ``x`` within
  1e-6 on the lanes that a 1e-13 perturbation of the start leaves
  unchanged in the JAX package itself (chaotic lanes amplify rounding).

Each JAX configuration is compiled once (its step and the shared
``init_internal_state`` are jitted); the file keeps at most 6 cases."""
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
from sella_tpu.utils.units import kB

from sella_tpu_torch import Atoms as TAtoms
from sella_tpu_torch import MorsePotential as TMorse
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


R0 = 4.73
MAX_STEPS = 40
COUNTS = ("nsteps", "nmatvec", "neval", "converged")


def _ints(A, I, pos):
    ints = I(A(["Xe"] * len(pos), pos))
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    return ints


@pytest.fixture(scope="module")
def xe4():
    """Both packages' Xe4 topologies, potentials and 8 starts (the
    bench's: ``pos0`` from RandomState(4), starts from RandomState(0)),
    the JAX topology's guess Hessian computed once so that a jitted
    ``init_internal_state`` can read it, and a jitted JAX init."""
    pos0 = np.random.RandomState(4).normal(size=(4, 3), scale=3.0)
    x0 = (pos0[None] + 0.3 * np.random.RandomState(0).normal(
        size=(8, 4, 3))).reshape(8, 12)
    ji = _ints(JAtoms, JInternals, pos0)
    ti = _ints(TAtoms, TInternals, pos0)
    H0 = ji.guess_hessian()
    ji.guess_hessian = lambda *a, **k: H0
    jpot = JMorse(epsilon=226.9 * kB, r0=R0, rho0=R0 * 1.099)
    tpot = TMorse(epsilon=226.9 * kB, r0=R0, rho0=R0 * 1.099)
    base = dict(natoms=4, nint=ji.nint, fmax=1e-3, gamma=1e-3)
    cfg0 = JE.InternalEnsembleConfig(order=1, **base)
    jinit = jax.jit(lambda x: JE.init_internal_state(jpot, ji, x, cfg0))
    return dict(x0=x0, ji=ji, ti=ti, jpot=jpot, tpot=tpot, base=base,
                jinit=jinit, steps={})


def _jax_step(env, kw):
    key = tuple(sorted(kw.items()))
    if key not in env["steps"]:
        cfg = JE.InternalEnsembleConfig(**env["base"], **kw)
        env["steps"][key] = jax.jit(
            JE.make_internal_step_fn(env["jpot"], env["ji"], cfg))
    return env["steps"][key]


def _jax_run(env, kw, x0):
    step = _jax_step(env, kw)
    st = env["jinit"](jnp.asarray(x0))
    key = jax.random.PRNGKey(0)
    for i in range(MAX_STEPS):
        st = step(st, jax.random.fold_in(key, i))
        if bool(jnp.all(st.converged)):
            break
    return st


def _np(st, k):
    v = getattr(st, k)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("chord", [False, True])
def test_one_step_matches_jax(xe4, chord):
    kw = dict(order=1, newton_chord=chord)
    js0 = xe4["jinit"](jnp.asarray(xe4["x0"]))
    js1 = _jax_step(xe4, kw)(js0, jax.random.PRNGKey(0))
    cfg = TE.InternalEnsembleConfig(**xe4["base"], **kw)
    ts0 = TE.init_internal_state(xe4["tpot"], xe4["ti"], xe4["x0"], cfg,
                                 device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    ts1 = TE.make_internal_step_fn(xe4["tpot"], xe4["ti"], cfg)(ts0, g)
    for js, ts in ((js0, ts0), (js1, ts1)):
        for k in ("x", "q", "gq", "f", "g", "delta"):
            np.testing.assert_allclose(_np(ts, k), _np(js, k), atol=1e-9,
                                       err_msg=k)
        Hj = _np(js, "H")
        assert np.max(np.abs(_np(ts, "H") - Hj)) <= 1e-9 * np.abs(Hj).max()
        for k in COUNTS + ("nsteps_since_diag", "qact"):
            np.testing.assert_array_equal(_np(ts, k), _np(js, k), err_msg=k)
    assert int(ts1.nmatvec.sum()) > 0      # the bootstrap Davidson ran


def _chain():
    ang = np.deg2rad(70.0)
    pos = [np.zeros(3)]
    p = np.zeros(3)
    for i in range(4):
        rot = 1 if i % 2 == 0 else -1
        dd = np.array([np.cos(rot * (np.pi - ang) / 2),
                       np.sin(rot * (np.pi - ang) / 2),
                       0.25 * ((i % 3) - 1)])
        p = p + R0 * dd / np.linalg.norm(dd)
        pos.append(p.copy())
    return np.array(pos)


def test_geodesic_fallback_rescues_newton():
    """A large concerted step on a floppy Xe5 chain (every angle to
    172 deg, both dihedrals rotated 2.8 rad, all bonds compressed 35%):
    Newton alone diverges on every lane in both packages, and the RK4
    geodesic initializer plus a Newton polish realizes the target to
    machine precision in both, with the same realized step."""
    pos = _chain()
    x0 = (pos[None] + 0.02 * np.random.RandomState(0).normal(
        size=(4, 5, 3))).reshape(4, 15)
    ji = _ints(JAtoms, JInternals, pos)
    ti = _ints(TAtoms, TInternals, pos)
    assert ti.ndihedrals >= 2
    jpot = JMorse(epsilon=226.9 * kB, r0=R0, rho0=4.0)
    tpot = TMorse(epsilon=226.9 * kB, r0=R0, rho0=4.0)
    ob, oa = ti.ntrans, ti.ntrans + ti.nbonds
    od = oa + ti.nangles

    def target(q0):
        dq = np.zeros_like(q0)
        dq[:, ob:oa] = -0.35 * R0
        dq[:, oa:od] = np.deg2rad(172.0) - q0[:, oa:od]
        dq[:, od:od + ti.ndihedrals] = 2.8
        return dq

    out = {}
    for geo in (0, 24):
        kw = dict(natoms=5, nint=ti.nint, order=1, geo_substeps=geo)
        js = JE.make_internal_step_fn(jpot, ji,
                                      JE.InternalEnsembleConfig(**kw))
        q0 = np.asarray(js.batch_q(jnp.asarray(x0)))
        dq = target(q0)
        _, dr_j = js.newton_set_x(jnp.asarray(x0), jnp.asarray(q0),
                                  jnp.asarray(dq))
        ts = TE.make_internal_step_fn(tpot, ti,
                                      TE.InternalEnsembleConfig(**kw))
        q0t = ts.batch_q(torch.as_tensor(x0))
        np.testing.assert_allclose(q0t.numpy(), q0, atol=1e-10)
        _, dr_t = ts.newton_set_x(torch.as_tensor(x0), q0t,
                                  torch.as_tensor(dq))
        res_j = np.max(np.abs(np.asarray(js.wrap_dq(
            jnp.asarray(dq) - dr_j))), axis=1)
        res_t = ts.wrap_dq(torch.as_tensor(dq) - dr_t).abs().amax(1).numpy()
        out[geo] = (res_j, res_t, np.asarray(dr_j), dr_t.numpy())
    # Newton alone diverges on every lane, the geodesic path lands
    assert np.all(out[0][0] > 1.0) and np.all(out[0][1] > 1.0), out[0][:2]
    assert np.all(out[24][0] < 1e-8) and np.all(out[24][1] < 1e-8)
    np.testing.assert_allclose(out[24][3], out[24][2], atol=1e-8)


@pytest.mark.parametrize("order", [1, 0])
def test_run_matches_jax(xe4, order):
    """Whole runs, per lane. Order 1 runs the bench's chord config
    (``newton_chord=True``); order 0 the full-Newton default."""
    kw = (dict(order=1, newton_chord=True, restart_after=60) if order
          else dict(order=0))
    x0 = xe4["x0"]
    js = _jax_run(xe4, kw, x0)
    jp = _jax_run(xe4, kw, x0 + 1e-13 * np.random.RandomState(9).normal(
        size=x0.shape))
    stable = np.ones(len(x0), bool)
    for k in COUNTS:
        stable &= _np(js, k) == _np(jp, k)
    stable &= np.max(np.abs(_np(js, "x") - _np(jp, "x")), axis=1) < 1e-6
    assert stable.sum() >= 5, stable

    cfg = TE.InternalEnsembleConfig(**xe4["base"], **kw)
    ts = TE.run_internal_ensemble(xe4["tpot"], xe4["ti"], x0, cfg,
                                  max_steps=MAX_STEPS, device="cpu")
    for k in COUNTS:
        np.testing.assert_array_equal(_np(ts, k)[stable],
                                      _np(js, k)[stable], err_msg=k)
    np.testing.assert_allclose(_np(ts, "x")[stable], _np(js, "x")[stable],
                               atol=1e-6)
    assert _np(ts, "converged").sum() == _np(js, "converged").sum() >= (
        6 if order else 2)
