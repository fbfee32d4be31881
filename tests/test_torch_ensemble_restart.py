"""Parity of the port's restart branches with the JAX package: the
stagnation restart (``restart_after``), the dissociation restart
(``dmax_restart``) and the ``conv_inertia`` curvature audit, on LJ4.

Every run uses ``restart_kick=0.0``, so a restart lands exactly on
``x_home`` whatever either package draws. The runs stop right after the
first restart: a restarted lane's Hessian is reset to the identity, so its
next P-RFO step maximizes along a direction that rounding noise picks out
of a degenerate eigenspace, and the two packages' QR and eigh bases pick
different ones. Up to and through the restart step every lane has
identical counters (``converged``, ``nsteps``, ``nmatvec``, ``neval``,
``nrestarts``) and ``f`` within 1e-8; the three-step dmax test also holds
``x`` to 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.parallel.ensemble as J
import sella_tpu_torch.parallel.ensemble as T
from sella_tpu.potentials import LennardJones as JLJ
from sella_tpu_torch.interop import state_from_numpy
from sella_tpu_torch.potentials import LennardJones as TLJ

torch.set_num_threads(1)

X_ATOL = 1e-10
F_ATOL = 1e-8
COUNTERS = ("converged", "nsteps", "nmatvec", "neval", "nrestarts")

TET = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * 1.12


def _jax_steps(kw, x0, max_steps, x_home=None, until_restart=True):
    """Per-step JAX states (as numpy dicts), stopping after the first
    step on which some lane restarted when ``until_restart``."""
    cfg = J.EnsembleConfig(**kw)
    step = jax.jit(J.make_step_fn(JLJ(), cfg))
    st = J.init_state(JLJ(), jnp.asarray(x0), cfg)
    if x_home is not None:
        st = st._replace(x_home=jnp.asarray(x_home))
    key = jax.random.PRNGKey(0)
    states = []
    for i in range(max_steps):
        st = step(st, jax.random.fold_in(key, i))
        states.append({f: np.asarray(getattr(st, f))
                       for f in J.SearchState._fields})
        if until_restart and states[-1]["nrestarts"].any():
            break
    return states


def _port_steps(kw, n, x0=None, x_home=None, state=None):
    """Per-step port states from ``init_state(x0)`` or from ``state``."""
    cfg = T.EnsembleConfig(**kw)
    step = T.make_step_fn(TLJ(), cfg)
    st = state if state is not None else T.init_state(
        TLJ(), torch.as_tensor(x0), cfg)
    if x_home is not None:
        st = st._replace(x_home=torch.as_tensor(x_home))
    gen = torch.Generator().manual_seed(0)
    states = []
    for _ in range(n):
        st = step(st, gen)
        states.append(st)
    return states


def _assert_same(ts, js, lanes=slice(None), where="", x_atol=None):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(ts, f).numpy()[lanes],
                                      js[f][lanes], err_msg=f + where)
    np.testing.assert_allclose(ts.f.numpy()[lanes], js["f"][lanes],
                               rtol=0, atol=F_ATOL, err_msg="f" + where)
    if x_atol is not None:
        np.testing.assert_allclose(ts.x.numpy()[lanes], js["x"][lanes],
                                   rtol=0, atol=x_atol, err_msg="x" + where)


def test_stagnation_restart_matches_jax():
    """The seed-7 config of ``test_ensemble_stagnation_restart``: lane 2
    limit-cycles until its stall counter reaches 40 and restarts (step
    129); the other lanes have converged by step 46. The port takes the
    JAX state 45 steps before the restart, before lane 2's last
    improvement, and both run to the restart step (the full 129-step run
    costs 16 s on one CPU thread)."""
    rng = np.random.RandomState(7)
    x0 = (TET[None] + 0.12 * rng.normal(size=(8, 4, 3))).reshape(8, 12)
    kw = dict(natoms=4, order=1, fmax=1e-3, gamma=1e-3, restart_after=40,
              restart_kick=0.0)
    js = _jax_steps(kw, x0, 200)
    nrst = js[-1]["nrestarts"]
    assert nrst.sum() == 1 and nrst[2] == 1, nrst
    k0 = len(js) - 46
    # lane 2's last improvement lies inside the port's window, so the
    # port counts all 40 stalled steps itself
    assert js[-41]["stall"][2] == 0
    ts = _port_steps(kw, 45, state=state_from_numpy(js[k0], device="cpu"))
    _assert_same(ts[-1], js[-1])
    # the restart itself: back home, identity Hessian, fresh counters
    last = ts[-1]
    assert torch.equal(last.x[2], last.x_home[2])
    assert torch.equal(last.B[2], torch.eye(12, dtype=torch.float64))
    assert bool(last.B_init[2]) and int(last.stall[2]) == 0
    assert float(last.delta[2]) == T.EnsembleConfig(natoms=4).delta0
    assert int(last.nsteps_since_diag[2]) == 3
    assert torch.isinf(last.best_fmax[2])
    assert last.converged[[0, 1, 3, 4, 5, 6, 7]].all()


def test_dmax_restart_matches_jax():
    """``test_ensemble_dmax_restart_rescues_dissociated_lane`` as a
    parity test: lane 1 starts with one atom 6 sigma away and is
    restarted home on its first step by ``dmax_restart`` alone (the
    stall counter is out of reach). Lanes 0, 2 and 3 are compared over
    all three steps, lane 1 through its restart."""
    rng = np.random.RandomState(3)
    home = TET[None] + 0.1 * rng.normal(size=(4, 4, 3))
    diss = home.copy()
    diss[1, 3] += np.array([6.0, 0.0, 0.0])
    kw = dict(natoms=4, order=1, fmax=1e-3, gamma=1e-3,
              restart_after=10_000, dmax_restart=3.5, conv_inertia=True,
              restart_kick=0.0)
    x0, x_home = diss.reshape(4, 12), home.reshape(4, 12)
    js = _jax_steps(kw, x0, 3, x_home=x_home, until_restart=False)
    ts = _port_steps(kw, 3, x0, x_home=x_home)
    assert js[0]["nrestarts"].tolist() == [0, 1, 0, 0]
    _assert_same(ts[0], js[0], where=" (restart step)", x_atol=X_ATOL)
    np.testing.assert_array_equal(ts[0].x.numpy()[1], x_home[1])
    np.testing.assert_array_equal(ts[2].nrestarts.numpy(),
                                  js[2]["nrestarts"])
    _assert_same(ts[2], js[2], lanes=[0, 2, 3], where=" (step 3)",
                 x_atol=X_ATOL)


def test_conv_inertia_audit_rejection_matches_jax():
    """``conv_inertia`` with the stagnation restart off: LJ4 starts with
    atom 3 pulled 3 sigma away reach the force criterion on flat
    detached-atom plateaus, where the exact-HVP audit along the leftmost
    prep mode rejects them and restarts them at once. Compared over the
    last two steps through the first rejection."""
    rng = np.random.RandomState(0)
    x = TET[None] + 0.1 * rng.normal(size=(4, 4, 3))
    x[:, 3] += np.array([3.0, 0.0, 0.0])
    x0 = x.reshape(4, 12)
    kw = dict(natoms=4, order=1, fmax=1e-3, gamma=1e-3, conv_inertia=True,
              restart_kick=0.0)
    js = _jax_steps(kw, x0, 80)
    rejected = js[-1]["nrestarts"] > 0
    assert rejected.any(), "no audit rejection in 80 steps"
    # a rejected lane met the force criterion but stays unconverged
    assert not js[-1]["converged"][rejected].any()
    ts = _port_steps(kw, len(js), x0)
    for k in (len(js) - 2, len(js) - 1):
        _assert_same(ts[k], js[k], where=f" (step {k})")


@pytest.mark.parametrize("what", ["x", "generator"])
def test_restart_kick_draws_only_when_a_lane_restarts(what):
    """The kick shares the run generator with the Davidson dead-vector
    draw, so it is drawn only on steps where some lane restarts: a run
    with the restarts armed but never firing leaves the generator where a
    run without them leaves it."""
    rng = np.random.RandomState(5)
    x0 = (TET[None] + 0.05 * rng.normal(size=(2, 4, 3))).reshape(2, 12)
    gens = []
    for kw in (dict(), dict(restart_after=500, restart_kick=0.3)):
        cfg = T.EnsembleConfig(natoms=4, order=1, fmax=1e-3, gamma=1e-3,
                               **kw)
        step = T.make_step_fn(TLJ(), cfg)
        st = T.init_state(TLJ(), torch.as_tensor(x0), cfg)
        gen = torch.Generator().manual_seed(1)
        for _ in range(4):
            st = step(st, gen)
        assert int(st.nrestarts.sum()) == 0
        gens.append(gen.get_state() if what == "generator" else st.x)
    assert torch.equal(gens[0], gens[1])
