"""The port's work queue (``refill_converged``, ``run_ensemble_queue``)
against the JAX package, and ports of ``tests/test_queue_checkpoint.py``'s
queue cases.

Retry starts are identical in both packages: both draw the retry kick
from the same numpy ``RandomState``. The parity configs need no other
random draw: the minimizations run ``eig=False`` (no Davidson), and the
saddle queue uses ``restart_kick=0.0``. Per input, ``converged``,
``nsteps``, ``nmatvec`` and ``neval`` are identical and ``f`` agrees
within 1e-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.parallel.ensemble as J
import sella_tpu_torch.parallel.ensemble as T
from sella_tpu.potentials import LennardJones as JLJ
from sella_tpu_torch.potentials import LennardJones as TLJ

torch.set_num_threads(1)

F_ATOL = 1e-8
QN = dict(natoms=4, order=0, fmax=1e-3, gamma=1e-3, eig=False,
          method="qn", sigma_dec=0.90, rho_dec=100.0)


def _x0_batch(total, seed=3, pert=0.1):
    """The starts of ``tests/test_queue_checkpoint.py``."""
    tet = np.array(
        [[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
         [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]
    ) * 1.12
    rng = np.random.RandomState(seed)
    return (tet[None] + pert * rng.normal(size=(total, 4, 3))).reshape(
        total, 12)


def _queue(x0, kw=QN, **args):
    return T.run_ensemble_queue(TLJ(), torch.as_tensor(x0),
                                T.EnsembleConfig(**kw), **args)


def _queue_both(x0, kw, **args):
    jr = J.run_ensemble_queue(JLJ(), jnp.asarray(x0), J.EnsembleConfig(**kw),
                              **args)
    return jr, _queue(x0, kw, **args)


def _assert_inputs(tr, jr, inputs):
    for i in inputs:
        assert tr[i][2:] == jr[i][2:], (i, tr[i][2:], jr[i][2:])
        assert abs(tr[i][1] - jr[i][1]) <= F_ATOL, i


@pytest.mark.parametrize("inherit_B", [False, True])
def test_refill_converged_matches_jax(inherit_B):
    """Every field exact, dtypes included, on a random state with mixed
    converged/available lanes."""
    rng = np.random.RandomState(0)
    B, d = 5, 12
    fields = dict(
        x=rng.normal(size=(B, d)), f=rng.normal(size=B),
        g=rng.normal(size=(B, d)), B=rng.normal(size=(B, d, d)),
        B_init=np.array([1, 0, 1, 1, 0], bool),
        delta=rng.uniform(size=B), rho=rng.normal(size=B),
        nsteps_since_diag=rng.randint(0, 9, B).astype(np.int32),
        converged=np.array([1, 1, 0, 1, 1], bool),
        nsteps=rng.randint(0, 99, B).astype(np.int32),
        neval=rng.randint(0, 99, B).astype(np.int32),
        nmatvec=rng.randint(0, 99, B).astype(np.int32),
        best_fmax=rng.uniform(size=B),
        stall=rng.randint(0, 9, B).astype(np.int32),
        nrestarts=rng.randint(0, 3, B).astype(np.int32),
        x_home=rng.normal(size=(B, d)), fmax_t=np.float64(1e-3),
    )
    x_new = rng.normal(size=(B, d))
    avail = np.array([1, 0, 1, 1, 1], bool)
    cfg_kw = dict(natoms=4, delta0=0.07)
    js, jtake = J.refill_converged(
        J.SearchState(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jnp.asarray(x_new), jnp.asarray(avail), J.EnsembleConfig(**cfg_kw),
        inherit_B=inherit_B)
    ts, ttake = T.refill_converged(
        T.SearchState(**{k: torch.as_tensor(v) for k, v in fields.items()}),
        torch.as_tensor(x_new), torch.as_tensor(avail),
        T.EnsembleConfig(**cfg_kw), inherit_B=inherit_B)
    np.testing.assert_array_equal(ttake.numpy(), np.asarray(jtake))
    assert ttake.tolist() == [True, False, False, True, True]
    for k in T.SearchState._fields:
        a, b = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_queue_work_set_smaller_than_batch():
    """A work set smaller than the device batch is clamped."""
    results = T.run_ensemble_queue(
        TLJ(), _x0_batch(3), T.EnsembleConfig(**QN), batch=8,
        max_steps_per_search=100, refill_every=20, device="cpu",
    )
    assert len(results) == 3
    assert sum(1 for r in results if r[3]) >= 2


def test_queue_processes_more_work_than_batch():
    results = _queue(_x0_batch(12), batch=4, max_steps_per_search=300,
                     refill_every=20)
    assert len(results) == 12
    assert sum(1 for r in results if r[3]) >= 11
    for x, f, nsteps, conv, *_ in results:
        assert len(x) == 12
        if conv:
            assert f < -5.5  # near the LJ4 tetrahedron basin


def test_queue_retry_step_growth():
    """A search that only needs more steps than the base budget is
    rescued by ``retry_step_growth`` alone (kick 0: the retry replays
    the same deterministic trajectory with a bigger budget). The base
    budget is derived from a full-budget run. Of the JAX test's six starts
    the four that converge within 60 steps run here (for time: one never
    converges within 300 steps, one needs 128)."""
    x0 = _x0_batch(6, pert=0.3)[[1, 2, 3, 5]]
    full = _queue(x0, batch=2, max_steps_per_search=60, refill_every=5)
    demands = [n if c else 10 ** 9 for _, _, n, c, *_ in full]
    conv_steps = sorted(n for _, _, n, c, *_ in full if c)
    budget = max(conv_steps[0] + 2, 10)
    assert max(demands) > budget
    base = _queue(x0, batch=2, max_steps_per_search=budget, refill_every=5)
    n_base = sum(1 for r in base if r[3])
    assert n_base < 4
    grown = _queue(x0, batch=2, max_steps_per_search=budget,
                   refill_every=5, max_retries=3, retry_kick=0.0,
                   retry_step_growth=4.0, retry_step_cap=310)
    n_grown = sum(1 for r in grown if r[3])
    max_budget = min(budget * 13.0, 310)
    assert n_grown > n_base
    assert n_grown >= sum(1 for dm in demands if dm <= max_budget) - 1
    for (_, _, nsteps, conv, *_), (_, _, nb, cb, *_) in zip(grown, base):
        if conv and not cb:
            assert nsteps > budget   # cumulative over every attempt


def test_queue_drain_handoff():
    """With ``drain_handoff`` the queue returns once the work set is
    exhausted and at most that many unconverged lanes remain; the
    stragglers come back unconverged with their own geometry and cost,
    and every search that converged does so exactly as without it."""
    x0 = _x0_batch(8, pert=0.3)
    # the full run only has to find the fastest search's step count
    full = _queue(x0, batch=4, max_steps_per_search=60, refill_every=5)
    conv_steps = sorted(n for _, _, n, c, *_ in full if c)
    budget = conv_steps[0] + 1
    base = _queue(x0, batch=4, max_steps_per_search=budget, refill_every=5)
    handed = _queue(x0, batch=4, max_steps_per_search=budget,
                    refill_every=5, drain_handoff=4)
    assert len(handed) == 8
    assert sum(1 for r in handed if not r[3]) >= 1
    xs = [r[0] for r in handed]
    for i, (x, f, nsteps, conv, *_) in enumerate(handed):
        if not conv:
            assert 0 < nsteps <= budget + 4
            assert np.all(np.isfinite(x))
        for j in range(i + 1, 8):
            assert not np.array_equal(xs[i], xs[j]), (i, j)
    for rb, rh in zip(base, handed):
        if rb[3] and rh[3]:
            np.testing.assert_array_equal(rb[0], rh[0])
            assert rb[2] == rh[2]


def test_queue_retries_and_handoff_match_jax():
    """Queue parity (a): 12 inputs through 4 lanes with a 40-step budget,
    one retry with a 0.15 kick and a budget grown by ``retry_step_growth``
    and cut by ``retry_step_cap``, and a handoff of the last 2
    stragglers. Every input matches, the retried and handed-off ones
    included."""
    x0 = _x0_batch(12, pert=0.3)
    args = dict(batch=4, max_steps_per_search=40, refill_every=5,
                max_retries=1, retry_kick=0.15, retry_step_growth=0.5,
                retry_step_cap=55, drain_handoff=2)
    jr, tr = _queue_both(x0, QN, **args)
    assert len(tr) == 12
    _assert_inputs(tr, jr, range(12))
    # a retry ran its whole grown budget: 40 + min(40 * 1.5, 55) steps
    assert any(not r[3] and r[2] == 40 + 55 for r in jr)
    # a handoff happened: unconverged below its (first or retry) budget
    assert any(not r[3] and r[2] not in (40, 95) for r in jr)


def test_saddle_queue_with_restart_matches_jax():
    """Queue parity (b): order-1 LJ4 with ``restart_after=30`` through 3
    lanes, 50-step budget. Input 0 stalls and restarts at step 42 (its
    neval is nsteps + 2: the start's eval and the restart's); the others
    converge in 16-23 steps with no restart. After a restart the P-RFO
    step maximizes along a rounding-picked mode of the identity Hessian
    (see test_torch_ensemble_restart.py), so the restarted input is held
    to its step and eval counts only; every other input matches in
    full."""
    rng = np.random.RandomState(11)
    tet = _x0_batch(1, pert=0.0)[0].reshape(4, 3)
    x0 = (tet[None] + 0.25 * rng.normal(size=(64, 4, 3))).reshape(64, 12)
    x0 = x0[[5, 50, 22, 1, 3]]
    kw = dict(natoms=4, order=1, fmax=1e-3, gamma=1e-3, restart_after=30,
              restart_kick=0.0)
    jr, tr = _queue_both(x0, kw, batch=3, max_steps_per_search=50,
                         refill_every=10)
    assert [r[3] for r in jr] == [False, True, True, True, True]
    assert jr[0][5] == jr[0][2] + 2          # one restart in JAX
    assert (tr[0][2], tr[0][3], tr[0][5]) == (jr[0][2], jr[0][3], jr[0][5])
    _assert_inputs(tr, jr, range(1, 5))
    for r in jr[1:]:
        assert r[5] == r[2] + 1              # no restart
