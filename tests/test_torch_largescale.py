"""The port's matrix-free large-system path (``parallel.largescale``)
against the JAX package's, in float64 on the CPU.

L-BFGS and Lanczos are held to the JAX functions on the same numpy
inputs (1e-12 and 1e-10: only summation order differs). Whole runs are
held step for step: the same step and evaluation counts, and positions
within 1e-8 (order 0) or 1e-7 (order 1, whose loose 1e-3 Lanczos test
carries rounding from step to step). The JAX ``mmf_init`` draws its mode
from ``jax.random``, so the order-1 runs start both packages from the
same injected numpy mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.parallel.largescale as JL
import sella_tpu_torch.parallel.largescale as TL
from sella_tpu.potentials import LennardJones as JLJ
from sella_tpu.potentials.binned import BinnedPairPotential as JBinned
from sella_tpu.potentials.emt import fcc111_slab as jax_fcc111_slab
from sella_tpu_torch import interop
from sella_tpu_torch.potentials import (EMT, BinnedPairPotential,
                                        ChunkedPairPotential, LennardJones)

torch.set_num_threads(2)

LBFGS_RTOL = 1e-12
LAM_RTOL = 1e-10
X_ATOL_ORDER0 = 1e-8
X_ATOL_ORDER1 = 1e-7


def lj7_start():
    """LJ7 bipyramid, compressed and rattled (tests/test_largescale.py:
    69-97), and a normalized numpy mode (RandomState(0))."""
    pos = np.array([
        [0.0, 0.0, 1.1], [0.0, 0.0, -1.1], [1.12, 0.0, 0.0],
        *[[1.12 * np.cos(2 * np.pi * k / 5),
           1.12 * np.sin(2 * np.pi * k / 5), 0] for k in range(1, 5)],
    ]) * 0.9
    pos = pos + 0.15 * np.random.RandomState(5).normal(size=pos.shape)
    v0 = np.random.RandomState(0).normal(size=21)
    return pos.ravel(), v0 / np.linalg.norm(v0)


def jax_init(pot, x0, cell=None):
    """The JAX ``mmf_init``, jitted (eagerly it dispatches the potential's
    gradient op by op, seconds for EMT)."""
    return jax.jit(lambda y: JL.mmf_init(pot, y, cell))(jnp.asarray(x0))


def jax_drive(pot, state, cell=None, order=1, fmax=1e-3, max_steps=500,
              max_move=0.1, steps_per_call=25):
    """The JAX ``run_mmf`` loop from a given state (sella_tpu/parallel/
    largescale.py:287-305, without its ``mmf_init``)."""
    step = JL.make_mmf_step(pot, cell, order, fmax, max_move)

    @jax.jit
    def multi(s):
        return jax.lax.fori_loop(
            0, steps_per_call,
            lambda i, st: jax.lax.cond(st.converged, lambda t: t, step, st),
            s)

    for _ in range(max_steps // steps_per_call + 1):
        state = multi(state)
        if bool(state.converged) or int(state.nsteps) >= max_steps:
            break
    return state


def test_lbfgs_matches_jax():
    """Push and two-loop apply on random secants, one of them rejected
    (s.y < 0), through a window of 4 wrapped twice (count 9 > 4)."""
    rng = np.random.RandomState(0)
    d, K = 12, 4
    jm, tm = JL.lbfgs_init(d, K), TL.lbfgs_init(d, K, device="cpu")
    for k in range(10):
        s, y = rng.normal(size=d), rng.normal(size=d)
        if k != 3:
            y = y if s @ y > 0 else -y
        else:
            y = y if s @ y < 0 else -y
        jm = JL.lbfgs_push(jm, jnp.asarray(s), jnp.asarray(y))
        tm = TL.lbfgs_push(tm, torch.as_tensor(s), torch.as_tensor(y))
        g = rng.normal(size=d)
        pj = np.asarray(JL.lbfgs_apply(jm, jnp.asarray(g)))
        pt = TL.lbfgs_apply(tm, torch.as_tensor(g)).numpy()
        # random secants make an ill-conditioned H^-1 (|p| ~ 1e3):
        # relative to the largest entry
        assert np.abs(pt - pj).max() < LBFGS_RTOL * np.abs(pj).max()
        assert int(tm.count) == int(jm.count)
        for f in ("S", "Y"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                          np.asarray(getattr(jm, f)))
        # rho = 1 / (s . y): the dot product's summation order differs
        np.testing.assert_allclose(tm.rho.numpy(), np.asarray(jm.rho),
                                   rtol=LBFGS_RTOL, atol=0)
    assert int(tm.count) == 9


def test_leftmost_mode_matches_jax():
    """Restarted Lanczos from the same start on a random symmetric
    matrix: the Ritz value to 1e-10 and the same HVP count."""
    rng = np.random.RandomState(1)
    d = 30
    A = rng.normal(size=(d, d))
    A = 0.5 * (A + A.T)
    v0 = rng.normal(size=d)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    lam_j, v_j, n_j = jax.jit(lambda v: JL.leftmost_mode(
        lambda u: Aj @ u, v, n_iter=6))(jnp.asarray(v0))
    lam_t, v_t, n_t = TL.leftmost_mode(lambda u: At @ u,
                                       torch.as_tensor(v0), n_iter=6)
    assert n_t == int(n_j)
    assert abs(float(lam_t) - float(lam_j)) < LAM_RTOL * abs(float(lam_j))
    assert abs(float(v_t @ torch.as_tensor(np.asarray(v_j)))) > 1 - 1e-10
    assert float(lam_t) < np.linalg.eigvalsh(A)[0] + 0.5


def test_mmf_slab_order0_matches_jax():
    """The rattled Cu(111) 3x4x3 slab minimization of
    tests/test_largescale.py:53-66, step for step."""
    slab = jax_fcc111_slab("Cu", 3.59, size=(3, 4, 3))
    pos = slab.positions + 0.05 * np.random.RandomState(2).normal(
        size=slab.positions.shape)
    kw = dict(order=0, fmax=5e-3, max_steps=500, max_move=0.2)
    cj = jnp.asarray(slab.cell)
    sj = jax_drive(slab.calc, jax_init(slab.calc, pos.ravel(), cj), cj,
                   **kw)
    st = TL.run_mmf(EMT([29] * len(pos), pbc=True), pos.ravel(),
                    cell=slab.cell, device="cpu", **kw)
    assert bool(st.converged) and bool(sj.converged)
    assert (int(st.nsteps), int(st.neval)) == (int(sj.nsteps),
                                               int(sj.neval))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=X_ATOL_ORDER0)


def test_mmf_lj7_saddle_matches_jax():
    """The LJ7 order-1 saddle of tests/test_largescale.py:69-97 from the
    same injected mode: the same steps and HVPs, lam < 0, and x within
    1e-7; the state round-trips through ``interop``."""
    x0, v0 = lj7_start()
    # eager, as the JAX run_mmf calls it: the saddle search carries the
    # init's last-bit rounding (a jitted init fuses differently) to ~5e-7
    sj = JL.mmf_init(JLJ(), jnp.asarray(x0))._replace(mode=jnp.asarray(v0))
    sj = jax_drive(JLJ(), sj, max_steps=800)
    pot = LennardJones()
    step = TL.make_mmf_step(pot, None, order=1, fmax=1e-3, max_move=0.1)
    st = TL.mmf_init(pot, x0, device="cpu")._replace(
        mode=torch.as_tensor(v0))
    st = TL.drive_mmf(step, st, max_steps=800)
    assert bool(st.converged) and bool(sj.converged)
    assert float(st.lam) < 0
    assert (int(st.nsteps), int(st.nmatvec)) == (int(sj.nsteps),
                                                 int(sj.nmatvec))
    assert step.hvp_calls == int(st.nmatvec)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=X_ATOL_ORDER1)
    back = interop.mmf_state_from_numpy(interop.mmf_state_to_numpy(st),
                                        device="cpu")
    for k in TL.MMFState._fields:
        a, b = getattr(back, k), getattr(st, k)
        same = all(torch.equal(p, q) for p, q in zip(a, b)) if k == "mem" \
            else torch.equal(a, b)
        assert same, k
    # a JAX state itself converts field for field
    cj = interop.mmf_state_from_numpy(sj, device="cpu")
    assert torch.equal(cj.x, torch.as_tensor(np.asarray(sj.x)))
    assert int(cj.mem.count) == int(sj.mem.count)


def _lj_fcc_block():
    """The rattled 32-atom LJ fcc block of tests/test_binned.py:112-142."""
    a = 1.5599
    base = [np.array([i, j, k], float) * a + np.asarray(s) * a
            for i in range(2) for j in range(2) for k in range(2)
            for s in ([0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                      [0, 0.5, 0.5])]
    pos = np.asarray(base)
    return (pos + 0.05 * np.random.RandomState(8).normal(size=pos.shape)
            ).reshape(-1)


def test_mmf_binned_matches_chunked_and_jax():
    """The matrix-free MMF run reaches the same minimum through the O(N)
    binned potential as through the O(N^2) chunked panel, and the
    binned run is the JAX package's, step for step."""
    x0 = _lj_fcc_block()
    kw = dict(order=0, fmax=1e-4, max_steps=400)
    binned = BinnedPairPotential(LennardJones(rc=2.5), rc=2.5, x0=x0,
                                 shift=False)
    chunked = ChunkedPairPotential(LennardJones(rc=2.5), chunk=16)
    st_b = TL.run_mmf(binned, x0, device="cpu", **kw)
    st_c = TL.run_mmf(chunked, torch.as_tensor(x0), **kw)
    assert bool(st_b.converged) and bool(st_c.converged)
    assert abs(float(st_b.f) - float(st_c.f)) < 1e-8
    jb = JBinned(JLJ(rc=2.5), rc=2.5, x0=jnp.asarray(x0), shift=False)
    sj = jax_drive(jb, jax_init(jb, x0), **kw)
    assert int(st_b.nsteps) == int(sj.nsteps)
    np.testing.assert_allclose(st_b.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=X_ATOL_ORDER0)


def test_device_rule():
    """A numpy x0 with no device goes to the GPU, and raises without one;
    a CPU tensor or device="cpu" runs on the CPU; the caller's x0 is
    never written. A run stops at the first multiple of steps_per_call
    at or past max_steps, as the JAX package's does."""
    x0, _ = lj7_start()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            TL.run_mmf(LennardJones(), x0, order=0, max_steps=2)
        with pytest.raises(RuntimeError, match="device"):
            TL.mmf_init(LennardJones(), x0)
    xt = torch.as_tensor(x0.copy())
    st = TL.run_mmf(LennardJones(), xt, order=0, max_steps=3,
                    steps_per_call=2)
    assert st.x.device.type == "cpu" and int(st.nsteps) == 4
    assert torch.equal(xt, torch.as_tensor(x0))
    st = TL.run_mmf(LennardJones(), x0, order=0, max_steps=2,
                    steps_per_call=2, device="cpu")
    assert st.x.device.type == "cpu" and int(st.nsteps) == 2
