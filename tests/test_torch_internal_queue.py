"""The port's internal-coordinate work queue
(``run_internal_ensemble_queue``): the refill queue of
``tests/test_ensemble_internal.py:305`` (8 inputs through 4 lanes, not
12) against the JAX package's, every
input identical (``nsteps``, ``converged``, ``nmatvec``, ``neval``; x
within 1e-6, f within 1e-8); the Cartesian spill finishing the lane
that walks into a 180-degree angle; the spill keeping a fixed bond on
its target; the spill-mode validation, ``mesh=`` and the device rule;
and checkpoint/resume from the first cycle's checkpoint, identical to
the uninterrupted run. At most 6 cases.

The JAX queue runs with its ``init_internal_state`` and
``refresh_internal`` jitted for the call (eagerly each dispatches
hundreds of single-operation compiles); the queue logic, the step and
the refill are the JAX package's own."""
import os
import shutil

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

import sella_tpu_torch.parallel.checkpoint as tckpt
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
POS0 = np.random.RandomState(4).normal(size=(4, 3), scale=3.0)
TET = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * R0


def _ints(A, I, pos, fix=False):
    ints = I(A(["Xe"] * 4, pos))
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    if fix:
        try:
            ints.add_bond((0, 1))
        except Exception:     # either package's DuplicateInternalError
            pass
        ints.cons.fix_bond((0, 1), target=1.15 * R0)
    return ints


def _morse(P):
    return P(epsilon=226.9 * kB, r0=R0, rho0=R0 * 1.099)


def _queue_starts(total=8):
    rng = np.random.RandomState(11)
    return (POS0[None] + 0.05 * rng.normal(size=(total, 4, 3))).reshape(
        total, 12)


QKW = dict(batch=4, max_steps_per_search=200, refill_every=15)


def _tcfg(ints, **kw):
    return TE.InternalEnsembleConfig(natoms=4, nint=ints.nint, order=0,
                                     fmax=1e-3, eig=False, delta0=0.05, **kw)


def test_refill_queue_matches_jax():
    x0_all = _queue_starts()
    ji = _ints(JAtoms, JInternals, POS0)
    H0 = ji.guess_hessian()
    ji.guess_hessian = lambda *a, **k: H0
    jcfg = JE.InternalEnsembleConfig(natoms=4, nint=ji.nint, order=0,
                                     fmax=1e-3, eig=False, delta0=0.05)
    mp = pytest.MonkeyPatch()
    mp.setattr(JE, "init_internal_state",
               jax.jit(JE.init_internal_state, static_argnums=(0, 1, 3, 4)))
    mp.setattr(JE, "refresh_internal",
               jax.jit(JE.refresh_internal, static_argnums=(1, 2, 3, 4),
                       static_argnames=("delta0",)))
    try:
        jr = JE.run_internal_ensemble_queue(_morse(JMorse), ji,
                                            jnp.asarray(x0_all), jcfg,
                                            **QKW)
    finally:
        mp.undo()
    ti = _ints(TAtoms, TInternals, POS0)
    tr = TE.run_internal_ensemble_queue(_morse(TMorse), ti, x0_all,
                                        _tcfg(ti), device="cpu", **QKW)
    assert len(tr) == len(jr) == len(x0_all)
    for a, b in zip(tr, jr):
        assert len(a) == 6 and a[2:] == b[2:], (a[2:], b[2:])
        np.testing.assert_allclose(a[0], b[0], atol=1e-6)
        np.testing.assert_allclose(a[1], b[1], atol=1e-8)
    assert sum(r[3] for r in tr) >= len(tr) - 1
    for x, f, nsteps, conv, nmv, nev in tr:
        if conv:
            assert f < -0.05


def test_cartesian_spill_finishes_bad_lane():
    """The bench's Xe4 starts (8 inputs, 4 lanes, order 1): one walks
    into a 180-degree angle, is harvested early and finished by the
    Cartesian pass, so every input converges."""
    x0 = (POS0[None] + 0.3 * np.random.RandomState(0).normal(
        size=(8, 4, 3))).reshape(8, 12)
    ti = _ints(TAtoms, TInternals, POS0)
    cfg = TE.InternalEnsembleConfig(natoms=4, nint=ti.nint, order=1,
                                    fmax=1e-3, gamma=1e-3)
    res = TE.run_internal_ensemble_queue(
        _morse(TMorse), ti, x0, cfg, batch=4, max_steps_per_search=300,
        refill_every=20, spill="cartesian", device="cpu")
    assert len(res) == 8
    assert all(r[3] for r in res), [r[2:] for r in res]


def test_spill_preserves_constraints():
    """A 3-step budget sends every input through the spill; the
    Cartesian pass keeps the fixed bond on its target."""
    ti = _ints(TAtoms, TInternals, TET, fix=True)
    x0 = (TET[None] + 0.15 * np.random.RandomState(1).normal(
        size=(4, 4, 3))).reshape(4, 12)
    res = TE.run_internal_ensemble_queue(
        _morse(TMorse), ti, x0, _tcfg(ti, ncons=1), batch=4,
        max_steps_per_search=3, refill_every=3, spill="cartesian",
        spill_max_steps=300, device="cpu")
    assert len(res) == 4 and all(r[3] for r in res), [r[2:] for r in res]
    for x, *_ in res:
        np.testing.assert_allclose(np.linalg.norm(x[3:6] - x[0:3]),
                                   1.15 * R0, atol=1e-3)


def test_spill_mode_mesh_and_device_rule():
    ti = _ints(TAtoms, TInternals, POS0)
    x0 = _queue_starts(2)
    cfg = _tcfg(ti)
    pot = _morse(TMorse)
    with pytest.raises(ValueError, match="spill"):
        TE.run_internal_ensemble_queue(pot, ti, x0, cfg, batch=2,
                                       max_steps_per_search=5, spill="cart",
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        TE.run_internal_ensemble_queue(pot, ti, x0, cfg, batch=2,
                                       mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        TE.run_internal_ensemble(pot, ti, x0, cfg, mesh=object(),
                                 device="cpu")
    # a tensor keeps its device; numpy goes to the GPU or raises
    st = TE.init_internal_state(pot, ti, torch.as_tensor(x0), cfg)
    assert st.x.device.type == "cpu" and st.x.dtype == torch.float64
    if not torch.cuda.is_available():
        for call in (
            lambda: TE.init_internal_state(pot, ti, x0, cfg),
            lambda: TE.run_internal_ensemble(pot, ti, x0, cfg, max_steps=1),
            lambda: TE.run_internal_ensemble_queue(pot, ti, x0, cfg,
                                                   batch=2),
        ):
            with pytest.raises(RuntimeError, match="GPU"):
                call()


def test_checkpoint_resume(tmp_path):
    """A queue resumed from its first cycle's checkpoint (state, lane
    map, cursor, results, step counter and generator state) finishes
    with every input identical to the uninterrupted run."""
    ti = _ints(TAtoms, TInternals, POS0)
    x0 = _queue_starts(4)
    cfg = _tcfg(ti)
    kw = dict(batch=2, max_steps_per_search=40, refill_every=10,
              device="cpu")
    path = os.path.join(tmp_path, "q.pt")
    first = os.path.join(tmp_path, "first.pt")
    saved = []
    real_save = tckpt.save_queue

    def save_and_keep_first(p, *a, **k):
        real_save(p, *a, **k)
        if not saved:
            shutil.copy(p, first)
        saved.append(p)

    mp = pytest.MonkeyPatch()
    mp.setattr(tckpt, "save_queue", save_and_keep_first)
    try:
        full = TE.run_internal_ensemble_queue(_morse(TMorse), ti, x0, cfg,
                                              checkpoint_path=path, **kw)
    finally:
        mp.undo()
    assert len(saved) >= 2
    _, origin, next_idx, results = tckpt.load_queue(
        first, TE.InternalSearchState, device="cpu")
    assert 0 < len(results) < 4
    shutil.copy(first, path)
    resumed = TE.run_internal_ensemble_queue(_morse(TMorse), ti, x0, cfg,
                                             checkpoint_path=path,
                                             resume=True, **kw)
    for a, b in zip(resumed, full):
        assert a[2:] == b[2:]
        np.testing.assert_array_equal(a[0], b[0])
