"""The port's atom+cell work queue (``run_cell_ensemble_queue``)
against the JAX package's, in float64 on the CPU: the 7-input, 3-lane
periodic-LJ queue of ``tests/test_ensemble_cell.py:142-169``, per input
``nsteps`` and ``converged`` identical, ``f`` within 1e-8 and ``z``
within 1e-6. The rebase, checkpoint and device-rule cases of the tier
are in ``tests/test_torch_cell_rebase.py``.

The JAX queue runs with its ``init_cell_state`` and ``refresh_cell``
jitted for the call: run eagerly, each dispatches ~100 single-operation
XLA compiles, which dominate this file's time in the parallel test lane.
The queue logic, the step and the refill are the JAX package's own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.parallel.ensemble_cell as J
import sella_tpu_torch.parallel.ensemble_cell as T
from sella_tpu.potentials import LennardJones as JLJ
from sella_tpu.potentials.emt import fcc_bulk
from sella_tpu_torch.potentials import LennardJones as TLJ

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


F_ATOL = 1e-8
Z_ATOL = 1e-6
TOTAL = 7


@pytest.fixture(scope="module")
def queues():
    mp = pytest.MonkeyPatch()
    mp.setattr(J, "init_cell_state",
               jax.jit(J.init_cell_state, static_argnums=(0, 2, 4)))
    mp.setattr(J, "refresh_cell",
               jax.jit(J.refresh_cell, static_argnums=(1, 2, 4)))
    try:
        return _run_both()
    finally:
        mp.undo()


def _run_both():
    atoms = fcc_bulk("Cu", 1.55, reps=(2, 2, 2))
    nat = len(atoms)
    rng = np.random.RandomState(0)
    x0_all = np.stack([
        (atoms.positions
         + 0.02 * rng.normal(size=atoms.positions.shape)).ravel()
        for _ in range(TOTAL)
    ])
    s0_all = 0.02 * rng.normal(size=(TOTAL, 9))
    kw = dict(natoms=nat, ncell=9, order=0, fmax=5e-3, delta0=0.1)
    args = dict(batch=3, max_steps_per_search=200, refill_every=10)
    jr = J.run_cell_ensemble_queue(
        JLJ(pbc=True), jnp.asarray(x0_all), J.CellEnsembleConfig(**kw),
        jnp.asarray(atoms.cell), s0_all=jnp.asarray(s0_all), **args)
    tr = T.run_cell_ensemble_queue(
        TLJ(pbc=True), x0_all, T.CellEnsembleConfig(**kw),
        np.asarray(atoms.cell), s0_all=s0_all, device="cpu", **args)
    return tr, jr


def test_cell_queue_returns_every_input(queues):
    tr, jr = queues
    assert len(tr) == len(jr) == TOTAL
    assert all(r["converged"] for r in tr)


def test_cell_queue_inputs_match_jax(queues):
    for i, (a, b) in enumerate(zip(*queues)):
        assert (a["nsteps"], a["converged"]) == (b["nsteps"],
                                                 b["converged"]), i
        assert abs(a["f"] - b["f"]) <= F_ATOL, i
        np.testing.assert_allclose(a["z"], np.asarray(b["z"]), rtol=0,
                                   atol=Z_ATOL, err_msg=str(i))
