"""The port's heterogeneous work sets against the JAX package, on the CPU.

* ``bucket_jobs``: the same grouping as the JAX package's, and the same
  ``ValueError`` for a length that is not 3 natoms.
* The mixed LJ4/LJ7 minimization sweep of
  ``tests/test_hetero_queue.py:45-76`` (8 LJ4 + 6 LJ7 jobs through
  4-lane queues) against the JAX sweep: per job the same steps, force
  calls and converged flag, x within 1e-8 and f within 1e-10, in input
  order; ``cfg_overrides`` on a template; ``mesh=`` and the device rule.
* ``internal_topology_signature`` equal to the JAX package's on the
  molecules of ``examples/09_heterogeneous_sweep.py`` (perturbed Xe4
  copies share one, He7 and a changed species do not).
* ``run_heterogeneous_internal_queue`` on a 2 + 2 job Morse Xe4 / LJ He7
  campaign with a short step cap: buckets by signature, input order,
  and every result bit for bit the port's own
  ``run_internal_ensemble_queue`` of its bucket (no JAX run here: the
  JAX internal sweep costs minutes).

At most 6 cases.
"""
import numpy as np
import pytest
import torch

import sella_tpu  # noqa: F401  (float64 before any jnp use)
from sella_tpu import Atoms as JAtoms
from sella_tpu.coords.internals import Internals as JInternals
from sella_tpu.parallel import hetero as JH
from sella_tpu.parallel.ensemble import EnsembleConfig as JConfig
from sella_tpu.potentials import LennardJones as JLJ

from sella_tpu_torch import Atoms as TAtoms
from sella_tpu_torch import EnsembleConfig as TConfig
from sella_tpu_torch import InternalEnsembleConfig, MorsePotential
from sella_tpu_torch import LennardJones as TLJ
from sella_tpu_torch.coords.internals import Internals as TInternals
from sella_tpu_torch.parallel import hetero as TH
from sella_tpu_torch.parallel.ensemble_internal import (
    fixed_internal_constraints,
    run_internal_ensemble_queue,
)
from sella_tpu_torch.utils.units import kB

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


TET = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * 1.12
XE4 = np.random.RandomState(4).normal(size=(4, 3), scale=3.0)


def _lj7_base():
    rstar = 2.0 ** (1.0 / 6.0)
    ring_r = rstar / (2.0 * np.sin(np.pi / 5.0))
    apex_z = np.sqrt(max(rstar ** 2 - ring_r ** 2, 0.1))
    ang = 2.0 * np.pi * np.arange(5) / 5.0
    return np.vstack([
        np.stack([ring_r * np.cos(ang), ring_r * np.sin(ang),
                  np.zeros(5)], axis=1),
        [[0.0, 0.0, apex_z]], [[0.0, 0.0, -apex_z]],
    ])


def test_bucket_jobs_matches_jax():
    jobs = [np.zeros(12), np.zeros(21), np.zeros(12), np.zeros(3),
            np.zeros(21)]
    assert TH.bucket_jobs(jobs) == JH.bucket_jobs(jobs) == {
        12: [0, 2], 21: [1, 4], 3: [3]}
    assert list(TH.bucket_jobs(jobs)) == [12, 21, 3]
    for mod in (TH, JH):
        with pytest.raises(ValueError, match="3\\*natoms"):
            mod.bucket_jobs([np.zeros(12), np.zeros(11)])


def test_mixed_sweep_matches_jax():
    rng = np.random.RandomState(3)
    lj7 = _lj7_base()
    jobs = []
    for k in range(14):
        if k % 2 == 0 and k < 12:
            jobs.append((TET + 0.08 * rng.normal(size=(4, 3))).ravel())
        else:
            jobs.append((lj7 + 0.05 * rng.normal(size=(7, 3))).ravel())
    kw = dict(order=0, fmax=1e-3, eig=False, method="qn", delta0=0.05)
    qkw = dict(max_steps_per_search=300, refill_every=10)
    res_j = JH.run_heterogeneous_queue(JLJ(), jobs, batch=4,
                                       cfg=JConfig(natoms=1, **kw), **qkw)
    res_t = TH.run_heterogeneous_queue(TLJ(), jobs, batch=4,
                                       cfg=TConfig(natoms=1, **kw),
                                       device="cpu", **qkw)
    assert len(res_t) == len(jobs)
    for a, b, x in zip(res_j, res_t, jobs):
        assert np.asarray(b[0]).shape == x.shape
        assert (int(a[2]), bool(a[3]), int(a[4]), int(a[5])) == (
            b[2], b[3], b[4], b[5])
        np.testing.assert_allclose(b[0], np.asarray(a[0]), rtol=0,
                                   atol=1e-8)
        assert abs(float(a[1]) - b[1]) < 1e-10
        assert b[3]
    # overrides replace the template's fields (a smaller first trust
    # radius changes the counts)
    over = TH.run_heterogeneous_queue(TLJ(), jobs[:2], batch=4,
                                      cfg=TConfig(natoms=1, **kw),
                                      device="cpu", delta0=0.02, **qkw)
    assert [r[2] for r in over] != [r[2] for r in res_t[:2]]
    with pytest.raises(NotImplementedError):
        TH.run_heterogeneous_queue(TLJ(), jobs, batch=4, mesh=object(),
                                   device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            TH.run_heterogeneous_queue(TLJ(), jobs[:2], batch=2,
                                       max_steps_per_search=2, **kw)


def _sig(mod, A, I, symbols, pos, kinds=("bonds", "angles", "dihedrals")):
    ints = I(A(symbols, pos))
    if "bonds" in kinds:
        ints.find_all_bonds()
    if "angles" in kinds:
        ints.find_all_angles()
    if "dihedrals" in kinds:
        ints.find_all_dihedrals()
    return mod.internal_topology_signature(ints)


def test_internal_topology_signature_matches_jax():
    rng = np.random.RandomState(0)
    lj7 = _lj7_base()
    cases = [(["Xe"] * 4, XE4), (["Xe"] * 4, XE4 + 0.05 * rng.normal(
        size=(4, 3))), (["He"] * 7, lj7), (["He"] * 4, XE4)]
    sigs = []
    for symbols, pos in cases:
        st = _sig(TH, TAtoms, TInternals, symbols, pos)
        sj = _sig(JH, JAtoms, JInternals, symbols, pos)
        assert st == sj
        sigs.append(st)
    assert sigs[0] == sigs[1]
    assert len({sigs[0], sigs[2], sigs[3]}) == 3
    # a bond graph without angles is another topology
    assert _sig(TH, TAtoms, TInternals, ["Xe"] * 4, XE4,
                ("bonds",)) != sigs[0]


def test_internal_campaign_equals_direct_queues():
    r0 = 4.73
    morse = MorsePotential(epsilon=226.9 * kB, r0=r0, rho0=r0 * 1.099)
    lj = TLJ()
    lj7 = _lj7_base()
    xe4, he7 = TAtoms(["Xe"] * 4, XE4), TAtoms(["He"] * 7, lj7)
    rng = np.random.RandomState(0)
    jobs = []
    for _ in range(2):
        jobs.append((morse, xe4, (XE4 + 0.3 * rng.normal(size=(4, 3))
                                  ).ravel()))
        jobs.append((lj, he7, (lj7 + 0.12 * rng.normal(size=(7, 3))
                               ).ravel()))
    cfg = InternalEnsembleConfig(natoms=1, nint=1, order=1, fmax=1e-3,
                                 gamma=1e-3)
    kw = dict(max_steps_per_search=4, refill_every=2, spill=None,
              device="cpu")
    res = TH.run_heterogeneous_internal_queue(jobs, batch=3, cfg=cfg, **kw)
    assert len(res) == 4
    for (_, _, x0), r in zip(jobs, res):
        assert np.asarray(r[0]).shape == x0.shape
    # buckets: (potential, signature at each job's own start); a
    # perturbation that changes the bond graph makes its own bucket
    groups = {}
    for i, (pot, at, x0) in enumerate(jobs):
        key = (id(pot), TH.internal_topology_signature(
            TH.discover_internals(at, x0)))
        groups.setdefault(key, []).append(i)
    assert len(groups) >= 2
    for idxs in groups.values():
        pot, at, _ = jobs[idxs[0]]
        ints = TH.discover_internals(at, jobs[idxs[0]][2])
        bcfg = cfg._replace(natoms=ints.natoms, nint=ints.nint,
                            ndummies=ints.ndummies,
                            ncons=len(fixed_internal_constraints(ints)[0]))
        direct = run_internal_ensemble_queue(
            pot, ints, np.stack([jobs[i][2] for i in idxs]), bcfg,
            min(3, len(idxs)), **kw)
        for i, d in zip(idxs, direct):
            np.testing.assert_array_equal(res[i][0], d[0])
            assert res[i][1:] == d[1:]
    with pytest.raises(ValueError, match="natoms"):
        TH.run_heterogeneous_internal_queue(
            [(lj, he7, np.zeros(12))], batch=1, cfg=cfg, **kw)
