"""Heterogeneous work sets: mixed structure sizes through the queue.

Counterpart of ``sella_tpu/parallel/hetero.py``. The batched tiers run
one fixed-shape batch per (natoms, config) signature, so a campaign of
different molecules is served by bucketing: jobs are grouped into
homogeneous sub-batches by their shape signature, each bucket runs
through the work queue (:func:`~.ensemble.run_ensemble_queue`, or
:func:`~.ensemble_internal.run_internal_ensemble_queue` for internal
coordinates), and results are stitched back in input order.

Buckets keep every batch dense: padding each structure to the largest
atom count would pay the largest size's O(n^3) eighs for every lane and
let masked atoms into the free-subspace projection and the fmax
reduction. The JAX package also amortizes one compile per bucket shape
across calls through jax's jit cache; eager torch compiles nothing, so
that cache has no counterpart here (the hand-written Jacobi kernel of
``prfo_eigh="jacobi"`` is built once per process, for every n).

Device rule of every entry point: the jobs are numpy rows, so each
bucket goes to ``device``, by default the GPU, and raises where there is
none (``device="cpu"`` asks for the CPU). ``mesh=`` is not ported and
raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .ensemble import EnsembleConfig, run_ensemble_queue
from .ensemble_internal import (
    InternalEnsembleConfig,
    fixed_internal_constraints,
    run_internal_ensemble_queue,
)


def bucket_jobs(x0_list: Sequence[np.ndarray]):
    """Group job indices by DOF size. Returns ``{dim: [input indices]}``
    in first-seen order (deterministic)."""
    buckets: dict = {}
    for i, x in enumerate(x0_list):
        d = int(np.asarray(x).ravel().shape[0])
        if d % 3 != 0:
            raise ValueError(
                f"job {i}: flat coordinate length {d} is not 3*natoms"
            )
        buckets.setdefault(d, []).append(i)
    return buckets


def run_heterogeneous_queue(
    potential,
    x0_list: Sequence[np.ndarray],
    batch: int,
    cfg: Optional[EnsembleConfig] = None,
    max_steps_per_search: int = 300,
    refill_every: int = 10,
    seed: int = 0,
    mesh=None,
    max_retries: int = 0,
    retry_kick: float = 0.3,
    device=None,
    **cfg_overrides,
):
    """Run a mixed-size job list through per-shape homogeneous queues.

    ``x0_list``: flat (3*natoms,) start coordinates, sizes may differ per
    job. ``cfg``: a template :class:`EnsembleConfig` whose ``natoms`` is
    replaced per bucket (or None to build one from ``cfg_overrides``;
    with both, the overrides replace the template's fields). A bucket
    smaller than ``batch`` runs with exactly as many lanes as it has
    jobs. Returns one ``(x_final, f, nsteps, converged, nmatvec,
    neval)`` tuple per job, in input order."""
    if mesh is not None:
        raise NotImplementedError(
            "run_heterogeneous_queue(mesh=...) is not ported to "
            "sella_tpu_torch yet (ROADMAP.md)"
        )
    if cfg is None:
        cfg = EnsembleConfig(natoms=1, **cfg_overrides)
    elif cfg_overrides:
        cfg = cfg._replace(**cfg_overrides)

    buckets = bucket_jobs(x0_list)
    results: list = [None] * len(x0_list)
    for dim, idxs in buckets.items():
        bcfg = cfg._replace(natoms=dim // 3)
        x0 = np.stack([np.asarray(x0_list[i], dtype=np.float64).ravel()
                       for i in idxs])
        out = run_ensemble_queue(
            potential, x0, bcfg, min(batch, len(idxs)),
            max_steps_per_search=max_steps_per_search,
            refill_every=refill_every, seed=seed,
            max_retries=max_retries, retry_kick=retry_kick, device=device,
        )
        for i, r in zip(idxs, out):
            results[i] = r
    return results


def internal_topology_signature(ints) -> tuple:
    """Hashable bucket key for internal-coordinate jobs: two jobs may
    share one internal-tier batch iff they have the same species and the
    same discovered coordinate sets."""
    from ..coords import topology as _topo

    return (
        ints.natoms,
        tuple(int(z) for z in ints.atoms.numbers),
        ints.ntrans,
        ints.ndummies,
        tuple(sorted(_topo._bond_key(i, j, nc)
                     for i, j, nc in ints.bonds)),
        tuple(sorted(_topo._angle_key(i, j, k, nc)
                     for i, j, k, nc in ints.angles)),
        tuple(sorted(_topo._dihedral_key(i, j, k, l2, nc)
                     for i, j, k, l2, nc in ints.dihedrals)),
    )


def discover_internals(atoms, x0,
                       discover: Sequence[str] = ("bonds", "angles",
                                                  "dihedrals")):
    """The :class:`Internals` of ``atoms`` at the flat geometry ``x0``,
    with the coordinate kinds of ``discover`` found there."""
    from ..coords.internals import Internals

    at = atoms.copy()
    at.set_positions(np.asarray(x0, dtype=np.float64).reshape(-1, 3))
    ints = Internals(at)
    if "bonds" in discover:
        ints.find_all_bonds()
    if "angles" in discover:
        ints.find_all_angles()
    if "dihedrals" in discover:
        ints.find_all_dihedrals()
    return ints


def run_heterogeneous_internal_queue(
    jobs: Sequence[tuple],
    batch: int,
    cfg: Optional[InternalEnsembleConfig] = None,
    max_steps_per_search: int = 300,
    refill_every: int = 10,
    seed: int = 0,
    spill: Optional[str] = "cartesian",
    discover: Sequence[str] = ("bonds", "angles", "dihedrals"),
    device=None,
    **cfg_overrides,
):
    """Mixed-molecule sweep in internal coordinates, the internal-tier
    analogue of :func:`run_heterogeneous_queue`.

    ``jobs``: a sequence of ``(potential, atoms, x0)``; ``atoms`` carries
    the species, ``x0`` the flat start coordinates. Each job's topology
    is discovered at its own start geometry; jobs share a bucket iff
    their potential is the same object and their topology signatures
    (:func:`internal_topology_signature`) match. Per bucket the first
    job's :class:`Internals` drives one
    :func:`~.ensemble_internal.run_internal_ensemble_queue`; results
    come back in input order (the same 6-tuple contract). ``cfg``: a
    template whose per-bucket fields (natoms, nint, ndummies, ncons) are
    replaced per bucket."""
    if cfg is None:
        cfg = InternalEnsembleConfig(natoms=1, nint=1, **cfg_overrides)
    elif cfg_overrides:
        cfg = cfg._replace(**cfg_overrides)

    buckets: dict = {}
    bucket_ints: dict = {}
    for idx, (pot, atoms, x0) in enumerate(jobs):
        x = np.asarray(x0, dtype=np.float64).ravel()
        if x.shape[0] != 3 * len(atoms.positions):
            raise ValueError(
                f"job {idx}: x0 length {x.shape[0]} != 3*natoms"
            )
        ints = discover_internals(atoms, x, discover)
        key = (id(pot), internal_topology_signature(ints))
        buckets.setdefault(key, []).append(idx)
        if key not in bucket_ints:
            bucket_ints[key] = (pot, ints)

    results: list = [None] * len(jobs)
    for key, idxs in buckets.items():
        pot, ints = bucket_ints[key]
        cidx, _ = fixed_internal_constraints(ints)
        bcfg = cfg._replace(
            natoms=ints.natoms, nint=ints.nint,
            ndummies=ints.ndummies, ncons=len(cidx),
        )
        x0 = np.stack([np.asarray(jobs[i][2], dtype=np.float64).ravel()
                       for i in idxs])
        out = run_internal_ensemble_queue(
            pot, ints, x0, bcfg, min(batch, len(idxs)),
            max_steps_per_search=max_steps_per_search,
            refill_every=refill_every, seed=seed, spill=spill,
            device=device,
        )
        for i, r in zip(idxs, out):
            results[i] = r
    return results
