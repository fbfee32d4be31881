"""sella_tpu_torch — the PyTorch/CUDA port of sella_tpu.

* The batched Cartesian RS-P-RFO saddle ensemble (``parallel.ensemble``:
  fixed batches, constraints, restarts, and the work queue with
  checkpoint/resume), its P-RFO prep eigendecomposition on a
  hand-written CUDA Jacobi kernel (``ops.jacobi_eigh``).
* The batched atom+cell tier (``parallel.ensemble_cell``: fixed batches
  with the per-lane Niggli rebase, and its work queue).
* The batched internal+cell tier (``parallel.ensemble_cell_internal``:
  internals and log-deformation cell parameters, the per-lane repave
  and Niggli rebase, its work queue), batched IRC
  (``parallel.ensemble_irc``: forward, reverse and the both-directions
  work queue) and heterogeneous campaigns bucketed by shape
  (``parallel.hetero``).
* The batched internal-coordinate tier (``parallel.ensemble_internal``
  over the ``coords`` engine: redundant internals with dummy atoms,
  fixed internals, TRIC fragments, the per-lane repave, and its work
  queue with the Cartesian spill).
* The matrix-free large-system path (``parallel.largescale``: L-BFGS
  and Lanczos minimum-mode following) on the cell-binned O(N)
  potentials (``BinnedPairPotential``, ``BinnedEMT``, the
  message-passing ``MLPotential``) and the row-chunked pair panel.
* The potentials: EMT, Lennard-Jones, Morse, harmonic, TIP3P and
  Stillinger-Weber, optionally evaluated in float32 behind a float64
  interface (``potentials.F32Potential``).

It imports torch and numpy, never jax: the JAX package ``sella_tpu``
stays the reference the port is tested against.
"""
from .atoms import Atoms
from .coords import Constraints, Internals
from .parallel import (
    CellEnsembleConfig,
    CellInternalEnsembleConfig,
    CellInternalSearchState,
    CellSearchState,
    EnsembleConfig,
    EnsembleMetrics,
    IRCEnsembleConfig,
    IRCState,
    InternalEnsembleConfig,
    InternalSearchState,
    MMFState,
    SearchState,
    cells_of,
    init_cell_internal_state,
    init_cell_state,
    init_internal_state,
    init_irc_state,
    init_state,
    make_cell_internal_step_fn,
    make_cell_step_fn,
    make_internal_step_fn,
    make_irc_step_fn,
    make_mmf_step,
    make_queue_fns,
    make_step_fn,
    niggli_rebase_cell_lanes,
    refill_converged,
    run_cell_ensemble,
    run_cell_ensemble_queue,
    run_cell_internal_ensemble,
    run_cell_internal_ensemble_queue,
    run_ensemble,
    run_ensemble_queue,
    run_heterogeneous_internal_queue,
    run_heterogeneous_queue,
    run_internal_ensemble,
    run_internal_ensemble_queue,
    run_irc_ensemble,
    run_irc_ensemble_queue,
    run_mmf,
    summarize,
)
from .potentials import (
    EMT,
    TIP3P,
    BinnedEMT,
    BinnedPairPotential,
    ChunkedPairPotential,
    F32Potential,
    Harmonic,
    LennardJones,
    MLPotential,
    MorsePotential,
    StillingerWeber,
)

__all__ = [
    "Atoms",
    "BinnedEMT",
    "BinnedPairPotential",
    "CellEnsembleConfig",
    "CellInternalEnsembleConfig",
    "CellInternalSearchState",
    "CellSearchState",
    "ChunkedPairPotential",
    "Constraints",
    "EMT",
    "EnsembleConfig",
    "EnsembleMetrics",
    "F32Potential",
    "Harmonic",
    "IRCEnsembleConfig",
    "IRCState",
    "InternalEnsembleConfig",
    "InternalSearchState",
    "Internals",
    "LennardJones",
    "MLPotential",
    "MMFState",
    "MorsePotential",
    "SearchState",
    "StillingerWeber",
    "TIP3P",
    "cells_of",
    "init_cell_internal_state",
    "init_cell_state",
    "init_internal_state",
    "init_irc_state",
    "init_state",
    "make_cell_internal_step_fn",
    "make_cell_step_fn",
    "make_internal_step_fn",
    "make_irc_step_fn",
    "make_mmf_step",
    "make_queue_fns",
    "make_step_fn",
    "niggli_rebase_cell_lanes",
    "refill_converged",
    "run_cell_ensemble",
    "run_cell_ensemble_queue",
    "run_cell_internal_ensemble",
    "run_cell_internal_ensemble_queue",
    "run_ensemble",
    "run_ensemble_queue",
    "run_heterogeneous_internal_queue",
    "run_heterogeneous_queue",
    "run_internal_ensemble",
    "run_internal_ensemble_queue",
    "run_irc_ensemble",
    "run_irc_ensemble_queue",
    "run_mmf",
    "summarize",
]

__version__ = "0.1.0"
