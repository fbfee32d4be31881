"""sella_tpu_torch — the PyTorch/CUDA port of sella_tpu.

The batched Cartesian RS-P-RFO saddle ensemble (``parallel.ensemble``:
fixed batches, constraints, restarts, and the work queue with
checkpoint/resume) and the batched atom+cell tier
(``parallel.ensemble_cell``: fixed batches with the per-lane Niggli
rebase, and its work queue) on the EMT, Lennard-Jones and Morse
potentials, optionally evaluated in float32 behind a float64 interface
(``potentials.F32Potential``), with the P-RFO prep eigendecomposition of
the Cartesian tier on a hand-written CUDA Jacobi kernel
(``ops.jacobi_eigh``). It imports torch and numpy, never jax: the JAX
package ``sella_tpu`` stays the reference the port is tested against.
"""
from .atoms import Atoms
from .parallel import (
    CellEnsembleConfig,
    CellSearchState,
    EnsembleConfig,
    EnsembleMetrics,
    SearchState,
    cells_of,
    init_cell_state,
    init_state,
    make_cell_step_fn,
    make_queue_fns,
    make_step_fn,
    niggli_rebase_cell_lanes,
    refill_converged,
    run_cell_ensemble,
    run_cell_ensemble_queue,
    run_ensemble,
    run_ensemble_queue,
    summarize,
)
from .potentials import EMT, F32Potential, LennardJones, MorsePotential

__all__ = [
    "Atoms",
    "CellEnsembleConfig",
    "CellSearchState",
    "EMT",
    "EnsembleConfig",
    "EnsembleMetrics",
    "F32Potential",
    "LennardJones",
    "MorsePotential",
    "SearchState",
    "cells_of",
    "init_cell_state",
    "init_state",
    "make_cell_step_fn",
    "make_queue_fns",
    "make_step_fn",
    "niggli_rebase_cell_lanes",
    "refill_converged",
    "run_cell_ensemble",
    "run_cell_ensemble_queue",
    "run_ensemble",
    "run_ensemble_queue",
    "summarize",
]

__version__ = "0.1.0"
