"""sella_tpu_torch — the PyTorch/CUDA port of sella_tpu.

The batched Cartesian RS-P-RFO saddle ensemble (``parallel.ensemble``:
fixed batches, constraints, restarts, and the work queue with
checkpoint/resume) on the EMT, Lennard-Jones and Morse potentials, with
the P-RFO prep
eigendecomposition on a hand-written CUDA Jacobi kernel
(``ops.jacobi_eigh``). It imports torch and numpy, never jax: the JAX
package ``sella_tpu`` stays the reference the port is tested against.
"""
from .atoms import Atoms
from .parallel import (
    EnsembleConfig,
    EnsembleMetrics,
    SearchState,
    init_state,
    make_queue_fns,
    make_step_fn,
    refill_converged,
    run_ensemble,
    run_ensemble_queue,
    summarize,
)
from .potentials import EMT, LennardJones, MorsePotential

__all__ = [
    "Atoms",
    "EMT",
    "EnsembleConfig",
    "EnsembleMetrics",
    "LennardJones",
    "MorsePotential",
    "SearchState",
    "init_state",
    "make_queue_fns",
    "make_step_fn",
    "refill_converged",
    "run_ensemble",
    "run_ensemble_queue",
    "summarize",
]

__version__ = "0.1.0"
