"""sella_tpu_torch — the PyTorch/CUDA port of sella_tpu.

The batched Cartesian RS-P-RFO saddle ensemble (``parallel.ensemble``) on
the EMT, Lennard-Jones and Morse potentials, with the P-RFO prep
eigendecomposition on a hand-written CUDA Jacobi kernel
(``ops.jacobi_eigh``). It imports torch and numpy, never jax: the JAX
package ``sella_tpu`` stays the reference the port is tested against.
"""
from .atoms import Atoms
from .parallel.ensemble import (
    EnsembleConfig,
    SearchState,
    init_state,
    make_step_fn,
    run_ensemble,
)
from .potentials import EMT, LennardJones, MorsePotential

__all__ = [
    "Atoms",
    "EMT",
    "EnsembleConfig",
    "LennardJones",
    "MorsePotential",
    "SearchState",
    "init_state",
    "make_step_fn",
    "run_ensemble",
]

__version__ = "0.1.0"
