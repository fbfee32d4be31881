from .ensemble import (
    EnsembleConfig,
    SearchState,
    free_basis,
    init_state,
    make_queue_fns,
    make_step_fn,
    refill_converged,
    run_ensemble,
    run_ensemble_queue,
)
from .metrics import EnsembleMetrics, summarize

__all__ = [
    "EnsembleConfig",
    "EnsembleMetrics",
    "SearchState",
    "free_basis",
    "init_state",
    "make_queue_fns",
    "make_step_fn",
    "refill_converged",
    "run_ensemble",
    "run_ensemble_queue",
    "summarize",
]
