from .ensemble import (
    EnsembleConfig,
    SearchState,
    free_basis,
    init_state,
    make_step_fn,
    run_ensemble,
)

__all__ = [
    "EnsembleConfig",
    "SearchState",
    "free_basis",
    "init_state",
    "make_step_fn",
    "run_ensemble",
]
