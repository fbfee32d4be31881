"""Carrying optimizer state between the JAX package and the port.

Both packages' ``SearchState`` have the same fields. A JAX state
converted with ``np.asarray`` per field becomes the port's state exactly
(dtypes kept: float64 arrays, int32 counters, bool masks), and back.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .parallel.ensemble import SearchState, _target_device


def state_from_numpy(fields: Dict[str, np.ndarray],
                     device=None) -> SearchState:
    """Build a :class:`SearchState` from numpy arrays keyed by field name
    (every field required) on ``device``: by default the GPU, raising
    where there is none; ``device="cpu"`` asks for the CPU."""
    missing = set(SearchState._fields) - set(fields)
    if missing:
        raise KeyError(f"missing SearchState fields: {sorted(missing)}")
    device = _target_device(None, device)
    return SearchState(**{
        k: torch.as_tensor(np.array(fields[k], copy=True), device=device)
        for k in SearchState._fields
    })


def state_to_numpy(state: SearchState) -> Dict[str, np.ndarray]:
    """Numpy copy of every field of ``state``, keyed by field name."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in SearchState._fields}
