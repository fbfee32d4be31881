"""Carrying optimizer state between the JAX package and the port.

Both packages' ``SearchState`` (and ``CellSearchState`` and
``InternalSearchState``) have the same fields. A JAX state converted with ``np.asarray`` per field becomes the
port's state exactly (dtypes kept: float64 arrays, int32 counters, bool
masks), and back. Potentials carry no state across: EMT's parameters
follow from the atomic numbers in both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .parallel.ensemble import SearchState, _target_device


def state_from_numpy(fields: Dict[str, np.ndarray], device=None,
                     state_cls=SearchState):
    """Build a ``state_cls`` state (:class:`SearchState` by default,
    ``CellSearchState`` or ``InternalSearchState``) from numpy arrays
    keyed by field name (every field required) on ``device``: by default
    the GPU, raising where there is none; ``device="cpu"`` asks for the
    CPU."""
    missing = set(state_cls._fields) - set(fields)
    if missing:
        raise KeyError(f"missing {state_cls.__name__} fields: "
                       f"{sorted(missing)}")
    device = _target_device(None, device)
    return state_cls(**{
        k: torch.as_tensor(np.array(fields[k], copy=True), device=device)
        for k in state_cls._fields
    })


def state_to_numpy(state, state_cls=None) -> Dict[str, np.ndarray]:
    """Numpy copy of every field of ``state`` (of ``state_cls``'s fields,
    by default those of the state's own type), keyed by field name."""
    fields = (state_cls or type(state))._fields
    return {k: getattr(state, k).detach().cpu().numpy() for k in fields}
