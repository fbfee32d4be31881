"""Carrying optimizer state and weights between the JAX package and the
port.

Both packages' ``SearchState`` (and ``CellSearchState``,
``InternalSearchState``, ``CellInternalSearchState`` and ``IRCState``)
have the same fields. A JAX state converted with
``np.asarray`` per field becomes the port's state exactly (dtypes kept:
float64 arrays, int32 counters, bool masks), and back. The large-system
``MMFState`` nests an ``LBFGSMemory``; :func:`mmf_state_from_numpy` and
:func:`mmf_state_to_numpy` carry both levels. EMT's parameters follow
from the atomic numbers in both packages; the ``MLPotential`` weights
are carried by :func:`mlff_params_from_numpy`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .parallel.ensemble import SearchState, _target_device
from .parallel.largescale import LBFGSMemory, MMFState


def state_from_numpy(fields: Dict[str, np.ndarray], device=None,
                     state_cls=SearchState):
    """Build a ``state_cls`` state (:class:`SearchState` by default,
    ``CellSearchState``, ``InternalSearchState``,
    ``CellInternalSearchState`` or ``IRCState``) from numpy arrays
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


def _fields_of(obj) -> Dict:
    """A mapping's items, or a NamedTuple's (the JAX states themselves)."""
    return dict(obj._asdict()) if hasattr(obj, "_asdict") else dict(obj)


def mmf_state_from_numpy(fields, device=None) -> MMFState:
    """An :class:`MMFState` from numpy arrays keyed by field name, with
    ``"mem"`` a mapping (or NamedTuple) of the ``LBFGSMemory`` fields; a
    JAX ``MMFState`` itself is accepted. ``device`` as in
    :func:`state_from_numpy`."""
    fields = _fields_of(fields)
    device = _target_device(None, device)
    mem = state_from_numpy(_fields_of(fields["mem"]), device=device,
                           state_cls=LBFGSMemory)
    return MMFState(mem=mem, **{
        k: torch.as_tensor(np.array(fields[k], copy=True), device=device)
        for k in MMFState._fields if k != "mem"
    })


def mmf_state_to_numpy(state: MMFState) -> Dict:
    """Numpy copy of every field of an :class:`MMFState`, ``"mem"`` a
    dict of the ``LBFGSMemory`` fields."""
    out = {k: getattr(state, k).detach().cpu().numpy()
           for k in MMFState._fields if k != "mem"}
    out["mem"] = state_to_numpy(state.mem)
    return out


def mlff_params_from_numpy(params) -> Dict[str, np.ndarray]:
    """The JAX ``MLPotential`` weight pytree (``{"embed", "readout_w",
    "readout_b", "layers": [...]}``, arrays of any kind) as the flat
    numpy dict the port's ``MLPotential(params=...)`` and ``.npz`` files
    use (``L{t}_{key}``). Dtypes are kept."""
    from .potentials.mlff import flatten_params

    return {k: np.asarray(v) for k, v in flatten_params(params).items()}
