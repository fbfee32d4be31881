"""Checkpoint/resume for the batched ensemble (``torch.save``).

Counterpart of ``sella_tpu/parallel/checkpoint.py``: a tier's state
NamedTuple, and for a work queue its host bookkeeping too, is saved as one
dict of tensors and restored with ``torch.load(..., weights_only=True)``.
Every entry is a tensor (numpy bookkeeping included), because
``weights_only`` loading refuses numpy arrays. A save writes a temporary
file beside the target and renames it over the target, so a crash during
the save leaves the previous checkpoint intact.

Where a checkpoint loads follows the rule of ``run_ensemble``: ``device``
names the device, by default the GPU, and loading raises where there is
none; ``device="cpu"`` asks for the CPU.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .ensemble import SearchState, _target_device


def _atomic_save(payload: dict, path: str) -> None:
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load(path: str, device) -> dict:
    # a non-tensor "x0" makes _target_device pick the GPU (or raise)
    # unless a device is named
    dev = _target_device(None, device)
    return torch.load(os.path.abspath(path), map_location=dev,
                      weights_only=True)


def _rebuild_state(payload, state_cls, fmax_default=1e-3):
    """Reconstruct a tier state NamedTuple from a payload, tolerating
    payloads written before late-added fields existed.

    ``SearchState.fmax_t`` (the runtime convergence gate) defaults to
    ``fmax_default`` when absent — callers that know the run's gate pass
    ``cfg.fmax``, so a checkpoint of an fmax=0.02 sweep is not resumed
    under a 20x stricter gate. Any other missing field is a genuine
    version mismatch and raises ``KeyError`` with the field name."""
    kw = {}
    for k in state_cls._fields:
        if k in payload:
            kw[k] = payload[k]
        elif k == "fmax_t":
            x = payload["x"]
            kw[k] = torch.tensor(fmax_default, dtype=x.dtype,
                                 device=x.device)
        else:
            raise KeyError(
                f"checkpoint payload is missing field {k!r} required by "
                f"{state_cls.__name__}: written by an incompatible "
                "version"
            )
    return state_cls(**kw)


def save_state(path: str, state, step: Optional[int] = None):
    """Save an ensemble state NamedTuple of tensors."""
    payload = state._asdict()
    if step is not None:
        payload = dict(payload, _step=torch.tensor(int(step)))
    _atomic_save(payload, path)


def load_state(path: str, state_cls=SearchState, fmax_default=1e-3,
               device=None) -> tuple:
    """Restore ``(state, step)`` saved by :func:`save_state` onto
    ``device`` (see the module docstring). ``fmax_default``: the gate
    applied if the payload predates the ``fmax_t`` field — pass the run's
    ``cfg.fmax``."""
    payload = _load(path, device)
    step = payload.pop("_step", None)
    state = _rebuild_state(payload, state_cls, fmax_default=fmax_default)
    return state, (int(step) if step is not None else None)


def _i64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64))


def save_queue(path: str, state, origin: np.ndarray, next_idx: int,
               results: dict, retry_state: dict = None,
               it: Optional[int] = None,
               rng_state: Optional[torch.Tensor] = None):
    """Checkpoint a work queue: the state plus the host bookkeeping
    (lane->input map, queue cursor, harvested results).

    ``retry_state``: optional dict with keys ``pending`` (list of
    (origin, x_start)), ``retries`` and ``spent`` (dicts by origin) — the
    retry bookkeeping of :func:`~sella_tpu_torch.parallel.ensemble.
    run_ensemble_queue`; a resumed sweep with ``max_retries > 0`` would
    never finish the retried inputs without it.

    ``it`` (the queue's step counter, which seeds the retry kicks) and
    ``rng_state`` (the run generator's ``get_state()``) let a resumed
    sweep continue its random streams instead of replaying the kicks and
    probes it has already used.

    Empty result and retry sets are encoded by the ABSENCE of their keys;
    a result without counters is saved with ``-1`` counters."""
    idxs = np.asarray(sorted(results), dtype=np.int64)
    payload = dict(
        state._asdict(),
        _origin=_i64(origin),
        _next_idx=torch.tensor(int(next_idx)),
    )
    if len(idxs):
        payload.update(
            _res_idx=_i64(idxs),
            _res_x=torch.as_tensor(np.stack(
                [np.asarray(results[i][0]) for i in idxs])),
            _res_f=torch.as_tensor(np.asarray(
                [results[i][1] for i in idxs], dtype=np.float64)),
            _res_nsteps=_i64([results[i][2] for i in idxs]),
            _res_conv=torch.as_tensor(np.asarray(
                [results[i][3] for i in idxs], dtype=bool)),
            # matvec/force counters (6-tuple results)
            _res_nmatvec=_i64([results[i][4] if len(results[i]) > 4
                               else -1 for i in idxs]),
            _res_neval=_i64([results[i][5] if len(results[i]) > 5
                             else -1 for i in idxs]),
        )
    if it is not None:
        payload["_it"] = torch.tensor(int(it))
    if rng_state is not None:
        payload["_rng"] = rng_state.detach().cpu()
    if retry_state is not None:
        pend = retry_state.get("pending", [])
        if pend:
            payload["_pend_idx"] = _i64([p[0] for p in pend])
            payload["_pend_x"] = torch.as_tensor(np.stack(
                [np.asarray(p[1]) for p in pend]))
        rt = retry_state.get("retries", {})
        sp = retry_state.get("spent", {})
        keys = np.asarray(sorted(set(rt) | set(sp)), dtype=np.int64)
        if keys.size:
            payload["_retry_idx"] = _i64(keys)
            payload["_retry_n"] = _i64([rt.get(int(k), 0) for k in keys])
            payload["_retry_spent"] = _i64(
                [sp.get(int(k), (0, 0, 0)) for k in keys]
            ).reshape(len(keys), 3)
    _atomic_save(payload, path)


def load_queue(path: str, state_cls=SearchState,
               with_retry_state: bool = False, fmax_default=1e-3,
               device=None):
    """Restore ``(state, origin, next_idx, results)`` saved by
    :func:`save_queue`, the state on ``device`` (see the module
    docstring) and the bookkeeping as numpy and Python values. With
    ``with_retry_state=True`` a fifth element is appended: the retry
    bookkeeping dict (``pending``, ``retries``, ``spent``, possibly
    empty), with the step counter ``it`` (0 if absent) and the generator
    state ``rng_state`` (a CPU tensor, or None if absent)."""
    payload = _load(path, device)
    state = _rebuild_state(payload, state_cls, fmax_default=fmax_default)

    def host(k):
        return payload[k].cpu().numpy()

    origin = host("_origin").astype(np.int64)
    next_idx = int(payload["_next_idx"])
    results = {}
    if "_res_idx" in payload:
        rx, rf, rn, rc = (host(k) for k in
                          ("_res_x", "_res_f", "_res_nsteps", "_res_conv"))
        mv = host("_res_nmatvec") if "_res_nmatvec" in payload else None
        ne = host("_res_neval") if "_res_neval" in payload else None
        for k, i in enumerate(host("_res_idx")):
            # negative counters are the save-side sentinel for results
            # that never carried them: restore those as 4-tuples
            counters = ((int(mv[k]), int(ne[k]))
                        if mv is not None and ne is not None
                        and mv[k] >= 0 and ne[k] >= 0 else ())
            results[int(i)] = (rx[k].copy(), float(rf[k]), int(rn[k]),
                               bool(rc[k])) + counters
    if not with_retry_state:
        return state, origin, next_idx, results
    retry_state = {"pending": [], "retries": {}, "spent": {}}
    if "_pend_idx" in payload:
        px = host("_pend_x")
        retry_state["pending"] = [
            (int(i), px[k].copy())
            for k, i in enumerate(host("_pend_idx"))
        ]
    if "_retry_idx" in payload:
        rk = host("_retry_idx")
        rn = host("_retry_n")
        rs = host("_retry_spent").reshape(len(rk), 3)
        retry_state["retries"] = {int(i): int(rn[k])
                                  for k, i in enumerate(rk)}
        retry_state["spent"] = {int(i): tuple(int(v) for v in rs[k])
                                for k, i in enumerate(rk)}
    retry_state["it"] = int(payload["_it"]) if "_it" in payload else 0
    retry_state["rng_state"] = (payload["_rng"].cpu() if "_rng" in payload
                                else None)
    return state, origin, next_idx, results, retry_state
