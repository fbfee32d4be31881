"""Host-side lattice utilities: greedy (Minkowski-style) basis reduction
and minimum-image integer offsets.

A copy of ``sella_tpu/utils/lattice.py`` (numpy only; the port imports
nothing of the JAX package). Sella leans on ASE's ``minkowski_reduce``
before any image search (``sella/internal.py:2634-2691``); this module
is the dependency-free equivalent, used here by the atom+cell tier's
per-lane rebase (:func:`sella_tpu_torch.parallel.ensemble_cell.
niggli_rebase_cell_lanes`).
"""
from __future__ import annotations

from itertools import product
from typing import Optional, Tuple

import numpy as np


def reduce_cell_basis(
    cell: np.ndarray, pbc: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy (Minkowski-style) lattice basis reduction.

    Returns ``(new_cell, M)`` with integer unimodular M such that
    ``new_cell = M @ cell`` and the rows of new_cell are as short/compact
    as a greedy pairwise reduction achieves — the role ASE's
    ``niggli_reduce``/``minkowski_reduce`` play for the reference
    (``peswrapper.py:194-196``, ``internal.py:2638``).

    With ``pbc`` given, only periodic rows are reduced and only by
    integer multiples of other periodic rows (non-periodic axes of a
    slab must not mix into the in-plane basis).
    """
    cell = np.asarray(cell, dtype=np.float64).copy()
    if pbc is None:
        periodic = [0, 1, 2]
    else:
        periodic = [i for i in range(3) if pbc[i]]
    M = np.eye(3, dtype=np.int64)
    for _ in range(100):
        changed = False
        for i in periodic:
            others = [j for j in periodic if j != i]
            if not others:
                continue
            Bo = cell[others]
            # best integer combination of the other periodic vectors
            coef, *_ = np.linalg.lstsq(Bo.T, cell[i], rcond=None)
            r = np.round(coef).astype(np.int64)
            if np.any(r != 0):
                new_vec = cell[i] - r @ Bo
                if (np.linalg.norm(new_vec)
                        < np.linalg.norm(cell[i]) - 1e-12):
                    cell[i] = new_vec
                    M[i] -= r @ M[others]
                    changed = True
        if not changed:
            break
    # canonical orientation: keep determinant sign
    if np.linalg.det(cell) < 0 and len(periodic) == 3:
        cell[2] *= -1
        M[2] *= -1
    return cell, M


def mic_ncvec(dx: np.ndarray, cell: np.ndarray, pbc) -> np.ndarray:
    """Integer cell offset n minimizing ``|dx + n @ cell|`` — the
    minimum-image vector resolved through the REDUCED basis so skewed
    cells cannot hide a closer image outside the naive +-1 shell
    (reference ``internal.py:2634-2668``)."""
    pbc = np.asarray(pbc, dtype=bool)
    dx = np.asarray(dx, dtype=np.float64)
    if not np.any(pbc):
        return np.zeros(3, dtype=np.int64)
    rcell, M = reduce_cell_basis(cell, pbc)
    frac = dx @ np.linalg.pinv(rcell)
    offset = np.where(pbc, np.round(frac), 0.0).astype(np.int64)
    best = None
    best_len = np.inf
    # +-2 shell: the greedy pairwise reduction is weaker than a full
    # Minkowski reduction (where +-1 would be provably exhaustive), so
    # spend the extra 5^3 host-side evaluations on safety
    ranges = [np.arange(-2, 3) if p else np.arange(0, 1) for p in pbc]
    for ts in product(*ranges):
        n_red = np.asarray(ts, dtype=np.int64) - offset
        trial = np.linalg.norm(dx + n_red @ rcell)
        if trial < best_len:
            best_len = trial
            best = n_red
    return best @ M
