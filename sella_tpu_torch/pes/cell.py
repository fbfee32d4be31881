"""Cell parameterization helpers of the atom+cell PES.

Counterpart of ``sella_tpu/pes/cell.py``. The cell is
``expm(L / factor) @ cell0`` with ``L`` the scaled log-deformation (the
ASE FrechetCellFilter-style chart of ``CellCartesianPES``). For now this
module holds the chart's Jacobian, which the batched tier's per-lane
rebase needs; the sequential cell PES classes are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from ..ops.linalg import expm


def _cell_param_jacobian(L: np.ndarray, cell0: np.ndarray,
                         factor: float) -> np.ndarray:
    """J[ab, ij] = d(cell_ab)/d(L_ij) at L, shape (9, 9), by forward-mode
    autodiff through :func:`expm` on the CPU in float64 (host-side, like
    the rebase event that calls it)."""
    L = torch.as_tensor(np.asarray(L, dtype=np.float64))
    cell0 = torch.as_tensor(np.asarray(cell0, dtype=np.float64))

    def cell_of(Lflat):
        return (expm(Lflat.reshape(3, 3) / factor) @ cell0).reshape(-1)

    return jacfwd(cell_of)(L.reshape(-1)).numpy()
