"""Mixed-precision potential evaluation (float32 compute, float64
interface).

Counterpart of ``sella_tpu/potentials/mixed.py``. The JAX package
evaluates potentials in float32 because the TPU emulates float64; the
H100 computes float64 natively, so whether the split still pays there is
an open measurement (``chip_smoke.py`` phase 11 times both). The
optimizer stays float64 either way: its root-finds and eigensolves carry
1e-8..1e-14 tolerances, while a float32 force carries ~1e-6 relative
error, far below the fmax = 1e-3 gate.

:class:`F32Potential` wraps any torch-native :class:`Potential`: ``x``
and ``cell`` are cast to float32 at the call boundary, a copy of the
inner potential with float32 parameters computes the energy, and the
scalar returns as float64. Because the split lives inside ``energy``,
every derived transform (``grad``, the Davidson HVPs via ``jvp`` over
``grad``, the strain gradient) inherits it: autograd casts the
(co)tangents back at the same boundary.

Pair it with ``EnsembleConfig.pred_min`` of roughly ``1e-6 * |E|``: the
trust ratio compares energy differences, which near convergence shrink
below the float32 noise floor of the energy.
"""
from __future__ import annotations

import copy

import torch

from .base import Potential

__all__ = ["F32Potential"]


class F32Potential(Potential):
    """Evaluate ``inner`` in float32 behind a float64 interface.

    The float32 copy is a deep copy of ``inner`` with every floating
    buffer and parameter cast to float32 (``nn.Module.float``); integer
    and bool buffers, and Python float attributes, stay as they are. It
    is the wrapper's only submodule, so ``.to(device)`` moves it and
    leaves ``inner`` where it is; ``inner`` is kept, unchanged, for
    :meth:`validate_cell` (a host-side check)."""

    def __init__(self, inner: Potential) -> None:
        super().__init__()
        self.pbc = inner.pbc
        self._inner32 = copy.deepcopy(inner).float()
        # a plain attribute, not a registered submodule
        object.__setattr__(self, "_orig", inner)

    def validate_cell(self, cell) -> None:
        self._orig.validate_cell(cell)

    def energy(self, x: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
        e = self._inner32.energy(x.to(torch.float32),
                                 cell.to(torch.float32))
        return e.to(torch.float64)
