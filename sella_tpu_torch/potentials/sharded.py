"""Row-chunked O(N^2) pair panel for one large system.

Counterpart of ``sella_tpu.potentials.sharded.ChunkedPairPotential``:
the anchor the cell-binned path (:mod:`.binned`) is compared with at 10k
atoms. The JAX package's two mesh-sharded classes
(``ShardedPairPotential``, ``ShardedBinnedPotential``) need a device
mesh and wait for the port's ``mesh=`` (ROADMAP.md).
"""
from __future__ import annotations

import torch

from ..ops.linalg import inv3
from .binned import RowChunked


class ChunkedPairPotential(RowChunked):
    """The (n, n) interaction panel in sequential row chunks of
    ``chunk`` atoms: peak memory ``chunk * n`` instead of ``n^2``.

    The JAX package maps the chunks with a plain ``lax.map``; here the
    energy is summed chunk by chunk and so are the gradient and the HVP
    (:class:`~sella_tpu_torch.potentials.binned.RowChunked`), which is
    what bounds the memory under ``torch.func``. Minimum image by
    rounding fractional displacements (half to even in both packages)."""

    def __init__(self, inner, chunk: int = 512) -> None:
        super().__init__()
        if not hasattr(inner, "pair_energy"):
            raise TypeError(
                f"{type(inner).__name__} exposes no pair_energy(r); "
                "ChunkedPairPotential needs a pair potential"
            )
        self.inner = inner
        self.chunk = int(chunk)
        self.pbc = getattr(inner, "pbc", False)

    def _prepare(self, x, cell):
        return inv3(cell) if self.pbc else None

    def _rows_energy(self, x, cell, inv, rows):
        n = x.shape[0] // 3
        pos = x.reshape(n, 3)
        in_range = rows < n
        rows_c = torch.clamp(rows, max=n - 1)
        dr = pos[None, :, :] - pos[rows_c][:, None, :]   # (chunk, n, 3)
        if self.pbc:
            frac = dr @ inv
            dr = (frac - torch.round(frac)) @ cell
        r2 = torch.sum(dr * dr, dim=-1)
        cols = torch.arange(n, device=x.device)
        valid = in_range[:, None] & (rows_c[:, None] != cols[None])
        # the guard keeps grad and HVP finite on the masked diagonal
        r = torch.sqrt(torch.where(valid, r2, 1.0))
        e = torch.where(valid, self.inner.pair_energy(r), 0.0)
        return 0.5 * torch.sum(e)
