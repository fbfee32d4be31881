"""O(N) cell-binned potentials: the large-system fast path.

Counterpart of ``sella_tpu/potentials/binned.py``. The dense pair panel
does O(N^2) work per force call; at 10k atoms only ~1e6 of its 1e8 pairs
are inside any physical cutoff. This module bins atoms into a static
grid of rc-sized cells on the device with fixed shapes and evaluates
only the 27-cell neighborhoods:

1. bin index per atom (fractional coordinates for PBC, a static
   bounding box otherwise; clipping is 1-Lipschitz, so two atoms within
   rc never land more than one bin apart);
2. a stable sort by bin id, and the rank within a bin by
   ``searchsorted``;
3. a scatter into a ``(ncells, capacity)`` bucket table (over-capacity
   ranks are dropped: see :meth:`CellBins.overflow_count`);
4. every atom gathers the 27 neighboring buckets' candidates, computes
   masked distances (minimum image for PBC) and sums the per-pair terms
   under the cutoff.

The integer binning carries no gradient: positions enter only through
the final gather, so forces and the exact Lanczos HVPs of
:mod:`sella_tpu_torch.parallel.largescale` are O(N) too.

:class:`RowChunked` is the memory bound of the large-N potentials: the
energy is a sum over atom rows, so the gradient and the HVP are summed
chunk by chunk, each chunk's graph freed before the next is built.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.func import grad, grad_and_value, jvp

from ..ops.linalg import inv3
from .base import Potential


def row_blocks(n: int, chunk: int, device) -> torch.Tensor:
    """``(nchunks, chunk)`` atom rows, the last block padded with the
    sentinel ``n`` (a sentinel row contributes exactly zero)."""
    nchunks = -(-n // chunk)
    rows = torch.arange(nchunks * chunk, device=device)
    return torch.where(rows < n, rows, n).reshape(nchunks, chunk)


class RowChunked(Potential):
    """A potential whose energy is a sum over atom rows.

    Subclasses implement :meth:`_prepare` (whatever the rows share: the
    bucket table, the inverse cell; it carries no gradient in ``x``) and
    :meth:`_rows_energy` (the energy the atoms in ``rows`` own, as a
    function of ALL positions). With ``chunk`` set, :meth:`energy_and_grad`
    and :meth:`hvp` transform one chunk at a time and sum: E = sum_c E_c,
    so the gradient and the HVP are sums of the chunks' too. The JAX
    package bounds memory with ``lax.map(jax.checkpoint(...))`` instead;
    a Python loop of chunks inside one ``torch.func.grad`` would keep
    every chunk's graph alive and bound nothing. :meth:`energy` itself
    stays one pure function (summed chunk by chunk), so any transform
    of it is still the same function."""

    chunk: Optional[int] = None

    def _prepare(self, x, cell):
        raise NotImplementedError

    def _rows_energy(self, x, cell, ctx, rows):
        raise NotImplementedError

    def _blocks(self, x):
        n = x.shape[0] // 3
        if self.chunk is None:
            return torch.arange(n, device=x.device)[None]
        return row_blocks(n, min(int(self.chunk), n), x.device)

    def energy(self, x, cell):
        ctx = self._prepare(x, cell)
        es = [self._rows_energy(x, cell, ctx, rows)
              for rows in self._blocks(x)]
        return es[0] if len(es) == 1 else torch.sum(torch.stack(es))

    def energy_and_grad(self, x, cell):
        if self.chunk is None:
            return super().energy_and_grad(x, cell)
        ctx = self._prepare(x.detach(), cell)
        e = g = None
        for rows in self._blocks(x):
            gc, ec = grad_and_value(
                lambda y: self._rows_energy(y, cell, ctx, rows))(x)
            e = ec if e is None else e + ec
            g = gc if g is None else g + gc
        return e, g

    def hvp(self, x, v, cell):
        if self.chunk is None:
            return super().hvp(x, v, cell)
        ctx = self._prepare(x.detach(), cell)
        out = None
        for rows in self._blocks(x):
            hc = jvp(grad(lambda y: self._rows_energy(y, cell, ctx, rows)),
                     (x,), (v,))[1]
            out = hc if out is None else out + hc
        return out


class CellBins(nn.Module):
    """Static cell-list grid and on-device candidate gather.

    Parameters
    ----------
    x0 : (3n,) or (n, 3) initial positions: they fix the static grid
        (the bounding box for free boundaries) and the default capacity.
    rc : interaction cutoff; also the bin edge length.
    cell : (3, 3) or None: the periodic cell. Binning uses fractional
        coordinates of the RUN-TIME cell, but the bin counts come from
        this one, which must keep every periodic height >= 3 rc.
    capacity : atoms per bin (static). Default: 2x the initial maximum
        occupancy, rounded up to a multiple of 4.
    margin : free-boundary bounding-box padding in units of rc.

    The 27 neighbor offsets, the bin counts, the origin and the bin
    widths are buffers, so ``.to()`` of the owning potential moves them.
    """

    def __init__(self, x0, rc: float, cell=None,
                 capacity: Optional[int] = None,
                 margin: float = 2.0) -> None:
        super().__init__()
        self.rc = float(rc)
        self.pbc = cell is not None
        pos = _host(x0).reshape(-1, 3)
        self.n = pos.shape[0]

        if self.pbc:
            cell = _host(cell)
            self._cell_np = cell
            vol = abs(np.linalg.det(cell))
            heights = np.array([
                vol / np.linalg.norm(np.cross(cell[(a + 1) % 3],
                                              cell[(a + 2) % 3]))
                for a in range(3)
            ])
            nbins = np.floor(heights / rc).astype(int)
            if np.any(nbins < 3):
                raise ValueError(
                    f"periodic axes must satisfy height >= 3 rc for "
                    f"the binned path (heights {heights}, rc {rc}); "
                    "use the dense/chunked potential for small cells"
                )
            lo = np.zeros(3)
            w = 1.0 / nbins                     # fractional bin widths
        else:
            self._cell_np = None
            lo = pos.min(axis=0) - margin * rc
            hi = pos.max(axis=0) + margin * rc
            nbins = np.maximum(np.ceil((hi - lo) / rc).astype(int), 1)
            w = np.full(3, rc)
        self._lo_np = lo
        self._w_np = w
        self.nbins = tuple(int(b) for b in nbins)
        self.ncells = int(np.prod(nbins))

        if capacity is None:
            occ = int(self._host_max_occupancy(pos))
            capacity = max(((2 * occ + 3) // 4) * 4, 4)
        self.capacity = int(capacity)

        off = np.stack(np.meshgrid(*[[-1, 0, 1]] * 3,
                                   indexing="ij"), -1).reshape(27, 3)
        self.register_buffer("offsets", torch.from_numpy(off.astype(
            np.int64)))
        self.register_buffer("nbins_t", torch.tensor(self.nbins))
        self.register_buffer("lo", torch.from_numpy(lo.astype(np.float64)))
        self.register_buffer("w", torch.from_numpy(w.astype(np.float64)))

    # -- host-side diagnostics ------------------------------------------
    def _host_max_occupancy(self, pos: np.ndarray) -> int:
        if self.pbc:
            frac = pos @ np.linalg.inv(self._cell_np)
            frac -= np.floor(frac)
            b3 = np.clip((frac / self._w_np).astype(int), 0,
                         np.array(self.nbins) - 1)
        else:
            b3 = np.clip(((pos - self._lo_np) / self._w_np).astype(int), 0,
                         np.array(self.nbins) - 1)
        ids = np.ravel_multi_index(b3.T, self.nbins)
        return int(np.bincount(ids, minlength=self.ncells).max())

    def max_occupancy(self, x) -> int:
        """Current max atoms-per-bin (host side); call after large moves
        to confirm ``capacity`` still holds: overflowing atoms silently
        drop out of everyone's candidate lists."""
        return self._host_max_occupancy(_host(x).reshape(-1, 3))

    # -- device side ------------------------------------------------------
    def _bin3(self, pos, cell):
        """Per-atom integer bin coordinates, (n, 3) int64. The cast
        truncates toward zero in both packages (``.astype(int32)``,
        ``.to(int64)``), so an atom that drifted just below a free box's
        origin lands in bin 0 in both before the clip."""
        if self.pbc:
            frac = pos @ inv3(cell)
            frac = frac - torch.floor(frac)
            b = frac / self.w
        else:
            b = (pos - self.lo) / self.w
        return torch.clamp(b.to(torch.int64), torch.zeros_like(self.nbins_t),
                           self.nbins_t - 1)

    def _binid(self, b3):
        nb = self.nbins_t
        return (b3[..., 0] * nb[1] + b3[..., 1]) * nb[2] + b3[..., 2]

    def overflow_count(self, pos, cell):
        """Device-side count of atoms beyond their bin's capacity, a 0-d
        tensor (no host sync). Overflowing atoms drop out of every
        candidate list, so a nonzero count means the energy is wrong."""
        binid = self._binid(self._bin3(pos.reshape(-1, 3), cell))
        sbin = torch.sort(binid).values
        rank = torch.arange(self.n, device=pos.device) - torch.searchsorted(
            sbin, sbin, side="left")
        return torch.sum(rank >= self.capacity)

    def candidates(self, pos, cell):
        """``(cand, r2, valid)`` for every atom; see :meth:`gather_rows`."""
        table = self.bucket_table(pos, cell)
        return self.gather_rows(pos, cell, table,
                                torch.arange(self.n, device=pos.device))

    def bucket_table(self, pos, cell):
        """Stage 1: bin ids and the (ncells + 1, K) bucket scatter.

        Returns ``(bucket, b3, inv)``, consumed by :meth:`gather_rows`.
        Integer work only: it carries no gradient."""
        n, K, ncells = self.n, self.capacity, self.ncells
        b3 = self._bin3(pos, cell)
        binid = self._binid(b3)
        # the sort MUST be stable, as jnp.argsort is: the rank within a
        # bin decides which atoms a bin over capacity drops, so an
        # unstable sort drops different atoms and changes the energy
        order = torch.argsort(binid, stable=True)
        sbin = binid[order]
        first = torch.searchsorted(sbin, sbin, side="left")
        rank = torch.arange(n, device=pos.device) - first
        # one sentinel row of fill slots (ncells) and one dump slot past
        # it: jax scatters over-capacity ranks out of bounds with
        # mode="drop"; torch raises on an out-of-range index, so they go
        # to the dump slot, which is sliced off (clamping them onto a
        # real slot would overwrite a kept atom)
        dump = (ncells + 1) * K
        slot = torch.where(rank < K, sbin * K + rank, dump)
        bucket = torch.full((dump + 1,), n, dtype=torch.int64,
                            device=pos.device).index_put((slot,), order)
        inv = inv3(cell) if self.pbc else None
        return bucket[:dump], b3, inv

    def safe_index(self, cand, rows_c):
        """``cand`` with each fill slot (n) pointing at its own row: the
        index for gathering per-atom values that carry a gradient.

        The JAX package gathers from an array padded with one fill row.
        Here that row would collect the (zero) adjoint of every padded
        slot, millions of duplicates at 10,000 atoms, which the card's
        sort-based ``index_put`` accumulates one after another (2.9 s
        of a force call); the row's own index spreads them over the
        atoms. Padded entries are masked either way, so every sum is
        the JAX package's."""
        return torch.where(cand < self.n, cand, rows_c[:, None])

    def gather_rows(self, pos, cell, table, rows):
        """Stage 2: candidates and distances for the atoms in ``rows``.

        ``rows`` may hold the sentinel n (chunk padding): those rows come
        back fully masked. Returns ``(cand, r2, valid)``, each
        (len(rows), 27K): candidate atom indices (fill value n), squared
        distances (minimum image under PBC; garbage where invalid) and
        the mask (not self, a real atom, r < rc). Callers overwrite
        masked distances BEFORE any sqrt or divide (the NaN-adjoint
        rule)."""
        n, K, ncells = self.n, self.capacity, self.ncells
        nb = self.nbins_t
        bucket, b3_all, inv = table

        real = rows < n
        rows_c = torch.clamp(rows, max=n - 1)
        b3 = b3_all[rows_c]                          # (m, 3)
        nb3 = b3[:, None, :] + self.offsets[None, :, :]
        if self.pbc:
            # jnp.mod takes the divisor's sign, as torch.remainder does;
            # torch.fmod would keep -1 for the offset below bin 0
            nb3 = torch.remainder(nb3, nb)
            nbid = self._binid(nb3)
        else:
            valid_bin = torch.all((nb3 >= 0) & (nb3 < nb), dim=-1)
            nb3c = torch.clamp(nb3, torch.zeros_like(nb), nb - 1)
            nbid = torch.where(valid_bin, self._binid(nb3c), ncells)

        m = rows.shape[0]
        cand = bucket[(nbid[..., None] * K
                       + torch.arange(K, device=pos.device)).reshape(
                           m, 27 * K)]
        dr = pos[self.safe_index(cand, rows_c)] - pos[rows_c][:, None, :]
        if self.pbc:
            # torch.round rounds half to even, as jnp.round does
            fr = dr @ inv
            dr = (fr - torch.round(fr)) @ cell
        r2 = torch.sum(dr * dr, dim=-1)
        valid = (cand != rows[:, None]) & (cand < n) & real[:, None] & (
            r2 < self.rc * self.rc)
        return cand, r2, valid


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


class BinnedPairPotential(RowChunked):
    """Cell-binned O(N) evaluation of a pair potential.

    Parameters
    ----------
    inner : pair potential exposing ``pair_energy(r)``
    rc : interaction cutoff; also the bin edge length.
    x0 : (3n,) initial flat positions: they fix the static grid.
    cell : (3, 3) or None: periodic cell (see :class:`CellBins`).
    capacity, margin : see :class:`CellBins`.
    shift : subtract ``pair_energy(rc)`` so the energy is continuous at
        the cutoff (default True).
    chunk : rows per chunk of the gradient and HVP (see
        :class:`RowChunked`); None evaluates the full panel.
    """

    def __init__(self, inner, rc: float, x0, cell=None,
                 capacity: Optional[int] = None, margin: float = 2.0,
                 shift: bool = True,
                 chunk: Optional[int] = None) -> None:
        super().__init__()
        if not hasattr(inner, "pair_energy"):
            raise TypeError(
                f"{type(inner).__name__} exposes no pair_energy(r); "
                "BinnedPairPotential needs a pair potential"
            )
        self.inner = inner
        self.rc = float(rc)
        self.shift = bool(shift)
        self.pbc = bool(getattr(inner, "pbc", False) or cell is not None)
        if self.pbc and cell is None:
            raise ValueError("pbc pair potential needs a cell")
        self._bins = CellBins(x0, rc, cell=cell if self.pbc else None,
                              capacity=capacity, margin=margin)
        self.n = self._bins.n
        self.chunk = chunk

    def max_occupancy(self, x) -> int:
        """Current max atoms-per-bin; see :meth:`CellBins.max_occupancy`."""
        return self._bins.max_occupancy(x)

    def _prepare(self, x, cell):
        return self._bins.bucket_table(x.reshape(self.n, 3), cell)

    def _rows_energy(self, x, cell, table, rows):
        """The half of the pair sum the atoms in ``rows`` own; sentinel
        rows contribute zero."""
        _, r2, valid = self._bins.gather_rows(x.reshape(self.n, 3), cell,
                                              table, rows)
        # the guard keeps grad and HVP finite through the padded entries
        r = torch.sqrt(torch.where(valid, r2, 1.0))
        e = self.inner.pair_energy(r)
        if self.shift:
            e = e - self.inner.pair_energy(r.new_full((), self.rc))
        return 0.5 * torch.sum(torch.where(valid, e, 0.0))
