"""Effective-medium-theory potential (fcc metals) in PyTorch.

Counterpart of ``sella_tpu/potentials/emt.py``: the Jacobsen–Stoltze–
Nørskov EMT with ASE's parameter table (Al, Cu, Ag, Au, Ni, Pd, Pt + the
"just for fun" H, C, N, O), written as a pure function of the flat
position vector so gradients, HVPs and the batched ensemble all come from
``torch.func`` transforms.

Formulation (theta is a Fermi cutoff centered at rc, ~1 out to the
third-neighbor shell):

    sigma1_i = sum_j chi_ij exp(-eta2_j (r_ij - beta s0_j)) theta(r_ij) / gamma1_i
    ds_i     = -log(sigma1_i / 12) / (beta eta2_i)
    E_c,i    = E0_i ((1 + lam_i ds_i) exp(-lam_i ds_i) - 1)
               + 6 V0_i exp(-kappa_i ds_i)
    E_pair   = -sum_{i != j} (1/2) V0_i chi_ij
               exp(-kappa_j (r_ij / beta - s0_j)) theta(r_ij) / gamma2_i

Periodic systems sum over one shell of neighbor images (27 offsets),
valid for cells with every lattice vector longer than rc (~4.8 Angstrom
for Cu) — use a 2x2x2 conventional supercell or larger.

:class:`BinnedEMT` evaluates the same physics over cell-binned candidate
lists, O(N), for large systems.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.elements import symbol_to_number
from ..utils.units import Bohr
from .base import Potential
from .binned import CellBins, RowChunked

BETA = 1.8093997906  # (16 pi / 3)^(1/3) / sqrt(2)

# symbol: E0 [eV], s0 [bohr], V0 [eV], eta2 [1/bohr], kappa [1/bohr],
#         lambda [1/bohr], n0 [1/bohr^3]   (ASE's EMT parameter table)
_PARAMS = {
    "Al": (-3.28, 3.00, 1.493, 1.240, 2.000, 1.169, 0.00700),
    "Cu": (-3.51, 2.67, 2.476, 1.652, 2.740, 1.906, 0.00910),
    "Ag": (-2.96, 3.01, 2.132, 1.652, 2.790, 1.892, 0.00547),
    "Au": (-3.80, 3.00, 2.321, 1.674, 2.873, 2.182, 0.00703),
    "Ni": (-4.44, 2.60, 3.673, 1.669, 2.757, 1.948, 0.01030),
    "Pd": (-3.90, 2.87, 2.773, 1.818, 3.107, 2.155, 0.00688),
    "Pt": (-5.85, 2.90, 4.067, 1.812, 3.145, 2.192, 0.00802),
    "H": (-3.21, 1.31, 0.132, 2.652, 2.790, 3.892, 0.00547),
    "C": (-3.50, 1.81, 0.332, 1.652, 2.790, 1.892, 0.01322),
    "N": (-5.10, 1.88, 0.132, 1.652, 2.790, 1.892, 0.01222),
    "O": (-4.60, 1.95, 0.332, 1.652, 2.790, 1.892, 0.00850),
}

_NUM_TO_PARAMS = {symbol_to_number[s]: p for s, p in _PARAMS.items()}


class EMT(Potential):
    """EMT for a fixed species list (per-atom parameter buffers)."""

    #: names of the per-atom parameter buffers, in the JAX ``_arrs`` order
    PARAM_NAMES = ("E0", "s0", "V0", "eta2", "kappa", "lam", "n0",
                   "gamma1", "gamma2")

    def __init__(self, numbers, pbc: bool = False) -> None:
        super().__init__()
        numbers = np.asarray(numbers, dtype=int)
        n = len(numbers)
        self.pbc = pbc

        E0 = np.zeros(n)
        s0 = np.zeros(n)
        V0 = np.zeros(n)
        eta2 = np.zeros(n)
        kappa = np.zeros(n)
        lam = np.zeros(n)
        n0 = np.zeros(n)
        for i, z in enumerate(numbers):
            if z not in _NUM_TO_PARAMS:
                raise ValueError(f"No EMT parameters for Z={z}")
            p = _NUM_TO_PARAMS[int(z)]
            E0[i] = p[0]
            s0[i] = p[1] * Bohr
            V0[i] = p[2]
            eta2[i] = p[3] / Bohr
            kappa[i] = p[4] / Bohr
            lam[i] = p[5] / Bohr
            n0[i] = p[6] / Bohr**3

        maxseq = s0.max()
        rc = BETA * maxseq * 0.5 * (np.sqrt(3.0) + 2.0)
        rr = rc * 2.0 * np.sqrt(3.0) / (np.sqrt(3.0) + 2.0)
        acut = np.log(9999.0) / (rc - rr)  # theta(rr) = 0.9999

        # per-atom normalizations gamma1/gamma2: fcc shell sums at the
        # reference density (shells at beta*s0*sqrt(k), k=1..3 with
        # coordination 12, 6, 24)
        gamma1 = np.zeros(n)
        gamma2 = np.zeros(n)
        for i in range(n):
            for shell, coord in enumerate((12, 6, 24)):
                r = s0[i] * BETA * np.sqrt(shell + 1.0)
                w = coord / (12.0 * (1.0 + np.exp(acut * (r - rc))))
                gamma1[i] += w * np.exp(-eta2[i] * (r - BETA * s0[i]))
                gamma2[i] += w * np.exp(-kappa[i] / BETA * (r - BETA * s0[i]))

        self.rc = float(rc)
        self.acut = float(acut)
        self.n = n
        for name, a in zip(self.PARAM_NAMES, (E0, s0, V0, eta2, kappa, lam,
                                              n0, gamma1, gamma2)):
            self.register_buffer(name, torch.from_numpy(a))
        # one shell of periodic images, in the JAX package's order
        offs = np.array(np.meshgrid(*([[-1, 0, 1]] * 3))).reshape(3, -1).T
        self.register_buffer(
            "offsets", torch.from_numpy(np.ascontiguousarray(offs, float)))
        self.register_buffer("zero_img",
                             torch.from_numpy(np.all(offs == 0, axis=1)))

    def validate_cell(self, cell) -> None:
        """The periodic path sums ONE shell of images (+-1), which is
        only exact when the cutoff fits within the cell: every
        perpendicular cell height must be >= rc (~4.8 A for Cu)."""
        if not self.pbc:
            return
        c = np.asarray(cell, dtype=float)
        vol = abs(float(np.linalg.det(c)))
        if vol <= 0.0:
            raise ValueError("EMT with pbc=True requires a full-rank cell")
        heights = [
            vol / np.linalg.norm(np.cross(c[(i + 1) % 3], c[(i + 2) % 3]))
            for i in range(3)
        ]
        if min(heights) < self.rc:
            raise ValueError(
                f"EMT one-image-shell cutoff rc={self.rc:.3f} A exceeds "
                f"the minimum cell height {min(heights):.3f} A; enlarge "
                "the cell (supercell) or the interaction sum is wrong."
            )

    def energy(self, x, cell):
        E0, s0, V0, eta2, kappa, lam, n0, gamma1, gamma2 = (
            getattr(self, k) for k in self.PARAM_NAMES
        )
        pos = x.reshape(self.n, 3)
        dr = pos[None, :, :] - pos[:, None, :]          # (n, n, 3)
        eye = torch.eye(self.n, dtype=torch.bool, device=x.device)

        if self.pbc:
            shifts = self.offsets.to(x.dtype) @ cell     # (27, 3)
            drs = dr[:, :, None, :] + shifts[None, None, :, :]
            r2 = torch.sum(drs * drs, dim=-1)            # (n, n, 27)
            self_mask = eye[:, :, None] & self.zero_img[None, None, :]
            r2 = torch.where(self_mask, torch.inf, r2)
        else:
            r2 = torch.sum(dr * dr, dim=-1)
            r2 = torch.where(eye, torch.inf, r2)
            r2 = r2[:, :, None]                          # (n, n, 1)

        # double-where guard: r2 is inf on masked self-pairs, and a naive
        # where() would still propagate NaN through the untaken branch's
        # gradient — so compute everything at a safe r and mask after
        mask = r2 < (self.rc + 1.5) ** 2
        r = torch.sqrt(torch.where(mask, r2, 1.0))
        # logistic form: every intermediate stays bounded at any
        # derivative order (a naive 1/(1+exp(z)) overflows in HVPs)
        theta = torch.sigmoid(-self.acut * (r - self.rc))
        theta = theta * mask.to(x.dtype)

        chi = (n0[None, :] / n0[:, None])[:, :, None]    # chi_ij = n0_j/n0_i

        # density contribution of j at i
        w1 = (
            chi
            * torch.exp(-eta2[None, :, None] * (r - BETA * s0[None, :, None]))
            * theta
        )
        sigma1 = torch.sum(w1, dim=(1, 2)) / gamma1      # (n,)

        # pair-potential part
        w2 = (
            chi
            * torch.exp(-kappa[None, :, None] * (r / BETA - s0[None, :, None]))
            * theta
        )
        e_pair = -0.5 * torch.sum(
            V0[:, None] * torch.sum(w2, dim=2) / gamma2[:, None]
        )

        # cohesive part
        sigma1 = torch.clamp(sigma1, min=1e-12)
        ds = -torch.log(sigma1 / 12.0) / (BETA * eta2)
        xl = lam * ds
        e_coh = torch.sum(E0 * ((1.0 + xl) * torch.exp(-xl) - 1.0))
        e_conv = torch.sum(6.0 * V0 * torch.exp(-kappa * ds))

        return e_coh + e_conv + e_pair



class BinnedEMT(RowChunked):
    """O(N) cell-binned EMT: the large-system path for the fcc metals.

    Counterpart of ``sella_tpu.potentials.emt.BinnedEMT``: the physics of
    :class:`EMT` (its parameter buffers, in the JAX ``_arrs`` order, the
    Fermi cutoff, and the hard candidate radius ``rc + 1.5`` A where
    theta ~ e^-39), evaluated over :class:`~.binned.CellBins` 27-cell
    candidate lists instead of the dense (n, n, images) panel.

    Validity: for periodic systems every cell height must be
    >= 3 (rc + 1.5) (~19.1 A for Cu), so only the nearest image of any
    neighbor is in range; :class:`~.binned.CellBins` enforces it at
    construction. Free clusters bin into a padded bounding box.

    Capacity: the HVP graph holds ``(n, 27 * capacity)`` candidate
    panels, so peak memory grows linearly with it. For relaxations in
    which atoms move far less than a bin width, ``capacity ~ 1.25x`` the
    initial occupancy (32 for close-packed Cu) is enough; overflowing
    atoms DROP out of candidate lists (wrong energies): check
    ``overflow_count`` after large moves. ``chunk`` evaluates the
    gradient and HVP ``chunk`` atom rows at a time
    (:class:`~.binned.RowChunked`).
    """

    def __init__(self, numbers, x0, cell=None, capacity=None,
                 margin: float = 2.0, chunk=None) -> None:
        super().__init__()
        self._base = EMT(numbers, pbc=cell is not None)
        self.pbc = self._base.pbc
        self.n = self._base.n
        self.rc = self._base.rc
        self.acut = self._base.acut
        # hard candidate cutoff: the dense path's mask radius
        self.rc_list = self._base.rc + 1.5
        self._bins = CellBins(x0, self.rc_list, cell=cell,
                              capacity=capacity, margin=margin)
        if self._bins.n != self.n:
            raise ValueError(
                f"x0 has {self._bins.n} atoms, numbers has {self.n}"
            )
        self.chunk = chunk

    def max_occupancy(self, x) -> int:
        return self._bins.max_occupancy(x)

    def validate_cell(self, cell) -> None:
        self._base.validate_cell(cell)

    def _prepare(self, x, cell):
        return self._bins.bucket_table(x.reshape(self.n, 3), cell)

    def _rows_energy(self, x, cell, table, rows):
        """Energy of the atoms in ``rows`` (their cohesive terms and
        their half of the pair sum); sentinel rows contribute zero."""
        E0, s0, V0, eta2, kappa, lam, n0, gamma1, gamma2 = (
            getattr(self._base, k) for k in EMT.PARAM_NAMES
        )
        n = self.n
        pos = x.reshape(n, 3)

        # padded j-parameter arrays (pad row = 1.0, fully masked)
        def pad(a):
            return torch.cat([a, a.new_ones((1,))])

        s0p, eta2p, kappap, n0p = (pad(a) for a in (s0, eta2, kappa, n0))

        cand, r2, valid = self._bins.gather_rows(pos, cell, table, rows)
        rows_c = torch.clamp(rows, max=n - 1)
        real = (rows < n).to(x.dtype)

        # the guard keeps grad and HVP finite through the padded entries
        r = torch.sqrt(torch.where(valid, r2, 1.0))
        theta = torch.sigmoid(-self.acut * (r - self.rc))
        theta = theta * valid.to(x.dtype)

        s0j, eta2j, kappaj, n0j = (a[cand] for a in (s0p, eta2p, kappap,
                                                       n0p))
        chi = n0j / n0[rows_c][:, None]          # chi_ij = n0_j / n0_i

        w1 = chi * torch.exp(-eta2j * (r - BETA * s0j)) * theta
        sigma1 = torch.sum(w1, dim=1) / gamma1[rows_c]

        w2 = chi * torch.exp(-kappaj * (r / BETA - s0j)) * theta
        e_pair = -0.5 * torch.sum(
            real * V0[rows_c] * torch.sum(w2, dim=1) / gamma2[rows_c]
        )

        sigma1 = torch.clamp(sigma1, min=1e-12)
        ds = -torch.log(sigma1 / 12.0) / (BETA * eta2[rows_c])
        xl = lam[rows_c] * ds
        e_coh = torch.sum(
            real * E0[rows_c] * ((1.0 + xl) * torch.exp(-xl) - 1.0)
        )
        e_conv = torch.sum(
            real * 6.0 * V0[rows_c] * torch.exp(-kappa[rows_c] * ds)
        )
        return e_coh + e_conv + e_pair


def fcc_bulk(symbol: str, a: float, reps=(2, 2, 2)):
    """Conventional fcc supercell (4 atoms/cell) — test/bench helper."""
    from ..atoms import Atoms

    base = np.array(
        [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]
    )
    nx, ny, nz = reps
    pos = []
    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                pos.extend((base + np.array([ix, iy, iz])) * a)
    pos = np.array(pos)
    cell = np.diag([a * nx, a * ny, a * nz])
    atoms = Atoms([symbol] * len(pos), pos, cell=cell, pbc=True)
    atoms.calc = EMT(atoms.numbers, pbc=True)
    return atoms


def fcc111_slab(symbol: str, a: float, size=(4, 4, 3), vacuum: float = 10.0):
    """fcc(111) slab — test/bench helper (orthogonal cell).

    ``ny`` must be even: the alternating row offset of the triangular
    lattice only closes periodically over an even number of rows.
    """
    from ..atoms import Atoms

    nx, ny, nz = size
    if ny % 2 != 0:
        raise ValueError("fcc111_slab requires even ny for periodicity")
    d = a / np.sqrt(2.0)                     # nn distance
    ax = d
    ay = d * np.sqrt(3.0) / 2.0
    dz = a / np.sqrt(3.0)
    pos = []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                sx = (iz % 3) * d / 2.0 + (iy % 2) * d / 2.0
                sy = (iz % 3) * d / (2.0 * np.sqrt(3.0))
                pos.append([ix * ax + sx, iy * ay + sy, iz * dz])
    pos = np.array(pos)
    cell = np.diag([nx * ax, ny * ay, nz * dz + vacuum])
    pos[:, 2] += vacuum / 2.0
    atoms = Atoms([symbol] * len(pos), pos, cell=cell, pbc=True)
    atoms.calc = EMT(atoms.numbers, pbc=True)
    return atoms


def fcc111_primitive(symbol: str, a: float, size=(5, 5, 6),
                     vacuum: float = 10.0):
    """fcc(111) slab on the primitive (rhombic) surface cell — any
    ``(nx, ny, nz)``, including the odd sizes the orthogonal constructor
    (:func:`fcc111_slab`) cannot close periodically.

    In-plane lattice vectors ``a1 = d (1, 0)``,
    ``a2 = d (1/2, sqrt(3)/2)`` with ``d = a/sqrt(2)`` the nn
    distance; ABC stacking shifts each layer by ``(a1 + a2)/3`` and
    ``dz = a/sqrt(3)``."""
    from ..atoms import Atoms

    nx, ny, nz = size
    d = a / np.sqrt(2.0)
    a1 = np.array([d, 0.0, 0.0])
    a2 = np.array([d / 2.0, d * np.sqrt(3.0) / 2.0, 0.0])
    dz = a / np.sqrt(3.0)
    pos = []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                f = iz / 3.0
                pos.append((ix + f) * a1 + (iy + f) * a2
                           + np.array([0.0, 0.0, iz * dz]))
    pos = np.array(pos)
    cell = np.array([nx * a1, ny * a2,
                     [0.0, 0.0, nz * dz + vacuum]])
    pos[:, 2] += vacuum / 2.0
    atoms = Atoms([symbol] * len(pos), pos, cell=cell, pbc=True)
    atoms.calc = EMT(atoms.numbers, pbc=True)
    return atoms
