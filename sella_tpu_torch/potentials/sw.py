"""Stillinger-Weber potential: the covalent 3-body model.

Counterpart of ``sella_tpu/potentials/sw.py``, the classic Si form

``E = sum_{i<j} f2(r_ij) + sum_{j-i-k} h(r_ij, r_ik, cos theta_jik)``

* ``f2(r) = A eps (B (sigma/r)^p - (sigma/r)^q) exp(sigma / (r - a sigma))``
* ``h = lam eps (cos theta + 1/3)^2 exp(gamma sigma/(r_ij - a sigma))
  exp(gamma sigma/(r_ik - a sigma))``

with the original Si parameters (Stillinger & Weber, PRB 31, 5262
(1985)). Both terms vanish smoothly at the cutoff ``a sigma``. Dense
all-pairs and all-triples with cutoff masks, O(n^2) + O(n^3): sized for
clusters to ~10^2 atoms. Masked radii are overwritten BEFORE the
singular ``exp(1/(r - a sigma))`` factors (the NaN-adjoint rule).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import Potential, displacements


class StillingerWeber(Potential):
    """SW potential; defaults are the original Si parameters (eV, A)."""

    def __init__(self, epsilon: float = 2.1683, sigma: float = 2.0951,
                 A: float = 7.049556277, B: float = 0.6022245584,
                 p: float = 4.0, q: float = 0.0, a: float = 1.80,
                 lam: float = 21.0, gamma: float = 1.20,
                 pbc: bool = False) -> None:
        super().__init__()
        self.epsilon = epsilon
        self.sigma = sigma
        self.A = A
        self.B = B
        self.p = p
        self.q = q
        self.a = a
        self.lam = lam
        self.gamma = gamma
        self.pbc = pbc

    def energy(self, x, cell):
        eps, sig = self.epsilon, self.sigma
        rc = self.a * sig
        n = x.shape[0] // 3

        dr = displacements(x, cell, self.pbc)      # (n, n, 3), r_j - r_i
        r2 = torch.sum(dr * dr, dim=-1)
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        pair_ok = ~eye & (r2 < rc * rc)
        # fill BEFORE sqrt/divide: masked radii sit mid-well
        r = torch.sqrt(torch.where(pair_ok, r2, sig * sig))

        # -- two-body --------------------------------------------------
        sr = sig / r
        decay = torch.exp(sig / torch.where(pair_ok, r - rc, -sig))
        f2 = self.A * eps * (self.B * sr ** self.p - sr ** self.q) * decay
        e2 = 0.5 * torch.sum(torch.where(pair_ok, f2, 0.0))

        # -- three-body: j - i - k angles around every center i --------
        g = torch.exp(
            self.gamma * sig / torch.where(pair_ok, r - rc, -sig)
        )
        g = torch.where(pair_ok, g, 0.0)
        rinv = torch.where(pair_ok, 1.0 / r, 0.0)
        u = dr * rinv[..., None]                   # unit vectors (masked)
        cosjk = torch.einsum("ijd,ikd->ijk", u, u)
        hjk = (cosjk + 1.0 / 3.0) ** 2
        w = torch.einsum("ij,ik->ijk", g, g)       # both legs in cutoff
        # exclude j == k (masked legs are already zero in w)
        w = w * (1.0 - torch.eye(n, dtype=x.dtype, device=x.device))[None]
        e3 = 0.5 * self.lam * eps * torch.sum(w * hjk)
        return e2 + e3


def si_diamond(a0: float = 5.431, reps=(1, 1, 1)):
    """Periodic diamond-Si cell (8 atoms per cube, repeated) with an
    attached :class:`StillingerWeber` calculator: test/bench helper."""
    from ..atoms import Atoms

    basis = np.array([
        [0, 0, 0], [0, 2, 2], [2, 0, 2], [2, 2, 0],
        [1, 1, 1], [1, 3, 3], [3, 1, 3], [3, 3, 1],
    ]) * (a0 / 4.0)
    nx, ny, nz = reps
    pos = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                pos.append(basis + np.array([i, j, k]) * a0)
    pos = np.concatenate(pos)
    cell = np.diag([nx * a0, ny * a0, nz * a0])
    atoms = Atoms(["Si"] * len(pos), pos, cell=cell, pbc=True)
    atoms.calc = StillingerWeber(pbc=True)
    return atoms
