"""Torch-native TIP3P rigid-water potential.

Counterpart of ``sella_tpu/potentials/tip3p.py`` (the JAX package's
stand-in for ASE's ``ase.calculators.tip3p.TIP3P``): a pure
``energy(x, cell)`` that ``torch.func`` differentiates and ``vmap``
batches over lanes.

Model (Jorgensen et al., JCP 79, 926 (1983), matching ASE conventions):

* atoms ordered ``O H H | O H H | ...``;
* site charges ``qO = -2 qH``, ``qH = +0.417 e``;
* Lennard-Jones on O-O only: ``sigma = 3.15061 A``,
  ``epsilon = 0.1521 kcal/mol``;
* Coulomb between all *inter*-molecular site pairs,
  ``k_c = Hartree * Bohr = 14.3996 eV*A``;
* no intramolecular terms (the geometry is held rigid by constraints);
* smooth molecule-pair cutoff on the O-O distance, ``f(r) = 1`` for
  ``r < rc - width``, ``1 - x^2 (3 - 2x)`` with
  ``x = (r - rc + width) / width`` inside the taper, 0 beyond ``rc``
  (``rc=None`` disables it).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.units import Bohr, Hartree
from .base import Potential

rOH = 0.9572
angleHOH = 104.52

qH = 0.417
sigma0 = 3.15061
epsilon0 = 0.1521 * 0.04336410424180094  # kcal/mol -> eV
k_c = Hartree * Bohr  # Coulomb prefactor, eV * Angstrom


class TIP3P(Potential):
    """Rigid 3-site water potential over ``nmol`` OHH-ordered molecules
    (the flat coordinate vector holds ``9 * nmol`` entries); ``rc`` and
    ``width`` set the smooth O-O cutoff (``rc=None`` disables it)."""

    def __init__(self, nmol: int, rc: Optional[float] = 5.0,
                 width: float = 1.0) -> None:
        super().__init__()
        self.nmol = int(nmol)
        self.rc = None if rc is None else float(rc)
        self.width = float(width)
        self.pbc = False

    def _cutoff(self, r_oo):
        if self.rc is None:
            return torch.ones_like(r_oo)
        x = (r_oo - self.rc + self.width) / self.width
        xc = torch.clamp(x, 0.0, 1.0)
        return 1.0 - xc * xc * (3.0 - 2.0 * xc)

    def energy(self, x, cell):
        m = self.nmol
        pos = x.reshape(m, 3, 3)  # (mol, site, xyz)
        q = torch.tensor([-2.0 * qH, qH, qH], dtype=x.dtype, device=x.device)
        pair_mask = torch.triu(torch.ones((m, m), dtype=torch.bool,
                                          device=x.device), diagonal=1)

        d = pos[:, None, :, None, :] - pos[None, :, None, :, :]
        r2 = torch.sum(d * d, dim=-1)
        r = torch.sqrt(torch.where(pair_mask[:, :, None, None], r2, 1.0))

        coulomb = k_c * torch.sum(
            (q[None, None, :, None] * q[None, None, None, :]) / r
            * pair_mask[:, :, None, None],
            dim=(2, 3),
        )
        r_oo = r[:, :, 0, 0]
        sr6 = (sigma0 / r_oo) ** 6
        lj = 4.0 * epsilon0 * (sr6 * sr6 - sr6)
        fcut = self._cutoff(r_oo)
        return torch.sum(torch.where(pair_mask, fcut * (coulomb + lj), 0.0))


def water_cluster(nside: int = 2, a: float = 3.106162559099496,
                  seed: int = 0) -> np.ndarray:
    """Ideal-geometry waters on an ``nside^3`` cubic grid with random
    rotations — the start geometry of the reference TIP3P test
    (``tests/integration/test_tip3p_cluster.py:12-25`` of
    the upstream Sella).
    Returns positions ``(3 * nside^3, 3)`` ordered OHH per molecule.
    """
    theta = np.deg2rad(angleHOH)
    monomer = np.array(
        [
            [0.0, 0.0, 0.0],
            [rOH * np.sin(theta / 2), 0.0, rOH * np.cos(theta / 2)],
            [-rOH * np.sin(theta / 2), 0.0, rOH * np.cos(theta / 2)],
        ]
    )
    rng = np.random.RandomState(seed)
    out = []
    for i in range(nside):
        for j in range(nside):
            for k in range(nside):
                mol = monomer.copy()
                # three random axis rotations, as the reference does
                for axis in range(3):
                    ang = rng.random() * 2 * np.pi
                    c, s = np.cos(ang), np.sin(ang)
                    rot = np.eye(3)
                    u, v = [w for w in range(3) if w != axis]
                    rot[u, u] = c
                    rot[u, v] = -s
                    rot[v, u] = s
                    rot[v, v] = c
                    mol = mol @ rot.T
                mol = mol + a * np.array([i, j, k])
                out.append(mol)
    return np.concatenate(out, axis=0)
