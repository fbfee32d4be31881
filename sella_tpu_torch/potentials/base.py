"""Potential protocol: the device/host calculator boundary.

:class:`Potential` is an ``nn.Module`` whose :meth:`~Potential.energy` is
a pure function of the flat coordinate vector ``x`` (shape ``(3n,)``) and
the ``(3, 3)`` cell. Per-species parameters are registered buffers, so
``.to(device)`` moves them with the module. Every derivative (gradient,
Hessian-vector product, Hessian) comes from ``torch.func`` transforms of
that one function, and the batched ensemble tier ``vmap``s them over
lanes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.func import grad, grad_and_value, hessian, jvp

from ..ops.linalg import inv3


class Potential(nn.Module):
    """Base class for torch-native potentials.

    Subclasses implement :meth:`energy` as a pure function of the flat
    position vector ``x`` (shape ``(3n,)``) and the ``(3, 3)`` cell."""

    #: whether minimum-image convention should be applied (set via pbc)
    pbc: bool = False

    def energy(self, x: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
        return self.energy(x, cell)

    def validate_cell(self, cell) -> None:
        """Host-side sanity check of a concrete cell. No-op by default."""

    # -- derived entry points ------------------------------------------------
    def energy_and_grad(
        self, x: torch.Tensor, cell: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        g, e = grad_and_value(self.energy)(x, cell)
        return e, g

    def grad(self, x: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
        return grad(self.energy)(x, cell)

    def hvp(self, x: torch.Tensor, v: torch.Tensor, cell: torch.Tensor):
        """Exact Hessian-vector product via forward-over-reverse."""
        return jvp(lambda y: grad(self.energy)(y, cell), (x,), (v,))[1]

    def hessian(self, x: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
        return hessian(self.energy)(x, cell)

    def energy_and_strain_grad(
        self, x: torch.Tensor, cell: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Energy and dE/d(strain), the autodiff route to the virial
        stress: an infinitesimal affine deformation ``F = I + eps`` of
        positions AND cell, differentiated at ``eps = 0``. Stress is
        ``sym(dE/deps) / volume`` (ASE convention, eV/A^3)."""
        def deformed(eps):
            F = torch.eye(3, dtype=cell.dtype, device=cell.device) + eps
            pos = x.reshape(-1, 3) @ F.T
            return self.energy(pos.reshape(-1), cell @ F.T)

        d, e = grad_and_value(deformed)(
            torch.zeros((3, 3), dtype=cell.dtype, device=cell.device))
        return e, d

    # -- host convenience (ASE-calculator-like surface) ---------------------
    def _host_device(self) -> torch.device:
        return next(iter(self.buffers()), torch.empty(0)).device

    def energy_and_forces(self, atoms) -> Tuple[float, np.ndarray]:
        dev = self._host_device()
        x = torch.as_tensor(atoms.positions.ravel(), device=dev)
        cell = torch.as_tensor(atoms.cell, device=dev)
        f, g = self.energy_and_grad(x, cell)
        return float(f), -g.detach().cpu().numpy().reshape(-1, 3)

    def energy_and_stress(self, atoms) -> Tuple[float, np.ndarray]:
        """Energy and Voigt stress [xx, yy, zz, yz, xz, xy] in eV/A^3."""
        dev = self._host_device()
        cell = np.asarray(atoms.cell, dtype=np.float64)
        vol = abs(np.linalg.det(cell))
        if vol <= 0.0:
            raise ValueError("stress requires a full-rank cell")
        x = torch.as_tensor(np.asarray(atoms.positions,
                                       dtype=np.float64).ravel(), device=dev)
        e, d = self.energy_and_strain_grad(x, torch.as_tensor(cell,
                                                              device=dev))
        d = d.detach().cpu().numpy()
        sig = 0.5 * (d + d.T) / vol
        voigt = np.array([sig[0, 0], sig[1, 1], sig[2, 2],
                          sig[1, 2], sig[0, 2], sig[0, 1]])
        return float(e), voigt


def displacements(x: torch.Tensor, cell: torch.Tensor, pbc: bool):
    """All-pairs displacement matrix with (optional) minimum-image wrap.

    Returns ``dr[i, j] = r_j - r_i`` of shape ``(n, n, 3)``. The MIC wrap
    rounds fractional displacements; exact for cells that are not too
    skewed (Niggli-reduced)."""
    pos = x.reshape(-1, 3)
    dr = pos[None, :, :] - pos[:, None, :]
    if pbc:
        inv = inv3(cell)
        frac = dr @ inv
        frac = frac - torch.round(frac)
        dr = frac @ cell
    return dr


def pair_distances(x: torch.Tensor, cell: torch.Tensor, pbc: bool):
    """Pairwise distances with a safe diagonal (set to +inf)."""
    dr = displacements(x, cell, pbc)
    r2 = torch.sum(dr * dr, dim=-1)
    n = r2.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    r2 = torch.where(eye, torch.inf, r2)
    return torch.sqrt(r2)


class ASECalculatorWrapper:
    """Host-tier calculator: wraps an ase.Atoms with an attached calculator
    (one structure at a time, on the host)."""

    def __init__(self, ase_atoms) -> None:
        self._ase_atoms = ase_atoms

    def energy_and_forces(self, atoms) -> Tuple[float, np.ndarray]:
        self._ase_atoms.positions = np.asarray(atoms.positions)
        if np.asarray(atoms.cell).any():
            self._ase_atoms.cell = np.asarray(atoms.cell)
        e = self._ase_atoms.get_potential_energy()
        f = self._ase_atoms.get_forces()
        return float(e), np.asarray(f)
