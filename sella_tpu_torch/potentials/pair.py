"""Pairwise torch-native potentials: Morse, Lennard-Jones, harmonic.

Conventions match the ASE calculators (and ``sella_tpu.potentials.pair``):

* Morse: ``E = sum_{i<j} eps * (exp(-2 rho0 (r/r0 - 1)) - 2 exp(-rho0 (r/r0 - 1)))``
* Lennard-Jones: ``E = sum_{i<j} 4 eps ((sigma/r)^12 - (sigma/r)^6)``
  (optionally shifted at cutoff rc, like ASE's smooth=False mode)

The pair sums are dense all-pairs reductions over the flat position
vector, so ``torch.func`` gradients, HVPs and ``vmap`` compose directly.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import Potential, pair_distances


class MorsePotential(Potential):
    def __init__(
        self,
        epsilon: float = 1.0,
        rho0: float = 6.0,
        r0: float = 1.0,
        pbc: bool = False,
    ) -> None:
        super().__init__()
        self.epsilon = epsilon
        self.rho0 = rho0
        self.r0 = r0
        self.pbc = pbc

    def pair_energy(self, r):
        """Per-pair energy at distance r (vectorized; r = +inf -> 0)."""
        expf = torch.exp(self.rho0 * (1.0 - r / self.r0))
        return self.epsilon * (expf * expf - 2.0 * expf)

    def energy(self, x, cell):
        r = pair_distances(x, cell, self.pbc)
        # the inf diagonal is safe: exp(-inf) = 0, and the where masks it
        e = self.pair_energy(r)
        return 0.5 * torch.sum(torch.where(torch.isfinite(r), e, 0.0))


class LennardJones(Potential):
    def __init__(
        self,
        epsilon: float = 1.0,
        sigma: float = 1.0,
        rc: float | None = None,
        pbc: bool = False,
    ) -> None:
        super().__init__()
        self.epsilon = epsilon
        self.sigma = sigma
        self.rc = rc
        self.pbc = pbc

    def pair_energy(self, r):
        """Per-pair energy at distance r (vectorized; r = +inf -> 0)."""
        sr6 = (self.sigma / r) ** 6
        e = 4.0 * self.epsilon * (sr6 * sr6 - sr6)
        if self.rc is not None:
            src6 = (self.sigma / self.rc) ** 6
            e0 = 4.0 * self.epsilon * (src6 * src6 - src6)
            e = torch.where(r < self.rc, e - e0, 0.0)
        return e

    def energy(self, x, cell):
        r = pair_distances(x, cell, self.pbc)
        e = self.pair_energy(r)
        return 0.5 * torch.sum(torch.where(torch.isfinite(r), e, 0.0))


class Harmonic(Potential):
    """Quadratic potential around a reference point: for unit tests.

    ``E = 0.5 (x - x0)^T K (x - x0) + g0^T (x - x0)``; exact Hessian K.
    ``x0``, ``K`` and ``g0`` are float64 buffers."""

    def __init__(self, x0, K, g0=None) -> None:
        super().__init__()
        x0 = torch.as_tensor(np.asarray(x0, dtype=np.float64))
        self.register_buffer("x0", x0)
        self.register_buffer("K", torch.as_tensor(np.asarray(
            K, dtype=np.float64)))
        self.register_buffer("g0", torch.zeros_like(x0) if g0 is None
                             else torch.as_tensor(np.asarray(
                                 g0, dtype=np.float64)))
        self.pbc = False

    def energy(self, x, cell):
        dx = x - self.x0
        return 0.5 * dx @ self.K @ dx + self.g0 @ dx
