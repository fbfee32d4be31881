"""Minimal invariant message-passing ML potential (MACE-style contract).

Counterpart of ``sella_tpu/potentials/mlff.py``: a graph network over
cell-binned neighbor lists whose energy is a smooth pure function of
positions and cell, so forces and exact Lanczos HVPs come from
``torch.func`` and stay O(N) through :class:`~.binned.CellBins`:

* species embedding, then T rounds of edge-gated message passing with
  radial-basis edge features under a C^1 cosine cutoff envelope, then a
  per-atom energy readout (summed);
* rotation and translation invariant by construction (edges enter
  through interatomic distances only);
* weights: a seeded random init, or a trained set via ``params=``. The
  committed EMT-distilled Cu weights (``weights/mlff_cu_emt.npz``, a
  byte-for-byte copy of the JAX package's file, path
  :data:`WEIGHTS_CU_EMT`) load with :meth:`MLPotential.params_from_npz`.

The weights are float64 buffers named as in the ``.npz`` (``embed``,
``readout_w``, ``readout_b``, ``L{t}_edge_w`` ...), so ``.to()``,
``state_dict`` and :class:`~.mixed.F32Potential`'s float32 copy reach
them. The committed file stores float32; the port widens it to float64
on construction, exactly. The JAX package keeps the float32 arrays, and
its promotion then computes the first layer's gate and message products
(float32 embedding times float32 weights) in float32 inside an otherwise
float64 energy, ~1e-6 relative. Here float64 is float64 throughout and
``F32Potential`` is float32 throughout; the two packages agree to
rounding given the same float64 weights.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .base import Potential
from .binned import CellBins

#: the committed EMT-distilled Cu weights (copied from the JAX package)
WEIGHTS_CU_EMT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "weights", "mlff_cu_emt.npz")

_LAYER_KEYS = ("edge_w", "edge_b", "msg_w", "upd_w", "upd_b", "gate_w")


def flatten_params(params) -> dict:
    """The ``.npz`` naming of a weight set: a flat dict passes through;
    the JAX package's pytree (``{"embed", "readout_w", "readout_b",
    "layers": [{...}, ...]}``) is flattened to ``L{t}_{key}``."""
    if "layers" not in params:
        return dict(params)
    flat = {k: params[k] for k in ("embed", "readout_w", "readout_b")}
    for t, lay in enumerate(params["layers"]):
        for k, v in lay.items():
            flat[f"L{t}_{k}"] = v
    return flat


def _init_params(seed: int, nspecies: int, nrbf: int, dim: int,
                 nlayers: int) -> dict:
    """Seeded small-weight init (the JAX package's scales; its draws come
    from ``jax.random`` and cannot be reproduced here)."""
    gen = torch.Generator().manual_seed(int(seed))
    dt = torch.float64

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=dt)

    scale = 0.5
    p = {"embed": scale * normal(nspecies, dim),
         "readout_w": scale * normal(dim, 1),
         "readout_b": torch.zeros(1, dtype=dt)}
    for t in range(nlayers):
        p[f"L{t}_edge_w"] = scale * normal(nrbf, dim)
        p[f"L{t}_edge_b"] = torch.zeros(dim, dtype=dt)
        p[f"L{t}_msg_w"] = scale * normal(dim, dim) / np.sqrt(dim)
        p[f"L{t}_upd_w"] = scale * normal(dim, dim) / np.sqrt(dim)
        p[f"L{t}_upd_b"] = torch.zeros(dim, dtype=dt)
        p[f"L{t}_gate_w"] = scale * normal(dim, dim) / np.sqrt(dim)
    return p


class MLPotential(Potential):
    """Message-passing potential over cell-binned neighbor lists.

    Parameters
    ----------
    numbers : (n,) atomic numbers (embedding rows are the distinct
        species in sorted order).
    x0 : (3n,) initial positions: they fix the static neighbor grid.
    cell : (3, 3) or None.
    rc : graph cutoff (default 5.0 A), also the bin edge.
    nrbf, dim, nlayers : network widths (used by the random init).
    params : trained weights, flat (``.npz`` naming) or the JAX pytree,
        as numpy arrays or tensors (widened to float64); default: seeded
        random weights.
    seed : weight seed when ``params`` is None.
    capacity, margin : see :class:`~.binned.CellBins`.

    Message passing couples neighbors, so there is no row chunking: a
    chunk would truncate the receptive field. The JAX package
    rematerializes each layer (``jax.checkpoint``) to fit a 16 GB chip;
    here the layers are evaluated without rematerialization.
    """

    def __init__(self, numbers, x0, cell=None, rc: float = 5.0,
                 nrbf: int = 8, dim: int = 16, nlayers: int = 2,
                 params=None, seed: int = 0,
                 capacity: Optional[int] = None,
                 margin: float = 2.0) -> None:
        super().__init__()
        numbers = np.asarray(numbers, dtype=int)
        self.n = len(numbers)
        self.pbc = cell is not None
        self.rc = float(rc)
        species = sorted(set(int(z) for z in numbers))
        self.register_buffer("spec", torch.as_tensor(
            [species.index(int(z)) for z in numbers], dtype=torch.int64))
        self.nrbf = int(nrbf)
        self.dim = int(dim)
        # Gaussian radial bases spanning (0, rc]
        self.register_buffer("centers", torch.from_numpy(
            np.linspace(0.5, rc, nrbf)))
        self._gamma = float((nrbf / rc) ** 2)
        if params is None:
            params = _init_params(seed, len(species), nrbf, dim, nlayers)
        flat = flatten_params(params)
        self.nlayers = 0
        while f"L{self.nlayers}_edge_w" in flat:
            self.nlayers += 1
        self._names = ["embed", "readout_w", "readout_b"] + [
            f"L{t}_{k}" for t in range(self.nlayers) for k in _LAYER_KEYS]
        for k in self._names:
            v = flat[k]
            v = v.detach() if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v))
            self.register_buffer(k, v.to(device="cpu", dtype=torch.float64,
                                         copy=True))
        self._bins = CellBins(x0, rc, cell=cell, capacity=capacity,
                              margin=margin)
        if self._bins.n != self.n:
            raise ValueError(
                f"x0 has {self._bins.n} atoms, numbers has {self.n}"
            )

    def max_occupancy(self, x) -> int:
        return self._bins.max_occupancy(x)

    @property
    def params(self) -> dict:
        """The weights as the JAX package's pytree (the buffers)."""
        return {"embed": self.embed, "readout_w": self.readout_w,
                "readout_b": self.readout_b,
                "layers": [{k: getattr(self, f"L{t}_{k}")
                            for k in _LAYER_KEYS}
                           for t in range(self.nlayers)]}

    def save_params(self, path: str) -> None:
        """Write the weights to one ``.npz`` in the JAX package's naming."""
        np.savez(path, **{k: getattr(self, k).detach().cpu().numpy()
                          for k in self._names})

    @staticmethod
    def params_from_npz(path: str) -> dict:
        """The flat weight dict of a :meth:`save_params` file (numpy)."""
        with np.load(path) as data:
            return {k: data[k] for k in data.files}

    def energy(self, x, cell):
        return self.energy_with_params(self.params, x, cell)

    def energy_with_params(self, p, x, cell):
        """Pure function of (weights pytree, positions, cell)."""
        n = self.n
        pos = x.reshape(n, 3)
        table = self._bins.bucket_table(pos, cell)
        rows = torch.arange(n, device=x.device)
        cand, r2, valid = self._bins.gather_rows(pos, cell, table,
                                                 rows)     # (n, 27K)
        # padded slots read their own row's features (masked by env;
        # see CellBins.safe_index)
        safe = self._bins.safe_index(cand, rows)
        mask = valid.to(x.dtype)
        # the guard keeps grad and HVP finite through the padded entries
        r = torch.sqrt(torch.where(valid, r2, 1.0))

        # C^1 cosine envelope, 0 exactly at rc where the hard mask also
        # flips; it multiplies the edge features AFTER the edge MLP so its
        # bias cannot leak through masked pairs
        env = 0.5 * (1.0 + torch.cos(torch.pi * torch.clamp(r / self.rc,
                                                            max=1.0)))
        env = env * mask

        h = p["embed"][self.spec]                      # (n, dim)
        for lay in p["layers"]:
            rbf = torch.exp(
                -self._gamma * (r[..., None] - self.centers) ** 2
            )                                          # (n, 27K, nrbf)
            edge = torch.tanh(rbf @ lay["edge_w"] + lay["edge_b"])
            edge = edge * env[..., None]
            hj = h[safe]                               # (n, 27K, dim)
            gate = torch.sigmoid(hj @ lay["gate_w"])
            msg = torch.sum(edge * gate * (hj @ lay["msg_w"]), dim=1)
            h = h + torch.tanh(msg @ lay["upd_w"] + lay["upd_b"])

        e_atom = (h @ p["readout_w"]).reshape(-1) + p["readout_b"]
        return torch.sum(e_atom)
