"""Batched small-matrix linear algebra for the ensemble tier.

Counterpart of ``sella_tpu/ops/linalg.py`` for the functions the batched
Cartesian ensemble reaches: the eigh chokepoint :func:`batched_eigh`,
the plain parallel-order Jacobi :func:`jacobi_eigh` (the reference the
CUDA kernel in ``sella_tpu_torch/csrc/jacobi_eigh.cu`` is held against),
two small helpers, and the matrix exponential and logarithm that the
atom+cell tier's cell chart differentiates through.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _interleave_perm(n: int):
    """Static permutation machinery for the adjacent-pair parallel
    Jacobi: with the basis kept in the round-robin "tournament"
    interleaved layout, every round rotates pairs (0,1), (2,3), ... and
    then re-pairs by applying ONE fixed permutation. Returns
    (idx0, perm): ``idx0`` maps original -> initial interleaved layout,
    ``perm`` is the between-rounds relabeling. Host-side, static."""

    def interleaved(players):
        half = len(players) // 2
        top = players[:half]
        bot = players[:half - 1:-1]          # reversed back half
        out = []
        for a, b in zip(top, bot):
            out += [a, b]
        return out

    players = list(range(n))
    L0 = interleaved(players)
    rotated = [players[0], players[-1]] + players[1:-1]
    L1 = interleaved(rotated)
    pos = {pl: i for i, pl in enumerate(L0)}
    perm = np.asarray([pos[pl] for pl in L1], np.int64)
    return np.asarray(L0, np.int64), perm


def jacobi_eigh(A: torch.Tensor, sweeps: int = 8):
    """Batched symmetric eigh via parallel-order cyclic Jacobi with an
    interleaved pair layout, in plain tensor operations.

    A literal port of ``sella_tpu.ops.linalg.jacobi_eigh``: the matrix is
    kept in the round-robin tournament ordering so the n/2 simultaneous
    Givens rotations act on adjacent index pairs, and moving to the next
    round's pairing is one static-index permutation. Fixed ``sweeps``
    (8 reach the float32 off-diagonal floor for n <= 128). Computes in
    float32 and returns eigenvalues ascending with matching eigenvector
    columns, in A's dtype."""
    dt = A.dtype
    n = A.shape[-1]
    if n % 2:
        # pad with one decoupled huge diagonal entry; it stays an exact
        # eigenpair, sorts last (ascending), and is sliced off below
        pad = A.new_zeros(A.shape[:-2] + (n + 1, n + 1))
        pad[..., :n, :n] = A
        pad[..., n, n] = 1e30
        lams, V = jacobi_eigh(pad, sweeps)
        return lams[..., :n], V[..., :n, :n]
    idx0_np, perm_np = _interleave_perm(n)
    idx0 = torch.as_tensor(idx0_np, device=A.device)
    perm = torch.as_tensor(perm_np, device=A.device)
    half = n // 2
    batch = A.shape[:-2]
    Af = A.to(torch.float32)
    # rebase into the interleaved tournament layout
    Af = Af.index_select(-2, idx0).index_select(-1, idx0)
    eye = torch.eye(n, dtype=torch.float32, device=A.device)
    V = eye[idx0].T.expand(batch + (n, n))

    for _ in range(sweeps * (n - 1)):
        diag = torch.diagonal(Af, dim1=-2, dim2=-1)
        app = diag[..., 0::2]                    # (..., n/2)
        aqq = diag[..., 1::2]
        apq = torch.diagonal(Af, offset=1, dim1=-2, dim2=-1)[..., 0::2]
        # classical Jacobi angle: tan(2t) = 2 a_pq / (a_qq - a_pp)
        tau = (aqq - app) / torch.where(apq == 0, 1.0, 2.0 * apq)
        t = torch.where(
            tau == 0,
            1.0,  # a_pp == a_qq with a_pq != 0: rotate 45 degrees
            torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau)),
        )
        t = torch.where(apq == 0, 0.0, t)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        # left rotation on row pairs
        Ar = Af.reshape(batch + (half, 2, n))
        r0, r1 = Ar[..., 0, :], Ar[..., 1, :]
        Af = torch.stack(
            [c[..., None] * r0 - s[..., None] * r1,
             s[..., None] * r0 + c[..., None] * r1], dim=-2
        ).reshape(batch + (n, n))
        # right rotation on column pairs
        Ac = Af.reshape(batch + (n, half, 2))
        c0, c1 = Ac[..., 0], Ac[..., 1]
        Af = torch.stack(
            [c[..., None, :] * c0 - s[..., None, :] * c1,
             s[..., None, :] * c0 + c[..., None, :] * c1], dim=-1
        ).reshape(batch + (n, n))
        # eigenvector columns follow the right rotation
        Vc = V.reshape(batch + (n, half, 2))
        v0, v1 = Vc[..., 0], Vc[..., 1]
        V = torch.stack(
            [c[..., None, :] * v0 - s[..., None, :] * v1,
             s[..., None, :] * v0 + c[..., None, :] * v1], dim=-1
        ).reshape(batch + (n, n))
        # advance to the next round-robin pairing (static relabel)
        Af = Af.index_select(-2, perm).index_select(-1, perm)
        V = V.index_select(-1, perm)

    lams = torch.diagonal(Af, dim1=-2, dim2=-1)
    order = torch.argsort(lams, dim=-1, stable=True)
    lams = torch.take_along_dim(lams, order, dim=-1)
    V = torch.take_along_dim(V, order[..., None, :], dim=-1)
    return lams.to(dt), V.to(dt)


def batched_eigh(A: torch.Tensor, mode: Optional[str] = None):
    """Single chokepoint for every batched symmetric eigh in the
    ensemble tiers. ``mode``: ``f64`` (native, the default), ``f32``
    (factor in float32, cast back — the opt-in ``eigh_f32`` fast path) or
    ``robust``.

    ``robust`` is the mode of the internal tier's Gram matrices, which
    hold an exactly degenerate zero cluster. In the JAX package it means
    native float64 on the CPU and a float32-refined eigh on the TPU,
    whose float64 eigh is emulated and returns NaN on such clusters. On
    the CPU and on Hopper float64 is native (LAPACK, cuSOLVER), so here
    it is float64 ``torch.linalg.eigh`` on every device, held on both to
    the degenerate-cluster gates of the JAX package's refined eigh
    (``tests/test_torch_coords.py`` on the CPU, ``chip_smoke.py`` phase
    12b on the card). The JAX package's ``refined`` mode is not ported
    and raises."""
    if mode is None:
        mode = "f64"
    if mode == "refined":
        raise NotImplementedError(
            "batched_eigh mode 'refined' (the TPU's float32-refined eigh) "
            "is not ported to sella_tpu_torch; 'robust' is float64 eigh "
            "(ROADMAP.md, Not to port)"
        )
    if mode not in ("f64", "f32", "robust"):
        raise ValueError(f"unknown batched_eigh mode {mode!r}")
    if mode == "robust":
        return torch.linalg.eigh(A.to(torch.float64))
    if mode == "f64" or A.dtype != torch.float64:
        return torch.linalg.eigh(A)
    lams, V = torch.linalg.eigh(A.to(torch.float32))
    return lams.to(A.dtype), V.to(A.dtype)


def sym(M: torch.Tensor) -> torch.Tensor:
    """Symmetrize (roundoff cleanup), as in ``hessian_update.py:104-109``."""
    return 0.5 * (M + M.transpose(-1, -2))


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / determinant); differentiable
    and cheaper than a general inverse for the 3x3 cells used here."""
    r0, r1, r2 = A[0], A[1], A[2]
    c0 = torch.linalg.cross(r1, r2)
    c1 = torch.linalg.cross(r2, r0)
    c2 = torch.linalg.cross(r0, r1)
    det = torch.dot(r0, c0)
    return torch.stack([c0, c1, c2], dim=1) / det


# ---------------------------------------------------------------------------
# Matrix exponential / logarithm (cell parameterization substrate)
# ---------------------------------------------------------------------------
def expm(A: torch.Tensor, order: int = 12, squarings: int = 8) -> torch.Tensor:
    """Differentiable matrix exponential: scaling and squaring + Taylor.

    A literal port of ``sella_tpu.ops.linalg.expm``: fixed counts (Taylor
    order 12, 8 squarings; ~1e-15 accurate for ``||A|| <~ 10``) in plain
    tensor operations, so ``torch.func`` forward-over-reverse through it
    is matmuls only, under ``vmap`` too, and the arithmetic is the JAX
    package's."""
    n = A.shape[-1]
    X = A * 2.0 ** (-squarings)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    term = eye
    out = eye
    for k in range(1, order + 1):
        term = term @ X / k
        out = out + term
    for _ in range(squarings):
        out = out @ out
    return out


def expm_frechet(A: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """Directional (Fréchet) derivative of :func:`expm` at A along E."""
    from torch.func import jvp

    return jvp(expm, (A,), (E,))[1]


def logm_host(F: np.ndarray) -> np.ndarray:
    """Real matrix logarithm of a well-conditioned 3x3 (numpy, host).

    The eigendecomposition closed form with a scipy fallback for
    defective inputs, as ``sella_tpu.ops.linalg.logm_host``."""
    import scipy.linalg as sla

    F = np.asarray(F, dtype=np.float64)
    lam, V = np.linalg.eig(F)
    if np.linalg.cond(V) > 1e10:
        return np.real(sla.logm(F))
    return np.real(V @ np.diag(np.log(lam)) @ np.linalg.inv(V))


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of a 3x3 by the triple product; differentiable to any
    order under ``torch.func`` (``torch.linalg.det`` is LU-based)."""
    return torch.dot(A[0], torch.linalg.cross(A[1], A[2]))
