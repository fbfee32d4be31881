"""Batched ensemble saddle search in PyTorch — the Cartesian tier.

Counterpart of ``sella_tpu/parallel/ensemble.py``: many concurrent
RS-P-RFO saddle searches advance in lockstep, every dense operation is a
batched (B, ., .) eigh/QR/matmul, and every force call is a batched
potential evaluation (``torch.func.vmap`` over lanes).

The JAX package's structured control flow becomes host control flow:

* ``lax.fori_loop`` becomes a Python ``for`` with the same fixed count
  (the restricted step's root-find stops once every lane is done, which
  changes no result);
* ``lax.cond(jnp.any(mask), ...)`` becomes ``if bool(mask.any()):`` (the
  scheduled Davidson, the restart re-evaluation and the curvature audit;
  each is one host sync);
* the Davidson ``lax.while_loop`` keeps its check every ``CHUNK = 4``
  iterations (the iteration count feeds the random draw and ``it < K-1``
  bounds the loop, so the cadence is part of the semantics).

Randomness comes from an explicit ``torch.Generator``; trajectories match
the JAX package only where the Davidson dead-vector draw and the restart
kick do not fire (or the kick is zero).

Also here: equality and inequality constraints (``make_step_fn(
constraints=, comparators=)``), the stagnation/dissociation restarts and
the ``conv_inertia`` gate, and the work queue (``refill_converged``,
``refresh_fg``, ``make_queue_fns``, ``run_ensemble_queue``) with
checkpoint/resume through :mod:`.checkpoint`. Not ported: sharding over a
mesh (``mesh=`` raises).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, grad_and_value, jacfwd, jvp, vmap

from ..config import default_dtype
from ..ops.jacobi_eigh import jacobi_eigh
from ..ops.linalg import batched_eigh

BIG = 1e30
# stiff positive curvature assigned to constrained-out directions in the
# inequality (projector) path: far above any physical eigenvalue, far
# below overflow in the alpha root-find denominators
_CONS_SHIFT = 1e6


class EnsembleConfig(NamedTuple):
    """Static configuration of a batched search (field names, defaults and
    meanings as in ``sella_tpu.parallel.ensemble.EnsembleConfig``)."""

    natoms: int
    order: int = 1                 # saddle order (0 = minimization)
    nproj: int = 6                 # projected rigid modes (3 trans + 3 rot)
    fmax: float = 1e-3
    gamma: float = 0.1             # Davidson relative residual target
    delta0: float = 0.1
    delta_min: float = 1e-4
    sigma_inc: float = 1.15
    sigma_dec: float = 0.65
    rho_inc: float = 1.035
    rho_dec: float = 5.0
    nsteps_per_diag: int = 3
    diag_every_n: int = 0          # 0 -> never (reference default: inf)
    davidson_max: int = 0          # 0 -> 2*m+1 capped at m
    rs_maxiter: int = 18           # alpha root-find iterations (exact count)
    rs_tol: float = 1e-8
    method: str = "prfo"           # 'prfo' | 'qn'
    rs: str = "ras"                # 'ras' | 'tr'
    eig: bool = True               # run Davidson (saddle default)
    ncons: int = 0                 # number of equality-constraint rows
    ctol: float = 1e-4             # constraint-residual convergence tol
    diag_budget: int = 0           # max lanes re-diagonalized per step
    #   (0 = all); unserved lanes keep their request and are served
    #   longest-waiting-first
    restart_after: int = 0         # stagnation restart (0 = off): a lane
    #   whose best fmax has not improved for this many steps restarts from
    #   x_home plus a random kick, with B reset to the identity
    restart_kick: float = 0.25     # kick stddev per DOF (grows with the
    #   lane's restart count, capped at 3x)
    dmax_restart: float = 0.0      # 0 = off; else restart a lane from home
    #   at once when its max pair distance exceeds this (dissociation)
    prfo_eigh: str = "eigh"        # P-RFO prep eigendecomposition:
    #   "eigh" (torch.linalg.eigh, honors eigh_f32) or "jacobi" (the
    #   batched parallel-order Jacobi: the CUDA kernel on the card, its
    #   plain version on the CPU; float32 accuracy class)
    davidson_seed: str = "grad"    # Davidson start vector: "grad"
    #   (projected gradient) or "pmode" (leftmost eigenvector of the
    #   projected quasi-Newton preconditioner for warm-Hessian lanes)
    absb: str = "eigh"             # |B| metric in TS-BFGS: "eigh" (exact)
    #   or "ns" (Newton–Schulz matrix-sign, batched float32 matmuls)
    conv_inertia: bool = False     # gate convergence on the P-RFO prep
    #   inertia matching ``order``; for order > 0 an exact-HVP audit along
    #   the leftmost prep mode checks each newly converged lane, and a
    #   rejected lane restarts at once (even with restart_after = 0)
    conv_curv_min: float = 1e-3    # curvature floor of the conv_inertia audit
    update: str = "TS-BFGS"        # "TS-BFGS", "BFGS" or "BFGS_auto"
    eval_chunk: int = 0            # lanes per potential-eval chunk (0 = all);
    #   bounds peak memory of the vmapped potential intermediates
    eigh_f32: bool = False         # P-RFO prep eigh and |B| eigh in float32
    pred_min: float = 1e-14        # smallest |predicted dE| the trust
    #   ratio test trusts; below it ratio := 1

    @property
    def dim(self) -> int:
        return 3 * self.natoms

    @property
    def nfree(self) -> int:
        return self.dim - self.nproj - self.ncons

    @property
    def subspace_max(self) -> int:
        m = self.nfree
        k = self.davidson_max if self.davidson_max > 0 else 2 * m + 1
        return min(m, k)


class SearchState(NamedTuple):
    """Per-search optimizer state; every field but ``fmax_t`` has a
    leading batch axis."""

    x: torch.Tensor            # (B, d) flat positions
    f: torch.Tensor            # (B,) energy
    g: torch.Tensor            # (B, d) gradient
    B: torch.Tensor            # (B, d, d) quasi-Newton Hessian
    B_init: torch.Tensor       # (B,) bool — Hessian bootstrapped?
    delta: torch.Tensor        # (B,) trust radius
    rho: torch.Tensor          # (B,) last prediction ratio
    nsteps_since_diag: torch.Tensor  # (B,) int32
    converged: torch.Tensor    # (B,) bool
    nsteps: torch.Tensor       # (B,) int32
    neval: torch.Tensor        # (B,) int32 gradient evaluations
    nmatvec: torch.Tensor      # (B,) int32 Davidson matvecs (HVPs)
    best_fmax: torch.Tensor    # (B,) best fmax since the last restart
    stall: torch.Tensor        # (B,) int32 steps since best_fmax improved
    nrestarts: torch.Tensor    # (B,) int32 stagnation restarts taken
    x_home: torch.Tensor       # (B, d) pristine start (restart anchor)
    fmax_t: torch.Tensor       # () runtime convergence gate


def _bmv(M, v):
    """Batched matrix-vector product: (B, i, j) @ (B, j) -> (B, i)."""
    return torch.matmul(M, v[..., None])[..., 0]


def _bmtv(M, v):
    """Batched transposed product: (B, i, j)^T @ (B, i) -> (B, j)."""
    return torch.matmul(v[..., None, :], M)[..., 0, :]


# ---------------------------------------------------------------------------
# Rigid-mode projection basis
# ---------------------------------------------------------------------------
def free_basis(x: torch.Tensor, nproj: int) -> torch.Tensor:
    """Orthonormal basis of the non-rigid subspace for every lane,
    shape (B, d, d - nproj), for flat positions ``x`` (B, d).

    Rows projected out by ``nproj``: 0 = nothing (identity basis);
    3 = the uniform translations; 5 = translations + the two rotations of
    a LINEAR geometry (top-2 singular directions of the rotation
    generators); 6 = translations + the 3 instantaneous rigid rotations
    about the centroid. A complete QR of the generators gives the
    complement. Only the span is defined: the columns' signs depend on
    the QR implementation."""
    Bsz, d = x.shape
    dtype, dev = x.dtype, x.device
    if nproj == 0:
        return torch.eye(d, dtype=dtype, device=dev).expand(Bsz, d, d)
    if nproj not in (3, 5, 6):
        raise ValueError(
            f"nproj={nproj} unsupported: 0 (nothing), 3 (translations), "
            "5 (linear: translations + 2 rotations), or 6 "
            "(translations + rotations)"
        )
    trans = _translations(d, dtype, dev)               # (d, 3)
    if nproj == 3:
        # the generators do not depend on x: one QR serves every lane
        Q, _ = torch.linalg.qr(trans, mode="complete")
        return Q[:, 3:].expand(Bsz, d, d - 3)
    gens = _rotations(x)                               # (B, d, 3)
    if nproj == 5:
        U, _, _ = torch.linalg.svd(gens, full_matrices=False)
        gens = U[:, :, :2]
    A = torch.cat([trans.expand(Bsz, d, 3), gens], dim=2)
    Q, _ = torch.linalg.qr(A, mode="complete")
    return Q[:, :, nproj:]


def _translations(d: int, dtype, dev) -> torch.Tensor:
    """(d, 3) orthonormal uniform translations."""
    n = d // 3
    trans = torch.zeros((3, n, 3), dtype=dtype, device=dev)
    for ax in range(3):
        trans[ax, :, ax] = 1.0 / np.sqrt(n)
    return trans.reshape(3, d).T


def _rotations(x: torch.Tensor) -> torch.Tensor:
    """(B, d, 3) instantaneous rigid rotations about each lane's
    centroid."""
    Bsz, d = x.shape
    pos = x.reshape(Bsz, d // 3, 3)
    rel = pos - pos.mean(dim=1, keepdim=True)
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    return torch.stack(
        [torch.linalg.cross(eye3[ax].expand_as(rel), rel).reshape(Bsz, d)
         for ax in range(3)], dim=2,
    )


def constrained_free_basis(x: torch.Tensor, nproj: int,
                           cons_jac_fn) -> torch.Tensor:
    """Free basis with equality constraints for every lane: the orthogonal
    complement of span(rigid generators) + span(J(x)^T), shape
    (B, d, d - ncols) for flat positions ``x`` (B, d).

    ``cons_jac_fn`` maps one lane's (d,) positions to its (m, d)
    constraint Jacobian. As in the JAX package, ``nproj > 0`` contributes
    the three translations, plus the three rotations when ``nproj == 6``;
    the constraint rows must stay independent of them (pick ``nproj``
    accordingly), so one complete QR suffices."""
    Bsz, d = x.shape
    J = vmap(cons_jac_fn)(x)                           # (B, m, d)
    cols = []
    if nproj > 0:
        cols.append(_translations(d, x.dtype, x.device).expand(Bsz, d, 3))
        if nproj == 6:
            cols.append(_rotations(x))
    A = torch.cat(cols + [J.transpose(1, 2)], dim=2)
    Q, _ = torch.linalg.qr(A, mode="complete")
    return Q[:, :, A.shape[2]:]


# ---------------------------------------------------------------------------
# Batched masked Davidson (exact-HVP matvecs)
# ---------------------------------------------------------------------------
def _masked_ritz(V, AV, k, K):
    """Galerkin eigenproblem on the masked subspace.

    Padded columns are exactly zero, so ``V^T AV`` is block structured;
    a per-lane shift that dominates the physical spectrum on the padded
    diagonal pushes phantom Ritz values to the top, keeping the leftmost
    (physical) pairs in the first k slots after the ascending eigh."""
    Atilde = torch.einsum("bik,bil->bkl", V, AV)
    Atilde = 0.5 * (Atilde + Atilde.transpose(-1, -2))
    colmask = torch.arange(K, device=V.device)[None, :] < k[:, None]
    pad_val = 10.0 * K * torch.amax(
        torch.abs(Atilde), dim=(-2, -1), keepdim=True
    ) + 1.0
    pad = torch.where(colmask[:, None, :], 0.0, pad_val)
    Atilde = Atilde + torch.eye(K, dtype=V.dtype, device=V.device)[None] * pad
    lams, W = batched_eigh(Atilde)
    return lams, W, colmask


# ---------------------------------------------------------------------------
# Batched TS-BFGS update (multi-secant, masked columns)
# ---------------------------------------------------------------------------
def _eig_inverse(lams, rcond):
    """Reciprocal eigenvalues with the rank cut ``|lam| > rcond max|lam|``
    (zeros for the cut ones)."""
    amax = torch.amax(torch.abs(lams), dim=-1, keepdim=True)
    keep = torch.abs(lams) > rcond * torch.clamp(amax, min=1e-300)
    return torch.where(keep, 1.0 / torch.where(keep, lams, 1.0), 0.0)


def sym_solve(A: torch.Tensor, b: torch.Tensor, rcond: float = 1e-14):
    """Batched symmetric-indefinite solve via eigendecomposition (kept on
    the eigh route for parity with the JAX package)."""
    lams, V = batched_eigh(A)
    inv = _eig_inverse(lams, rcond)
    return torch.einsum("bij,bj,bkj,bk->bi", V, inv, V, b)


def _sym_pinv(A: torch.Tensor, rcond: float = 1e-12) -> torch.Tensor:
    """Batched pseudo-inverse of a symmetric matrix via eigh."""
    lams, V = batched_eigh(A)
    inv = _eig_inverse(lams, rcond)
    return torch.einsum("bij,bj,bkj->bik", V, inv, V)


def _blstsq(A: torch.Tensor, Bv: torch.Tensor, rcond: float = 1e-10):
    """Batched minimum-norm least squares A^+ Bv for SYMMETRIC A
    (masked-zero rows/columns fall out as rank deficiency), via eigh."""
    lams, V = batched_eigh(A)
    inv = _eig_inverse(lams, rcond)
    return torch.einsum("bij,bj,bkj,bkl->bil", V, inv, V, Bv)


def ts_bfgs_update_batched(
    B: torch.Tensor, S: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor,
    f32: bool = False, absb: str = "eigh", eig=None,
) -> torch.Tensor:
    """Batched multi-secant TS-BFGS (``hessian_update.py:118-125``).

    ``S, Y``: (B, d, K) secant pairs with inactive columns zeroed via
    ``mask`` (B, K). ``absb``: how the |B| metric is computed — ``eigh``
    (exact) or ``ns`` (Newton–Schulz matmuls; see :func:`_abs_ns`).
    ``eig``: ``(lams, V)`` of ``B`` from a float64 eigh the caller already
    made (``absb="eigh"``, ``f32=False``); the same numbers as a second
    eigh of the same matrix, one batched eigh fewer."""
    mask_f = mask.to(B.dtype)
    S = S * mask_f[:, None, :]
    Y = Y * mask_f[:, None, :]
    J = Y - torch.einsum("bij,bjk->bik", B, S)
    STY = torch.einsum("bli,blj->bij", S, Y)               # (B, K, K)
    X1 = torch.einsum("bij,bkj->bik", STY, Y)              # (B, K, d)
    if eig is not None and absb == "eigh" and not f32:
        lams, V = eig
        absB = torch.einsum("bik,bk,bjk->bij", V, torch.abs(lams), V)
    else:
        absB = _abs_psd(B, f32, absb)
    absBS = torch.einsum("bij,bjk->bik", absB, S)          # (B, d, K)
    X2 = torch.einsum("bli,blj->bij", S, absBS)            # (B, K, K)
    X2 = torch.einsum("bij,bkj->bik", X2, absBS)           # (B, K, d)
    XS = X1 + X2                                           # (B, K, d)
    XS_S = torch.einsum("bid,bdk->bik", XS, S)             # (B, K, K)
    U = _blstsq(XS_S, XS).transpose(-1, -2)                # (B, d, K)
    UJT = torch.einsum("bik,bjk->bij", U, J)
    JTS = torch.einsum("bdi,bdj->bij", J, S)               # (B, K, K)
    delta = UJT + UJT.transpose(-1, -2) - torch.einsum(
        "bik,bkl,bjl->bij", U, JTS, U
    )
    Bp = B + delta
    return 0.5 * (Bp + Bp.transpose(-1, -2))


def bfgs_update_batched(
    B: torch.Tensor, S: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor,
) -> torch.Tensor:
    """Batched multi-secant plain BFGS (``hessian_update.py:114``):
    ``B+ = B + Y (Y^T S)^+ Y^T - B S (S^T B S)^+ S^T B`` with inactive
    secant columns zeroed."""
    mask_f = mask.to(B.dtype)
    S = S * mask_f[:, None, :]
    Y = Y * mask_f[:, None, :]
    YTS = torch.einsum("bdi,bdj->bij", Y, S)
    YTS = 0.5 * (YTS + YTS.transpose(-1, -2))
    t1 = torch.einsum("bdi,bij,bej->bde", Y, _sym_pinv(YTS), Y)
    BS = torch.einsum("bij,bjk->bik", B, S)
    STBS = torch.einsum("bdi,bdj->bij", S, BS)
    STBS = 0.5 * (STBS + STBS.transpose(-1, -2))
    t2 = torch.einsum("bdi,bij,bej->bde", BS, _sym_pinv(STBS), BS)
    Bp = B + t1 - t2
    return 0.5 * (Bp + Bp.transpose(-1, -2))


def _pd_mask(A: torch.Tensor) -> torch.Tensor:
    """(B,) bool — is each (symmetric) matrix positive definite?
    Cholesky-based, without an eigh."""
    _, info = torch.linalg.cholesky_ex(A)
    return info == 0


def quasi_newton_update_batched(
    B: torch.Tensor, S: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor,
    f32: bool = False, absb: str = "eigh", method: str = "TS-BFGS",
) -> torch.Tensor:
    """Batched quasi-Newton update dispatch (``EnsembleConfig.update``):
    ``TS-BFGS``, ``BFGS``, or ``BFGS_auto`` — plain BFGS on lanes where
    both B and the secant overlap ``S^T Y`` (in the ``S^T S`` metric) are
    positive definite, TS-BFGS elsewhere."""
    if method == "TS-BFGS":
        return ts_bfgs_update_batched(B, S, Y, mask, f32, absb)
    if method == "BFGS":
        return bfgs_update_batched(B, S, Y, mask)
    if method != "BFGS_auto":
        raise ValueError(f"Unknown batched update method {method}")
    mask_f = mask.to(B.dtype)
    Sm = S * mask_f[:, None, :]
    Ym = Y * mask_f[:, None, :]
    K = S.shape[-1]
    eyeK = torch.eye(K, dtype=B.dtype, device=B.device)
    pad = eyeK[None] * (1.0 - mask_f)[:, None, :]
    STY = torch.einsum("bdi,bdj->bij", Sm, Ym)
    STY = 0.5 * (STY + STY.transpose(-1, -2)) + pad
    STS = torch.einsum("bdi,bdj->bij", Sm, Sm) + pad
    # lam(STY, STS) > 0 <=> whitened STY is PD; STS is PD after the
    # inactive-column identity padding
    Ls, _ = torch.linalg.cholesky_ex(STS)
    Li = _btrisolve_lower(Ls, eyeK.expand(Ls.shape))
    W = torch.einsum("bij,bjk,blk->bil", Li, STY, Li)
    use_bfgs = _pd_mask(B) & _pd_mask(0.5 * (W + W.transpose(-1, -2)))
    B_bf = bfgs_update_batched(B, S, Y, mask)
    B_bf = torch.where(torch.isfinite(B_bf), B_bf, 0.0)
    B_ts = ts_bfgs_update_batched(B, S, Y, mask, f32, absb)
    return torch.where(use_bfgs[:, None, None], B_bf, B_ts)


def _btrisolve_lower(L: torch.Tensor, Bv: torch.Tensor) -> torch.Tensor:
    """Batched lower-triangular solve L X = Bv."""
    return torch.linalg.solve_triangular(L, Bv, upper=False)


def eigh_maybe_f32(A: torch.Tensor, f32: bool = False):
    """Batched symmetric eigh through the chokepoint
    (:func:`sella_tpu_torch.ops.linalg.batched_eigh`); ``f32=True`` forces
    the cast-down fast path (``EnsembleConfig.eigh_f32``)."""
    return batched_eigh(A, "f32" if f32 else None)


def _abs_ns(B: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """|B| via the Newton–Schulz matrix-sign iteration (float32 matmuls).

    For symmetric B, |B| = sign(B) B with sign(B) from
    X_{k+1} = 1.5 X_k - 0.5 X_k^3 seeded with X_0 = B/||B||_F.
    Eigenvalues smaller than ~1.5^-iters of the Frobenius norm come out
    shrunk toward zero, which is harmless for a quasi-Newton metric."""
    dt = B.dtype
    X = B.to(torch.float32)
    nrm = torch.linalg.matrix_norm(X, keepdim=True)
    X = X / torch.clamp(nrm, min=1e-30)
    for _ in range(iters):
        X2 = torch.matmul(X, X)
        X = 1.5 * X - 0.5 * torch.matmul(X2, X)
    A = torch.matmul(X, B.to(torch.float32))
    return (0.5 * (A + A.transpose(-1, -2))).to(dt)


def _abs_psd(B: torch.Tensor, f32: bool = False,
             method: str = "eigh") -> torch.Tensor:
    """|B| (batched): ``eigh`` exact, ``ns`` Newton–Schulz matmuls."""
    if method == "ns":
        return _abs_ns(B)
    lams, V = eigh_maybe_f32(B, f32)
    return torch.einsum("bik,bk,bjk->bij", V, torch.abs(lams), V)


def bootstrap_B_batched(S, Y, mask, dim):
    """Scaled-identity bootstrap from the geometric-mean |Ritz| value
    (``hessian_update.py:59-67``), batched with masked columns."""
    STY = torch.einsum("bli,blj->bij", S, Y)
    STY = 0.5 * (STY + STY.transpose(-1, -2))
    K = STY.shape[-1]
    pad = torch.where(mask, 0.0, 1.0).to(STY.dtype)
    STY = STY + torch.eye(K, dtype=STY.dtype, device=STY.device)[None] \
        * pad[:, None, :]
    thetas = batched_eigh(STY)[0]
    logs = torch.log(torch.clamp(torch.abs(thetas), min=1e-12))
    # average only over the active columns: padded eigenvalues are 1 -> log 0
    k = torch.clamp(torch.sum(mask, dim=1), min=1)
    lam0 = torch.exp(torch.sum(logs, dim=1) / k)
    return lam0[:, None, None] * torch.eye(
        dim, dtype=STY.dtype, device=STY.device
    )[None]


# ---------------------------------------------------------------------------
# Batched P-RFO / QN trust-region step
# ---------------------------------------------------------------------------
def _secular_F_dF(delta, g2, edge, mu):
    """F(mu) and F'(mu) of the pole-shifted secular function of
    :func:`_rfo_secular`."""
    # uncoupled terms need no mask here: their g2 is exactly 0 and inv is
    # finite, so they add exact zeros to both sums
    den = delta + mu[:, None]
    inv = torch.where(den > 1e-300, den.reciprocal(), 0.0)
    g2inv = g2 * inv
    F = edge - mu + torch.sum(g2inv, dim=1)
    dF = -1.0 - torch.sum(g2inv * inv, dim=1)
    return F, dF


def _secular_newton(delta, g2, edge, mu0, gnorm, niter: int):
    """``niter`` safeguarded Newton steps on F(mu) = 0 from ``mu0``,
    bracketed in (0, gnorm]; returns mu."""
    mu, lo, hi = mu0, torch.zeros_like(gnorm), gnorm + 1e-30
    for _ in range(niter):
        F, dF = _secular_F_dF(delta, g2, edge, mu)
        pos = F > 0
        lo = torch.where(pos, mu, lo)
        hi = torch.where(pos, hi, mu)
        newt = mu - F / dF
        bad = ~torch.isfinite(newt) | (newt <= lo) | (newt >= hi)
        mu = torch.where(bad, 0.5 * (lo + hi), newt)
    return mu


# On the card the secular loop is ~25 small kernels an iteration for 32
# iterations, and each costs more to launch from the host than to run:
# the restricted step's root-find calls it up to rs_maxiter + 2 times a
# step. So it runs as a CUDA graph, captured once per (shape, dtype,
# device, niter) and replayed: the same kernels on the same inputs, so
# the same numbers, from one launch.
_SECULAR_GRAPHS: dict = {}
_SECULAR_GRAPHS_MAX = 32


def _secular_newton_graphed(delta, g2, edge, mu0, gnorm, niter: int):
    """:func:`_secular_newton` on CUDA tensors through a cached CUDA
    graph."""
    args = (delta, g2, edge, mu0, gnorm)
    key = (tuple(delta.shape), delta.dtype, delta.device, niter)
    entry = _SECULAR_GRAPHS.get(key)
    if entry is None:
        if len(_SECULAR_GRAPHS) >= _SECULAR_GRAPHS_MAX:
            _SECULAR_GRAPHS.clear()
        static = [a.detach().clone(memory_format=torch.contiguous_format)
                  for a in args]
        # warm up on a side stream before the capture, as CUDA graphs ask
        stream = torch.cuda.current_stream(delta.device)
        side = torch.cuda.Stream(device=delta.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            _secular_newton(*static, niter)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _secular_newton(*static, niter)
        entry = _SECULAR_GRAPHS[key] = (graph, static, out)
    graph, static, out = entry
    for dst, src in zip(static, args):
        dst.copy_(src)
    graph.replay()
    return out.clone()


def _rfo_secular(gsub, d, alpha, highest, niter: int = 32):
    """Batched RFO subproblem via the arrowhead secular equation, solved
    in the POLE-SHIFTED gap variable (LAPACK dlaed4's trick).

    The alpha-scaled augmented matrix [[a^2 D, a g], [a g^T, 0]] is an
    arrowhead with known diagonal (D from the hoisted eigh in
    :func:`prfo_prepare_batched`), so the one extreme eigenpair the step
    needs solves ``f(lam) = lam - sum_i a^2 g_i^2 / (lam - a^2 d_i) = 0``
    elementwise. Iterating on the gap ``mu = |lam - edge|`` with exact pole
    offsets keeps full relative precision where the root sits closer than
    eps to its pole. ``highest`` reduces to the lowest-root case via
    d -> -d, lam -> -lam; ``highest`` is a bool or a per-row (R,) bool
    tensor, so one call can solve rows of both kinds. The alpha
    derivative comes from implicit differentiation. Returns
    (s, ds/dalpha)."""
    top = torch.as_tensor(highest, device=gsub.device).expand(
        gsub.shape[0])[:, None]
    sign = 1.0 - 2.0 * top.to(gsub.dtype)
    a2 = alpha[:, None] ** 2
    p = a2 * (sign * d)                # poles of the reduced problem
    num = a2 * gsub                    # a^2 g_i
    g2 = num * gsub                    # a^2 g_i^2 >= 0
    coupled = g2 > 0.0
    gnorm = torch.sqrt(torch.sum(g2, dim=1))   # |a g|_2

    p_eff = torch.where(coupled, p, BIG)
    edge = torch.clamp(torch.amin(p_eff, dim=1), max=0.0)
    delta = p - edge[:, None]          # >= 0, exact at the edge pole
    # F(mu) = edge - mu + sum_i g2_i/(delta_i + mu): strictly
    # decreasing and convex on mu > 0 with a unique root in (0, gnorm]
    m_bind = coupled & (delta <= 0.0)
    g2_bind = torch.sum(torch.where(m_bind, g2, 0.0), dim=1)
    C0 = torch.sum(
        torch.where(m_bind | ~coupled, 0.0,
                    g2 / torch.clamp(delta, min=1e-300)),
        dim=1,
    )
    b = edge + C0
    disc = torch.sqrt(b * b + 4.0 * g2_bind)
    # stable quadratic root of the two-term model
    mu0 = torch.where(
        b > 0.0, 0.5 * (b + disc),
        2.0 * g2_bind / torch.clamp(disc - b, min=1e-300),
    )
    mu0 = torch.minimum(torch.clamp(mu0, min=1e-300), gnorm + 1e-30)

    solve = (_secular_newton_graphed if delta.is_cuda and not any(
        t.requires_grad for t in (delta, g2, edge, mu0, gnorm))
        else _secular_newton)
    mu = solve(delta, g2, edge, mu0, gnorm, niter)

    # reduced-frame den = lam_low - p = -(delta + mu), exact at poles;
    # original frame: lowest -> identity, highest -> inv flips sign
    den = -(delta + mu[:, None])
    ok = torch.abs(den) > 1e-300
    inv = torch.where(ok & coupled, 1.0 / torch.where(ok, den, 1.0), 0.0)
    inv_o = torch.where(top, -inv, inv)
    s = num * inv_o

    # dlam/dalpha by implicit differentiation of f(lam, alpha) = 0
    _, dF = _secular_F_dF(delta, g2, edge, mu)
    df_dlam = -dF                       # = 1 + sum g2 inv^2 > 0
    a = alpha[:, None]
    df_dalpha = -torch.sum(
        2 * a * gsub**2 * inv_o + 2 * a**3 * d * gsub**2 * inv_o * inv_o,
        dim=1,
    )
    dlam = -df_dalpha / df_dlam
    ds = (
        2 * a * gsub * inv_o
        - num * (dlam[:, None] - 2 * a * d) * inv_o * inv_o
    )
    return s, ds


def prfo_prepare_batched(g, Hproj, order: int, f32: bool = False,
                         method: str = "eigh"):
    """Alpha-independent PRFO precomputation: one batched eigh, hoisted
    out of the alpha root-find. ``method="jacobi"`` routes through the
    parallel-order Jacobi (:func:`sella_tpu_torch.ops.jacobi_eigh.
    jacobi_eigh`: the CUDA kernel for CUDA tensors, the plain version on
    the CPU) — float32 accuracy, like ``f32=True``."""
    if method == "jacobi":
        lams, V = jacobi_eigh(Hproj)
    else:
        lams, V = eigh_maybe_f32(Hproj, f32)
    gV = _bmtv(V, g)
    return lams, V, gV


def prfo_step_batched(prep, order: int, alpha):
    """Batched P-RFO step in the free subspace at per-search alpha
    (``stepper.py:160-185``): the highest root over the first ``order``
    modes, the lowest over the rest. Both secular solves run as one
    batch of 2B rows, each side zero-padded to a common width (zero
    coupling adds exact zeros to every sum, so the padding changes no
    result)."""
    lams, V, gV = prep
    if order == 0:
        s, ds = _rfo_secular(gV, lams, alpha, highest=False)
        return _bmv(V, s), _bmv(V, ds)
    Bsz, q = lams.shape
    w = max(order, q - order)

    def two_sides(a):
        return torch.cat([
            torch.nn.functional.pad(a[:, :order], (0, w - order)),
            torch.nn.functional.pad(a[:, order:], (0, w - q + order)),
        ])

    highest = torch.arange(2 * Bsz, device=lams.device) < Bsz
    s2, ds2 = _rfo_secular(two_sides(gV), two_sides(lams),
                           torch.cat([alpha, alpha]), highest)
    s = torch.cat([s2[:Bsz, :order], s2[Bsz:, :q - order]], dim=1)
    ds = torch.cat([ds2[:Bsz, :order], ds2[Bsz:, :q - order]], dim=1)
    return _bmv(V, s), _bmv(V, ds)


def qn_step_batched(prep, order: int, alpha):
    """Batched shifted quasi-Newton/MMF step (``stepper.py:58-96``)."""
    lams, V, gV = prep
    q = lams.shape[-1]
    sign = torch.where(
        torch.arange(q, device=lams.device)[None, :] < order, -1.0, 1.0
    ).to(lams.dtype)
    L = torch.abs(lams) * sign
    denom = L + alpha[:, None] * sign
    sproj = gV / denom
    s = -_bmv(V, sproj)
    ds = _bmv(V, sproj * sign / denom)
    return s, ds


def _step_norm(s_full, ds_full, rs: str, natoms: int):
    """'ras' (max per-atom displacement) or 'tr' (2-norm) with analytic
    alpha-derivative (``restricted_step.py:127-183``)."""
    if rs == "tr":
        val = torch.linalg.norm(s_full, dim=1)
        dval = torch.einsum("bi,bi->b", ds_full, s_full) / torch.clamp(
            val, min=1e-12
        )
        return val, dval
    s3 = s_full.reshape(-1, natoms, 3)
    ds3 = ds_full.reshape(-1, natoms, 3)
    norms = torch.linalg.norm(s3, dim=2)
    idx = torch.argmax(norms, dim=1)      # first index on ties
    b = torch.arange(s3.shape[0], device=s3.device)
    val = norms[b, idx]
    dval = torch.einsum("bi,bi->b", ds3[b, idx], s3[b, idx]) / torch.clamp(
        val, min=1e-12
    )
    return val, dval


def restricted_step_batched(
    g_free, Hproj, Ufree, delta, cfg: EnsembleConfig, prep=None,
    norm_fn=None, stepper_fn=None,
):
    """Map per-search trust radii to steps: masked Newton/bisection on
    ||s(alpha)|| = delta (``restricted_step.py:78-120``), at most
    ``cfg.rs_maxiter`` iterations: the JAX package's fixed count, cut
    short once every lane is done, with the same result. Returns
    (s_full, smag).

    ``norm_fn(s_full, ds_full) -> (val, dval)`` overrides the step norm
    (the internal-coordinate tier passes its weighted max-internal-step
    norm); by default it is ``cfg.rs`` ('ras'/'tr') on Cartesian
    geometry. ``stepper_fn(prep, order, alpha) -> (s_free, ds_free)``
    overrides the step family (the IRC tier passes its mass-weighted
    corrector); it uses the qn alpha schedule unless ``cfg.method`` is
    'prfo'."""
    stepper = prfo_step_batched if cfg.method == "prfo" else qn_step_batched
    if stepper_fn is not None:
        stepper = stepper_fn
    Bsz = g_free.shape[0]
    dtype, dev = g_free.dtype, g_free.device

    if cfg.method == "prfo":
        alpha0, amin, amax, slope = 1.0, 0.0, 1.0, 1.0
    else:
        alpha0, amin, amax, slope = 0.0, 0.0, float("inf"), -1.0

    if prep is None:
        prep = prfo_prepare_batched(g_free, Hproj, cfg.order)

    def eval_at(alpha):
        s_free, ds_free = stepper(prep, cfg.order, alpha)
        s_full = _bmv(Ufree, s_free)
        ds_full = _bmv(Ufree, ds_free)
        if norm_fn is not None:
            val, dval = norm_fn(s_full, ds_full)
        else:
            val, dval = _step_norm(s_full, ds_full, cfg.rs, cfg.natoms)
        return s_full, val, dval

    alpha = torch.full((Bsz,), alpha0, dtype=dtype, device=dev)
    s, val, dval = eval_at(alpha)
    # interior step: accept immediately
    done0 = val < delta
    smag0 = val

    lower = torch.full((Bsz,), amin, dtype=dtype, device=dev)
    upper = torch.full((Bsz,), amax, dtype=dtype, device=dev)
    done = done0
    # Once every lane is done, the remaining iterations leave alpha, and
    # so the result, unchanged: the loop stops there. The test is a host
    # sync an iteration on the card, cheaper than an iteration's launches.
    for _ in range(cfg.rs_maxiter):
        if bool(done.all()):
            break
        _, val, dval = eval_at(alpha)
        err = val - delta
        done = done | (torch.abs(err) <= cfg.rs_tol)

        shrink_up = err * slope > 0
        upper = torch.where(shrink_up, alpha, upper)
        lower = torch.where(shrink_up, lower, alpha)

        a1 = alpha - err / torch.where(dval != 0, dval, 1.0)
        newton_bad = (
            torch.isnan(a1) | (a1 <= lower) | (a1 >= upper) | (dval == 0)
        )
        a2 = 0.5 * (lower + upper)
        # unbounded upper (qn): grow alpha geometrically
        a2 = torch.where(
            torch.isinf(a2), alpha + torch.clamp(0.5 * alpha, min=1.0), a2
        )
        alpha_new = torch.where(newton_bad, a2, a1)
        alpha = torch.where(done, alpha, alpha_new)
    # final evaluation at the converged alpha for not-yet-copied steps
    s_fin, val_fin, _ = eval_at(alpha)
    s_out = torch.where(done0[:, None], s, s_fin)
    smag = torch.where(done0, smag0, torch.minimum(val_fin, delta))
    return s_out, smag


# ---------------------------------------------------------------------------
# Potential batching
# ---------------------------------------------------------------------------
def _chunk_lanes(vfn, chunk):
    """Run a vmapped-over-lanes function in ``chunk``-lane sub-batches
    (one chunk's potential intermediates live at a time). Whole-batch
    when chunking is disabled or the batch is not divisible."""
    if not chunk:
        return vfn

    def run(*args):
        B = args[0].shape[0]
        if B <= chunk or B % chunk:
            return vfn(*args)
        outs = [vfn(*(a[i:i + chunk] for a in args))
                for i in range(0, B, chunk)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o, dim=0) for o in zip(*outs))
        return torch.cat(outs, dim=0)

    return run


def _batched_eval(potential, cell, chunk=0):
    """(B, d) -> (f (B,), g (B, d)) through ``vmap`` of grad-and-value."""
    def one(x):
        g, e = grad_and_value(potential.energy)(x, cell)
        return e, g

    return _chunk_lanes(vmap(one), chunk)


def _batched_hvp_full(potential, cell, chunk=0):
    """Full-space exact HVP of the potential at x along v (batched,
    forward-over-reverse)."""
    def one(x, v):
        return jvp(lambda y: grad(potential.energy)(y, cell), (x,), (v,))[1]

    return _chunk_lanes(vmap(one), chunk)


# ---------------------------------------------------------------------------
# Davidson + absorption
# ---------------------------------------------------------------------------
def _davidson_and_absorb(potential, cell, cfg: EnsembleConfig, x, g, B,
                         B_init, Ufree, active, generator=None,
                         cons_jac=None, cons_active=None, tang_proj=None):
    """Run batched Davidson at x and absorb every HVP probe into B
    (the reference's diag + full-probe TS-BFGS absorption,
    ``peswrapper.py:508-556``). Returns (B_out, B_init_out, k).

    With ``cons_jac`` (one lane's (d,) -> (m, d) constraint Jacobian) the
    operator is the Lagrangian Hessian ``W v = H v - sum_k lam_k (d2c_k) v``
    with least-squares multipliers ``lam = (J J^T)^+ J g``.
    ``cons_active`` (B, m) masks inactive inequality rows out of the
    multipliers; ``tang_proj`` (B, nfree, nfree), the projector onto the
    active-constraint tangent space in free coordinates, confines the
    operator to that space and gives the projected-out directions a stiff
    positive shift."""
    K = cfg.subspace_max
    hvp_full = _batched_hvp_full(potential, cell, cfg.eval_chunk)
    if cons_jac is not None:
        J = vmap(cons_jac)(x)                          # (B, m, d)
        if cons_active is not None:
            J = J * cons_active[:, :, None]
        JJt = torch.einsum("bij,bkj->bik", J, J)
        lam = sym_solve(JJt, torch.einsum("bij,bj->bi", J, g))   # (B, m)
        hvp_pot = hvp_full

        def _corr_one(x1, v1, l1):
            # directional derivative of J(x)^T lam at fixed lam
            return jvp(lambda y: cons_jac(y).T @ l1, (x1,), (v1,))[1]

        corr = vmap(_corr_one)

        def hvp_full(xb, vb):  # noqa: F811 — Lagrangian-corrected
            return hvp_pot(xb, vb) - corr(xb, vb, lam)

    nfree = Ufree.shape[2]

    if tang_proj is None:
        def hvp_free(v_free):
            v_full = _bmv(Ufree, v_free)
            Av_full = hvp_full(x, v_full)
            return _bmtv(Ufree, Av_full), Av_full
    else:
        def hvp_free(v_free):
            vt = _bmv(tang_proj, v_free)
            v_full = _bmv(Ufree, vt)
            Av_full = hvp_full(x, v_full)
            Av = _bmtv(tang_proj, _bmtv(Ufree, Av_full))
            # stiff shift along projected-out directions
            return Av + _CONS_SHIFT * (v_free - vt), Av_full

    # preconditioner: projected quasi-Newton B (identity when fresh)
    P = torch.einsum("bji,bjk,bkl->bil", Ufree, B, Ufree)
    eye = torch.eye(nfree, dtype=x.dtype, device=x.device)[None]
    P = torch.where(B_init[:, None, None], P, eye)
    if tang_proj is not None:
        P = (torch.einsum("bij,bjk,bkl->bil", tang_proj, P, tang_proj)
             + _CONS_SHIFT * (eye - tang_proj))

    v0 = _bmtv(Ufree, g)
    if tang_proj is not None:
        v0 = _bmv(tang_proj, v0)

    P_eig = None
    if cfg.davidson_seed == "pmode":
        P_eig = batched_eigh(P)
        # leftmost P-mode for warm-Hessian lanes (reference subspace
        # init, ``eigensolvers.py:47-50``); gradient seed for bootstraps
        v0 = torch.where(B_init[:, None], P_eig[1][:, :, 0], v0)

    V, AVp, YF, k = _davidson_loop(
        hvp_free, P, v0, cfg.gamma, K, active, generator, P_eig=P_eig,
    )

    # Rotate probes A-diagonal before the update (``peswrapper.py:546-553``)
    lams, W, colmask = _masked_ritz(V, AVp, k, K)
    Vr = torch.einsum("bik,bkl->bil", V, W)
    YFr = torch.einsum("bik,bkl->bil", YF, W)
    S_full = torch.einsum("bij,bjk->bik", Ufree, Vr)
    mask = colmask

    B_boot = bootstrap_B_batched(S_full, YFr, mask, cfg.dim)
    B_base = torch.where(B_init[:, None, None], B, B_boot)
    B_new = quasi_newton_update_batched(
        B_base, S_full, YFr, mask, cfg.eigh_f32, cfg.absb, cfg.update)
    B_out = torch.where(active[:, None, None], B_new, B)
    return B_out, B_init | active, k


def _davidson_loop(hvp_free2, P, v0, gamma, K, active_in, generator=None,
                   P_eig=None):
    """Masked batched Davidson whose hvp returns (projected, full)
    actions; stores the full actions alongside for secant absorption.
    ``P_eig``: optional precomputed ``(lams, Q)`` of the preconditioner.
    ``generator`` feeds the dead-vector restart draw."""
    Bsz, m = v0.shape
    dtype, dev = v0.dtype, v0.device

    nrm = torch.linalg.norm(v0, dim=1, keepdim=True)
    e0 = torch.zeros((Bsz, m), dtype=dtype, device=dev)
    e0[:, 0] = 1.0
    v0 = torch.where(nrm > 1e-12, v0 / torch.where(nrm > 0, nrm, 1.0), e0)

    Av0p, Av0f = hvp_free2(v0)
    d_full = Av0f.shape[1]

    act_f = active_in[:, None, None].to(dtype)
    V = torch.zeros((Bsz, m, K), dtype=dtype, device=dev)
    AVp = torch.zeros((Bsz, m, K), dtype=dtype, device=dev)
    YF = torch.zeros((Bsz, d_full, K), dtype=dtype, device=dev)
    V[:, :, 0] = v0
    AVp[:, :, 0] = Av0p
    YF[:, :, 0] = Av0f
    V, AVp, YF = V * act_f, AVp * act_f, YF * act_f
    k = active_in.to(torch.int32)
    running = active_in
    bidx = torch.arange(Bsz, device=dev)
    kidx = torch.arange(K, device=dev)[None, :]

    def ritz(V, AVp, k):
        lams, W, colmask = _masked_ritz(V, AVp, k, K)
        Vr = torch.einsum("bik,bkl->bil", V, W)
        AVr = torch.einsum("bik,bkl->bil", AVp, W)
        neg = torch.sum((lams < 0) & colmask, dim=1)
        nneg = torch.clamp(neg, min=1)
        R = AVr - Vr * lams[:, None, :]
        Rnorm = torch.linalg.norm(R, dim=1)
        conv = (Rnorm < gamma * torch.abs(lams)) & (k[:, None] > 1)
        of_interest = (kidx < nneg[:, None]) & colmask
        unconv = of_interest & ~conv
        # argmax over a mask: cast first; the first index wins ties
        seeking = torch.argmax(unconv.to(torch.int32), dim=1)
        any_unconv = torch.any(unconv, dim=1)
        return lams, Vr, AVr, R, seeking, any_unconv, W

    # One eigendecomposition of the (iteration-independent) jd0
    # preconditioner per Davidson call; each iteration's augmented solve
    # is two diagonal applications via the Olsen formula.
    lamsP, QP = P_eig if P_eig is not None else batched_eigh(P)

    def pinv_shift_apply(theta, x):
        """(P - theta I)^+ x through the precomputed eigenbasis."""
        denom = lamsP - theta[:, None]
        scale = torch.amax(torch.abs(lamsP), dim=1, keepdim=True) + 1e-300
        keep = torch.abs(denom) > 1e-12 * scale
        inv = torch.where(keep, 1.0 / torch.where(keep, denom, 1.0), 0.0)
        return torch.einsum("bij,bj,bkj,bk->bi", QP, inv, QP, x)

    def project_out(Vr, t):
        return t - torch.einsum("bik,bk->bi", Vr,
                                torch.einsum("bik,bi->bk", Vr, t))

    def body(V, AVp, YF, k, running):
        lams, Vr, AVr, R, seeking, any_unconv, W = ritz(V, AVp, k)
        YFr = torch.einsum("bik,bkl->bil", YF, W)
        run = running & any_unconv & (k < K)

        theta = lams[bidx, seeking]
        r = R[bidx, :, seeking]
        vi = Vr[bidx, :, seeking]

        # Olsen/JD correction: t = -(y1 - (v^T y1 / v^T y2) y2) with
        # y1 = (P - theta)^+ r, y2 = (P - theta)^+ v; t is normalized
        # below, so the global sign is immaterial.
        y1 = pinv_shift_apply(theta, r)
        y2 = pinv_shift_apply(theta, vi)
        num = torch.einsum("bi,bi->b", vi, y1)
        den = torch.einsum("bi,bi->b", vi, y2)
        safe = torch.abs(den) > 1e-300
        alpha = torch.where(safe, num / torch.where(safe, den, 1.0), 0.0)
        t = y1 - alpha[:, None] * y2

        tnorm = torch.linalg.norm(t, dim=1, keepdim=True)
        bad = (~torch.all(torch.isfinite(t), dim=1, keepdim=True)) | (
            tnorm < 1e-300
        )
        rnorm = torch.linalg.norm(r, dim=1, keepdim=True)
        rhat = r / torch.where(rnorm > 0, rnorm, 1.0)
        t = torch.where(bad, rhat, t / torch.where(tnorm > 0, tnorm, 1.0))
        t = torch.where(
            torch.linalg.norm(project_out(Vr, t), dim=1, keepdim=True)
            < 1e-2, rhat, t
        )
        for _ in range(2):
            t = project_out(Vr, t)
        tnorm = torch.linalg.norm(t, dim=1, keepdim=True)
        dead = tnorm[:, 0] < 1e-8
        rand = torch.randn((Bsz, m), generator=generator, dtype=dtype,
                           device=dev)
        rand = project_out(Vr, rand)
        rand = rand / torch.clamp(
            torch.linalg.norm(rand, dim=1, keepdim=True), min=1e-12
        )
        t = torch.where(dead[:, None], rand,
                        t / torch.where(tnorm > 0, tnorm, 1.0))

        Atp, Atf = hvp_free2(t)

        slot = torch.clamp(k, 0, K - 1)
        onehot = (kidx == slot[:, None]) & run[:, None]
        Vn = torch.where(onehot[:, None, :], t[:, :, None], Vr)
        AVn = torch.where(onehot[:, None, :], Atp[:, :, None], AVr)
        YFn = torch.where(onehot[:, None, :], Atf[:, :, None], YFr)
        kn = k + run.to(k.dtype)
        # Freeze finished lanes entirely: extra global iterations (driven
        # by slower searches in the batch) must not keep re-rotating a
        # finished search's subspace (batch-composition independence).
        keep = run[:, None, None]
        Vn = torch.where(keep, Vn, V)
        AVn = torch.where(keep, AVn, AVp)
        YFn = torch.where(keep, YFn, YF)
        return Vn, AVn, YFn, kn, run

    # Check for early exit once per CHUNK iterations, as the JAX package
    # does (its chunked while_loop); each check is one host sync.
    CHUNK = 4
    it = 0
    while it < K - 1 and bool(torch.any(running)):
        for _ in range(CHUNK):
            V, AVp, YF, k, running = body(V, AVp, YF, k, running)
            it += 1
    return V, AVp, YF, k


def _validate_rigid_rank(x0: np.ndarray, nproj: int) -> None:
    """Warn when the rigid generators are rank-deficient (linear/planar
    cluster): the complete-QR ``free_basis`` then silently keeps a rigid
    direction in the 'free' subspace. Host-side, init-time only."""
    if nproj != 6:
        return
    import warnings

    for b in range(x0.shape[0]):
        pos = np.asarray(x0[b]).reshape(-1, 3)
        rel = pos - pos.mean(axis=0)
        gens = [np.cross(e, rel).ravel() for e in np.eye(3)]
        rank = np.linalg.matrix_rank(np.stack(gens), tol=1e-8)
        if rank < 3:
            warnings.warn(
                f"lane {b}: rigid rotation generators are rank-{rank} "
                "(linear geometry) — free_basis will retain a rigid "
                "direction; use nproj=5 (translations + the two "
                "physical rotations) for linear geometries"
            )
            return  # one warning is enough


def _as_cell(cell, like: torch.Tensor) -> torch.Tensor:
    if cell is None:
        return torch.zeros((3, 3), dtype=like.dtype, device=like.device)
    return torch.as_tensor(cell, dtype=like.dtype, device=like.device)


def _target_device(x0, device) -> torch.device:
    """Decide where a search runs. A tensor ``x0`` keeps its device (the
    caller placed it) unless ``device`` names another. Anything else (a
    numpy array, nested lists) goes to ``device``, and to the GPU when
    none is given: the CPU is reached only by a CPU tensor or by
    ``device="cpu"``, never by default."""
    if device is not None:
        return torch.device(device)
    if isinstance(x0, torch.Tensor):
        return x0.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "x0 is not a tensor and no device was given: the search "
            "runs on the GPU by default, and no CUDA device is "
            "present. Pass device=\"cpu\" (or a CPU tensor) to run on "
            "the CPU."
        )
    return torch.device("cuda")


def _place_x0(x0, device) -> torch.Tensor:
    """``x0`` as a tensor on the device :func:`_target_device` picks."""
    dev = _target_device(x0, device)
    if isinstance(x0, torch.Tensor):
        return x0.to(dev)
    return torch.as_tensor(np.asarray(x0), device=dev)


def _check_potential_device(potential, dev: torch.device) -> None:
    """Raise if the potential's buffers or parameters live on another
    device than the state (a potential without any runs anywhere)."""
    if not isinstance(potential, torch.nn.Module):
        return
    t = next(itertools.chain(potential.buffers(), potential.parameters()),
             None)
    if t is None:
        return
    same = t.device.type == dev.type and (
        t.device.index is None or dev.index is None
        or t.device.index == dev.index)
    if not same:
        raise ValueError(
            f"the potential lives on {t.device} but the search state on "
            f"{dev}: move one of them (potential.to({str(dev)!r}), or place "
            f"x0 / pass device= accordingly)"
        )


def init_state(potential, x0, cfg: EnsembleConfig, cell=None,
               device=None) -> SearchState:
    """Initialize the batched search state (pre-step, no diag yet).
    A tensor ``x0`` keeps its device; any other ``x0`` goes to ``device``,
    by default the GPU (see :func:`_place_x0`; ``device="cpu"`` asks for
    the CPU). The state is float64 (``x0`` is cast); ``potential`` must
    live on the same device."""
    x0 = _place_x0(x0, device).to(default_dtype())
    _check_potential_device(potential, x0.device)
    _validate_rigid_rank(x0.detach().cpu().numpy(), cfg.nproj)
    x0 = x0.clone()
    Bsz = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    cell = _as_cell(cell, x0)
    f, g = _batched_eval(potential, cell, cfg.eval_chunk)(x0)
    d = cfg.dim
    i32 = dict(dtype=torch.int32, device=dev)
    return SearchState(
        x=x0,
        f=f,
        g=g,
        B=torch.eye(d, dtype=dtype, device=dev).expand(Bsz, d, d).clone(),
        B_init=torch.zeros(Bsz, dtype=torch.bool, device=dev),
        delta=torch.full((Bsz,), cfg.delta0, dtype=dtype, device=dev),
        rho=torch.ones((Bsz,), dtype=dtype, device=dev),
        nsteps_since_diag=torch.zeros(Bsz, **i32),
        converged=torch.zeros(Bsz, dtype=torch.bool, device=dev),
        nsteps=torch.zeros(Bsz, **i32),
        neval=torch.ones(Bsz, **i32),
        nmatvec=torch.zeros(Bsz, **i32),
        best_fmax=torch.full((Bsz,), torch.inf, dtype=dtype, device=dev),
        stall=torch.zeros(Bsz, **i32),
        nrestarts=torch.zeros(Bsz, **i32),
        x_home=x0.clone(),
        fmax_t=torch.tensor(cfg.fmax, dtype=dtype, device=dev),
    )


def make_step_fn(potential, cfg: EnsembleConfig, cell=None,
                 constraints=None, comparators=None):
    """Build the batched step ``step(state, generator) -> state``: one
    full RS-P-RFO iteration for every search in the ensemble
    (``optimize.py:359-440`` as a pure function of the state; the input
    state is never modified).

    ``constraints``: optional function ``c(x: (d,)) -> (m,)`` of
    constraint residuals (m == cfg.ncons, the same for every lane; each
    lane evaluates it at its own geometry), written in torch operations
    that ``torch.func.jacfwd`` and ``vmap`` can trace. ``comparators``:
    one of ``'eq'``, ``'lt'`` (c <= 0) or ``'gt'`` (c >= 0) per row, all
    ``'eq'`` by default. Equalities confine the step to the tangent space
    (``constrained_free_basis``); any inequality switches to the
    projector path, which keeps the rigid-free basis and projects the
    active rows out. Both add a Gauss-Newton restoration step capped at
    the trust radius, give Davidson the Lagrangian Hessian, and require
    ``max violation < cfg.ctol`` for convergence."""
    if constraints is None and cfg.ncons > 0:
        raise ValueError(
            f"cfg.ncons == {cfg.ncons} but no constraints function given"
        )
    if comparators is not None and constraints is None:
        raise ValueError("comparators given but no constraints function")
    audit = cfg.conv_inertia and cfg.order > 0
    has_ineq = False
    cons_jac = None
    if constraints is not None:
        if cfg.ncons <= 0:
            raise ValueError("constraints given but cfg.ncons == 0")
        m = tuple(constraints(torch.zeros(cfg.dim,
                                          dtype=torch.float64)).shape)
        if m != (cfg.ncons,):
            raise ValueError(
                f"constraints(x) returns shape {m}, expected"
                f" ({cfg.ncons},) to match cfg.ncons"
            )
        cons_jac = jacfwd(constraints)
        if comparators is None:
            comparators = ("eq",) * cfg.ncons
        comparators = tuple(comparators)
        if len(comparators) != cfg.ncons or not all(
            c in ("eq", "lt", "gt") for c in comparators
        ):
            raise ValueError(
                f"comparators must be {cfg.ncons} of 'eq'|'lt'|'gt', got"
                f" {comparators}"
            )
        has_ineq = any(c != "eq" for c in comparators)

    if has_ineq:
        # Inequality (projector) path: the active set varies per lane and
        # per step, so the step works in the rigid-free basis and projects
        # the ACTIVE constraint rows out of gradient and Hessian, giving
        # the projected-out directions a stiff positive curvature.
        # Inequalities deactivate while satisfied and re-engage on
        # violation (the reference's disable_satisfied semantics).
        cfg_w = cfg._replace(ncons=0)
        kinds = np.array(comparators)
        masks = {}

        def comparator_masks(dev):
            """(eq, lt, gt) row masks on ``dev``, copied there once."""
            if dev not in masks:
                masks[dev] = tuple(torch.as_tensor(kinds == k, device=dev)
                                   for k in ("eq", "lt", "gt"))
            return masks[dev]

        def active_mask(c, J, g):
            """Active set with a boundary layer and a multiplier-sign
            test: violated rows are always active, comfortably satisfied
            ones free, and a row in the |c| <= ctol layer stays active
            while the descent direction points out of the feasible region
            (for 'lt': J.g < 0). A purely violation-driven set chatters
            on the boundary and never converges."""
            eqm, ltm, gtm = comparator_masks(c.device)
            jg = torch.einsum("bmd,bd->bm", J, g)
            layer = torch.abs(c) <= cfg.ctol
            return (eqm
                    | (ltm & ((c > 0.0) | (layer & (jg < 0.0))))
                    | (gtm & ((c < 0.0) | (layer & (jg > 0.0)))))

        def basis_fn(xx):
            return free_basis(xx, cfg.nproj)
    elif constraints is not None:
        cfg_w = cfg

        def basis_fn(xx):
            return constrained_free_basis(xx, cfg.nproj, cons_jac)
    else:
        cfg_w = cfg

        def basis_fn(xx):
            return free_basis(xx, cfg.nproj)

    def tang_at(x, c, g, Ufree):
        """Active-set mask and tangent projector (inequality path)."""
        Jb0 = vmap(cons_jac)(x)                            # (B, m, d)
        a = active_mask(c, Jb0, g).to(x.dtype)
        Jb = Jb0 * a[:, :, None]
        A = torch.einsum("bmd,bdf->bmf", Jb, Ufree)        # (B, m, f)
        G = torch.einsum("bmf,bnf->bmn", A, A)
        Pc = torch.einsum("bmf,bmn,bng->bfg", A, _sym_pinv(G), A)
        eye = torch.eye(Ufree.shape[2], dtype=x.dtype, device=x.device)
        return a, eye[None] - Pc

    def _diag_at(cell_t, x_, g_, B_, B_init_, Ufree_, active_, generator,
                 cons_active_=None, tang_proj_=None):
        if bool(torch.any(active_)):
            return _davidson_and_absorb(
                potential, cell_t, cfg_w, x_, g_, B_, B_init_, Ufree_,
                active_, generator, cons_jac=cons_jac,
                cons_active=cons_active_, tang_proj=tang_proj_,
            )
        return B_, B_init_, torch.zeros(
            active_.shape[0], dtype=torch.int32, device=active_.device
        )

    # the cell, the eval and the audit HVP, built once per device and
    # dtype (the step learns them from its first state)
    built = {}

    def built_for(x):
        key = (x.device, x.dtype)
        if key not in built:
            cell_t = _as_cell(cell, x)
            built[key] = (
                cell_t, _batched_eval(potential, cell_t, cfg.eval_chunk),
                _batched_hvp_full(potential, cell_t, cfg.eval_chunk)
                if audit else None)
        return built[key]

    def step(state: SearchState, generator=None) -> SearchState:
        cell_t, eval_fn, hvp_audit = built_for(state.x)
        Bsz = state.x.shape[0]
        dtype, dev = state.x.dtype, state.x.device
        act = ~state.converged

        Ufree = basis_fn(state.x)
        if has_ineq:
            c_cur = vmap(constraints)(state.x)
            a_cur, Ip_cur = tang_at(state.x, c_cur, state.g, Ufree)
        else:
            c_cur = a_cur = Ip_cur = None

        # ---- initial diagonalization (first step only, eig mode) ----
        need_init_diag = act & (~state.B_init) & cfg.eig
        B1, B_init1, k_init = _diag_at(
            cell_t, state.x, state.g, state.B, state.B_init, Ufree,
            need_init_diag, generator, a_cur, Ip_cur,
        )
        # HVP matvecs are exact jvp's, not force calls: they count in
        # nmatvec only
        nmv = state.nmatvec + torch.where(need_init_diag, k_init, 0)
        neval = state.neval

        # ---- projected quantities ----
        Hproj = torch.einsum("bji,bjk,bkl->bil", Ufree, B1, Ufree)
        eye = torch.eye(cfg_w.nfree, dtype=dtype, device=dev)[None]
        Hproj = torch.where(B_init1[:, None, None], Hproj, eye)
        g_free = _bmtv(Ufree, state.g)
        if has_ineq:
            g_free = _bmv(Ip_cur, g_free)
            Hproj = (torch.einsum("bij,bjk,bkl->bil", Ip_cur, Hproj, Ip_cur)
                     + _CONS_SHIFT * (eye - Ip_cur))

        # one batched eigh of the projected Hessian serves the
        # trust-region stepper, the diag-scheduling inertia check and the
        # conv_inertia gate
        prep = prfo_prepare_batched(g_free, Hproj, cfg.order,
                                    cfg.eigh_f32, cfg.prfo_eigh)

        # ---- inertia gate for convergence (see conv_inertia) ----
        if cfg.conv_inertia:
            lams_c = prep[0]
            if cfg.order > 0:
                bad_i = torch.any(lams_c[:, : cfg.order] > 0, dim=1)
                if cfg.order < cfg_w.nfree:
                    bad_i = bad_i | (lams_c[:, cfg.order] < 0)
            else:
                bad_i = lams_c[:, 0] < 0
            inertia_ok = ~bad_i
        else:
            inertia_ok = None

        # ---- trust-region step ----
        s_full, smag = restricted_step_batched(
            g_free, Hproj, Ufree, state.delta, cfg_w, prep=prep
        )
        s_full = torch.where(act[:, None], s_full, 0.0)

        # ---- diag scheduling (``optimize.py:362-378``) ----
        if cfg.eig and cfg.order > 0:
            lams_proj = prep[0]
            # wrong inertia: too few negatives (reference trigger) or
            # too many (near a higher-order saddle); bounded by the
            # projected width, wider than cfg.nfree on the inequality path
            too_few = torch.any(lams_proj[:, : cfg.order] > 0, dim=1)
            too_many = (
                lams_proj[:, cfg.order] < 0
                if cfg.order < cfg_w.nfree
                else torch.zeros(Bsz, dtype=torch.bool, device=dev)
            )
            ev = act & (state.nsteps_since_diag >= cfg.nsteps_per_diag) & (
                too_few | too_many
            )
        else:
            ev = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        if cfg.diag_every_n > 0:
            ev = ev | (act & (state.nsteps_since_diag >= cfg.diag_every_n))
        # compaction: serve at most diag_budget requests this step;
        # unserved lanes keep counting and re-request next step
        if 0 < cfg.diag_budget < Bsz:
            # aging: serve the longest-waiting requesters first; the
            # sort must be stable so tied lanes go in index order
            prio = torch.where(
                ev, -state.nsteps_since_diag,
                torch.iinfo(torch.int32).max,
            )
            sel = torch.argsort(prio, stable=True)[: cfg.diag_budget]
            served = torch.zeros(Bsz, dtype=torch.bool, device=dev)
            served[sel] = ev[sel]
        else:
            sel = None
            served = ev
        nsd = torch.where(
            served | need_init_diag, 0, state.nsteps_since_diag + 1
        ).to(torch.int32)

        # ---- take the step ----
        if cons_jac is not None:
            # Gauss-Newton restoration toward the constraint manifold,
            # kept separate so the tangent step and the normal
            # correction stay orthogonal to first order
            c_now = c_cur if c_cur is not None else vmap(constraints)(
                state.x)                                     # (B, m)
            Jb = vmap(cons_jac)(state.x)                     # (B, m, d)
            if has_ineq:
                # restore only the ACTIVE rows
                Jb = Jb * a_cur[:, :, None]
                c_now = c_now * a_cur
            JJt = torch.einsum("bij,bkj->bik", Jb, Jb)
            dx_rest = -torch.einsum("bij,bi->bj", Jb, sym_solve(JJt, c_now))
            # cap restoration at the trust radius to keep the update
            # secant meaningful when starting far off the manifold
            rmag = torch.linalg.norm(dx_rest, dim=1, keepdim=True)
            cap = state.delta[:, None]
            dx_rest = torch.where(
                rmag > cap,
                dx_rest * cap / torch.where(rmag > 0, rmag, 1.0), dx_rest,
            )
            s_full = s_full + torch.where(act[:, None], dx_rest, 0.0)
        x_new = state.x + s_full
        f_new, g_new = eval_fn(x_new)
        neval = neval + act.to(torch.int32)

        # ---- trust ratio (``peswrapper.py:578-594``) ----
        df_pred = torch.einsum("bi,bi->b", state.g, s_full) + 0.5 * \
            torch.einsum("bi,bij,bj->b", s_full, B1, s_full)
        df_actual = f_new - state.f
        pred_ok = torch.abs(df_pred) > cfg.pred_min
        ratio = torch.where(
            pred_ok, df_actual / torch.where(pred_ok, df_pred, 1.0), 1.0
        )
        # an uninitialized Hessian gives no meaningful prediction
        ratio = torch.where(B_init1, ratio, 1.0)

        # ---- quasi-Newton update with the step secant ----
        dg = g_new - state.g
        S1 = s_full[:, :, None]
        Y1 = dg[:, :, None]
        m1 = (torch.linalg.norm(s_full, dim=1) > 1e-8)[:, None]
        B_boot = bootstrap_B_batched(S1, Y1, m1, cfg.dim)
        B_base = torch.where(B_init1[:, None, None], B1, B_boot)
        B2 = quasi_newton_update_batched(
            B_base, S1, Y1, m1 & act[:, None],
            cfg.eigh_f32, cfg.absb, cfg.update)
        B2 = torch.where((act & m1[:, 0])[:, None, None], B2, B1)
        B_init2 = B_init1 | (act & m1[:, 0])

        # ---- scheduled re-diagonalization at the new point ----
        Ufree_new = basis_fn(x_new)
        if has_ineq:
            c_new = vmap(constraints)(x_new)
            a_new, Ip_new = tang_at(x_new, c_new, g_new, Ufree_new)
        else:
            c_new = a_new = Ip_new = None
        if sel is None:
            B3, B_init3, k_ev = _diag_at(
                cell_t, x_new, g_new, B2, B_init2, Ufree_new, served,
                generator, a_new, Ip_new,
            )
            nmv = nmv + torch.where(served, k_ev, 0)
        else:
            # run Davidson only on the compacted sub-batch, then scatter
            # back out of place (the input state stays untouched)
            ev_g = ev[sel]
            B_g, B_init_g, k_g = _diag_at(
                cell_t, x_new[sel], g_new[sel], B2[sel], B_init2[sel],
                Ufree_new[sel], ev_g, generator,
                None if a_new is None else a_new[sel],
                None if Ip_new is None else Ip_new[sel],
            )
            B3 = B2.clone()
            B3[sel] = torch.where(ev_g[:, None, None], B_g, B2[sel])
            B_init3 = B_init2.clone()
            B_init3[sel] = B_init2[sel] | ev_g
            k_full = torch.zeros_like(nmv)
            k_full[sel] = torch.where(ev_g, k_g, 0)
            nmv = nmv + k_full

        # ---- trust radius update (``optimize.py:412-432``) ----
        bad = (ratio < 1.0 / cfg.rho_dec) | (ratio > cfg.rho_dec)
        good = (1.0 / cfg.rho_inc < ratio) & (ratio < cfg.rho_inc)
        delta_new = torch.where(
            bad,
            torch.clamp(smag * cfg.sigma_dec, min=cfg.delta_min),
            torch.where(
                good,
                torch.maximum(cfg.sigma_inc * smag, state.delta),
                state.delta,
            ),
        )
        # no meaningful prediction without an initialized Hessian: the
        # reference SKIPS the trust update
        delta_new = torch.where(act & B_init1, delta_new, state.delta)

        # ---- convergence: max projected per-atom force ----
        gfree_new = _bmtv(Ufree_new, g_new)
        if has_ineq:
            gfree_new = _bmv(Ip_new, gfree_new)
        gp = _bmv(Ufree_new, gfree_new)
        fmax_now = torch.amax(
            torch.linalg.norm(gp.reshape(Bsz, cfg.natoms, 3), dim=2), dim=1
        )
        conv_now = fmax_now < state.fmax_t
        if has_ineq:
            eqm, ltm, _ = comparator_masks(dev)
            viol = torch.where(eqm, torch.abs(c_new),
                               torch.where(ltm, c_new, -c_new))
            conv_now = conv_now & (torch.amax(viol, dim=1) < cfg.ctol)
        elif cons_jac is not None:
            c_new = vmap(constraints)(x_new)
            conv_now = conv_now & (
                torch.amax(torch.abs(c_new), dim=1) < cfg.ctol)
        if inertia_ok is not None:
            conv_now = conv_now & inertia_ok
        audit_fail = None
        if audit:
            # exact-curvature audit of the claimed leftmost mode at the
            # new geometry: at a genuine index-1 point it is strongly
            # negative, on a flat dissociated plateau ~0 or positive.
            # One exact HVP, only on steps where some lane newly meets
            # the force criterion.
            newly = act & conv_now
            if bool(newly.any()):
                v_aud = _bmv(Ufree, prep[1][:, :, 0])
                c_aud = torch.einsum("bi,bi->b", v_aud,
                                     hvp_audit(x_new, v_aud))
            else:
                c_aud = torch.full((Bsz,), -torch.inf, dtype=dtype,
                                   device=dev)
            audit_ok = c_aud < -cfg.conv_curv_min
            conv_now = conv_now & audit_ok
            # a rejected lane is done-but-wrong (forces under the
            # criterion, further steps ~zero): restart it now
            audit_fail = newly & ~audit_ok
            nmv = nmv + newly.to(torch.int32)
        conv_new = state.converged | (act & conv_now)

        # ---- stagnation restart (no reference analog; see config) ----
        improved = fmax_now < 0.97 * state.best_fmax
        best2 = torch.where(act & improved, fmax_now, state.best_fmax)
        stall2 = torch.where(act & ~improved, state.stall + 1, 0).to(
            torch.int32)
        x_fin, f_fin, g_fin = x_new, f_new, g_new
        nrst = state.nrestarts
        # the machinery also serves the audit's rejections, which restart
        # even with the stagnation restart off (restart_after = 0)
        if cfg.restart_after > 0 or audit_fail is not None:
            if cfg.restart_after > 0:
                restart = act & ~conv_new & (stall2 >= cfg.restart_after)
            else:
                restart = torch.zeros(Bsz, dtype=torch.bool, device=dev)
            if audit_fail is not None:
                restart = restart | (audit_fail & ~conv_new)
            if cfg.dmax_restart > 0:
                # a cluster whose max pair distance exceeds the threshold
                # has dissociated onto flat landscape: restart it now
                pos_b = x_new.reshape(Bsz, cfg.natoms, 3)
                dvec = pos_b[:, :, None, :] - pos_b[:, None, :, :]
                dmax = torch.sqrt(torch.amax(
                    torch.sum(dvec * dvec, dim=-1), dim=(1, 2)))
                restart = restart | (
                    act & ~conv_new & (dmax > cfg.dmax_restart))
            if bool(restart.any()):
                # from the PRISTINE start plus a kick whose stddev grows
                # with the attempt count, capped at 3x (an uncapped kick
                # eventually exceeds the bond length). The kick is drawn
                # only here, so runs without restarts keep the generator
                # stream of the Davidson draws unchanged.
                scale = cfg.restart_kick * torch.clamp(
                    1.0 + 0.5 * state.nrestarts.to(dtype), max=3.0)
                kick = scale[:, None] * torch.randn(
                    x_new.shape, generator=generator, dtype=dtype,
                    device=dev)
                x_fin = torch.where(restart[:, None], state.x_home + kick,
                                    x_new)
                f_k, g_k = eval_fn(x_fin)
                f_fin = torch.where(restart, f_k, f_new)
                g_fin = torch.where(restart[:, None], g_k, g_new)
                neval = neval + restart.to(torch.int32)
                # reset curvature to the identity but KEEP B_init: the
                # wrong-inertia trigger then requests a re-diag through
                # the budget-compacted path instead of a full-batch
                # bootstrap Davidson
                eye_d = torch.eye(cfg.dim, dtype=dtype, device=dev)[None]
                B3 = torch.where(restart[:, None, None], eye_d, B3)
                nsd = torch.where(restart, cfg.nsteps_per_diag, nsd).to(
                    torch.int32)
                delta_new = torch.where(restart, cfg.delta0, delta_new)
                best2 = torch.where(restart, torch.inf, best2)
                stall2 = torch.where(restart, 0, stall2).to(torch.int32)
                nrst = nrst + restart.to(torch.int32)

        return SearchState(
            x=torch.where(act[:, None], x_fin, state.x),
            f=torch.where(act, f_fin, state.f),
            g=torch.where(act[:, None], g_fin, state.g),
            B=B3,
            B_init=B_init3,
            delta=delta_new,
            rho=torch.where(act, ratio, state.rho),
            nsteps_since_diag=nsd,
            converged=conv_new,
            nsteps=state.nsteps + act.to(torch.int32),
            neval=neval,
            nmatvec=nmv,
            best_fmax=best2,
            stall=stall2,
            nrestarts=nrst,
            x_home=state.x_home,
            fmax_t=state.fmax_t,
        )

    return step


def run_ensemble(
    potential,
    x0: torch.Tensor,
    cfg: EnsembleConfig,
    max_steps: int = 100,
    cell=None,
    mesh=None,
    seed: int = 0,
    steps_per_call: int = 1,
    constraints=None,
    comparators=None,
    device=None,
):
    """Host loop driving the batched step until all searches converge (or
    max_steps). The state lives on ``x0``'s device when ``x0`` is a
    tensor; any other ``x0`` goes to ``device``, by default the GPU, and
    raises where there is none (``device="cpu"`` asks for the CPU).
    Convergence is checked every ``steps_per_call`` steps (one host sync
    each)."""
    if mesh is not None:
        raise NotImplementedError(
            "run_ensemble(mesh=...) is not ported to sella_tpu_torch yet "
            "(ROADMAP.md)"
        )
    step = make_step_fn(potential, cfg, cell, constraints=constraints,
                        comparators=comparators)
    x0 = _place_x0(x0, device)
    state = init_state(potential, x0, cfg, cell)
    generator = torch.Generator(device=x0.device)
    generator.manual_seed(seed)
    n_calls = (max_steps + steps_per_call - 1) // steps_per_call
    for _ in range(n_calls):
        for _ in range(steps_per_call):
            state = step(state, generator)
        if bool(torch.all(state.converged)):
            break
    return state


# ---------------------------------------------------------------------------
# Work queue: refill converged lanes from a queue of starts
# ---------------------------------------------------------------------------
def refill_converged(state: SearchState, x_new: torch.Tensor,
                     avail: torch.Tensor, cfg: EnsembleConfig,
                     inherit_B: bool = False):
    """Replace converged lanes with fresh starts from a work queue.

    ``x_new``: (B, d) replacement geometries; ``avail``: (B,) bool — which
    rows of x_new hold real work. A lane is refilled when it is converged
    AND its replacement is available; refilled lanes are fully reset
    (fresh identity Hessian, trust radius, counters; f and g zeroed until
    :func:`refresh_fg`). Returns the new state and the refill mask.

    ``inherit_B=True`` keeps the lane's converged quasi-Newton Hessian as
    the fresh search's initial one (B_init stays True, so no bootstrap
    Davidson runs): a good warm start when the queue holds perturbations
    of one structure, a bad one for unrelated structures."""
    take = state.converged & avail
    tk = take[:, None]
    d = cfg.dim
    Bsz = state.x.shape[0]
    dev = state.x.device
    i32 = torch.int32
    if inherit_B:
        B, B_init = state.B, state.B_init | take
    else:
        eye = torch.eye(d, dtype=state.B.dtype, device=dev).expand(Bsz, d, d)
        B = torch.where(take[:, None, None], eye, state.B)
        B_init = state.B_init & ~take
    new_state = SearchState(
        x=torch.where(tk, x_new, state.x),
        f=torch.where(take, 0.0, state.f),
        g=torch.where(tk, 0.0, state.g),
        B=B,
        B_init=B_init,
        delta=torch.where(take, cfg.delta0, state.delta),
        rho=torch.where(take, 1.0, state.rho),
        nsteps_since_diag=torch.where(take, 0, state.nsteps_since_diag).to(
            i32),
        converged=state.converged & ~take,
        nsteps=torch.where(take, 0, state.nsteps).to(i32),
        neval=torch.where(take, 0, state.neval).to(i32),
        nmatvec=torch.where(take, 0, state.nmatvec).to(i32),
        best_fmax=torch.where(take, torch.inf, state.best_fmax),
        stall=torch.where(take, 0, state.stall).to(i32),
        nrestarts=torch.where(take, 0, state.nrestarts).to(i32),
        x_home=torch.where(tk, x_new, state.x_home),
        fmax_t=state.fmax_t,
    )
    return new_state, take


def refresh_fg(state: SearchState, potential, cfg: EnsembleConfig,
               cell=None, mask: Optional[torch.Tensor] = None
               ) -> SearchState:
    """Recompute (f, g) for all lanes — call once after a refill.

    ``mask`` marks the lanes whose geometry actually changed (the refill
    mask): only those lanes' neval counters advance, so per-search force
    accounting stays exact."""
    f, g = _batched_eval(potential, _as_cell(cell, state.x),
                         cfg.eval_chunk)(state.x)
    inc = 1 if mask is None else mask.to(state.neval.dtype)
    return state._replace(f=f, g=g, neval=state.neval + inc)


def make_queue_fns(potential, cfg: EnsembleConfig, cell=None,
                   constraints=None, comparators=None,
                   refill_every: int = 10, inherit_B: bool = False):
    """The ``(step_chunk, refill, refresh, snapshot)`` 4-tuple for
    :func:`run_ensemble_queue` — build once, pass to every call that
    shares the config. ``refill_every`` must match the queue call.

    * ``step_chunk(state, generator)`` runs ``refill_every`` steps;
    * ``refill(state, x_new, avail)`` is :func:`refill_converged`;
    * ``refresh(state, mask)`` recomputes (f, g) with an eval function
      built once (per device) and advances ``neval`` on ``mask``;
    * ``snapshot(state)`` packs ``converged``, ``nsteps``, ``f``,
      ``nmatvec``, ``neval`` and ``x`` into one float64 buffer and
      returns it on the host: one device-to-host copy per harvest cycle
      (the counters are exact in float64 below 2^53)."""
    step1 = make_step_fn(potential, cfg, cell, constraints=constraints,
                         comparators=comparators)

    def step_chunk(state, generator=None):
        for _ in range(refill_every):
            state = step1(state, generator)
        return state

    def refill(state, x_new, avail):
        return refill_converged(state, x_new, avail, cfg,
                                inherit_B=inherit_B)

    evals = {}

    def refresh(state, mask):
        dev = state.x.device
        if dev not in evals:
            evals[dev] = _batched_eval(potential, _as_cell(cell, state.x),
                                       cfg.eval_chunk)
        f, g = evals[dev](state.x)
        return state._replace(
            f=f, g=g, neval=state.neval + mask.to(state.neval.dtype))

    def snapshot(state):
        dt = state.x.dtype
        return torch.cat([
            state.converged.to(dt),
            state.nsteps.to(dt),
            state.f.to(dt),
            state.nmatvec.to(dt),
            state.neval.to(dt),
            state.x.reshape(-1),
        ]).cpu().numpy()

    return step_chunk, refill, refresh, snapshot


def run_ensemble_queue(
    potential,
    x0_all,
    cfg: EnsembleConfig,
    batch: int,
    max_steps_per_search: int = 300,
    cell=None,
    refill_every: int = 10,
    seed: int = 0,
    constraints=None,
    comparators=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    fns=None,
    inherit_B: bool = False,
    max_retries: int = 0,
    retry_kick: float = 0.3,
    retry_step_growth: float = 0.0,
    retry_step_cap: Optional[int] = None,
    mesh=None,
    drain_handoff: int = 0,
    device=None,
):
    """Process an arbitrarily large work set with a fixed device batch.

    Converged searches are harvested every ``refill_every`` steps and
    their lanes refilled from the queue, so no lane idles on a finished
    search. Returns one ``(x_final, f, nsteps, converged, nmatvec,
    neval)`` tuple per input, in input order. The searches run on
    ``x0_all``'s device when it is a tensor; any other ``x0_all`` goes to
    ``device``, by default the GPU, and raises where there is none
    (``device="cpu"`` asks for the CPU).

    ``max_retries``: a search that times out unconverged is re-enqueued
    (up to this many times) from its ORIGINAL geometry plus a kick of
    stddev ``sqrt(attempt) * retry_kick`` per DOF, drawn from a numpy
    ``RandomState`` (so retry starts are the JAX package's exactly).
    Retried searches report cumulative counts over all attempts.
    ``retry_step_growth``: attempt ``k`` (0 = first try) gets a budget of
    ``max_steps_per_search * (1 + growth * k)`` steps, capped at
    ``retry_step_cap`` if given.

    ``checkpoint_path``: the state plus the host bookkeeping (lane->input
    map, queue cursor, results, retries, the step counter and the
    generator's state) is saved every ``checkpoint_every`` harvest
    cycles; ``resume=True`` continues from an existing checkpoint.

    ``fns``: the 4-tuple of :func:`make_queue_fns`, to reuse across calls.
    ``inherit_B``: see :func:`refill_converged`.

    ``drain_handoff``: once the queue is exhausted (no fresh inputs, no
    pending retries) and at most this many unconverged lanes remain,
    return them at once as UNCONVERGED results with their cumulative
    cost and current geometry, for the caller to finish in a smaller
    batch. ``mesh=`` is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "run_ensemble_queue(mesh=...) is not ported to sella_tpu_torch "
            "yet (ROADMAP.md)"
        )
    dev = _target_device(x0_all, device)
    x0_np = (x0_all.detach().cpu().numpy() if isinstance(x0_all, torch.Tensor)
             else np.asarray(x0_all))   # host copy: refills slice it
    total = x0_np.shape[0]
    # a work set smaller than the device batch: clamp
    batch = min(batch, total)
    if fns is None:
        fns = make_queue_fns(potential, cfg, cell,
                             constraints=constraints,
                             comparators=comparators,
                             refill_every=refill_every,
                             inherit_B=inherit_B)
    step_chunk, refill, refresh, snapshot = fns

    loaded = None
    if checkpoint_path is not None and resume:
        import os

        from .checkpoint import load_queue

        if os.path.exists(checkpoint_path):
            loaded = load_queue(
                checkpoint_path, SearchState, with_retry_state=True,
                fmax_default=cfg.fmax, device=dev,
            )
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    it0 = 0
    if loaded is not None:
        state, origin, next_idx, results, retry_state = loaded
        retries = retry_state["retries"]
        pending = retry_state["pending"]   # (origin_idx, x_start) FIFO
        spent = retry_state["spent"]       # origin -> (ns, nmv, nev)
        # continue the random streams where the interrupted run left
        # them instead of replaying kicks and probes already used
        it0 = retry_state["it"]
        if retry_state["rng_state"] is not None:
            generator.set_state(retry_state["rng_state"].cpu())
    else:
        state = init_state(potential, torch.as_tensor(x0_np[:batch],
                                                      device=dev), cfg, cell)
        origin = np.arange(batch)          # which input each lane holds
        next_idx = batch
        results = {}
        retries = {}
        pending = []
        spent = {}
    kick_rng = np.random.RandomState(((seed ^ 0x5EED) + it0) % 2**32)

    def save():
        from .checkpoint import save_queue

        save_queue(
            checkpoint_path, state, origin, next_idx, results,
            retry_state=dict(pending=pending, retries=retries, spent=spent),
            it=it, rng_state=generator.get_state(),
        )

    cycle = 0
    it = it0
    while len(results) < total:
        state = step_chunk(state, generator)
        it += refill_every

        buf = snapshot(state)                  # one device->host copy
        Bsz = state.x.shape[0]
        conv = buf[0:Bsz] != 0.0
        nsteps = buf[Bsz:2 * Bsz].astype(np.int64)
        fs = buf[2 * Bsz:3 * Bsz]
        nmv = buf[3 * Bsz:4 * Bsz].astype(np.int64)
        nev = buf[4 * Bsz:5 * Bsz].astype(np.int64)
        xs = buf[5 * Bsz:].reshape(Bsz, -1)
        if max_retries and retry_step_growth:
            budgets = np.asarray([
                max_steps_per_search
                * (1.0 + retry_step_growth * retries.get(int(o), 0))
                for o in origin
            ])
            if retry_step_cap is not None:
                budgets = np.minimum(budgets, retry_step_cap)
            done = conv | (nsteps >= budgets)
        else:
            done = conv | (nsteps >= max_steps_per_search)
        if not np.any(done):
            continue
        for lane in np.where(done)[0]:
            oi = int(origin[lane])
            if oi < 0 or oi in results:
                continue
            s0, m0, e0 = spent.get(oi, (0, 0, 0))
            if (not conv[lane]) and retries.get(oi, 0) < max_retries:
                # timed out: back of the queue, from the ORIGINAL
                # geometry plus a kick with sqrt growth in the attempt
                # (a linear one passes the bond length in a few attempts)
                attempt = retries.get(oi, 0) + 1
                retries[oi] = attempt
                spent[oi] = (s0 + int(nsteps[lane]),
                             m0 + int(nmv[lane]), e0 + int(nev[lane]))
                pending.append((
                    oi,
                    x0_np[oi]
                    + np.sqrt(attempt) * retry_kick * kick_rng.normal(
                        size=xs[lane].shape
                    ),
                ))
                continue
            results[oi] = (
                xs[lane].copy(), float(fs[lane]),
                s0 + int(nsteps[lane]), bool(conv[lane]),
                m0 + int(nmv[lane]), e0 + int(nev[lane]),
            )

        if drain_handoff and next_idx >= total and not pending:
            # queue exhausted and nothing awaiting retry: hand the last
            # few unconverged lanes back. This runs BEFORE the refill
            # below, so every active lane's snapshot row is its own
            # (after a refill a lane could hold a new occupant with the
            # previous occupant's stale row)
            active = [
                lane for lane in range(Bsz)
                if origin[lane] >= 0 and int(origin[lane]) not in results
            ]
            if len(active) <= drain_handoff:
                for lane in active:
                    oi = int(origin[lane])
                    s0, m0, e0 = spent.get(oi, (0, 0, 0))
                    results[oi] = (
                        xs[lane].copy(), float(fs[lane]),
                        s0 + int(nsteps[lane]), False,
                        m0 + int(nmv[lane]), e0 + int(nev[lane]),
                    )
                if checkpoint_path is not None:
                    # the break skips the end-of-cycle save: persist the
                    # handed-off results, or a resume would replay the
                    # drain this handoff skipped
                    save()
                break

        # refill from the queue (timed-out lanes are marked converged so
        # the refill mask picks them up too): retried jobs first, then
        # fresh inputs; the geometries go to the device in one copy
        done_t = torch.as_tensor(done, device=dev)
        state = state._replace(converged=done_t)
        x_new = np.zeros((batch, cfg.dim))
        avail = np.zeros(batch, dtype=bool)
        new_origin = origin.copy()
        for lane in np.where(done)[0]:
            if pending:
                oi, xstart = pending.pop(0)
                x_new[lane] = xstart
                avail[lane] = True
                new_origin[lane] = oi
            elif next_idx < total:
                x_new[lane] = x0_np[next_idx]
                avail[lane] = True
                new_origin[lane] = next_idx
                next_idx += 1
            else:
                new_origin[lane] = -1  # idle lane
        origin = new_origin

        if np.any(avail):
            avail_t = torch.as_tensor(avail, device=dev)
            state, _ = refill(state, torch.as_tensor(x_new, device=dev),
                              avail_t)
            state = refresh(state, avail_t)
        # else: queue drained — refill would be a no-op and refresh would
        # re-pay a full-batch force evaluation for identical (f, g).
        # Idle lanes stay marked converged so they are skipped.
        state = state._replace(
            converged=state.converged | torch.as_tensor(origin < 0,
                                                        device=dev))

        cycle += 1
        if checkpoint_path is not None and cycle % checkpoint_every == 0:
            save()

    return [results[i] for i in range(total)]
