"""Batched ensemble saddle search in redundant internal coordinates.

Counterpart of ``sella_tpu/parallel/ensemble_internal.py``: a Lindh-style
guess Hessian, P-RFO steps taken in the nonredundant internal subspace
with the weighted max-internal-step (``mis``) trust norm, and a masked
Newton back-transform realizing each internal step in Cartesian space,
for every lane of the ensemble at once.

* ONE union topology layout, shared by every lane, with per-lane
  coordinate-activity rows (``state.qact``). It is built host-side by
  :class:`~sella_tpu_torch.coords.internals.Internals`; its torch engine
  evaluates q/B/dB and ``torch.func.vmap`` batches it over lanes. A lane
  whose coordinates go singular is repaved in place
  (:func:`repave_lanes`); when the union grows, the step function is
  rebuilt (eager torch compiles nothing).
* The nonredundant subspace comes from one batched eigh of the Gram
  matrix G = B B^T (``batched_eigh(G, "robust")``: float64 on every
  device), which also gives every pseudo-inverse application.
* The Davidson operator is the exact internal-coordinate Lagrangian
  Hessian action ``W v = G^+ B (H_x u - dB[u]^T g_q)``, ``u = B^T G^+ v``:
  one potential HVP plus one Jacobian-JVP per matvec.
* ``set_x`` is a masked Newton iteration on q(x) = q_target with
  dihedral residuals wrapped and best-iterate tracking; lanes above
  ``newton_accept`` re-run from a fixed-substep RK4 geodesic initializer
  followed by a Newton polish.
* Dummy atoms and fixed internal coordinates reduce to linear
  constraints in q-space (the constrained free subspace is a complete-QR
  split of range(B)); the Newton back-transform pins the constrained
  components of the target.

The JAX package's structured control flow becomes host control flow, as
in :mod:`.ensemble`: the Newton ``lax.while_loop`` is a Python loop that
tests ``any(~done)`` (every iteration off the card, every 4 on it; the
iteration count never passes ``newton_maxiter``, and a finished lane
keeps its x, so the cadence changes no result), and each
``lax.cond(jnp.any(..))`` (the chord polish, the geodesic fallback, the
scheduled Davidson, the prep reuse, the restart re-evaluation) is one
host test. Random draws (the Davidson dead-vector restart, the restart
kick) come from a ``torch.Generator``. Not ported: sharding over a mesh
(``mesh=`` raises).
"""
from __future__ import annotations

import contextlib
import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, grad_and_value, jvp, vmap

from ..config import default_dtype
from ..ops.linalg import batched_eigh
from .ensemble import (
    _as_cell,
    _bmtv,
    _bmv,
    _check_potential_device,
    _davidson_loop,
    _masked_ritz,
    _place_x0,
    free_basis,
    prfo_prepare_batched,
    restricted_step_batched,
    ts_bfgs_update_batched,
)


# Optional span timing of the step's parts: when a caller sets
# ``SPANS`` to a dict, :func:`_span` records a pair of CUDA events per
# entry into a named region under that name (``"gram"``: every Gram eigh;
# ``"newton"``: the whole back-transform, of which ``"geodesic"`` is the
# fallback with its polish; ``"davidson"``: the scheduled
# diagonalization; ``"restricted"``: the trust-region step; the
# internal+cell tier records ``"gram"``, ``"newton"`` and ``"restricted"``
# too, and the IRC tier ``"irc_eigh"``, its eighs); ``None`` (the
# default) costs one test.
SPANS = None


class _Span:
    __slots__ = ("name", "ev")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.ev = torch.cuda.Event(enable_timing=True)
        self.ev.record()

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        SPANS.setdefault(self.name, []).append((self.ev, end))


def _span(name: str, x: torch.Tensor):
    """A timing region on ``x``'s CUDA device when :data:`SPANS` is set."""
    if SPANS is None or x.device.type != "cuda":
        return contextlib.nullcontext()
    return _Span(name)


def span_ms(spans: dict) -> dict:
    """Total milliseconds per region of a filled :data:`SPANS` dict
    (synchronizes the device)."""
    torch.cuda.synchronize()
    return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}


class InternalEnsembleConfig(NamedTuple):
    """Static configuration of a batched internal search (field names,
    defaults and meanings as in ``sella_tpu.parallel.ensemble_internal.
    InternalEnsembleConfig``).

    ``natoms`` counts REAL atoms; ``ndummies`` extends the DOF vector
    with dummy-atom coordinates (linear-center dummies from
    :class:`Internals`); ``ncons`` is the number of fixed internal
    coordinates."""

    natoms: int
    nint: int                      # number of internal coordinates
    order: int = 1
    nproj: int = 6                 # rigid modes absent from range(B)
    ndummies: int = 0              # dummy atoms appended to the DOF
    ncons: int = 0                 # fixed internal coordinates
    fmax: float = 1e-3
    gamma: float = 0.1
    delta0: float = 0.1
    delta_min: float = 1e-4
    sigma_inc: float = 1.15
    sigma_dec: float = 0.65
    rho_inc: float = 1.035
    rho_dec: float = 5.0
    nsteps_per_diag: int = 3
    diag_every_n: int = 0
    davidson_max: int = 0
    rs_maxiter: int = 18
    rs_tol: float = 1e-8
    method: str = "prfo"
    rs: str = "mis"                # fixed: weighted max internal step
    eig: bool = True
    newton_maxiter: int = 20
    newton_tol: float = 1e-10
    newton_accept: float = 1e-6    # residual above this after Newton
    #   engages the geodesic fallback
    davidson_seed: str = "grad"    # Davidson start vector: "grad" or
    #   "pmode" (leftmost eigenvector of the projected preconditioner)
    newton_chord: bool = False     # chord back-transform: reuse the
    #   step-start B/Gram factorization for every Newton iteration;
    #   lanes above the accept gate get a full-Newton polish, then the
    #   geodesic
    newton_stop: str = "inf"       # Newton stop metric: "inf"
    #   (max|r| < newton_tol) or "rms" (|r|_2/sqrt(n_active) < newton_tol)
    geo_substeps: int = 16         # RK4 substeps of the geodesic
    #   fallback integrator (0 disables the fallback)
    restart_after: int = 0         # stagnation restart (0 = disabled)
    restart_kick: float = 0.25     # kick stddev per real-atom DOF
    eigh_f32: bool = False         # f32 P-RFO prep + TS-BFGS |B| eighs
    absb: str = "eigh"             # TS-BFGS |B| metric: "eigh" or "ns"
    # mis weights per coordinate kind (``restricted_step.py:186-243``)
    wx: float = 1.0                # translations
    wb: float = 1.0                # bonds
    wa: float = 1.0                # angles
    wd: float = 1.0                # dihedrals
    wo: float = 1.0                # user coords / rotations
    pred_min: float = 1e-14        # smallest trusted |predicted dE|

    @property
    def dim(self) -> int:
        return 3 * (self.natoms + self.ndummies)

    @property
    def nred(self) -> int:
        """Width of range(B) — the nonredundant subspace."""
        return self.dim - self.nproj

    @property
    def nfree(self) -> int:
        """Width of the constrained free subspace."""
        return self.nred - self.ncons

    @property
    def subspace_max(self) -> int:
        m = self.nfree
        k = self.davidson_max if self.davidson_max > 0 else 2 * m + 1
        return min(m, k)


class InternalSearchState(NamedTuple):
    """Per-search state; every field has a leading batch axis."""

    x: torch.Tensor           # (B, 3n) Cartesian positions
    q: torch.Tensor           # (B, nint) internal values (continuous)
    f: torch.Tensor           # (B,)
    g: torch.Tensor           # (B, 3n) Cartesian gradient
    gq: torch.Tensor          # (B, nint) internal gradient B^+T g
    H: torch.Tensor           # (B, nint, nint) quasi-Newton Hessian
    delta: torch.Tensor       # (B,) trust radius (mis norm)
    rho: torch.Tensor
    nsteps_since_diag: torch.Tensor
    converged: torch.Tensor
    nsteps: torch.Tensor
    neval: torch.Tensor
    nmatvec: torch.Tensor
    best_fmax: torch.Tensor   # (B,) best fmax since the last restart
    stall: torch.Tensor       # (B,) int32 steps since best_fmax improved
    nrestarts: torch.Tensor   # (B,) int32 stagnation restarts taken
    x_home: torch.Tensor      # (B, 3n) pristine start (restart anchor)
    qact: torch.Tensor        # (B, nint) bool per-lane coordinate
    #   activity inside the shared union layout (all True until a
    #   repave, :func:`repave_lanes`)


def _kind_weights(ints, cfg: InternalEnsembleConfig) -> np.ndarray:
    return np.concatenate([
        np.full(ints.ntrans, cfg.wx),
        np.full(ints.nbonds, cfg.wb),
        np.full(ints.nangles, cfg.wa),
        np.full(ints.ndihedrals, cfg.wd),
        np.full(ints.nother, cfg.wo),
        np.full(ints.nrotations, cfg.wo),
    ])


def _dihedral_mask(ints) -> np.ndarray:
    m = np.zeros(ints.nint, dtype=bool)
    a0 = ints.ntrans + ints.nbonds + ints.nangles
    m[a0:a0 + ints.ndihedrals] = True
    return m


def fixed_internal_constraints(ints):
    """Map every equality constraint of ``ints.cons`` onto its member
    coordinate in the q-vector. Returns ``(idx, targets)`` int/float
    arrays of length ncons; raises ``ValueError`` for a constraint with
    no q-vector member or a non-equality comparator."""
    idx, targets = [], []
    off_b = ints.ntrans
    off_a = off_b + ints.nbonds
    off_d = off_a + ints.nangles

    def _nc_eq(a, b):
        return np.array_equal(np.asarray(a), np.asarray(b))

    for rec in ints.cons._iter_records(only_active=False):
        if rec.comparator != "eq":
            raise ValueError(
                "batched tier supports equality constraints only "
                f"(got {rec.comparator} {rec.kind})"
            )
        found = None
        ii = [int(v) for v in np.atleast_1d(rec.indices)]
        nc = rec.ncvecs
        if rec.kind == "bond":
            z = np.zeros((1, 3)) if nc is None else nc
            for m, (i, j, bnc) in enumerate(ints.bonds):
                if [i, j] == ii and _nc_eq(bnc, z[0]):
                    found = off_b + m
                elif [j, i] == ii and _nc_eq(-bnc, z[0]):
                    found = off_b + m
                if found is not None:
                    break
        elif rec.kind == "angle":
            z = np.zeros((2, 3)) if nc is None else nc
            for m, (i, j, k, anc) in enumerate(ints.angles):
                if [i, j, k] == ii and _nc_eq(anc, z):
                    found = off_a + m
                # reversed record: offsets negate AND reverse
                elif [k, j, i] == ii and _nc_eq(-anc[::-1], z):
                    found = off_a + m
                if found is not None:
                    break
        elif rec.kind == "dihedral":
            z = np.zeros((3, 3)) if nc is None else nc
            for m, (i, j, k, l, dnc) in enumerate(ints.dihedrals):
                if [i, j, k, l] == ii and _nc_eq(dnc, z):
                    found = off_d + m
                elif [l, k, j, i] == ii and _nc_eq(-dnc[::-1], z):
                    found = off_d + m
                if found is not None:
                    break
        elif rec.kind == "translation":
            for m, (tind, tax) in enumerate(zip(ints.trans,
                                                ints.trans_axes)):
                if tax == rec.axis and len(tind) == len(ii) and \
                        np.array_equal(np.sort(tind), np.sort(ii)):
                    found = m
                    break
        else:
            raise ValueError(
                f"batched tier cannot map a {rec.kind} constraint "
                "onto the q-vector"
            )
        if found is None:
            raise ValueError(
                f"constraint {rec.kind}{ii} has no matching internal "
                "coordinate; add it to the Internals first"
            )
        idx.append(found)
        targets.append(float(rec.target))
    return (np.asarray(idx, dtype=np.int64),
            np.asarray(targets, dtype=np.float64))


def extend_with_dummies(ints, x0: torch.Tensor) -> torch.Tensor:
    """Append per-lane dummy-atom coordinates to a (B, 3*natoms) batch:
    each lane's dummy sits at its center atom plus the base geometry's
    center->dummy offset (the first Newton back-transform snaps it onto
    its constraints)."""
    nd = ints.ndummies
    if nd == 0:
        return x0
    n = ints.natoms
    centers = np.full(nd, -1, dtype=np.int64)
    for j, dind in enumerate(np.asarray(ints.dinds)):
        if dind >= 0:
            centers[int(dind) - n] = j
    if np.any(centers < 0):
        raise ValueError("dummy atom with no recorded center")
    offsets = ints.dummies.positions - ints.atoms.positions[centers]
    pos = x0.reshape(x0.shape[0], n, 3)
    dpos = pos[:, torch.as_tensor(centers, device=x0.device), :] + \
        torch.as_tensor(offsets, dtype=x0.dtype, device=x0.device)[None]
    return torch.cat([pos, dpos], dim=1).reshape(x0.shape[0], 3 * (n + nd))


def _gram_pinv(Bm: torch.Tensor, nfree: int):
    """Batched eigh of G = B B^T: returns (apply_pinv, Ufree_q). The top
    ``nfree`` eigenvectors span range(B); thresholded inverse eigenvalues
    give the pseudo-inverse application. G is singular with a zero
    eigenvalue of multiplicity nint - nred: ``batched_eigh(G, "robust")``
    (float64)."""
    with _span("gram", Bm):
        return _gram_pinv_impl(Bm, nfree)


def _gram_pinv_impl(Bm: torch.Tensor, nfree: int):
    G = Bm @ Bm.transpose(1, 2)
    # a lane whose geometry went non-finite (a diverged geodesic or
    # Newton trial) gets NaN eigenpairs, as XLA's eigh returns them;
    # LAPACK and cuSOLVER would raise for the whole batch instead
    finite = torch.isfinite(G).all(dim=2).all(dim=1)
    eye = torch.eye(G.shape[1], dtype=G.dtype, device=G.device)
    lams, V = batched_eigh(torch.where(finite[:, None, None], G, eye),
                           "robust")
    lams = torch.where(finite[:, None], lams, torch.nan)
    V = torch.where(finite[:, None, None], V, torch.nan)
    lmax = torch.clamp(lams[:, -1:], min=1e-300)
    keep = lams > 1e-10 * lmax
    inv = torch.where(keep, 1.0 / torch.where(keep, lams, 1.0), 0.0)

    def apply_pinv(x):
        return _bmv(V, inv * _bmtv(V, x))

    Ufree_q = V[:, :, -nfree:]
    return apply_pinv, Ufree_q


def _split_fixed(Ured: torch.Tensor, cons_idx: torch.Tensor,
                 ncons: int) -> torch.Tensor:
    """Constrained free subspace: the orthogonal complement, inside
    range(B), of the fixed-coordinate directions (rows ``cons_idx`` of U;
    a complete QR of their transpose gives the free columns)."""
    if ncons == 0:
        return Ured
    if cons_idx.ndim == 2:
        sel = torch.take_along_dim(Ured, cons_idx[:, :, None], dim=1)
        W = sel.transpose(1, 2)                       # (B, nred, nc)
    else:
        W = Ured[:, cons_idx, :].transpose(1, 2)      # (B, nred, nc)
    Q = torch.linalg.qr(W, mode="complete")[0]        # (B, nred, nred)
    return Ured @ Q[:, :, ncons:]


def _batch_fns(engine, n: int, cell_t):
    """(batch_q, batch_B, batch_dB) over lanes (B, 3n) for one engine and
    cell: the engine evaluates a batch of geometries in one call.
    ``batch_dB(x, u, with_B=True)`` returns ``(B, dB[u])`` from one pass."""
    def batch_q(x):
        return engine._calc_impl(x.reshape(-1, n, 3), cell_t)

    def batch_B(x):
        return engine._jac_impl(x.reshape(-1, n, 3), cell_t)

    def batch_dB(x, u, with_B=False):
        B, dB = engine._jac_hrdot_impl(x.reshape(-1, n, 3), cell_t,
                                       u.reshape(-1, n, 3), with_jac=with_B)
        return (B, dB) if with_B else dB

    return batch_q, batch_B, batch_dB


def _batch_eval(potential, cell_t, cfg):
    """(B, 3(n+nd)) -> (f, g) with the potential on the real atoms and
    zero gradient on the dummies."""
    nr3 = 3 * cfg.natoms

    def one(xx):
        g, e = grad_and_value(potential.energy)(xx[:nr3], cell_t)
        return e, g

    ev = vmap(one)

    def run(x):
        f, g = ev(x)
        return f, _pad_dummy(g, cfg)

    return run


def _pad_dummy(g_real, cfg):
    """Zero-pad real-atom gradients/tangents to the extended DOF."""
    if cfg.ndummies == 0:
        return g_real
    pad = torch.zeros(g_real.shape[:-1] + (3 * cfg.ndummies,),
                      dtype=g_real.dtype, device=g_real.device)
    return torch.cat([g_real, pad], dim=-1)


def make_internal_step_fn(potential, ints, cfg: InternalEnsembleConfig,
                          cell=None):
    """Build the batched internal-coordinate RS-P-RFO step
    ``step(state, generator) -> state`` (the input state is never
    modified). ``ints``: a host-side :class:`Internals` defining the
    shared topology, dummy atoms and fixed internal coordinates included
    (``cfg.ndummies``/``cfg.ncons`` must match)."""
    if ints.ndummies != cfg.ndummies:
        raise ValueError(
            f"cfg.ndummies={cfg.ndummies} != topology "
            f"ndummies={ints.ndummies}"
        )
    if ints.nint != cfg.nint:
        raise ValueError(
            f"cfg.nint={cfg.nint} != topology nint={ints.nint}"
        )
    cons_idx_np, cons_target_np = fixed_internal_constraints(ints)
    if len(cons_idx_np) != cfg.ncons:
        raise ValueError(
            f"cfg.ncons={cfg.ncons} != mapped constraints "
            f"{len(cons_idx_np)}"
        )

    engine = ints._get_engine()
    n = cfg.natoms + cfg.ndummies          # extended atom count
    nr3 = 3 * cfg.natoms                   # real-atom DOF
    ncons = cfg.ncons
    dih_np = _dihedral_mask(ints)
    w_mis_np = _kind_weights(ints, cfg)
    # shared Lindh guess — the restart re-bootstrap target
    H_guess_np = ints.guess_hessian()
    K = cfg.subspace_max
    # the cell, the batched functions and the constants, built once per
    # device and dtype (the step learns them from its first state)
    built = {}

    def built_for(x):
        key = (x.device, x.dtype)
        if key not in built:
            cell_t = _as_cell(cell, x)
            f64 = dict(dtype=x.dtype, device=x.device)
            bq, bB, bdB = _batch_fns(engine, n, cell_t)
            built[key] = dict(
                cell=cell_t, batch_q=bq, batch_B=bB, batch_dB=bdB,
                batch_eval=_batch_eval(potential, cell_t, cfg),
                cons_idx=torch.as_tensor(cons_idx_np, device=x.device),
                cons_target=torch.as_tensor(cons_target_np, **f64),
                dih=torch.as_tensor(dih_np, device=x.device),
                w_mis=torch.as_tensor(w_mis_np, **f64),
                H_guess=torch.as_tensor(H_guess_np, **f64),
            )
        return built[key]

    def batch_hvp(c, x, u):
        def one(x1, u1):
            return jvp(lambda y: grad(potential.energy)(y, c["cell"]),
                       (x1[:nr3],), (u1[:nr3],))[1]

        return _pad_dummy(vmap(one)(x, u), cfg)

    def lagrangian_gq(c, gq):
        """Zero the constrained components: the multiplier of a fixed
        internal is exactly its g_q component, and its q-Hessian is zero
        (reference get_Hc, ``peswrapper.py:1011-1031``, specialized to
        member-coordinate constraints)."""
        if ncons == 0:
            return gq
        gq = gq.clone()
        gq[:, c["cons_idx"]] = 0.0
        return gq

    def wrap_dq(c, r):
        """Wrap dihedral components of an internal-space difference into
        (-pi, pi]."""
        wrapped = r - 2 * np.pi * torch.round(r / (2 * np.pi))
        return torch.where(c["dih"][None, :], wrapped, r)

    def mis_norm_for(c):
        w_mis = c["w_mis"]

        def mis_norm(s_full, ds_full):
            """Weighted max-internal-step norm with its analytic alpha
            derivative (``restricted_step.py:186-243``)."""
            ws = w_mis[None, :] * torch.abs(s_full)
            idx = torch.argmax(ws, dim=1)
            b = torch.arange(s_full.shape[0], device=s_full.device)
            val = ws[b, idx]
            sgn = torch.sign(s_full[b, idx])
            dval = w_mis[idx] * sgn * ds_full[b, idx]
            return val, dval

        return mis_norm

    def davidson_absorb(c, x, gq, Bm, apply_pinv, Ufree_q, H, active,
                        generator, P_eig=None):
        """Batched Davidson on the internal-coordinate Lagrangian Hessian;
        every probe pair is absorbed into H (TS-BFGS). ``P_eig``: the
        step's P-RFO prep eigensystem of the identical matrix, reused for
        ``davidson_seed="pmode"``."""
        gLq = lagrangian_gq(c, gq)

        def hvp_free(v_free):
            v_q = _bmv(Ufree_q, v_free)
            u = _bmtv(Bm, apply_pinv(v_q))  # B^+ v
            w_x = batch_hvp(c, x, u)
            # curvilinear correction: - dB[u]^T g_Lq
            dB = c["batch_dB"](x, u)                   # (B, nint, 3n)
            w_x = w_x - _bmtv(dB, gLq)
            w_q = apply_pinv(_bmv(Bm, w_x))
            w_free = _bmtv(Ufree_q, w_q)
            return w_free, w_q

        UT = Ufree_q.transpose(1, 2)
        P = UT @ H @ Ufree_q
        v0 = _bmtv(Ufree_q, gq)
        if cfg.davidson_seed != "pmode":
            P_eig = None
        elif P_eig is None:
            P_eig = batched_eigh(P)
        if P_eig is not None:
            v0 = P_eig[1][:, :, 0]

        V, AVp, YF, k = _davidson_loop(
            hvp_free, P, v0, cfg.gamma, K, active, generator, P_eig=P_eig,
        )
        lams, W, colmask = _masked_ritz(V, AVp, k, K)
        Vr = V @ W
        YFr = YF @ W
        S_full = Ufree_q @ Vr
        H_new = ts_bfgs_update_batched(H, S_full, YFr, colmask,
                                       cfg.eigh_f32, cfg.absb)
        H_out = torch.where(active[:, None, None], H_new, H)
        return H_out, k

    def _pin_target(c, q0, dq_target):
        q_target = q0 + dq_target
        if ncons:
            q_target = q_target.clone()
            q_target[:, c["cons_idx"]] = c["cons_target"][None]
        return q_target

    def _newton_iter(c, x_init, q_target, rows, frozen=None):
        """Masked Newton on q(x) = q_target with best-iterate tracking;
        ``rows`` (B, nint) masks each lane's inactive coordinates out of
        residual and Jacobian. ``frozen``: ``(Bm0, apply_pinv0)`` at the
        step's start geometry — the chord variant. Returns
        (x_best, rinf_best)."""
        batch_q, batch_B = c["batch_q"], c["batch_B"]

        def resid(x):
            return wrap_dq(c, q_target - batch_q(x)) * rows

        n_act = torch.clamp(torch.sum(rows, dim=1), min=1.0)

        def stop_metric(r):
            if cfg.newton_stop == "rms":
                return torch.linalg.norm(r, dim=1) / torch.sqrt(n_act)
            return torch.amax(torch.abs(r), dim=1)

        x = x_init
        x_best = x_init
        r_best = torch.amax(torch.abs(resid(x_init)), dim=1)
        done = torch.zeros(x_init.shape[0], dtype=torch.bool,
                           device=x_init.device)
        # the JAX while_loop tests any(~done) before every iteration;
        # testing every `every` iterations instead only adds no-op
        # iterations (a finished lane keeps x, so r_best/x_best stay)
        every = 4 if x_init.device.type == "cuda" else 1
        it = 0
        while it < cfg.newton_maxiter and bool(torch.any(~done)):
            for _ in range(min(every, cfg.newton_maxiter - it)):
                r = resid(x)
                rinf = torch.amax(torch.abs(r), dim=1)
                better = rinf < r_best
                x_best = torch.where(better[:, None], x, x_best)
                r_best = torch.where(better, rinf, r_best)
                done = done | (stop_metric(r) < cfg.newton_tol)
                if frozen is not None:
                    Bm, apply_pinv = frozen
                else:
                    Bm = batch_B(x) * rows[:, :, None]
                    apply_pinv, _ = _gram_pinv(Bm, cfg.nred)
                dx = _bmtv(Bm, apply_pinv(r))
                x = torch.where(done[:, None], x, x + dx)
                it += 1
        r_fin = resid(x)
        rinf_fin = torch.amax(torch.abs(r_fin), dim=1)
        better = rinf_fin < r_best
        x_best = torch.where(better[:, None], x, x_best)
        return x_best, torch.minimum(rinf_fin, r_best)

    def _geodesic_x(c, x0, q_target, rows):
        """Masked fixed-substep RK4 of the geodesic equation
        ``xdd = -B+ (dB/dx[xd] xd)`` (the reference's ODE move with a
        static substep count): the fallback initializer when Newton fails
        on a large curved step; a Newton polish follows."""
        batch_q, batch_B, batch_dB = c["batch_q"], c["batch_B"], c["batch_dB"]
        dq = wrap_dq(c, q_target - batch_q(x0)) * rows

        def xdot(x, dq_vec):
            Bm = batch_B(x) * rows[:, :, None]
            apply_pinv, _ = _gram_pinv(Bm, cfg.nred)
            return _bmtv(Bm, apply_pinv(dq_vec))

        def rhs(x, xd):
            # curvature term dB/dx[xd] . xd: the rows H_k xd of the
            # masked B's directional derivative, contracted with xd (B
            # and its derivative come from one pass)
            Bx, dB = batch_dB(x, xd, with_B=True)
            curv = _bmv(dB * rows[:, :, None], xd)
            Bm = Bx * rows[:, :, None]
            apply_pinv, _ = _gram_pinv(Bm, cfg.nred)
            xdd = -_bmtv(Bm, apply_pinv(curv))
            return xd, xdd

        nsub = max(int(cfg.geo_substeps), 1)
        h = 1.0 / nsub
        x, xd = x0, xdot(x0, dq)
        for _ in range(nsub):
            k1x, k1v = rhs(x, xd)
            k2x, k2v = rhs(x + 0.5 * h * k1x, xd + 0.5 * h * k1v)
            k3x, k3v = rhs(x + 0.5 * h * k2x, xd + 0.5 * h * k2v)
            k4x, k4v = rhs(x + h * k3x, xd + h * k3v)
            x, xd = (x + (h / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x),
                     xd + (h / 6.0) * (k1v + 2 * k2v + 2 * k3v + k4v))
        return x

    def newton_set_x(c, x0, q0, dq_target, rows, frozen=None):
        """Realize the internal step: x with q(x) = q0 + dq_target (the
        constrained components pinned to their targets). Newton first
        (chord when ``cfg.newton_chord`` and ``frozen`` is given; then a
        full-Newton polish for lanes the chord left above the accept
        gate); lanes still above ``cfg.newton_accept`` re-run from the
        geodesic initializer plus a full-Newton polish. Each fallback
        runs only when some lane needs it."""
        q_target = _pin_target(c, q0, dq_target)
        if not cfg.newton_chord:
            frozen = None
        x_nw, r_nw = _newton_iter(c, x0, q_target, rows, frozen=frozen)

        if frozen is not None:
            miss = r_nw > cfg.newton_accept
            if bool(torch.any(miss)):
                x_pl, r_pl = _newton_iter(c, x_nw, q_target, rows)
                use_pl = miss & (r_pl < r_nw)
                x_nw = torch.where(use_pl[:, None], x_pl, x_nw)
                r_nw = torch.minimum(r_nw, r_pl)

        x_fin = x_nw
        if cfg.geo_substeps > 0:
            fail = r_nw > cfg.newton_accept
            if bool(torch.any(fail)):
                with _span("geodesic", x0):
                    x_geo = _geodesic_x(c, x0, q_target, rows)
                    x_geo, r_geo = _newton_iter(c, x_geo, q_target, rows)
                use_geo = fail & (r_geo < r_nw)
                x_fin = torch.where(use_geo[:, None], x_geo, x_nw)
        dq_real = wrap_dq(c, c["batch_q"](x_fin) - q0) * rows
        return x_fin, dq_real

    def step(state: InternalSearchState,
             generator=None) -> InternalSearchState:
        c = built_for(state.x)
        batch_q, batch_B = c["batch_q"], c["batch_B"]
        cons_idx = c["cons_idx"]
        Bsz = state.x.shape[0]
        dtype, dev = state.x.dtype, state.x.device
        act = ~state.converged
        rows = state.qact.to(dtype)

        Bm = batch_B(state.x) * rows[:, :, None]
        apply_pinv, Ured_q = _gram_pinv(Bm, cfg.nred)
        Ufree_q = _split_fixed(Ured_q, cons_idx, ncons)
        gq = apply_pinv(_bmv(Bm, state.g))

        # ---- projected quantities + diag scheduling ----
        UT = Ufree_q.transpose(1, 2)
        Hproj = UT @ state.H @ Ufree_q
        g_free = _bmtv(Ufree_q, gq)
        prep = prfo_prepare_batched(g_free, Hproj, cfg.order, cfg.eigh_f32)

        if cfg.eig and cfg.order > 0:
            lams_proj = prep[0]
            too_few = torch.any(lams_proj[:, : cfg.order] > 0, dim=1)
            too_many = (
                lams_proj[:, cfg.order] < 0
                if cfg.order < cfg.nfree
                else torch.zeros(Bsz, dtype=torch.bool, device=dev)
            )
            ev = act & (state.nsteps_since_diag >= cfg.nsteps_per_diag) & (
                too_few | too_many
            )
            # bootstrap diag on the very first step
            ev = ev | (act & (state.nsteps == 0))
        else:
            ev = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        if cfg.diag_every_n > 0:
            ev = ev | (act & (state.nsteps_since_diag >= cfg.diag_every_n))

        any_ev = bool(torch.any(ev))
        if any_ev:
            # the P-RFO prep already diagonalized UT @ H @ U: reuse it as
            # the Davidson preconditioner eigensystem when full precision
            reuse = ((prep[0], prep[1])
                     if cfg.davidson_seed == "pmode" and not cfg.eigh_f32
                     else None)
            with _span("davidson", state.x):
                H1, k_diag = davidson_absorb(
                    c, state.x, gq, Bm, apply_pinv, Ufree_q, state.H, ev,
                    generator, P_eig=reuse,
                )
        else:
            H1 = state.H
            k_diag = torch.zeros(Bsz, dtype=state.nsteps.dtype, device=dev)
        nmv = state.nmatvec + torch.where(ev, k_diag, 0)
        nsd = torch.where(ev, 0, state.nsteps_since_diag + 1)

        # ---- trust-region step in the free internal subspace ----
        # with no lane diagonalized, H1 is state.H and the prep is the
        # same eigensystem: reuse it instead of a second hot eigh
        Hproj1 = UT @ H1 @ Ufree_q
        prep1 = (prfo_prepare_batched(g_free, Hproj1, cfg.order,
                                      cfg.eigh_f32)
                 if any_ev else prep)
        with _span("restricted", state.x):
            dq_pred, smag = restricted_step_batched(
                g_free, Hproj1, Ufree_q, state.delta, cfg, prep=prep1,
                norm_fn=mis_norm_for(c),
            )
        dq_pred = torch.where(act[:, None], dq_pred, 0.0)

        # ---- realize the step + evaluate ----
        with _span("newton", state.x):
            x_new, dq_real = newton_set_x(c, state.x, state.q, dq_pred,
                                          rows, frozen=(Bm, apply_pinv))
        x_new = torch.where(act[:, None], x_new, state.x)
        dq_real = torch.where(act[:, None], dq_real, 0.0)
        f_new, g_new = c["batch_eval"](x_new)
        neval = state.neval + act.to(torch.int32)

        Bm_new = batch_B(x_new) * rows[:, :, None]
        apply_pinv_new, Ured_q_new = _gram_pinv(Bm_new, cfg.nred)
        gq_new = apply_pinv_new(_bmv(Bm_new, g_new))

        # ---- trust ratio (prediction with the PREDICTED step) ----
        df_pred = (gq * dq_pred).sum(1) + 0.5 * (
            dq_pred * _bmv(H1, dq_pred)).sum(1)
        df_actual = f_new - state.f
        pred_ok = torch.abs(df_pred) > cfg.pred_min
        ratio = torch.where(
            pred_ok, df_actual / torch.where(pred_ok, df_pred, 1.0), 1.0
        )

        # ---- quasi-Newton update with the REALIZED secant ----
        # the pre-step internal gradient parallel-transported into the
        # post-step frame: g_par = B_new (B_old^T G_old^+ gq_old)
        g0_cart = _bmtv(Bm, apply_pinv(gq))
        g_par = _bmv(Bm_new, g0_cart)
        dgq = gq_new - g_par
        m1 = (torch.linalg.norm(dq_real, dim=1) > 1e-10)[:, None]
        H2 = ts_bfgs_update_batched(
            H1, dq_real[:, :, None], dgq[:, :, None], m1 & act[:, None],
            cfg.eigh_f32, cfg.absb,
        )
        H2 = torch.where((act & m1[:, 0])[:, None, None], H2, H1)

        # ---- trust update ----
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
        delta_new = torch.where(act, delta_new, state.delta)

        # ---- convergence: projected per-atom forces on REAL atoms ----
        if ncons or cfg.ndummies:
            Ufree_new = _split_fixed(Ured_q_new, cons_idx, ncons)
            gqp = _bmv(Ufree_new, _bmtv(Ufree_new, gq_new))
            gp = _bmtv(Bm_new, gqp)[:, :nr3]
            fmax_now = torch.amax(
                torch.linalg.norm(gp.reshape(Bsz, cfg.natoms, 3), dim=2),
                dim=1,
            )
        else:
            Ux = free_basis(x_new, cfg.nproj)
            gfree_x = _bmtv(Ux, g_new)
            gp = _bmv(Ux, gfree_x)
            fmax_now = torch.amax(
                torch.linalg.norm(gp.reshape(Bsz, n, 3), dim=2), dim=1
            )
        conv_new = state.converged | (act & (fmax_now < cfg.fmax))

        # ---- stagnation restart ----
        improved = fmax_now < 0.97 * state.best_fmax
        best2 = torch.where(act & improved, fmax_now, state.best_fmax)
        stall2 = torch.where(act & ~improved, state.stall + 1, 0)
        x_fin = x_new
        q_fin = state.q + dq_real
        f_fin, g_fin, gq_fin = f_new, g_new, gq_new
        nrst = state.nrestarts
        if cfg.restart_after > 0:
            restart = act & ~conv_new & (stall2 >= cfg.restart_after)
            if bool(torch.any(restart)):
                # restart from the PRISTINE start with a kick that grows
                # with the attempt count (drawn only when some lane
                # restarts, so runs without restarts keep their stream)
                scale = cfg.restart_kick * (
                    1.0 + 0.5 * state.nrestarts.to(dtype))
                kick = scale[:, None] * torch.randn(
                    x_new.shape, generator=generator, dtype=dtype,
                    device=dev)
                if cfg.ndummies:
                    # dummies are spectators pinned by their constraints
                    kick[:, nr3:] = 0.0
                x_fin = torch.where(restart[:, None], state.x_home + kick,
                                    x_new)
                f2, g2 = c["batch_eval"](x_fin)
                q2 = batch_q(x_fin)
                Bm2 = batch_B(x_fin) * rows[:, :, None]
                ap2, _ = _gram_pinv(Bm2, cfg.nred)
                gq2 = ap2(_bmv(Bm2, g2))
                f_fin = torch.where(restart, f2, f_new)
                g_fin = torch.where(restart[:, None], g2, g_new)
                # restarted lanes re-base q continuity at principal values
                q_fin = torch.where(restart[:, None], q2, q_fin)
                gq_fin = torch.where(restart[:, None], gq2, gq_new)
                neval = neval + restart.to(torch.int32)
                H2 = torch.where(restart[:, None, None], c["H_guess"][None],
                                 H2)
                nsd = torch.where(restart, cfg.nsteps_per_diag, nsd)
                delta_new = torch.where(restart, cfg.delta0, delta_new)
                best2 = torch.where(restart, torch.inf, best2)
                stall2 = torch.where(restart, 0, stall2)
                nrst = nrst + restart.to(torch.int32)

        return InternalSearchState(
            x=torch.where(act[:, None], x_fin, state.x),
            q=torch.where(act[:, None], q_fin, state.q),
            f=torch.where(act, f_fin, state.f),
            g=torch.where(act[:, None], g_fin, state.g),
            gq=torch.where(act[:, None], gq_fin, state.gq),
            H=H2,
            delta=delta_new,
            rho=torch.where(act, ratio, state.rho),
            nsteps_since_diag=nsd.to(torch.int32),
            converged=conv_new,
            nsteps=state.nsteps + act.to(torch.int32),
            neval=neval,
            nmatvec=nmv.to(torch.int32),
            best_fmax=best2,
            stall=stall2.to(torch.int32),
            nrestarts=nrst,
            x_home=state.x_home,
            qact=state.qact,
        )

    # the step-realization machinery, for direct testing
    def _ones_rows(x0):
        return torch.ones((x0.shape[0], cfg.nint), dtype=x0.dtype,
                          device=x0.device)

    step.newton_set_x = lambda x0, q0, dq, rows=None: newton_set_x(
        built_for(x0), x0, q0, dq, _ones_rows(x0) if rows is None else rows
    )
    step.batch_q = lambda x: built_for(x)["batch_q"](x)
    step.wrap_dq = lambda r: wrap_dq(built_for(r), r)
    return step


def _place(x0, device) -> torch.Tensor:
    """``x0`` as a float64 tensor on the device of the port's rule
    (:func:`~.ensemble._place_x0`)."""
    return _place_x0(x0, device).to(default_dtype())


def init_internal_state(potential, ints, x0, cfg: InternalEnsembleConfig,
                        cell=None, device=None) -> InternalSearchState:
    """Initialize the batched internal-coordinate state, the quasi-Newton
    Hessian at the Lindh-style guess of the shared topology. A tensor
    ``x0`` keeps its device; any other ``x0`` goes to ``device``, by
    default the GPU (raising where there is none; ``device="cpu"`` asks
    for the CPU). ``potential`` must live on the same device."""
    x0 = _place(x0, device).clone()
    _check_potential_device(potential, x0.device)
    if cfg.ndummies and x0.shape[1] == 3 * cfg.natoms:
        x0 = extend_with_dummies(ints, x0)
    Bsz = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    n = cfg.natoms + cfg.ndummies
    cell_t = _as_cell(cell, x0)
    batch_q, batch_B, _ = _batch_fns(ints._get_engine(), n, cell_t)

    f, g = _batch_eval(potential, cell_t, cfg)(x0)
    q = batch_q(x0)
    Bm = batch_B(x0)
    apply_pinv, _ = _gram_pinv(Bm, cfg.nred)
    gq = apply_pinv(_bmv(Bm, g))

    H0 = torch.as_tensor(ints.guess_hessian(), dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return InternalSearchState(
        x=x0,
        q=q,
        f=f,
        g=g,
        gq=gq,
        H=H0[None].expand(Bsz, cfg.nint, cfg.nint).clone(),
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
        qact=torch.ones((Bsz, cfg.nint), dtype=torch.bool, device=dev),
    )


def bad_internals_mask(state: InternalSearchState, ints,
                       atol_deg: float = 0.5) -> torch.Tensor:
    """Per-lane mask of searches whose active angles reached the
    singular 0/180-deg window where the B matrix loses rank (repave,
    spill or re-seed them)."""
    a0 = ints.ntrans + ints.nbonds
    ang = state.q[:, a0:a0 + ints.nangles]
    if ang.shape[1] == 0:
        return torch.zeros(state.q.shape[0], dtype=torch.bool,
                           device=state.q.device)
    atol = np.radians(atol_deg)
    bad = (ang < atol) | (ang > np.pi - atol)
    # coordinates already deactivated for a lane cannot re-trigger
    bad = bad & state.qact[:, a0:a0 + ints.nangles]
    return torch.any(bad, dim=1)


# ---------------------------------------------------------------------------
# Per-lane repave: the union layout grows, each lane activates its rows
# ---------------------------------------------------------------------------
def _layout_offsets(ints):
    """Start offsets of the (bonds, angles, dihedrals, others,
    rotations) blocks in the q-vector layout."""
    off_b = ints.ntrans
    off_a = off_b + ints.nbonds
    off_d = off_a + ints.nangles
    off_o = off_d + ints.ndihedrals
    off_r = off_o + ints.nother
    return off_b, off_a, off_d, off_o, off_r


def rebuild_internals_at(ints, pos: np.ndarray, cell=None,
                         keep_dummies: bool = False):
    """Rebuild a fresh topology from the given geometry (the JAX
    package's ``rebuild_internals_at``): ``keep_dummies=False`` inserts
    no dummy atom at linear centers; ``keep_dummies=True`` takes the
    EXTENDED geometry and, when discovery reproduces the original dummy
    layout, pins the rebuilt dummies to the lane's current positions, or
    else re-attaches the original dummies as pinned spectators on a
    dummy-free rebuild (:func:`_rebuild_reattach_dummies`). ``cell``
    overrides the discovery cell."""
    pos = np.asarray(pos)
    nreal = ints.natoms
    new = _rebuild_base(ints, pos, cell, strip_dummy_records=keep_dummies)
    new.find_all_bonds()
    new.find_all_angles(allow_dummies=keep_dummies)
    new.find_all_dihedrals()
    if keep_dummies and ints.ndummies:
        if (new.ndummies != ints.ndummies
                or not np.array_equal(new.dinds, ints.dinds)):
            return _rebuild_reattach_dummies(ints, pos, cell)
        new.dummies.positions[:] = pos[nreal:]
        new._engine = None
    return new


def _rebuild_base(ints, pos: np.ndarray, cell, strip_dummy_records: bool):
    """Shared rebuild prologue: fresh atoms at the lane geometry, copied
    constraints (optionally without dummy-referencing records), a fresh
    :class:`Internals` with the forbidden lists carried over."""
    nreal = ints.natoms
    at = ints.atoms.copy()
    at.set_positions(pos[:nreal])
    if cell is not None:
        at.set_cell(np.asarray(cell))
    cons = ints.cons.copy()
    cons.atoms = at
    if strip_dummy_records and ints.ndummies:
        from ..coords.constraints import DummyStore

        cons.dummies = DummyStore()
        cons.records = {
            g: [r for r in recs
                if np.max(np.atleast_1d(r.indices), initial=0) < nreal]
            for g, recs in cons.records.items()
        }
    new = type(ints)(at, cons, allow_fragments=ints.allow_fragments,
                     atol_deg=float(np.degrees(ints.atol)))
    new.forbidden = {g: set(s) for g, s in ints.forbidden.items()}
    return new


def _rebuild_reattach_dummies(ints, pos: np.ndarray, cell):
    """Dummy-layout-change repave path: dummy-free re-discovery at the
    lane geometry plus a verbatim re-attach of the ORIGINAL dummies as
    pinned spectators; keeps the extended DOF count and ``dinds``."""
    import copy as _copy

    from ..coords import topology as topo_mod

    nreal = ints.natoms
    new = _rebuild_base(ints, pos, cell, strip_dummy_records=True)
    at = new.atoms
    new.find_all_bonds()
    new.find_all_angles(allow_dummies=False)
    new.find_all_dihedrals()

    new.dummies.positions = np.asarray(pos[nreal:]).copy()
    new.dinds = ints.dinds.copy()

    def _refs_dummy(idx_tuple):
        return any(int(i) >= nreal for i in idx_tuple)

    cons_angle_keys = {
        topo_mod._angle_key(
            *(int(i) for i in np.atleast_1d(r.indices)),
            r.ncvecs if r.ncvecs is not None else np.zeros((2, 3)),
        )
        for recs in ints.cons.records.values() for r in recs
        if r.kind == "angle" and len(np.atleast_1d(r.indices)) == 3
    }
    for (i, j, nc) in ints.bonds:
        if _refs_dummy((i, j)):
            k = topo_mod._bond_key(i, j, nc)
            if k not in new._bond_keys:
                new.bonds.append((i, j, nc))
                new._bond_keys.add(k)
    have_a = {topo_mod._angle_key(*a) for a in new.angles}
    for a in ints.angles:
        idx = (a[0], a[1], a[2])
        if not _refs_dummy(idx):
            continue
        k = topo_mod._angle_key(*a)
        if k in have_a:
            continue
        # drop unconstrained dummy angles that are near-singular at the
        # lane's current geometry
        if k not in cons_angle_keys:
            ncv = np.asarray(a[3]) if len(a) > 3 and a[3] is not None \
                else np.zeros((2, 3))
            cell_arr = np.asarray(at.cell)
            tv1 = ncv[0] @ cell_arr
            tv2 = ncv[1] @ cell_arr if ncv.shape[0] > 1 else np.zeros(3)
            ang = topo_mod._angle_of(pos, idx[0], idx[1], idx[2], tv1, tv2)
            if not (ints.atol < ang < np.pi - ints.atol):
                continue
        new.angles.append(a)
        have_a.add(k)
    have_d = {topo_mod._dihedral_key(*d) for d in new.dihedrals}
    for d in ints.dihedrals:
        if not _refs_dummy((d[0], d[1], d[2], d[3])):
            continue
        k = topo_mod._dihedral_key(*d)
        if k not in have_d:
            new.dihedrals.append(d)
            have_d.add(k)
    for g, recs in ints.cons.records.items():
        for r in recs:
            if np.max(np.atleast_1d(r.indices), initial=0) >= nreal:
                new.cons.records[g].append(_copy.deepcopy(r))
    new._engine = None
    return new


def merge_novel_internals(base, lane):
    """Append lane-topology entries missing from ``base`` at the end of
    their kind blocks (existing q positions stay). Returns
    ``(merged, (nb, na, nd))`` with the novel counts."""
    from ..coords import topology as topo_mod

    merged = base.copy()
    have_b = {topo_mod._bond_key(i, j, nc) for (i, j, nc) in base.bonds}
    have_a = {topo_mod._angle_key(*a) for a in base.angles}
    have_d = {topo_mod._dihedral_key(*d) for d in base.dihedrals}
    nb = na = nd = 0
    for (i, j, nc) in lane.bonds:
        k = topo_mod._bond_key(i, j, nc)
        if k not in have_b:
            merged.bonds.append((i, j, nc))
            merged._bond_keys.add(k)
            have_b.add(k)
            nb += 1
    for a in lane.angles:
        k = topo_mod._angle_key(*a)
        if k not in have_a:
            merged.angles.append(a)
            have_a.add(k)
            na += 1
    for d in lane.dihedrals:
        k = topo_mod._dihedral_key(*d)
        if k not in have_d:
            merged.dihedrals.append(d)
            have_d.add(k)
            nd += 1
    merged._engine = None
    return merged, (nb, na, nd)


def _membership_rows(merged, lane) -> np.ndarray:
    """Activity rows of ``lane``'s topology inside ``merged``'s layout
    (translations, user coordinates and rotations always active)."""
    from ..coords import topology as topo_mod

    rows = np.zeros(merged.nint, bool)
    off_b, off_a, off_d, off_o, off_r = _layout_offsets(merged)
    rows[:off_b] = True
    rows[off_o:] = True
    kb = {topo_mod._bond_key(i, j, nc) for (i, j, nc) in lane.bonds}
    ka = {topo_mod._angle_key(*a) for a in lane.angles}
    kd = {topo_mod._dihedral_key(*d) for d in lane.dihedrals}
    for m, (i, j, nc) in enumerate(merged.bonds):
        rows[off_b + m] = topo_mod._bond_key(i, j, nc) in kb
    for m, a in enumerate(merged.angles):
        rows[off_a + m] = topo_mod._angle_key(*a) in ka
    for m, d in enumerate(merged.dihedrals):
        rows[off_d + m] = topo_mod._dihedral_key(*d) in kd
    return rows


def _old_to_new_map(base, merged) -> np.ndarray:
    """Position of every base-layout q entry inside the merged layout
    (each kind block shifts rigidly)."""
    mp = np.empty(base.nint, np.int64)
    ob = (0,) + _layout_offsets(base)
    om = (0,) + _layout_offsets(merged)
    counts = (base.ntrans, base.nbonds, base.nangles, base.ndihedrals,
              base.nother, base.nrotations)
    for so, sn, c in zip(ob, om, counts):
        mp[so:so + c] = sn + np.arange(c)
    return mp


def repave_lanes(state: InternalSearchState, ints, cfg, bad, cell=None,
                 atol_deg: float = 0.5):
    """Rebuild the topology of every ``bad`` lane from its CURRENT
    geometry and keep it converging in place (the JAX package's
    ``repave_lanes``): per bad lane, re-discover the topology
    (:func:`rebuild_internals_at`), merge novel entries into the union
    layout, make its ``qact`` rows its rebuilt topology (falling back to
    the union with its previously active, non-singular rows when the
    rebuilt rows cannot span ``cfg.nred`` directions, and refusing the
    lane when even that fails), and transfer its Hessian through
    Cartesian space with the curvilinear corrections
    (``Hx = Bo^T H Bo + hldot_o(gq)``,
    ``H' = Bn^+T (Hx - hldot_n(gq')) Bn^+``). The per-lane work is host
    numpy; q and gq are then re-derived for every lane on the device.

    Returns ``(state', ints', cfg', repaved_mask)``; ``cfg'.nint`` grows
    when the union gained entries (rebuild the step function then)."""
    cell_for_rebuild = None if cell is None else (
        cell.detach().cpu().numpy() if isinstance(cell, torch.Tensor)
        else np.asarray(cell))
    bad = np.asarray(bad.detach().cpu().numpy()
                     if isinstance(bad, torch.Tensor) else bad).copy()
    lanes = np.where(bad)[0]
    if lanes.size == 0:
        return state, ints, cfg, bad

    n = cfg.natoms + cfg.ndummies          # extended atom count
    keep_dummies = cfg.ndummies > 0
    xs = state.x.detach().cpu().numpy()
    rebuilt = {}
    for l in lanes:
        r = rebuild_internals_at(ints, xs[l].reshape(n, 3),
                                 cell=cell_for_rebuild,
                                 keep_dummies=keep_dummies)
        if r is None:
            bad[l] = False
        else:
            rebuilt[int(l)] = r
    lanes = np.where(bad)[0]
    if lanes.size == 0:
        return state, ints, cfg, bad
    merged = ints
    for r in rebuilt.values():
        merged, _ = merge_novel_internals(merged, r)
    nint_new = merged.nint
    cfg_new = cfg._replace(nint=nint_new) if nint_new != cfg.nint else cfg

    # scatter every lane's old state into the new layout
    mp = _old_to_new_map(ints, merged)
    Bsz = xs.shape[0]
    qact_old = state.qact.detach().cpu().numpy()
    H_old = state.H.detach().cpu().numpy()
    qact = np.zeros((Bsz, nint_new), bool)
    qact[:, mp] = qact_old
    H = np.zeros((Bsz, nint_new, nint_new), dtype=H_old.dtype)
    H[:, mp[:, None], mp[None, :]] = H_old
    novel = np.ones(nint_new, bool)
    novel[mp] = False
    if novel.any():
        hg = np.diag(merged.guess_hessian())
        H[:, novel, novel] = hg[novel][None, :]

    eng_old = ints._get_engine()
    eng_new = merged._get_engine()
    gq_old_all = state.gq.detach().cpu().numpy()
    cell_h = torch.zeros((3, 3), dtype=torch.float64) if cell is None \
        else torch.as_tensor(cell_for_rebuild, dtype=torch.float64)

    for l in lanes:
        lane = rebuilt[int(l)]
        pos = torch.as_tensor(xs[l].reshape(n, 3))
        rows_new = _membership_rows(merged, lane)
        Bfull = eng_new._jac_impl(pos, cell_h).numpy()
        Bn = Bfull * rows_new[:, None]
        sv = np.linalg.svd(Bn, compute_uv=False)
        if int(np.sum(sv > 1e-8 * max(sv[0], 1e-300))) < cfg.nred:
            # rebuilt set too sparse: augment with previously active
            # rows, EXCLUDING the near-singular angles
            off_b, off_a, off_d, _, _ = _layout_offsets(merged)
            qv = eng_new._calc_impl(pos, cell_h).numpy()
            atol = np.radians(atol_deg)
            sing = np.zeros(nint_new, bool)
            sing[off_a:off_d] = (qv[off_a:off_d] < atol) | (
                qv[off_a:off_d] > np.pi - atol
            )
            rows_new = rows_new | (qact[l] & ~sing)
            Bn = Bfull * rows_new[:, None]
            sv = np.linalg.svd(Bn, compute_uv=False)
            if int(np.sum(sv > 1e-8 * max(sv[0], 1e-300))) < cfg.nred:
                bad[l] = False      # cannot repave this lane
                continue
        # Hessian transfer through Cartesian space
        Bo = eng_old._jac_impl(pos, cell_h).numpy() * qact_old[l][:, None]
        gq_o = gq_old_all[l]
        g_cart = gq_o @ Bo
        Binv = np.linalg.pinv(Bn)
        gq_n = g_cart @ Binv
        hld_o = eng_old._hldot_impl(pos, cell_h,
                                    torch.as_tensor(gq_o)).numpy()
        hld_n = eng_new._hldot_impl(pos, cell_h,
                                    torch.as_tensor(gq_n)).numpy()
        Hcart = Bo.T @ H_old[l] @ Bo + hld_o
        H[int(l)] = Binv.T @ (Hcart - hld_n) @ Binv
        qact[int(l)] = rows_new

    if not bad.any():
        # every flagged lane was refused: leave the ensemble untouched
        return state, ints, cfg, bad

    # re-derive (q, gq) for every lane in the new masked layout (q
    # continuity re-bases at principal values)
    dev, dtype = state.x.device, state.x.dtype
    qact_t = torch.as_tensor(qact, device=dev)
    batch_q, batch_B, _ = _batch_fns(eng_new, n, _as_cell(cell, state.x))
    q = batch_q(state.x)
    Bm = batch_B(state.x) * qact_t.to(dtype)[:, :, None]
    apply_pinv, _ = _gram_pinv(Bm, cfg.nred)
    gq = apply_pinv(_bmv(Bm, state.g))

    bad_t = torch.as_tensor(bad, device=dev)
    state_new = state._replace(
        q=q,
        gq=gq,
        H=torch.as_tensor(H, dtype=dtype, device=dev),
        qact=qact_t,
        # repaved lanes restart their stagnation bookkeeping
        best_fmax=torch.where(bad_t, torch.inf, state.best_fmax),
        stall=torch.where(bad_t, 0, state.stall),
    )
    return state_new, merged, cfg_new, bad


# ---------------------------------------------------------------------------
# Work queue
# ---------------------------------------------------------------------------
def refill_converged_internal(state: InternalSearchState, x_new, avail, H0):
    """Replace converged lanes with fresh starts; refilled lanes restart
    from the shared Lindh guess ``H0`` on the full shared topology. Call
    :func:`refresh_internal` afterwards to fill (f, g, q, gq)."""
    take = state.converged & avail
    tk = take[:, None]
    dtype = state.x.dtype
    zero = torch.zeros((), dtype=dtype, device=state.x.device)
    new_state = InternalSearchState(
        x=torch.where(tk, x_new, state.x),
        q=torch.where(tk, zero, state.q),
        f=torch.where(take, zero, state.f),
        g=torch.where(tk, zero, state.g),
        gq=torch.where(tk, zero, state.gq),
        H=torch.where(take[:, None, None], H0[None], state.H),
        delta=torch.where(take, zero, state.delta),
        rho=torch.where(take, zero + 1.0, state.rho),
        nsteps_since_diag=torch.where(take, 0, state.nsteps_since_diag),
        converged=torch.where(take, False, state.converged),
        nsteps=torch.where(take, 0, state.nsteps),
        neval=torch.where(take, 0, state.neval),
        nmatvec=torch.where(take, 0, state.nmatvec),
        best_fmax=torch.where(take, torch.inf, state.best_fmax),
        stall=torch.where(take, 0, state.stall),
        nrestarts=torch.where(take, 0, state.nrestarts),
        x_home=torch.where(tk, x_new, state.x_home),
        qact=torch.where(tk, True, state.qact),
    )
    return new_state, take


def refresh_internal(state: InternalSearchState, potential, ints,
                     cfg: InternalEnsembleConfig, cell=None, mask=None,
                     delta0: Optional[float] = None) -> InternalSearchState:
    """Recompute (f, g, q, gq) for all lanes — once after a refill; only
    ``mask`` lanes' neval counters advance (and get their trust radius
    reset to ``delta0``)."""
    n = cfg.natoms + cfg.ndummies
    cell_t = _as_cell(cell, state.x)
    batch_q, batch_B, _ = _batch_fns(ints._get_engine(), n, cell_t)
    f, g = _batch_eval(potential, cell_t, cfg)(state.x)
    q = batch_q(state.x)
    Bm = batch_B(state.x) * state.qact.to(state.x.dtype)[:, :, None]
    apply_pinv, _ = _gram_pinv(Bm, cfg.nred)
    gq = apply_pinv(_bmv(Bm, g))
    inc = 1 if mask is None else mask.to(state.neval.dtype)
    delta = state.delta
    if mask is not None and delta0 is not None:
        delta = torch.where(mask, torch.as_tensor(delta0, dtype=delta.dtype,
                                                  device=delta.device),
                            delta)
    return state._replace(f=f, g=g, q=q, gq=gq,
                          neval=state.neval + inc, delta=delta)


def run_internal_ensemble_queue(
    potential,
    ints,
    x0_all,
    cfg: InternalEnsembleConfig,
    batch: int,
    max_steps_per_search: int = 300,
    cell=None,
    refill_every: int = 10,
    seed: int = 0,
    spill: Optional[str] = "cartesian",
    spill_max_steps: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    mesh=None,
    device=None,
):
    """Process an arbitrarily large set of internal-coordinate searches
    with a fixed device batch. Returns a list of (x_final, f, nsteps,
    converged, nmatvec, neval) per input.

    ``spill='cartesian'``: lanes whose angles hit the singular 0/180-deg
    window are harvested early and, with every other unconverged input,
    finished by one Cartesian :func:`~.ensemble.run_ensemble` (user
    fixed-internal constraints ride along as Cartesian residuals;
    ``spill_max_steps`` overrides its step budget); ``spill=None``
    records them unconverged. Requires ``ndummies == 0`` (warned and
    disabled otherwise). ``checkpoint_path`` saves the queue every
    ``checkpoint_every`` cycles (with the step counter and the
    generator's state); ``resume=True`` continues from it.

    The searches run on ``x0_all``'s device when it is a tensor; any
    other ``x0_all`` goes to ``device``, by default the GPU (raising
    where there is none; ``device="cpu"`` asks for the CPU). ``mesh=``
    is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "run_internal_ensemble_queue(mesh=...) is not ported to "
            "sella_tpu_torch yet (ROADMAP.md)"
        )
    if spill not in (None, "cartesian"):
        raise ValueError(
            f"unknown spill mode {spill!r}: use None or 'cartesian'"
        )
    if spill == "cartesian" and cfg.ndummies:
        warnings.warn(
            "spill='cartesian' requires ndummies == 0 (dummy DOF have "
            "no Cartesian analogue); bad-topology lanes will be "
            "recorded unconverged instead"
        )
        spill = None
    x0_all = _place(x0_all, device)
    dev = x0_all.device
    _check_potential_device(potential, dev)
    if cfg.ndummies and x0_all.shape[1] == 3 * cfg.natoms:
        x0_all = extend_with_dummies(ints, x0_all)
    x0_np = x0_all.cpu().numpy()
    total = x0_all.shape[0]
    batch = min(batch, total)
    cons_idx_all, cons_target_all = (
        fixed_internal_constraints(ints) if cfg.ncons else ([], [])
    )
    step = make_internal_step_fn(potential, ints, cfg, cell)
    H0 = torch.as_tensor(ints.guess_hessian(), dtype=x0_all.dtype,
                         device=dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    it = 0
    loaded = None
    if checkpoint_path is not None and resume:
        from .checkpoint import load_queue

        if os.path.exists(checkpoint_path):
            loaded = load_queue(
                checkpoint_path, InternalSearchState,
                with_retry_state=True, fmax_default=cfg.fmax, device=dev,
            )
    if loaded is not None:
        state, origin, next_idx, results, rst = loaded
        it = rst.get("it", 0)
        if rst.get("rng_state") is not None:
            generator.set_state(rst["rng_state"])
    else:
        state = init_internal_state(potential, ints, x0_all[:batch], cfg,
                                    cell)
        origin = np.arange(batch)
        next_idx = batch
        results = {}

    cycle = 0
    while len(results) < total:
        for _ in range(refill_every):
            state = step(state, generator)
            it += 1

        conv = state.converged.cpu().numpy()
        nsteps = state.nsteps.cpu().numpy()
        done = conv | (nsteps >= max_steps_per_search)
        if spill is not None:
            # harvest singular-topology lanes early; the Cartesian pass
            # below finishes them
            done = done | bad_internals_mask(state, ints).cpu().numpy()
        if not np.any(done):
            continue

        xs = state.x.cpu().numpy()
        fs = state.f.cpu().numpy()
        nmv = state.nmatvec.cpu().numpy()
        nev = state.neval.cpu().numpy()
        for lane in np.where(done)[0]:
            if origin[lane] >= 0 and origin[lane] not in results:
                results[int(origin[lane])] = (
                    xs[lane].copy(), float(fs[lane]),
                    int(nsteps[lane]), bool(conv[lane]),
                    int(nmv[lane]), int(nev[lane]),
                )

        x_new = np.array(xs)
        avail = np.zeros(batch, dtype=bool)
        new_origin = origin.copy()
        for lane in np.where(done)[0]:
            if next_idx < total:
                x_new[lane] = x0_np[next_idx]
                avail[lane] = True
                new_origin[lane] = next_idx
                next_idx += 1
            else:
                new_origin[lane] = -1
        # mark ALL done lanes converged: maxed-out lanes become
        # refillable, exhausted-queue lanes idle cheaply
        state = state._replace(
            converged=torch.as_tensor(conv | done, device=dev))
        if np.any(avail):
            state, take = refill_converged_internal(
                state, torch.as_tensor(x_new, device=dev),
                torch.as_tensor(avail, device=dev), H0)
            state = refresh_internal(state, potential, ints, cfg, cell,
                                     mask=take, delta0=cfg.delta0)
            origin = new_origin

        cycle += 1
        if checkpoint_path is not None and cycle % checkpoint_every == 0:
            from .checkpoint import save_queue

            save_queue(checkpoint_path, state, origin, next_idx, results,
                       it=it, rng_state=generator.get_state())

    if spill == "cartesian":
        todo = [i for i in range(total) if not results[i][3]]
        if todo:
            from .ensemble import EnsembleConfig
            from .ensemble import run_ensemble as _run_cart

            x_spill = torch.as_tensor(
                np.stack([results[i][0] for i in todo]), device=dev)
            ccfg = EnsembleConfig(
                natoms=cfg.natoms, order=cfg.order, fmax=cfg.fmax,
                gamma=cfg.gamma, nproj=cfg.nproj, ncons=cfg.ncons,
            )
            # user fixed-internal constraints survive the spill: each is
            # a Cartesian residual q_i(x) - target through the same
            # engine (dihedral rows wrapped)
            cons_fn = None
            if cfg.ncons:
                engine_s = ints._get_engine()
                dih_s_np = _dihedral_mask(ints)[np.asarray(cons_idx_all)]
                consts = {}

                def cons_fn(x):
                    key = x.device
                    if key not in consts:
                        consts[key] = (
                            _as_cell(cell, x),
                            torch.as_tensor(cons_idx_all, device=key),
                            torch.as_tensor(cons_target_all,
                                            dtype=x.dtype, device=key),
                            torch.as_tensor(dih_s_np, device=key))
                    cell_s, ci_s, ct_s, dih_s = consts[key]
                    q = engine_s._calc_impl(x.reshape(cfg.natoms, 3),
                                            cell_s)
                    r = q[ci_s] - ct_s
                    wrapped = r - 2 * np.pi * torch.round(r / (2 * np.pi))
                    return torch.where(dih_s, wrapped, r)

            cst = _run_cart(potential, x_spill, ccfg,
                            max_steps=(spill_max_steps
                                       or max_steps_per_search),
                            cell=cell, constraints=cons_fn)
            cxs = cst.x.cpu().numpy()
            cfs = cst.f.cpu().numpy()
            cconv = cst.converged.cpu().numpy()
            cns = cst.nsteps.cpu().numpy()
            cmv = cst.nmatvec.cpu().numpy()
            cev = cst.neval.cpu().numpy()
            for j, i in enumerate(todo):
                prev = results[i]
                pmv = prev[4] if len(prev) > 4 else 0
                pev = prev[5] if len(prev) > 5 else 0
                results[i] = (
                    cxs[j].copy(), float(cfs[j]),
                    prev[2] + int(cns[j]), bool(cconv[j]),
                    pmv + int(cmv[j]), pev + int(cev[j]),
                )

    return [results[i] for i in range(total)]


def run_internal_ensemble(
    potential,
    ints,
    x0,
    cfg: InternalEnsembleConfig,
    max_steps: int = 100,
    cell=None,
    mesh=None,
    seed: int = 0,
    steps_per_call: int = 1,
    repave: bool = False,
    repave_atol_deg: float = 0.5,
    max_repaves_per_lane: int = 2,
    device=None,
):
    """Host loop driving the batched internal step until every search
    converges (or ``max_steps``); convergence is checked every
    ``steps_per_call`` steps (one host sync each).

    ``repave=True`` enables the per-lane bad-internal recovery
    (:func:`repave_lanes`), checked before every ``steps_per_call``
    chunk; the step function is rebuilt when the union layout grows, and
    the return value is ``(state, ints)``.

    The state lives on ``x0``'s device when ``x0`` is a tensor; any
    other ``x0`` goes to ``device``, by default the GPU (raising where
    there is none; ``device="cpu"`` asks for the CPU). ``mesh=`` is not
    ported and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "run_internal_ensemble(mesh=...) is not ported to "
            "sella_tpu_torch yet (ROADMAP.md)"
        )
    x0 = _place(x0, device)
    step = make_internal_step_fn(potential, ints, cfg, cell)
    state = init_internal_state(potential, ints, x0, cfg, cell)
    generator = torch.Generator(device=x0.device)
    generator.manual_seed(seed)
    n_calls = (max_steps + steps_per_call - 1) // steps_per_call
    nrepaves = np.zeros(state.x.shape[0], np.int64)
    for _ in range(n_calls):
        if repave:
            # checked BEFORE stepping: a lane that starts (or lands)
            # inside the singular window is repaved first
            bad = bad_internals_mask(state, ints,
                                     repave_atol_deg).cpu().numpy()
            bad &= ~state.converged.cpu().numpy()
            bad &= nrepaves < max_repaves_per_lane
            if bad.any():
                nint_before = cfg.nint
                state, ints, cfg, _ = repave_lanes(
                    state, ints, cfg, bad, cell, atol_deg=repave_atol_deg,
                )
                nrepaves[bad] += 1      # count attempts, even failed
                if cfg.nint != nint_before:
                    step = make_internal_step_fn(potential, ints, cfg,
                                                 cell)
        for _ in range(steps_per_call):
            state = step(state, generator)
        if bool(torch.all(state.converged)):
            break
    if repave:
        return state, ints
    return state
