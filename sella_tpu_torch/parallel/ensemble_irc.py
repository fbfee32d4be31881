"""Batched intrinsic-reaction-coordinate (IRC) integration.

Counterpart of ``sella_tpu/parallel/ensemble_irc.py``: follows the
reaction paths of an ensemble of transition states at once. Natural
pipeline: harvest converged lanes (x, H) from a saddle ensemble
(:mod:`.ensemble`), then integrate every lane's IRC forward and reverse.

Per outer step: displace by the pivot vector d1, then run a masked inner
loop of mass-weighted trust-region corrector steps (the qn_irc stepper
with the sphere constraint ||sqrtm (d1 + s)|| = dx), absorbing every
realized secant into the per-lane TS-BFGS Hessian; a lane's inner loop
is done when its step is bound-clipped and its mass-weighted
path-orthogonal force is small, or when its endpoint test passes.
Convergence requires per-atom forces < fmax AND a positive leftmost
eigenvalue of the rigid-projected Hessian (the endpoint is a minimum).

* The initial mass-weighted mode comes from one batched eigh per lane;
  its sign is canonicalized after the port's own eigh by the same rule
  as the JAX package (largest-magnitude component positive, or the
  first non-negligible one on the raw-eigh branch), since an eigenvector
  from cuSOLVER, LAPACK or XLA can come with either sign. Forward and
  reverse then match the JAX package lane by lane.
* The JAX ``fori_loop`` over ``ninner_iter`` is a Python loop of at most
  ``ninner_iter`` masked iterations. Once every lane is done, the
  iterations left would move no lane (``moved`` all False: no x, f, g,
  H, d1, ``done`` or ``neval`` changes), so one host read of
  ``all(done)`` per iteration ends the loop there; ``inner_fail`` and
  every count stay the JAX package's exactly (a lane exits after one or
  two corrector steps on most of a path, and each skipped iteration
  would cost two batched eighs).
* Each inner iteration's TS-BFGS update reuses the eigendecomposition of
  the corrector's prep (the same matrix) for its |H| metric, and the
  endpoint test reuses the leftmost projected eigenvalue of each lane's
  last inner move (the same x and H): one eigh fewer each.
* No random draw anywhere: a lane's path is the JAX package's up to
  rounding.

Not ported: sharding over a mesh (``mesh=`` raises).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from ..config import default_dtype
from ..ops.linalg import batched_eigh
from .ensemble import (
    _as_cell,
    _bmtv,
    _bmv,
    _check_potential_device,
    _place_x0,
    _target_device,
    free_basis,
    restricted_step_batched,
    ts_bfgs_update_batched,
)
from .ensemble_internal import _span


class IRCEnsembleConfig(NamedTuple):
    """Static configuration of a batched IRC integration (field names,
    defaults and meanings as in ``sella_tpu.parallel.ensemble_irc.
    IRCEnsembleConfig``)."""

    natoms: int
    fmax: float = 0.05
    fmax_inner: float = 0.01
    dx: float = 0.1               # mass-weighted path step length
    ninner_iter: int = 10
    nproj: int = 6                # rigid modes for the endpoint test
    rs_maxiter: int = 24
    rs_tol: float = 1e-8
    pivot_free: bool = True       # imaginary-mode pivot inside the
    #   rigid-free subspace; False = the raw-eigh pivot with the
    #   first-nonzero sign rule
    # fields read by restricted_step_batched
    method: str = "qn"
    rs: str = "tr"
    order: int = 0
    absb: str = "eigh"             # TS-BFGS |B| metric: "eigh" or "ns"

    @property
    def dim(self) -> int:
        return 3 * self.natoms


class IRCState(NamedTuple):
    """Per-path state; every field has a leading batch axis."""

    x: torch.Tensor            # (B, 3n)
    f: torch.Tensor
    g: torch.Tensor
    H: torch.Tensor            # (B, 3n, 3n)
    d1: torch.Tensor           # (B, 3n) pivot displacement
    converged: torch.Tensor
    inner_fail: torch.Tensor   # lanes whose inner loop hit the budget
    nsteps: torch.Tensor
    neval: torch.Tensor


def _qn_irc_prepare_batched(g, H, d1):
    """Batched ``qn_irc_prepare``: one eigh of H, projections of g and
    d1."""
    with _span("irc_eigh", H):
        lams, V = batched_eigh(H)
    Vg = _bmtv(V, g)
    Vd1 = _bmtv(V, d1)
    return (lams, V, Vg, Vd1)


def _qn_irc_step_batched(prep, order, alpha):
    lams, V, Vg, Vd1 = prep
    a = alpha[:, None]
    denom = torch.abs(lams) + a
    sproj = -(Vg + a * Vd1) / denom
    s = _bmv(V, sproj)
    dsda = -_bmv(V, (sproj + Vd1) / denom)
    return s, dsda


def _sqrtm(masses, like: torch.Tensor) -> torch.Tensor:
    """Per-DOF square-root masses (3n,) as float64 on ``like``'s device."""
    return torch.as_tensor(np.repeat(np.sqrt(np.asarray(masses,
                                                        np.float64)), 3),
                           dtype=like.dtype, device=like.device)


def _batch_fg(potential, cell_t):
    """(B, 3n) -> (f (B,), g (B, 3n))."""
    def one(xx):
        g, e = grad_and_value(potential.energy)(xx, cell_t)
        return e, g

    return vmap(one)


def make_irc_step_fn(potential, cfg: IRCEnsembleConfig, masses,
                     cell=None):
    """Build the batched IRC outer step ``step(state, generator=None) ->
    state`` (the input state is never modified; nothing is drawn)."""
    n = cfg.natoms
    Bdim = cfg.dim
    built = {}

    def built_for(x):
        key = (x.device, x.dtype)
        if key not in built:
            cell_t = _as_cell(cell, x)
            built[key] = dict(
                sqrtm=_sqrtm(masses, x), eval=_batch_fg(potential, cell_t),
                eye=torch.eye(Bdim, dtype=x.dtype, device=x.device))
        return built[key]

    def irc_norm(sqrtm, d1):
        def norm_fn(s_full, ds_full):
            v = sqrtm[None, :] * (d1 + s_full)
            val = torch.linalg.norm(v, dim=1)
            dval = (sqrtm[None, :] * ds_full * v).sum(1) / torch.clamp(
                val, min=1e-12)
            return val, dval

        return norm_fn

    def lam0_of(x, H):
        """Leftmost eigenvalue of the rigid-projected Hessian per lane.
        The JAX package takes it from a full ``batched_eigh``; the
        eigenvalues alone are the same to rounding, only their sign is
        read, and cuSOLVER gives them in about half the eigh's time."""
        U = free_basis(x, cfg.nproj)
        with _span("irc_eigh", x):
            return torch.linalg.eigvalsh(U.transpose(1, 2) @ H @ U)[:, 0]

    def step(state: IRCState, generator=None) -> IRCState:
        del generator
        c = built_for(state.x)
        sqrtm, batch_eval = c["sqrtm"], c["eval"]
        Bsz = state.x.shape[0]
        dtype = state.x.dtype
        act = ~state.converged

        # ---- pivot displacement off the previous point
        x1 = state.x + torch.where(act[:, None], state.d1, 0.0)
        f1, g1 = batch_eval(x1)
        # secant from the pivot move
        m_piv = act & (torch.linalg.norm(state.d1, dim=1) > 1e-12)
        # d1 is zero after a lane's first outer step; with no pivot in
        # the batch the masked update would return state.H unchanged
        H1 = state.H
        if bool(m_piv.any()):
            H1 = ts_bfgs_update_batched(
                state.H, state.d1[:, :, None], (g1 - state.g)[:, :, None],
                m_piv[:, None], absb=cfg.absb,
            )
            H1 = torch.where(m_piv[:, None, None], H1, state.H)

        x = torch.where(act[:, None], x1, state.x)
        f = torch.where(act, f1, state.f)
        g = torch.where(act[:, None], g1, state.g)
        H = H1
        d1 = state.d1
        done = ~act
        neval = state.neval + act.to(torch.int32)
        Ufree_b = c["eye"].expand(Bsz, Bdim, Bdim)
        dx_t = torch.full((Bsz,), cfg.dx, dtype=dtype, device=x.device)

        # leftmost rigid-free eigenvalue at each lane's current (x, H),
        # kept from the inner move that produced them (a lane that does
        # not step keeps its converged flag, which the test never reads)
        lam0 = torch.full((Bsz,), -torch.inf, dtype=dtype, device=x.device)
        # the JAX fori_loop of ninner_iter masked iterations; with every
        # lane done the rest are no-ops, so the loop ends there
        for _ in range(cfg.ninner_iter):
            if bool(done.all()):
                break
            prep = _qn_irc_prepare_batched(g, H, d1)
            s, smag = restricted_step_batched(
                torch.zeros_like(g), H, Ufree_b, dx_t, cfg, prep=prep,
                norm_fn=irc_norm(sqrtm, d1),
                stepper_fn=_qn_irc_step_batched,
            )
            s = torch.where(done[:, None], 0.0, s)
            bound_clip = torch.abs(smag - cfg.dx) < 1e-8

            x_new = x + s
            f_new, g_new = batch_eval(x_new)
            moved = ~done
            H_new = ts_bfgs_update_batched(
                H, s[:, :, None], (g_new - g)[:, :, None],
                (moved & (torch.linalg.norm(s, dim=1) > 1e-12))[:, None],
                absb=cfg.absb, eig=prep[:2],
            )
            H_new = torch.where(moved[:, None, None], H_new, H)
            d1_new = d1 + s

            # mass-weighted path-orthogonal force
            d1m = d1_new * sqrtm[None, :]
            d1m = d1m / torch.clamp(
                torch.linalg.norm(d1m, dim=1, keepdim=True), min=1e-30)
            g1m = g_new / sqrtm[None, :]
            g1m_proj = g1m - d1m * (d1m * g1m).sum(1)[:, None]
            fmax_mw = torch.amax(torch.linalg.norm(
                (g1m_proj * sqrtm[None, :]).reshape(Bsz, n, 3), dim=2),
                dim=1)
            # inner exit: a bound-clipped step with small path-orthogonal
            # force, or the endpoint itself converged (small forces AND
            # positive leftmost rigid-projected curvature)
            fmax_cart = torch.amax(torch.linalg.norm(
                g_new.reshape(Bsz, n, 3), dim=2), dim=1)
            lam0i = lam0_of(x_new, H_new)
            done_new = done | (
                moved & bound_clip & (fmax_mw < cfg.fmax_inner)
            ) | (moved & (fmax_cart < cfg.fmax) & (lam0i > 0))

            x = torch.where(moved[:, None], x_new, x)
            f = torch.where(moved, f_new, f)
            g = torch.where(moved[:, None], g_new, g)
            H = H_new
            d1 = torch.where(moved[:, None], d1_new, d1)
            lam0 = torch.where(moved, lam0i, lam0)
            done = done_new
            neval = neval + moved.to(torch.int32)

        inner_fail = state.inner_fail | (act & ~done)

        # ---- endpoint test: forces small AND projected H positive ----
        fmax_now = torch.amax(torch.linalg.norm(g.reshape(Bsz, n, 3),
                                                dim=2), dim=1)
        conv_new = state.converged | (act & (fmax_now < cfg.fmax)
                                      & (lam0 > 0))

        # d1 resets to zero after every outer step: the pivot fires only
        # on the first outer step; afterwards the sphere constraint
        # ||W (d1 + s)|| = dx pulls the corrector along the path
        return IRCState(
            x=x,
            f=f,
            g=g,
            H=H,
            d1=torch.zeros_like(d1),
            converged=conv_new,
            inner_fail=inner_fail,
            nsteps=state.nsteps + act.to(torch.int32),
            neval=neval,
        )

    return step


def _mw_pivot(x_ts: torch.Tensor, H_ts: torch.Tensor,
              cfg: IRCEnsembleConfig, sqrtm: torch.Tensor) -> torch.Tensor:
    """Sign-canonical mass-weighted imaginary-mode pivot, length
    ``cfg.dx`` in mass-weighted arc length.

    ``pivot_free`` (the default): the leftmost mass-weighted mode inside
    the rigid-free subspace (a quasi-Newton Hessian's rigid blocks can
    be spuriously negative), sign canonical by its largest-magnitude
    component. Otherwise the raw eigh of the mass-weighted Hessian, sign
    canonical by its first non-negligible component. The sign rule runs
    after the port's own eigh, whose eigenvector may come with either
    sign; ``argmax`` takes the first index on ties, as in the JAX
    package."""
    Bsz = x_ts.shape[0]
    Hw = H_ts / (sqrtm[None, :, None] * sqrtm[None, None, :])
    if cfg.pivot_free:
        U = free_basis(x_ts, cfg.nproj)                # (B, dim, m)
        Uw = torch.linalg.qr(sqrtm[None, :, None] * U)[0]
        A = Uw.transpose(1, 2) @ Hw @ Uw
        _, V = batched_eigh(A)
        vw = _bmv(Uw, V[:, :, 0])
    else:
        _, V = batched_eigh(Hw)
        vw = V[:, :, 0]
    v0 = vw / sqrtm[None, :]
    v0 = cfg.dx * v0 / torch.linalg.norm(v0 * sqrtm[None, :], dim=1,
                                         keepdim=True)
    b = torch.arange(Bsz, device=x_ts.device)
    if cfg.pivot_free:
        lead = v0[b, torch.argmax(torch.abs(v0), dim=1)]
    else:
        nz = torch.abs(v0) > 1e-12 * torch.amax(torch.abs(v0), dim=1,
                                               keepdim=True)
        lead = v0[b, torch.argmax(nz.to(torch.int8), dim=1)]
    return v0 * torch.where(lead < 0, -1.0, 1.0)[:, None]


def _direction_signs(direction, Bsz: int, like: torch.Tensor):
    if isinstance(direction, str):
        if direction not in ("forward", "reverse"):
            raise ValueError('direction must be "forward" or "reverse"')
        return torch.full((Bsz,), -1.0 if direction == "reverse" else 1.0,
                          dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(direction.cpu() if isinstance(
        direction, torch.Tensor) else direction), dtype=like.dtype,
        device=like.device)


def _place_H(H_ts, like: torch.Tensor) -> torch.Tensor:
    if isinstance(H_ts, torch.Tensor):
        return H_ts.to(dtype=like.dtype, device=like.device).clone()
    return torch.as_tensor(np.asarray(H_ts), dtype=like.dtype,
                           device=like.device)


def init_irc_state(potential, x_ts, H_ts, cfg: IRCEnsembleConfig, masses,
                   direction="forward", cell=None,
                   device=None) -> IRCState:
    """Initialize from an ensemble of transition states: the pivot along
    each lane's mass-weighted imaginary mode (:func:`_mw_pivot`);
    ``direction`` flips its sign for the reverse run, either one string
    for every lane or a per-lane ±1 array (the work queue's mix).

    A tensor ``x_ts`` keeps its device; any other ``x_ts`` goes to
    ``device``, by default the GPU, and raises where there is none
    (``device="cpu"`` asks for the CPU). ``H_ts`` follows ``x_ts``. The
    state is float64, and the caller's ``x_ts`` and ``H_ts`` are copied,
    never written."""
    x_ts = _place_x0(x_ts, device).to(default_dtype()).clone()
    _check_potential_device(potential, x_ts.device)
    H_ts = _place_H(H_ts, x_ts)
    Bsz = x_ts.shape[0]
    dev = x_ts.device
    sqrtm = _sqrtm(masses, x_ts)
    sign = _direction_signs(direction, Bsz, x_ts)
    v0 = _mw_pivot(x_ts, H_ts, cfg, sqrtm) * sign[:, None]
    f, g = _batch_fg(potential, _as_cell(cell, x_ts))(x_ts)
    i32 = dict(dtype=torch.int32, device=dev)
    return IRCState(
        x=x_ts,
        f=f,
        g=g,
        H=H_ts,
        d1=v0,
        converged=torch.zeros(Bsz, dtype=torch.bool, device=dev),
        inner_fail=torch.zeros(Bsz, dtype=torch.bool, device=dev),
        nsteps=torch.zeros(Bsz, **i32),
        neval=torch.ones(Bsz, **i32),
    )


def run_irc_ensemble(potential, x_ts, H_ts, cfg: IRCEnsembleConfig,
                     masses, direction="forward", max_steps: int = 50,
                     cell=None, mesh=None, record_path: bool = False,
                     device=None):
    """Host loop driving the batched IRC step until every path converges
    (or ``max_steps``; one host read of ``converged`` a step). With
    ``record_path`` returns ``(state, path)``: path is the numpy
    (nsteps, B, 3n) stack of outer-step geometries. Device rule as in
    :func:`init_irc_state`; ``mesh=`` is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "run_irc_ensemble(mesh=...) is not ported to sella_tpu_torch "
            "yet (ROADMAP.md)"
        )
    step = make_irc_step_fn(potential, cfg, masses, cell)
    state = init_irc_state(potential, x_ts, H_ts, cfg, masses, direction,
                           cell, device=device)
    path = []
    for _ in range(max_steps):
        state = step(state)
        if record_path:
            path.append(state.x.detach().cpu().numpy())
        if bool(torch.all(state.converged)):
            break
    if record_path:
        return state, (np.stack(path) if path
                       else np.zeros((0,) + tuple(state.x.shape)))
    return state


def make_irc_refill_fn(potential, cfg: IRCEnsembleConfig, masses,
                       cell=None):
    """Lane refill for the IRC work queue: ``refill(state, x_new, H_new,
    sign_new, avail)`` re-initializes every lane where ``state.converged
    & avail`` from the corresponding rows (fresh pivot, reset counters)
    and leaves the rest untouched; returns ``(state, take)``. As in the
    JAX package, the fresh pivot and force call are computed for the
    whole batch and spliced in with ``where``."""
    def refill(state: IRCState, x_new, H_new, sign_new, avail):
        sqrtm = _sqrtm(masses, state.x)
        take = state.converged & avail
        v0 = _mw_pivot(x_new, H_new, cfg, sqrtm) * sign_new[:, None]
        f, g = _batch_fg(potential, _as_cell(cell, state.x))(x_new)
        tf = take[:, None]
        return IRCState(
            x=torch.where(tf, x_new, state.x),
            f=torch.where(take, f, state.f),
            g=torch.where(tf, g, state.g),
            H=torch.where(take[:, None, None], H_new, state.H),
            d1=torch.where(tf, v0, state.d1),
            converged=state.converged & ~take,
            inner_fail=state.inner_fail & ~take,
            nsteps=torch.where(take, 0, state.nsteps).to(torch.int32),
            neval=torch.where(take, 1, state.neval).to(torch.int32),
        ), take

    return refill


def run_irc_ensemble_queue(potential, x_ts_all, H_ts_all,
                           cfg: IRCEnsembleConfig, masses, batch: int,
                           directions: str = "both",
                           max_steps_per_search: int = 150, cell=None,
                           refill_every: int = 10, mesh=None, device=None):
    """Process an arbitrarily large set of transition states with a fixed
    device batch. ``directions='both'`` expands every TS into a forward
    and a reverse work item, which advance in the same batch. Returns
    one dict per work item, ``{"ts", "direction" (+1/-1), "x" (endpoint),
    "f", "nsteps", "converged", "inner_fail"}``, ordered by (ts index,
    forward then reverse), plus ``"neval"``, the item's force calls.

    The paths run on ``x_ts_all``'s device when it is a tensor; any other
    ``x_ts_all`` goes to ``device``, by default the GPU, and raises where
    there is none (``device="cpu"`` asks for the CPU). The caller's
    arrays are read, never written. ``mesh=`` is not ported and
    raises."""
    if mesh is not None:
        raise NotImplementedError(
            "run_irc_ensemble_queue(mesh=...) is not ported to "
            "sella_tpu_torch yet (ROADMAP.md)"
        )
    dev = _target_device(x_ts_all, device)
    dtype = default_dtype()
    x_np = (x_ts_all.detach().cpu().numpy()
            if isinstance(x_ts_all, torch.Tensor)
            else np.asarray(x_ts_all)).astype(np.float64)
    H_np = (H_ts_all.detach().cpu().numpy()
            if isinstance(H_ts_all, torch.Tensor)
            else np.asarray(H_ts_all)).astype(np.float64)
    nts = x_np.shape[0]
    if directions == "both":
        items = [(i, s) for i in range(nts) for s in (1.0, -1.0)]
    elif directions in ("forward", "reverse"):
        s = 1.0 if directions == "forward" else -1.0
        items = [(i, s) for i in range(nts)]
    else:
        raise ValueError(
            'directions must be "forward", "reverse" or "both"'
        )
    total = len(items)
    batch = min(batch, total)

    step = make_irc_step_fn(potential, cfg, masses, cell)
    refill = make_irc_refill_fn(potential, cfg, masses, cell)

    ts0 = np.array([items[j][0] for j in range(batch)])
    sg0 = np.array([items[j][1] for j in range(batch)])
    state = init_irc_state(potential, torch.as_tensor(x_np[ts0], device=dev),
                           H_np[ts0], cfg, masses, sg0, cell)
    origin = np.arange(batch)
    next_idx = batch
    results: dict = {}

    while len(results) < total:
        for _ in range(refill_every):
            state = step(state)

        conv = state.converged.cpu().numpy()
        nsteps = state.nsteps.cpu().numpy()
        done = conv | (nsteps >= max_steps_per_search)
        if not np.any(done):
            continue

        xs = state.x.cpu().numpy()
        fs = state.f.cpu().numpy()
        ifail = state.inner_fail.cpu().numpy()
        nev = state.neval.cpu().numpy()
        for lane in np.where(done)[0]:
            j = origin[lane]
            if j >= 0 and j not in results:
                results[int(j)] = {
                    "ts": items[j][0],
                    "direction": int(items[j][1]),
                    "x": xs[lane].copy(),
                    "f": float(fs[lane]),
                    "nsteps": int(nsteps[lane]),
                    "converged": bool(conv[lane]),
                    "inner_fail": bool(ifail[lane]),
                    "neval": int(nev[lane]),
                }

        x_new = xs.copy()
        H_new = state.H.cpu().numpy()
        sg_new = np.ones(batch)
        avail = np.zeros(batch, dtype=bool)
        new_origin = origin.copy()
        for lane in np.where(done)[0]:
            if next_idx < total:
                ti, si = items[next_idx]
                x_new[lane] = x_np[ti]
                H_new[lane] = H_np[ti]
                sg_new[lane] = si
                avail[lane] = True
                new_origin[lane] = next_idx
                next_idx += 1
            else:
                new_origin[lane] = -1
        # done-but-unconverged lanes become refillable / idle cheaply
        state = state._replace(
            converged=torch.as_tensor(conv | done, device=dev))
        if np.any(avail):
            state, _ = refill(
                state, torch.as_tensor(x_new, dtype=dtype, device=dev),
                torch.as_tensor(H_new, dtype=dtype, device=dev),
                torch.as_tensor(sg_new, dtype=dtype, device=dev),
                torch.as_tensor(avail, device=dev),
            )
            origin = new_origin

    return [results[j] for j in range(total)]
