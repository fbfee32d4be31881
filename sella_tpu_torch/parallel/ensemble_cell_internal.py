"""Batched ensemble optimization in internal coordinates + cell DOF.

Counterpart of ``sella_tpu/parallel/ensemble_cell_internal.py``, the
batched analog of the sequential ``CellInternalPES``: per-lane DOF are
``z = [q (redundant internals), s (masked log-deformation cell
parameters)]``; steps are predicted by RS-(P-)RFO in the nonredundant
free subspace of z and realized by (1) applying the cell update
``cell = expm(L/factor) @ cell0`` and then (2) a masked Newton
back-transform that moves the atoms until the internals at the NEW cell
hit ``q_after_cell + dq``.

* One shared topology layout with per-lane activity rows (``qact``) and
  per-lane base cells (``cell0``), as in the JAX package: a repave or a
  Niggli rebase of one lane is a state update. The engine of
  :class:`~sella_tpu_torch.coords.internals.Internals` evaluates q and B
  at each lane's own cell (``torch.func.vmap`` over lanes and cells), so
  periodic image vectors ride the deformation.
* The enthalpy ``E + P |det cell|`` is one differentiable scalar of
  ``(x, s)`` (the atom+cell tier's
  :func:`~.ensemble_cell.make_ext_energy_c0`); its gradient gives the
  atom forces and the cell gradient by ``torch.func`` through
  :func:`~sella_tpu_torch.ops.linalg.expm`.
* Curvature is secant-driven (TS-BFGS on z-space secants) from the
  block guess [Lindh q-Hessian, ``h0_cell`` I].
* Fixed internal coordinates split the free subspace and are pinned in
  the Newton back-transform, as in the internal tier.

The JAX package's ``lax.while_loop`` of the full-Newton back-transform
is a Python loop that reads ``any(~done)`` on the host once per
iteration (``step.host_syncs`` counts those reads, ``step.newton_iters``
the iterations); a finished lane is frozen by ``where``, so its result
does not depend on the batch it sits in. The step takes a generator and
draws nothing from it (the JAX step ignores its key), so a lane's run is
the JAX package's up to rounding. Dummy atoms raise, as in the JAX
package. Not ported: sharding over a mesh (``mesh=`` raises).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad_and_value, jacfwd, vmap

from ..config import default_dtype
from ..ops.linalg import inv3
from .ensemble import (
    _bmtv,
    _bmv,
    _check_potential_device,
    _place_x0,
    _target_device,
    prfo_prepare_batched,
    restricted_step_batched,
    ts_bfgs_update_batched,
)
from .ensemble_cell import _NullPotential, _place_cell0, make_ext_energy_c0
from .ensemble_internal import (
    _dihedral_mask,
    _gram_pinv,
    _kind_weights,
    _span,
    _split_fixed,
    fixed_internal_constraints,
)


class CellInternalEnsembleConfig(NamedTuple):
    """Static configuration of a batched internal+cell search (field
    names, defaults and meanings as in ``sella_tpu.parallel.
    ensemble_cell_internal.CellInternalEnsembleConfig``). ``nint``
    internals + ``ncell`` free cell parameters (the True count of the
    3x3 cell mask); ``nred`` is the nonredundant width of range(B),
    ``3 natoms - nproj`` (``nproj=3``: translations are invariant in q
    under PBC; the cell pins rotations)."""

    natoms: int
    nint: int
    ncell: int = 9
    order: int = 0
    nproj: int = 3
    ncons: int = 0
    fmax: float = 1e-3
    smax: float = 0.0              # 0 -> use fmax
    gamma: float = 0.1
    delta0: float = 0.1
    delta_min: float = 1e-4
    sigma_inc: float = 1.15
    sigma_dec: float = 0.65
    rho_inc: float = 1.035
    rho_dec: float = 5.0
    rs_maxiter: int = 18
    rs_tol: float = 1e-8
    method: str = "prfo"
    rs: str = "mis"
    newton_maxiter: int = 20
    newton_tol: float = 1e-10
    rigid_fragments: bool = False
    exp_cell_factor: float = 0.0   # <= 0 -> float(natoms)
    scalar_pressure: float = 0.0
    absb: str = "eigh"             # TS-BFGS |B| metric: "eigh" or "ns"
    h0_cell: float = 60.0          # cell-block guess curvature (eV)
    # mis weights per coordinate kind + cell components
    wx: float = 1.0
    wb: float = 1.0
    wa: float = 1.0
    wd: float = 1.0
    wo: float = 1.0
    wc: float = 1.0
    pred_min: float = 1e-14        # smallest trusted |predicted dE|

    @property
    def nz(self) -> int:
        return self.nint + self.ncell

    @property
    def nred(self) -> int:
        return 3 * self.natoms - self.nproj

    @property
    def nfree(self) -> int:
        """Free width of the z-subspace: nonredundant internals minus
        fixed coordinates, plus all cell parameters."""
        return self.nred - self.ncons + self.ncell


class CellInternalSearchState(NamedTuple):
    """Per-search state; every field has a leading batch axis."""

    x: torch.Tensor           # (B, 3n) Cartesian positions
    s: torch.Tensor           # (B, ncell) masked log-deformation params
    q: torch.Tensor           # (B, nint) internal values (continuous)
    f: torch.Tensor           # (B,) enthalpy E + PV
    g: torch.Tensor           # (B, 3n) Cartesian enthalpy gradient
    gs: torch.Tensor          # (B, ncell) cell-parameter gradient
    gq: torch.Tensor          # (B, nint) internal gradient B^+T g
    H: torch.Tensor           # (B, nz, nz) quasi-Newton Hessian (z)
    delta: torch.Tensor
    rho: torch.Tensor
    converged: torch.Tensor
    nsteps: torch.Tensor
    neval: torch.Tensor
    cell0: torch.Tensor       # (B, 3, 3) per-lane base cell, constant
    #   between rebase events
    qact: torch.Tensor        # (B, nint) per-lane active topology rows
    qcons: torch.Tensor       # (B, ncons) per-lane rows of the fixed
    #   internal coordinates (a Niggli rebase remaps an image-pinned
    #   constraint for its lane only)


def _cell_map(cfg: CellInternalEnsembleConfig,
              cell_mask: Optional[np.ndarray]):
    """``(cell_of, make_enthalpy)``: ``cell_of(s, c0)`` realizes one
    lane's cell from its parameters and base cell; ``make_enthalpy(pot)``
    gives ``enthalpy(x, s, c0) = E + P |det cell|``. Both take the base
    cell as an argument, so one step serves every per-lane base."""
    if cell_mask is None:
        cell_mask = np.ones((3, 3), dtype=bool)
    _, cell_of = make_ext_energy_c0(_NullPotential(), cfg, cell_mask)

    def make_enthalpy(potential):
        ext_energy, _ = make_ext_energy_c0(potential, cfg, cell_mask)

        def enthalpy(x, s, c0):
            return ext_energy(torch.cat([x, s]), c0)

        return enthalpy

    return cell_of, make_enthalpy


def _fragment_ids(ints, n: int):
    """Per-atom fragment index (lone atoms are their own fragments) and
    the fragment count."""
    frag_id = np.full(n, -1, dtype=np.int64)
    nfrag = 0
    for group in ints.fragment_atom_groups or []:
        frag_id[np.asarray(group)] = nfrag
        nfrag += 1
    for a in range(n):
        if frag_id[a] < 0:
            frag_id[a] = nfrag
            nfrag += 1
    return frag_id, nfrag


def _rigid_maps(ints, cfg: CellInternalEnsembleConfig, cell_of):
    """Single-lane rigid-fragment transport + corrected cell gradient
    (the JAX package's ``_rigid_maps``): under a cell change each
    fragment's centroid follows the cell affinely and its orientation
    rotates by the polar factor of ``F_inc = cell_new @ cell_old^-1``;
    lone atoms follow the cell affinely. ``gs_corr`` is the closed-form
    linearization of the transport, ``dE/ds = dE/ds|_x + g . dT/ds``.

    The polar factor is ``U V^T`` of the SVD of ``F_inc``, the JAX
    package's formula: the product does not depend on the signs that
    LAPACK, cuSOLVER or XLA give the singular vectors, unlike U or V
    alone. The per-fragment sums are products with a constant one-hot
    (nfrag, n) matrix (the JAX ``segment_sum``). Returns
    ``(transport, gs_corr)`` over one lane; ``vmap`` at the call sites."""
    n = cfg.natoms
    frag_id_np, nfrag = _fragment_ids(ints, n)
    member_np = np.zeros((nfrag, n))
    member_np[frag_id_np, np.arange(n)] = 1.0
    counts_np = member_np.sum(axis=1)
    consts = {}

    def _c(like):
        key = (like.device, like.dtype)
        if key not in consts:
            consts[key] = (
                torch.as_tensor(frag_id_np, device=like.device),
                torch.as_tensor(member_np, dtype=like.dtype,
                                device=like.device),
                torch.as_tensor(counts_np, dtype=like.dtype,
                                device=like.device),
            )
        return consts[key]

    def _coms(pos):                              # (n,3) -> (nfrag,3)
        _, member, counts = _c(pos)
        return (member @ pos) / counts[:, None]

    def transport(x_flat, cell_old, cell_new):
        frag_id = _c(x_flat)[0]
        pos = x_flat.reshape(n, 3)
        com = _coms(pos)
        inv_old = inv3(cell_old)
        F_inc = cell_new @ inv_old
        U, _, Vh = torch.linalg.svd(F_inc)
        R = U @ Vh
        com_new = (com @ inv_old) @ cell_new
        delta = pos - com[frag_id]
        pos_new = com_new[frag_id] + delta @ R.T
        return pos_new.reshape(-1)

    dcell_of = jacfwd(cell_of)                   # s -> (3, 3, ncell)

    def gs_corr(g_flat, x_flat, s, c0):
        frag_id, member, _ = _c(x_flat)
        gm = g_flat.reshape(n, 3)
        pos = x_flat.reshape(n, 3)
        com = _coms(pos)
        cell = cell_of(s, c0)
        inv_c = inv3(cell)
        D = dcell_of(s, c0)                      # (3, 3, ncell)
        A = torch.einsum("ij,jlk->ilk", inv_c, D)
        dF = torch.einsum("ijk,jl->ilk", D, inv_c)
        S = 0.5 * (dF - dF.transpose(0, 1))      # skew(dF)
        G = member @ gm
        term1 = torch.einsum("fi,ijk,fj->k", com, A, G)
        delta = pos - com[frag_id]
        P = delta.T @ gm
        term2 = torch.einsum("ij,ijk->k", P, S)
        return term1 - term2

    return transport, gs_corr


def _batch_qB(engine, n: int):
    """(batch_q, batch_B) of (B, 3n) positions at (B, 3, 3) per-lane
    cells."""
    def batch_q(x, cells):
        return vmap(lambda p, c: engine._calc_impl(p.reshape(n, 3), c))(
            x, cells)

    def batch_B(x, cells):
        return vmap(lambda p, c: engine._jac_impl(p.reshape(n, 3), c))(
            x, cells)

    return batch_q, batch_B


def _batch_eval(enthalpy):
    """(B, 3n), (B, ncell), (B, 3, 3) -> (f, g, gs)."""
    def one(x, s, c0):
        (g, gs), e = grad_and_value(enthalpy, argnums=(0, 1))(x, s, c0)
        return e, g, gs

    return vmap(one)


def make_cell_internal_step_fn(
    potential, ints, cfg: CellInternalEnsembleConfig, cell0=None,
    cell_mask: Optional[np.ndarray] = None,
):
    """Build the batched internal+cell RS-RFO step ``step(state,
    generator=None) -> state`` (the input state is never modified, and
    the generator is not drawn from). ``cell0`` is accepted for
    compatibility and unused: the base cells live in the state.

    ``step.newton_iters`` and ``step.host_syncs`` count the Newton
    back-transform's iterations and its host reads of ``any(~done)``
    over every call."""
    if ints.ndummies:
        raise ValueError(
            "dummy atoms are not supported in the batched internal+cell"
            " tier; use the sequential CellInternalPES"
        )
    if ints.nint != cfg.nint:
        raise ValueError(f"cfg.nint={cfg.nint} != topology {ints.nint}")
    cons_idx_np, cons_target_np = fixed_internal_constraints(ints)
    if len(cons_idx_np) != cfg.ncons:
        raise ValueError(
            f"cfg.ncons={cfg.ncons} != mapped constraints "
            f"{len(cons_idx_np)}"
        )
    del cell0
    ncons = cfg.ncons
    engine = ints._get_engine()
    n = cfg.natoms
    nint = cfg.nint

    cell_of, make_enthalpy = _cell_map(cfg, cell_mask)
    batch_eval = _batch_eval(make_enthalpy(potential))
    if cfg.rigid_fragments:
        transport, gs_corr = _rigid_maps(ints, cfg, cell_of)
        batch_transport = vmap(transport)
        batch_gs_corr = vmap(gs_corr)
    batch_q, batch_B = _batch_qB(engine, n)
    batch_cell = vmap(cell_of)

    dih_np = _dihedral_mask(ints)
    w_z_np = np.concatenate([_kind_weights(ints, cfg),
                             cfg.wc * np.ones(cfg.ncell)])
    smax_tol = cfg.smax if cfg.smax > 0 else cfg.fmax
    built = {}

    def built_for(x):
        key = (x.device, x.dtype)
        if key not in built:
            built[key] = dict(
                cons_idx=torch.as_tensor(cons_idx_np, device=x.device),
                cons_target=torch.as_tensor(cons_target_np, dtype=x.dtype,
                                            device=x.device),
                dih=torch.as_tensor(dih_np, device=x.device),
                w_z=torch.as_tensor(w_z_np, dtype=x.dtype,
                                    device=x.device),
            )
        return built[key]

    def wrap_dq(c, r):
        # torch.round rounds half to even, as jnp.round does
        wrapped = r - 2 * np.pi * torch.round(r / (2 * np.pi))
        return torch.where(c["dih"][None, :], wrapped, r)

    def mis_norm_for(c):
        w_z = c["w_z"]

        def mis_norm(s_full, ds_full):
            ws = w_z[None, :] * torch.abs(s_full)
            # argmax takes the first index on ties, as jnp.argmax does
            idx = torch.argmax(ws, dim=1)
            b = torch.arange(s_full.shape[0], device=s_full.device)
            val = ws[b, idx]
            sgn = torch.sign(s_full[b, idx])
            dval = w_z[idx] * sgn * ds_full[b, idx]
            return val, dval

        return mis_norm

    def blockdiag_free(Ufree_q):
        """(B, nint, kq) -> (B, nz, kq + ncell) with an identity cell
        block: cell parameters are already nonredundant DOF."""
        Bsz, _, kq = Ufree_q.shape
        out = torch.zeros((Bsz, cfg.nz, kq + cfg.ncell),
                          dtype=Ufree_q.dtype, device=Ufree_q.device)
        out[:, :nint, :kq] = Ufree_q
        out[:, nint:, kq:] = torch.eye(cfg.ncell, dtype=Ufree_q.dtype,
                                       device=Ufree_q.device)
        return out

    def newton_set_x(c, x0, cells, q_after, dq_target, rows, qcons_rows):
        """x with q(x; cell_new) = q_after + dq_target: masked Newton with
        best-iterate tracking, fixed components pinned, inactive rows
        ignored. The JAX ``while_loop`` runs while any lane is not done
        and fewer than ``newton_maxiter`` iterations have passed; here
        that test is one host read per iteration. A done lane keeps its
        x through ``where``."""
        q_target = q_after + dq_target
        if ncons:
            q_target = q_target.scatter(
                1, qcons_rows.to(torch.int64),
                c["cons_target"][None].expand(q_target.shape[0], ncons))

        def resid(x):
            return wrap_dq(c, q_target - batch_q(x, cells)) * rows

        x = x0
        x_best = x0
        r_best = torch.amax(torch.abs(resid(x0)), dim=1)
        done = torch.zeros(x0.shape[0], dtype=torch.bool, device=x0.device)
        it = 0
        while it < cfg.newton_maxiter:
            step.host_syncs += 1
            if not bool(torch.any(~done)):
                break
            r = resid(x)
            rinf = torch.amax(torch.abs(r), dim=1)
            better = rinf < r_best
            x_best = torch.where(better[:, None], x, x_best)
            r_best = torch.where(better, rinf, r_best)
            done = done | (rinf < cfg.newton_tol)
            Bm = batch_B(x, cells) * rows[:, :, None]
            apply_pinv, _ = _gram_pinv(Bm, cfg.nred)
            dx = _bmtv(Bm, apply_pinv(r))
            x = torch.where(done[:, None], x, x + dx)
            it += 1
        step.newton_iters += it
        r_fin = resid(x)
        rinf_fin = torch.amax(torch.abs(r_fin), dim=1)
        better = rinf_fin < r_best
        return torch.where(better[:, None], x, x_best)

    def step(state: CellInternalSearchState, generator=None
             ) -> CellInternalSearchState:
        del generator
        c = built_for(state.x)
        cons_rows = state.qcons if ncons else c["cons_idx"]
        Bsz = state.x.shape[0]
        act = ~state.converged
        rows = state.qact.to(state.x.dtype)

        cells = batch_cell(state.s, state.cell0)
        Bm = batch_B(state.x, cells) * rows[:, :, None]
        # every caller passes float64 B, so the Gram eigh's float64
        # output of batched_eigh(G, "robust") matches its input
        apply_pinv, Ured_q = _gram_pinv(Bm, cfg.nred)
        Ufree_q = _split_fixed(Ured_q, cons_rows, ncons)
        Ufree_z = blockdiag_free(Ufree_q)          # (B, nz, nfree)

        gz = torch.cat([state.gq, state.gs], dim=1)
        UT = Ufree_z.transpose(1, 2)
        g_free = _bmtv(Ufree_z, gz)
        Hproj = UT @ state.H @ Ufree_z
        prep = prfo_prepare_batched(g_free, Hproj, cfg.order)

        with _span("restricted", state.x):
            dz_pred, smag = restricted_step_batched(
                g_free, Hproj, Ufree_z, state.delta, cfg, prep=prep,
                norm_fn=mis_norm_for(c),
            )
        dz_pred = torch.where(act[:, None], dz_pred, 0.0)
        dq_pred, ds = dz_pred[:, :nint] * rows, dz_pred[:, nint:]

        # ---- apply: cell first, then internals at the new cell ----
        s_new = state.s + ds
        cells_new = batch_cell(s_new, state.cell0)
        if cfg.rigid_fragments:
            # rigid transport to the new cell: fragments keep their
            # internal geometry, so the Newton solve only works on the
            # predicted dq
            x_base = batch_transport(state.x, cells, cells_new)
        else:
            x_base = state.x
        q_after = wrap_dq(c, batch_q(x_base, cells_new) - state.q) + state.q
        with _span("newton", state.x):
            x_new = newton_set_x(c, x_base, cells_new, q_after, dq_pred,
                                 rows, state.qcons)
        x_new = torch.where(act[:, None], x_new, state.x)
        q_new = wrap_dq(c, batch_q(x_new, cells_new) - state.q) + state.q

        f_new, g_new, gs_new = batch_eval(x_new, s_new, state.cell0)
        if cfg.rigid_fragments:
            # total cell derivative along the transported path
            gs_new = gs_new + batch_gs_corr(g_new, x_new, s_new,
                                            state.cell0)
        neval = state.neval + act.to(torch.int32)

        Bm_new = batch_B(x_new, cells_new) * rows[:, :, None]
        apply_pinv_new, Ured_q_new = _gram_pinv(Bm_new, cfg.nred)
        gq_new = apply_pinv_new(_bmv(Bm_new, g_new))

        # ---- trust ratio ----
        df_pred = (gz * dz_pred).sum(1) + 0.5 * (
            dz_pred * _bmv(state.H, dz_pred)).sum(1)
        df_actual = f_new - state.f
        pred_ok = torch.abs(df_pred) > cfg.pred_min
        ratio = torch.where(
            pred_ok, df_actual / torch.where(pred_ok, df_pred, 1.0), 1.0
        )

        # ---- TS-BFGS with the realized z secant ----
        dz_real = torch.cat([(q_new - state.q) * rows, s_new - state.s],
                            dim=1)
        gz_new = torch.cat([gq_new, gs_new], dim=1)
        # the internal block of the old gradient parallel-transported
        # into the post-step B frame, g_par = B_new (B_old^T G_old^+
        # gq_old); the cell block is not transported
        g0_cart = _bmtv(Bm, apply_pinv(state.gq))
        gq_par = _bmv(Bm_new, g0_cart)
        dgz = gz_new - torch.cat([gq_par, state.gs], dim=1)
        m1 = (torch.linalg.norm(dz_real, dim=1) > 1e-10)[:, None]
        H2 = ts_bfgs_update_batched(
            state.H, dz_real[:, :, None], dgz[:, :, None],
            m1 & act[:, None], absb=cfg.absb,
        )
        H2 = torch.where((act & m1[:, 0])[:, None, None], H2, state.H)

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

        # ---- convergence: projected forces AND cell gradient ----
        Ufree_new = _split_fixed(Ured_q_new, cons_rows, ncons)
        gqp = _bmv(Ufree_new, _bmtv(Ufree_new, gq_new))
        gp = _bmtv(Bm_new, gqp)
        fmax_now = torch.amax(
            torch.linalg.norm(gp.reshape(Bsz, n, 3), dim=2), dim=1)
        smax_now = (torch.amax(torch.abs(gs_new), dim=1) if cfg.ncell
                    else torch.zeros_like(fmax_now))
        conv_new = state.converged | (
            act & (fmax_now < cfg.fmax) & (smax_now < smax_tol))

        a1 = act[:, None]
        return CellInternalSearchState(
            x=torch.where(a1, x_new, state.x),
            s=torch.where(a1, s_new, state.s),
            q=torch.where(a1, q_new, state.q),
            f=torch.where(act, f_new, state.f),
            g=torch.where(a1, g_new, state.g),
            gs=torch.where(a1, gs_new, state.gs),
            gq=torch.where(a1, gq_new, state.gq),
            H=H2,
            delta=delta_new,
            rho=torch.where(act, ratio, state.rho),
            converged=conv_new,
            nsteps=state.nsteps + act.to(torch.int32),
            neval=neval,
            cell0=state.cell0,
            qact=state.qact,
            qcons=state.qcons,
        )

    step.newton_iters = 0
    step.host_syncs = 0
    # the trust norm and the dihedral wrap, for direct testing
    step.mis_norm = lambda s, ds: mis_norm_for(built_for(s))(s, ds)
    step.wrap_dq = lambda r: wrap_dq(built_for(r), r)
    return step


def _place_s(s, Bsz: int, ncell: int, like: torch.Tensor) -> torch.Tensor:
    if s is None:
        return torch.zeros((Bsz, ncell), dtype=like.dtype, device=like.device)
    if isinstance(s, torch.Tensor):
        return s.to(dtype=like.dtype, device=like.device).clone()
    return torch.as_tensor(np.asarray(s), dtype=like.dtype,
                           device=like.device)


def init_cell_internal_state(
    potential, ints, x0, cfg: CellInternalEnsembleConfig, cell0,
    cell_mask: Optional[np.ndarray] = None, s0=None, device=None,
) -> CellInternalSearchState:
    """Initialize the batched internal+cell state; the z-space Hessian
    guess is blockdiag(Lindh q-Hessian, ``h0_cell`` I). ``cell0`` is one
    (3, 3) base cell or (B, 3, 3) per lane; ``s0`` optional (B, ncell)
    initial cell parameters.

    A tensor ``x0`` keeps its device; any other ``x0`` goes to
    ``device``, by default the GPU, and raises where there is none
    (``device="cpu"`` asks for the CPU). The state is float64; the
    caller's ``x0``, ``s0`` and ``cell0`` are copied, never written."""
    x0 = _place_x0(x0, device).to(default_dtype()).clone()
    _check_potential_device(potential, x0.device)
    Bsz = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    n = cfg.natoms
    cons_idx0, _ = fixed_internal_constraints(ints)
    if len(cons_idx0) != cfg.ncons:
        raise ValueError(
            f"cfg.ncons={cfg.ncons} != mapped constraints "
            f"{len(cons_idx0)}"
        )
    cons_idx0 = np.asarray(cons_idx0, np.int64).reshape(-1)
    s0 = _place_s(s0, Bsz, cfg.ncell, x0)

    cell_of, make_enthalpy = _cell_map(cfg, cell_mask)
    cell0 = _place_cell0(cell0, Bsz, x0)
    cells = vmap(cell_of)(s0, cell0)

    f, g, gs = _batch_eval(make_enthalpy(potential))(x0, s0, cell0)
    if cfg.rigid_fragments:
        _, gs_corr = _rigid_maps(ints, cfg, cell_of)
        gs = gs + vmap(gs_corr)(g, x0, s0, cell0)
    batch_q, batch_B = _batch_qB(ints._get_engine(), n)
    q = batch_q(x0, cells)
    Bm = batch_B(x0, cells)
    apply_pinv, _ = _gram_pinv(Bm, cfg.nred)
    gq = apply_pinv(_bmv(Bm, g))

    H0 = np.zeros((cfg.nz, cfg.nz))
    H0[:cfg.nint, :cfg.nint] = ints.guess_hessian()
    H0[cfg.nint:, cfg.nint:] = cfg.h0_cell * np.eye(cfg.ncell)
    H0 = torch.as_tensor(H0, dtype=dtype, device=dev)

    i32 = dict(dtype=torch.int32, device=dev)
    return CellInternalSearchState(
        x=x0,
        s=s0,
        q=q,
        f=f,
        g=g,
        gs=gs,
        gq=gq,
        H=H0[None].expand(Bsz, cfg.nz, cfg.nz).clone(),
        delta=torch.full((Bsz,), cfg.delta0, dtype=dtype, device=dev),
        rho=torch.ones((Bsz,), dtype=dtype, device=dev),
        converged=torch.zeros(Bsz, dtype=torch.bool, device=dev),
        nsteps=torch.zeros(Bsz, **i32),
        neval=torch.ones(Bsz, **i32),
        cell0=cell0,
        qact=torch.ones((Bsz, cfg.nint), dtype=torch.bool, device=dev),
        qcons=torch.as_tensor(cons_idx0, **i32)[None].expand(
            Bsz, cfg.ncons).clone(),
    )


def realized_cells(state: CellInternalSearchState,
                   cfg: CellInternalEnsembleConfig,
                   cell_mask: Optional[np.ndarray] = None) -> torch.Tensor:
    """Per-lane realized cells ``expm(L(s)/factor) @ cell0``."""
    cell_of, _ = _cell_map(cfg, cell_mask)
    return vmap(cell_of)(state.s, state.cell0)


def _recompute_q_gq(state, merged, cfg, cell_mask):
    """(q, gq) of every lane in the (possibly grown) masked layout at
    the lane's realized cell; q continuity re-bases at principal values
    (every later difference is dihedral-wrapped)."""
    batch_q, batch_B = _batch_qB(merged._get_engine(), cfg.natoms)
    cells = realized_cells(state, cfg, cell_mask)
    q = batch_q(state.x, cells)
    Bm = batch_B(state.x, cells) * state.qact.to(state.x.dtype)[:, :, None]
    apply_pinv, _ = _gram_pinv(Bm, cfg.nred)
    gq = apply_pinv(_bmv(Bm, state.g))
    return q, gq


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def repave_cell_internal_lanes(
    state: CellInternalSearchState, ints,
    cfg: CellInternalEnsembleConfig, bad,
    cell_mask: Optional[np.ndarray] = None, atol_deg: float = 0.5,
):
    """Rebuild the topology of every ``bad`` lane from its current
    geometry at its current realized cell and keep it converging in
    place (the JAX package's ``repave_cell_internal_lanes``): per-lane
    rediscovery at the lane's cell, union-layout merge, per-lane
    ``qact`` rows, and the Hessian transferred through Cartesian space
    (q-block with the curvilinear corrections; cross block linearly,
    ``H'[qs] = Bn^{+T} (Bo^T H[qs])``; the cell block carried over
    untouched). The per-lane work is host numpy; q and gq are then
    re-derived for every lane on the state's device.

    Returns ``(state', ints', cfg', repaved_mask)``; rebuild the step
    function whenever ``cfg'.nint`` grew."""
    from .ensemble_internal import (
        _layout_offsets,
        _membership_rows,
        _old_to_new_map,
        merge_novel_internals,
        rebuild_internals_at,
    )

    bad = _np(bad).copy()
    lanes = np.where(bad)[0]
    if lanes.size == 0:
        return state, ints, cfg, bad

    n = cfg.natoms
    nint_old = cfg.nint
    xs = _np(state.x)
    cells = _np(realized_cells(state, cfg, cell_mask))
    rebuilt = {
        int(l): rebuild_internals_at(ints, xs[l].reshape(n, 3),
                                     cell=cells[l])
        for l in lanes
    }
    merged = ints
    for r in rebuilt.values():
        merged, _ = merge_novel_internals(merged, r)
    nint_new = merged.nint
    cfg_new = cfg._replace(nint=nint_new) if nint_new != cfg.nint else cfg

    # scatter every lane's old state into the new z layout: q rows move
    # by the rigid block shifts, the trailing cell rows just translate
    mp = _old_to_new_map(ints, merged)
    mz = np.concatenate([mp, nint_new + np.arange(cfg.ncell)])
    Bsz = xs.shape[0]
    qact_old = _np(state.qact)
    H_old_all = _np(state.H)
    qact = np.zeros((Bsz, nint_new), bool)
    qact[:, mp] = qact_old
    nz_new = nint_new + cfg.ncell
    H = np.zeros((Bsz, nz_new, nz_new), dtype=H_old_all.dtype)
    H[:, mz[:, None], mz[None, :]] = H_old_all
    novel = np.ones(nint_new, bool)
    novel[mp] = False
    if novel.any():
        hg = np.diag(merged.guess_hessian())
        H[:, np.where(novel)[0], np.where(novel)[0]] = hg[novel][None, :]

    eng_old = ints._get_engine()
    eng_new = merged._get_engine()
    gq_old_all = _np(state.gq)

    for l in lanes:
        lane = rebuilt[int(l)]
        pos = torch.as_tensor(xs[l].reshape(n, 3))
        cell_l = torch.as_tensor(cells[l])
        rows_new = _membership_rows(merged, lane)
        Bfull = eng_new._jac_impl(pos, cell_l).numpy()
        Bn = Bfull * rows_new[:, None]
        sv = np.linalg.svd(Bn, compute_uv=False)
        if int(np.sum(sv > 1e-8 * max(sv[0], 1e-300))) < cfg.nred:
            # rebuilt set too sparse: augment with previously active
            # rows, excluding the near-singular angles
            off_b, off_a, off_d, _, _ = _layout_offsets(merged)
            qv = eng_new._calc_impl(pos, cell_l).numpy()
            atol = np.radians(atol_deg)
            sing = np.zeros(nint_new, bool)
            sing[off_a:off_d] = (qv[off_a:off_d] < atol) | (
                qv[off_a:off_d] > np.pi - atol)
            rows_new = rows_new | (qact[l] & ~sing)
            Bn = Bfull * rows_new[:, None]
            sv = np.linalg.svd(Bn, compute_uv=False)
            if int(np.sum(sv > 1e-8 * max(sv[0], 1e-300))) < cfg.nred:
                bad[l] = False      # cannot repave this lane
                continue
        Bo = eng_old._jac_impl(pos, cell_l).numpy() * qact_old[l][:, None]
        gq_o = gq_old_all[l]
        g_cart = gq_o @ Bo
        Binv = np.linalg.pinv(Bn)
        gq_n = g_cart @ Binv
        hld_o = eng_old._hldot_impl(pos, cell_l,
                                    torch.as_tensor(gq_o)).numpy()
        hld_n = eng_new._hldot_impl(pos, cell_l,
                                    torch.as_tensor(gq_n)).numpy()
        Hqq_o = H_old_all[l, :nint_old, :nint_old]
        Hqs_o = H_old_all[l, :nint_old, nint_old:]
        Hcart = Bo.T @ Hqq_o @ Bo + hld_o
        H[int(l), :nint_new, :nint_new] = Binv.T @ (Hcart - hld_n) @ Binv
        Hqs_n = Binv.T @ (Bo.T @ Hqs_o)
        H[int(l), :nint_new, nint_new:] = Hqs_n
        H[int(l), nint_new:, :nint_new] = Hqs_n.T
        qact[int(l)] = rows_new

    dev, dtype = state.x.device, state.x.dtype
    mp_t = torch.as_tensor(mp, device=dev)
    state = state._replace(
        H=torch.as_tensor(H, dtype=dtype, device=dev),
        qact=torch.as_tensor(qact, device=dev),
        # constraint rows ride the rigid block shifts of the union
        qcons=mp_t[state.qcons.to(torch.int64)].to(torch.int32),
    )
    q, gq = _recompute_q_gq(state, merged, cfg_new, cell_mask)
    return state._replace(q=q, gq=gq), merged, cfg_new, bad


def niggli_rebase_cell_internal_lanes(
    state: CellInternalSearchState, ints,
    cfg: CellInternalEnsembleConfig,
    cell_mask: Optional[np.ndarray] = None,
    angle_threshold: float = 30.0,
    potential=None,
    pbc: Optional[np.ndarray] = None,
):
    """Per-lane cell rebase for the batched internal+cell tier (the JAX
    package's ``niggli_rebase_cell_internal_lanes``). For every
    unconverged lane whose realized cell has an angle more than
    ``angle_threshold`` degrees from 90:

    1. reduce the lattice basis (``new_cell = M @ cell``, M integer
       unimodular);
    2. reset the lane's base cell to the reduced cell and zero its
       parameters (positions untouched);
    3. remap the lane's periodic image offsets ``nc -> nc @ M^{-1}``:
       remapped entries merge into the union layout, and the lane's
       ``qact`` becomes exactly the remapped set (its fixed-coordinate
       rows in ``qcons`` follow the same remap);
    4. transform the Hessian: q rows and columns permute to their
       remapped positions; the cell block and cross columns transform by
       ``T = J_old^{-1} (M^{-1} kron I) J_new``.

    With ``potential`` given, (f, g, gs) of the rebased lanes are
    re-evaluated. Returns ``(state', ints', cfg', rebased_mask)`` with
    the mask a bool tensor on the state's device; rebuild the step
    function whenever ``cfg'.nint`` grew."""
    from types import SimpleNamespace

    from ..coords import topology as topo_mod
    from ..pes.cell import _cell_param_jacobian
    from ..utils.lattice import reduce_cell_basis
    from .ensemble_internal import (
        _layout_offsets,
        _old_to_new_map,
        merge_novel_internals,
    )

    if cell_mask is None:
        cell_mask = np.ones((3, 3), dtype=bool)
    if pbc is None:
        periodic_axes = (0, 1, 2)
    else:
        pbc = np.asarray(pbc, dtype=bool)
        periodic_axes = tuple(i for i in range(3) if pbc[i])
    axis_pairs = [
        (i, j) for ai, i in enumerate(periodic_axes)
        for j in periodic_axes[ai + 1:]
    ]
    midx = np.where(np.asarray(cell_mask, bool).ravel())[0]
    factor = (cfg.exp_cell_factor if cfg.exp_cell_factor > 0
              else float(cfg.natoms))
    nint_old = cfg.nint
    dev = state.x.device

    def _angle_dev(cell):
        norms = np.linalg.norm(cell, axis=1)
        if np.any(norms[list(periodic_axes)] < 1e-10):
            return None              # degenerate row: skip, don't NaN
        devs = [0.0]
        for i, j in axis_pairs:
            c = cell[i] @ cell[j] / (norms[i] * norms[j])
            devs.append(
                abs(np.degrees(np.arccos(np.clip(c, -1, 1))) - 90.0))
        return max(devs)

    ss = _np(state.s).copy()
    c0 = _np(state.cell0).copy()
    conv = _np(state.converged)
    cells = _np(realized_cells(state, cfg, cell_mask))
    Bsz = ss.shape[0]
    rebased = np.zeros(Bsz, bool)
    qact_old = _np(state.qact)
    qcons_old = _np(state.qcons).astype(np.int64)
    off_b, off_a, off_d, off_o, _ = _layout_offsets(ints)

    # -- pass 1: decide per-lane rebases, build remapped topologies ----
    plans = {}
    for lane in range(Bsz):
        if conv[lane]:
            continue
        cell = cells[lane]
        dev_deg = _angle_dev(cell)
        if dev_deg is None or dev_deg <= angle_threshold:
            continue
        new_cell, M = reduce_cell_basis(cell, pbc=pbc)
        new_dev = _angle_dev(new_cell)
        if new_dev is None or new_dev >= dev_deg - 1e-9:
            continue                     # reduction gained nothing
        Minv = np.rint(np.linalg.inv(M)).astype(np.int64)
        assert np.array_equal(M @ Minv, np.eye(3, dtype=np.int64))
        lane_topo = SimpleNamespace(bonds=[], angles=[], dihedrals=[])
        src_rows, keys = [], []
        for m, (i, j, nc) in enumerate(ints.bonds):
            r = off_b + m
            if not qact_old[lane, r]:
                continue
            nc2 = np.asarray(nc, np.int64) @ Minv
            lane_topo.bonds.append((i, j, nc2))
            src_rows.append(r)
            keys.append(("b", topo_mod._bond_key(i, j, nc2)))
        for m, (i, j, k, ncvs) in enumerate(ints.angles):
            r = off_a + m
            if not qact_old[lane, r]:
                continue
            nc2 = np.asarray(ncvs, np.int64) @ Minv
            lane_topo.angles.append((i, j, k, nc2))
            src_rows.append(r)
            keys.append(("a", topo_mod._angle_key(i, j, k, nc2)))
        for m, (i, j, k, l2, ncvs) in enumerate(ints.dihedrals):
            r = off_d + m
            if not qact_old[lane, r]:
                continue
            nc2 = np.asarray(ncvs, np.int64) @ Minv
            lane_topo.dihedrals.append((i, j, k, l2, nc2))
            src_rows.append(r)
            keys.append(("d", topo_mod._dihedral_key(i, j, k, l2, nc2)))
        plans[lane] = (new_cell, M, lane_topo, src_rows, keys)
        rebased[lane] = True

    if not rebased.any():
        return state, ints, cfg, torch.as_tensor(rebased, device=dev)

    merged = ints
    for (_, _, lane_topo, _, _) in plans.values():
        merged, _ = merge_novel_internals(merged, lane_topo)
    nint_new = merged.nint
    cfg_new = cfg._replace(nint=nint_new) if nint_new != cfg.nint else cfg

    # merged-layout key -> row index
    offs = _layout_offsets(merged)
    key_pos = {}
    for m, (i, j, nc) in enumerate(merged.bonds):
        key_pos[("b", topo_mod._bond_key(i, j, nc))] = offs[0] + m
    for m, (i, j, k, ncvs) in enumerate(merged.angles):
        key_pos[("a", topo_mod._angle_key(i, j, k, ncvs))] = offs[1] + m
    for m, (i, j, k, l2, ncvs) in enumerate(merged.dihedrals):
        key_pos[("d", topo_mod._dihedral_key(i, j, k, l2, ncvs))] = (
            offs[2] + m)

    # scatter every lane into the new z layout (rigid block shifts)
    mp = _old_to_new_map(ints, merged)
    qcons_new = mp[qcons_old]
    mz = np.concatenate([mp, nint_new + np.arange(cfg.ncell)])
    qact = np.zeros((Bsz, nint_new), bool)
    qact[:, mp] = qact_old
    nz_new = nint_new + cfg.ncell
    H_old_all = _np(state.H)
    H = np.zeros((Bsz, nz_new, nz_new), dtype=H_old_all.dtype)
    H[:, mz[:, None], mz[None, :]] = H_old_all
    novel = np.ones(nint_new, bool)
    novel[mp] = False
    if novel.any():
        hg = np.diag(merged.guess_hessian())
        H[:, np.where(novel)[0], np.where(novel)[0]] = hg[novel][None, :]

    for lane, (new_cell, M, lane_topo, src_rows, keys) in plans.items():
        # source rows: always-active translation/other/rotation rows keep
        # their (shifted) positions; remapped rows go to their keys
        src = np.concatenate([
            np.arange(off_b),
            np.arange(off_o, nint_old),
            np.asarray(src_rows, np.int64),
        ]).astype(np.int64)
        tgt = np.concatenate([
            mp[:off_b],
            mp[off_o:nint_old],
            np.asarray([key_pos[k] for k in keys], np.int64),
        ]).astype(np.int64)
        assert len(np.unique(tgt)) == len(tgt)

        L = np.zeros(9)
        L[midx] = ss[lane]
        L = L.reshape(3, 3)
        J_old = _cell_param_jacobian(L, c0[lane], factor)
        J_new = _cell_param_jacobian(np.zeros((3, 3)), new_cell, factor)
        K = np.kron(np.linalg.inv(M), np.eye(3))
        T = np.linalg.solve(J_old, K @ J_new)[np.ix_(midx, midx)]

        Hl = np.zeros((nz_new, nz_new), H.dtype)
        hg = np.diag(merged.guess_hessian())
        Hl[:nint_new, :nint_new] = np.diag(hg)
        Hqq_o = H_old_all[lane, :nint_old, :nint_old]
        Hqs_o = H_old_all[lane, :nint_old, nint_old:]
        Hss_o = H_old_all[lane, nint_old:, nint_old:]
        Hl[tgt[:, None], tgt[None, :]] = Hqq_o[src[:, None], src[None, :]]
        cross = Hqs_o[src] @ T
        Hl[tgt, nint_new:] = cross
        Hl[nint_new:, tgt] = cross.T
        Hl[nint_new:, nint_new:] = T.T @ Hss_o @ T
        H[lane] = Hl

        qact[lane] = False
        qact[lane, tgt] = True
        ss[lane] = 0.0
        c0[lane] = new_cell
        # constraint member rows follow the same remap as their
        # coordinates (active rows are all in src by construction)
        rowmap = dict(zip(src.tolist(), tgt.tolist()))
        qcons_new[lane] = [rowmap[int(r)] for r in qcons_old[lane]]

    dtype = state.x.dtype
    rebased_t = torch.as_tensor(rebased, device=dev)
    state = state._replace(
        s=torch.as_tensor(ss, dtype=dtype, device=dev),
        cell0=torch.as_tensor(c0, dtype=dtype, device=dev),
        H=torch.as_tensor(H, dtype=dtype, device=dev),
        qact=torch.as_tensor(qact, device=dev),
        qcons=torch.as_tensor(qcons_new, dtype=torch.int32, device=dev),
    )
    q, gq = _recompute_q_gq(state, merged, cfg_new, cell_mask)
    state = state._replace(q=q, gq=gq)
    if potential is not None:
        state = refresh_cell_internal(
            state, potential, merged, cfg_new, None,
            cell_mask=cell_mask, mask=rebased_t,
        )
    return state, merged, cfg_new, rebased_t


def run_cell_internal_ensemble(
    potential, ints, x0, cfg: CellInternalEnsembleConfig,
    cell0, cell_mask: Optional[np.ndarray] = None,
    s0=None, max_steps: int = 100,
    mesh=None, seed: int = 0, steps_per_call: int = 1,
    repave: bool = False, repave_atol_deg: float = 0.5,
    max_repaves_per_lane: int = 2,
    niggli: bool = False, niggli_threshold: float = 30.0,
    pbc: Optional[np.ndarray] = None,
    device=None,
):
    """Host loop driving the batched internal+cell step until every lane
    converges (or ``max_steps``), checking convergence once every
    ``steps_per_call`` steps.

    ``repave=True`` enables the per-lane bad-internal recovery
    (:func:`repave_cell_internal_lanes`) and ``niggli=True`` the
    per-lane cell rebase (:func:`niggli_rebase_cell_internal_lanes`),
    both checked before every chunk; the step function is rebuilt when
    the union layout grows. With either flag the return value is
    ``(state, ints)``. ``seed`` is accepted for compatibility: the step
    draws nothing.

    Device rule as in :func:`init_cell_internal_state`; ``mesh=`` is not
    ported and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "run_cell_internal_ensemble(mesh=...) is not ported to "
            "sella_tpu_torch yet (ROADMAP.md)"
        )
    del seed
    state = init_cell_internal_state(potential, ints, x0, cfg, cell0,
                                     cell_mask, s0, device=device)
    step = make_cell_internal_step_fn(potential, ints, cfg, None, cell_mask)
    n_calls = (max_steps + steps_per_call - 1) // steps_per_call
    nrepaves = np.zeros(state.x.shape[0], np.int64)
    for _ in range(n_calls):
        if repave or niggli:
            nint_before = cfg.nint
            if repave:
                from .ensemble_internal import bad_internals_mask

                bad = _np(bad_internals_mask(state, ints, repave_atol_deg))
                bad &= ~_np(state.converged)
                bad &= nrepaves < max_repaves_per_lane
                if bad.any():
                    state, ints, cfg, _ = repave_cell_internal_lanes(
                        state, ints, cfg, bad, cell_mask,
                        atol_deg=repave_atol_deg,
                    )
                    nrepaves[bad] += 1      # count attempts, even failed
            if niggli:
                state, ints, cfg, _ = niggli_rebase_cell_internal_lanes(
                    state, ints, cfg, cell_mask,
                    angle_threshold=niggli_threshold,
                    potential=potential, pbc=pbc,
                )
            if cfg.nint != nint_before:
                step = make_cell_internal_step_fn(potential, ints, cfg,
                                                  None, cell_mask)
        for _ in range(steps_per_call):
            state = step(state)
        if bool(torch.all(state.converged)):
            break
    if repave or niggli:
        return state, ints
    return state


def refresh_cell_internal(
    state: CellInternalSearchState, potential, ints,
    cfg: CellInternalEnsembleConfig, cell0=None,
    cell_mask: Optional[np.ndarray] = None,
    mask: Optional[torch.Tensor] = None,
) -> CellInternalSearchState:
    """Recompute (f, g, gs, q, gq) for all lanes (once after a refill or
    a rebase); only ``mask`` lanes' neval counters advance. ``cell0`` is
    accepted for compatibility and unused (the base cell is per-lane
    state)."""
    del cell0
    n = cfg.natoms
    cell_of, make_enthalpy = _cell_map(cfg, cell_mask)
    cells = vmap(cell_of)(state.s, state.cell0)
    f, g, gs = _batch_eval(make_enthalpy(potential))(state.x, state.s,
                                                     state.cell0)
    if cfg.rigid_fragments:
        _, gs_corr = _rigid_maps(ints, cfg, cell_of)
        gs = gs + vmap(gs_corr)(g, state.x, state.s, state.cell0)
    batch_q, batch_B = _batch_qB(ints._get_engine(), n)
    q = batch_q(state.x, cells)
    Bm = batch_B(state.x, cells) * state.qact.to(state.x.dtype)[:, :, None]
    apply_pinv, _ = _gram_pinv(Bm, cfg.nred)
    gq = apply_pinv(_bmv(Bm, g))
    inc = 1 if mask is None else mask.to(state.neval.dtype)
    return state._replace(f=f, g=g, gs=gs, q=q, gq=gq,
                          neval=state.neval + inc)


def run_cell_internal_ensemble_queue(
    potential, ints, x0_all, cfg: CellInternalEnsembleConfig, cell0,
    batch: int, cell_mask: Optional[np.ndarray] = None, s0_all=None,
    max_steps_per_search: int = 200, refill_every: int = 10,
    seed: int = 0, mesh=None, device=None,
):
    """Work-queue compaction for the internal+cell tier (the JAX
    package's ``run_cell_internal_ensemble_queue``): every
    ``refill_every`` steps, finished lanes (converged, or at
    ``max_steps_per_search``) are harvested and refilled from the queue
    on the shared base cell and the full shared topology. Returns
    per-input dicts ``{x, s, f, nsteps, converged}`` in input order.

    The searches run on ``x0_all``'s device when it is a tensor; any
    other ``x0_all`` goes to ``device``, by default the GPU, and raises
    where there is none (``device="cpu"`` asks for the CPU). The
    caller's ``x0_all`` and ``s0_all`` are read, never written.
    ``mesh=`` is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "run_cell_internal_ensemble_queue(mesh=...) is not ported to "
            "sella_tpu_torch yet (ROADMAP.md)"
        )
    del seed
    dev = _target_device(x0_all, device)
    x0_np = _np(x0_all).astype(np.float64)
    total = x0_np.shape[0]
    s0_np = (np.zeros((total, cfg.ncell)) if s0_all is None
             else _np(s0_all).astype(np.float64))
    dtype = default_dtype()
    cell0_t = torch.as_tensor(_np(cell0), dtype=dtype, device=dev)

    step = make_cell_internal_step_fn(potential, ints, cfg, None, cell_mask)
    state = init_cell_internal_state(
        potential, ints, torch.as_tensor(x0_np[:batch], device=dev), cfg,
        cell0_t, cell_mask, s0_np[:batch],
    )
    batch = state.x.shape[0]
    H0 = state.H[0].clone()
    origin = np.arange(batch)
    next_idx = batch
    results: dict = {}

    while len(results) < total:
        for _ in range(refill_every):
            state = step(state)

        conv = _np(state.converged)
        nsteps = _np(state.nsteps)
        done = conv | (nsteps >= max_steps_per_search)
        if not np.any(done):
            continue

        xs = _np(state.x)
        ss = _np(state.s)
        fs = _np(state.f)
        for lane in np.where(done)[0]:
            oi = origin[lane]
            if oi >= 0 and oi not in results:
                results[oi] = dict(
                    x=xs[lane].copy(), s=ss[lane].copy(),
                    f=float(fs[lane]), nsteps=int(nsteps[lane]),
                    converged=bool(conv[lane]),
                )

        x_fill = xs.copy()
        s_fill = ss.copy()
        take = np.zeros(batch, dtype=bool)
        new_origin = origin.copy()
        for lane in np.where(done)[0]:
            if next_idx < total:
                x_fill[lane] = x0_np[next_idx]
                s_fill[lane] = s0_np[next_idx]
                take[lane] = True
                new_origin[lane] = next_idx
                next_idx += 1
            else:
                new_origin[lane] = -1
        take_t = torch.as_tensor(take, device=dev)
        tk = take_t[:, None]
        done_t = torch.as_tensor(done, device=dev)
        idle_t = torch.as_tensor(new_origin < 0, device=dev)
        state = state._replace(
            x=torch.where(tk, torch.as_tensor(x_fill, dtype=dtype,
                                              device=dev), state.x),
            s=torch.where(tk, torch.as_tensor(s_fill, dtype=dtype,
                                              device=dev), state.s),
            H=torch.where(take_t[:, None, None], H0[None], state.H),
            delta=torch.where(take_t, cfg.delta0, state.delta),
            rho=torch.where(take_t, 1.0, state.rho),
            converged=((done_t | state.converged) & ~take_t) | idle_t,
            nsteps=torch.where(take_t, 0, state.nsteps).to(torch.int32),
            neval=torch.where(take_t, 0, state.neval).to(torch.int32),
            # refilled lanes restart from the shared base cell and the
            # full shared topology
            cell0=torch.where(take_t[:, None, None], cell0_t, state.cell0),
            qact=torch.where(tk, True, state.qact),
        )
        if take.any():
            state = refresh_cell_internal(state, potential, ints, cfg, None,
                                          cell_mask, take_t)
        origin = new_origin

    return [results[i] for i in range(total)]
