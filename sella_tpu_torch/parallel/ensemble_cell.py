"""Batched ensemble optimization of atoms + cell (the variable-cell tier).

Counterpart of ``sella_tpu/parallel/ensemble_cell.py``. Each lane's DOF
vector is ``z = [x_cart (3n), s (ncell)]``, where ``s`` holds the masked
entries of the scaled log-deformation L and ``cell = expm(L / factor) @
cell0``. The enthalpy ``E + P V`` is one differentiable scalar, so the
atom forces, the cell gradient and the exact Hessian-vector products of
the Davidson diagonalization all come from ``torch.func`` through
:func:`sella_tpu_torch.ops.linalg.expm`, batched over lanes with
``vmap``.

* One base cell per lane (``CellSearchState.cell0``): the per-lane
  Niggli rebase (:func:`niggli_rebase_cell_lanes`) replaces a skewed
  lane's base cell between step chunks.
* The rigid-mode projection is constant: under periodic boundary
  conditions only the 3 atom translations are free, so one host-side
  complete QR serves every lane and step.
* Convergence: max per-atom projected force < fmax AND max |dE/ds| <
  smax.

The JAX package's structured control flow becomes host control flow, as
in :mod:`.ensemble`: the scheduled Davidson's ``lax.cond(jnp.any(ev))``
is one host test, the ``fori_loop`` over ``steps_per_call`` a Python
loop, and the Davidson dead-vector draw comes from a ``torch.Generator``.
The step reuses the Cartesian tier's Davidson, Ritz, P-RFO and TS-BFGS
functions. Not ported: sharding over a mesh (``mesh=`` raises).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, grad_and_value, jvp, vmap

from ..config import default_dtype
from ..ops.linalg import det3, expm
from .ensemble import (
    _check_potential_device,
    _davidson_loop,
    _masked_ritz,
    _place_x0,
    _target_device,
    prfo_prepare_batched,
    restricted_step_batched,
    ts_bfgs_update_batched,
)


class CellEnsembleConfig(NamedTuple):
    """Static configuration of a batched atom+cell search (field names,
    defaults and meanings as in ``sella_tpu.parallel.ensemble_cell.
    CellEnsembleConfig``). ``ncell`` is the True count of the 3x3
    ``cell_mask``; ``exp_cell_factor`` <= 0 means ``float(natoms)``."""

    natoms: int
    ncell: int = 9
    order: int = 0
    nproj: int = 3                 # atom translations only (PBC)
    fmax: float = 1e-3
    smax: float = 0.0              # 0 -> use fmax
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
    rs: str = "tr"
    eig: bool = False              # minima by default (order=0)
    exp_cell_factor: float = 0.0
    scalar_pressure: float = 0.0
    absb: str = "eigh"             # TS-BFGS |B| metric: "eigh" or "ns"
    pred_min: float = 1e-14        # smallest trusted |predicted dE|

    @property
    def dim(self) -> int:
        return 3 * self.natoms + self.ncell

    @property
    def nfree(self) -> int:
        return self.dim - self.nproj

    @property
    def subspace_max(self) -> int:
        m = self.nfree
        k = self.davidson_max if self.davidson_max > 0 else 2 * m + 1
        return min(m, k)


class CellSearchState(NamedTuple):
    """Per-search state; every field has a leading batch axis."""

    z: torch.Tensor            # (B, 3n + ncell) positions + cell params
    f: torch.Tensor            # (B,) enthalpy E + PV
    g: torch.Tensor            # (B, 3n + ncell) gradient
    H: torch.Tensor            # (B, dim, dim) quasi-Newton Hessian
    delta: torch.Tensor
    rho: torch.Tensor
    nsteps_since_diag: torch.Tensor
    converged: torch.Tensor
    nsteps: torch.Tensor
    neval: torch.Tensor
    nmatvec: torch.Tensor
    cell0: torch.Tensor        # (B, 3, 3) per-lane base cell, the
    #   log-deformation reference; constant between rebase events


def _const_free_basis(natoms: int, ncell: int, nproj: int) -> np.ndarray:
    """Orthonormal complement of the (constant) translation generators:
    (dim, dim - nproj), shared by all lanes and steps."""
    dim = 3 * natoms + ncell
    if nproj == 0:
        return np.eye(dim)
    if nproj != 3:
        raise ValueError("cell tier supports nproj in (0, 3)")
    T = np.zeros((dim, 3))
    for a in range(3):
        T[np.arange(natoms) * 3 + a, a] = 1.0 / np.sqrt(natoms)
    Q = np.linalg.qr(T, mode="complete")[0]
    return Q[:, 3:]


def _cell_factor(cfg: CellEnsembleConfig) -> float:
    return (cfg.exp_cell_factor if cfg.exp_cell_factor > 0
            else float(cfg.natoms))


def _initial_hessian(cfg: CellEnsembleConfig, like: torch.Tensor):
    """The block-diagonal bootstrap Hessian: 70 eV/A^2 on the Cartesian
    block, identity on the cell block (float64, on ``like``'s device)."""
    H0 = np.zeros((cfg.dim, cfg.dim))
    H0[: 3 * cfg.natoms, : 3 * cfg.natoms] = 70.0 * np.eye(3 * cfg.natoms)
    H0[3 * cfg.natoms:, 3 * cfg.natoms:] = np.eye(cfg.ncell)
    return torch.as_tensor(H0, dtype=like.dtype, device=like.device)


def make_ext_energy_c0(potential, cfg: CellEnsembleConfig,
                       cell_mask: np.ndarray):
    """The differentiable extended objective ``(z, cell0) -> E + PV`` with
    the base cell as a per-call argument, and ``cell_of(s, cell0)``.
    Gradients w.r.t. z give the forces and the cell gradient at once.

    L is stacked from the free entries of ``s`` and zeros: exact, like
    the JAX package's ``.at[mask].set(s)``, and valid under ``vmap`` and
    forward-over-reverse alike, with no constant tensor to move between
    devices. The pressure term's volume is the triple product
    (:func:`~sella_tpu_torch.ops.linalg.det3`)."""
    if not getattr(potential, "has_stress", True):
        raise ValueError(
            "this potential has no stress source: cell DOF derivatives "
            "would be silently wrong"
        )
    nr3 = 3 * cfg.natoms
    factor = _cell_factor(cfg)
    midx = np.where(np.asarray(cell_mask, dtype=bool).ravel())[0]
    if midx.shape[0] != cfg.ncell:
        raise ValueError(
            f"cell_mask has {midx.shape[0]} free entries, "
            f"cfg.ncell={cfg.ncell}"
        )
    slot = {int(m): j for j, m in enumerate(midx)}   # entry of L -> s
    pressure = cfg.scalar_pressure

    def cell_of(s, cell0):
        zero = torch.zeros_like(s[0])
        L = torch.stack([s[slot[i]] if i in slot else zero
                         for i in range(9)]).reshape(3, 3)
        return expm(L / factor) @ cell0

    def ext_energy(z, cell0):
        x, s = z[:nr3], z[nr3:]
        cell = cell_of(s, cell0)
        e = potential.energy(x, cell)
        if pressure != 0.0:
            e = e + pressure * torch.abs(det3(cell))
        return e

    return ext_energy, cell_of


def make_ext_energy(potential, cfg: CellEnsembleConfig, cell0,
                    cell_mask: np.ndarray):
    """:func:`make_ext_energy_c0` with one shared base cell closed over."""
    e2, c2 = make_ext_energy_c0(potential, cfg, cell_mask)
    cell0 = torch.as_tensor(cell0)
    return (lambda z: e2(z, cell0.to(z))), (lambda s: c2(s, cell0.to(s)))


def _batched_cell_eval(ext_energy):
    """(B, dim), (B, 3, 3) -> (f (B,), g (B, dim)) through ``vmap``."""
    def one(z, c0):
        g, e = grad_and_value(ext_energy)(z, c0)
        return e, g

    return vmap(one)


def make_cell_step_fn(potential, cfg: CellEnsembleConfig,
                      cell0=None, cell_mask: Optional[np.ndarray] = None):
    """Build the batched atom+cell RS-(P-)RFO step ``step(state,
    generator) -> state`` (the input state is never modified).

    ``cell0`` is accepted for compatibility and unused: the base cells
    live in the state. The P-RFO prep of the pre-diagonalization Hessian
    is computed only where the saddle schedule reads it (``cfg.eig and
    cfg.order > 0``); a minimization pays one prep eigh a step."""
    del cell0
    if cell_mask is None:
        cell_mask = np.ones((3, 3), dtype=bool)
    ext_energy, _ = make_ext_energy_c0(potential, cfg, cell_mask)
    nr3 = 3 * cfg.natoms
    n = cfg.natoms

    batch_eval = _batched_cell_eval(ext_energy)

    def one_hvp(z1, u1, c01):
        return jvp(lambda zz: grad(ext_energy)(zz, c01), (z1,), (u1,))[1]

    batch_hvp = vmap(one_hvp)

    Ufree_np = _const_free_basis(cfg.natoms, cfg.ncell, cfg.nproj)
    bases = {}
    smax = cfg.smax if cfg.smax > 0 else cfg.fmax
    K = cfg.subspace_max

    def basis_for(z):
        key = (z.device, z.dtype)
        if key not in bases:
            bases[key] = torch.as_tensor(Ufree_np, dtype=z.dtype,
                                         device=z.device)
        return bases[key]

    def project(H, Ufree):
        return torch.einsum("ji,bjk,kl->bil", Ufree, H, Ufree)

    def davidson_absorb(z, g, H, active, generator, c0, Ufree):
        """Batched Davidson with exact extended-objective HVPs; every
        probe absorbed into H (TS-BFGS)."""

        def hvp_free(v_free):
            w = batch_hvp(z, v_free @ Ufree.T, c0)
            return w @ Ufree, w

        V, AVp, YF, k = _davidson_loop(
            hvp_free, project(H, Ufree), g @ Ufree, cfg.gamma, K, active,
            generator,
        )
        lams, W, colmask = _masked_ritz(V, AVp, k, K)
        Vr = torch.einsum("bik,bkl->bil", V, W)
        YFr = torch.einsum("bik,bkl->bil", YF, W)
        S_full = torch.einsum("ij,bjk->bik", Ufree, Vr)
        H_new = ts_bfgs_update_batched(H, S_full, YFr, colmask,
                                       absb=cfg.absb)
        return torch.where(active[:, None, None], H_new, H), k

    def step(state: CellSearchState, generator=None) -> CellSearchState:
        Ufree = basis_for(state.z)
        Bsz = state.z.shape[0]
        dev = state.z.device
        act = ~state.converged

        g_free = state.g @ Ufree

        # ---- diag scheduling (saddles only) ----
        if cfg.eig and cfg.order > 0:
            lams_proj = prfo_prepare_batched(
                g_free, project(state.H, Ufree), cfg.order)[0]
            too_few = torch.any(lams_proj[:, : cfg.order] > 0, dim=1)
            too_many = (
                lams_proj[:, cfg.order] < 0
                if cfg.order < cfg.nfree
                else torch.zeros(Bsz, dtype=torch.bool, device=dev)
            )
            ev = act & (state.nsteps_since_diag >= cfg.nsteps_per_diag) & (
                too_few | too_many
            )
            ev = ev | (act & (state.nsteps == 0))
        else:
            ev = torch.zeros(Bsz, dtype=torch.bool, device=dev)
        if cfg.diag_every_n > 0:
            ev = ev | (act & (state.nsteps_since_diag >= cfg.diag_every_n))

        if bool(torch.any(ev)):
            H1, k_diag = davidson_absorb(state.z, state.g, state.H, ev,
                                         generator, state.cell0, Ufree)
        else:
            H1 = state.H
            k_diag = torch.zeros(Bsz, dtype=state.nsteps.dtype, device=dev)
        nmv = state.nmatvec + torch.where(ev, k_diag, 0).to(torch.int32)
        nsd = torch.where(ev, 0, state.nsteps_since_diag + 1).to(
            torch.int32)

        # ---- trust-region step ----
        Hproj1 = project(H1, Ufree)
        prep1 = prfo_prepare_batched(g_free, Hproj1, cfg.order)
        Ufree_b = Ufree.expand((Bsz,) + Ufree.shape)
        dz, smag = restricted_step_batched(
            g_free, Hproj1, Ufree_b, state.delta, cfg, prep=prep1
        )
        dz = torch.where(act[:, None], dz, 0.0)

        z_new = state.z + dz
        f_new, g_new = batch_eval(z_new, state.cell0)
        neval = state.neval + act.to(torch.int32)

        # ---- trust ratio ----
        df_pred = torch.einsum("bi,bi->b", state.g, dz) + 0.5 * torch.einsum(
            "bi,bij,bj->b", dz, H1, dz
        )
        df_actual = f_new - state.f
        pred_ok = torch.abs(df_pred) > cfg.pred_min
        ratio = torch.where(
            pred_ok, df_actual / torch.where(pred_ok, df_pred, 1.0), 1.0
        )

        # ---- quasi-Newton update with the realized secant ----
        dg = g_new - state.g
        m1 = (torch.linalg.norm(dz, dim=1) > 1e-10)[:, None]
        H2 = ts_bfgs_update_batched(
            H1, dz[:, :, None], dg[:, :, None], m1 & act[:, None],
            absb=cfg.absb,
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

        # ---- convergence ----
        gp = (g_new @ Ufree) @ Ufree.T
        fmax_now = torch.amax(
            torch.linalg.norm(gp[:, :nr3].reshape(Bsz, n, 3), dim=2), dim=1
        )
        smax_now = (
            torch.amax(torch.abs(g_new[:, nr3:]), dim=1)
            if cfg.ncell else torch.zeros(Bsz, dtype=g_new.dtype, device=dev)
        )
        conv_new = state.converged | (
            act & (fmax_now < cfg.fmax) & (smax_now < smax)
        )

        return CellSearchState(
            z=torch.where(act[:, None], z_new, state.z),
            f=torch.where(act, f_new, state.f),
            g=torch.where(act[:, None], g_new, state.g),
            H=H2,
            delta=delta_new,
            rho=torch.where(act, ratio, state.rho),
            nsteps_since_diag=nsd,
            converged=conv_new,
            nsteps=state.nsteps + act.to(torch.int32),
            neval=neval,
            nmatvec=nmv,
            cell0=state.cell0,
        )

    return step


def _place_cell0(cell0, Bsz: int, like: torch.Tensor) -> torch.Tensor:
    """Base cell(s) as a (B, 3, 3) float64 tensor on ``like``'s device;
    one (3, 3) cell is shared by every lane."""
    if isinstance(cell0, torch.Tensor):
        cell0 = cell0.to(dtype=like.dtype, device=like.device)
    else:
        cell0 = torch.as_tensor(np.asarray(cell0), dtype=like.dtype,
                                device=like.device)
    if cell0.ndim == 2:
        cell0 = cell0[None].expand(Bsz, 3, 3)
    return cell0.clone()


def init_cell_state(
    potential, x0, cfg: CellEnsembleConfig, cell0,
    cell_mask: Optional[np.ndarray] = None, s0=None, device=None,
) -> CellSearchState:
    """Initialize the batched atom+cell state. ``x0`` is (B, 3n) Cartesian
    positions; ``s0`` optional (B, ncell) initial cell parameters (zeros
    = the base cell); ``cell0`` one (3, 3) base cell or (B, 3, 3) per
    lane. The initial Hessian is block-diagonal: 70 eV/A^2 on the
    Cartesian block, identity on the cell block.

    A tensor ``x0`` keeps its device; any other ``x0`` goes to
    ``device``, by default the GPU, and raises where there is none
    (``device="cpu"`` asks for the CPU). The state is float64."""
    if cell_mask is None:
        cell_mask = np.ones((3, 3), dtype=bool)
    ext_energy, _ = make_ext_energy_c0(potential, cfg, cell_mask)
    x0 = _place_x0(x0, device).to(default_dtype())
    _check_potential_device(potential, x0.device)
    Bsz = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    if s0 is None:
        s0 = torch.zeros((Bsz, cfg.ncell), dtype=dtype, device=dev)
    elif isinstance(s0, torch.Tensor):
        s0 = s0.to(dtype=dtype, device=dev)
    else:
        s0 = torch.as_tensor(np.asarray(s0), dtype=dtype, device=dev)
    z0 = torch.cat([x0, s0], dim=1)
    cell0 = _place_cell0(cell0, Bsz, x0)

    f, g = _batched_cell_eval(ext_energy)(z0, cell0)
    i32 = dict(dtype=torch.int32, device=dev)
    return CellSearchState(
        z=z0,
        f=f,
        g=g,
        H=_initial_hessian(cfg, x0)[None].expand(Bsz, cfg.dim,
                                                 cfg.dim).clone(),
        delta=torch.full((Bsz,), cfg.delta0, dtype=dtype, device=dev),
        rho=torch.ones((Bsz,), dtype=dtype, device=dev),
        nsteps_since_diag=torch.zeros(Bsz, **i32),
        converged=torch.zeros(Bsz, dtype=torch.bool, device=dev),
        nsteps=torch.zeros(Bsz, **i32),
        neval=torch.ones(Bsz, **i32),
        nmatvec=torch.zeros(Bsz, **i32),
        cell0=cell0,
    )


class _NullPotential:
    def energy(self, x, cell):
        return 0.0


def cells_of(state: CellSearchState, cfg: CellEnsembleConfig, cell0=None,
             cell_mask: Optional[np.ndarray] = None) -> torch.Tensor:
    """Per-lane (B, 3, 3) cells realized from the state's cell parameters
    and base cells (``cell0`` is accepted for compatibility and
    ignored)."""
    del cell0
    if cell_mask is None:
        cell_mask = np.ones((3, 3), dtype=bool)
    _, cell_of = make_ext_energy_c0(_NullPotential(), cfg, cell_mask)
    return vmap(cell_of)(state.z[:, 3 * cfg.natoms:], state.cell0)


def run_cell_ensemble(
    potential,
    x0,
    cfg: CellEnsembleConfig,
    cell0,
    cell_mask: Optional[np.ndarray] = None,
    s0=None,
    max_steps: int = 100,
    mesh=None,
    seed: int = 0,
    steps_per_call: int = 1,
    niggli: bool = False,
    niggli_angle: float = 30.0,
    pbc: Optional[np.ndarray] = None,
    device=None,
) -> CellSearchState:
    """Host loop driving the batched atom+cell step until every lane
    converges (or ``max_steps``), checking convergence once every
    ``steps_per_call`` steps (one host sync each).

    ``niggli=True`` checks every lane's realized cell between chunks and
    rebases skewed lanes onto a reduced lattice basis
    (:func:`niggli_rebase_cell_lanes`). ``pbc`` (per-axis bools)
    restricts the rebase to the periodic sub-basis. Device rule as in
    :func:`init_cell_state`; ``mesh=`` is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "run_cell_ensemble(mesh=...) is not ported to sella_tpu_torch "
            "yet (ROADMAP.md)"
        )
    step = make_cell_step_fn(potential, cfg, cell0, cell_mask)
    x0 = _place_x0(x0, device)
    state = init_cell_state(potential, x0, cfg, cell0, cell_mask, s0)
    generator = torch.Generator(device=x0.device)
    generator.manual_seed(seed)
    n_calls = (max_steps + steps_per_call - 1) // steps_per_call
    for _ in range(n_calls):
        for _ in range(steps_per_call):
            state = step(state, generator)
        if bool(torch.all(state.converged)):
            break
        if niggli:
            state, _ = niggli_rebase_cell_lanes(
                state, cfg, cell_mask, niggli_angle, potential, pbc=pbc
            )
    return state


def refill_converged_cell(
    state: CellSearchState, z_new: torch.Tensor, avail: torch.Tensor,
    cfg: CellEnsembleConfig,
):
    """Replace converged lanes with fresh starts (atom+cell work-queue
    compaction). ``z_new`` is (B, dim) = [x, s] replacement DOF vectors;
    refilled lanes get the bootstrap Hessian and fresh counters, with
    (f, g) zeroed until :func:`refresh_cell`. Returns (state, take)."""
    take = state.converged & avail
    tk = take[:, None]
    H0 = _initial_hessian(cfg, state.z)
    i32 = torch.int32
    new_state = CellSearchState(
        z=torch.where(tk, z_new, state.z),
        f=torch.where(take, 0.0, state.f),
        g=torch.where(tk, 0.0, state.g),
        H=torch.where(take[:, None, None], H0[None], state.H),
        delta=torch.where(take, cfg.delta0, state.delta),
        rho=torch.where(take, 1.0, state.rho),
        nsteps_since_diag=torch.where(take, 0, state.nsteps_since_diag).to(
            i32),
        converged=state.converged & ~take,
        nsteps=torch.where(take, 0, state.nsteps).to(i32),
        neval=torch.where(take, 0, state.neval).to(i32),
        nmatvec=torch.where(take, 0, state.nmatvec).to(i32),
        cell0=state.cell0,
    )
    return new_state, take


def refresh_cell(state: CellSearchState, potential,
                 cfg: CellEnsembleConfig, cell0=None,
                 cell_mask: Optional[np.ndarray] = None,
                 mask: Optional[torch.Tensor] = None) -> CellSearchState:
    """Recompute (f, g) for all lanes (call once after a refill); only
    ``mask`` lanes' neval counters advance. ``cell0`` is accepted for
    compatibility and ignored."""
    del cell0
    if cell_mask is None:
        cell_mask = np.ones((3, 3), dtype=bool)
    ext_energy, _ = make_ext_energy_c0(potential, cfg, cell_mask)
    f, g = _batched_cell_eval(ext_energy)(state.z, state.cell0)
    inc = 1 if mask is None else mask.to(state.neval.dtype)
    return state._replace(f=f, g=g, neval=state.neval + inc)


def niggli_rebase_cell_lanes(
    state: CellSearchState, cfg: CellEnsembleConfig,
    cell_mask: Optional[np.ndarray] = None,
    angle_threshold: float = 30.0,
    potential=None,
    pbc: Optional[np.ndarray] = None,
):
    """Per-lane cell rebase between step chunks, a host event.

    For every unconverged lane whose realized cell has an angle more than
    ``angle_threshold`` degrees from 90:

    1. reduce the lattice basis (``utils.lattice.reduce_cell_basis``:
       the same lattice, a compact representation);
    2. reset the lane's base cell to the reduced cell and its cell
       parameters to zero (Cartesian positions stay untouched, which
       keeps the chart change exact);
    3. transform the Hessian's cell blocks by
       ``T = J_old^{-1} (M^{-1} kron I) J_new``, with the chart Jacobians
       from :func:`sella_tpu_torch.pes.cell._cell_param_jacobian` and the
       unimodular ``M`` (``new_cell = M @ cell``). Sella's own transform
       drops the ``M^{-1}`` factor and is then wrong by O(1) whenever the
       reduction is nontrivial; the JAX package fixed that, and so does
       this port.

    The check reads only the cell parameters, base cells and convergence
    mask from the device; the Hessians, base cells and parameters of the
    rebased lanes alone make the round trip. With ``potential`` given,
    (f, g) of the rebased lanes are re-evaluated on the state's device
    (the same physical point in the new chart) and their ``neval``
    advances. With ``pbc`` given, only angles between periodic rows
    count and the reduction never mixes in a non-periodic axis. Lanes
    with a degenerate cell row are skipped.

    Returns ``(state', rebased_mask)`` with the mask as numpy bools."""
    from scipy.linalg import expm as _sexpm

    from ..pes.cell import _cell_param_jacobian
    from ..utils.lattice import reduce_cell_basis

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
    factor = _cell_factor(cfg)
    nr3 = 3 * cfg.natoms

    s_all = state.z[:, nr3:].detach().cpu().numpy()
    c0 = state.cell0.detach().cpu().numpy()
    conv = state.converged.detach().cpu().numpy()
    Bsz = s_all.shape[0]
    rebased = np.zeros(Bsz, bool)

    def _angle_dev(cell):
        norms = np.linalg.norm(cell, axis=1)
        if np.any(norms[list(periodic_axes)] < 1e-10):
            return None              # degenerate row: skip, don't NaN
        devs = [0.0]
        for i, j in axis_pairs:
            c = cell[i] @ cell[j] / (norms[i] * norms[j])
            devs.append(
                abs(np.degrees(np.arccos(np.clip(c, -1, 1))) - 90.0)
            )
        return max(devs)

    hits = {}                        # lane -> (new_cell, T)
    for lane in range(Bsz):
        if conv[lane]:
            continue
        L = np.zeros(9)
        L[midx] = s_all[lane]
        L = L.reshape(3, 3)
        cell = _sexpm(L / factor) @ c0[lane]
        dev = _angle_dev(cell)
        if dev is None or dev <= angle_threshold:
            continue
        new_cell, M = reduce_cell_basis(cell, pbc=pbc)
        new_dev = _angle_dev(new_cell)
        if new_dev is None or new_dev >= dev - 1e-9:
            continue                     # reduction gained nothing
        # dL_old = T dL_new for the same physical lattice perturbation:
        # same-lattice cell-matrix perturbations of the two
        # representations satisfy dC_old = M^{-1} dC_new
        J_old = _cell_param_jacobian(L, c0[lane], factor)
        J_new = _cell_param_jacobian(np.zeros((3, 3)), new_cell, factor)
        K = np.kron(np.linalg.inv(M), np.eye(3))
        T = np.linalg.solve(J_old, K @ J_new)[np.ix_(midx, midx)]
        hits[lane] = (new_cell, T)
        rebased[lane] = True

    if not rebased.any():
        return state, rebased

    lanes = np.where(rebased)[0]
    dev = state.z.device
    idx = torch.as_tensor(lanes, device=dev)
    H = state.H[idx].detach().cpu().numpy()
    for k, lane in enumerate(lanes):
        T = hits[lane][1]
        H[k, nr3:, nr3:] = T.T @ H[k, nr3:, nr3:] @ T
        H[k, :nr3, nr3:] = H[k, :nr3, nr3:] @ T
        H[k, nr3:, :nr3] = T.T @ H[k, nr3:, :nr3]
    H_all = state.H.clone()
    H_all[idx] = torch.as_tensor(H, dtype=state.H.dtype, device=dev)
    z_all = state.z.clone()
    z_all[idx, nr3:] = 0.0
    c0_all = state.cell0.clone()
    c0_all[idx] = torch.as_tensor(np.stack([hits[ln][0] for ln in lanes]),
                                  dtype=state.cell0.dtype, device=dev)
    state = state._replace(z=z_all, cell0=c0_all, H=H_all)
    if potential is not None:
        ext_energy, _ = make_ext_energy_c0(potential, cfg, cell_mask)
        f_r, g_r = _batched_cell_eval(ext_energy)(z_all[idx], c0_all[idx])
        f_all = state.f.clone()
        g_all = state.g.clone()
        neval = state.neval.clone()
        f_all[idx] = f_r
        g_all[idx] = g_r
        neval[idx] += 1
        state = state._replace(f=f_all, g=g_all, neval=neval)
    return state, rebased


def run_cell_ensemble_queue(
    potential,
    x0_all,
    cfg: CellEnsembleConfig,
    cell0,
    batch: int,
    cell_mask: Optional[np.ndarray] = None,
    s0_all=None,
    max_steps_per_search: int = 200,
    refill_every: int = 10,
    seed: int = 0,
    mesh=None,
    device=None,
):
    """Process an arbitrarily large set of atom+cell relaxations with a
    fixed device batch: every ``refill_every`` steps, finished lanes
    (converged, or at ``max_steps_per_search``) are harvested and refilled
    from the queue. Returns per-input result dicts ``{z, f, nsteps,
    converged}`` in input order. Each harvest is one device-to-host copy
    of a packed buffer.

    The searches run on ``x0_all``'s device when it is a tensor; any
    other ``x0_all`` goes to ``device``, by default the GPU, and raises
    where there is none (``device="cpu"`` asks for the CPU). ``mesh=`` is
    not ported and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "run_cell_ensemble_queue(mesh=...) is not ported to "
            "sella_tpu_torch yet (ROADMAP.md)"
        )
    dev = _target_device(x0_all, device)
    x0_np = (x0_all.detach().cpu().numpy() if isinstance(x0_all, torch.Tensor)
             else np.asarray(x0_all, dtype=np.float64))
    total = x0_np.shape[0]
    if s0_all is None:
        s0_np = np.zeros((total, cfg.ncell))
    elif isinstance(s0_all, torch.Tensor):
        s0_np = s0_all.detach().cpu().numpy()
    else:
        s0_np = np.asarray(s0_all, dtype=np.float64)
    z_all = np.concatenate([x0_np, s0_np], axis=1)

    step = make_cell_step_fn(potential, cfg, cell0, cell_mask)
    state = init_cell_state(
        potential, torch.as_tensor(x0_np[:batch], device=dev), cfg, cell0,
        cell_mask, torch.as_tensor(s0_np[:batch], device=dev),
    )
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    Bsz = state.z.shape[0]
    origin = np.arange(Bsz)
    next_idx = Bsz
    results: dict = {}

    while len(results) < total:
        for _ in range(refill_every):
            state = step(state, generator)

        dt = state.z.dtype
        buf = torch.cat([state.converged.to(dt), state.nsteps.to(dt),
                         state.f, state.z.reshape(-1)]).cpu().numpy()
        conv = buf[:Bsz] != 0.0
        nsteps = buf[Bsz:2 * Bsz].astype(np.int64)
        fs = buf[2 * Bsz:3 * Bsz]
        zs = buf[3 * Bsz:].reshape(Bsz, -1)
        done = conv | (nsteps >= max_steps_per_search)
        if not np.any(done):
            continue

        for lane in np.where(done)[0]:
            oi = origin[lane]
            if oi >= 0 and oi not in results:
                results[oi] = dict(
                    z=zs[lane].copy(), f=float(fs[lane]),
                    nsteps=int(nsteps[lane]), converged=bool(conv[lane]),
                )

        # refill from the queue (timed-out lanes are retired too)
        z_fill = np.zeros((Bsz, cfg.dim))
        avail = np.zeros(Bsz, dtype=bool)
        new_origin = origin.copy()
        for lane in np.where(done)[0]:
            if next_idx < total:
                z_fill[lane] = z_all[next_idx]
                avail[lane] = True
                new_origin[lane] = next_idx
                next_idx += 1
            else:
                new_origin[lane] = -1
        state = state._replace(
            converged=torch.as_tensor(done, device=dev) | state.converged)
        state, took = refill_converged_cell(
            state, torch.as_tensor(z_fill, dtype=dt, device=dev),
            torch.as_tensor(avail, device=dev), cfg)
        # lanes with no replacement idle as "converged"
        state = state._replace(
            converged=state.converged
            | torch.as_tensor(new_origin < 0, device=dev))
        if avail.any():
            state = refresh_cell(state, potential, cfg, cell0, cell_mask,
                                 took)
        origin = new_origin

    return [results[i] for i in range(total)]
