"""Large-system path: matrix-free saddle refinement, no dense Hessian.

Counterpart of ``sella_tpu/parallel/largescale.py`` (BASELINE config 5:
10k-atom systems). A dense quasi-Newton Hessian is O((3N)^2) memory, so
this module is matrix-free:

* the leftmost Hessian mode comes from a restarted Lanczos loop whose
  matvecs are exact potential HVPs (``torch.func.jvp`` through the
  gradient, :meth:`Potential.hvp`), warm-started from the previous
  step's mode;
* the step is minimum-mode following: the force along the leftmost mode
  is reversed, and an L-BFGS two-loop recursion over a fixed secant
  window preconditions the remainder.

For ``order=0`` the mode machinery is skipped and this is a plain
trust-clipped L-BFGS minimizer.

Host syncs. The JAX package runs the Lanczos ``while_loop`` and
``run_mmf``'s ``lax.cond`` inside one jitted ``fori_loop``; eager torch
reads the Lanczos ``done`` flag once per restart and ``converged`` once
per step on the host. :class:`MMFStep` counts those reads
(``host_syncs``); on the card each restart's (5, 5) eigh also waits for
its solver's status.

Potentials are called through ``energy_and_grad`` and ``hvp``, so a
row-chunked potential (``chunk=``) bounds the memory of both.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.linalg import batched_eigh
from .ensemble import _check_potential_device, _place_x0

#: Lanczos subspace size (the JAX package's default)
KRYLOV = 5


class LBFGSMemory(NamedTuple):
    S: torch.Tensor      # (K, d) position secants
    Y: torch.Tensor      # (K, d) gradient secants
    rho: torch.Tensor    # (K,) 1 / (s . y)
    count: torch.Tensor  # () int32: total secants pushed


def lbfgs_init(d: int, window: int, dtype=torch.float64,
               device=None) -> LBFGSMemory:
    return LBFGSMemory(
        S=torch.zeros((window, d), dtype=dtype, device=device),
        Y=torch.zeros((window, d), dtype=dtype, device=device),
        rho=torch.zeros((window,), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def lbfgs_push(mem: LBFGSMemory, s: torch.Tensor, y: torch.Tensor
               ) -> LBFGSMemory:
    """Ring-buffer push; degenerate secants (s.y <= 1e-12) are skipped
    so the implicit Hessian stays positive definite. Out of place, with
    no host sync."""
    sy = s @ y
    ok = sy > 1e-12
    slot = (mem.count % mem.S.shape[0]).to(torch.int64).reshape(1)
    S = torch.where(ok, mem.S.index_copy(0, slot, s[None]), mem.S)
    Y = torch.where(ok, mem.Y.index_copy(0, slot, y[None]), mem.Y)
    rho = torch.where(ok, mem.rho.index_copy(
        0, slot, (1.0 / torch.where(ok, sy, 1.0)).reshape(1)), mem.rho)
    return LBFGSMemory(S, Y, rho, mem.count + ok.to(torch.int32))


def lbfgs_apply(mem: LBFGSMemory, g: torch.Tensor) -> torch.Tensor:
    """Two-loop recursion: H_approx^{-1} g over the masked fixed window.

    The ring order is gathered once per loop, so the K iterations index
    with Python integers: indexing with a 0-d device tensor would read
    it on the host. Both loops run all K iterations masked, as the JAX
    ``fori_loop`` does, so the arithmetic is the JAX package's."""
    K = mem.S.shape[0]
    n_valid = torch.clamp(mem.count, max=K)
    # torch's % on tensors takes the divisor's sign, as jnp.mod does:
    # newest = K - 1 while the ring is empty
    newest = (mem.count.to(torch.int64) - 1) % K
    ar = torch.arange(K, device=g.device)

    # backward loop, newest first
    order = (newest - ar) % K
    S, Y, rho = (t.index_select(0, order) for t in (mem.S, mem.Y, mem.rho))
    q = g
    alpha_by_pos = []
    for i in range(K):
        alpha = torch.where(i < n_valid, rho[i] * (S[i] @ q), 0.0)
        q = q - alpha * Y[i]
        alpha_by_pos.append(alpha)
    alphas = torch.zeros(K, dtype=g.dtype, device=g.device).index_copy(
        0, order, torch.stack(alpha_by_pos))

    # initial scaling gamma = s.y / y.y of the newest pair
    sy = S[0] @ Y[0]
    yy = Y[0] @ Y[0]
    gamma = torch.where((n_valid > 0) & (yy > 1e-300),
                        sy / torch.clamp(yy, min=1e-300), 1.0)
    r = gamma * q

    # forward loop, oldest valid first
    order = (newest - (n_valid - 1 - ar)) % K
    S, Y, rho, a = (t.index_select(0, order)
                    for t in (mem.S, mem.Y, mem.rho, alphas))
    for i in range(K):
        beta = rho[i] * (Y[i] @ r)
        upd = (a[i] - beta) * S[i]
        r = r + torch.where(i < n_valid, upd, 0.0)
    return r


def leftmost_mode(hvp: Callable, v0: torch.Tensor, n_iter: int = 10,
                  tol: float = 1e-3, krylov: int = KRYLOV):
    """Leftmost eigenpair via restarted fixed-size Lanczos (HVP matvecs).

    Each outer iteration builds a ``krylov``-dimensional Krylov subspace
    from the current estimate (full reorthogonalization), takes the
    leftmost Ritz pair, and restarts until the residual test passes or
    ``n_iter`` restarts ran. Returns ``(lam, v, n_hvp_used)``; the test
    is read on the host once per restart, i.e. ``n_hvp_used / (krylov +
    1)`` times."""
    d = v0.shape[0]
    m = krylov
    mask_of = [torch.arange(m, device=v0.device) <= k for k in range(m)]

    v = v0 / torch.linalg.norm(v0)
    lam = v0.new_zeros(())
    nmv = 0
    for _ in range(n_iter):
        V = v0.new_zeros((m, d))
        V[0] = v
        T = v0.new_zeros((m, m))
        for k in range(m):
            w = hvp(V[k])
            # full reorthogonalization against all previous vectors
            coeffs = torch.where(mask_of[k], V @ w, 0.0)
            T[k] = coeffs
            T[:, k] = coeffs
            w = w - (coeffs[:, None] * V).sum(0)
            w = w - (V * (V @ w)[:, None]).sum(0)      # second pass
            nrm = torch.linalg.norm(w)
            w = torch.where(nrm > 1e-12, w / torch.clamp(nrm, min=1e-300),
                            0.0)
            if k + 1 < m:
                V[k + 1] = w
        lams, W = batched_eigh(T)
        v = W[:, 0] @ V
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-300)
        Hv = hvp(v)
        lam = v @ Hv
        r = Hv - lam * v
        nmv += m + 1
        done = torch.linalg.norm(r) < tol * torch.clamp(torch.abs(lams[0]),
                                                        min=1e-3)
        if bool(done):
            break
    return lam, v, nmv


class MMFState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    mode: torch.Tensor       # current leftmost-mode estimate
    lam: torch.Tensor        # its Rayleigh quotient
    mem: LBFGSMemory
    tr: torch.Tensor         # adaptive max step length
    geff_norm: torch.Tensor  # last effective-gradient norm (merit)
    nsteps: torch.Tensor
    neval: torch.Tensor
    nmatvec: torch.Tensor
    converged: torch.Tensor


def _as_cell(cell, like: torch.Tensor) -> torch.Tensor:
    if cell is None:
        return torch.zeros((3, 3), dtype=torch.float64, device=like.device)
    return torch.as_tensor(cell, dtype=torch.float64, device=like.device)


class MMFStep:
    """One minimum-mode-following step of ONE large system (the JAX
    package's ``make_mmf_step`` closure). ``host_syncs`` counts the
    host reads of its Lanczos tests and, through :func:`drive_mmf`, of
    the convergence flag; ``hvp_calls`` counts its HVPs."""

    def __init__(self, potential, cell=None, order: int = 1,
                 fmax: float = 1e-3, max_move: float = 0.1,
                 mode_iter: int = 8) -> None:
        self.potential = potential
        self.cell = cell
        self.order = order
        self.fmax = fmax
        self.max_move = max_move
        self.mode_iter = mode_iter
        self.host_syncs = 0
        self.hvp_calls = 0
        self._cell_t = None

    def _cell(self, like):
        if self._cell_t is None or self._cell_t.device != like.device:
            self._cell_t = _as_cell(self.cell, like)
        return self._cell_t

    def __call__(self, state: MMFState) -> MMFState:
        pot, order, max_move = self.potential, self.order, self.max_move
        cell = self._cell(state.x)
        x = state.x
        if order > 0:
            def hvp(v):
                self.hvp_calls += 1
                return pot.hvp(x, v, cell)

            lam, mode, nmv = leftmost_mode(hvp, state.mode,
                                           n_iter=self.mode_iter)
            self.host_syncs += nmv // (KRYLOV + 1)
            gpar_coef = state.g @ mode
            g_perp = state.g - gpar_coef * mode
            # parallel: exact Newton along the mode with the Lanczos
            # curvature; with lam >= 0, walk up the mode, bounded
            s_par_len = torch.where(
                lam < 0,
                -gpar_coef / torch.where(lam < 0, lam, -1.0),
                -torch.sign(gpar_coef) * 0.5 * max_move,
            )
            s_par_len = torch.clamp(s_par_len, -max_move, max_move)
            s_par = s_par_len * mode
        else:
            lam, mode, nmv = state.lam, state.mode, 0
            g_perp = state.g
            s_par = torch.zeros_like(state.g)

        # perpendicular: L-BFGS with a steepest-descent fallback
        p = lbfgs_apply(state.mem, g_perp)
        pg = p @ g_perp
        bad = (pg <= 1e-14) | ~torch.all(torch.isfinite(p))
        p = torch.where(bad, g_perp, p)
        s_perp = -p
        if order > 0:
            s_perp = s_perp - (s_perp @ mode) * mode
        norm = torch.linalg.norm(s_perp)
        s_perp = torch.where(
            norm > max_move,
            s_perp * (max_move / torch.clamp(norm, min=1e-300)),
            s_perp,
        )

        step_vec = s_par + s_perp
        # a new tensor: the caller's x is never written
        x_new = x + step_vec
        f_new, g_new = pot.energy_and_grad(x_new, cell)

        # L-BFGS secants on the PERPENDICULAR gradient (fixed mode)
        if order > 0:
            g_perp_new = g_new - (g_new @ mode) * mode
        else:
            g_perp_new = g_new
        mem = lbfgs_push(state.mem, step_vec, g_perp_new - g_perp)

        natoms = x.shape[0] // 3
        fmax_now = torch.max(torch.linalg.norm(g_new.reshape(natoms, 3),
                                               dim=1))
        conv = fmax_now < self.fmax
        if order > 0:
            conv = conv & (lam < 0)

        return MMFState(
            x=x_new, f=f_new, g=g_new, mode=mode, lam=lam, mem=mem,
            tr=state.tr, geff_norm=torch.linalg.norm(g_perp_new),
            nsteps=state.nsteps + 1, neval=state.neval + 1,
            nmatvec=state.nmatvec + nmv, converged=conv,
        )


def make_mmf_step(potential, cell=None, order: int = 1,
                  fmax: float = 1e-3, max_move: float = 0.1,
                  window: int = 20, mode_iter: int = 8) -> MMFStep:
    """The minimum-mode-following step for ONE large system (an
    :class:`MMFStep`). ``window`` is accepted for the JAX signature: the
    L-BFGS window is the state's (:func:`mmf_init`)."""
    return MMFStep(potential, cell, order, fmax, max_move, mode_iter)


def mmf_init(potential, x0, cell=None, window: int = 20,
             seed: int = 0, device=None) -> MMFState:
    """The starting state. A tensor ``x0`` keeps its device; a numpy
    ``x0`` goes to ``device``: by default the GPU, raising where there is
    none; ``device="cpu"`` asks for the CPU.

    The initial mode is a normal draw from a CPU ``torch.Generator``
    seeded with ``seed`` (the same on every device). The JAX package
    draws it from ``jax.random``, so order-1 runs match the JAX
    package's only from an injected mode (``state._replace(mode=...)``);
    order-0 runs never read it."""
    x0 = _place_x0(x0, device)
    _check_potential_device(potential, x0.device)
    cell = _as_cell(cell, x0)
    f, g = potential.energy_and_grad(x0, cell)
    gen = torch.Generator().manual_seed(int(seed))
    v0 = torch.randn(x0.shape, generator=gen, dtype=x0.dtype).to(x0.device)
    v0 = v0 / torch.linalg.norm(v0)

    def scalar(v, dtype=x0.dtype):
        return torch.full((), v, dtype=dtype, device=x0.device)

    return MMFState(
        x=x0, f=f, g=g, mode=v0, lam=scalar(0.0),
        mem=lbfgs_init(x0.shape[0], window, x0.dtype, x0.device),
        tr=scalar(0.05), geff_norm=scalar(float("inf")),
        nsteps=scalar(0, torch.int32), neval=scalar(1, torch.int32),
        nmatvec=scalar(0, torch.int32),
        converged=scalar(False, torch.bool),
    )


def drive_mmf(step: MMFStep, state: MMFState, max_steps: int = 500,
              steps_per_call: int = 25) -> MMFState:
    """``run_mmf``'s host loop from a given state: calls of
    ``steps_per_call`` steps, a converged state left as it is, until
    convergence or ``max_steps`` (checked after each call, so a run may
    take up to the next multiple of ``steps_per_call``, as the JAX
    package's may). Reads ``converged`` once per step."""
    n = int(state.nsteps)
    conv = bool(state.converged)
    for _ in range(max_steps // steps_per_call + 1):
        for _ in range(steps_per_call):
            if conv:
                break
            state = step(state)
            n += 1
            conv = bool(state.converged)
            step.host_syncs += 1
        if conv or n >= max_steps:
            break
    return state


def run_mmf(potential, x0, cell=None, order: int = 1, fmax: float = 1e-3,
            max_steps: int = 500, max_move: float = 0.1,
            steps_per_call: int = 25, device=None, **kwargs) -> MMFState:
    """Minimum-mode following (``order=1``) or L-BFGS minimization
    (``order=0``) of one system until convergence. ``device`` as in
    :func:`mmf_init`; ``kwargs`` (``window``, ``mode_iter``) go to
    :func:`make_mmf_step`. The caller's ``x0`` is never written."""
    step = make_mmf_step(potential, cell, order, fmax, max_move, **kwargs)
    state = mmf_init(potential, x0, cell, device=device)
    return drive_mmf(step, state, max_steps, steps_per_call)
