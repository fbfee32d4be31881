"""Internal-coordinate primitives as pure, differentiable torch functions.

Counterpart of ``sella_tpu/coords/primitives.py``. Value functions take
gathered positions (shape ``(..., k, 3)`` for a k-body coordinate, any
leading dims: one coordinate or a batch of lanes and coordinates) plus
periodic translation vectors, and compose with ``torch.func`` (``grad``,
``jacfwd``, ``jvp``, ``vmap``) like the JAX package's with
jit/vmap/grad. Bonds, angles and dihedrals also have analytic batched
gradients (``*_grads``), whose directional derivatives come from one
pass of hand-rolled dual numbers (:class:`Dual`, :func:`grad_and_jvp`).

The quaternion rotation coordinate is the delicate one: naive autodiff
through ``eigh`` of the 4x4 Kearsley matrix gives NaN on (near-)
degenerate spectra. The JAX package gives the leading-eigenvector map a
``custom_jvp`` with a pseudo-inverted resolvent (degenerate directions
contribute zero) whose own derivative is a second ``custom_jvp`` in
closed form. Here the eigendecomposition is a constant to every
transform (:class:`_Spectral`, a ``torch.autograd.Function`` with a zero
``jvp`` and a generated vmap rule), and :func:`_leading_evec` returns
the second-order perturbation expansion about it, whose value is exact
and whose first and second derivatives are the JAX package's rules. It
works under ``torch.func.jvp``, ``jacfwd``, ``grad``, ``vmap`` and their
nestings, forward-over-reverse included.
"""
from __future__ import annotations

import torch
from torch.func import grad, jacfwd, jvp


# ---------------------------------------------------------------------------
# Two-/three-/four-body coordinates: any leading dims, analytic gradients
# ---------------------------------------------------------------------------
class Dual:
    """A (value, tangent) pair: hand-rolled forward mode for the analytic
    gradients below. Their directional derivatives (the curvature rows
    of the internal-coordinate engine) then cost a few tensor operations
    per operation, where ``torch.func.jvp`` in eager mode costs ~15x the
    plain evaluation. Supports exactly the operations those functions
    use."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v, self.t = v, t

    def __getitem__(self, k):
        return Dual(self.v[k], self.t[k])

    def __neg__(self):
        return Dual(-self.v, -self.t)

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v + o.v, self.t + o.t)
        return Dual(self.v + o, self.t)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v - o.v, self.t - o.t)
        return Dual(self.v - o, self.t)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.t)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v * o.v, self.t * o.v + self.v * o.t)
        return Dual(self.v * o, self.t * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Dual):
            q = self.v / o.v
            return Dual(q, (self.t - q * o.t) / o.v)
        return Dual(self.v / o, self.t / o)

    def __rtruediv__(self, o):
        q = o / self.v
        return Dual(q, -q * self.t / self.v)

    def sum(self, dim):
        return Dual(self.v.sum(dim), self.t.sum(dim))


def _sqrt(a):
    if isinstance(a, Dual):
        r = torch.sqrt(a.v)
        return Dual(r, a.t / (2.0 * r))
    return torch.sqrt(a)


def _clamp(a, lo, hi):
    if isinstance(a, Dual):
        inside = (a.v >= lo) & (a.v <= hi)
        return Dual(torch.clamp(a.v, lo, hi),
                    torch.where(inside, a.t, 0.0))
    return torch.clamp(a, lo, hi)


def _cross(a, b):
    if isinstance(a, Dual):
        return Dual(torch.linalg.cross(a.v, b.v, dim=-1),
                    torch.linalg.cross(a.t, b.v, dim=-1)
                    + torch.linalg.cross(a.v, b.t, dim=-1))
    return torch.linalg.cross(a, b, dim=-1)


def _stack(xs, dim):
    if isinstance(xs[0], Dual):
        return Dual(torch.stack([x.v for x in xs], dim=dim),
                    torch.stack([x.t for x in xs], dim=dim))
    return torch.stack(xs, dim=dim)


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(a):
    return _sqrt(_dot(a, a))


def _e(a):
    """``a[..., None]``."""
    return a[..., None]


def bond_value(P: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Bond length of P (..., 2, 3); T (..., 1, 3) is the periodic offset
    of atom 1."""
    return _norm(P[..., 1, :] - P[..., 0, :] + T[..., 0, :])


def bond_grads(P, T):
    """d(bond)/dP, (..., 2, 3)."""
    d = P[..., 1, :] - P[..., 0, :] + T[..., 0, :]
    u = d / _e(_norm(d))
    return _stack([-u, u], -2)


def _angle_parts(P, T):
    dx1 = -(P[..., 1, :] - P[..., 0, :] + T[..., 0, :])
    dx2 = P[..., 2, :] - P[..., 1, :] + T[..., 1, :]
    r1, r2 = _norm(dx1), _norm(dx2)
    c = _clamp(_dot(dx1, dx2) / (r1 * r2), -1.0, 1.0)
    return dx1, dx2, r1, r2, c


def angle_value(P: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Bend angle at atom 1 of P (..., 3, 3); offsets T (..., 2, 3)."""
    return torch.arccos(_angle_parts(P, T)[4])


def angle_grads(P, T):
    """d(angle)/dP, (..., 3, 3); not finite at an exactly linear angle,
    as in the JAX package."""
    dx1, dx2, r1, r2, c = _angle_parts(P, T)
    r12 = _e(r1 * r2)
    dth = _e(-1.0 / _sqrt(1.0 - c * c))
    g0 = dth * (dx2 / r12 - _e(c) * dx1 / _e(r1 * r1))
    g2 = dth * (dx1 / r12 - _e(c) * dx2 / _e(r2 * r2))
    return _stack([g0, -(g0 + g2), g2], -2)


def _dihedral_parts(P, T):
    b1 = P[..., 1, :] - P[..., 0, :] + T[..., 0, :]
    b2 = P[..., 2, :] - P[..., 1, :] + T[..., 1, :]
    b3 = P[..., 3, :] - P[..., 2, :] + T[..., 2, :]
    return b1, b2, b3, _cross(b1, b2), _cross(b2, b3)


def dihedral_value(P: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Torsion about bond 1-2 of P (..., 4, 3); offsets T (..., 3, 3).
    atan2 convention (smooth through 0/pi except the +-pi branch cut,
    handled by wrap)."""
    b1, b2, b3, n1, n2 = _dihedral_parts(P, T)
    numer = _dot(b2, _cross(n1, n2))
    denom = _norm(b2) * _dot(n1, n2)
    return torch.atan2(numer, denom)


def dihedral_grads(P, T):
    """d(dihedral)/dP, (..., 4, 3) (Blondel-Karplus form)."""
    b1, b2, b3, n1, n2 = _dihedral_parts(P, T)
    L2 = _dot(b2, b2)
    L = _sqrt(L2)
    g0 = -_e(L / _dot(n1, n1)) * n1
    g3 = _e(L / _dot(n2, n2)) * n2
    s1 = _e(_dot(b1, b2) / L2)
    s3 = _e(_dot(b3, b2) / L2)
    g1 = s3 * g3 - (1.0 + s1) * g0
    g2 = s1 * g0 - (1.0 + s3) * g3
    return _stack([g0, g1, g2, g3], -2)


KIND_VALUES = {"bond": bond_value, "angle": angle_value,
               "dihedral": dihedral_value}
KIND_GRADS = {"bond": bond_grads, "angle": angle_grads,
              "dihedral": dihedral_grads}


def grad_and_jvp(kind: str, P, T, V):
    """The ``kind`` gradients and their directional derivatives along
    ``V`` (the rows ``H_k v`` of each coordinate's Hessian), from one
    :class:`Dual` pass."""
    d = KIND_GRADS[kind](Dual(P, V), T)
    return d.v, d.t


# ---------------------------------------------------------------------------
# Displacement
# ---------------------------------------------------------------------------
def displacement_value(pos: torch.Tensor, refpos: torch.Tensor,
                       W: torch.Tensor) -> torch.Tensor:
    """Weighted squared displacement from a reference geometry."""
    dx = (pos - refpos).reshape(-1)
    return dx @ W @ dx


# ---------------------------------------------------------------------------
# Quaternion rotation coordinate
# ---------------------------------------------------------------------------
def _kearsley_coefficients() -> torch.Tensor:
    """(16, 9) constant map from M = Yc^T Xc (row-major) to the Kearsley
    matrix K (row-major)."""
    C = torch.zeros((4, 4, 3, 3), dtype=torch.float64)

    def put(a, b, terms):
        for sgn, i, j in terms:
            C[a, b, i, j] += sgn

    diag = {0: (1, 1, 1), 1: (1, -1, -1), 2: (-1, 1, -1), 3: (-1, -1, 1)}
    for a, signs in diag.items():
        put(a, a, [(sg, i, i) for i, sg in enumerate(signs)])
    off = {(0, 1): [(1, 1, 2), (-1, 2, 1)], (0, 2): [(1, 2, 0), (-1, 0, 2)],
           (0, 3): [(1, 0, 1), (-1, 1, 0)], (1, 2): [(1, 0, 1), (1, 1, 0)],
           (1, 3): [(1, 0, 2), (1, 2, 0)], (2, 3): [(1, 1, 2), (1, 2, 1)]}
    for (a, b), terms in off.items():
        put(a, b, terms)
        put(b, a, terms)
    return C.reshape(16, 9)


_KEARSLEY = _kearsley_coefficients()


def _kearsley_matrix(Xc: torch.Tensor, Yc: torch.Tensor) -> torch.Tensor:
    """4x4 symmetric matrix whose leading eigenvector is the quaternion
    (w, x, y, z) of the rotation best mapping Yc onto Xc (both centered;
    any leading dims): a constant linear map of M = Yc^T Xc."""
    M = Yc.transpose(-1, -2) @ Xc
    C = _KEARSLEY.to(dtype=M.dtype, device=M.device)
    K = M.reshape(M.shape[:-2] + (9,)) @ C.T
    return K.reshape(M.shape[:-2] + (4, 4))


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product over leading dims."""
    return (A @ v[..., None])[..., 0]


def _canonical_q(lams: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Branch-stable leading quaternion from an eigh of K (any leading
    dims; the JAX package's ``_canonical_q``, degenerate branch kept as
    it stands): when the leading eigenvalue is degenerate (2-atom /
    linear fragments) the identity quaternion is projected onto the
    leading eigenspace, so the coordinate reads 0 at the reference
    orientation instead of an arbitrary LAPACK basis vector. Sign:
    w >= 0, falling back to largest-|component|-positive for 180-degree
    rotations. The gap threshold is relative, the same form as
    :func:`_resolvent_parts`."""
    q = V[..., :, -1]
    top = lams[..., -1:]
    scale = torch.clamp(torch.abs(top), min=1.0)
    mask = ((top - lams) < 1e-10 * scale).to(V.dtype)
    proj = _mv(V, mask * V[..., 0, :])    # V @ (mask * (V^T e0))
    pn = torch.linalg.norm(proj, dim=-1, keepdim=True)
    deg_use = (torch.sum(mask, dim=-1, keepdim=True) > 1.5) & (pn > 1e-7)
    q = torch.where(deg_use,
                    proj / torch.where(pn > 1e-14, pn, torch.ones_like(pn)),
                    q)
    pick = torch.argmax(torch.abs(q), dim=-1, keepdim=True)
    qpick = torch.gather(q, -1, pick)
    sign = torch.where(torch.abs(q[..., :1]) > 1e-12, torch.sign(q[..., :1]),
                       torch.sign(qpick))
    return q * sign


def _resolvent_parts(K: torch.Tensor):
    """Primal spectral pieces of A = lam_max I - K (any leading dims): the
    canonical q and ``(Vrest, inv_gap)`` with
    ``A^+ x = Vrest (inv_gap * Vrest^T x)``. Thresholded gaps make this
    the pseudo-inverted resolvent: smooth under interior (non-leading)
    degeneracies, which only reshuffle the eigenbasis of a subspace the
    projector sums over."""
    lams, V = torch.linalg.eigh(K)
    q = _canonical_q(lams, V)
    gap = lams[..., -1:] - lams[..., :-1]
    scale = torch.clamp(torch.abs(lams[..., -1:]), min=1.0)
    ok = gap > 1e-10 * scale
    inv_gap = torch.where(ok, 1.0 / torch.where(ok, gap,
                                                torch.ones_like(gap)), 0.0)
    return q, V[..., :, :-1], inv_gap


class _Spectral(torch.autograd.Function):
    """``K -> (K0, q, Vrest, inv_gap)``: the spectral pieces of
    :func:`_resolvent_parts` plus a copy ``K0`` of K, all treated as
    constants by every transform (zero JVP, no gradient), so no
    derivative of any order ever differentiates ``eigh``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(K):
        q, Vrest, inv_gap = _resolvent_parts(K)
        return K.clone(), q, Vrest, inv_gap

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def jvp(ctx, dK):
        return (torch.zeros_like(dK), torch.zeros_like(dK[..., 0, :]),
                torch.zeros_like(dK[..., :, :-1]),
                torch.zeros_like(dK[..., 0, :-1]))

    @staticmethod
    def backward(ctx, *grads):
        return None


def _leading_evec(K: torch.Tensor) -> torch.Tensor:
    """Branch-stable leading eigenvector of the symmetric 4x4 K (any
    leading dims; :func:`_canonical_q`), with the derivatives of the JAX
    package's ``custom_jvp`` rules.

    With ``E = K - K0`` (zero in value, the identity in derivative) and
    the constants of :class:`_Spectral`, this returns the second-order
    Rayleigh-Schroedinger expansion of q about K0:
    ``q + A^+ E q + A^+ E A^+ E q - (q.E q) A^+ A^+ E q
    - 1/2 (E q . A^+ A^+ E q) q``. Its value is q exactly; its first
    derivative is ``dq = A^+ dK q`` (the JAX ``_leading_evec_jvp``), and
    its mixed second derivative is algebraically the JAX ``_dq_jvp``
    closed form, degenerate spectra included. Plain torch operations on
    constants, so ``jvp``, ``jacfwd``, ``grad``, ``vmap`` and their
    nestings (forward-over-reverse too) all apply; derivatives of third
    and higher order are not carried (the coordinate layer uses two).

    (Two ``torch.autograd.Function`` classes with closed-form ``jvp``
    rules, the direct translation of the JAX pair, give correct first
    derivatives but wrong nested ones: under ``jvp`` of ``jvp`` torch
    2.13 does not apply the inner rule's own rule at the outer level.)"""
    K0, q, Vrest, inv_gap = _Spectral.apply(K)
    E = K - K0

    def ap(v):
        return _mv(Vrest, inv_gap * _mv(Vrest.transpose(-1, -2), v))

    Eq = _mv(E, q)
    q1 = ap(Eq)
    RREq = ap(q1)
    q2 = (ap(_mv(E, q1)) - (q * Eq).sum(-1, keepdim=True) * RREq
          - 0.5 * (Eq * RREq).sum(-1, keepdim=True) * q)
    return q + q1 + q2


def _quat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """Log map of unit quaternions (..., 4) (w, x, y, z) -> rotation
    vectors, ``v = 2 atan2(|qv|, qw) qv / |qv|``, with the double-where
    guard at small angle (value and all derivative orders finite at the
    identity)."""
    w = q[..., :1]
    qv = q[..., 1:]
    s2 = (qv * qv).sum(-1, keepdim=True)
    small = s2 < 1e-16
    one = torch.ones_like(s2)
    s = torch.sqrt(torch.where(small, one, s2))
    w_safe = torch.where(torch.abs(w) > 1e-12, w, one)
    theta_over_s = torch.where(small, 2.0 / w_safe,
                               2.0 * torch.atan2(s, w) / s)
    return qv * theta_over_s


def rotation_value(pos: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) of a fragment ``pos`` (..., n, 3) relative
    to its reference geometry ``ref`` (n, 3): the expmap log of the
    optimal (Kabsch) rotation carrying the reference onto the current
    geometry (the TRIC rotation)."""
    Xc = pos - torch.mean(pos, dim=-2, keepdim=True)
    Yc = ref - torch.mean(ref, dim=-2, keepdim=True)
    K = _kearsley_matrix(Xc, Yc)
    return _quat_to_rotvec(_leading_evec(K))


def rotation_jacobians(pos: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """d(rotation vector)/d(pos), (..., 3, n, 3), for any leading dims:
    one forward-mode pass with the 3n unit tangents stacked on a new
    leading dim (no vmap)."""
    n = pos.shape[-2]
    lead = pos.shape[:-2]
    eye = torch.eye(3 * n, dtype=pos.dtype, device=pos.device).reshape(
        (3 * n,) + (1,) * len(lead) + (n, 3))
    P = pos.expand((3 * n,) + pos.shape).clone()
    _, J = jvp(lambda p: rotation_value(p, ref), (P,),
               (eye.expand(P.shape).clone(),))
    return J.movedim(0, -1).reshape(lead + (3, n, 3))


def rotation_jacobians_jvp(pos, ref, v):
    """Directional derivative of :func:`rotation_jacobians` along ``v``
    (the rows ``H_k v`` of the three rotation components' Hessians)."""
    return jvp(lambda p: rotation_jacobians(p, ref), (pos,), (v,))[1]


# ---------------------------------------------------------------------------
# Generic per-coordinate derivative closures
# ---------------------------------------------------------------------------
bond_grad = grad(bond_value, argnums=0)
angle_grad = grad(angle_value, argnums=0)
dihedral_grad = grad(dihedral_value, argnums=0)
bond_hess = jacfwd(bond_grad, argnums=0)
angle_hess = jacfwd(angle_grad, argnums=0)
dihedral_hess = jacfwd(dihedral_grad, argnums=0)
rotation_jac = jacfwd(rotation_value, argnums=0)              # (3, n, 3)
rotation_hess = jacfwd(rotation_jac, argnums=0)               # (3, n, 3, n, 3)
