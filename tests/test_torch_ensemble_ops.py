"""Per-function parity of the port's batched ensemble building blocks
(sella_tpu_torch.parallel.ensemble) with the JAX package, on the CPU.

Random batched inputs are made with numpy from a seed and handed to both
packages. Everything is float64 unless the function itself drops to
float32 (``_abs_ns``). Where a result depends on a basis convention (QR
or eigenvector signs), the test compares a basis-invariant quantity or
feeds both sides the same basis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.parallel.ensemble as J
import sella_tpu_torch.parallel.ensemble as T
from sella_tpu.ops.linalg import batched_eigh as jax_batched_eigh
from sella_tpu_torch.ops.linalg import batched_eigh

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _rand_sym(rng, B, n):
    A = rng.normal(size=(B, n, n))
    return A + np.swapaxes(A, 1, 2)


def _tet(seed, n):
    tet = np.array(
        [[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
         [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]
    ) * 1.12
    rng = np.random.RandomState(seed)
    return (tet[None] + 0.1 * rng.normal(size=(n, 4, 3))).reshape(n, 12)


def _basis(rng, B, d, q):
    """Random orthonormal (B, d, q) bases, shared by both packages."""
    return np.stack([np.linalg.qr(rng.normal(size=(d, d)))[0][:, :q]
                     for _ in range(B)])


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nproj", [0, 3, 5, 6])
def test_free_basis_projector(nproj):
    if nproj == 5:
        rng = np.random.RandomState(0)
        line = np.linspace(0, 3, 4)[:, None] * np.array([1.0, 0.5, 0.2])
        x = np.stack([(line + 0.0 * rng.normal()).ravel() + s
                      for s in range(3)])
    else:
        x = _tet(1, 3)
    U_t = T.free_basis(_t(x), nproj)
    U_j = jax.vmap(lambda y: J.free_basis(y, nproj))(jnp.asarray(x))
    assert U_t.shape == U_j.shape
    P_t = U_t @ U_t.transpose(1, 2)
    P_j = np.einsum("bij,bkj->bik", U_j, U_j)
    assert np.abs(P_t.numpy() - P_j).max() < 1e-12
    eye = torch.eye(U_t.shape[2], dtype=U_t.dtype)
    assert (U_t.transpose(1, 2) @ U_t - eye).abs().max() < 1e-12


def test_free_basis_rejects_bad_nproj():
    with pytest.raises(ValueError):
        T.free_basis(_t(_tet(0, 2)), 4)


@pytest.mark.parametrize("mode", [None, "f64", "f32"])
def test_batched_eigh_modes(mode):
    rng = np.random.RandomState(2)
    A = _rand_sym(rng, 3, 7)
    w_t, _ = batched_eigh(_t(A), mode)
    w_j, _ = jax_batched_eigh(jnp.asarray(A), mode)
    assert w_t.dtype == torch.float64
    # f32 factorization: float32 eigenvalue accuracy class
    assert _rel(w_t, w_j) < (1e-6 if mode == "f32" else 1e-12)


@pytest.mark.parametrize("mode", ["refined", "robust", "bogus"])
def test_batched_eigh_unported_modes_raise(mode):
    """``refined`` is not ported and an unknown mode is refused;
    ``robust`` is ported as float64 ``torch.linalg.eigh`` (the Gram
    eighs of the internal tier) and no longer raises."""
    A = _t(_rand_sym(np.random.RandomState(0), 2, 4))
    if mode == "robust":
        w, V = batched_eigh(A, mode)
        w64, V64 = torch.linalg.eigh(A)
        assert w.dtype == torch.float64
        assert torch.equal(w, w64) and torch.equal(V, V64)
        return
    with pytest.raises(NotImplementedError if mode != "bogus"
                       else ValueError):
        batched_eigh(A, mode)


def test_masked_ritz():
    rng = np.random.RandomState(3)
    B, m, K = 4, 9, 5
    V = rng.normal(size=(B, m, K))
    AV = rng.normal(size=(B, m, K))
    k = np.array([1, 3, 5, 2], np.int32)
    cm = np.arange(K)[None, :] < k[:, None]
    V, AV = V * cm[:, None, :], AV * cm[:, None, :]
    l_t, _, c_t = T._masked_ritz(_t(V), _t(AV), _t(k), K)
    l_j, _, c_j = J._masked_ritz(jnp.asarray(V), jnp.asarray(AV),
                                 jnp.asarray(k), K)
    assert _rel(l_t, l_j) < 1e-12
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


@pytest.mark.parametrize("fn", ["sym_solve", "_sym_pinv", "_blstsq"])
def test_eigh_route_solves(fn):
    rng = np.random.RandomState(4)
    A = _rand_sym(rng, 4, 6)
    A[1, 3:, :] = 0.0     # rank-deficient lane: the cut must agree
    A[1, :, 3:] = 0.0
    if fn == "sym_solve":
        b = rng.normal(size=(4, 6))
        out_t = T.sym_solve(_t(A), _t(b))
        out_j = J.sym_solve(jnp.asarray(A), jnp.asarray(b))
    elif fn == "_sym_pinv":
        out_t = T._sym_pinv(_t(A))
        out_j = J._sym_pinv(jnp.asarray(A))
    else:
        Bv = rng.normal(size=(4, 6, 5))
        out_t = T._blstsq(_t(A), _t(Bv))
        out_j = J._blstsq(jnp.asarray(A), jnp.asarray(Bv))
    assert _rel(out_t, out_j) < 1e-10


# ---------------------------------------------------------------------------
def _secant_inputs(seed, B=4, d=12, K=3):
    rng = np.random.RandomState(seed)
    H = _rand_sym(rng, B, d) / 4
    Bm = _rand_sym(rng, B, d) / 4 + 2.0 * np.eye(d)
    S = rng.normal(size=(B, d, K))
    Y = np.einsum("bij,bjk->bik", H, S) + 0.01 * rng.normal(size=S.shape)
    mask = np.ones((B, K), bool)
    mask[1, 2] = False
    mask[2, 1:] = False
    return Bm, S, Y, mask


@pytest.mark.parametrize("method", ["TS-BFGS", "BFGS", "BFGS_auto"])
def test_quasi_newton_updates(method):
    Bm, S, Y, mask = _secant_inputs(5)
    if method == "BFGS_auto":
        # make lane 0 BFGS-eligible (PD B, PD secant overlap)
        Y[0] = np.einsum("ij,jk->ik", Bm[0], S[0])
    out_t = T.quasi_newton_update_batched(_t(Bm), _t(S), _t(Y), _t(mask),
                                          method=method)
    out_j = J.quasi_newton_update_batched(
        jnp.asarray(Bm), jnp.asarray(S), jnp.asarray(Y), jnp.asarray(mask),
        method=method)
    assert _rel(out_t, out_j) < 1e-10
    with pytest.raises(ValueError):
        T.quasi_newton_update_batched(_t(Bm), _t(S), _t(Y), _t(mask),
                                      method="SR1")


def test_ts_bfgs_and_bootstrap():
    Bm, S, Y, mask = _secant_inputs(6)
    out_t = T.ts_bfgs_update_batched(_t(Bm), _t(S), _t(Y), _t(mask))
    out_j = J.ts_bfgs_update_batched(jnp.asarray(Bm), jnp.asarray(S),
                                     jnp.asarray(Y), jnp.asarray(mask))
    assert _rel(out_t, out_j) < 1e-10
    b_t = T.bootstrap_B_batched(_t(S), _t(Y), _t(mask), 12)
    b_j = J.bootstrap_B_batched(jnp.asarray(S), jnp.asarray(Y),
                                jnp.asarray(mask), 12)
    assert _rel(b_t, b_j) < 1e-10


def test_abs_ns_and_ts_bfgs_ns_metric():
    rng = np.random.RandomState(7)
    Q = np.stack([np.linalg.qr(rng.normal(size=(30, 30)))[0]
                  for _ in range(3)])
    lam = np.concatenate([-(10.0 ** rng.uniform(-4, 1.5, (3, 4))),
                          10.0 ** rng.uniform(-4, 1.5, (3, 26))], axis=1)
    A = np.einsum("bij,bj,bkj->bik", Q, lam, Q)
    a_t = T._abs_ns(_t(A))
    a_j = J._abs_ns(jnp.asarray(A))
    assert a_t.dtype == torch.float64
    # both sides run the same 24 float32 Newton-Schulz iterations;
    # float32 matmul rounding differs (1e-5 of the matrix scale)
    assert _rel(a_t, a_j) < 1e-5
    Bm, S, Y, mask = _secant_inputs(8)
    out_t = T.ts_bfgs_update_batched(_t(Bm), _t(S), _t(Y), _t(mask),
                                     absb="ns")
    out_j = J.ts_bfgs_update_batched(jnp.asarray(Bm), jnp.asarray(S),
                                     jnp.asarray(Y), jnp.asarray(mask),
                                     absb="ns")
    assert _rel(out_t, out_j) < 1e-5


# ---------------------------------------------------------------------------
def _secular_inputs(seed, B=6, q=7):
    rng = np.random.RandomState(seed)
    g = rng.normal(size=(B, q))
    g[0, 2] = 0.0          # an uncoupled pole
    g[3, :] = 0.0          # a zero gradient lane
    d = np.sort(rng.normal(size=(B, q)) * 3.0, axis=1)
    d[4, 1] = d[4, 0]      # a degenerate pole pair
    alpha = rng.uniform(0.2, 1.5, size=B)
    return g, d, alpha


@pytest.mark.parametrize("highest", [False, True])
def test_rfo_secular(highest):
    g, d, alpha = _secular_inputs(9)
    s_t, ds_t = T._rfo_secular(_t(g), _t(d), _t(alpha), highest)
    s_j, ds_j = jax.jit(J._rfo_secular, static_argnums=3)(
        jnp.asarray(g), jnp.asarray(d), jnp.asarray(alpha), highest)
    assert _rel(s_t, s_j) < 1e-11
    assert _rel(ds_t, ds_j) < 1e-11


def test_rfo_secular_per_row_highest():
    """One call with per-row ``highest`` equals two single-kind calls."""
    g, d, alpha = _secular_inputs(10)
    top = torch.tensor([True, False, True, False, True, False])
    s_t, ds_t = T._rfo_secular(_t(g), _t(d), _t(alpha), top)
    for h in (False, True):
        s_j, ds_j = J._rfo_secular(jnp.asarray(g), jnp.asarray(d),
                                   jnp.asarray(alpha), h)
        rows = (top == h).numpy()
        assert _rel(s_t[rows], np.asarray(s_j)[rows]) < 1e-11
        assert _rel(ds_t[rows], np.asarray(ds_j)[rows]) < 1e-11


@pytest.mark.parametrize("stepper", ["prfo", "qn"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_step_families(stepper, order):
    rng = np.random.RandomState(11 + order)
    B, q = 4, 8
    H = _rand_sym(rng, B, q)
    g = rng.normal(size=(B, q))
    alpha = rng.uniform(0.3, 1.0, size=B)
    prep_t = T.prfo_prepare_batched(_t(g), _t(H), order)
    # both sides from the SAME eigenbasis (eigenvector signs are a
    # LAPACK convention)
    prep_j = tuple(jnp.asarray(p.numpy()) for p in prep_t)
    fn_t = T.prfo_step_batched if stepper == "prfo" else T.qn_step_batched
    fn_j = J.prfo_step_batched if stepper == "prfo" else J.qn_step_batched
    s_t, ds_t = fn_t(prep_t, order, _t(alpha))
    s_j, ds_j = jax.jit(fn_j, static_argnums=1)(prep_j, order,
                                                jnp.asarray(alpha))
    assert _rel(s_t, s_j) < 1e-11
    assert _rel(ds_t, ds_j) < 1e-11


@pytest.mark.parametrize("method,rs", [("prfo", "ras"), ("prfo", "tr"),
                                       ("qn", "ras")])
def test_restricted_step(method, rs):
    rng = np.random.RandomState(12)
    B, nat = 5, 4
    d, q = 3 * nat, 3 * nat - 6
    H = _rand_sym(rng, B, q) / 2
    g = rng.normal(size=(B, q)) * 0.3
    U = _basis(rng, B, d, q)
    delta = np.array([0.05, 0.1, 2.0, 0.01, 0.3])   # lane 2: interior
    cfg_kw = dict(natoms=nat, order=1, method=method, rs=rs)
    prep_t = T.prfo_prepare_batched(_t(g), _t(H), 1)
    prep_j = tuple(jnp.asarray(p.numpy()) for p in prep_t)
    s_t, m_t = T.restricted_step_batched(_t(g), _t(H), _t(U), _t(delta),
                                         T.EnsembleConfig(**cfg_kw),
                                         prep=prep_t)
    cfg_j = J.EnsembleConfig(**cfg_kw)
    s_j, m_j = jax.jit(
        lambda *a: J.restricted_step_batched(*a, cfg_j, prep=prep_j))(
        jnp.asarray(g), jnp.asarray(H), jnp.asarray(U), jnp.asarray(delta))
    assert _rel(s_t, s_j) < 1e-9
    assert _rel(m_t, m_j) < 1e-9


def test_prfo_prepare_jacobi_route_on_cpu():
    """``method="jacobi"`` takes the plain Jacobi on a CPU tensor and
    returns the state dtype, like the JAX package's CPU route."""
    from sella_tpu_torch.ops.jacobi_eigh import jacobi_eigh_cuda

    rng = np.random.RandomState(13)
    H = _rand_sym(rng, 3, 10)
    g = rng.normal(size=(3, 10))
    l_t, V_t, gV_t = T.prfo_prepare_batched(_t(g), _t(H), 1,
                                            method="jacobi")
    l_j, V_j, gV_j = J.prfo_prepare_batched(jnp.asarray(g), jnp.asarray(H),
                                            1, method="jacobi")
    assert l_t.dtype == V_t.dtype == torch.float64
    # float32 Jacobi on both sides
    assert _rel(l_t, l_j) < 1e-5
    assert jacobi_eigh_cuda.launches == 0


# ---------------------------------------------------------------------------
def _davidson_case(name):
    """(jax pot, torch pot, cell, x, cfg kwargs, nproj)."""
    if name == "lj4":
        from sella_tpu.potentials import LennardJones as JLJ
        from sella_tpu_torch.potentials import LennardJones as TLJ

        return (JLJ(), TLJ(), np.zeros((3, 3)), _tet(14, 4),
                dict(natoms=4, order=1, gamma=1e-3))
    from sella_tpu.potentials.emt import EMT as JEMT, fcc111_slab
    from sella_tpu_torch.potentials import EMT as TEMT

    slab = fcc111_slab("Cu", 3.59, size=(2, 2, 2))
    nat = len(slab)
    rng = np.random.RandomState(15)
    x = np.stack([(slab.positions + 0.03 * rng.normal(
        size=slab.positions.shape)).ravel() for _ in range(3)])
    z = np.array([29] * nat)
    return (JEMT(z, pbc=True), TEMT(z, pbc=True), np.asarray(slab.cell), x,
            dict(natoms=nat, order=1, nproj=3, gamma=0.3, davidson_max=8))


@pytest.mark.parametrize("name", ["lj4", "emt"])
def test_davidson_and_absorb(name):
    jp, tp, cell, x, kw = _davidson_case(name)
    cfg_j, cfg_t = J.EnsembleConfig(**kw), T.EnsembleConfig(**kw)
    B = x.shape[0]
    rng = np.random.RandomState(16)
    g = np.stack([np.asarray(jp.energy_and_grad(jnp.asarray(xb),
                                                jnp.asarray(cell))[1])
                  for xb in x])
    U = np.asarray(jax.vmap(lambda y: J.free_basis(y, cfg_j.nproj))(
        jnp.asarray(x)))
    Bm = np.stack([np.eye(cfg_j.dim)] * B)
    Bm[1] = _rand_sym(rng, 1, cfg_j.dim)[0] / 3 + 2.0 * np.eye(cfg_j.dim)
    B_init = np.zeros(B, bool)
    B_init[1] = True
    active = np.ones(B, bool)
    active[-1] = False
    B_t, Bi_t, k_t = T._davidson_and_absorb(
        tp, _t(cell), cfg_t, _t(x), _t(g), _t(Bm), _t(B_init), _t(U),
        _t(active), torch.Generator().manual_seed(0))
    # jitted: the JAX package's eager dispatch of this call is ~6x slower
    B_j, Bi_j, k_j = jax.jit(
        lambda c, *a: J._davidson_and_absorb(jp, c, cfg_j, *a))(
        jnp.asarray(cell), jnp.asarray(x), jnp.asarray(g), jnp.asarray(Bm),
        jnp.asarray(B_init), jnp.asarray(U), jnp.asarray(active),
        jax.random.PRNGKey(0))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(Bi_t.numpy(), np.asarray(Bi_j))
    assert _rel(B_t, B_j) < 1e-7
    # the inactive lane's Hessian is untouched
    assert torch.equal(B_t[-1], _t(Bm[-1]))


def test_chunk_lanes_is_exact():
    calls = []

    def vfn(a, b):
        calls.append(a.shape[0])
        return a * 2.0, a + b

    a = torch.arange(8.0)
    whole = T._chunk_lanes(vfn, 0)(a, a)
    chunked = T._chunk_lanes(vfn, 2)(a, a)
    assert all(torch.equal(u, v) for u, v in zip(whole, chunked))
    assert calls == [8, 2, 2, 2, 2]
    T._chunk_lanes(vfn, 3)(a, a)      # not divisible: whole batch
    assert calls[-1] == 8
