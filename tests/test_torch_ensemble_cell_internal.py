"""The port's internal+cell tier against the JAX package, in float64 on
the CPU.

* Per-step parity on the LJ 2x2x2 bulk of
  ``tests/test_ensemble_cell_internal.py:23-36`` (2 lanes, 10 steps,
  full and hydrostatic masks): x, s, f and gs within 1e-8 and H within
  1e-8 of its largest entry, the same ``nsteps`` and ``converged``; the
  step draws nothing, so the lanes agree up to rounding. The trust
  norm's argmax takes the first index on a tie, and ``wrap_dq`` rounds
  half to even, in both packages.
* ``rigid_fragments=True`` on the two-Ar2-dimer box of ``:164-253``: the
  transport and five steps against the JAX package, and the corrected
  cell gradient against central differences along the transported path
  (that test's tolerance).
* The Niggli rebase (``tests/test_cell_internal_events.py``'s ``_bulk``
  at ``reps=2`` with a sheared lane) and the repave (its
  ``_cluster_in_box`` with a near-linear lane) against the JAX package:
  cell0, qact, qcons, s, q and H to 1e-12.
* The work queue at 2 lanes over 4 inputs against the JAX package, the
  device rule, ``mesh=`` and the dummy-atom ``ValueError``.

The JAX init, refresh and step are jitted (the guess Hessian cached on
the topology, since a traced init cannot call it), one compile per
configuration. At most 6 cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu  # noqa: F401  (float64 before any jnp use)
import sella_tpu.coords.internals as JIm
import sella_tpu.parallel.ensemble_cell_internal as JC
from sella_tpu import Atoms as JAtoms
from sella_tpu.coords.internals import Internals as JInternals
from sella_tpu.parallel import ensemble_internal as JE
from sella_tpu.potentials import LennardJones as JLJ
from sella_tpu.potentials.emt import fcc_bulk as jfcc_bulk

import sella_tpu_torch.parallel.ensemble_cell_internal as TC
from sella_tpu_torch import Atoms as TAtoms
from sella_tpu_torch import LennardJones as TLJ
from sella_tpu_torch.coords.internals import Internals as TInternals
from sella_tpu_torch.parallel import ensemble_internal as TE
from sella_tpu_torch.potentials import fcc_bulk as tfcc_bulk

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One OpenBLAS thread for the LAPACK calls of both packages (the JAX
    reference's eigh, numpy's pinv and svd): the test lane runs six
    workers on a few cores, where every worker's default thread pool
    spins against the others'. The results are the same to rounding."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


TOL = 1e-8
EVENT_TOL = 1e-12
R0 = 2.0 ** (1.0 / 6.0)


def _cached_guess(ints):
    H0 = ints.guess_hessian()
    ints.guess_hessian = lambda *a, **k: H0
    return ints


def _jit_init(pot, ints, x0, cfg, cell0, cell_mask=None, s0=None):
    """The JAX init, jitted (``cell_mask`` passed as a hashable tuple)."""
    return _JIT_INIT(pot, ints, jnp.asarray(x0), cfg, jnp.asarray(cell0),
                     cell_mask, None if s0 is None else jnp.asarray(s0))


def _init_impl(pot, ints, x0, cfg, cell0, cell_mask, s0):
    mask = None if cell_mask is None else np.asarray(cell_mask, bool)
    return JC.init_cell_internal_state(pot, ints, x0, cfg, cell0, mask, s0)


_JIT_INIT = jax.jit(_init_impl, static_argnums=(0, 1, 3, 5))
JC_recompute = JC._recompute_q_gq


def _jit_refresh():
    """The JAX ``refresh_cell_internal`` jitted, with its cell mask made
    hashable for the static argument (``cell0`` is unused there)."""
    impl = JC.refresh_cell_internal

    def inner(state, potential, ints, cfg, mask_key, mask):
        cm = None if mask_key is None else np.asarray(mask_key, bool)
        return impl(state, potential, ints, cfg, None, cm, mask)

    jitted = jax.jit(inner, static_argnums=(1, 2, 3, 4))

    def refresh(state, potential, ints, cfg, cell0=None, cell_mask=None,
                mask=None):
        return jitted(state, potential, ints, cfg, _mask_key(cell_mask),
                      mask)

    return refresh


def _mask_key(mask):
    return None if mask is None else tuple(map(tuple, np.asarray(mask)))


def _close(name, a, b, tol, scale=False):
    a = np.asarray(a, dtype=np.float64)
    b = b.numpy().astype(np.float64) if isinstance(b, torch.Tensor) \
        else np.asarray(b, dtype=np.float64)
    atol = tol * max(np.abs(a).max(), 1.0) if scale else tol
    np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=name)


def _lj_bulk(A, I, fcc, Bsz=2, seed=0):
    """``tests/test_ensemble_cell_internal.py:_bulk_setup``."""
    atoms = fcc("Cu", 1.55, reps=(2, 2, 2))
    ints = I(atoms)
    ints.find_all_bonds(scale=0.43)
    rng = np.random.RandomState(seed)
    x0 = np.stack([(atoms.positions + 0.02 * rng.normal(
        size=atoms.positions.shape)).ravel() for _ in range(Bsz)])
    s0 = 0.02 * rng.normal(size=(Bsz, 9))
    return atoms, ints, x0, s0


@pytest.mark.parametrize("mask_name", ["full", "hydrostatic"])
def test_step_matches_jax(mask_name):
    atoms, ji, x0, s0 = _lj_bulk(JAtoms, JInternals, jfcc_bulk)
    _, ti, _, _ = _lj_bulk(TAtoms, TInternals, tfcc_bulk)
    _cached_guess(ji)
    mask = None
    if mask_name == "hydrostatic":
        mask = np.eye(3, dtype=bool)
        s0 = 0.03 * np.random.RandomState(1).normal(size=(2, 3))
    cfg_j = JC.CellInternalEnsembleConfig(
        natoms=32, nint=ji.nint, ncell=9 if mask is None else 3, order=0,
        fmax=5e-3, delta0=0.1, h0_cell=10.0)
    cfg_t = TC.CellInternalEnsembleConfig(**cfg_j._asdict())
    jpot, tpot = JLJ(pbc=True), TLJ(pbc=True)
    sj = _jit_init(jpot, ji, x0, cfg_j, atoms.cell, _mask_key(mask), s0)
    st = TC.init_cell_internal_state(tpot, ti, x0, cfg_t, atoms.cell, mask,
                                     s0, device="cpu")
    for k in ("x", "s", "q", "f", "g", "gs", "gq"):
        _close(f"init {k}", getattr(sj, k), getattr(st, k), TOL)
    step_j = jax.jit(JC.make_cell_internal_step_fn(jpot, ji, cfg_j, None,
                                                   mask))
    step_t = TC.make_cell_internal_step_fn(tpot, ti, cfg_t, None, mask)
    key = jax.random.PRNGKey(0)
    for i in range(10):
        sj = step_j(sj, jax.random.fold_in(key, i))
        st = step_t(st)
        for k in ("x", "s", "f", "gs"):
            _close(f"step {i} {k}", getattr(sj, k), getattr(st, k), TOL)
        _close(f"step {i} H", sj.H, st.H, TOL, scale=True)
        assert np.array_equal(np.asarray(sj.nsteps), st.nsteps.numpy())
        assert np.array_equal(np.asarray(sj.converged),
                              st.converged.numpy())
    # every step ran the full-Newton loop: one host read per iteration
    assert step_t.host_syncs >= step_t.newton_iters >= 10

    # the trust norm's argmax takes the first index on a tie; wrap_dq
    # rounds half to even (r / 2 pi = +-0.5, 1.5), as jnp.round does
    w = np.concatenate([np.ones(ti.nint), np.ones(cfg_t.ncell)])
    s_full = np.zeros((1, cfg_t.nz))
    s_full[0, [3, 7, 11]] = [0.2, -0.2, 0.2]
    ds_full = np.arange(cfg_t.nz, dtype=float)[None] + 1.0
    val, dval = step_t.mis_norm(torch.as_tensor(s_full),
                                torch.as_tensor(ds_full))
    idx = int(jnp.argmax(jnp.asarray(w * np.abs(s_full[0]))))
    assert idx == 3
    assert float(val[0]) == 0.2 and float(dval[0]) == ds_full[0, idx]
    dih = ti.ntrans + ti.nbonds + ti.nangles
    if ti.ndihedrals:
        r = np.zeros((1, ti.nint))
        r[0, dih:dih + 3] = [np.pi, -np.pi, 3 * np.pi][:ti.ndihedrals]
        got = step_t.wrap_dq(torch.as_tensor(r)).numpy()
        want = r - 2 * np.pi * np.asarray(jnp.round(r / (2 * np.pi)))
        np.testing.assert_array_equal(got[0, dih:], want[0, dih:])
    half = torch.tensor([0.5, 1.5, 2.5, -0.5], dtype=torch.float64)
    np.testing.assert_array_equal(torch.round(half).numpy(),
                                  np.asarray(jnp.round(half.numpy())))


def _dimer_box(A, I, LJ):
    """``tests/test_ensemble_cell_internal.py:_dimer_box``."""
    pos = np.array([[2.0, 2.0, 2.0], [2.0, 2.0, 4.0],
                    [7.0, 5.5, 3.0], [7.0, 7.5, 3.0]])
    atoms = A(["Ar"] * 4, pos, cell=np.eye(3) * 12.0, pbc=True)
    ints = I(atoms, allow_fragments=True)
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    return atoms, ints, LJ(epsilon=0.0104, sigma=3.4, pbc=True), pos


def test_rigid_fragments_match_jax_and_fd():
    atoms, ji, jpot, pos = _dimer_box(JAtoms, JInternals, JLJ)
    _, ti, tpot, _ = _dimer_box(TAtoms, TInternals, TLJ)
    _cached_guess(ji)
    assert len(ti.fragment_atom_groups) == 2
    cfg_j = JC.CellInternalEnsembleConfig(natoms=4, nint=ji.nint, ncell=9,
                                          rigid_fragments=True,
                                          h0_cell=10.0)
    cfg_t = TC.CellInternalEnsembleConfig(**cfg_j._asdict())
    cell0 = np.asarray(atoms.cell)
    rng = np.random.RandomState(3)
    s_old = 0.05 * rng.normal(size=9)
    s_new = s_old + 0.3 * rng.normal(size=9)

    j_cell_of, j_make = JC._cell_map(cfg_j, None)
    t_cell_of, t_make = TC._cell_map(cfg_t, None)
    j_tr, j_gc = (jax.jit(f) for f in JC._rigid_maps(ji, cfg_j, j_cell_of))
    t_tr, t_gc = TC._rigid_maps(ti, cfg_t, t_cell_of)
    c0j, c0t = jnp.asarray(cell0), torch.as_tensor(cell0)
    xj = j_tr(jnp.asarray(pos.ravel()), j_cell_of(jnp.asarray(s_old), c0j),
              j_cell_of(jnp.asarray(s_new), c0j))
    xt = t_tr(torch.as_tensor(pos.ravel()),
              t_cell_of(torch.as_tensor(s_old), c0t),
              t_cell_of(torch.as_tensor(s_new), c0t))
    _close("transport", xj, xt, 1e-12)

    # the corrected cell gradient against central differences along the
    # transported path (tests/test_ensemble_cell_internal.py:226-253)
    enthalpy = t_make(tpot)
    s = torch.as_tensor(0.03 * np.random.RandomState(5).normal(size=9))
    x = torch.as_tensor(pos.ravel())
    g, gs_part = torch.func.grad(enthalpy, argnums=(0, 1))(x, s, c0t)
    gs_tot = (gs_part + t_gc(g, x, s, c0t)).numpy()
    gj, gsj = jax.jit(jax.grad(j_make(jpot), argnums=(0, 1)))(
        jnp.asarray(pos.ravel()), jnp.asarray(s.numpy()), c0j)
    _close("gs_corr", gsj + j_gc(gj, jnp.asarray(pos.ravel()),
                                 jnp.asarray(s.numpy()), c0j), gs_tot, 1e-12)
    h = 1e-6
    c_here = t_cell_of(s, c0t)
    for k in range(9):
        e = torch.zeros(9, dtype=torch.float64)
        e[k] = h
        fp = enthalpy(t_tr(x, c_here, t_cell_of(s + e, c0t)), s + e, c0t)
        fm = enthalpy(t_tr(x, c_here, t_cell_of(s - e, c0t)), s - e, c0t)
        fd = float((fp - fm) / (2 * h))
        np.testing.assert_allclose(gs_tot[k], fd, rtol=1e-3, atol=5e-7)

    # five steps of two lanes against the JAX package
    x0 = np.stack([pos.ravel(), pos.ravel() + 0.05 * rng.normal(size=12)])
    s0 = 0.02 * rng.normal(size=(2, 9))
    sj = _jit_init(jpot, ji, x0, cfg_j, cell0, None, s0)
    st = TC.init_cell_internal_state(tpot, ti, x0, cfg_t, cell0, s0=s0,
                                     device="cpu")
    step_j = jax.jit(JC.make_cell_internal_step_fn(jpot, ji, cfg_j, None))
    step_t = TC.make_cell_internal_step_fn(tpot, ti, cfg_t)
    for i in range(5):
        sj = step_j(sj, jax.random.PRNGKey(i))
        st = step_t(st)
        for k in ("x", "s", "f", "gs"):
            _close(f"rigid step {i} {k}", getattr(sj, k), getattr(st, k),
                   TOL)
        _close(f"rigid step {i} H", sj.H, st.H, TOL, scale=True)
        assert np.array_equal(np.asarray(sj.nsteps), st.nsteps.numpy())


def _shear_s(nat):
    """``tests/test_cell_internal_events.py:_shear_s``: parameters
    realizing the unimodular shear [[1,0,0],[1,1,0],[0,0,1]] exactly."""
    L = np.zeros((3, 3))
    L[1, 0] = 1.0
    return (float(nat) * L).ravel()


def _compare_event(sj, st, ij, it):
    assert ij.nint == it.nint
    for k in ("cell0", "s", "q", "H"):
        _close(f"event {k}", getattr(sj, k), getattr(st, k), EVENT_TOL,
               scale=(k == "H"))
    for k in ("qact", "qcons"):
        assert np.array_equal(np.asarray(getattr(sj, k)),
                              getattr(st, k).numpy()), k


def test_niggli_rebase_matches_jax(monkeypatch):
    def bulk(fcc, I):
        atoms = fcc("Cu", 1.55, reps=(2, 2, 2))
        ints = I(atoms)
        ints.find_all_bonds(scale=0.43)
        return atoms, ints

    atoms, ji = bulk(jfcc_bulk, JInternals)
    _, ti = bulk(tfcc_bulk, TInternals)
    _cached_guess(ji)
    pos = (atoms.positions + 0.01 * np.random.RandomState(0).normal(
        size=atoms.positions.shape)).ravel()
    x0 = np.stack([pos, pos])
    s0 = np.stack([np.zeros(9), _shear_s(32)])
    cfg_j = JC.CellInternalEnsembleConfig(natoms=32, nint=ji.nint, ncell=9,
                                          order=0, fmax=5e-3, h0_cell=10.0)
    cfg_t = TC.CellInternalEnsembleConfig(**cfg_j._asdict())
    jpot, tpot = JLJ(pbc=True, rc=1.4), TLJ(pbc=True, rc=1.4)
    sj = _jit_init(jpot, ji, x0, cfg_j, atoms.cell, None, s0)
    st = TC.init_cell_internal_state(tpot, ti, x0, cfg_t, atoms.cell,
                                     s0=s0, device="cpu")
    monkeypatch.setattr(JC, "refresh_cell_internal", _jit_refresh())
    sj2, ij2, cj2, hit_j = JC.niggli_rebase_cell_internal_lanes(
        sj, ji, cfg_j, potential=jpot)
    st2, it2, ct2, hit_t = TC.niggli_rebase_cell_internal_lanes(
        st, ti, cfg_t, potential=tpot)
    assert list(np.asarray(hit_j)) == hit_t.tolist() == [False, True]
    assert cj2.nint == ct2.nint
    _compare_event(sj2, st2, ij2, it2)
    _close("rebased f", sj2.f, st2.f, TOL)
    assert np.array_equal(np.asarray(sj2.neval), st2.neval.numpy())


def test_repave_matches_jax(monkeypatch):
    off = np.array([4.0, 4.0, 4.0])
    th = np.radians(0.2)
    b = np.array([R0, 0.0, 0.0])
    near_linear = np.stack([np.zeros(3), b,
                            b + R0 * np.array([np.cos(th), np.sin(th), 0]),
                            np.array([R0, 0.75 * R0, 0.6 * R0])])
    tet = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                    [0.5, np.sqrt(3.0) / 2.0, 0.0],
                    [0.5, np.sqrt(3.0) / 6.0, np.sqrt(2.0 / 3.0)]]) * R0

    def cluster(A, I):
        at = A(["He"] * 4, tet + off, cell=np.eye(3) * 12.0, pbc=True)
        ints = I(at)
        ints.find_all_bonds()
        ints.find_all_angles()
        ints.find_all_dihedrals()
        return at, ints

    at, ji = cluster(JAtoms, JInternals)
    _, ti = cluster(TAtoms, TInternals)
    _cached_guess(ji)
    mask = np.eye(3, dtype=bool)
    cfg_j = JC.CellInternalEnsembleConfig(natoms=4, nint=ji.nint, ncell=3,
                                          nproj=6, order=0, fmax=1e-3,
                                          h0_cell=10.0)
    cfg_t = TC.CellInternalEnsembleConfig(**cfg_j._asdict())
    x0 = np.stack([(tet + off).ravel(), (near_linear + off).ravel()])
    jpot, tpot = JLJ(pbc=True, rc=3.0), TLJ(pbc=True, rc=3.0)
    sj = _jit_init(jpot, ji, x0, cfg_j, at.cell, _mask_key(mask))
    st = TC.init_cell_internal_state(tpot, ti, x0, cfg_t, at.cell, mask,
                                     device="cpu")
    # the JAX event's host loop calls the engine and _recompute_q_gq
    # eagerly; jitted, each compiles once
    for name in ("_calc_impl", "_jac_impl", "_hldot_impl"):
        monkeypatch.setattr(JIm._Engine, name, jax.jit(
            getattr(JIm._Engine, name), static_argnums=0))
    recompute = jax.jit(
        lambda st, merged, cfg, key: JC_recompute(st, merged, cfg,
                                                  np.asarray(key, bool)),
        static_argnums=(1, 2, 3))
    monkeypatch.setattr(JC, "_recompute_q_gq", lambda st, merged, cfg, cm:
                        recompute(st, merged, cfg, _mask_key(cm)))
    bad_j = np.asarray(JE.bad_internals_mask(sj, ji, 0.5))
    bad_t = TE.bad_internals_mask(st, ti, 0.5).numpy()
    assert bad_j.tolist() == bad_t.tolist() == [False, True]
    sj2, ij2, cj2, done_j = JC.repave_cell_internal_lanes(
        sj, ji, cfg_j, bad_j, cell_mask=mask)
    st2, it2, ct2, done_t = TC.repave_cell_internal_lanes(
        st, ti, cfg_t, bad_t, cell_mask=mask)
    assert done_j.tolist() == done_t.tolist() == [False, True]
    assert cj2.nint == ct2.nint >= cfg_j.nint
    _compare_event(sj2, st2, ij2, it2)
    _close("repaved gq", sj2.gq, st2.gq, TOL)


def test_queue_matches_jax_and_entry_rules(monkeypatch):
    atoms, ji, x0, s0 = _lj_bulk(JAtoms, JInternals, jfcc_bulk, Bsz=4)
    _, ti, _, _ = _lj_bulk(TAtoms, TInternals, tfcc_bulk)
    _cached_guess(ji)
    cfg_j = JC.CellInternalEnsembleConfig(natoms=32, nint=ji.nint, ncell=9,
                                          order=0, fmax=5e-3, delta0=0.1,
                                          h0_cell=10.0)
    cfg_t = TC.CellInternalEnsembleConfig(**cfg_j._asdict())
    jpot, tpot = JLJ(pbc=True), TLJ(pbc=True)
    monkeypatch.setattr(JC, "init_cell_internal_state", jax.jit(
        JC.init_cell_internal_state, static_argnums=(0, 1, 3, 5)))
    monkeypatch.setattr(JC, "refresh_cell_internal", _jit_refresh())
    kw = dict(batch=2, max_steps_per_search=6, refill_every=3)
    out_j = JC.run_cell_internal_ensemble_queue(
        jpot, ji, jnp.asarray(x0), cfg_j, jnp.asarray(atoms.cell),
        s0_all=jnp.asarray(s0), **kw)
    out_t = TC.run_cell_internal_ensemble_queue(
        tpot, ti, x0, cfg_t, atoms.cell, s0_all=s0, device="cpu", **kw)
    assert len(out_t) == 4
    for a, b in zip(out_j, out_t):
        assert (a["nsteps"], a["converged"]) == (b["nsteps"],
                                                 b["converged"])
        _close("queue x", a["x"], b["x"], TOL)
        _close("queue s", a["s"], b["s"], TOL)
        assert abs(a["f"] - b["f"]) < TOL

    # the device rule: a numpy x0 goes to the GPU by default, raising
    # where there is none; a CPU tensor stays put; mesh= raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            TC.init_cell_internal_state(tpot, ti, x0[:1], cfg_t, atoms.cell)
    st = TC.init_cell_internal_state(tpot, ti, torch.as_tensor(x0[:1]),
                                     cfg_t, atoms.cell)
    assert st.x.device.type == "cpu" and st.H.dtype == torch.float64
    with pytest.raises(NotImplementedError):
        TC.run_cell_internal_ensemble(tpot, ti, x0, cfg_t, atoms.cell,
                                      mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        TC.run_cell_internal_ensemble_queue(tpot, ti, x0, cfg_t, atoms.cell,
                                            batch=2, mesh=object(),
                                            device="cpu")
    # dummy atoms raise, as in the JAX package
    oco = np.array([[-1.16, 0.0, 0.0], [0.0, 0.0, 0.0], [1.16, 0.0, 0.0]])
    di = TInternals(TAtoms(["O", "C", "O"], oco + 5.0,
                           cell=np.eye(3) * 10.0, pbc=True))
    di.find_all_bonds()
    di.find_all_angles()
    assert di.ndummies > 0
    with pytest.raises(ValueError, match="dummy"):
        TC.make_cell_internal_step_fn(
            tpot, di, TC.CellInternalEnsembleConfig(natoms=3,
                                                    nint=di.nint))
