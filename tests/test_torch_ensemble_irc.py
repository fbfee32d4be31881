"""The port's batched IRC tier against the JAX package, in float64 on the
CPU, from the LJ4 transition states of ``tests/test_ensemble_irc.py``
(the JAX saddle run of ``examples/04_irc_pipeline.py``'s stage, kept in
``tools/irc_lj4_ts.npz``; dx 0.4, fmax 1e-2, Ar masses).

* ``_mw_pivot`` in both branches (rigid-free and raw eigh): the pivot
  within 1e-12, with its canonical sign after the port's own eigh.
* ``run_irc_ensemble`` forward and reverse with path recording: x after
  every outer step within 1e-8, the same ``nsteps``, ``neval``,
  ``inner_fail`` and ``converged`` (nothing is drawn, so exact up to
  rounding).
* ``run_irc_ensemble_queue(directions="both")`` against the JAX queue,
  the device rule and ``mesh=``.
* ``IRCState`` round-tripped through ``interop`` and stepped by both
  packages from the same numbers.

Each JAX configuration compiles once. At most 6 cases.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu  # noqa: F401  (float64 before any jnp use)
from sella_tpu.parallel import ensemble_irc as JI
from sella_tpu.potentials import LennardJones as JLJ

from sella_tpu_torch import LennardJones as TLJ
from sella_tpu_torch import interop
from sella_tpu_torch.parallel import ensemble_irc as TI

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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASSES = np.full(4, 39.948)
SQRTM = np.repeat(np.sqrt(MASSES), 3)
X_TOL = 1e-8


@pytest.fixture(scope="module")
def ts():
    d = np.load(os.path.join(ROOT, "tools", "irc_lj4_ts.npz"))
    conv = d["converged"]
    assert conv.sum() >= 6
    return d["x"][conv], d["H"][conv], d["f"][conv]


def _cfgs(**kw):
    cj = JI.IRCEnsembleConfig(natoms=4, fmax=1e-2, dx=0.4, **kw)
    return cj, TI.IRCEnsembleConfig(**cj._asdict())


@pytest.mark.parametrize("pivot_free", [True, False])
def test_mw_pivot_matches_jax(ts, pivot_free, monkeypatch):
    x, H, _ = ts
    cj, ct = _cfgs(pivot_free=pivot_free)
    pj = np.asarray(JI._mw_pivot(jnp.asarray(x), jnp.asarray(H), cj,
                                 jnp.asarray(SQRTM)))
    pt = TI._mw_pivot(torch.as_tensor(x), torch.as_tensor(H), ct,
                      torch.as_tensor(SQRTM)).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(pt * SQRTM, axis=1), ct.dx,
                               atol=1e-12)
    # the pivot lies along negative curvature, and its sign does not
    # depend on the sign the eigh gives the mode: with every eigenvector
    # negated, the same pivot comes back
    for b in range(len(pt)):
        assert pt[b] @ H[b] @ pt[b] < 0
    if pivot_free:
        lead = pt[np.arange(len(pt)), np.argmax(np.abs(pt), axis=1)]
        assert np.all(lead > 0)
    eigh = TI.batched_eigh

    def flipped(A, mode=None):
        w, V = eigh(A, mode)
        return w, -V

    monkeypatch.setattr(TI, "batched_eigh", flipped)
    pf = TI._mw_pivot(torch.as_tensor(x), torch.as_tensor(H), ct,
                      torch.as_tensor(SQRTM)).numpy()
    np.testing.assert_array_equal(pf, pt)


@pytest.mark.parametrize("direction", ["forward", "reverse"])
def test_run_matches_jax_with_path(ts, direction):
    x, H, f_ts = ts
    cj, ct = _cfgs()
    sj, pj = JI.run_irc_ensemble(JLJ(), jnp.asarray(x), jnp.asarray(H), cj,
                                 MASSES, direction=direction, max_steps=150,
                                 record_path=True)
    st, pt = TI.run_irc_ensemble(TLJ(), x, H, ct, MASSES,
                                 direction=direction, max_steps=150,
                                 record_path=True, device="cpu")
    assert pt.shape == pj.shape
    np.testing.assert_allclose(pt, pj, rtol=0, atol=X_TOL)
    for k in ("nsteps", "neval", "inner_fail", "converged"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(sj, k)), err_msg=k)
    assert bool(st.converged.all())
    np.testing.assert_allclose(st.f.numpy(), -6.0, atol=1e-4)
    assert np.all(st.f.numpy() < f_ts - 0.1)
    # the caller's arrays are copied, never written
    x2, H2 = x.copy(), H.copy()
    xt = torch.as_tensor(x2)
    TI.run_irc_ensemble(TLJ(), xt, torch.as_tensor(H2), ct, MASSES,
                        max_steps=2)
    np.testing.assert_array_equal(xt.numpy(), x)


def test_queue_both_matches_jax_and_device_rule(ts):
    x, H, _ = ts
    cj, ct = _cfgs()
    out_j = JI.run_irc_ensemble_queue(JLJ(), jnp.asarray(x[:3]),
                                      jnp.asarray(H[:3]), cj, MASSES,
                                      batch=4, directions="both")
    out_t = TI.run_irc_ensemble_queue(TLJ(), x[:3], H[:3], ct, MASSES,
                                      batch=4, directions="both",
                                      device="cpu")
    assert [(r["ts"], r["direction"]) for r in out_t] == [
        (i, s) for i in range(3) for s in (1, -1)]
    for a, b in zip(out_j, out_t):
        for k in ("ts", "direction", "nsteps", "converged", "inner_fail"):
            assert a[k] == b[k], k
        np.testing.assert_allclose(b["x"], a["x"], rtol=0, atol=X_TOL)
        assert abs(a["f"] - b["f"]) < 1e-10
        assert b["neval"] > b["nsteps"]
    with pytest.raises(ValueError):
        TI.run_irc_ensemble_queue(TLJ(), x[:1], H[:1], ct, MASSES, batch=2,
                                  directions="sideways", device="cpu")
    with pytest.raises(NotImplementedError):
        TI.run_irc_ensemble(TLJ(), x, H, ct, MASSES, mesh=object(),
                            device="cpu")
    with pytest.raises(NotImplementedError):
        TI.run_irc_ensemble_queue(TLJ(), x, H, ct, MASSES, batch=2,
                                  mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            TI.init_irc_state(TLJ(), x, H, ct, MASSES)
    st = TI.init_irc_state(TLJ(), torch.as_tensor(x), H, ct, MASSES,
                           np.array([1.0, -1.0] * (len(x) // 2)
                                    + [1.0] * (len(x) % 2)))
    assert st.x.device.type == "cpu" and st.H.dtype == torch.float64
    np.testing.assert_allclose(st.d1[1].numpy(), -TI._mw_pivot(
        torch.as_tensor(x[1:2]), torch.as_tensor(H[1:2]), ct,
        torch.as_tensor(SQRTM))[0].numpy(), atol=1e-15)


def test_irc_state_interop_roundtrip(ts):
    x, H, _ = ts
    cj, ct = _cfgs()
    st = TI.init_irc_state(TLJ(), x, H, ct, MASSES, "reverse", device="cpu")
    fields = interop.state_to_numpy(st)
    back = interop.state_from_numpy(fields, device="cpu",
                                    state_cls=TI.IRCState)
    for k in TI.IRCState._fields:
        a, b = getattr(st, k), getattr(back, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    # the JAX package steps the same numbers to the same place
    sj = JI.IRCState(**{k: jnp.asarray(v) for k, v in fields.items()})
    sj = jax.jit(JI.make_irc_step_fn(JLJ(), cj, MASSES))(sj)
    st = TI.make_irc_step_fn(TLJ(), ct, MASSES)(back)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=X_TOL)
    np.testing.assert_allclose(st.H.numpy(), np.asarray(sj.H), rtol=0,
                               atol=X_TOL * np.abs(np.asarray(sj.H)).max())
    for k in ("neval", "nsteps", "converged", "inner_fail"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(sj, k)))
