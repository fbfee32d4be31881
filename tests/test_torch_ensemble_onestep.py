"""One-step parity from a mid-run JAX state, and the state carry-over
(sella_tpu_torch.interop).

The JAX package runs k steps; its state crosses to the port field by
field through numpy; then both take one more step from the same state.
Counters must be identical. The float fields agree to 1e-9 relative on
the LJ4 eigh route (float64 throughout) and to 1e-5 on the EMT jacobi
route, whose prep eigendecomposition is float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.parallel.ensemble as J
import sella_tpu_torch.parallel.ensemble as T
from sella_tpu.potentials import LennardJones as JLJ
from sella_tpu.potentials.emt import EMT as JEMT
from sella_tpu_torch.interop import state_from_numpy, state_to_numpy
from sella_tpu_torch.potentials import EMT as TEMT
from sella_tpu_torch.potentials import LennardJones as TLJ
from test_torch_ensemble_run import _graft_lj4_starts
from test_torch_ensemble_run_emt import headline_kwargs, headline_starts

torch.set_num_threads(2)

COUNTERS = ("converged", "B_init", "nsteps", "neval", "nmatvec",
            "nsteps_since_diag", "stall", "nrestarts")
FLOATS = ("x", "f", "g", "B", "delta")


def _route(name):
    if name == "lj4_eigh":
        kw = dict(natoms=4, order=1, fmax=1e-3, gamma=1e-3)
        return JLJ(), TLJ(), _graft_lj4_starts(lanes=6), np.zeros((3, 3)), \
            kw, 1e-9
    x0, cell, nat = headline_starts(3)
    z = np.array([29] * nat)
    return JEMT(z, pbc=True), TEMT(z, pbc=True), x0, cell, \
        headline_kwargs(nat, 3), 1e-5


def _jax_state_after(jpot, x0, cfg, cell, k):
    step = jax.jit(J.make_step_fn(jpot, cfg, jnp.asarray(cell)))
    state = J.init_state(jpot, jnp.asarray(x0), cfg, jnp.asarray(cell))
    key = jax.random.PRNGKey(0)
    for i in range(k):
        state = step(state, jax.random.fold_in(key, i))
    return state, step, key


@pytest.mark.parametrize("name,k", [("lj4_eigh", 0), ("lj4_eigh", 6),
                                    ("emt_jacobi", 0), ("emt_jacobi", 3)])
def test_one_step_from_jax_state(name, k):
    jpot, tpot, x0, cell, kw, rtol = _route(name)
    jcfg, tcfg = J.EnsembleConfig(**kw), T.EnsembleConfig(**kw)
    js, jstep, key = _jax_state_after(jpot, x0, jcfg, cell, k)
    fields = {f: np.asarray(getattr(js, f)) for f in J.SearchState._fields}
    ts = state_from_numpy(fields, device="cpu")
    js1 = jstep(js, jax.random.fold_in(key, k))
    tstep = T.make_step_fn(tpot, tcfg, torch.as_tensor(cell))
    ts1 = tstep(ts, torch.Generator().manual_seed(0))
    # the step is out of place: the carried state is untouched
    for f, a in fields.items():
        np.testing.assert_array_equal(getattr(ts, f).numpy(), a)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(ts1, f).numpy(),
                                      np.asarray(getattr(js1, f)),
                                      err_msg=f)
    for f in FLOATS:
        a, b = getattr(ts1, f).numpy(), np.asarray(getattr(js1, f))
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert rel < rtol, (f, rel)


def test_state_round_trip_is_exact():
    jpot, _, x0, cell, kw, _ = _route("lj4_eigh")
    js, _, _ = _jax_state_after(jpot, x0, J.EnsembleConfig(**kw), cell, 2)
    fields = {f: np.asarray(getattr(js, f)) for f in J.SearchState._fields}
    ts = state_from_numpy(fields, device="cpu")
    assert ts.x.dtype == torch.float64 and ts.nsteps.dtype == torch.int32
    assert ts.converged.dtype == torch.bool and ts.fmax_t.dim() == 0
    back = state_to_numpy(ts)
    assert set(back) == set(fields)
    for f, a in fields.items():
        assert back[f].dtype == a.dtype
        np.testing.assert_array_equal(back[f], a)
    with pytest.raises(KeyError):
        state_from_numpy({f: a for f, a in fields.items() if f != "B"},
                         device="cpu")


def test_unported_options_raise():
    """Only ``mesh=`` is left unported; the restart, inertia and
    constraint options build a step, and inconsistent constraint
    arguments are refused as in the JAX package."""
    pot = TLJ()
    for kw in (dict(restart_after=10), dict(dmax_restart=3.0),
               dict(conv_inertia=True)):
        assert callable(T.make_step_fn(pot, T.EnsembleConfig(natoms=4, **kw)))
    assert callable(T.make_step_fn(pot, T.EnsembleConfig(natoms=4, ncons=1),
                                   constraints=lambda x: x[:1]))
    with pytest.raises(ValueError):
        T.make_step_fn(pot, T.EnsembleConfig(natoms=4, ncons=1))
    with pytest.raises(ValueError):
        T.make_step_fn(pot, T.EnsembleConfig(natoms=4),
                       constraints=lambda x: x[:1])
    with pytest.raises(ValueError):
        T.make_step_fn(pot, T.EnsembleConfig(natoms=4, ncons=2),
                       constraints=lambda x: x[:1])
    with pytest.raises(ValueError):
        T.make_step_fn(pot, T.EnsembleConfig(natoms=4, ncons=1),
                       constraints=lambda x: x[:1], comparators=("ge",))
    with pytest.raises(NotImplementedError):
        T.run_ensemble(pot, torch.as_tensor(_graft_lj4_starts(lanes=2)),
                       T.EnsembleConfig(natoms=4), mesh=object())
    with pytest.raises(NotImplementedError):
        T.run_ensemble_queue(pot, torch.as_tensor(_graft_lj4_starts(lanes=2)),
                             T.EnsembleConfig(natoms=4), batch=2,
                             mesh=object())


def test_init_state_is_float64_on_x0_device():
    """Optimizer state is float64 whatever the dtype of ``x0``."""
    x0 = torch.as_tensor(_graft_lj4_starts(lanes=2), dtype=torch.float32)
    st = T.init_state(TLJ(), x0, T.EnsembleConfig(natoms=4))
    for f in ("x", "f", "g", "B", "delta", "rho", "best_fmax", "x_home",
              "fmax_t"):
        assert getattr(st, f).dtype == torch.float64, f
    assert all(t.device == x0.device for t in st)
