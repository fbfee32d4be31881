"""The port's atom+cell tier (``sella_tpu_torch.parallel.ensemble_cell``)
against the JAX package's, lane by lane, in float64 on the CPU.

* One ``make_cell_step_fn`` step from one state carried across with
  ``interop``: ``z``, ``f``, ``g`` and ``H`` agree to 1e-10.
* The bench's atom+cell config (``bench.py:1067-1130``: bulk Cu EMT 2x2x2
  supercell, 32 atoms, 9 cell DOF, 3% over-expanded, rattled, random
  cell parameters, fmax 1e-3, ``absb="ns"``) at 2 lanes, run to
  convergence: per lane ``nsteps``, ``neval`` and ``converged``
  identical (36/35 steps), ``z`` within 1e-6.

The periodic-LJ cases (cell mask, pressure, the saddle branch) are in
``tests/test_torch_ensemble_cell_lj.py``. The JAX reference runs its
jitted step in a host loop (:func:`_jax_run`), so the one-step case and
the run share one compile. The loop is ``run_cell_ensemble``'s
trajectory: the random key feeds only the Davidson dead-vector draw,
which these configurations never take.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.parallel.ensemble_cell as J
import sella_tpu_torch.parallel.ensemble_cell as T
from sella_tpu.potentials.emt import EMT as JEMT
from sella_tpu.potentials.emt import fcc_bulk
from sella_tpu_torch.interop import state_from_numpy, state_to_numpy
from sella_tpu_torch.potentials import EMT as TEMT

torch.set_num_threads(1)

ONESTEP_ATOL = 1e-10
Z_ATOL = 1e-6


def _jax_run(pot, x0, cfg, cell0, s0=None, cell_mask=None, max_steps=250,
             chunk=10):
    """The JAX package's trajectory: ``init_cell_state`` and the step,
    each jitted (one compile each rather than op-by-op dispatch), the
    step in a host loop that checks convergence every ``chunk`` steps.
    Returns the final state, the state after the first step and the
    jitted step."""
    step = jax.jit(J.make_cell_step_fn(pot, cfg, cell_mask=cell_mask))
    init = jax.jit(lambda x, c, s: J.init_cell_state(pot, x, cfg, c,
                                                     cell_mask, s))
    st = init(jnp.asarray(x0), jnp.asarray(cell0),
              None if s0 is None else jnp.asarray(s0))
    key = jax.random.PRNGKey(0)
    first = None
    for i in range(max_steps):
        st = step(st, jax.random.fold_in(key, i))
        if first is None:
            first = st
        if (i + 1) % chunk == 0 and bool(jnp.all(st.converged)):
            break
    return st, first, step


def _bench_setup(batch):
    """bench.py:1085-1096."""
    atoms = fcc_bulk("Cu", 3.59 * 1.03, reps=(2, 2, 2))
    nat = len(atoms)
    rng = np.random.RandomState(0)
    x0 = np.stack([
        (atoms.positions
         + 0.05 * rng.normal(size=atoms.positions.shape)).ravel()
        for _ in range(batch)
    ])
    s0 = 0.02 * rng.normal(size=(batch, 9))
    kw = dict(natoms=nat, ncell=9, order=0, nproj=3, fmax=1e-3,
              delta0=0.1, absb="ns")
    return nat, x0, s0, np.asarray(atoms.cell), kw


@pytest.fixture(scope="module")
def bench():
    nat, x0, s0, cell0, kw = _bench_setup(2)
    z = np.array([29] * nat)
    js, jfirst, jstep = _jax_run(JEMT(z, pbc=True), x0,
                                 J.CellEnsembleConfig(**kw), cell0, s0)
    ts = T.run_cell_ensemble(TEMT(z, pbc=True), x0,
                             T.CellEnsembleConfig(**kw), cell0, s0=s0,
                             max_steps=250, steps_per_call=10,
                             device="cpu")
    return dict(nat=nat, kw=kw, z=z, js=js, jfirst=jfirst, jstep=jstep,
                ts=ts)


def test_one_step_matches_jax(bench):
    """One step from the JAX state after its first step (so H is no
    longer the bootstrap one), carried across field by field."""
    js1 = bench["jfirst"]
    fields = {k: np.asarray(getattr(js1, k)) for k in js1._fields}
    st = state_from_numpy(fields, device="cpu", state_cls=T.CellSearchState)
    assert isinstance(st, T.CellSearchState)
    assert st.nsteps.dtype == torch.int32 and st.H.dtype == torch.float64
    back = state_to_numpy(st)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v)
    step = T.make_cell_step_fn(TEMT(bench["z"], pbc=True),
                               T.CellEnsembleConfig(**bench["kw"]))
    ts2 = step(st)
    js2 = bench["jstep"](js1, jax.random.PRNGKey(1))
    for k in ("z", "f", "g", "H"):
        a, b = getattr(ts2, k).numpy(), np.asarray(getattr(js2, k))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=ONESTEP_ATOL * max(1.0,
                                                           np.abs(b).max()),
                                   err_msg=k)
    # the input state is not modified
    np.testing.assert_array_equal(st.z.numpy(), fields["z"])


@pytest.mark.parametrize("lane", [0, 1])
def test_bench_cell_lane_matches_jax(bench, lane):
    ts, js = bench["ts"], bench["js"]
    for k in ("nsteps", "neval", "nmatvec", "converged"):
        assert getattr(ts, k)[lane].item() == np.asarray(
            getattr(js, k))[lane].item(), k
    np.testing.assert_allclose(ts.z[lane].numpy(), np.asarray(js.z)[lane],
                               rtol=0, atol=Z_ATOL)


def test_bench_cell_config_converges_on_the_lattice(bench):
    ts = bench["ts"]
    assert bool(ts.converged.all())
    for name, t in zip(ts._fields, ts):
        assert t.device.type == "cpu", name
        if t.is_floating_point():
            assert t.dtype == torch.float64, name
        elif name != "converged":
            assert t.dtype == torch.int32, name
    cells = T.cells_of(ts, T.CellEnsembleConfig(**bench["kw"])).numpy()
    for C in cells:
        np.testing.assert_allclose(np.linalg.norm(C, axis=1) / 2.0, 3.593,
                                   atol=0.01)
        ortho = C @ C.T
        assert np.abs(ortho - np.diag(np.diag(ortho))).max() < 0.05
