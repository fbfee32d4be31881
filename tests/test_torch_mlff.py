"""The port's message-passing ML potential (``potentials.mlff``) against
the JAX package's, on the CPU.

With the same float64 weights both packages evaluate the same float64
formulas: energy, forces and HVP agree to 1e-10 relative. The committed
file stores float32; the JAX package keeps it so and computes its first
layer's gate and message products in float32, the port widens it to
float64 (``sella_tpu_torch/potentials/mlff.py``), so on the raw file the
two agree to float32 rounding, 1e-6 relative. Invariance, cutoff
smoothness and the float32 wrapper are held at the JAX tests'
tolerances (tests/test_mlff.py).
"""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import sella_tpu.parallel.largescale as JL
import sella_tpu_torch.parallel.largescale as TL
from sella_tpu.potentials import MLPotential as JMLPotential
from sella_tpu.potentials.emt import fcc_bulk
from sella_tpu_torch.interop import mlff_params_from_numpy
from sella_tpu_torch.potentials import F32Potential, MLPotential
from sella_tpu_torch.potentials.mlff import WEIGHTS_CU_EMT

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_WEIGHTS = os.path.join(ROOT, "sella_tpu", "potentials", "weights",
                           "mlff_cu_emt.npz")

RTOL = 1e-10
RAW_FILE_RTOL = 1e-6


def _rattled_box(reps, seed, amp=0.05):
    atoms = fcc_bulk("Cu", 3.59, reps=reps)
    pos = atoms.positions + amp * np.random.RandomState(seed).normal(
        size=atoms.positions.shape)
    return atoms.numbers, pos.ravel(), np.asarray(atoms.cell)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_eg_hvp(pot, x, cell, v):
    @jax.jit
    def f(x, cell, v):
        e, g = jax.value_and_grad(pot.energy)(x, cell)
        h = jax.jvp(jax.grad(lambda y: pot.energy(y, cell)), (x,), (v,))[1]
        return e, g, h

    e, g, h = f(*(jnp.asarray(a) for a in (x, cell, v)))
    return float(e), np.asarray(g), np.asarray(h)


def _torch_eg_hvp(pot, x, cell, v):
    x, cell, v = (torch.as_tensor(a) for a in (x, cell, v))
    e, g = pot.energy_and_grad(x, cell)
    return float(e), g.numpy(), pot.hvp(x, v, cell).numpy()


def test_weights_are_the_jax_packages_file():
    """The port ships its own byte-for-byte copy of the committed file."""
    assert os.path.dirname(WEIGHTS_CU_EMT).startswith(
        os.path.join(ROOT, "sella_tpu_torch"))
    assert filecmp.cmp(WEIGHTS_CU_EMT, JAX_WEIGHTS, shallow=False)


def test_committed_weights_match_jax():
    """Energy, forces and HVP on a rattled periodic Cu box (256 atoms,
    rc 4.5): float64 weights in both packages to 1e-10; the raw float32
    file to float32 rounding."""
    z, x, cell = _rattled_box((4, 4, 4), 0)
    v = np.random.RandomState(1).normal(size=x.shape)
    raw = JMLPotential.params_from_npz(JAX_WEIGHTS)
    p64 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), raw)
    tm = MLPotential(z, x, cell, rc=4.5,
                     params=MLPotential.params_from_npz(WEIGHTS_CU_EMT))
    assert all(b.dtype == torch.float64 for b in tm.params["layers"][0]
               .values())
    et, gt, ht = _torch_eg_hvp(tm, x, cell, v)
    ej, gj, hj = _jax_eg_hvp(JMLPotential(z, x, cell, rc=4.5, params=p64),
                             x, cell, v)
    assert abs(et - ej) < RTOL * abs(ej)
    assert _rel(gt, gj) < RTOL and _rel(ht, hj) < RTOL
    er, gr, _ = _jax_eg_hvp(JMLPotential(z, x, cell, rc=4.5, params=raw), x,
                            cell, v)
    assert abs(et - er) < RAW_FILE_RTOL * abs(er)
    assert _rel(gt, gr) < RAW_FILE_RTOL * 10


def test_random_init_carried_by_interop():
    """The JAX package's seeded random weights (a jax.random draw the
    port cannot repeat) carried across as numpy give the same energy;
    a save/load round trip keeps them."""
    z, x, cell = _rattled_box((3, 3, 3), 2)
    jm = JMLPotential(z, x, None, rc=3.5)
    tm = MLPotential(z, x, None, rc=3.5,
                     params=mlff_params_from_numpy(jm.params))
    ej = float(jax.jit(jm.energy)(jnp.asarray(x), jnp.zeros((3, 3))))
    et = float(tm.energy(torch.as_tensor(x), torch.zeros((3, 3),
                                                         dtype=torch.float64)))
    assert abs(et - ej) < RTOL * abs(ej)
    flat = mlff_params_from_numpy(jm.params)
    assert set(flat) == set(tm._names)


def test_invariance_and_cutoff_smoothness():
    """Rigid rotation + translation leaves the energy unchanged (1e-12,
    free boundaries), and one atom crossing rc changes it by < 1e-10
    (tests/test_mlff.py:39-66)."""
    z, x, _ = _rattled_box((3, 3, 3), 0)
    zero = torch.zeros((3, 3), dtype=torch.float64)
    pot = MLPotential(z, x, None)
    e0 = float(pot.energy(torch.as_tensor(x), zero))
    c, s = np.cos(0.5), np.sin(0.5)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    pos2 = (x.reshape(-1, 3) @ R.T + np.array([1.0, -2.0, 0.5])).ravel()
    pot2 = MLPotential(z, pos2, None, params=pot.params)
    e1 = float(pot2.energy(torch.as_tensor(pos2), zero))
    assert abs(e1 - e0) < 1e-12 * abs(e0)
    es = []
    for eps in (-1e-7, 1e-7):
        pos = np.array([[0.0, 0, 0], [5.0 + eps, 0, 0]]).ravel()
        es.append(float(MLPotential([29, 29], pos, None, rc=5.0).energy(
            torch.as_tensor(pos), zero)))
    assert abs(es[1] - es[0]) < 1e-10, es


def test_f32_wrap_matches_float64():
    """F32Potential(MLPotential) forces against float64 within
    3e-5 max(scale, 1) (tests/test_mlff.py:139-164); the float32 copy's
    weights are float32 and the wrapped potential's stay float64."""
    z, x, cell = _rattled_box((3, 3, 3), 0)
    pot = MLPotential(z, x, cell, rc=3.5)
    wrapped = F32Potential(pot)
    assert all(b.dtype == torch.float32 for n, b in
               wrapped._inner32.named_buffers() if b.is_floating_point())
    assert pot.embed.dtype == torch.float64
    xt, ct = torch.as_tensor(x), torch.as_tensor(cell)
    g64 = pot.grad(xt, ct).numpy()
    g32 = wrapped.grad(xt, ct)
    assert g32.dtype == torch.float64
    scale = float(np.abs(g64).max())
    np.testing.assert_allclose(g32.numpy(), g64,
                               atol=3e-5 * max(scale, 1.0))


def test_order1_mmf_step_matches_jax():
    """One order-1 MMF step (Lanczos HVPs through the network) from the
    same injected mode and the same float64 weights, on a rattled
    32-atom Cu cluster: the same HVP count, x within 1e-10."""
    z, x, _ = _rattled_box((2, 2, 2), 2, amp=0.02)
    jm = JMLPotential(z, x, None, rc=3.5)
    tm = MLPotential(z, x, None, rc=3.5,
                     params=mlff_params_from_numpy(jm.params))
    v0 = np.random.RandomState(0).normal(size=x.shape)
    v0 /= np.linalg.norm(v0)
    # jitted: the eager init dispatches the network's gradient op by op
    sj = jax.jit(lambda y: JL.mmf_init(jm, y))(jnp.asarray(x))._replace(
        mode=jnp.asarray(v0))
    sj = jax.jit(JL.make_mmf_step(jm, None, order=1, fmax=1e-3))(sj)
    step = TL.make_mmf_step(tm, None, order=1, fmax=1e-3)
    st = TL.mmf_init(tm, x, device="cpu")._replace(mode=torch.as_tensor(v0))
    st = step(st)
    assert int(st.nsteps) == 1 and int(st.nmatvec) == int(sj.nmatvec)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=0,
                               atol=1e-10)
    assert abs(float(st.lam) - float(sj.lam)) < 1e-8 * abs(float(sj.lam))
