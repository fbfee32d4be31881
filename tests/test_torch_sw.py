"""The port's Stillinger-Weber and harmonic potentials against the JAX
package's, in float64 on the CPU: energy, gradient and HVP to 1e-10
relative (the same formulas; only summation order differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import sella_tpu.potentials as J
import sella_tpu_torch.potentials as T
from sella_tpu.potentials.sw import si_diamond as jax_si_diamond

torch.set_num_threads(2)

RTOL = 1e-10


def _both(jpot, tpot, x, cell, v):
    """(energy, gradient, HVP) of each package's potential."""
    @jax.jit
    def f(x, cell, v):
        e, g = jax.value_and_grad(jpot.energy)(x, cell)
        h = jax.jvp(jax.grad(lambda y: jpot.energy(y, cell)), (x,), (v,))[1]
        return e, g, h

    ej, gj, hj = (np.asarray(a) for a in f(
        *(jnp.asarray(a) for a in (x, cell, v))))
    xt, ct, vt = (torch.as_tensor(a) for a in (x, cell, v))
    et, gt = tpot.energy_and_grad(xt, ct)
    return (ej, gj, hj), (et.numpy(), gt.numpy(), tpot.hvp(xt, vt, ct).numpy())


def _assert_close(ref, got):
    for a, b in zip(got, ref):
        assert np.abs(a - b).max() < RTOL * np.abs(b).max()


def test_stillinger_weber_matches_jax():
    """A rattled periodic diamond-Si 2x2x2 supercell (64 atoms), and the
    ideal cell's cohesive energy (-4.3366 eV/atom, tests/test_sw.py)."""
    atoms = jax_si_diamond(reps=(2, 2, 2))
    ported = T.si_diamond(reps=(2, 2, 2))
    np.testing.assert_array_equal(ported.positions, atoms.positions)
    np.testing.assert_array_equal(ported.cell, atoms.cell)
    rng = np.random.RandomState(0)
    x = (atoms.positions + 0.08 * rng.normal(size=atoms.positions.shape)
         ).ravel()
    v = rng.normal(size=x.shape)
    ref, got = _both(atoms.calc, ported.calc, x, np.asarray(atoms.cell), v)
    _assert_close(ref, got)
    one = T.si_diamond()
    e = float(one.calc.energy(torch.as_tensor(one.positions.ravel()),
                              torch.as_tensor(one.cell))) / 8
    assert abs(e - (-4.3366)) < 5e-3


def test_harmonic_matches_jax():
    """The quadratic test potential with a linear term: energy, gradient
    and HVP (= K v exactly)."""
    rng = np.random.RandomState(1)
    d = 12
    A = rng.normal(size=(d, d))
    K = A @ A.T + np.eye(d)
    x0, g0 = rng.normal(size=d), rng.normal(size=d)
    x, v = rng.normal(size=d), rng.normal(size=d)
    ref, got = _both(J.Harmonic(x0, K, g0), T.Harmonic(x0, K, g0), x,
                     np.zeros((3, 3)), v)
    _assert_close(ref, got)
    np.testing.assert_allclose(got[2], K @ v, rtol=1e-12)
