"""The port's ``F32Potential`` (float32 evaluation behind a float64
interface): the five cases of ``tests/test_pot_f32.py`` on the port, at
the same tolerances, and the port's float32 energies against the JAX
package's.

* EMT gradient, HVP and strain gradient in float32 agree with float64 to
  the float32 noise floor, three orders below fmax = 1e-3.
* A batched LJ4 saddle search driven by float32 evaluations (with
  ``pred_min`` raised above the float32 energy noise) converges every
  lane the float64 run converges, to the same saddle. Both runs stop at
  34 steps rather than ``test_pot_f32.py``'s 100: every lane of these
  starts that converges does so by step 31 in both precisions, and the
  rest converge at neither cap (measured), so the claims are the same
  and the port's eager CPU steps cost a third.
* The ``pred_min`` guard keeps the float32 run sane (same starts and
  gate as ``test_pot_f32.py``), run in the same batch as the parity
  starts: lanes do not interact.

The energies of port and JAX package in float32 agree to 1e-6 relative
on LJ4. On the EMT bulk the energy is a cancellation of O(10 eV/atom)
terms to ~0.03 eV/atom, so the float32 rounding of either package is
~2e-4 of |E| (measured); there both are held to ``test_pot_f32.py``'s
absolute noise bound against float64 instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.potentials as JP
import sella_tpu_torch as T
from sella_tpu_torch.potentials import EMT, F32Potential, LennardJones, \
    fcc_bulk

torch.set_num_threads(1)

TET = np.array(
    [[0.0, 0.0, 0.0],
     [1.0, 0.0, 0.0],
     [0.5, np.sqrt(3.0) / 2.0, 0.0],
     [0.5, np.sqrt(3.0) / 6.0, np.sqrt(2.0 / 3.0)]]
) * 1.12
MAX_STEPS = 34
E_RTOL_VS_JAX = 1e-6


def _emt_case(seed):
    atoms = fcc_bulk("Cu", 3.59, reps=(2, 2, 2))
    n = len(atoms.positions)
    pot64 = EMT(np.array([29] * n), pbc=True)
    rng = np.random.RandomState(seed)
    x = torch.as_tensor((atoms.positions
                         + 0.05 * rng.normal(size=(n, 3))).ravel())
    return pot64, F32Potential(pot64), x, torch.as_tensor(atoms.cell), rng


def test_emt_grad_matches_f64():
    """The float32 copy casts floating buffers only and is the wrapper's
    only submodule; its gradient is float64 at the interface and within
    the float32 noise floor of the float64 one."""
    pot64, pot32, x, cell, _ = _emt_case(0)
    assert pot32._inner32.E0.dtype == torch.float32
    assert pot32._inner32.offsets.dtype == torch.float32
    assert pot32._inner32.zero_img.dtype == torch.bool
    # the wrapped potential itself is untouched, and is not a submodule
    # (moving the wrapper must not move it)
    assert pot64.E0.dtype == torch.float64
    assert [n for n, _ in pot32.named_children()] == ["_inner32"]
    with pytest.raises(ValueError):
        pot32.validate_cell(np.eye(3))       # delegated to the original
    n = x.shape[0] // 3
    e64, g64 = pot64.energy_and_grad(x, cell)
    e32, g32 = pot32.energy_and_grad(x, cell)
    assert e32.dtype == torch.float64 and g32.dtype == torch.float64
    assert abs(float(e32 - e64)) < 1e-5 * 15.0 * n
    assert float(torch.max(torch.abs(g32 - g64))) < 5e-5


def test_emt_hvp_matches_f64():
    pot64, pot32, x, cell, rng = _emt_case(1)
    v = torch.as_tensor(rng.normal(size=x.shape[0]))
    v = v / torch.linalg.norm(v)
    h64 = pot64.hvp(x, v, cell)
    h32 = pot32.hvp(x, v, cell)
    assert h32.dtype == torch.float64
    scale = float(torch.linalg.norm(h64))
    assert float(torch.linalg.norm(h32 - h64)) < 2e-4 * max(scale, 1.0)


def test_strain_grad_matches_f64():
    atoms = fcc_bulk("Cu", 3.59, reps=(2, 2, 2))
    n = len(atoms.positions)
    pot64 = EMT(np.array([29] * n), pbc=True)
    pot32 = F32Potential(pot64)
    x = torch.as_tensor(atoms.positions.ravel())
    cell = torch.as_tensor(atoms.cell)
    _, d64 = pot64.energy_and_strain_grad(x, cell)
    e32, d32 = pot32.energy_and_strain_grad(x, cell)
    assert e32.dtype == torch.float64 and d32.dtype == torch.float64
    assert float(torch.max(torch.abs(d32 - d64))) < 1e-3 * max(
        float(torch.max(torch.abs(d64))), 1.0
    )


def test_f32_energies_match_jax_f32():
    rng = np.random.RandomState(2)
    zero = np.zeros((3, 3))
    lj_j = jax.jit(JP.F32Potential(JP.LennardJones()).energy)
    for _ in range(4):
        x = (TET + 0.05 * rng.normal(size=(4, 3))).ravel()
        e_j = float(lj_j(jnp.asarray(x), jnp.asarray(zero)))
        e_t = float(F32Potential(LennardJones()).energy(
            torch.as_tensor(x), torch.as_tensor(zero)))
        assert abs(e_t - e_j) <= E_RTOL_VS_JAX * abs(e_j), (e_t, e_j)
    atoms = fcc_bulk("Cu", 3.59, reps=(2, 2, 2))
    n = len(atoms.positions)
    z = np.array([29] * n)
    x = (atoms.positions + 0.05 * rng.normal(size=(n, 3))).ravel()
    cell = np.asarray(atoms.cell)
    e64 = float(EMT(z, pbc=True).energy(torch.as_tensor(x),
                                        torch.as_tensor(cell)))
    e_t = float(F32Potential(EMT(z, pbc=True)).energy(
        torch.as_tensor(x), torch.as_tensor(cell)))
    e_j = float(jax.jit(JP.F32Potential(JP.EMT(z, pbc=True)).energy)(
        jnp.asarray(x), jnp.asarray(cell)))
    for e in (e_t, e_j):
        assert abs(e - e64) < 1e-5 * 15.0 * n, (e, e64)


def _starts(seed, n, scale):
    rng = np.random.RandomState(seed)
    return (TET[None] + scale * rng.normal(size=(n, 4, 3))).reshape(n, 12)


def _run(pot, x0, pred_min=1e-14):
    cfg = T.EnsembleConfig(natoms=4, order=1, fmax=1e-3, gamma=1e-3,
                           pred_min=pred_min)
    return T.run_ensemble(pot, torch.as_tensor(x0), cfg,
                          max_steps=MAX_STEPS)


@pytest.fixture(scope="module")
def runs():
    """The float64 run on the parity starts, and one float32 run on the
    parity starts (lanes 0-15) followed by the guard's (lanes 16-23)."""
    par = _starts(3, 16, 0.05)
    guard = _starts(5, 8, 0.03)
    base = _run(LennardJones(), par)
    alt = _run(F32Potential(LennardJones()), np.vstack([par, guard]),
               pred_min=1e-6)
    return base, alt


def test_saddle_search_f32_potential_parity(runs):
    base, alt = runs
    cb = base.converged.numpy()
    ca = alt.converged.numpy()[:16]
    assert cb.mean() > 0.5, "baseline must mostly converge"
    assert (ca | ~cb).all(), (cb, ca)
    both = cb & ca
    dx = np.abs(base.x.numpy() - alt.x.numpy()[:16])[both]
    assert dx.max() < 5e-2, dx.max()
    dsteps = np.abs(base.nsteps.numpy().astype(int)
                    - alt.nsteps.numpy()[:16].astype(int))[both]
    assert dsteps.mean() <= 10.0, dsteps


def test_pred_min_guard_accepts_subnoise_predictions(runs):
    _, alt = runs
    assert np.isfinite(alt.x.numpy()[16:]).all()
    assert alt.converged.numpy()[16:].mean() >= 0.5
