"""The port's cell-binned and row-chunked potentials against the JAX
package's, in float64 on the CPU.

The same numpy-seeded geometries go through both packages. Candidate
lists are integer results and must be identical (the port's stable sort
keeps the JAX ranks, so a bin over capacity drops the same atoms);
squared distances agree to 1e-12 absolute. Energies, gradients and HVPs
differ only in summation order: 1e-10 relative. The row-chunked
evaluation sums the same terms in another order: 1e-12 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.potentials as J
import sella_tpu_torch.potentials as T
from sella_tpu.potentials.binned import BinnedPairPotential as JBinned
from sella_tpu.potentials.emt import BinnedEMT as JBinnedEMT
from sella_tpu.potentials.emt import fcc111_slab as jax_fcc111_slab
from sella_tpu.potentials.sharded import ChunkedPairPotential as JChunked

torch.set_num_threads(2)

RTOL = 1e-10
R2_ATOL = 1e-12
CHUNK_RTOL = 1e-12


def _cloud(n, scale, seed):
    return np.random.RandomState(seed).uniform(0, scale, size=3 * n)


def _triclinic(seed=4):
    cell = np.array([[12.0, 0, 0], [3.0, 11.0, 0], [1.0, 2.0, 10.5]])
    frac = np.random.RandomState(seed).uniform(size=(80, 3))
    return (frac @ cell).ravel(), cell


# (x, cell or None, capacity): tests/test_binned.py:18-75 and :176-201
CANDIDATE_CASES = {
    "free": lambda: (_cloud(120, 8.0, 2), None, None),
    "cubic": lambda: (_cloud(100, 10.0, 3), 10.0 * np.eye(3), None),
    "triclinic": lambda: (*_triclinic(), None),
    "capacity1": lambda: (_cloud(100, 12.0, 4), 12.0 * np.eye(3), 1),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _jax_eg_hvp(pot, x, cell, v):
    """Energy, gradient and HVP of a JAX potential, in one jit (eager
    dispatch of the transforms costs ~10x the compile here)."""
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


@pytest.mark.parametrize("case", sorted(CANDIDATE_CASES))
def test_candidates_match_jax(case):
    """Candidate sets, r2 and masks, the overflow count and the host
    occupancy, for a free cluster, a cubic and a triclinic periodic box,
    and a capacity of 1 under which the same atoms overflow in both."""
    x, cell, cap = CANDIDATE_CASES[case]()
    pbc = cell is not None
    cell_np = cell if pbc else np.zeros((3, 3))
    jb = JBinned(J.LennardJones(rc=2.5, pbc=pbc), rc=2.5, x0=x, cell=cell,
                 capacity=cap)._bins
    tb = T.BinnedPairPotential(T.LennardJones(rc=2.5, pbc=pbc), rc=2.5,
                               x0=x, cell=cell, capacity=cap)._bins
    assert (tb.nbins, tb.ncells, tb.capacity) == (jb.nbins, jb.ncells,
                                                  jb.capacity)
    pos_j = jnp.asarray(x).reshape(-1, 3)
    pos_t = torch.as_tensor(x).reshape(-1, 3)
    cell_j, cell_t = jnp.asarray(cell_np), torch.as_tensor(cell_np)
    cj, r2j, vj = (np.asarray(a) for a in jax.jit(jb.candidates)(pos_j,
                                                                 cell_j))
    ct, r2t, vt = (a.numpy() for a in tb.candidates(pos_t, cell_t))
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(r2t[vt], r2j[vj], rtol=0, atol=R2_ATOL)
    over = int(tb.overflow_count(pos_t, cell_t))
    assert over == int(jax.jit(jb.overflow_count)(pos_j, cell_j))
    assert tb.max_occupancy(x) == jb.max_occupancy(x)
    assert (over > 0) == (cap == 1)


def test_binned_pair_matches_jax_and_chunks():
    """BinnedPairPotential energy, gradient and HVP against the JAX
    package (periodic LJ, shifted); chunk=64 equals the full panel
    (tests/test_binned.py:144-173); a cell under 3 rc raises."""
    rng = np.random.RandomState(2)
    x = rng.uniform(0, 12.0, size=600)
    v = rng.normal(size=600)
    cell = 12.0 * np.eye(3)
    jl, tl = J.LennardJones(pbc=True), T.LennardJones(pbc=True)
    ej, gj, hj = _jax_eg_hvp(JBinned(jl, rc=2.5, x0=x, cell=cell), x, cell,
                             v)
    full = T.BinnedPairPotential(tl, rc=2.5, x0=x, cell=cell)
    et, gt, ht = _torch_eg_hvp(full, x, cell, v)
    assert abs(et - ej) < RTOL * abs(ej)
    assert _rel(gt, gj) < RTOL and _rel(ht, hj) < RTOL
    chunked = T.BinnedPairPotential(tl, rc=2.5, x0=x, cell=cell, chunk=64)
    ec, gc, hc = _torch_eg_hvp(chunked, x, cell, v)
    assert abs(ec - et) < CHUNK_RTOL * abs(et)
    assert _rel(gc, gt) < CHUNK_RTOL and _rel(hc, ht) < CHUNK_RTOL
    assert float(chunked.energy(torch.as_tensor(x),
                                torch.as_tensor(cell))) == pytest.approx(
        et, rel=CHUNK_RTOL)
    with pytest.raises(ValueError, match="3 rc"):
        T.BinnedPairPotential(tl, rc=2.5, x0=x[:60],
                              cell=6.0 * np.eye(3))


def test_binned_emt_and_chunked_pair_match_jax():
    """BinnedEMT against the JAX BinnedEMT and the port's dense EMT on a
    rattled Cu(111) slab tall enough for the binned path, chunked and
    not; ChunkedPairPotential against the JAX one (periodic LJ)."""
    slab = jax_fcc111_slab("Cu", 3.59, size=(8, 10, 4), vacuum=12.0)
    rng = np.random.RandomState(7)
    x = (slab.positions + 0.05 * rng.normal(size=slab.positions.shape)
         ).ravel()
    cell = np.asarray(slab.cell)
    v = rng.normal(size=x.shape)
    z = np.array([29] * (x.size // 3))
    ej, gj, hj = _jax_eg_hvp(JBinnedEMT(z, x, cell, capacity=32), x, cell,
                             v)
    for chunk in (None, 100):
        pot = T.BinnedEMT(z, x, cell, capacity=32, chunk=chunk)
        et, gt, ht = _torch_eg_hvp(pot, x, cell, v)
        assert abs(et - ej) < RTOL * abs(ej), chunk
        assert _rel(gt, gj) < RTOL and _rel(ht, hj) < RTOL, chunk
    ed, gd, hd = _torch_eg_hvp(T.EMT(z, pbc=True), x, cell, v)
    assert abs(et - ed) < RTOL * abs(ed)
    assert _rel(gt, gd) < RTOL and _rel(ht, hd) < RTOL

    xl = rng.uniform(0, 9.0, size=3 * 60)
    cl = 9.0 * np.eye(3)
    kw = dict(epsilon=0.4, sigma=2.3, rc=4.0, pbc=True)
    ej, gj, hj = _jax_eg_hvp(JChunked(J.LennardJones(**kw), chunk=16), xl,
                             cl, v[:180])
    et, gt, ht = _torch_eg_hvp(T.ChunkedPairPotential(
        T.LennardJones(**kw), chunk=16), xl, cl, v[:180])
    assert abs(et - ej) < RTOL * abs(ej)
    assert _rel(gt, gj) < RTOL and _rel(ht, hj) < RTOL
