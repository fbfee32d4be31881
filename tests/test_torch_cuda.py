"""GPU tests of the port: the CUDA Jacobi kernel against its plain
version, one ensemble step (Cartesian and atom+cell) on the card against
the same step on the CPU, ``F32Potential`` on the card, the internal
tier's state on the card and its ``"robust"`` Gram eigh, and the
large-system path: the binned, chunked and ML potentials and
``run_mmf`` on the card against the CPU; the internal+cell tier's steps
and IRC on the card against the CPU, and a heterogeneous queue that
launches the kernel. They skip without a CUDA device.

This file imports neither jax nor the JAX package, so it runs on a GPU
host without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

import sella_tpu_torch.parallel.ensemble as T
from sella_tpu_torch.ops import jacobi_eigh as je
from sella_tpu_torch.potentials import EMT, fcc111_slab

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

# float32 Jacobi vs float64 eigh (the gates of tests/test_pallas_eigh.py)
EIG_RTOL = 5e-5
RES_TOL = 5e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _rand_sym(B, n, seed):
    rng = np.random.RandomState(seed)
    A = rng.normal(size=(B, n, n))
    return A + np.swapaxes(A, 1, 2)


def _spread_spectrum(seed, d, neg):
    """Eigenvalues spanning 1e-4..30 with ``neg`` negatives
    (tests/test_pallas_eigh.py:25-34)."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    lam = np.concatenate([
        -(10.0 ** rng.uniform(-4, 1.5, neg)),
        10.0 ** rng.uniform(-4, 1.5, d - neg),
    ])
    return (Q * lam) @ Q.T


def _check_gates(A, w, V, plain=True):
    """The gates of tests/test_pallas_eigh.py against float64 eigvalsh,
    and agreement with the plain version to float32 rounding."""
    A64 = A.double()
    w, V = w.double(), V.double()
    w_ref = torch.linalg.eigvalsh(A64)
    scale = float(w_ref.abs().max())
    assert float((w - w_ref).abs().max()) / scale < EIG_RTOL
    if plain:
        w_p, _ = je.jacobi_eigh_ref(A64)
        assert float((w - w_p).abs().max()) / scale < EIG_RTOL
    res = torch.linalg.norm(A64 @ V - V * w[:, None, :], dim=(1, 2))
    assert float((res / torch.linalg.norm(A64, dim=(1, 2))).max()) < RES_TOL
    eye = torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    assert float((V.transpose(1, 2) @ V - eye).abs().max()) < RES_TOL


@pytest.mark.parametrize("B,n", [(64, 72), (8, 20), (4, 9), (3, 127),
                                 (2, 128), (5, 1), (6, 2), (6, 3), (16, 71),
                                 (16, 73), (8, 100)])
def test_kernel_matches_plain_and_eigvalsh(cuda, B, n):
    """Every instantiation: the compile-time size (n = 71 padded, 72) and
    the run-time one (every other n). n = 127 and 128 need more than 48 KB
    of shared memory; odd n pads with a decoupled 1e30 entry."""
    A = torch.as_tensor(_rand_sym(B, n, n), device=cuda)
    before = je.jacobi_eigh_cuda.launches
    w, V = je.jacobi_eigh(A)
    torch.cuda.synchronize()
    assert je.jacobi_eigh_cuda.launches == before + 1
    assert w.dtype == V.dtype == A.dtype and V.shape == A.shape
    _check_gates(A, w, V)


@pytest.mark.parametrize("B", [1, 660, 1024, 1500])
def test_kernel_batches_around_the_wave_size(cuda, B):
    """660 blocks fill the card once at five blocks an SM; 1500 is more
    than two such waves. Two launches on one input agree bit for bit."""
    A = torch.as_tensor(_rand_sym(B, 72, 7), device=cuda)
    w, V = je.jacobi_eigh_cuda(A)
    w2, V2 = je.jacobi_eigh_cuda(A)
    torch.cuda.synchronize()
    assert torch.equal(w, w2) and torch.equal(V, V2)
    _check_gates(A, w, V, plain=B <= 660)


@pytest.mark.parametrize("n", [72, 71, 20, 9])
def test_kernel_reads_strides_and_dtypes(cuda, n):
    """A non-contiguous float64 view, its contiguous copy and its float32
    copy go through the same float32 solve: the first two agree bit for
    bit, and outputs come back in the caller's dtype."""
    big = torch.as_tensor(_rand_sym(12, n + 5, n), device=cuda)
    sub = big[:, 2:2 + n, 2:2 + n]
    view = sub.transpose(1, 2)
    assert not sub.is_contiguous() and not view.is_contiguous()
    w_s, V_s = je.jacobi_eigh_cuda(sub)
    w_c, V_c = je.jacobi_eigh_cuda(sub.contiguous())
    w_t, V_t = je.jacobi_eigh_cuda(view)
    w_tc, V_tc = je.jacobi_eigh_cuda(view.contiguous())
    w_f, V_f = je.jacobi_eigh_cuda(sub.contiguous().float())
    torch.cuda.synchronize()
    assert w_s.dtype == V_s.dtype == torch.float64
    assert w_f.dtype == V_f.dtype == torch.float32
    assert torch.equal(w_s, w_c) and torch.equal(V_s, V_c)
    assert torch.equal(w_t, w_tc) and torch.equal(V_t, V_tc)
    # float64 -> float32 is rounded the same way by the kernel and by .float()
    assert torch.equal(w_s.float(), w_f) and torch.equal(V_s.float(), V_f)
    _check_gates(sub, w_s, V_s)
    _check_gates(view, w_t, V_t)


@pytest.mark.parametrize("d,neg", [(72, 3), (75, 5)])
def test_kernel_hard_spectrum_negative_count(cuda, d, neg):
    """The saddle-order decision (count of negative eigenvalues) must be
    exact on a spectrum spanning 1e-4..30."""
    A = torch.as_tensor(np.stack([_spread_spectrum(s, d, neg)
                                  for s in range(4)]), device=cuda)
    w, V = je.jacobi_eigh_cuda(A)
    torch.cuda.synchronize()
    _check_gates(A, w, V)
    assert bool(((w < 0).sum(dim=1) == neg).all())


def test_kernel_float32_input_and_empty_batch(cuda):
    A = torch.as_tensor(_rand_sym(4, 16, 0), device=cuda,
                        dtype=torch.float32)
    w, V = je.jacobi_eigh_cuda(A)
    assert w.dtype == torch.float32
    w_ref = torch.linalg.eigvalsh(A.double())
    assert float((w.double() - w_ref).abs().max()) / float(
        w_ref.abs().max()) < EIG_RTOL
    before = je.jacobi_eigh_cuda.launches
    w0, V0 = je.jacobi_eigh_cuda(A[:0])
    assert w0.shape == (0, 16) and je.jacobi_eigh_cuda.launches == before


def test_kernel_rejects_too_large(cuda):
    with pytest.raises(ValueError):
        je.jacobi_eigh_cuda(torch.zeros((1, 130, 130), device=cuda))


def _slab_state(dev, batch=8):
    a = 3.59
    slab = fcc111_slab("Cu", a, size=(3, 4, 2))
    d = a / np.sqrt(2)
    top_z = slab.positions[:, 2].max()
    base = slab.positions[slab.positions[:, 2] > top_z - 0.1][0]
    ad = base + np.array(
        [d / 2 + 0.3, d / (2 * np.sqrt(3)) + 0.1, a / np.sqrt(3)]
    )
    pos0 = np.vstack([slab.positions, ad])
    rng = np.random.RandomState(0)
    x0 = np.stack([(pos0 + 0.02 * rng.normal(size=pos0.shape)).ravel()
                   for _ in range(batch)])
    return x0, np.asarray(slab.cell), len(pos0)


@pytest.mark.parametrize("prfo_eigh,rtol", [("jacobi", 1e-5),
                                            ("eigh", 1e-9)])
def test_ensemble_step_card_matches_cpu(cuda, prfo_eigh, rtol):
    """Three steps of the headline config on the CPU, then one more step
    from that state on each device. The jacobi route runs the kernel on
    the card and the plain version on the CPU (float32: 1e-5); the eigh
    route is float64 LAPACK vs cuSOLVER (1e-9)."""
    x0, cell, nat = _slab_state(cuda)
    cfg = T.EnsembleConfig(
        natoms=nat, order=1, nproj=3, fmax=1e-3, gamma=0.3,
        davidson_max=25, delta0=5e-3, diag_budget=1, eigh_f32=False,
        rs_maxiter=12, absb="ns", prfo_eigh=prfo_eigh,
    )
    pot = EMT(np.array([29] * nat), pbc=True)
    step = T.make_step_fn(pot, cfg, torch.as_tensor(cell))
    gen = torch.Generator().manual_seed(0)
    st = T.init_state(pot, torch.as_tensor(x0), cfg, cell)
    for _ in range(3):
        st = step(st, gen)
    out_cpu = step(st, gen)
    pot_g = EMT(np.array([29] * nat), pbc=True).to(cuda)
    st_g = T.SearchState(*(t.to(cuda) for t in st))
    before = je.jacobi_eigh_cuda.launches
    out_gpu = T.make_step_fn(pot_g, cfg, torch.as_tensor(cell, device=cuda))(
        st_g, torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert je.jacobi_eigh_cuda.launches - before == (
        1 if prfo_eigh == "jacobi" else 0)
    for f in ("converged", "B_init", "nsteps", "neval", "nmatvec",
              "nsteps_since_diag"):
        assert torch.equal(getattr(out_gpu, f).cpu(), getattr(out_cpu, f)), f
    for f in ("x", "f", "g", "B", "delta"):
        a, b = getattr(out_gpu, f).cpu(), getattr(out_cpu, f)
        assert float((a - b).abs().max() / b.abs().max()) < rtol, f


def _lj4_starts(total, seed=3, pert=0.1):
    tet = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                    [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * 1.12
    rng = np.random.RandomState(seed)
    return (tet[None] + pert * rng.normal(size=(total, 4, 3))).reshape(
        total, 12)


def _watched_fns(cfg, seen):
    """make_queue_fns whose snapshot records every state field's device."""
    from sella_tpu_torch.potentials import LennardJones

    step, refill, refresh, snapshot = T.make_queue_fns(
        LennardJones(), cfg, refill_every=5)

    def watched(state):
        seen.update(t.device.type for t in state)
        return snapshot(state)

    return step, refill, refresh, watched


@pytest.mark.parametrize("x0_kind", ["cuda_tensor", "numpy"])
def test_queue_keeps_state_on_the_card(cuda, x0_kind):
    """A CUDA ``x0_all`` keeps the queue on the card, and a numpy one goes
    to the GPU without being asked; the results match a CPU run of the
    same queue (qn, no Davidson: float64 LAPACK vs cuSOLVER only)."""
    from sella_tpu_torch.potentials import LennardJones

    cfg = T.EnsembleConfig(natoms=4, order=0, fmax=1e-3, eig=False,
                           method="qn", sigma_dec=0.9, rho_dec=100.0)
    x0 = _lj4_starts(6)
    seen = set()
    x0_all = torch.as_tensor(x0, device=cuda) if x0_kind == "cuda_tensor" \
        else x0
    res = T.run_ensemble_queue(LennardJones(), x0_all, cfg, batch=4,
                               max_steps_per_search=100, refill_every=5,
                               fns=_watched_fns(cfg, seen))
    assert seen == {"cuda"}
    ref = T.run_ensemble_queue(LennardJones(), x0, cfg, batch=4,
                               max_steps_per_search=100, refill_every=5,
                               device="cpu")
    assert [r[3] for r in res] == [r[3] for r in ref]
    for a, b in zip(res, ref):
        if a[3]:
            assert abs(a[1] - b[1]) < 1e-8


def test_checkpoint_saved_on_the_card_loads_to_the_card(cuda, tmp_path):
    import os

    from sella_tpu_torch.parallel import checkpoint as ckpt
    from sella_tpu_torch.potentials import LennardJones

    cfg = T.EnsembleConfig(natoms=4, order=1, fmax=1e-3)
    st = T.init_state(LennardJones(), torch.as_tensor(_lj4_starts(4),
                                                      device=cuda), cfg)
    st = T.make_step_fn(LennardJones(), cfg)(
        st, torch.Generator(device=cuda).manual_seed(0))
    path = os.path.join(tmp_path, "q.pt")
    gen = torch.Generator(device=cuda).manual_seed(3)
    ckpt.save_queue(path, st, np.arange(4), 4, {}, it=5,
                    rng_state=gen.get_state())
    back, origin, nxt, res, retry = ckpt.load_queue(path,
                                                    with_retry_state=True)
    for name, a, b in zip(st._fields, st, back):
        assert b.device == a.device and b.dtype == a.dtype, name
        assert torch.equal(a, b), name
    gen2 = torch.Generator(device=cuda)
    gen2.set_state(retry["rng_state"])
    assert torch.equal(torch.randn(8, generator=gen, device=cuda),
                       torch.randn(8, generator=gen2, device=cuda))


def test_f32_potential_on_the_card(cuda):
    """F32Potential moves with ``.to()``: on the card its energy, gradient
    and HVP are float64 at the interface, agree with the same float32
    evaluation on the CPU to float32 rounding, and with float64 EMT to
    the gates of tests/test_pot_f32.py."""
    from sella_tpu_torch.potentials import F32Potential, fcc_bulk

    atoms = fcc_bulk("Cu", 3.59, reps=(2, 2, 2))
    n = len(atoms.positions)
    rng = np.random.RandomState(0)
    x = torch.as_tensor((atoms.positions
                         + 0.05 * rng.normal(size=(n, 3))).ravel())
    v = torch.as_tensor(rng.normal(size=3 * n))
    cell = torch.as_tensor(atoms.cell)
    pot64 = EMT(np.array([29] * n), pbc=True)
    out = {}
    for dev in ("cpu", cuda):
        p32 = F32Potential(pot64).to(dev)
        xd, vd, cd = x.to(dev), v.to(dev), cell.to(dev)
        e, g = p32.energy_and_grad(xd, cd)
        h = p32.hvp(xd, vd, cd)
        assert e.dtype == g.dtype == h.dtype == torch.float64
        assert g.device.type == torch.device(dev).type
        out[str(dev)] = [t.cpu() for t in (e, g, h)]
    # moving the wrapper leaves the wrapped potential where it was
    assert pot64.E0.device.type == "cpu"
    cpu, card = out["cpu"], out[str(cuda)]
    e64, g64 = pot64.energy_and_grad(x, cell)
    h64 = pot64.hvp(x, v, cell)
    assert abs(float(card[0] - e64)) < 1e-5 * 15.0 * n
    assert float((card[1] - g64).abs().max()) < 5e-5
    assert float((card[2] - h64).norm()) < 2e-4 * max(float(h64.norm()), 1.0)
    for a, b in zip(card[1:], cpu[1:]):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-5


def test_cell_step_card_matches_cpu(cuda):
    """Two steps of the bench's atom+cell config (bulk Cu EMT, 32 atoms +
    9 cell DOF) on the CPU, then one more from that state on each device
    (float64 LAPACK vs cuSOLVER); a numpy x0 lands on the GPU."""
    import sella_tpu_torch.parallel.ensemble_cell as C
    from sella_tpu_torch.potentials import fcc_bulk

    atoms = fcc_bulk("Cu", 3.59 * 1.03, reps=(2, 2, 2))
    nat = len(atoms)
    rng = np.random.RandomState(0)
    x0 = np.stack([(atoms.positions
                    + 0.05 * rng.normal(size=atoms.positions.shape)).ravel()
                   for _ in range(4)])
    s0 = 0.02 * rng.normal(size=(4, 9))
    cfg = C.CellEnsembleConfig(natoms=nat, ncell=9, order=0, nproj=3,
                               fmax=1e-3, delta0=0.1, absb="ns")
    pot = EMT(np.array([29] * nat), pbc=True)
    step = C.make_cell_step_fn(pot, cfg)
    st = C.init_cell_state(pot, x0, cfg, np.asarray(atoms.cell), s0=s0,
                           device="cpu")
    for _ in range(2):
        st = step(st)
    out_cpu = step(st)
    st_g = C.CellSearchState(*(t.to(cuda) for t in st))
    out_gpu = C.make_cell_step_fn(pot.to(cuda), cfg)(st_g)
    torch.cuda.synchronize()
    for f in ("converged", "nsteps", "neval", "nmatvec"):
        assert torch.equal(getattr(out_gpu, f).cpu(), getattr(out_cpu, f)), f
    for f in ("z", "f", "g", "H", "delta"):
        a, b = getattr(out_gpu, f).cpu(), getattr(out_cpu, f)
        assert float((a - b).abs().max() / b.abs().max()) < 1e-9, f
    placed = C.init_cell_state(pot.to(cuda), x0, cfg,
                               np.asarray(atoms.cell), s0=s0)
    assert all(t.device.type == "cuda" for t in placed)


def _xe4_internal():
    from sella_tpu_torch import Atoms, Internals, MorsePotential
    from sella_tpu_torch.parallel.ensemble_internal import (
        InternalEnsembleConfig,
    )
    from sella_tpu_torch.utils.units import kB

    pos0 = np.random.RandomState(4).normal(size=(4, 3), scale=3.0)
    ints = Internals(Atoms(["Xe"] * 4, pos0))
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    x0 = (pos0[None] + 0.3 * np.random.RandomState(0).normal(
        size=(8, 4, 3))).reshape(8, 12)
    cfg = InternalEnsembleConfig(natoms=4, nint=ints.nint, order=1,
                                 fmax=1e-3, gamma=1e-3, newton_chord=True)
    pot = MorsePotential(epsilon=226.9 * kB, r0=4.73, rho0=4.73 * 1.099)
    return ints, x0, cfg, pot


@pytest.mark.parametrize("x0_kind", ["cuda_tensor", "numpy"])
def test_internal_state_stays_on_the_card(cuda, x0_kind):
    """A CUDA tensor keeps its device and a numpy ``x0`` lands on the
    GPU; every field of the internal state stays there through steps,
    and three steps on the card match the CPU within 1e-8."""
    from sella_tpu_torch.parallel import ensemble_internal as TE

    ints, x0, cfg, pot = _xe4_internal()
    x_in = torch.as_tensor(x0, device=cuda) if x0_kind == "cuda_tensor" \
        else x0
    st = TE.run_internal_ensemble(pot.to(cuda), ints, x_in, cfg,
                                  max_steps=3)
    assert all(getattr(st, k).device.type == "cuda" for k in st._fields)
    st_cpu = TE.run_internal_ensemble(pot.to("cpu"), ints, x0, cfg,
                                      max_steps=3, device="cpu")
    np.testing.assert_allclose(st.x.cpu().numpy(), st_cpu.x.numpy(),
                               atol=1e-8)
    np.testing.assert_array_equal(st.nmatvec.cpu().numpy(),
                                  st_cpu.nmatvec.numpy())


def test_robust_eigh_of_degenerate_gram_on_the_card(cuda):
    """``batched_eigh(.., "robust")`` on the card: the Gram matrices of
    the Xe4 internal Jacobian (a zero cluster of multiplicity 5) give
    finite eigenpairs, 5 eigenvalues below 1e-10 of the largest, and
    residual and orthonormality within 1e-12."""
    from sella_tpu_torch.ops.linalg import batched_eigh

    ints, x0, _, _ = _xe4_internal()
    B = ints._get_engine()._jac_impl(
        torch.as_tensor(x0, device=cuda).reshape(8, 4, 3),
        torch.zeros(3, 3, dtype=torch.float64, device=cuda))
    G = B @ B.transpose(1, 2)
    lams, V = batched_eigh(G, "robust")
    assert bool(torch.isfinite(lams).all() and torch.isfinite(V).all())
    scale = lams[:, -1:].abs()
    assert bool(((lams < 1e-10 * scale).sum(1) == 5).all())
    res = (G @ V - V * lams[:, None, :]).abs().amax((1, 2)) / scale[:, 0]
    assert float(res.max()) <= 1e-12
    eye = torch.eye(G.shape[1], dtype=G.dtype, device=cuda)
    assert float((V.transpose(1, 2) @ V - eye).abs().max()) <= 1e-12


def _slab_10():
    from sella_tpu_torch.potentials import fcc111_slab

    slab = fcc111_slab("Cu", 3.59, size=(8, 10, 4), vacuum=12.0)
    rng = np.random.RandomState(7)
    x = (slab.positions + 0.05 * rng.normal(size=slab.positions.shape)
         ).ravel()
    return x, np.asarray(slab.cell), rng.normal(size=x.shape)


@pytest.mark.parametrize("name", ["binned_lj", "chunked_lj", "binned_emt",
                                  "binned_emt_chunk", "mlff", "mlff_f32"])
def test_large_system_potentials_card_match_cpu(cuda, name):
    """Energy, gradient and HVP of each large-system potential on a
    rattled 320-atom Cu(111) slab: the card against the CPU, float64 to
    1e-10 relative, float32 to 1e-4; no bin overflows on the card."""
    from sella_tpu_torch.potentials import (BinnedEMT, BinnedPairPotential,
                                            ChunkedPairPotential,
                                            F32Potential, LennardJones,
                                            MLPotential)
    from sella_tpu_torch.potentials.mlff import WEIGHTS_CU_EMT

    x, cell, v = _slab_10()
    z = [29] * (x.size // 3)
    lj = LennardJones(sigma=2.3, epsilon=0.4, rc=5.5, pbc=True)
    pot = {
        "binned_lj": lambda: BinnedPairPotential(lj, rc=5.5, x0=x,
                                                 cell=cell, shift=False),
        "chunked_lj": lambda: ChunkedPairPotential(lj, chunk=100),
        "binned_emt": lambda: BinnedEMT(z, x, cell, capacity=32),
        "binned_emt_chunk": lambda: BinnedEMT(z, x, cell, capacity=32,
                                              chunk=100),
        "mlff": lambda: MLPotential(z, x, cell, rc=4.5, capacity=24,
                                    params=MLPotential.params_from_npz(
                                        WEIGHTS_CU_EMT)),
    }
    f32 = name == "mlff_f32"
    pot = pot["mlff" if f32 else name]()
    if f32:
        pot = F32Potential(pot)
    out = {}
    for dev in ("cpu", cuda):
        p = pot.to(dev)
        xd, cd, vd = (torch.as_tensor(a, device=dev) for a in (x, cell, v))
        e, g = p.energy_and_grad(xd, cd)
        out[str(dev)] = [t.cpu() for t in (e, g, p.hvp(xd, vd, cd))]
        bins = getattr(getattr(p, "_inner32", p), "_bins", None)
        if bins is not None:
            assert int(bins.overflow_count(xd.reshape(-1, 3), cd)) == 0
    tol = 1e-4 if f32 else 1e-10
    for a, b in zip(out[str(cuda)], out["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize("order", [0, 1])
def test_run_mmf_card_matches_cpu(cuda, order):
    """``run_mmf`` on the card: order 0 on the binned EMT slab, order 1
    (LJ7 from an injected mode) through ``drive_mmf``; every state field
    stays on the card, a numpy x0 lands there, and the run matches the
    CPU's counts with x within 1e-6 (the saddle search carries a
    last-bit difference to ~5e-7: a jitted JAX init against an eager
    one moves the JAX package's own run that far)."""
    import sella_tpu_torch.parallel.largescale as L
    from sella_tpu_torch.potentials import BinnedEMT, LennardJones

    if order == 0:
        x, cell, _ = _slab_10()
        pot = BinnedEMT([29] * (x.size // 3), x, cell, capacity=32)
        kw = dict(order=0, fmax=1e-2, max_steps=100, max_move=0.2)
        st = L.run_mmf(pot.to(cuda), x, cell=cell, **kw)
        ref = L.run_mmf(pot.to("cpu"), x, cell=cell, device="cpu", **kw)
    else:
        pos = np.array([
            [0.0, 0.0, 1.1], [0.0, 0.0, -1.1], [1.12, 0.0, 0.0],
            *[[1.12 * np.cos(2 * np.pi * k / 5),
               1.12 * np.sin(2 * np.pi * k / 5), 0] for k in range(1, 5)],
        ]) * 0.9
        x = (pos + 0.15 * np.random.RandomState(5).normal(size=pos.shape)
             ).ravel()
        v0 = np.random.RandomState(0).normal(size=21)
        v0 /= np.linalg.norm(v0)
        runs = []
        for dev in (cuda, "cpu"):
            step = L.make_mmf_step(LennardJones(), None, order=1)
            s0 = L.mmf_init(LennardJones(), x, device=dev)._replace(
                mode=torch.as_tensor(v0, device=dev))
            runs.append(L.drive_mmf(step, s0, max_steps=800))
        st, ref = runs
        assert float(st.lam) < 0
    assert bool(st.converged) and bool(ref.converged)
    assert all(t.device.type == "cuda" for t in [*st[:5], *st[6:], *st.mem])
    assert (int(st.nsteps), int(st.nmatvec)) == (int(ref.nsteps),
                                                 int(ref.nmatvec))
    np.testing.assert_allclose(st.x.cpu().numpy(), ref.x.numpy(), atol=1e-6)


def test_cell_internal_steps_card_match_cpu(cuda):
    """Three steps of the internal+cell tier on the LJ 2x2x2 bulk (two
    lanes, full cell mask) from a numpy x0 on the card and on the CPU:
    every field on the card, the same counts, x, s and f within 1e-9."""
    from sella_tpu_torch import Internals, LennardJones
    from sella_tpu_torch.parallel import ensemble_cell_internal as TC
    from sella_tpu_torch.potentials import fcc_bulk

    atoms = fcc_bulk("Cu", 1.55, reps=(2, 2, 2))
    ints = Internals(atoms)
    ints.find_all_bonds(scale=0.43)
    rng = np.random.RandomState(0)
    x0 = np.stack([(atoms.positions + 0.02 * rng.normal(
        size=atoms.positions.shape)).ravel() for _ in range(2)])
    s0 = 0.02 * rng.normal(size=(2, 9))
    cfg = TC.CellInternalEnsembleConfig(natoms=32, nint=ints.nint,
                                        fmax=5e-3, h0_cell=10.0)
    out = {}
    for dev in (None, "cpu"):
        pot = LennardJones(pbc=True)
        st = TC.init_cell_internal_state(pot, ints, x0, cfg, atoms.cell,
                                         s0=s0, device=dev)
        step = TC.make_cell_internal_step_fn(pot, ints, cfg)
        for _ in range(3):
            st = step(st)
        out[dev] = st
    card, cpu = out[None], out["cpu"]
    assert all(t.device.type == "cuda" for t in card)
    for k in ("nsteps", "neval", "converged", "qact", "qcons"):
        assert torch.equal(getattr(card, k).cpu(), getattr(cpu, k)), k
    for k in ("x", "s", "f"):
        np.testing.assert_allclose(getattr(card, k).cpu().numpy(),
                                   getattr(cpu, k).numpy(), rtol=0,
                                   atol=1e-9)


def test_irc_card_matches_cpu(cuda):
    """Forward and reverse IRC of the LJ4 transition states
    (``tools/irc_lj4_ts.npz``) on the card and on the CPU: the same
    steps, force calls and flags, endpoints within 1e-8."""
    import os

    from sella_tpu_torch import IRCEnsembleConfig, LennardJones, \
        run_irc_ensemble_queue

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = np.load(os.path.join(root, "tools", "irc_lj4_ts.npz"))
    x, H = d["x"][d["converged"]], d["H"][d["converged"]]
    cfg = IRCEnsembleConfig(natoms=4, fmax=1e-2, dx=0.4)
    masses = np.full(4, 39.948)
    card = run_irc_ensemble_queue(LennardJones(), x, H, cfg, masses, 4)
    cpu = run_irc_ensemble_queue(LennardJones(), x, H, cfg, masses, 4,
                                 device="cpu")
    for a, b in zip(card, cpu):
        for k in ("ts", "direction", "nsteps", "neval", "converged",
                  "inner_fail"):
            assert a[k] == b[k], k
        np.testing.assert_allclose(a["x"], b["x"], rtol=0, atol=1e-8)


def test_hetero_queue_launches_the_kernel(cuda):
    """A mixed LJ4/LJ7 campaign with ``prfo_eigh="jacobi"`` on the card:
    each bucket launches the Jacobi kernel (n = 6 and 15), the results
    come back in input order and converge to the clusters' minima."""
    from sella_tpu_torch import LennardJones, run_heterogeneous_queue

    tet = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                    [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * 1.12
    rstar = 2.0 ** (1.0 / 6.0)
    ring_r = rstar / (2.0 * np.sin(np.pi / 5.0))
    ang = 2.0 * np.pi * np.arange(5) / 5.0
    apex = np.sqrt(rstar ** 2 - ring_r ** 2)
    pbp = np.vstack([np.stack([ring_r * np.cos(ang), ring_r * np.sin(ang),
                               np.zeros(5)], axis=1),
                     [[0, 0, apex]], [[0, 0, -apex]]])
    rng = np.random.RandomState(0)
    jobs = []
    for _ in range(4):
        jobs.append((tet + 0.05 * rng.normal(size=(4, 3))).ravel())
        jobs.append((pbp + 0.05 * rng.normal(size=(7, 3))).ravel())
    je.jacobi_eigh_cuda.launches = 0
    res = run_heterogeneous_queue(LennardJones(), jobs, 4, order=0,
                                  fmax=1e-3, prfo_eigh="jacobi",
                                  max_steps_per_search=300)
    assert je.jacobi_eigh_cuda.launches > 0
    for r, x in zip(res, jobs):
        assert r[0].shape == x.shape and r[3]
        assert abs(r[1] - (-6.0 if x.size == 12 else -16.505384)) < 1e-4


@pytest.mark.parametrize("order", [0, 1])
def test_secular_graph_replay_equals_eager(cuda, order):
    """The restricted step's secular solve replays a cached CUDA graph on
    the card: the same numbers, bit for bit, as the same loop run eagerly
    on the card, on fresh inputs at every call (the graph's static
    buffers are refilled, not reused stale)."""
    rng = np.random.RandomState(order)
    Bsz, q = 64, 15
    T._SECULAR_GRAPHS.clear()
    for call in range(3):
        A = torch.as_tensor(_rand_sym(Bsz, q, 10 * order + call), device=cuda)
        g = torch.as_tensor(rng.normal(size=(Bsz, q)), device=cuda)
        alpha = torch.as_tensor(rng.uniform(0.1, 1.0, Bsz), device=cuda)
        prep = T.prfo_prepare_batched(g, A, order)
        s, ds = T.prfo_step_batched(prep, order, alpha)
        graphs = dict(T._SECULAR_GRAPHS)
        T._SECULAR_GRAPHS.clear()
        newton = T._secular_newton_graphed
        T._secular_newton_graphed = T._secular_newton
        try:
            s_e, ds_e = T.prfo_step_batched(prep, order, alpha)
        finally:
            T._secular_newton_graphed = newton
        T._SECULAR_GRAPHS.update(graphs)
        assert len(graphs) == 1
        assert torch.equal(s, s_e) and torch.equal(ds, ds_e)
