"""GPU tests of the port: the CUDA Jacobi kernel against its plain
version, and one ensemble step on the card against the same step on the
CPU. They skip without a CUDA device.

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


@pytest.mark.parametrize("B,n", [(64, 72), (8, 20), (4, 9), (3, 127),
                                 (2, 128), (5, 1)])
def test_kernel_matches_plain_and_eigvalsh(cuda, B, n):
    """n = 127 and 128 need more than 48 KB of shared memory."""
    A = torch.as_tensor(_rand_sym(B, n, n), device=cuda)
    before = je.jacobi_eigh_cuda.launches
    w, V = je.jacobi_eigh(A)
    torch.cuda.synchronize()
    assert je.jacobi_eigh_cuda.launches == before + 1
    assert w.dtype == V.dtype == A.dtype and V.shape == A.shape
    w_p, _ = je.jacobi_eigh_ref(A)
    w_ref = torch.linalg.eigvalsh(A)
    scale = float(w_ref.abs().max())
    assert float((w - w_ref).abs().max()) / scale < EIG_RTOL
    assert float((w - w_p).abs().max()) / scale < EIG_RTOL
    res = torch.linalg.norm(A @ V - V * w[:, None, :], dim=(1, 2))
    assert float((res / torch.linalg.norm(A, dim=(1, 2))).max()) < RES_TOL
    eye = torch.eye(n, dtype=A.dtype, device=cuda)
    assert float((V.transpose(1, 2) @ V - eye).abs().max()) < RES_TOL


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
