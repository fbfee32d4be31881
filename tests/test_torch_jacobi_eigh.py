"""The port's batched Jacobi eigh (sella_tpu_torch.ops.jacobi_eigh) against
the JAX package's plain Jacobi and its Pallas kernel in interpret mode.

The same numpy-seeded symmetric matrices go through both packages on the
CPU. Both sides compute in float32, in the same rotation order, so their
eigenvalues agree far below the float32 eigh accuracy class; the gate is
1e-5 of the spectral radius. The CUDA kernel itself runs only on a GPU:
its test here skips without one, and its jax-free tests are in
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sella_tpu.ops.linalg import _interleave_perm as jax_interleave_perm
from sella_tpu.ops.linalg import jacobi_eigh as jax_jacobi_eigh
from sella_tpu_torch.ops import jacobi_eigh as je
from sella_tpu_torch.ops.linalg import _interleave_perm

torch.set_num_threads(2)

# eigenvalues, port vs JAX, relative to the spectral radius: both sides
# run the same float32 rotations, so only float32 rounding differs
PARITY_RTOL = 1e-5
# accuracy gates of tests/test_pallas_eigh.py (float32 Jacobi vs float64)
EIG_RTOL = 5e-5
RES_TOL = 5e-4


def _rand_sym(B, n, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.normal(size=(B, n, n))
    return A + np.swapaxes(A, 1, 2)


def _spread_spectrum(seed=0, d=75, neg=5):
    """Eigenvalues spanning 1e-4..30, mixed sign (a quasi-Newton
    Hessian's conditioning), as in tests/test_pallas_eigh.py."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    lam = np.concatenate([
        -(10.0 ** rng.uniform(-4, 1.5, neg)),
        10.0 ** rng.uniform(-4, 1.5, d - neg),
    ])
    return (Q * lam) @ Q.T


def _check_accuracy(A, w, V):
    w_ref = np.linalg.eigvalsh(A)
    assert np.abs(w - w_ref).max() / np.abs(w_ref).max() < EIG_RTOL
    res = np.linalg.norm(A @ V - V * w[:, None, :], axis=(1, 2))
    assert (res / np.linalg.norm(A, axis=(1, 2))).max() < RES_TOL
    n = A.shape[-1]
    assert np.abs(np.swapaxes(V, 1, 2) @ V - np.eye(n)).max() < RES_TOL


@pytest.mark.parametrize("n", [2, 6, 20, 72])
def test_interleave_perm_matches_jax(n):
    idx0, perm = _interleave_perm(n)
    jidx0, jperm = jax_interleave_perm(n)
    np.testing.assert_array_equal(idx0, jidx0)
    np.testing.assert_array_equal(perm, jperm)


@pytest.mark.parametrize("n", [6, 20, 71, 72])
def test_plain_matches_jax_jacobi(n):
    A = _rand_sym(8, n, seed=1)
    w_j, _ = jax.jit(jax_jacobi_eigh)(jnp.asarray(A))
    w, V = je.jacobi_eigh_ref(torch.as_tensor(A))
    w, V = w.numpy(), V.numpy()
    assert w.dtype == np.float64 and V.dtype == np.float64
    w_j = np.asarray(w_j)
    assert np.abs(w - w_j).max() / np.abs(w_j).max() < PARITY_RTOL
    _check_accuracy(A, w, V)


@pytest.mark.parametrize("shape,seed", [((10, 20), 2), ((4, 9), 3)])
def test_plain_matches_pallas_interpret(shape, seed):
    """Against the Pallas kernel run as tests/test_pallas_eigh.py runs it
    (interpret mode, tile=2), including the odd-n pad path."""
    from sella_tpu.ops.pallas_eigh import jacobi_eigh_tpu

    B, n = shape
    A = _rand_sym(B, n, seed=seed)
    w_p, _ = jacobi_eigh_tpu(jnp.asarray(A), tile=2, interpret=True)
    w, V = je.jacobi_eigh_ref(torch.as_tensor(A))
    w_p = np.asarray(w_p)
    assert np.abs(w.numpy() - w_p).max() / np.abs(w_p).max() < PARITY_RTOL
    _check_accuracy(A, w.numpy(), V.numpy())


def test_hard_spectrum_negative_count():
    A = np.stack([_spread_spectrum(s, d=72, neg=3) for s in range(3)])
    w, V = je.jacobi_eigh_ref(torch.as_tensor(A))
    w_j, _ = jax.jit(jax_jacobi_eigh)(jnp.asarray(A))
    w = w.numpy()
    assert np.abs(w - np.asarray(w_j)).max() / np.abs(w).max() < PARITY_RTOL
    _check_accuracy(A, w, V.numpy())
    # the saddle-order decision (count of negatives) must be exact
    assert (np.sum(w < 0, axis=1) == 3).all()


def test_wrapper_takes_plain_path_on_cpu():
    A = torch.as_tensor(_rand_sym(4, 12, seed=5))
    before = je.jacobi_eigh_cuda.launches
    w, V = je.jacobi_eigh(A)
    w_r, V_r = je.jacobi_eigh_ref(A)
    assert torch.equal(w, w_r) and torch.equal(V, V_r)
    assert w.dtype == A.dtype and V.shape == A.shape
    assert je.jacobi_eigh_cuda.launches == before == 0


@pytest.mark.parametrize("bad", ["cpu", "int", "2d", "nonsquare", "big",
                                 "half"])
def test_kernel_wrapper_rejects_bad_input(bad):
    """The CUDA wrapper validates before building or launching; a CPU
    tensor is refused rather than silently sent to the plain path. The
    kernel reads float32 and float64 through any strides (accepted layouts
    are in tests/test_torch_jacobi_schedule.py); a half type is refused."""
    A = torch.zeros((2, 4, 4), dtype=torch.float64)
    if bad == "int":
        A = A.to(torch.int32)
    elif bad == "2d":
        A = A[0]
    elif bad == "nonsquare":
        A = torch.zeros((2, 4, 5))
    elif bad == "big":
        A = torch.zeros((1, je.MAX_N + 2, je.MAX_N + 2))
    elif bad == "half":
        A = A.to(torch.float16)
    if bad != "cpu":
        # every other check must fire before the device check would
        A = _FakeCuda(A)
    with pytest.raises((ValueError, TypeError)):
        je.jacobi_eigh_cuda(A)
    assert je.jacobi_eigh_cuda.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seed", [((10, 20), 2), ((4, 9), 3),
                                        ((8, 72), 1)])
def test_kernel_matches_jax_jacobi(shape, seed):
    """The CUDA kernel against the JAX package's plain Jacobi on the same
    inputs (needs a card and jax in one process; the kernel-only GPU
    tests, which need no jax, are in tests/test_torch_cuda.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    B, n = shape
    A = _rand_sym(B, n, seed=seed)
    before = je.jacobi_eigh_cuda.launches
    w, V = je.jacobi_eigh(torch.as_tensor(A, device="cuda"))
    torch.cuda.synchronize()
    assert je.jacobi_eigh_cuda.launches == before + 1
    w, V = w.cpu().numpy(), V.cpu().numpy()
    w_j = np.asarray(jax.jit(jax_jacobi_eigh)(jnp.asarray(A))[0])
    assert np.abs(w - w_j).max() / np.abs(w_j).max() < PARITY_RTOL
    _check_accuracy(A, w, V)


class _FakeCuda:
    """Tensor stand-in that reports a CUDA device, so the wrapper's shape,
    dtype and layout checks can be exercised without a GPU."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)
