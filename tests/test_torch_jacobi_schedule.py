"""CPU tests of what surrounds the CUDA Jacobi kernel and of the entry
points' device rule: the kernel's pair schedule against the plain
version's interleaved layout, its operation and byte counts, the
wrapper's input checks, and where ``run_ensemble`` / ``init_state`` place
a search. None of them needs a GPU; the kernel itself is tested in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import sella_tpu_torch as st
from sella_tpu_torch.ops import jacobi_eigh as je
from sella_tpu_torch.ops.linalg import _interleave_perm
from sella_tpu_torch.parallel import ensemble as T

torch.set_num_threads(2)


@pytest.mark.parametrize("m", [2, 4, 10, 72, 128])
def test_pair_schedule_matches_plain_layout(m):
    """Round by round through one sweep: the kernel's pairs are the plain
    version's adjacent positions (2i, 2i + 1) read back in original
    labels, in the same order and orientation; each round is a perfect
    matching; every pair meets exactly once; the next sweep starts over."""
    idx0, perm = _interleave_perm(m)
    layout = idx0.copy()
    met = set()
    for r in range(m - 1):
        pairs = je.pair_schedule(m, r)
        assert pairs == [(int(layout[2 * i]), int(layout[2 * i + 1]))
                         for i in range(m // 2)]
        assert sorted(x for pq in pairs for x in pq) == list(range(m))
        for pq in pairs:
            assert frozenset(pq) not in met
            met.add(frozenset(pq))
        layout = layout[perm]
    assert len(met) == m * (m - 1) // 2
    np.testing.assert_array_equal(layout, idx0)
    assert je.pair_schedule(m, m - 1) == je.pair_schedule(m, 0)


@pytest.mark.parametrize("m", [0, 1, 7])
def test_pair_schedule_rejects_odd_or_empty(m):
    with pytest.raises(ValueError):
        je.pair_schedule(m, 0)


def test_kernel_work_at_the_main_shape():
    """(1024, 72, 72), 8 sweeps: 568 rounds of 36 x 36 blocks x 24 flop
    plus 72 x 36 pairs x 6 flop = 46,656 flop a round and matrix."""
    flop, b_in, b_out = je.kernel_work(1024, 72, 8)
    assert flop == 1024 * 568 * 46656 == 27_136_622_592
    assert b_in == 1024 * 72 * 72 * 4 == 21_233_664
    assert b_out == 1024 * (72 * 72 + 72) * 4 == 21_528_576
    # float32 peak outside the tensor cores binds, not the memory rate
    assert abs(flop / 67e12 * 1e3 - 0.405) < 5e-4
    assert (b_in + b_out) / 3.35e12 * 1e3 < 0.013


@pytest.mark.parametrize("n,itemsize", [(71, 4), (72, 8), (1, 4)])
def test_kernel_work_pads_odd_n_and_scales_bytes(n, itemsize):
    m = n + n % 2
    flop, b_in, b_out = je.kernel_work(3, n, 8, itemsize)
    assert flop == 3 * 8 * (m - 1) * ((m // 2) ** 2 * 24 + m * (m // 2) * 6)
    assert b_in == 3 * n * n * itemsize
    assert b_out == 3 * (n * n + n) * itemsize


class _OnCuda:
    """Tensor stand-in that reports a CUDA device, so the wrapper's checks
    can be exercised without a GPU."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("case", ["f64_contiguous", "f32_contiguous",
                                  "transposed", "sliced", "expanded",
                                  "empty_batch"])
def test_wrapper_accepts_strided_float_input(case):
    """The kernel reads through strides and converts itself: float32 and
    float64 of any layout pass the checks."""
    A = torch.zeros((3, 9, 9), dtype=torch.float64)
    if case == "f32_contiguous":
        A = A.float()
    elif case == "transposed":
        A = A.transpose(1, 2)
    elif case == "sliced":
        A = torch.zeros((3, 12, 20))[:, 2:11, ::2][:, :, :9]
    elif case == "expanded":
        A = torch.zeros((9, 9)).expand(3, 9, 9)
    elif case == "empty_batch":
        A = A[:0]
    if case in ("transposed", "sliced", "expanded"):
        assert not A.is_contiguous()
    assert je._check_input(_OnCuda(A)) == (A.shape[0], 9)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.complex64, torch.int64])
def test_wrapper_rejects_other_dtypes(dtype):
    """Half types are floating but the kernel has no instantiation for
    them; they are refused, not cast behind the caller's back."""
    with pytest.raises(TypeError):
        je._check_input(_OnCuda(torch.zeros((2, 4, 4), dtype=dtype)))
    assert je.jacobi_eigh_cuda.launches == 0


def test_plain_version_takes_strided_float64_view():
    """What the step hands the wrapper (a non-contiguous float64 view)
    gives the same result as its contiguous copy on the CPU path."""
    rng = np.random.RandomState(0)
    big = rng.normal(size=(4, 14, 12))
    big = torch.as_tensor(big)
    view = (big[:, 2:, :] + big[:, 2:, :].transpose(1, 2)).transpose(1, 2)
    assert not view.is_contiguous()
    w, V = je.jacobi_eigh(view)
    w_c, V_c = je.jacobi_eigh(view.contiguous())
    assert torch.equal(w, w_c) and torch.equal(V, V_c)
    assert w.dtype == torch.float64


def _lj4(lanes=3):
    base = np.array([[0, 0, 0], [1.1, 0, 0], [0.55, 0.95, 0],
                     [0.55, 0.32, 0.9]], float)
    rng = np.random.RandomState(0)
    return np.stack([(base + 0.05 * rng.normal(size=base.shape)).ravel()
                     for _ in range(lanes)])


def test_numpy_x0_with_device_cpu_matches_tensor_call():
    x0 = _lj4()
    cfg = st.EnsembleConfig(natoms=4, order=0, fmax=1e-3)
    a = st.run_ensemble(st.LennardJones(), x0, cfg, max_steps=5,
                        device="cpu")
    b = st.run_ensemble(st.LennardJones(), torch.as_tensor(x0), cfg,
                        max_steps=5)
    assert a.x.device.type == "cpu"
    for name, ta, tb in zip(a._fields, a, b):
        assert torch.equal(torch.nan_to_num(ta.double()),
                           torch.nan_to_num(tb.double())), name
    s = st.init_state(st.LennardJones(), x0.tolist(), cfg, device="cpu")
    assert s.x.device.type == "cpu" and s.x.dtype == torch.float64


@pytest.mark.parametrize("entry", ["run_ensemble", "init_state"])
def test_numpy_x0_without_device_needs_a_gpu(entry, monkeypatch):
    """No device given and no tensor: the GPU or an error, never a silent
    CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = st.EnsembleConfig(natoms=4, order=0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(st, entry)(st.LennardJones(), _lj4(), cfg)


def test_state_from_numpy_follows_the_device_rule(monkeypatch):
    """Carrying a state over from numpy lands on the GPU by default, the
    CPU only when asked, and raises without a GPU."""
    from sella_tpu_torch.interop import state_from_numpy, state_to_numpy

    s = st.init_state(st.LennardJones(), torch.as_tensor(_lj4()),
                      st.EnsembleConfig(natoms=4, order=0))
    fields = state_to_numpy(s)
    back = state_from_numpy(fields, device="cpu")
    assert all(t.device.type == "cpu" for t in back)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        state_from_numpy(fields)


def test_tensor_x0_keeps_its_device_without_asking(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = st.init_state(st.LennardJones(), torch.as_tensor(_lj4()),
                      st.EnsembleConfig(natoms=4, order=0))
    assert s.x.device.type == "cpu"


def test_potential_on_another_device_raises():
    """An EMT potential whose buffers sit on another device than the state
    is refused at the entry point, not deep inside vmap."""
    pot = st.EMT(np.array([29] * 4), pbc=False)
    T._check_potential_device(pot, torch.device("cpu"))
    with pytest.raises(ValueError, match="potential lives on"):
        T._check_potential_device(pot, torch.device("cuda", 0))
    pot_meta = st.EMT(np.array([29] * 4), pbc=False).to("meta")
    cfg = st.EnsembleConfig(natoms=4, order=0)
    with pytest.raises(ValueError, match="potential lives on"):
        st.init_state(pot_meta, torch.as_tensor(_lj4()), cfg)
    with pytest.raises(ValueError, match="potential lives on"):
        st.run_ensemble(pot_meta, _lj4(), cfg, device="cpu")
    # a potential without buffers or parameters runs anywhere
    T._check_potential_device(st.LennardJones(), torch.device("cuda", 0))
