"""The port's checkpoint/resume (``sella_tpu_torch.parallel.checkpoint``):
``torch.save`` payloads of tensors only, loaded with
``torch.load(weights_only=True)``, with the JAX package's contracts: the
``fmax_t`` default for payloads that predate it, ``KeyError`` for any
other missing field, absent keys for empty result and retry sets, the
``-1`` counter sentinel, and a queue that resumes mid-run to the same
results. The round-trip state is a JAX state carried over through numpy.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sella_tpu.parallel.ensemble as J
import sella_tpu_torch.parallel.checkpoint as ckpt
import sella_tpu_torch.parallel.ensemble as T
from sella_tpu.potentials import LennardJones as JLJ
from sella_tpu_torch.interop import state_from_numpy
from sella_tpu_torch.potentials import LennardJones as TLJ

torch.set_num_threads(1)

QN = dict(natoms=4, order=0, fmax=1e-3, gamma=1e-3, eig=False,
          method="qn", sigma_dec=0.90, rho_dec=100.0)


def _x0_batch(total, seed=3, pert=0.1):
    tet = np.array(
        [[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
         [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]
    ) * 1.12
    rng = np.random.RandomState(seed)
    return (tet[None] + pert * rng.normal(size=(total, 4, 3))).reshape(
        total, 12)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX init_state of 4 LJ4 lanes, as numpy fields."""
    js = J.init_state(JLJ(), jnp.asarray(_x0_batch(4)),
                      J.EnsembleConfig(natoms=4, order=1, fmax=1e-3))
    return {f: np.asarray(getattr(js, f)) for f in J.SearchState._fields}


def _same_state(a, b):
    for f in T.SearchState._fields:
        ta, tb = getattr(a, f), getattr(b, f)
        assert ta.dtype == tb.dtype and ta.device == tb.device, f
        assert torch.equal(ta, tb), f


def test_state_round_trip_and_resumed_step(tmp_path, jax_state):
    cfg = T.EnsembleConfig(natoms=4, order=1, fmax=1e-3)
    state = state_from_numpy(jax_state, device="cpu")
    step = T.make_step_fn(TLJ(), cfg)
    state = step(state, torch.Generator().manual_seed(0))
    path = os.path.join(tmp_path, "ckpt.pt")
    ckpt.save_state(path, state, step=1)
    restored, nstep = ckpt.load_state(path, device="cpu")
    assert nstep == 1
    _same_state(state, restored)
    for f, a in jax_state.items():
        assert getattr(restored, f).numpy().dtype == a.dtype, f
    s1 = step(state, torch.Generator().manual_seed(1))
    s2 = step(restored, torch.Generator().manual_seed(1))
    assert torch.equal(s1.x, s2.x)
    # nothing but the checkpoint itself is left behind
    assert os.listdir(tmp_path) == ["ckpt.pt"]


def test_payload_loads_under_weights_only(tmp_path, jax_state):
    state = state_from_numpy(jax_state, device="cpu")
    path = os.path.join(tmp_path, "q.pt")
    results = {0: (np.ones(12), -1.5, 7, True, 3, 8)}
    ckpt.save_queue(path, state, np.array([0, 1, -1, 3]), 5, results,
                    retry_state=dict(pending=[(2, np.zeros(12))],
                                     retries={2: 1}, spent={2: (4, 5, 6)}),
                    it=20, rng_state=torch.Generator().get_state())
    payload = torch.load(path, weights_only=True)
    assert all(isinstance(v, torch.Tensor) for v in payload.values())
    st, origin, nxt, res, retry = ckpt.load_queue(
        path, with_retry_state=True, device="cpu")
    _same_state(state, st)
    assert origin.tolist() == [0, 1, -1, 3] and nxt == 5
    np.testing.assert_array_equal(res[0][0], np.ones(12))
    assert res[0][1:] == (-1.5, 7, True, 3, 8)
    assert retry["retries"] == {2: 1} and retry["spent"] == {2: (4, 5, 6)}
    assert retry["pending"][0][0] == 2 and retry["it"] == 20
    assert torch.equal(retry["rng_state"], torch.Generator().get_state())


def test_pre_fmax_t_payload_gets_the_default(tmp_path, jax_state):
    state = state_from_numpy(jax_state, device="cpu")
    path = os.path.join(tmp_path, "old.pt")
    torch.save({k: v for k, v in state._asdict().items() if k != "fmax_t"},
               path)
    restored, nstep = ckpt.load_state(path, fmax_default=0.02, device="cpu")
    assert nstep is None
    assert restored.fmax_t.dtype == torch.float64
    assert float(restored.fmax_t) == 0.02
    assert torch.equal(restored.x, state.x)


def test_other_missing_field_raises(tmp_path, jax_state):
    state = state_from_numpy(jax_state, device="cpu")
    path = os.path.join(tmp_path, "bad.pt")
    torch.save({k: v for k, v in state._asdict().items() if k != "rho"},
               path)
    with pytest.raises(KeyError, match="rho"):
        ckpt.load_state(path, device="cpu")


def test_empty_sets_and_counter_sentinel_round_trip(tmp_path, jax_state):
    state = state_from_numpy(jax_state, device="cpu")
    path = os.path.join(tmp_path, "empty.pt")
    ckpt.save_queue(path, state, np.arange(4), 4, {},
                    retry_state=dict(pending=[], retries={}, spent={}))
    keys = set(torch.load(path, weights_only=True))
    assert not keys & {"_res_idx", "_pend_idx", "_retry_idx", "_it", "_rng"}
    _, _, _, res, retry = ckpt.load_queue(path, with_retry_state=True,
                                          device="cpu")
    assert res == {}
    assert retry == {"pending": [], "retries": {}, "spent": {}, "it": 0,
                     "rng_state": None}
    # a result saved without counters comes back as a 4-tuple
    ckpt.save_queue(path, state, np.arange(4), 4,
                    {3: (np.zeros(12), 0.5, 9, False)})
    _, _, _, res = ckpt.load_queue(path, device="cpu")
    assert res[3][1:] == (0.5, 9, False)


def test_load_needs_a_device_or_a_gpu(tmp_path, jax_state, monkeypatch):
    path = os.path.join(tmp_path, "s.pt")
    ckpt.save_state(path, state_from_numpy(jax_state, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (ckpt.load_state, ckpt.load_queue):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            load(path)


def test_queue_resume_from_checkpoint(tmp_path, monkeypatch):
    """The first harvest cycle's checkpoint (genuinely mid-run) resumes
    to the complete result set of the uninterrupted run, counters
    included (``tests/test_queue_checkpoint.py``'s resume test)."""
    total, batch = 10, 3
    path = os.path.join(tmp_path, "queue.pt")
    side = os.path.join(tmp_path, "queue_first.pt")
    orig_save = ckpt.save_queue

    def capture(p, state, origin, next_idx, results, **kw):
        orig_save(p, state, origin, next_idx, results, **kw)
        if not os.path.exists(side):
            shutil.copy(p, side)

    monkeypatch.setattr(ckpt, "save_queue", capture)
    args = dict(batch=batch, max_steps_per_search=150, refill_every=20,
                checkpoint_every=1, device="cpu")
    full = T.run_ensemble_queue(TLJ(), _x0_batch(total),
                                T.EnsembleConfig(**QN),
                                checkpoint_path=path, **args)
    monkeypatch.setattr(ckpt, "save_queue", orig_save)
    assert len(full) == total and os.path.exists(side)
    _, _, _, partial, retry = ckpt.load_queue(side, with_retry_state=True,
                                              device="cpu")
    assert 0 < len(partial) < total
    assert retry["it"] == 20 and retry["rng_state"] is not None
    resumed = T.run_ensemble_queue(TLJ(), _x0_batch(total),
                                   T.EnsembleConfig(**QN),
                                   checkpoint_path=side, resume=True, **args)
    assert len(resumed) == total
    for (x1, f1, n1, c1, *_), (x2, f2, n2, c2, *_) in zip(full, resumed):
        assert c1 == c2
        if c1:
            assert abs(f1 - f2) <= 1e-8
    assert all(len(r) == 6 for r in resumed)
    for i in partial:
        assert resumed[i][4:] == partial[i][4:]
