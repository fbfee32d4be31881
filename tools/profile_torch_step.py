#!/usr/bin/env python3
"""Per-layer breakdown of the port's headline ensemble step on one GPU.

Runs the 1024-lane headline config of ``chip_smoke.py`` for a few steps
with each route (``prfo_eigh="jacobi"`` and ``"eigh"``). Every call into
a layer of the step (free basis, Davidson, prep eigh, trust-region step,
quasi-Newton update, potential evaluation) is timed on the host with a
``torch.cuda.synchronize()`` on both sides, so the per-layer times come
from an instrumented run, not from the timed smoke run. One extra jacobi
step is traced with ``torch.profiler`` (CUDA activity only) for the
device busy share and the largest device kernels.

    python3 tools/profile_torch_step.py [--steps 8]
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import sella_tpu_torch.parallel.ensemble as T  # noqa: E402

LAYERS = ("free_basis", "_davidson_and_absorb", "prfo_prepare_batched",
          "restricted_step_batched", "quasi_newton_update_batched")


class Spans:
    """Host-timed, synchronised spans around the outermost layer calls."""

    def __init__(self):
        self.acc = {}
        self._depth = 0
        self._orig = {n: getattr(T, n) for n in LAYERS + ("_batched_eval",)}

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def timed(*a, **k):
            if self._depth:
                return fn(*a, **k)
            self._depth += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                self.acc[name] = self.acc.get(name, 0.0) + \
                    time.perf_counter() - t
                self._depth -= 1
        return timed

    def install(self):
        for n in LAYERS:
            setattr(T, n, self._wrap(n, self._orig[n]))
        orig_eval = self._orig["_batched_eval"]
        T._batched_eval = lambda *a, **k: self._wrap("eval",
                                                     orig_eval(*a, **k))

    def remove(self):
        for n, fn in self._orig.items():
            setattr(T, n, fn)


def device_trace(step, state, gen):
    """One unsynchronised step under the profiler; prints busy share and
    the largest device kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state = step(state, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kern) / 1e6
    print(f"traced step: wall {wall:.4f} s, {len(kern)} device kernels, "
          f"kernel time {busy:.4f} s, busy share {busy / wall:.4f}")
    by = {}
    for e in kern:
        c, ms = by.get(e.name, (0, 0.0))
        by[e.name] = (c + 1, ms + e.device_time_total / 1e3)
    for name, (c, ms) in sorted(by.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {ms:9.3f} ms {c:6d}x  {name[:90]}")
    return state


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_env()
    dev = torch.device("cuda", 0)
    spans = Spans()
    for prfo in ("jacobi", "eigh"):
        pot, x0, cell, nat = cs.headline_setup(1024)
        cfg = cs.headline_config(nat, 1024, prfo)
        pot = pot.to(dev)
        cell_t = torch.as_tensor(cell, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = T.init_state(pot, torch.as_tensor(x0, device=dev), cfg,
                             cell_t)
        spans.install()
        step = T.make_step_fn(pot, cfg, cell_t)
        for i in range(args.steps):
            spans.acc.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state = step(state, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            print(f"{prfo} step {i}: wall {wall:.4f} s; " + ", ".join(
                f"{k} {v:.4f}" for k, v in spans.acc.items()), flush=True)
        spans.remove()
        if prfo == "jacobi":
            state = device_trace(T.make_step_fn(pot, cfg, cell_t), state,
                                 gen)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          " GiB")


if __name__ == "__main__":
    main()
