"""Metrics and profiling for the batched ensemble.

Counterpart of ``sella_tpu/parallel/metrics.py``: the per-search counters
live in the ``SearchState`` (``neval``, ``nmatvec``, ``nsteps``); this
module aggregates them, times wall-clock throughput, and wraps
``torch.profiler`` for trace capture.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class EnsembleMetrics:
    """Aggregated view of a SearchState's counters."""

    n_total: int
    n_converged: int
    steps_mean: float
    steps_max: int
    neval_total: int
    nmatvec_total: int
    wall_s: Optional[float] = None

    @property
    def searches_per_sec(self) -> Optional[float]:
        if not self.wall_s:
            return None
        return self.n_converged / self.wall_s

    def as_dict(self) -> dict:
        out = {
            "n_total": self.n_total,
            "n_converged": self.n_converged,
            "steps_mean": round(self.steps_mean, 2),
            "steps_max": self.steps_max,
            "neval_total": self.neval_total,
            "nmatvec_total": self.nmatvec_total,
        }
        if self.wall_s is not None:
            out["wall_s"] = round(self.wall_s, 3)
            out["searches_per_sec"] = round(self.searches_per_sec, 3)
        return out


def summarize(state, wall_s: Optional[float] = None) -> EnsembleMetrics:
    """Aggregate a state's counters (one device-to-host copy)."""
    conv, nsteps, neval, nmatvec = (
        t.cpu().numpy() for t in torch.stack([
            state.converged.long(), state.nsteps.long(),
            state.neval.long(), state.nmatvec.long()]))
    return EnsembleMetrics(
        n_total=int(conv.size),
        n_converged=int(conv.sum()),
        steps_mean=float(nsteps.mean()),
        steps_max=int(nsteps.max()),
        neval_total=int(neval.sum()),
        nmatvec_total=int(nmatvec.sum()),
        wall_s=wall_s,
    )


class Timer:
    """Wall-clock timer; ``stop(*tensors)`` first waits for the devices
    of the tensors it is given, so queued device work is timed."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0

    def stop(self, *tensors) -> float:
        for dev in {t.device for t in tensors if t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self.t0
        return self.elapsed


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block, with CUDA activity
    where a CUDA device is present, and write it to
    ``logdir/trace.json`` (view in Perfetto or chrome://tracing). Yields
    the profiler, whose ``key_averages()`` sum the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
