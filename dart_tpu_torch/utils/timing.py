"""Timing and tracing (port of `dart_tpu.utils.timing`): `timed_call` and
`Stopwatch` on the host clock, and `trace(logdir)`, a torch.profiler
trace of the host and the card written as a Chrome trace into `logdir`."""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch


def _sync() -> None:
    """Wait for the card's queued work, where the process uses a card."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_call(fn: Callable, *args, reps: int = 3):
    """Returns (result, first_call_seconds, steady_seconds_per_call): one
    warm call, then `reps` calls, the card synchronised around each. The
    first call carries the one-time costs (the kernels' build and load)."""
    _sync()
    t0 = time.perf_counter()
    out = fn(*args)
    _sync()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        _sync()
    return out, first_s, (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (the host, and the card where
    CUDA is available) and write its Chrome trace to
    `logdir/trace.json` (open it in chrome://tracing or Perfetto). The
    profile object is yielded for in-process reads
    (`key_averages()`)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _sync()
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Stopwatch:
    """Wall-clock stage timers with mean/p50/p99 summaries (port of
    `dart_tpu.utils.timing.Stopwatch`); the card is synchronised at the
    end of each measured stage."""

    def __init__(self):
        self.samples: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def measure(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.samples.setdefault(stage, []).append(
                time.perf_counter() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for stage, xs in self.samples.items():
            a = np.asarray(xs)
            out[stage] = {
                "n": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p99_ms": float(np.percentile(a, 99) * 1e3),
                "total_s": float(a.sum()),
            }
        return out
