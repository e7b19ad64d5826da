"""Timing of a whole call on the host clock (port of
`dart_tpu.utils.timing.timed_call`)."""

from __future__ import annotations

import time
from typing import Callable

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
