"""Experiment metrics, as the reference defines them
(`PMPC/src/logger.py:154-176`; port of `dart_tpu.rollout.metrics`):

- steady-state error: final position error ||p_T - p*||;
- convergence time: first time the error crosses below tolerance (1 cm);
- control effort: sum ||u_k|| * dt.

Time runs along the leading axis; any lane axes follow it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Metrics(NamedTuple):
    steady_state_error: torch.Tensor
    convergence_time: torch.Tensor   # seconds; inf if never converged
    control_effort: torch.Tensor
    min_error: torch.Tensor
    converged: torch.Tensor          # bool


def position_error(X: torch.Tensor, target_xy: torch.Tensor) -> torch.Tensor:
    """(T, ...) Euclidean error of state channels [0, 2] of X (T, ..., 4)
    against target_xy (..., 2)."""
    return torch.linalg.vector_norm(X[..., [0, 2]] - target_xy, dim=-1)


def compute_metrics(X: torch.Tensor, U: torch.Tensor, target_xy: torch.Tensor,
                    dt: float, tol: float = 0.01) -> Metrics:
    """Per-lane metrics of a trace X (T, ..., 4) under controls U
    (T, ..., 2)."""
    err = position_error(X, target_xy)
    below = err < tol
    any_below = below.any(dim=0)
    # argmax returns the first maximum: the first step below tolerance.
    first = torch.argmax(below.to(torch.int8), dim=0)
    conv_time = torch.where(any_below, first.to(err.dtype) * dt,
                            torch.full_like(err[0], float("inf")))
    effort = torch.sum(torch.linalg.vector_norm(U, dim=-1), dim=0) * dt
    return Metrics(
        steady_state_error=err[-1],
        convergence_time=conv_time,
        control_effort=effort,
        min_error=torch.amin(err, dim=0),
        converged=any_below,
    )
