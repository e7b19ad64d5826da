"""Batched closed loop of a controller and a plant (counterpart of the
step of `dart_tpu.rollout.evaluate.make_pmpc_batch_evaluator` with
control_every=1 and warmup_steps=0, of the bench's closed loop, and of the
LMPC eval episode on the analytic plant).

A plain Python loop over steps: each step solves, applies the control the
solver returns and steps the plant.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from dart_tpu_torch.control.mpc import (LMPC_DEFAULT_WEIGHTS, LMPCBatch,
                                        LMPCWeights, PMPCBatch, PMPCWeights,
                                        RMPCBatch, RMPCWeights,
                                        RMPC_DEFAULT_WEIGHTS)
from dart_tpu_torch.models import dynamics as dyn


def pmpc_solve_fn(ctlr: PMPCBatch, targets: torch.Tensor,
                  params: dyn.PMPCParams, weights: PMPCWeights):
    """`ctlr.solve` bound to its targets, params and weights, as the
    `solve_fn(carry, x) -> (carry, u)` of `run_batch_closed_loop`. u is
    V[:, 0] of the solution."""

    def solve_fn(carry, x):
        carry, u, _ = ctlr.solve(carry, x, targets, params, weights)
        return carry, u

    return solve_fn


def rmpc_solve_fn(ctlr: RMPCBatch, targets4: torch.Tensor,
                  weights: RMPCWeights = RMPC_DEFAULT_WEIGHTS):
    """`ctlr.solve_batched` as the `solve_fn(carry, x) -> (carry, u)` of
    `run_batch_closed_loop`. The controller observes [px, vx, py, vy] =
    x[:, :4] of the analytic plant's state; u is the applied tilt."""

    def solve_fn(carry, x):
        carry, u, _ = ctlr.solve_batched(carry, x[:, :4], targets4, weights)
        return carry, u

    return solve_fn


def lmpc_solve_fn(ctlr: LMPCBatch, targets8: torch.Tensor,
                  pvecs: torch.Tensor,
                  weights: LMPCWeights = LMPC_DEFAULT_WEIGHTS):
    """`ctlr.solve_batched` bound to its targets (B, 8) and raw model
    parameters (B, 34), as the `solve_fn(carry, x) -> (carry, u)` of
    `run_batch_closed_loop`; u is V[:, 0] of the solution."""

    def solve_fn(carry, x):
        carry, u, _ = ctlr.solve_batched(carry, x, targets8, pvecs, weights)
        return carry, u

    return solve_fn


def lmpc_plant_step(pvec_true: torch.Tensor, dt: float):
    """The RK4 LMPC model x+ = F(x, u; pvec_true) at period dt, batched:
    the analytic plant of the LMPC eval episodes, with per-lane true
    parameters (B, 34)."""
    step = dyn.discretize(dyn.lmpc_dynamics, dt)

    def plant_step(x, u):
        return step(x, u, pvec_true)

    return plant_step


def pmpc_plant_step(mu: torch.Tensor | float, dt: float):
    """The analytic RK4 plant x+ = F(x, u; mu) at period dt, batched."""
    step = dyn.discretize(dyn.pmpc_dynamics, dt)
    params = dyn.PMPCParams(mu=mu, dt=dt)

    def plant_step(x, u):
        return step(x, u, params)

    return plant_step


def run_batch_closed_loop(solve_fn: Callable[[Any, torch.Tensor], tuple],
                          plant_step: Callable[[torch.Tensor, torch.Tensor],
                                               torch.Tensor],
                          carry0, x0: torch.Tensor, n_steps: int):
    """Run `n_steps` of solve -> apply u -> step the plant.
    Returns (final carry, final state (B, nx), controls (n_steps, B, 2))."""
    carry, x = carry0, x0
    us = []
    with torch.no_grad():
        for _ in range(n_steps):
            carry, u = solve_fn(carry, x)
            x = plant_step(x, u)
            us.append(u)
    return carry, x, torch.stack(us)


def quality_at_1cm(x_final: torch.Tensor,
                   targets: torch.Tensor) -> tuple[float, float]:
    """The bench's quality gate: share of lanes whose final XY position is
    within 1 cm of the target, and the mean final XY error in mm."""
    err = torch.hypot(x_final[:, 0] - targets[:, 0],
                      x_final[:, 2] - targets[:, 2])
    return (float(torch.mean((err < 0.01).to(torch.float32))),
            float(torch.mean(err)) * 1e3)
