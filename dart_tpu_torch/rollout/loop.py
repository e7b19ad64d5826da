"""Closed loops of a controller and a plant, as plain Python loops over
steps.

`run_closed_loop` is `jax.vmap(dart_tpu.rollout.loop.run_closed_loop)`
on a leading lane axis: {observe -> (solve | hold) -> apply -> plant
step}, with the reference's asynchrony made explicit (`control_every`
for an MPC slower than the plant, `warmup_steps` of rest, a `hold_fn`
such as `LMPC.shift_plan` between solves). `run_batch_closed_loop` is the
batch controllers' loop (the bench's closed loop, and the LMPC eval
episode on the analytic plant): solve every step, apply, step the plant.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from dart_tpu_torch.control.mpc import (LMPC_DEFAULT_WEIGHTS, LMPCBatch,
                                        LMPCWeights, PMPCBatch, PMPCWeights,
                                        RMPCBatch, RMPCWeights,
                                        RMPC_DEFAULT_WEIGHTS, SolveDiag)
from dart_tpu_torch.models import dynamics as dyn


class ClosedLoopResult(NamedTuple):
    X: torch.Tensor          # (B, T+1, nx_plant) plant states, x0 first
    U: torch.Tensor          # (B, T, nu) applied controls
    diag: SolveDiag          # (B, T) per-step diagnostics (0 on hold steps)
    carry: Any               # final controller carry


def _zero_diag(B: int, dtype, device) -> SolveDiag:
    z = torch.zeros((B,), dtype=dtype, device=device)
    return SolveDiag(z, z, torch.zeros((B,), dtype=torch.int32,
                                       device=device), z)


def run_closed_loop(solve_fn: Callable, plant_step: Callable, carry0: Any,
                    x0: torch.Tensor, target: torch.Tensor, plant_params: Any,
                    n_steps: int, observe: Callable = lambda x: x,
                    control_every: int = 1, warmup_steps: int = 0,
                    hold_fn: Optional[Callable] = None) -> ClosedLoopResult:
    """`n_steps` of the closed loop on lanes x0 (B, nx).

    solve_fn(carry, obs, target) -> (carry, u (B, 2), diag) runs at step k
    when k >= warmup_steps and (k - warmup_steps) % control_every == 0;
    otherwise hold_fn(carry, obs, target) -> (carry, u, diag), or, without
    one, the held control with zero diagnostics. Before warmup_steps the
    plant gets u = 0. plant_step(x, u, plant_params) -> x_next.
    """
    B, dtype, dev = x0.shape[0], x0.dtype, x0.device
    carry, x = carry0, x0
    u_held = torch.zeros((B, 2), dtype=dtype, device=dev)
    xs, us, diags = [x0], [], []
    with torch.no_grad():
        for k in range(n_steps):
            obs = observe(x)
            if k >= warmup_steps and (k - warmup_steps) % control_every == 0:
                carry, u, diag = solve_fn(carry, obs, target)
            elif hold_fn is not None:
                carry, u, diag = hold_fn(carry, obs, target)
            else:
                u, diag = u_held, _zero_diag(B, dtype, dev)
            if k < warmup_steps:
                u = torch.zeros_like(u)
            x = plant_step(x, u, plant_params)
            u_held = u
            xs.append(x)
            us.append(u)
            diags.append(diag)
    return ClosedLoopResult(
        X=torch.stack(xs, 1), U=torch.stack(us, 1),
        diag=SolveDiag(*(torch.stack(d, 1) for d in zip(*diags))),
        carry=carry)


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
