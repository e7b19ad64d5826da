"""Optimal-control problem definition and the stationarity certificate
(port of the parts of `dart_tpu.solver.ilqr` that the PMPC kernel path
reads).

Batch-first throughout: z (B, nz), V (B, N, nu), per-lane cost data with a
leading batch axis or scalars that broadcast. The generic box-DDP solver
(`ilqr.solve_batch`) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class OCPDef(NamedTuple):
    """A discrete-time optimal-control problem over horizon N.

    `step(z, v, params)`, `stage_cost(z, v, k, aux)` and
    `term_cost(z, aux)` act on batches (B, ...) and return (B, ...) or (B,).
    """

    step: Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]
    stage_cost: Callable[[torch.Tensor, torch.Tensor, int, Any], torch.Tensor]
    term_cost: Callable[[torch.Tensor, Any], torch.Tensor]
    u_lo: tuple
    u_hi: tuple


class ILQRConfig(NamedTuple):
    max_iters: int = 60          # inner iLQR iterations per AL round
    al_iters: int = 5            # augmented-Lagrangian rounds
    mu_init: float = 10.0        # initial penalty weight
    mu_scale: float = 10.0       # penalty growth when violation stalls
    mu_max: float = 1e8
    tol_con: float = 1e-8        # constraint violation target
    tol_step: float = 1e-7       # max feedforward step for convergence
    tol_cost: float = 1e-9       # relative cost decrease for convergence
    reg_init: float = 1e-6
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_up: float = 8.0
    reg_down: float = 0.25
    n_alphas: int = 11           # line-search resolution (0.6^k)
    linesearch: str = "backtrack"


def _rollout(ocp: OCPDef, params, z0: torch.Tensor,
             V: torch.Tensor) -> torch.Tensor:
    """z0 (B, nz), V (B, N, nu) -> Z (B, N+1, nz)."""
    zs = [z0]
    for k in range(V.shape[1]):
        zs.append(ocp.step(zs[-1], V[:, k], params))
    return torch.stack(zs, dim=1)


def _raw_cost(ocp: OCPDef, aux, Z: torch.Tensor,
              V: torch.Tensor) -> torch.Tensor:
    """Per-lane unpenalised cost (B,) of the trajectory (Z, V)."""
    cs = torch.stack([ocp.stage_cost(Z[:, k], V[:, k], k, aux)
                      for k in range(V.shape[1])], dim=-1)
    return torch.sum(cs, dim=-1) + ocp.term_cost(Z[:, -1], aux)


def projected_grad_norm(ocp: OCPDef, params, aux, z0: torch.Tensor,
                        V: torch.Tensor) -> torch.Tensor:
    """Per-lane first-order stationarity of the RAW objective at V:
    max |V - clip(V - dJ/dV, u_lo, u_hi)| over the horizon.

    Zero at a box-constrained optimum: the post-hoc certificate for the
    fixed-budget whole-solve kernel. dJ/dV is one reverse pass through the
    batched rollout (lanes are independent, so the gradient of the summed
    cost is every lane's own gradient). Returns (B,).
    """
    with torch.enable_grad():
        v = V.detach().clone().requires_grad_(True)
        J = _raw_cost(ocp, aux, _rollout(ocp, params, z0, v), v)
        (g,) = torch.autograd.grad(J.sum(), v)
    u_lo = torch.as_tensor(ocp.u_lo, dtype=V.dtype, device=V.device)
    u_hi = torch.as_tensor(ocp.u_hi, dtype=V.dtype, device=V.device)
    step = torch.clamp(V - g, u_lo, u_hi) - V
    return torch.amax(torch.abs(step), dim=(1, 2))
