"""PMPC transition model and the shared RK4 integrator (port of
`dart_tpu.models.dynamics`, PMPC part).

Every function has the signature ``f(x, u, params) -> xdot`` and works on
one state (6,) or a batch (B, 6); per-lane parameters of shape (B,)
broadcast against the batch.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Dynamics = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]

# Signed gravity of the PMPC model (the reference reads model.opt.gravity[2]).
GRAVITY_Z = -9.81


class PMPCParams(NamedTuple):
    """Parameters of the analytic model (`mpc_3d.py:12-26`)."""

    mu: torch.Tensor | float = 0.4        # friction coefficient
    g: torch.Tensor | float = GRAVITY_Z   # signed gravity (negative)
    dt: torch.Tensor | float = 0.002      # Ts, used by the az finite-difference


def _like(v, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def pmpc_dynamics(x: torch.Tensor, u: torch.Tensor,
                  p: PMPCParams) -> torch.Tensor:
    """xdot for state [px, vx, py, vy, pz, vz], control [theta_x, theta_y].

    Keeps the reference's quirks: the vertical channel uses the algebraic
    ``vz_new = -g (tx^2 + ty^2)`` as pz-rate and a finite-difference az.
    """
    vx, vy, vz = x[..., 1], x[..., 3], x[..., 5]
    tx, ty = u[..., 0], u[..., 1]
    g = _like(p.g, x)
    mu = _like(p.mu, x)
    ax = g * torch.sin(tx) - mu * vx
    ay = g * torch.sin(ty) - mu * vy
    vz_new = -g * (tx * tx + ty * ty)
    az = (vz_new - vz) / _like(p.dt, x)
    return torch.stack([vx, ax, vy, ay, vz_new, az], dim=-1)


def rk4_step(f: Dynamics, x: torch.Tensor, u: torch.Tensor, p: Any,
             dt: float | torch.Tensor) -> torch.Tensor:
    """Classic RK4 with zero-order-held control."""
    k1 = f(x, u, p)
    k2 = f(x + 0.5 * dt * k1, u, p)
    k3 = f(x + 0.5 * dt * k2, u, p)
    k4 = f(x + dt * k3, u, p)
    return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def discretize(f: Dynamics, dt: float) -> Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]:
    """Return the discrete-time transition x_{k+1} = F(x_k, u_k, p)."""

    def step(x, u, p):
        return rk4_step(f, x, u, p, dt)

    return step
