"""PMPC and RMPC transition models, their closed-form Jacobians and the
shared RK4 integrator (port of `dart_tpu.models.dynamics`, PMPC and RMPC
parts).

Every function has the signature ``f(x, u, params) -> xdot`` and works on
one state or a batch (B, nx): indexing is written with ``...``, so the same
function serves a batch and a single lane under `torch.func.vmap`.
Per-lane parameters of shape (B,) (or (B, 14) for the RMPC theta)
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


class RMPCParams(NamedTuple):
    """theta = 14-vector [theta_x(7), theta_y(7)] learned online by RLS."""

    theta: torch.Tensor                   # (..., 14)
    g: torch.Tensor | float = GRAVITY_Z   # signed gravity (negative)
    v_eps: torch.Tensor | float = 0.1     # tanh feature sharpness


def rmpc_features(x: torch.Tensor, v_eps) -> torch.Tensor:
    """7-feature vector phi = [px, vx, py, vy, tanh(vx/eps), tanh(vy/eps), 1],
    shared by the MPC model and the RLS estimator."""
    px, vx, py, vy = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    v_eps = _like(v_eps, x)
    return torch.stack([px, vx, py, vy, torch.tanh(vx / v_eps),
                        torch.tanh(vy / v_eps), torch.ones_like(px)], dim=-1)


def rmpc_dynamics(x: torch.Tensor, u: torch.Tensor,
                  p: RMPCParams) -> torch.Tensor:
    """xdot for state [px, vx, py, vy]: gravity plus the learned regressor."""
    vx, vy = x[..., 1], x[..., 3]
    g = _like(p.g, x)
    phi = rmpc_features(x, p.v_eps)
    th = _like(p.theta, x)
    ax = g * torch.sin(u[..., 0]) + torch.sum(phi * th[..., 0:7], dim=-1)
    ay = g * torch.sin(u[..., 1]) + torch.sum(phi * th[..., 7:14], dim=-1)
    return torch.stack([vx, ax, vy, ay], dim=-1)


def pmpc_jac(x: torch.Tensor, u: torch.Tensor, p: PMPCParams):
    """Continuous-time (A (..., 6, 6), B (..., 6, 2)) of `pmpc_dynamics`.
    A is constant (a function of mu and dt only); B carries the g cos(tilt)
    rows and the algebraic vertical channel's -2 g tilt terms."""
    tx, ty = u[..., 0], u[..., 1]
    g = _like(p.g, x)
    mu = _like(p.mu, x) * torch.ones_like(tx)
    inv_dt = 1.0 / _like(p.dt, x) * torch.ones_like(tx)
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    A = torch.stack([
        torch.stack([z, o, z, z, z, z], -1),
        torch.stack([z, -mu, z, z, z, z], -1),
        torch.stack([z, z, z, o, z, z], -1),
        torch.stack([z, z, z, -mu, z, z], -1),
        torch.stack([z, z, z, z, z, z], -1),
        torch.stack([z, z, z, z, z, -inv_dt], -1),
    ], -2)
    ca, cb = g * torch.cos(tx), g * torch.cos(ty)
    wx, wy = -2.0 * g * tx, -2.0 * g * ty
    z2 = torch.stack([z, z], -1)
    B = torch.stack([z2, torch.stack([ca, z], -1), z2,
                     torch.stack([z, cb], -1), torch.stack([wx, wy], -1),
                     torch.stack([wx * inv_dt, wy * inv_dt], -1)], -2)
    return A, B


def rmpc_jac(x: torch.Tensor, u: torch.Tensor, p: RMPCParams):
    """Continuous-time (A (..., 4, 4), B (..., 4, 2)) of `rmpc_dynamics`:
    phi is linear in the state except the two tanh features, whose slope
    is (1 - tanh^2) / v_eps."""
    vx, vy = x[..., 1], x[..., 3]
    g = _like(p.g, x)
    ve = _like(p.v_eps, x)
    th = _like(p.theta, x)
    thx, thy = th[..., 0:7], th[..., 7:14]
    tx, ty = torch.tanh(vx / ve), torch.tanh(vy / ve)
    dtx = (1.0 - tx * tx) / ve
    dty = (1.0 - ty * ty) / ve
    z, o = torch.zeros_like(vx), torch.ones_like(vx)
    row_ax = torch.stack([thx[..., 0], thx[..., 1] + thx[..., 4] * dtx,
                          thx[..., 2], thx[..., 3] + thx[..., 5] * dty], -1)
    row_ay = torch.stack([thy[..., 0], thy[..., 1] + thy[..., 4] * dtx,
                          thy[..., 2], thy[..., 3] + thy[..., 5] * dty], -1)
    A = torch.stack([torch.stack([z, o, z, z], -1), row_ax,
                     torch.stack([z, z, z, o], -1), row_ay], -2)
    ca, cb = g * torch.cos(u[..., 0]), g * torch.cos(u[..., 1])
    B = torch.stack([torch.stack([z, z], -1), torch.stack([ca, z], -1),
                     torch.stack([z, z], -1), torch.stack([z, cb], -1)], -2)
    return A, B


def rk4_jac(f: Dynamics, f_jac, x: torch.Tensor, u: torch.Tensor, p: Any,
            dt: float | torch.Tensor):
    """Exact (Ad, Bd) of `rk4_step` by the chain rule through the four RK4
    stages, from the continuous-time stage Jacobians `f_jac`."""
    dt = _like(dt, x)
    k1 = f(x, u, p)
    x2 = x + 0.5 * dt * k1
    k2 = f(x2, u, p)
    x3 = x + 0.5 * dt * k2
    x4 = x + dt * f(x3, u, p)
    A1, B1 = f_jac(x, u, p)
    A2, B2 = f_jac(x2, u, p)
    A3, B3 = f_jac(x3, u, p)
    A4, B4 = f_jac(x4, u, p)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    dk2x = A2 @ (eye + 0.5 * dt * A1)
    dk2u = A2 @ (0.5 * dt * B1) + B2
    dk3x = A3 @ (eye + 0.5 * dt * dk2x)
    dk3u = A3 @ (0.5 * dt * dk2u) + B3
    dk4x = A4 @ (eye + dt * dk3x)
    dk4u = A4 @ (dt * dk3u) + B4
    Ad = eye + dt / 6.0 * (A1 + 2.0 * dk2x + 2.0 * dk3x + dk4x)
    Bd = dt / 6.0 * (B1 + 2.0 * dk2u + 2.0 * dk3u + dk4u)
    return Ad, Bd


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
