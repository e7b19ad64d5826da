"""PMPC, RMPC and LMPC transition models, their closed-form Jacobians and
the shared RK4 integrator (port of `dart_tpu.models.dynamics`).

Every function has the signature ``f(x, u, params) -> xdot`` and works on
one state or a batch (B, nx): indexing is written with ``...``, so the same
function serves a batch and a single lane under `torch.func.vmap`.
Per-lane parameters of shape (B,) (or (B, 14) for the RMPC theta, (B, 34)
for the LMPC parameter vector) broadcast against the batch.
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


# --------------------------------------------------------------------------
# LMPC: 8-state, 34-parameter Stribeck / rolling / toppling model
# --------------------------------------------------------------------------

# Index map of the 34-entry parameter vector:
#   0 m_x*   1 m_y*   2 c_x*   3 c_y*   4 k_x*   5 k_y*
#   6 F_s_x  7 F_c_x  8 B_x    9 v_s_x* 10 eps_x*
#   11 F_s_y 12 F_c_y 13 B_y   14 v_s_y* 15 eps_y*
#   16 I_x*  17 I_y*  18 r_x*  19 r_y*  20 c_rot_x* 21 c_rot_y*
#   22 F_s_rot_x 23 F_c_rot_x 24 B_rot_x 25 v_s_rot_x* 26 eps_rot_x*
#   27 F_s_rot_y 28 F_c_rot_y 29 B_rot_y 30 v_s_rot_y* 31 eps_rot_y*
#   32 h_com_x* 33 h_com_y*
# Entries marked * pass through squash(p) = |p| + 1e-6 before use.
LMPC_N_PARAMS = 34
LMPC_G = 9.81  # positive, as the reference hard-codes it

_SQUASHED = (0, 1, 2, 3, 4, 5, 9, 10, 14, 15, 16, 17, 18, 19, 20, 21,
             25, 26, 30, 31, 32, 33)


def _squash(p: torch.Tensor) -> torch.Tensor:
    return torch.abs(p) + 1e-6


def smooth_sign(v: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    return torch.tanh(v / eps)


def stribeck_friction(v, f_s, f_c, b, v_s, eps):
    """sign_smooth(v) * (Fc + (Fs-Fc) e^{-|v|/vs}) + B v."""
    static_to_coulomb = f_c + (f_s - f_c) * torch.exp(
        -torch.abs(v) / (v_s + 1e-12))
    return smooth_sign(v, eps) * static_to_coulomb + b * v


def lmpc_squash_params(p: torch.Tensor) -> torch.Tensor:
    """Apply |.|+1e-6 to the positivity-constrained entries of the
    34-vector (..., 34)."""
    m = torch.zeros(LMPC_N_PARAMS, dtype=torch.bool, device=p.device)
    m[list(_SQUASHED)] = True
    return torch.where(m, _squash(p), p)


class _LMPCTerms(NamedTuple):
    """The 34-vector's entries by name, squashed where the model says."""

    m_x: torch.Tensor
    m_y: torch.Tensor
    c_x: torch.Tensor
    c_y: torch.Tensor
    k_x: torch.Tensor
    k_y: torch.Tensor
    fric_x: tuple          # (F_s, F_c, B, v_s, eps) of the x slide
    fric_y: tuple
    i_x: torch.Tensor
    i_y: torch.Tensor
    r_x: torch.Tensor
    r_y: torch.Tensor
    c_rot_x: torch.Tensor
    c_rot_y: torch.Tensor
    fric_rx: tuple         # (F_s, F_c, B, v_s, eps) of the x rotation
    fric_ry: tuple
    h_com_x: torch.Tensor
    h_com_y: torch.Tensor


def _lmpc_terms(pvec: torch.Tensor) -> _LMPCTerms:
    def sq(i):
        return _squash(pvec[..., i])

    def raw(i):
        return pvec[..., i]

    def fric(i):
        return (raw(i), raw(i + 1), raw(i + 2), sq(i + 3), sq(i + 4))

    return _LMPCTerms(
        m_x=sq(0), m_y=sq(1), c_x=sq(2), c_y=sq(3), k_x=sq(4), k_y=sq(5),
        fric_x=fric(6), fric_y=fric(11), i_x=sq(16), i_y=sq(17),
        r_x=sq(18), r_y=sq(19), c_rot_x=sq(20), c_rot_y=sq(21),
        fric_rx=fric(22), fric_ry=fric(27), h_com_x=sq(32), h_com_y=sq(33))


def lmpc_dynamics(x: torch.Tensor, u: torch.Tensor,
                  pvec: torch.Tensor) -> torch.Tensor:
    """xdot for state [px,vx,py,vy, th_x,om_x, th_y,om_y], control
    [tilt_x, tilt_y]. pvec is the raw 34-vector (squashing applied
    here)."""
    px, vx, py, vy = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    th_x, om_x, th_y, om_y = x[..., 4], x[..., 5], x[..., 6], x[..., 7]
    a, b = u[..., 0], u[..., 1]
    p = _lmpc_terms(_like(pvec, x))
    g = _like(LMPC_G, x)

    # gravity / tilt forcing (translational)
    g_x = p.m_x * g * torch.sin(a)
    g_y = p.m_y * g * torch.sin(b)
    # translational sliding friction
    ff_x = stribeck_friction(vx, *p.fric_x)
    ff_y = stribeck_friction(vy, *p.fric_y)
    # rolling slip: omega_y drives x, -omega_x drives y
    f_roll_x = stribeck_friction(vx - p.r_x * om_y, *p.fric_x)
    f_roll_y = stribeck_friction(vy - (-p.r_y * om_x), *p.fric_y)
    # rotational torques
    t_noslip_x = stribeck_friction(om_x, *p.fric_rx)
    t_noslip_y = stribeck_friction(om_y, *p.fric_ry)
    tau_topple_x = -p.m_y * g * p.h_com_x * torch.sin(th_x)
    tau_topple_y = -p.m_x * g * p.h_com_y * torch.sin(th_y)
    tau_x = -p.r_y * f_roll_y - t_noslip_x - p.c_rot_x * om_x + tau_topple_x
    tau_y = -p.r_x * f_roll_x - t_noslip_y - p.c_rot_y * om_y + tau_topple_y
    al_x = tau_x / (p.i_x + 1e-12)
    al_y = tau_y / (p.i_y + 1e-12)
    # translational EoM: M qdd = G - C qd - K q - F_fric - F_roll
    qdd_x = (g_x - p.c_x * vx - p.k_x * px - ff_x - f_roll_x) / p.m_x
    qdd_y = (g_y - p.c_y * vy - p.k_y * py - ff_y - f_roll_y) / p.m_y
    return torch.stack([vx, qdd_x, vy, qdd_y, om_x, al_x, om_y, al_y], -1)


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


def stribeck_friction_deriv(v, f_s, f_c, b, v_s, eps):
    """d/dv of `stribeck_friction`, with d|v|/dv = sign(0) = 0 at v = 0 as
    autodiff of `torch.abs` (and `jnp.abs`) gives it."""
    vs = v_s + 1e-12
    ex = torch.exp(-torch.abs(v) / vs)
    stc = f_c + (f_s - f_c) * ex
    t = torch.tanh(v / eps)
    return (1.0 - t * t) / eps * stc + t * (f_s - f_c) * ex * \
        (-torch.sign(v) / vs) + b


def lmpc_jac(x: torch.Tensor, u: torch.Tensor, pvec: torch.Tensor):
    """Continuous-time (A (..., 8, 8), B (..., 8, 2)) of `lmpc_dynamics`.
    qdd_x couples to {px, vx, om_y} (rolling slip), al_x to {vy, om_x,
    th_x}, and symmetrically for y; the tilts enter only the translational
    accelerations (g cos tilt)."""
    vx, vy = x[..., 1], x[..., 3]
    th_x, om_x, th_y, om_y = x[..., 4], x[..., 5], x[..., 6], x[..., 7]
    a, b_u = u[..., 0], u[..., 1]
    p = _lmpc_terms(_like(pvec, x))
    g = _like(LMPC_G, x)
    m_x, m_y, r_x, r_y = p.m_x, p.m_y, p.r_x, p.r_y

    # Friction slopes at the evaluation point.
    Dff_x = stribeck_friction_deriv(vx, *p.fric_x)
    Dff_y = stribeck_friction_deriv(vy, *p.fric_y)
    Dfr_x = stribeck_friction_deriv(vx - r_x * om_y, *p.fric_x)
    Dfr_y = stribeck_friction_deriv(vy + r_y * om_x, *p.fric_y)
    Dtn_x = stribeck_friction_deriv(om_x, *p.fric_rx)
    Dtn_y = stribeck_friction_deriv(om_y, *p.fric_ry)
    ix = p.i_x + 1e-12
    iy = p.i_y + 1e-12
    z, o = torch.zeros_like(vx), torch.ones_like(vx)

    # State order [px, vx, py, vy, th_x, om_x, th_y, om_y].
    r_vx = torch.stack([-p.k_x / m_x, (-p.c_x - Dff_x - Dfr_x) / m_x, z, z,
                        z, z, z, r_x * Dfr_x / m_x], -1)
    r_vy = torch.stack([z, z, -p.k_y / m_y, (-p.c_y - Dff_y - Dfr_y) / m_y,
                        z, -r_y * Dfr_y / m_y, z, z], -1)
    r_alx = torch.stack([z, z, z, -r_y * Dfr_y / ix,
                         -m_y * g * p.h_com_x * torch.cos(th_x) / ix,
                         (-r_y * r_y * Dfr_y - Dtn_x - p.c_rot_x) / ix, z,
                         z], -1)
    r_aly = torch.stack([z, -r_x * Dfr_x / iy, z, z, z, z,
                         -m_x * g * p.h_com_y * torch.cos(th_y) / iy,
                         (r_x * r_x * Dfr_x - Dtn_y - p.c_rot_y) / iy], -1)

    def e(i):
        rows = [z] * 8
        rows[i] = o
        return torch.stack(rows, -1)

    A = torch.stack([e(1), r_vx, e(3), r_vy, e(5), r_alx, e(7), r_aly], -2)
    ca = g * torch.cos(a)
    cb = g * torch.cos(b_u)
    z2 = torch.stack([z, z], -1)
    B = torch.stack([z2, torch.stack([ca, z], -1), z2,
                     torch.stack([z, cb], -1), z2, z2, z2, z2], -2)
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
