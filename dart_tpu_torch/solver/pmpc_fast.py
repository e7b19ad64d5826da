"""Structure-exploiting PMPC pieces (port of `dart_tpu.solver.pmpc_fast`,
kernel path).

The PMPC continuous dynamics are affine in the state, xdot = M(mu) x + c(u),
so one RK4 step is exactly x+ = Ad x + Sd c(u) with per-lane constant
Ad, Sd (functions of mu only). `solve_batch_kernel` hands the whole solve
to `ops.kernels.pmpc_solve`. The non-kernel solver `solve_batch_fast`
needs the Riccati kernel and is not ported yet.
"""

from __future__ import annotations

import torch

from dart_tpu_torch.models import dynamics as dyn
from dart_tpu_torch.ops.kernels.pmpc_solve import pmpc_solve
from dart_tpu_torch.solver.ocp import PMPCAux, _pmpc_w


def _affine_discretization(mu: torch.Tensor, g, dt: float):
    """Per-scenario (Ad, Sd) (..., 6, 6): the exact RK4 of the affine
    system, Ad = sum_{n<=4} (dt M)^n / n!, Sd = dt sum_{n<=3} (dt M)^n /
    (n+1)!. mu may be batched (...,); g does not enter (it lives in c(u))."""
    z = torch.zeros_like(mu)
    o = torch.ones_like(mu)
    inv_ts = o / dt
    M = torch.stack([
        torch.stack([z, o, z, z, z, z], -1),
        torch.stack([z, -mu, z, z, z, z], -1),
        torch.stack([z, z, z, o, z, z], -1),
        torch.stack([z, z, z, -mu, z, z], -1),
        torch.stack([z, z, z, z, z, z], -1),
        torch.stack([z, z, z, z, z, -inv_ts], -1),
    ], -2)
    eye = torch.eye(6, dtype=mu.dtype, device=mu.device)
    M2 = M @ M
    M3 = M2 @ M
    M4 = M3 @ M
    Ad = (eye + dt * M + dt**2 / 2 * M2 + dt**3 / 6 * M3 + dt**4 / 24 * M4)
    Sd = (dt * eye + dt**2 / 2 * M + dt**3 / 6 * M2 + dt**4 / 24 * M3)
    return Ad, Sd


def _c_of_u(u: torch.Tensor, g, dt: float) -> torch.Tensor:
    """Input drive c(u) (..., 6)."""
    s0, s1 = torch.sin(u[..., 0]), torch.sin(u[..., 1])
    w = -g * (u[..., 0] ** 2 + u[..., 1] ** 2)
    z = torch.zeros_like(s0)
    return torch.stack([z, g * s0, z, g * s1, w, w / dt], -1)


def _dcdu(u: torch.Tensor, g, dt: float) -> torch.Tensor:
    """dc/du (..., 6, 2), closed form."""
    c0, c1 = torch.cos(u[..., 0]), torch.cos(u[..., 1])
    z = torch.zeros_like(c0)
    du0 = torch.stack([z, g * c0, z, z, -2 * g * u[..., 0],
                       -2 * g * u[..., 0] / dt], -1)
    du1 = torch.stack([z, z, z, g * c1, -2 * g * u[..., 1],
                       -2 * g * u[..., 1] / dt], -1)
    return torch.stack([du0, du1], -1)


def _batch_last(x: torch.Tensor) -> torch.Tensor:
    return torch.movedim(x, 0, -1).contiguous()


def solve_batch_kernel(mu: torch.Tensor, aux: PMPCAux, z0: torch.Tensor,
                       V_init: torch.Tensor, dt: float = 0.002,
                       u_bound: float = 0.6, n_iters: int = 2,
                       n_alphas: int = 3, g: float = dyn.GRAVITY_Z):
    """Whole-solve kernel path, batch-first API: mu (B,), aux leaves (B, ...),
    z0 (B, 6), V_init (B, N, 2). V_init is not clipped.
    Returns (V (B,N,2), cost (B,), gnorm (B,)), gnorm being the kernel's
    max |feedforward| of its last iteration."""
    dtype = V_init.dtype
    Ad, Sd = _affine_discretization(mu.to(dtype), g, dt)
    wdiag = _pmpc_w(aux, dtype)
    V, cost, gnorm = pmpc_solve(
        _batch_last(Ad), _batch_last(Sd), _batch_last(wdiag),
        aux.R.to(dtype).contiguous(), _batch_last(aux.target.to(dtype)),
        _batch_last(z0), _batch_last(V_init), dt=dt, u_bound=u_bound,
        g=float(g), n_iters=n_iters, n_alphas=n_alphas)
    return torch.movedim(V, -1, 0), cost, gnorm
