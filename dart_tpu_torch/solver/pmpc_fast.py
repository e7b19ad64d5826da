"""Structure-exploiting PMPC pieces (port of `dart_tpu.solver.pmpc_fast`,
kernel path).

The PMPC continuous dynamics are affine in the state, xdot = M(mu) x + c(u),
so one RK4 step is exactly x+ = Ad x + Sd c(u) with per-lane constant
Ad, Sd (functions of mu only). `solve_batch_kernel` hands the whole solve
to `ops.kernels.pmpc_solve`. `solve_batch_fast` runs the box-DDP iteration
of `ilqr.solve_batch` with this closed-form linearisation and the Riccati
kernel (`ops.kernels.riccati`) as its backward pass.
"""

from __future__ import annotations

import torch

from dart_tpu_torch.models import dynamics as dyn
from dart_tpu_torch.ops.kernels.pmpc_solve import pmpc_solve
from dart_tpu_torch.solver import ilqr
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


def solve_batch_fast(mu: torch.Tensor, aux: PMPCAux, z0: torch.Tensor,
                     V_init: torch.Tensor, dt: float = 0.002,
                     u_bound: float = 0.6, g: float = dyn.GRAVITY_Z,
                     max_iters: int = 4, n_alphas: int = 8,
                     tol_cost: float = 1e-9):
    """Batched PMPC solve with closed-form linearisation: mu (B,), aux
    leaves (B, ...), z0 (B, 6), V_init (B, N, 2).
    Returns (V (B,N,2), Z (B,N+1,6), cost (B,))."""
    B, N, nu = V_init.shape
    dtype, dev = V_init.dtype, V_init.device
    Ad, Sd = _affine_discretization(mu.to(dtype), g, dt)     # (B,6,6) x2
    u_lo = torch.full((nu,), -u_bound, dtype=dtype, device=dev)
    u_hi = torch.full((nu,), u_bound, dtype=dtype, device=dev)
    bounds = ((-u_bound, -u_bound), (u_bound, u_bound))
    V = ilqr._clip(V_init, u_lo, u_hi)

    wdiag = _pmpc_w(aux, dtype)
    lxx = 2.0 * torch.diag_embed(wdiag)                      # (B, 6, 6)
    luu = 2.0 * aux.R[:, None, None] * torch.eye(2, dtype=dtype, device=dev)
    tgt = aux.target

    def mv(M, x):
        """Per-lane (B,i,j) @ (..., B, j) -> (..., B, i)."""
        return (M @ x[..., None])[..., 0]

    def step(x, v):
        return mv(Ad, x) + mv(Sd, _c_of_u(v, g, dt))

    def rollout(V):
        zs = [z0]
        for k in range(N):
            zs.append(step(zs[-1], V[:, k]))
        return torch.stack(zs, dim=1)

    def total_cost(Z, V):
        """Z (..., B, N+1, 6), V (..., B, N, 2) -> (..., B)."""
        e = Z - tgt[:, None, :]
        state_c = torch.sum(wdiag[:, None, :] * e * e, dim=(-2, -1))
        ctrl_c = aux.R[:, None] * torch.sum(V * V, dim=-1)
        return state_c + torch.sum(ctrl_c, dim=-1)

    def linearize(Z, V):
        e = Z[:, :-1] - tgt[:, None, :]
        lx = 2.0 * wdiag[:, None, :] * e
        lu = 2.0 * aux.R[:, None, None] * V
        Bmat = torch.einsum("bij,bnjm->bnim", Sd, _dcdu(V, g, dt))
        A = Ad[:, None].expand(B, N, 6, 6)
        lux = torch.zeros((B, N, 2, 6), dtype=dtype, device=dev)
        gx = 2.0 * wdiag * (Z[:, -1] - tgt)
        return (A, Bmat, lx, lu, lxx[:, None].expand(B, N, 6, 6), lux,
                luu[:, None].expand(B, N, 2, 2), gx, lxx)

    def forward(Z, V, D, K):
        """Closed-loop rollouts at every step size at once, alphas on a
        leading axis: Zn (A,B,N+1,6), Vn (A,B,N,2), cost (A,B)."""
        al = alphas[:, None, None]
        x = z0.expand(n_alphas, B, 6)
        zs, vs = [x], []
        for k in range(N):
            v = ilqr._clip(V[:, k] + al * D[:, k] + mv(K[:, k], x - Z[:, k]),
                           u_lo, u_hi)
            x = step(x, v)
            zs.append(x)
            vs.append(v)
        Zn, Vn = torch.stack(zs, dim=-2), torch.stack(vs, dim=-2)
        return Zn, Vn, total_cost(Zn, Vn)

    alphas = ilqr._alphas(n_alphas, dtype, dev)
    Z = rollout(V)
    cost = total_cost(Z, V)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    reg = torch.full((B,), 1e-6, dtype=dtype, device=dev)
    it = 0
    while it < max_iters and not ilqr.host_bool(done.all()):
        D, K = ilqr.backward(linearize(Z, V), V, *bounds, reg)
        # Per-lane backtracking: each lane takes the first step size that
        # lowers its cost. The trials are independent, so all of them run
        # in one batched rollout (a few hundred device ops and no host
        # sync per iteration, where a loop over alphas would issue one
        # rollout and one sync per alpha); the selection below keeps the
        # sequential order.
        Zc, Vc, cc = forward(Z, V, D, K)
        acc = done
        Zb, Vb, cb = Z, V, cost
        for i in range(n_alphas):
            newly = (~acc) & (cc[i] < cost - 1e-12)
            Zb = torch.where(newly[:, None, None], Zc[i], Zb)
            Vb = torch.where(newly[:, None, None], Vc[i], Vb)
            cb = torch.where(newly, cc[i], cb)
            acc = acc | newly
        improved = acc & (~done)
        Z = torch.where(improved[:, None, None], Zb, Z)
        V = torch.where(improved[:, None, None], Vb, V)
        cost_keep = torch.where(improved, cb, cost)
        rel = (cost - cost_keep) / (torch.abs(cost) + 1.0)
        done = done | (improved & (rel < tol_cost)) | \
            ((~improved) & (reg >= 1e9))
        reg = torch.where(improved, torch.clamp_min(reg * 0.25, 1e-9),
                          torch.clamp_max(reg * 8.0, 1e9))
        cost = cost_keep
        it += 1
    return V, Z, cost
