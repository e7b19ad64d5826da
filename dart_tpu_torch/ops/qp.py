"""Dense ADMM QP solver (OSQP-style) for two-sided linear constraints
(port of `dart_tpu.ops.qp`):

    min_x  0.5 x' P x + q' x    s.t.   l <= A x <= u

It replaces IPOPT on the per-arm impedance QP (7 variables, 21 two-sided
constraints, `PMPC/src/controller/arm.py:338-424`): every lane (both
arms of every scenario) one dense 7x7 factorisation. A fixed iteration
count with over-relaxation, warm-startable with (x, y) from the previous
control step as the reference warm-starts IPOPT (`arm.py:297-314,
434-437`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QPSolution(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor          # dual for the Ax rows
    z: torch.Tensor          # auxiliary (projected Ax)
    pri_res: torch.Tensor    # final primal residual ||Ax - z||_inf
    dua_res: torch.Tensor    # final dual residual


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Matrix (..., m, n) times vector (..., n), on lanes."""
    return (A @ x[..., None])[..., 0]


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X with (L L') X = B for a lower Cholesky factor L (..., n, n) and B
    (..., n, k): two triangular solves, as `jax.scipy.linalg.cho_solve`
    takes them. Unlike `torch.cholesky_solve` it reads no error flag back
    to the host."""
    return torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, B, upper=False), upper=True)


def spd_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 B for symmetric positive definite A (..., n, n), B (..., n, k),
    by Cholesky. JAX's `jnp.linalg.solve` and `inv` take LU; on such A the
    two agree to round-off, and this route reads nothing back to the host
    (torch's LU solve checks its pivots there). A singular A gives inf or
    NaN, as JAX's does, and raises nothing."""
    return cho_solve(torch.linalg.cholesky_ex(A)[0], B)


def spd_inv(A: torch.Tensor) -> torch.Tensor:
    """`spd_solve(A, I)`."""
    n = A.shape[-1]
    return spd_solve(A, torch.eye(n, dtype=A.dtype, device=A.device)
                     .expand(A.shape))


def solve_qp_admm(P: torch.Tensor, q: torch.Tensor, A: torch.Tensor,
                  l: torch.Tensor, u: torch.Tensor,
                  x0: torch.Tensor | None = None,
                  y0: torch.Tensor | None = None,
                  rho: float = 0.4, sigma: float = 1e-6, alpha: float = 1.6,
                  iters: int = 100) -> QPSolution:
    """OSQP ADMM splitting with a fixed iteration count, on lanes: P
    (..., n, n), q (..., n), A (..., m, n), l and u (..., m). One Cholesky
    factorisation, as JAX's; where JAX solves with the factor every
    iteration, this multiplies by the inverse it gives once. The iteration
    is JAX's, each update written as one fused op where torch has one
    (`lerp` for the relaxation, `add(alpha=)` for a scaled sum), so the
    iterates agree with JAX's to round-off times K's condition number."""
    n = q.shape[-1]
    x = torch.zeros_like(q) if x0 is None else x0
    y = torch.zeros_like(l) if y0 is None else y0
    z = torch.clamp(mv(A, x), l, u)

    AT = A.mT
    K = P + sigma * torch.eye(n, dtype=q.dtype, device=q.device) \
        + rho * (AT @ A)
    # K's inverse from its Cholesky factor, once: each iteration's solve
    # is then one product (two triangular solves an iteration cost the
    # card ten times the launches).
    Kinv = spd_inv(K)
    neg_q = -q
    for _ in range(iters):
        # rhs = sigma x - q + A'(rho z - y), with the sign of the product
        # folded in: one kernel a term.
        rhs = torch.add(neg_q, x, alpha=sigma) \
            - mv(AT, torch.add(y, z, alpha=-rho))
        xt = mv(Kinv, rhs)
        zt = mv(A, xt)
        # OSQP over-relaxation: mix the auxiliary iterate with z, not Ax.
        x = torch.lerp(x, xt, alpha)
        z_relaxed = torch.lerp(z, zt, alpha)
        z = torch.clamp(torch.add(z_relaxed, y, alpha=1.0 / rho), l, u)
        y = torch.add(y, z_relaxed - z, alpha=rho)
    pri = torch.abs(mv(A, x) - z).amax(-1)
    dua = torch.abs(mv(P, x) + q + mv(AT, y)).amax(-1)
    return QPSolution(x=x, y=y, z=z, pri_res=pri, dua_res=dua)
