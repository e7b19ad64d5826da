"""Batched constrained trajectory optimisation: box-DDP with an
augmented-Lagrangian outer loop (port of `dart_tpu.solver.ilqr`).

Batch-first throughout: z (B, nz), V (B, N, nu), per-lane cost data and
parameters with a leading batch axis, or python scalars that broadcast.
The Riccati backward pass is `ops.kernels.riccati.riccati_backward` (its
CUDA kernel on a card, its plain version on the CPU) for every shape the
kernel has an instance for (nu == 2, nz in `NZ_INSTANCES`), and the same
stage recursion in plain torch (`riccati._backward_lanes`, JAX's generic
`_backward`) for any other shape, chosen by shape as JAX's `pallas_ok`
chooses. Linearisation is the OCP's closed form when it gives one, else
`torch.func.jacfwd`/`hessian` under `torch.func.vmap` over lanes and
stages. JAX's `while_loop`s become host loops; each loop test reads the
device (`host_bool`). `solve` is `vmap(solve)` of the JAX package on a
leading lane axis, `solve_batch` its batch-major solve; the two differ in
what a finished lane keeps.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from dart_tpu_torch.ops.kernels.riccati import (NZ_INSTANCES, _backward_lanes,
                                                _reg_lanes, riccati_backward)


class OCPDef(NamedTuple):
    """A discrete-time optimal-control problem over horizon N.

    `step(z, v, params)`, `stage_cost(z, v, k, aux)`, `term_cost(z, aux)`
    and `constraints(z, v, k, aux)` (c <= 0, n_con rows, stages 0..N-1)
    act on a batch (B, ...) or on one lane under `torch.func.vmap`. The
    optional closed-form linearisation, used by `_linearize` in place of
    autodiff when set:
      dyn_jac(z, v, params) -> (A (nz,nz), B (nz,nu)) of the discrete step;
      cost_quad(k, z, v, lam_k, mu, aux) -> (lz, lv, lzz, lvz, lvv) of the
        AL-penalised stage cost; term_quad(z, aux) -> (gz, gzz).
    """

    step: Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]
    stage_cost: Callable[[torch.Tensor, torch.Tensor, Any, Any], torch.Tensor]
    term_cost: Callable[[torch.Tensor, Any], torch.Tensor]
    u_lo: tuple
    u_hi: tuple
    constraints: Optional[Callable] = None
    n_con: int = 0
    dyn_jac: Optional[Callable] = None
    cost_quad: Optional[Callable] = None
    term_quad: Optional[Callable] = None


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


class ILQRSolution(NamedTuple):
    V: torch.Tensor          # (B, N, nu) optimal open-loop controls
    Z: torch.Tensor | None   # (B, N+1, nz) state trajectory
    K: torch.Tensor | None   # (B, N, nu, nz) feedback gains
    cost: torch.Tensor       # (B,) unpenalised cost
    viol: torch.Tensor       # (B,) max inequality violation
    iters: torch.Tensor      # (B,) inner iterations used
    grad_norm: torch.Tensor  # (B,) final max |feedforward|


def host_bool(t: torch.Tensor) -> bool:
    """Read a device boolean on the host. Each call is a host-device sync,
    counted in `host_bool.count`."""
    host_bool.count += 1
    return bool(t)


host_bool.count = 0


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    return torch.minimum(torch.maximum(x, lo), hi)


def _al_penalty(c: torch.Tensor, lam: torch.Tensor,
                mu: torch.Tensor) -> torch.Tensor:
    """Powell-Hestenes-Rockafellar penalty for c <= 0, summed over the last
    axis; mu has c's shape without it."""
    t = torch.maximum(torch.zeros_like(c), lam + mu[..., None] * c)
    return torch.sum(t * t - lam * lam, dim=-1) / (2.0 * mu)


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


def _total_cost(ocp: OCPDef, params, aux, Z, V, lam, mu) -> torch.Tensor:
    """Per-lane AL-penalised cost (B,)."""
    cs = []
    for k in range(V.shape[1]):
        c = ocp.stage_cost(Z[:, k], V[:, k], k, aux)
        if ocp.n_con:
            c = c + _al_penalty(ocp.constraints(Z[:, k], V[:, k], k, aux),
                                lam[:, k], mu)
        cs.append(c)
    return torch.sum(torch.stack(cs, dim=-1), dim=-1) + \
        ocp.term_cost(Z[:, -1], aux)


def _batch_axes(tree, B: int):
    """vmap in_dims for a params/aux NamedTuple: leaves whose leading dim
    is B are batched, everything else (python scalars, shared tensors) is
    broadcast. A shared leaf whose first dim happens to be B would be
    misread, as in the JAX package: batch every leaf or none."""
    def ax(x):
        return 0 if (isinstance(x, torch.Tensor) and x.dim() >= 1
                     and x.shape[0] == B) else None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(ax(x) for x in tree))
    return ax(tree)


def _linearize(ocp: OCPDef, params, aux, Z, V, lam, mu):
    """Stage-wise Jacobians of the dynamics and quadratic expansion of the
    AL cost, batch-first: A (B,N,nz,nz), B (B,N,nz,nu), lx (B,N,nz),
    lu (B,N,nu), lxx, lux (B,N,nu,nz), luu, gx (B,nz), gxx (B,nz,nz)."""
    Bt, N = V.shape[0], V.shape[1]
    nz = Z.shape[-1]
    ks = torch.arange(N, device=V.device)

    def lane(p, a, Zl, Vl, laml, mul):
        if ocp.dyn_jac is not None:
            def dyn_jac(z, v):
                return ocp.dyn_jac(z, v, p)
        else:
            def dyn_jac(z, v):
                return jacfwd(ocp.step, argnums=(0, 1))(z, v, p)
        A, Bm = vmap(dyn_jac)(Zl[:-1], Vl)

        if ocp.cost_quad is not None:
            def cost_quad(k, z, v, lam_k):
                return ocp.cost_quad(k, z, v, lam_k, mul, a)
        else:
            def cost_quad(k, z, v, lam_k):
                def l_of(zv):
                    zz, vv = zv[:nz], zv[nz:]
                    c = ocp.stage_cost(zz, vv, k, a)
                    if ocp.n_con:
                        c = c + _al_penalty(ocp.constraints(zz, vv, k, a),
                                            lam_k, mul)
                    return c

                # The gradient is the primal of the Hessian's forward pass.
                def g_twice(zv):
                    g = grad(l_of)(zv)
                    return g, g

                H, g = jacfwd(g_twice, has_aux=True)(torch.cat([z, v]))
                return g[:nz], g[nz:], H[:nz, :nz], H[nz:, :nz], H[nz:, nz:]
        lx, lu, lxx, lux, luu = vmap(cost_quad)(ks, Zl[:-1], Vl, laml)

        if ocp.term_quad is not None:
            gx, gxx = ocp.term_quad(Zl[-1], a)
        else:
            def gt_twice(z):
                g = grad(ocp.term_cost)(z, a)
                return g, g

            gxx, gx = jacfwd(gt_twice, has_aux=True)(Zl[-1])
        return A, Bm, lx, lu, lxx, lux, luu, gx, gxx

    return vmap(lane, in_dims=(_batch_axes(params, Bt), _batch_axes(aux, Bt),
                               0, 0, 0, 0))(params, aux, Z, V, lam, mu)


def _batch_last(x: torch.Tensor) -> torch.Tensor:
    return torch.movedim(x, 0, -1).contiguous()


def kernel_route(nz: int, nu: int) -> bool:
    """Whether a backward pass of this shape goes through
    `riccati_backward` (the kernel's instances), or else the plain
    recursion."""
    return nu == 2 and nz in NZ_INSTANCES


def backward(derivs, V, u_lo: tuple, u_hi: tuple, reg: torch.Tensor):
    """Batch-first Riccati sweep: one `riccati_backward` call where
    `kernel_route` holds, else the same stage recursion in plain torch
    (`riccati._backward_lanes`, any nz and nu).
    Returns D (B,N,nu), K (B,N,nu,nz)."""
    lanes = [_batch_last(d) for d in derivs]
    Vl = _batch_last(V)
    if kernel_route(derivs[0].shape[-1], V.shape[-1]):
        D, K = riccati_backward(*lanes, Vl, u_lo, u_hi, reg)
    else:
        Bt = V.shape[0]

        def box(b):
            return torch.tensor(b, dtype=V.dtype, device=V.device)[
                :, None].expand(-1, Bt)

        D, K = _backward_lanes(*lanes, Vl, box(u_lo), box(u_hi),
                               _reg_lanes(reg, Bt, V))
    return torch.movedim(D, -1, 0), torch.movedim(K, -1, 0)


def _forward(ocp, params, aux, Z, V, D, Ks, lam, mu, al, u_lo, u_hi):
    """Closed-loop rollout with clipped controls at per-lane step al (B,)."""
    z = Z[:, 0]
    zs, vs = [z], []
    for k in range(V.shape[1]):
        dz = (Ks[:, k] @ (z - Z[:, k])[..., None])[..., 0]
        v = _clip(V[:, k] + al[:, None] * D[:, k] + dz, u_lo, u_hi)
        z = ocp.step(z, v, params)
        zs.append(z)
        vs.append(v)
    Zn, Vn = torch.stack(zs, dim=1), torch.stack(vs, dim=1)
    return Zn, Vn, _total_cost(ocp, params, aux, Zn, Vn, lam, mu)


def _alphas(n: int, dtype, device) -> torch.Tensor:
    return torch.pow(0.6, torch.arange(n, dtype=torch.float64,
                                       device=device)).to(dtype)


def _backtrack(ocp, params, aux, Z, V, D, Ks, lam, mu, cost, alphas, u_lo,
               u_hi, skip):
    """Per-lane backtracking: each lane not in `skip` takes the first alpha
    whose trial beats its cost by 1e-12, trying them in order until every
    lane has one or the schedule ends; one host read per trial. Returns
    (accepted, Z, V, cost); a lane without a trial keeps its inputs."""
    B = V.shape[0]
    i, acc = 0, skip
    Zb, Vb, cb = Z, V, cost
    while i < alphas.shape[0] and not host_bool(acc.all()):
        Zc, Vc, cc = _forward(ocp, params, aux, Z, V, D, Ks, lam, mu,
                              alphas[i].expand(B), u_lo, u_hi)
        newly = (~acc) & (cc < cost - 1e-12)
        Zb = torch.where(newly[:, None, None], Zc, Zb)
        Vb = torch.where(newly[:, None, None], Vc, Vb)
        cb = torch.where(newly, cc, cb)
        acc = acc | newly
        i += 1
    return acc, Zb, Vb, cb


def _parallel(ocp, params, aux, Z, V, D, Ks, lam, mu, alphas, u_lo, u_hi):
    """Every alpha's trial, then per lane the one of least cost (argmin:
    the first on ties, a NaN cost wins, as `jnp.argmin`). Returns (Z, V,
    cost) of that trial."""
    B = V.shape[0]
    trials = [_forward(ocp, params, aux, Z, V, D, Ks, lam, mu, a.expand(B),
                       u_lo, u_hi) for a in alphas]
    costs = torch.stack([t[2] for t in trials])               # (n_alphas, B)
    best = torch.argmin(costs, dim=0)
    lane = torch.arange(B, device=V.device)
    return (torch.stack([t[0] for t in trials])[best, lane],
            torch.stack([t[1] for t in trials])[best, lane],
            costs[best, lane])


def _al_rounds(ocp: OCPDef, cfg: ILQRConfig, aux, V: torch.Tensor,
               inner: Callable) -> ILQRSolution:
    """The augmented-Lagrangian outer loop around `inner(V, lam, mu) ->
    (Z, V, K, iters, gnorm)`, with per-lane multipliers and penalties
    (`cfg.al_iters` rounds); an OCP with n_con == 0 runs `inner` once on
    the placeholder lam (B, N, 1) and mu = 1. `iters` is one count for the
    batch (an int) or per lane ((B,) int32); the solution's K and
    grad_norm are the last round's, its cost the unpenalised one."""
    B, N, _ = V.shape
    dtype, dev = V.dtype, V.device

    def lanes(it):
        if isinstance(it, torch.Tensor):
            return it.to(torch.int32)
        return torch.full((B,), it, dtype=torch.int32, device=dev)

    if ocp.n_con == 0:
        lam0 = torch.zeros((B, N, 1), dtype=dtype, device=dev)
        mu0 = torch.ones((B,), dtype=dtype, device=dev)
        Z, V, K, it, gnorm = inner(V, lam0, mu0)
        return ILQRSolution(
            V=V, Z=Z, K=K, cost=_raw_cost(ocp, aux, Z, V),
            viol=torch.zeros((B,), dtype=dtype, device=dev),
            iters=lanes(it), grad_norm=gnorm)

    lam = torch.zeros((B, N, ocp.n_con), dtype=dtype, device=dev)
    mu = torch.full((B,), cfg.mu_init, dtype=dtype, device=dev)
    tot_it = 0
    for _ in range(cfg.al_iters):
        Z, V, K, it, gnorm = inner(V, lam, mu)
        C = torch.stack([ocp.constraints(Z[:, k], V[:, k], k, aux)
                         for k in range(N)], dim=1)        # (B, N, n_con)
        lam = torch.clamp_min(lam + mu[:, None, None] * C, 0.0)
        viol = torch.amax(torch.clamp_min(C, 0.0), dim=(1, 2))
        mu = torch.where(viol > cfg.tol_con,
                         torch.clamp_max(mu * cfg.mu_scale, cfg.mu_max), mu)
        tot_it = tot_it + it
    return ILQRSolution(
        V=V, Z=Z, K=K, cost=_raw_cost(ocp, aux, Z, V), viol=viol,
        iters=lanes(tot_it), grad_norm=gnorm)


def solve_batch(ocp: OCPDef, cfg: ILQRConfig, params, aux, z0: torch.Tensor,
                V_init: torch.Tensor) -> ILQRSolution:
    """Batch-major solve with per-lane regularisation, backtracking,
    acceptance and convergence masks; OCPs with n_con > 0 run the
    augmented-Lagrangian outer loop with per-lane multipliers/penalties.
    The batch iterates while any lane is not done, and a done lane's
    regularisation and gnorm keep moving (only Z, V, K and cost freeze),
    as in `dart_tpu.solver.ilqr.solve_batch`; `iters` is the batch's count.

    params/aux: NamedTuples with batched (B, ...) or shared leaves;
    z0 (B, nz), V_init (B, N, nu). Returns a batched ILQRSolution.
    """
    B, N, nu = V_init.shape
    dtype, dev = V_init.dtype, V_init.device
    u_lo = torch.tensor(ocp.u_lo, dtype=dtype, device=dev)
    u_hi = torch.tensor(ocp.u_hi, dtype=dtype, device=dev)
    alphas = _alphas(cfg.n_alphas, dtype, dev)

    def inner(V, lam, mu):
        """Batched iLQR on the AL objective for fixed (lam, mu)."""
        Z = _rollout(ocp, params, z0, V)
        cost = _total_cost(ocp, params, aux, Z, V, lam, mu)
        K = torch.zeros((B, N, nu, Z.shape[-1]), dtype=dtype, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        reg = torch.full((B,), cfg.reg_init, dtype=dtype, device=dev)
        gnorm = torch.full((B,), float("inf"), dtype=dtype, device=dev)
        it = 0
        while it < cfg.max_iters and not host_bool(done.all()):
            derivs = _linearize(ocp, params, aux, Z, V, lam, mu)
            D, Ks = backward(derivs, V, ocp.u_lo, ocp.u_hi, reg)
            acc, Zb, Vb, cb = _backtrack(ocp, params, aux, Z, V, D, Ks, lam,
                                         mu, cost, alphas, u_lo, u_hi, done)
            improved = acc & (~done)
            Z = torch.where(improved[:, None, None], Zb, Z)
            V = torch.where(improved[:, None, None], Vb, V)
            K = torch.where(improved[:, None, None, None], Ks, K)
            gnorm = torch.amax(torch.abs(D), dim=(1, 2))
            cost_keep = torch.where(improved, cb, cost)
            rel = (cost - cost_keep) / (torch.abs(cost) + 1.0)
            done = done | (improved & (rel < cfg.tol_cost)) | \
                (gnorm < cfg.tol_step) | ((~improved) & (reg >= cfg.reg_max))
            reg = torch.where(improved,
                              torch.clamp_min(reg * cfg.reg_down, cfg.reg_min),
                              torch.clamp_max(reg * cfg.reg_up, cfg.reg_max))
            cost = cost_keep
            it += 1
        return Z, V, K, it, gnorm

    return _al_rounds(ocp, cfg, aux, _clip(V_init, u_lo, u_hi), inner)


def solve(ocp: OCPDef, cfg: ILQRConfig, params, aux, z0: torch.Tensor,
          V_init: torch.Tensor) -> ILQRSolution:
    """`jax.vmap(dart_tpu.solver.ilqr.solve)` on a leading lane axis: each
    lane runs its own iLQR (both line searches, `cfg.linesearch`) and AL
    rounds, and a lane whose loop has ended keeps its whole carry (Z, V,
    K, cost, iteration count, regularisation and gnorm) while the others
    go on. `iters` is each lane's own count summed over the AL rounds, and
    `grad_norm` the max |feedforward| of the lane's last executed
    iteration. Every backward pass is one `riccati_backward` call where
    the kernel has an instance for the shape (`kernel_route`), else its
    plain recursion.

    The loop reads "some lane still active" on the host once per
    iteration, and the backtracking search once per trial (`host_bool`).

    params/aux: NamedTuples with per-lane (B, ...) or shared leaves;
    z0 (B, nz), V_init (B, N, nu). Returns an ILQRSolution of (B, ...)
    leaves.
    """
    B, N, nu = V_init.shape
    dtype, dev = V_init.dtype, V_init.device
    u_lo = torch.tensor(ocp.u_lo, dtype=dtype, device=dev)
    u_hi = torch.tensor(ocp.u_hi, dtype=dtype, device=dev)
    alphas = _alphas(cfg.n_alphas, dtype, dev)

    def inner(V, lam, mu):
        Z = _rollout(ocp, params, z0, V)
        cost = _total_cost(ocp, params, aux, Z, V, lam, mu)
        K = torch.zeros((B, N, nu, Z.shape[-1]), dtype=dtype, device=dev)
        it = torch.zeros((B,), dtype=torch.int32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        reg = torch.full((B,), cfg.reg_init, dtype=dtype, device=dev)
        gnorm = torch.full((B,), float("inf"), dtype=dtype, device=dev)
        while True:
            active = (it < cfg.max_iters) & (~done)
            if not host_bool(active.any()):
                return Z, V, K, it, gnorm
            derivs = _linearize(ocp, params, aux, Z, V, lam, mu)
            D, Ks = backward(derivs, V, ocp.u_lo, ocp.u_hi, reg)
            if cfg.linesearch == "backtrack":
                _, Zb, Vb, cb = _backtrack(ocp, params, aux, Z, V, D, Ks,
                                           lam, mu, cost, alphas, u_lo, u_hi,
                                           ~active)
            else:
                Zb, Vb, cb = _parallel(ocp, params, aux, Z, V, D, Ks, lam,
                                       mu, alphas, u_lo, u_hi)
            improved = cb < cost - 1e-12
            gnorm_n = torch.amax(torch.abs(D), dim=(1, 2))
            rel = (cost - cb) / (torch.abs(cost) + 1.0)
            done_n = (improved & (rel < cfg.tol_cost)) | \
                (gnorm_n < cfg.tol_step) | ((~improved) & (reg >= cfg.reg_max))
            reg_n = torch.where(
                improved, torch.clamp_min(reg * cfg.reg_down, cfg.reg_min),
                torch.clamp_max(reg * cfg.reg_up, cfg.reg_max))
            # A lane whose loop has ended keeps its carry.
            step = active & improved
            Z = torch.where(step[:, None, None], Zb, Z)
            V = torch.where(step[:, None, None], Vb, V)
            K = torch.where(step[:, None, None, None], Ks, K)
            cost = torch.where(step, cb, cost)
            reg = torch.where(active, reg_n, reg)
            gnorm = torch.where(active, gnorm_n, gnorm)
            done = torch.where(active, done_n, done)
            it = it + active.to(torch.int32)

    return _al_rounds(ocp, cfg, aux, _clip(V_init, u_lo, u_hi), inner)


def projected_grad_norm(ocp: OCPDef, params, aux, z0: torch.Tensor,
                        V: torch.Tensor) -> torch.Tensor:
    """Per-lane first-order stationarity of the RAW objective at V:
    max |V - clip(V - dJ/dV, u_lo, u_hi)| over the horizon.

    Zero at a box-constrained optimum: the post-hoc certificate for the
    fixed-budget whole-solve kernels. dJ/dV is one reverse pass through the
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


def constraint_max(ocp: OCPDef, params, aux, z0: torch.Tensor,
                   V: torch.Tensor) -> torch.Tensor:
    """Per-lane max RAW constraint value (signed: negative = strictly
    feasible) along the trajectory induced by V. Returns (B,)."""
    Z = _rollout(ocp, params, z0, V)
    C = torch.stack([ocp.constraints(Z[:, k], V[:, k], k, aux)
                     for k in range(V.shape[1])], dim=1)
    return torch.amax(C, dim=(1, 2))
