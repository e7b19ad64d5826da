"""MPPI (Model Predictive Path Integral) sampling solver (port of
`dart_tpu.solver.mppi`).

A derivative-free alternative to box-DDP on the same OCPs: K perturbed
control sequences per lane roll out as one batched rollout on a (lane x
sample) axis through the OCP's `step` and `stage_cost`, their costs are
weighted by a softmin of temperature lambda, and the nominal sequence
moves to the weighted mean. Receding-horizon warm start: shift the
nominal sequence one stage.

The noise is an argument, (n_iters, K, N, nu) shared by every lane or
(B, n_iters, K, N, nu) per lane, already scaled by sigma: a caller draws it
from an explicit `torch.Generator` (`make_controller` does), or passes the
JAX package's own draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dart_tpu_torch.solver.ilqr import OCPDef


class MPPIConfig(NamedTuple):
    n_samples: int = 256
    temperature: float = 0.1      # lambda: softmin sharpness
    sigma: float = 0.05           # exploration std per control channel
    n_iters: int = 1              # importance-sampling refinements per solve


def ocp_nu(ocp: OCPDef) -> int:
    return len(ocp.u_lo)


def _repeat_lanes(tree, B: int, K: int):
    """Each leaf with a leading lane axis (B, ...) repeated K times per lane
    to (B*K, ...), lane-major; other leaves (python scalars, shared
    tensors) as they are."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_repeat_lanes(x, B, K) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_repeat_lanes(x, B, K) for x in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() >= 1 and \
            tree.shape[0] == B:
        return tree.repeat_interleave(K, dim=0)
    return tree


def _rollout_cost(ocp: OCPDef, params, aux, z0: torch.Tensor,
                  U: torch.Tensor) -> torch.Tensor:
    """Cost of each row's open-loop rollout: z0 (R, nz), U (R, N, nu) ->
    (R,), the stage costs summed in stage order, then the terminal cost."""
    z, cost = z0, None
    for k in range(U.shape[1]):
        c = ocp.stage_cost(z, U[:, k], k, aux)
        cost = c if cost is None else cost + c
        z = ocp.step(z, U[:, k], params)
    return cost + ocp.term_cost(z, aux)


def solve(ocp: OCPDef, cfg: MPPIConfig, params, aux, z0: torch.Tensor,
          U_nominal: torch.Tensor, noise: torch.Tensor):
    """One MPPI solve of each lane: z0 (B, nz), U_nominal (B, N, nu),
    params/aux per lane (B, ...) or shared, `noise` the sigma-scaled
    perturbations (n_iters, K, N, nu) or (B, n_iters, K, N, nu). Each
    iteration clips the perturbed sequences to the box, rolls the B*K rows
    out at once, weights them by exp(-(cost - min cost) / temperature) and
    takes the clipped weighted mean. Returns (U_new (B, N, nu), the last
    iteration's weighted cost (B,))."""
    B, N, nu = U_nominal.shape
    K = cfg.n_samples
    u_lo = torch.tensor(ocp.u_lo, dtype=U_nominal.dtype,
                        device=U_nominal.device)
    u_hi = torch.tensor(ocp.u_hi, dtype=U_nominal.dtype,
                        device=U_nominal.device)
    if noise.dim() == 4:
        noise = noise.expand(B, *noise.shape)
    if tuple(noise.shape) != (B, cfg.n_iters, K, N, nu):
        raise ValueError(f"noise must be ({cfg.n_iters}, {K}, {N}, {nu}) or "
                         f"({B}, {cfg.n_iters}, {K}, {N}, {nu}), got "
                         f"{tuple(noise.shape)}")
    params_r = _repeat_lanes(params, B, K)
    aux_r = _repeat_lanes(aux, B, K)
    z0_r = z0.repeat_interleave(K, dim=0)
    U, cost = U_nominal, None
    for i in range(cfg.n_iters):
        Us = torch.clamp(U[:, None] + noise[:, i], u_lo, u_hi)
        costs = _rollout_cost(ocp, params_r, aux_r, z0_r,
                              Us.reshape(B * K, N, nu)).reshape(B, K)
        beta = torch.amin(costs, dim=1, keepdim=True)
        w = torch.exp(-(costs - beta) / cfg.temperature)
        w = w / torch.sum(w, dim=1, keepdim=True)
        U = torch.clamp(torch.einsum("bk,bknu->bnu", w, Us), u_lo, u_hi)
        cost = torch.sum(w * costs, dim=1)
    return U, cost


def shift(U: torch.Tensor) -> torch.Tensor:
    """(B, N, nu) -> the sequence one stage on, its last stage repeated."""
    return torch.cat([U[:, 1:], U[:, -1:]], dim=1)


class MPPICarry(NamedTuple):
    U: torch.Tensor              # (B, N, nu) nominal sequence
    gen: torch.Generator         # draws the perturbations


def draw_noise(cfg: MPPIConfig, gen: torch.Generator, shape: tuple, N: int,
               nu: int, dtype, device) -> torch.Tensor:
    """sigma * N(0, 1) perturbations (*shape, n_iters, K, N, nu) from
    `gen`, on `gen`'s device, then moved to `device`."""
    eps = torch.randn((*shape, cfg.n_iters, cfg.n_samples, N, nu),
                      generator=gen, dtype=dtype, device=gen.device)
    return (cfg.sigma * eps).to(device)


def make_controller(ocp: OCPDef, cfg: MPPIConfig, N: int):
    """Receding-horizon front end: (init_carry, step) with
    `init_carry(gen, B, dtype, device)` and `step(carry, params, aux, z0,
    noise=None) -> (carry, u (B, nu), cost (B,))`. Without `noise` each
    lane draws its own perturbations from the carry's generator."""
    nu = ocp_nu(ocp)

    def init_carry(gen: torch.Generator, B: int, dtype=torch.float32,
                   device=None) -> MPPICarry:
        dev = gen.device if device is None else device
        return MPPICarry(U=torch.zeros((B, N, nu), dtype=dtype, device=dev),
                         gen=gen)

    def step(carry: MPPICarry, params, aux, z0, noise=None):
        if noise is None:
            noise = draw_noise(cfg, carry.gen, (carry.U.shape[0],), N, nu,
                               carry.U.dtype, carry.U.device)
        U, cost = solve(ocp, cfg, params, aux, z0, carry.U, noise)
        return MPPICarry(U=shift(U), gen=carry.gen), U[:, 0], cost

    return init_carry, step
