"""Receding-horizon PMPC front end for a scenario batch (port of the PMPC
part of `dart_tpu.control.mpc`).

The controller is stateless: it holds the static problem structure, and
the warm-start trajectory lives in an explicit `PMPCCarry`. Only the
whole-solve kernel branch of `PMPCBatch` is ported; the other branches
raise `NotImplementedError` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from dart_tpu_torch.models import dynamics as dyn
from dart_tpu_torch.solver import ilqr, pmpc_fast
from dart_tpu_torch.solver.ocp import PMPCAux, make_pmpc_ocp

LANES = 128


class SolveDiag(NamedTuple):
    cost: torch.Tensor
    viol: torch.Tensor
    iters: torch.Tensor
    grad_norm: torch.Tensor


def _shift(V: torch.Tensor) -> torch.Tensor:
    """Receding-horizon warm start along the horizon axis (-2): drop stage
    0, repeat the tail. Takes (N, 2) or (B, N, 2)."""
    return torch.cat([V[..., 1:, :], V[..., -1:, :]], dim=-2)


def _escalate(one_round: Callable[[torch.Tensor], tuple], first: tuple,
              needs_help: Callable[[tuple], bool], max_rounds: int):
    """Re-run `one_round(V)` (a tuple whose first element is V) while
    `needs_help(state)` holds, up to `max_rounds` extra rounds. Returns
    (final state tuple, rounds used).

    A host loop: `needs_help` reads the device, so each round syncs.
    `needs_help` must be NaN-safe (written as ~(x <= tol)), so a diverged
    lane escalates. Before each extra round, a lane whose V is not finite
    restarts cold from zeros, since a NaN warm start can never recover.
    """
    st, rounds = first, 0
    while rounds < max_rounds and needs_help(st):
        V = st[0]
        lane_ok = torch.isfinite(V.reshape(V.shape[0], -1)).all(dim=1)
        V = torch.where(lane_ok[:, None, None], V, torch.zeros_like(V))
        st, rounds = one_round(V), rounds + 1
    return st, rounds


class PMPCWeights(NamedTuple):
    """Per-object tuning table entries (`PMPC/main_parallel.py:107-122`)."""

    Qp: torch.Tensor | float
    Qv: torch.Tensor | float
    R: torch.Tensor | float


# Reference tables: cube(600,5,.1) cylinder(400,2.5,.2) sphere(200,2,.2)
# general(300,2,.2). Python floats, so they carry no device or dtype.
PMPC_WEIGHTS = {
    "cube": PMPCWeights(600.0, 5.0, 0.1),
    "cylinder": PMPCWeights(400.0, 2.5, 0.2),
    "sphere": PMPCWeights(200.0, 2.0, 0.2),
    "general": PMPCWeights(300.0, 2.0, 0.2),
}


def pmpc_schedule_weights(weights: PMPCWeights, mu, sliding,
                          mu_breakaway: float = 0.15, qp_boost: float = 1.5,
                          r_cut: float = 0.5) -> PMPCWeights:
    """High-friction weight schedule: for objects that must slide to move
    at mu >= `mu_breakaway`, scale Qp up and R down, leaving low-friction
    lanes untouched. `mu`/`sliding` may be per-lane tensors; the result
    takes mu's dtype and device."""
    mu = torch.as_tensor(mu)
    boost = torch.as_tensor(sliding, device=mu.device) & (mu >= mu_breakaway)
    one = torch.ones((), dtype=mu.dtype, device=mu.device)
    Qp = torch.as_tensor(weights.Qp, dtype=mu.dtype, device=mu.device)
    R = torch.as_tensor(weights.R, dtype=mu.dtype, device=mu.device)
    return PMPCWeights(Qp=Qp * torch.where(boost, qp_boost * one, one),
                       Qv=weights.Qv,
                       R=R * torch.where(boost, r_cut * one, one))


class PMPCCarry(NamedTuple):
    V: torch.Tensor               # (B, N, 2) warm-start control trajectory


class PMPCBatch:
    """Batch-major PMPC: one whole-solve kernel launch per round for the
    whole scenario batch, plus per-lane escalation.

    The iteration budget is kernel_iters x kernel_alphas. While any lane's
    kernel-reported max |feedforward| exceeds `kernel_tol_grad`, the batch
    re-solves warm, up to `kernel_max_extra_rounds` extra rounds.
    Gravity comes from params.g and must be a python float (the kernel
    takes it as a constant). `cfg` governs only the non-kernel branches,
    which are not ported; it is kept so callers construct the controller
    as they do in `dart_tpu`.
    """

    def __init__(self, N: int = 15, dt: float = 0.002, u_bound: float = 0.6,
                 cfg: ilqr.ILQRConfig = ilqr.ILQRConfig(max_iters=4),
                 fast: bool = True, use_kernel: bool = True,
                 kernel_iters: int = 2, kernel_alphas: int = 3,
                 kernel_tol_grad: float = 5e-3,
                 kernel_max_extra_rounds: int = 2):
        if not fast:
            raise NotImplementedError(
                "fast=False needs ilqr.solve_batch (ROADMAP Queue 1 item 7, "
                "RMPC slice); only the whole-solve kernel branch is ported")
        if not use_kernel:
            raise NotImplementedError(
                "use_kernel=False needs pmpc_fast.solve_batch_fast (ROADMAP "
                "Queue 2 item 2, Riccati kernel); only the whole-solve "
                "kernel branch is ported")
        self.N, self.dt, self.u_bound = N, dt, u_bound
        self.ocp = make_pmpc_ocp(dt=dt, u_bound=u_bound)
        self.cfg = cfg
        self.kernel_iters = kernel_iters
        self.kernel_alphas = kernel_alphas
        self.kernel_tol_grad = kernel_tol_grad
        self.kernel_max_extra_rounds = kernel_max_extra_rounds

    def init_carry(self, B: int, dtype: torch.dtype,
                   device: torch.device | str) -> PMPCCarry:
        return PMPCCarry(V=torch.zeros((B, self.N, 2), dtype=dtype,
                                       device=device))

    def solve(self, carry: PMPCCarry, states: torch.Tensor,
              targets: torch.Tensor, params: dyn.PMPCParams,
              weights: PMPCWeights):
        """states (B, 6), targets (B, 6); params/weights leaves either
        scalar (shared) or batched (B,). Returns (carry, u (B, 2), diag)."""
        B = states.shape[0]
        if B % LANES != 0:
            raise NotImplementedError(
                f"B={B} is not a multiple of {LANES}: that branch needs "
                "pmpc_fast.solve_batch_fast (ROADMAP Queue 2 item 2, "
                "Riccati kernel)")
        if not isinstance(params.g, (int, float)):
            raise NotImplementedError(
                "params.g as a tensor needs ilqr.solve_batch (ROADMAP "
                "Queue 1 item 7, RMPC slice); pass gravity as a python "
                "float")
        dtype, device = states.dtype, states.device

        def bc(x):
            return torch.as_tensor(x, dtype=dtype, device=device).expand(B)

        aux = PMPCAux(target=targets, Qp=bc(weights.Qp), Qv=bc(weights.Qv),
                      R=bc(weights.R))
        mu = bc(params.mu)

        def one_round(V):
            return pmpc_fast.solve_batch_kernel(
                mu, aux, states, V, dt=self.dt, u_bound=self.u_bound,
                n_iters=self.kernel_iters, n_alphas=self.kernel_alphas,
                g=float(params.g))

        def needs_help(st):
            return not bool(torch.max(st[2]) <= self.kernel_tol_grad)

        (V, cost, gnorm), rounds = _escalate(
            one_round, one_round(carry.V), needs_help,
            self.kernel_max_extra_rounds)
        iters = torch.full((B,), (1 + rounds) * self.kernel_iters,
                           dtype=torch.int32, device=device)
        diag = SolveDiag(cost, torch.zeros((B,), dtype=dtype, device=device),
                         iters, gnorm)
        return PMPCCarry(V=_shift(V)), V[:, 0], diag
