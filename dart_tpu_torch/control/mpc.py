"""Receding-horizon MPC front ends (port of `dart_tpu.control.mpc`).

Each controller is stateless: it holds the static problem structure, and
everything that evolves (warm start, previous tilt, RLS estimates,
governor reference, stiction integral) lives in an explicit carry. Every
carry, state and target has a leading lane axis. `PMPC`, `RMPC` and
`LMPC` are the JAX package's single-lane controllers, run on lanes as
`jax.vmap` runs them: each solve is `ilqr.solve`, linearised by autodiff.
The `*Batch` controllers are the batch-major ones, with the whole-solve
kernels. JAX's `while_loop`/`cond` become host loops that read the device
(`ilqr.host_bool`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from dart_tpu_torch.adapt.rls import RLSState, rls_init, rls_update
from dart_tpu_torch.control.reference import (build_ref_traj,
                                              reference_governor)
from dart_tpu_torch.models import dynamics as dyn
from dart_tpu_torch.ops.kernels.lmpc_solve import lmpc_solve
from dart_tpu_torch.ops.kernels.rmpc_solve import rmpc_solve
from dart_tpu_torch.solver import ilqr, pmpc_fast
from dart_tpu_torch.solver.ocp import (LMPCAux, PMPCAux, RMPCAux,
                                       make_lmpc_ocp, make_pmpc_ocp,
                                       make_rmpc_ocp, make_rmpc_ocp_du)

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


def _diag(sol: ilqr.ILQRSolution) -> SolveDiag:
    return SolveDiag(sol.cost, sol.viol, sol.iters, sol.grad_norm)


def _escalate(one_round: Callable[[torch.Tensor], tuple], first: tuple,
              needs_help: Callable[[tuple], bool], max_rounds: int):
    """Re-run `one_round(V)` (a tuple whose first element is V) while
    `needs_help(state)` holds, up to `max_rounds` extra rounds. Returns
    (final state tuple, rounds used).

    A host loop: `needs_help` returns a device boolean that each round
    reads. It must be NaN-safe (written as ~(x <= tol)), so a diverged lane
    escalates. Before each extra round, a lane whose V is not finite
    restarts cold from zeros, since a NaN warm start can never recover.
    """
    st, rounds = first, 0
    while rounds < max_rounds and ilqr.host_bool(needs_help(st)):
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


class PMPC:
    """Analytic tray-tilt MPC (nx=6, nu=2), one `ilqr.solve` per call on
    `make_pmpc_ocp`'s autodiff linearisation."""

    def __init__(self, N: int = 15, dt: float = 0.002, u_bound: float = 0.6,
                 cfg: ilqr.ILQRConfig = ilqr.ILQRConfig()):
        self.N, self.dt = N, dt
        self.ocp = make_pmpc_ocp(dt=dt, u_bound=u_bound)
        self.cfg = cfg

    def init_carry(self, B: int, dtype: torch.dtype,
                   device: torch.device | str) -> PMPCCarry:
        return PMPCCarry(V=torch.zeros((B, self.N, 2), dtype=dtype,
                                       device=device))

    def solve(self, carry: PMPCCarry, state: torch.Tensor,
              target: torch.Tensor, params: dyn.PMPCParams,
              weights: PMPCWeights):
        """state (B, 6), target (B, 6); params/weights leaves shared or per
        lane (B,). Returns (carry, u (B, 2), diag)."""
        aux = _pmpc_aux(state, target, weights)
        sol = ilqr.solve(self.ocp, self.cfg, params, aux, state, carry.V)
        return PMPCCarry(V=_shift(sol.V)), sol.V[:, 0], _diag(sol)


def _pmpc_aux(states: torch.Tensor, targets: torch.Tensor,
              weights: PMPCWeights) -> PMPCAux:
    B = states.shape[0]

    def bc(x):
        return torch.as_tensor(x, dtype=states.dtype,
                               device=states.device).expand(B)

    return PMPCAux(target=targets, Qp=bc(weights.Qp), Qv=bc(weights.Qv),
                   R=bc(weights.R))


class PMPCBatch:
    """Batch-major PMPC: one fused solve for a whole scenario batch.

    Three branches, chosen as in `dart_tpu`: the whole-solve kernel
    (`use_kernel`, `fast`, B % 128 == 0 and a python-float gravity), whose
    budget is kernel_iters x kernel_alphas with per-batch escalation while
    any lane's max |feedforward| exceeds `kernel_tol_grad`; else the
    structure-exploiting `pmpc_fast.solve_batch_fast` (`fast` and a
    python-float gravity); else the generic `ilqr.solve_batch`, which takes
    a per-lane gravity tensor. `cfg` governs the two non-kernel branches.
    """

    def __init__(self, N: int = 15, dt: float = 0.002, u_bound: float = 0.6,
                 cfg: ilqr.ILQRConfig = ilqr.ILQRConfig(max_iters=4),
                 fast: bool = True, use_kernel: bool = True,
                 kernel_iters: int = 2, kernel_alphas: int = 3,
                 kernel_tol_grad: float = 5e-3,
                 kernel_max_extra_rounds: int = 2):
        self.N, self.dt, self.u_bound = N, dt, u_bound
        self.ocp = make_pmpc_ocp(dt=dt, u_bound=u_bound)
        self.cfg = cfg
        self.fast = fast
        self.use_kernel = use_kernel
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
        dtype, device = states.dtype, states.device

        def bc(x):
            return torch.as_tensor(x, dtype=dtype, device=device).expand(B)

        aux = _pmpc_aux(states, targets, weights)
        g_static = params.g if isinstance(params.g, (int, float)) else None
        zero = torch.zeros((B,), dtype=dtype, device=device)
        if (self.use_kernel and self.fast and B % LANES == 0
                and g_static is not None):
            mu = bc(params.mu)

            def one_round(V):
                return pmpc_fast.solve_batch_kernel(
                    mu, aux, states, V, dt=self.dt, u_bound=self.u_bound,
                    n_iters=self.kernel_iters, n_alphas=self.kernel_alphas,
                    g=float(g_static))

            def needs_help(st):
                return ~(torch.max(st[2]) <= self.kernel_tol_grad)

            (V, cost, gnorm), rounds = _escalate(
                one_round, one_round(carry.V), needs_help,
                self.kernel_max_extra_rounds)
            iters = torch.full((B,), (1 + rounds) * self.kernel_iters,
                               dtype=torch.int32, device=device)
            diag = SolveDiag(cost, zero, iters, gnorm)
        elif self.fast and g_static is not None:
            V, _, cost = pmpc_fast.solve_batch_fast(
                bc(params.mu), aux, states, carry.V, dt=self.dt,
                u_bound=self.u_bound, max_iters=self.cfg.max_iters,
                g=float(g_static))
            diag = SolveDiag(cost, zero, torch.zeros(
                (B,), dtype=torch.int32, device=device), zero)
        else:
            sol = ilqr.solve_batch(self.ocp, self.cfg, params, aux, states,
                                   carry.V)
            V = sol.V
            diag = _diag(sol)
        return PMPCCarry(V=_shift(V)), V[:, 0], diag


# --------------------------------------------------------------------------
# RMPC (adaptive, with RLS + reference governor inside the carry)
# --------------------------------------------------------------------------

class RMPCWeights(NamedTuple):
    Qp: torch.Tensor | float
    Qv: torch.Tensor | float
    Ru: torch.Tensor | float
    Rdu: torch.Tensor | float


RMPC_DEFAULT_WEIGHTS = RMPCWeights(100.0, 1.0, 0.05, 1.0)


class RMPCCarry(NamedTuple):
    V: torch.Tensor                   # (B, N, 2) warm start (du sequence)
    u_prev: torch.Tensor              # (B, 2) previously applied tilt
    r_v: torch.Tensor                 # (B, 4) governor virtual reference
    rls_x: RLSState
    rls_y: RLSState
    prev_state: torch.Tensor          # (B, 4) for the acceleration estimate
    err_int: torch.Tensor | None = None   # (B, 2) anti-stiction offset


class RMPC:
    """Adaptive MPC: RLS update -> governor -> staged ref -> solve, one
    call per control step (`rob_ctrl.py:331-361`)."""

    def __init__(self, N: int = 20, dt: float = 0.002, u_bound: float = 0.4,
                 du_bound: float = 0.05, vmax: float = 0.25,
                 v_eps: float = 0.1, rls_lam: float = 0.995,
                 rls_P_max: float | None = 1e4, dr_max: float = 0.01,
                 rg_alpha: float = 0.5, step_fraction: float = 0.2,
                 slew_exact: bool = True, ki_stiction: float = 0.006,
                 stiction_vstall: float = 0.02,
                 stiction_deadzone: float = 0.004, int_max: float = 0.08,
                 stiction_decay: float = 0.98,
                 cfg: ilqr.ILQRConfig = ilqr.ILQRConfig()):
        self.N, self.dt, self.v_eps = N, dt, v_eps
        self.rls_lam, self.dr_max, self.rg_alpha = rls_lam, dr_max, rg_alpha
        # Covariance wind-up guard (adapt.rls.rls_update); None disables it.
        self.rls_P_max = rls_P_max
        self.step_fraction = step_fraction
        # Anti-stiction integral offset on the governed target: while an
        # axis is stalled (|v| < stiction_vstall) outside the deadzone, a
        # bounded offset integrates so the commanded tilt keeps growing
        # past breakaway; it leaks away once the object moves.
        # ki_stiction = 0 recovers the reference governor exactly.
        self.ki_stiction = ki_stiction
        self.stiction_vstall = stiction_vstall
        self.stiction_deadzone = stiction_deadzone
        self.int_max = int_max
        self.stiction_decay = stiction_decay
        self.u_bound = u_bound
        self.du_bound = du_bound
        self.vmax = vmax
        self.slew_exact = slew_exact
        if slew_exact:
            # Slew bounds exact in the DDP box QP.
            self.ocp = make_rmpc_ocp_du(dt=dt, u_bound=u_bound,
                                        du_bound=du_bound, vmax=vmax)
        else:
            # Slew as soft (AL) constraints, like IPOPT's g-bounds.
            self.ocp = make_rmpc_ocp(dt=dt, u_bound=u_bound,
                                     du_bound=du_bound, vmax=vmax)
        self.cfg = cfg

    def init_carry(self, state0: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> RMPCCarry:
        """Carry for states0 (..., 4): any leading batch shape."""
        state0 = torch.as_tensor(state0).to(dtype)
        batch, dev = state0.shape[:-1], state0.device
        rls = rls_init(7, dtype=dtype, device=dev, batch_shape=batch)
        mask = torch.tensor([1.0, 0.0, 1.0, 0.0], dtype=dtype, device=dev)
        return RMPCCarry(
            V=torch.zeros((*batch, self.N, 2), dtype=dtype, device=dev),
            u_prev=torch.zeros((*batch, 2), dtype=dtype, device=dev),
            r_v=state0 * mask, rls_x=rls, rls_y=rls, prev_state=state0,
            err_int=torch.zeros((*batch, 2), dtype=dtype, device=dev))

    def _stiction_update(self, err_int: torch.Tensor, state: torch.Tensor,
                         target: torch.Tensor):
        """One anti-stiction integrator step on (..., 4) state/target;
        returns (err_int', target') with the offset on the positions."""
        pos = torch.stack([state[..., 0], state[..., 2]], -1)
        vel = torch.stack([state[..., 1], state[..., 3]], -1)
        err = torch.stack([target[..., 0], target[..., 2]], -1) - pos
        stalled = (torch.abs(vel) < self.stiction_vstall) & \
            (torch.abs(err) > self.stiction_deadzone)
        err_int = torch.where(stalled, err_int + self.ki_stiction * err,
                              self.stiction_decay * err_int)
        err_int = torch.clamp(err_int, -self.int_max, self.int_max)
        zero = torch.zeros_like(err_int[..., 0])
        target_aug = target + torch.stack(
            [err_int[..., 0], zero, err_int[..., 1], zero], -1)
        return err_int, target_aug

    def _front(self, carry: RMPCCarry, states: torch.Tensor,
               targets: torch.Tensor, weights: RMPCWeights):
        """The step before the solve: the RLS update from the
        finite-difference acceleration (features at the previous state;
        gravity not subtracted, `rob_ctrl.py:341-343`), the anti-stiction
        offset, the governor and the staged reference. states and targets
        (B, 4). Returns (params, aux, z0, the carry's new RLS, governor and
        stiction fields)."""
        B = states.shape[0]
        dtype, dev = states.dtype, states.device
        ax = (states[:, 1] - carry.prev_state[:, 1]) / self.dt
        ay = (states[:, 3] - carry.prev_state[:, 3]) / self.dt
        phi = dyn.rmpc_features(carry.prev_state, self.v_eps)
        rls_x = rls_update(carry.rls_x, phi, ax, self.rls_lam, self.rls_P_max)
        rls_y = rls_update(carry.rls_y, phi, ay, self.rls_lam, self.rls_P_max)
        theta = torch.cat([rls_x.theta, rls_y.theta], -1)
        err_int, target_aug = self._stiction_update(carry.err_int, states,
                                                    targets)
        r_v = reference_governor(carry.r_v, target_aug, self.dr_max,
                                 self.rg_alpha)
        refs = build_ref_traj(r_v, target_aug, self.N, self.step_fraction)

        def bc(x):
            return torch.as_tensor(x, dtype=dtype, device=dev).expand(B)

        params = dyn.RMPCParams(theta=theta, g=bc(dyn.GRAVITY_Z),
                                v_eps=bc(self.v_eps))
        w = RMPCWeights(*(bc(x) for x in weights))
        aux = RMPCAux(ref=refs, Qp=w.Qp, Qv=w.Qv, Ru=w.Ru, Rdu=w.Rdu)
        z0 = torch.cat([states, carry.u_prev], -1)
        return params, aux, z0, dict(r_v=r_v, rls_x=rls_x, rls_y=rls_y,
                                     prev_state=states, err_int=err_int)

    def _advance(self, carry: RMPCCarry, sol: ilqr.ILQRSolution,
                 fields: dict):
        """The applied tilt (slew-exact: u_prev + V[:, 0], clipped) and the
        next carry. Returns (carry', u (B, 2), diag)."""
        if self.slew_exact:
            u = torch.clamp(carry.u_prev + sol.V[:, 0], -self.u_bound,
                            self.u_bound)
        else:
            u = sol.V[:, 0]
        return (RMPCCarry(V=_shift(sol.V), u_prev=u, **fields), u,
                _diag(sol))

    def solve(self, carry: RMPCCarry, state: torch.Tensor,
              target: torch.Tensor,
              weights: RMPCWeights = RMPC_DEFAULT_WEIGHTS):
        """One control step: state and target (B, 4), one `ilqr.solve`
        with u_prev in the augmented initial state. Returns (carry',
        u (B, 2), diag)."""
        params, aux, z0, fields = self._front(carry, state, target, weights)
        sol = ilqr.solve(self.ocp, self.cfg, params, aux, z0, carry.V)
        return self._advance(carry, sol, fields)


class RMPCBatch(RMPC):
    """Batch-major RMPC: batched RLS/governor/reference, then one
    constrained solve for the whole batch. With `use_kernel` (default),
    `slew_exact` and B % 128 == 0, the complete solve (AL outer loop
    included) is one `rmpc_solve` launch per round, with escalation while
    any lane is non-stationary or infeasible, and (`kernel_xla_fallback`)
    a per-lane `ilqr.solve_batch` rescue of the lanes still flagged.
    Otherwise `ilqr.solve_batch` solves the batch."""

    def __init__(self, *args, kernel_iters: int = 6, kernel_alphas: int = 4,
                 kernel_al_rounds: int = 3, kernel_tol_grad: float = 5e-3,
                 kernel_max_extra_rounds: int = 2,
                 kernel_xla_fallback: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.kernel_iters = kernel_iters
        self.kernel_alphas = kernel_alphas
        self.kernel_al_rounds = kernel_al_rounds
        self.kernel_tol_grad = kernel_tol_grad
        self.kernel_max_extra_rounds = kernel_max_extra_rounds
        self.kernel_xla_fallback = kernel_xla_fallback

    def _rescue(self, bad, params, aux, z0, V, cost, viol, gnorm):
        """Re-solve the flagged lanes with `ilqr.solve_batch` and merge.
        solve_batch's lanes are independent (every update is masked per
        lane), so solving the flagged lanes alone gives each the answer it
        gets in a whole-batch solve."""
        idx = torch.nonzero(bad).squeeze(-1)

        def rows(tree):
            return type(tree)(*(x.index_select(0, idx)
                                if isinstance(x, torch.Tensor) else x
                                for x in tree))

        p_b, a_b, z_b = rows(params), rows(aux), z0.index_select(0, idx)
        V_b = V.index_select(0, idx)
        lane_ok = torch.isfinite(V_b.reshape(V_b.shape[0], -1)).all(dim=1)
        V_ws = torch.where(lane_ok[:, None, None], V_b, torch.zeros_like(V_b))
        sx = ilqr.solve_batch(self.ocp, self.cfg, p_b, a_b, z_b, V_ws)
        # sx.grad_norm is the raw feedforward norm, large at active slew
        # bounds even at the optimum; report the box-projected
        # stationarity instead, as the kernel's gnorm means.
        pg = ilqr.projected_grad_norm(self.ocp, p_b, a_b, z_b, sx.V)
        return (V.index_copy(0, idx, sx.V), cost.index_copy(0, idx, sx.cost),
                viol.index_copy(0, idx, sx.viol),
                gnorm.index_copy(0, idx, pg))

    def solve_batched(self, carry: RMPCCarry, states: torch.Tensor,
                      targets: torch.Tensor,
                      weights: RMPCWeights = RMPC_DEFAULT_WEIGHTS,
                      use_kernel: bool = True):
        """states (B, 4), targets (B, 4). Returns (carry', u (B, 2), diag)."""
        B = states.shape[0]
        dev = states.device
        params, aux, z0, fields = self._front(carry, states, targets, weights)
        theta, refs = params.theta, aux.ref
        if use_kernel and self.slew_exact and B % LANES == 0:
            wk = torch.stack([aux.Qp, aux.Qv, aux.Ru, aux.Rdu])
            th_bl, ref_bl = theta.T.contiguous(), \
                torch.movedim(refs, 0, -1).contiguous()
            z0_bl = z0.T.contiguous()

            def one_round(V):
                Vn, cost, viol, gn = rmpc_solve(
                    th_bl, ref_bl, wk, z0_bl,
                    torch.movedim(V, 0, -1).contiguous(), dt=self.dt,
                    u_bound=self.u_bound, du_bound=self.du_bound,
                    vmax=self.vmax, v_eps=self.v_eps,
                    n_iters=self.kernel_iters, n_alphas=self.kernel_alphas,
                    al_rounds=self.kernel_al_rounds,
                    mu_init=self.cfg.mu_init, mu_scale=self.cfg.mu_scale,
                    mu_max=self.cfg.mu_max, tol_con=self.cfg.tol_con)
                return torch.movedim(Vn, -1, 0), cost, viol, gn

            # Lanes need help when non-stationary or infeasible (NaN-safe).
            def needs_help(st):
                return ~(torch.max(st[2]) <= self.cfg.tol_con) | \
                    ~(torch.max(st[3]) <= self.kernel_tol_grad)

            (V, cost, viol, gnorm), rounds = _escalate(
                one_round, one_round(carry.V), needs_help,
                self.kernel_max_extra_rounds)
            if self.kernel_xla_fallback:
                bad = ~(viol <= self.cfg.tol_con) | \
                    ~(gnorm <= self.kernel_tol_grad)
                if ilqr.host_bool(bad.any()):
                    V, cost, viol, gnorm = self._rescue(
                        bad, params, aux, z0, V, cost, viol, gnorm)
            iters = torch.full(
                (B,), (1 + rounds) * self.kernel_iters * self.kernel_al_rounds,
                dtype=torch.int32, device=dev)
            sol = ilqr.ILQRSolution(V=V, Z=None, K=None, cost=cost,
                                    viol=viol, iters=iters, grad_norm=gnorm)
        else:
            sol = ilqr.solve_batch(self.ocp, self.cfg, params, aux, z0,
                                   carry.V)
        return self._advance(carry, sol, fields)


# --------------------------------------------------------------------------
# LMPC (RL-tuned model parameters; plan-shift on emulated solver lag)
# --------------------------------------------------------------------------

class LMPCWeights(NamedTuple):
    Q: torch.Tensor | tuple      # (8,) stage state weights
    R: torch.Tensor | tuple      # (4,) on [u0, u1, du0, du1]
    Qt: torch.Tensor | tuple     # (8,) terminal state weights


# Python floats, so the defaults carry no device or dtype.
LMPC_DEFAULT_WEIGHTS = LMPCWeights(
    Q=(200.0, 2.0, 200.0, 2.0, 0.0, 0.0, 0.0, 0.0),
    R=(0.1, 0.1, 1.0, 1.0),
    Qt=(200.0, 2.0, 200.0, 2.0, 0.0, 0.0, 0.0, 0.0),
)


class LMPCCarry(NamedTuple):
    V: torch.Tensor               # (..., N, 2) warm start
    U_plan: torch.Tensor          # (..., N, 2) last full plan (for shifting)
    plan_idx: torch.Tensor        # (...) int32: next index into the plan
    u_prev: torch.Tensor          # (..., 2) last applied control


class LMPC:
    """MPC over the 34-parameter learned model (nx=8, nu=2), one
    `ilqr.solve` per call."""

    def __init__(self, N: int = 20, dt: float = 0.002, u_bound: float = 0.4,
                 cfg: ilqr.ILQRConfig = ilqr.ILQRConfig(),
                 fast: bool = False):
        self.N, self.dt = N, dt
        self.ocp = make_lmpc_ocp(dt=dt, u_bound=u_bound, fast=fast)
        self.cfg = cfg

    def init_carry(self, B: int, dtype: torch.dtype,
                   device: torch.device | str) -> LMPCCarry:
        z = torch.zeros((B, self.N, 2), dtype=dtype, device=device)
        return LMPCCarry(
            V=z, U_plan=z.clone(),
            plan_idx=torch.zeros((B,), dtype=torch.int32, device=device),
            u_prev=torch.zeros((B, 2), dtype=dtype, device=device))

    def _problem(self, carry: LMPCCarry, states: torch.Tensor,
                 targets: torch.Tensor, weights: LMPCWeights):
        """(aux, z0) of states and targets (B, 8), weights per lane."""
        B = states.shape[0]

        def bc(x, n):
            return torch.as_tensor(x, dtype=states.dtype,
                                   device=states.device).expand(B, n)

        aux = LMPCAux(target=targets, Q=bc(weights.Q, 8),
                      R=bc(weights.R, 4), Qt=bc(weights.Qt, 8))
        return aux, torch.cat([states, carry.u_prev], -1)

    @staticmethod
    def _advance(sol: ilqr.ILQRSolution):
        """Apply V[:, 0] and cache the whole plan for `shift_plan`."""
        u = sol.V[:, 0]
        plan_idx = torch.ones(u.shape[:1], dtype=torch.int32,
                              device=u.device)
        return (LMPCCarry(V=_shift(sol.V), U_plan=sol.V, plan_idx=plan_idx,
                          u_prev=u), u, _diag(sol))

    def solve(self, carry: LMPCCarry, state: torch.Tensor,
              target: torch.Tensor, pvec: torch.Tensor,
              weights: LMPCWeights = LMPC_DEFAULT_WEIGHTS):
        """state and target (B, 8), pvec (B, 34) raw parameters (or one
        (34,) vector shared by every lane). Returns (carry', u (B, 2),
        diag)."""
        aux, z0 = self._problem(carry, state, target, weights)
        return self._advance(ilqr.solve(self.ocp, self.cfg, pvec, aux, z0,
                                        carry.V))

    def shift_plan(self, carry: LMPCCarry):
        """Reuse the stale plan when the solver "missed its deadline":
        advance one step into the cached plan, holding the last entry
        (`rlmpc2.py:1013-1018`). Any leading lane shape, none included."""
        idx = torch.clamp_max(carry.plan_idx, self.N - 1)
        u = torch.take_along_dim(carry.U_plan, idx.long()[..., None, None],
                                 dim=-2)[..., 0, :]
        return carry._replace(plan_idx=idx + 1, u_prev=u), u


class LMPCBatch(LMPC):
    """Batch-major LMPC with per-lane 34-parameter vectors: one solve over
    the whole scenario batch. With `use_kernel` (default) and B % 128 == 0
    the complete solve is one `lmpc_solve` launch per round, kernel_iters x
    kernel_alphas, with up to `kernel_max_extra_rounds` warm re-solves while
    any lane's max |feedforward| exceeds `kernel_tol_grad`. Otherwise
    `ilqr.solve_batch` solves the batch, with the closed-form linearisation
    when `fast`, else `torch.func` autodiff; `cfg` governs that branch."""

    def __init__(self, N: int = 20, dt: float = 0.002, u_bound: float = 0.4,
                 cfg: ilqr.ILQRConfig = ilqr.ILQRConfig(), fast: bool = False,
                 kernel_iters: int = 2, kernel_alphas: int = 3,
                 kernel_tol_grad: float = 5e-3,
                 kernel_max_extra_rounds: int = 2):
        super().__init__(N=N, dt=dt, u_bound=u_bound, cfg=cfg, fast=fast)
        self.u_bound = u_bound
        self.kernel_iters = kernel_iters
        self.kernel_alphas = kernel_alphas
        self.kernel_tol_grad = kernel_tol_grad
        self.kernel_max_extra_rounds = kernel_max_extra_rounds

    def solve_batched(self, carry: LMPCCarry, states: torch.Tensor,
                      targets: torch.Tensor, pvecs: torch.Tensor,
                      weights: LMPCWeights = LMPC_DEFAULT_WEIGHTS,
                      use_kernel: bool = True):
        """states (B, 8), targets (B, 8), pvecs (B, 34) raw parameters.
        Returns (carry', u (B, 2), diag)."""
        B = states.shape[0]
        dtype, dev = states.dtype, states.device
        aux, z0 = self._problem(carry, states, targets, weights)
        if use_kernel and B % LANES == 0:
            pv, Q, R, Qt, tg, zl = (x.T.contiguous() for x in
                                    (pvecs, aux.Q, aux.R, aux.Qt, targets,
                                     z0))

            def one_round(V):
                Vn, cost, gn = lmpc_solve(
                    pv, Q, R, Qt, tg, zl, torch.movedim(V, 0, -1).contiguous(),
                    dt=self.dt, u_bound=self.u_bound,
                    n_iters=self.kernel_iters, n_alphas=self.kernel_alphas)
                return torch.movedim(Vn, -1, 0), cost, gn

            def needs_help(st):
                return ~(torch.max(st[2]) <= self.kernel_tol_grad)

            (V, cost, gnorm), rounds = _escalate(
                one_round, one_round(carry.V), needs_help,
                self.kernel_max_extra_rounds)
            iters = torch.full((B,), (1 + rounds) * self.kernel_iters,
                               dtype=torch.int32, device=dev)
            sol = ilqr.ILQRSolution(
                V=V, Z=None, K=None, cost=cost,
                viol=torch.zeros((B,), dtype=dtype, device=dev), iters=iters,
                grad_norm=gnorm)
        else:
            sol = ilqr.solve_batch(self.ocp, self.cfg, pvecs, aux, z0,
                                   carry.V)
        return self._advance(sol)
