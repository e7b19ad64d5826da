"""Scenario evaluation: closed-loop PMPC / RMPC against the tray-object
contact plant (port of `dart_tpu.rollout.evaluate`'s PMPC and RMPC
evaluators).

A scenario batch advances in one host loop: the plant at the 2 ms sim
cadence, one solve every `control_every` steps after `warmup_steps` of
rest, and the reference's metrics (steady-state error, convergence time,
control effort; `logger.py:154-176`) per lane at the end. JAX's
`lax.cond` on the step index is a host `if` here. Tensors follow the
scenario tensors' device.

Two kinds of evaluator share each loop. The per-scenario ones
(`make_pmpc_evaluator`, `make_rmpc_evaluator`) are JAX's single-episode
evaluators vmapped over the rows: one `PMPC.solve` / `RMPC.solve`
(`ilqr.solve`, its backward passes on the Riccati kernel on the card) per
control step. The batch ones solve with `PMPCBatch` / `RMPCBatch`, whose
whole-solve kernels run on the card when B % 128 == 0; their loop reads
nothing from the device beyond what the controllers' escalation reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dart_tpu_torch.control import mpc as mpc_mod
from dart_tpu_torch.models import dynamics as dyn
from dart_tpu_torch.physics import tray_object as to_mod
from dart_tpu_torch.rollout.metrics import Metrics, compute_metrics
from dart_tpu_torch.solver import ilqr


class PMPCScenarioResult(NamedTuple):
    metrics: Metrics
    final_p: torch.Tensor
    # Sticky contact-loss flag of the LMPC evaluator (None where not
    # tracked, as in both batch evaluators).
    contact_lost: torch.Tensor | None = None


def _shape_id(kappa_inv: torch.Tensor) -> torch.Tensor:
    """Shape from the kappa signature: cube (0,0), cylinder (k,0), sphere
    (k,k)."""
    return torch.where(kappa_inv[..., 1] > 0, 2,
                       torch.where(kappa_inv[..., 0] > 0, 1, 0))


def _select_weights(shape_id: torch.Tensor, dtype):
    """Per-object weight tables (`PMPC/main_parallel.py:107-135`) indexed
    by shape. The high-friction schedule is not applied: on the calibrated
    lag plant it parks the cube short of its target."""
    tab = torch.tensor([
        [600.0, 5.0, 0.1],    # cube
        [400.0, 2.5, 0.2],    # cylinder
        [200.0, 2.0, 0.2],    # sphere
    ], dtype=dtype, device=shape_id.device)
    row = tab[shape_id.long()]
    return mpc_mod.PMPCWeights(Qp=row[..., 0], Qv=row[..., 1], R=row[..., 2])


def _tray_params(shape_kappa_inv: torch.Tensor, mass: torch.Tensor,
                 mu: torch.Tensor, dtype, tray_lag=None):
    """Scenario rows -> TrayObjectParams with (B,) and (B, 2) leaves.
    `tray_lag` is an optional (omega_n, zeta[, fast_frac]) tuple of
    scalars or per-axis pairs. Default (None): the mass-interpolated
    `calibrated_lag(mass)` plus the fitted per-shape dissipation and
    backlash; `to_mod.LEGACY_TRAY_LAG` reproduces the r1/r2 artifacts
    (optimistic lag, no dissipation)."""
    B, dev = mass.shape[0], mass.device

    def axes(x):
        return torch.broadcast_to(
            torch.as_tensor(x, dtype=dtype, device=dev), (B, 2))

    def lanes(v):
        return torch.full((B,), v, dtype=dtype, device=dev)

    calibrated = tray_lag is None
    lag = to_mod.calibrated_lag(mass, dtype) if calibrated else tray_lag
    omega_n, zeta = lag[0], lag[1]
    lag_fast = lag[2] if len(lag) > 2 else 0.0
    if calibrated:
        shape_id = _shape_id(shape_kappa_inv).long()
        rr_tab = torch.tensor([to_mod.CALIBRATED_ROLL_RESIST[s]
                               for s in to_mod.SHAPES], dtype=dtype,
                              device=dev)
        sd_tab = torch.tensor([to_mod.CALIBRATED_SLIDE_DAMP[s]
                               for s in to_mod.SHAPES], dtype=dtype,
                              device=dev)
        roll_resist = rr_tab[shape_id]
        slide_damp = to_mod.calibrated_slide_damp(sd_tab[shape_id], mu,
                                                  dtype)
        roll_stick = to_mod.calibrated_roll_stick(shape_kappa_inv, mu,
                                                  dtype)
        back_w = axes(to_mod.CALIBRATED_BACK_W)
        back_gss = axes(to_mod.CALIBRATED_BACK_GSS)
    else:
        roll_resist, slide_damp = lanes(0.0), lanes(0.0)
        roll_stick, back_w, back_gss = axes(0.0), axes(0.0), axes(1.0)
    return to_mod.TrayObjectParams(
        mass=mass, mu=mu, kappa_inv=shape_kappa_inv, slip_eps=lanes(2e-3),
        omega_n=axes(omega_n), zeta=axes(zeta),
        tray_pos=torch.broadcast_to(
            torch.tensor([0.0, 0.0, 0.4], dtype=dtype, device=dev), (B, 3)),
        half_w=axes(0.025), h_com=lanes(0.025),
        topple_on=to_mod.topple_on_from_kappa(shape_kappa_inv),
        roll_resist=roll_resist, slide_damp=slide_damp,
        lag_fast=axes(lag_fast), roll_stick=roll_stick,
        stick_vel=lanes(5e-3), back_w=back_w, back_gss=back_gss)


def _solves_at(k: int, warmup_steps: int, control_every: int) -> bool:
    return k >= warmup_steps and (k - warmup_steps) % control_every == 0


def _trace_metrics(ps: torch.Tensor, us: torch.Tensor,
                   target_xy: torch.Tensor, dt: float, tol: float) -> Metrics:
    """Per-lane metrics of the tray-frame positions (T, B, 2) after each
    step and the applied controls (T, B, 2)."""
    zt = torch.zeros_like(ps[..., 0])
    X = torch.stack([ps[..., 0], zt, ps[..., 1], zt], -1)
    return compute_metrics(X, us, target_xy, dt, tol=tol)


def _lane_where(mask: torch.Tensor, a, b):
    """Per-lane select over NamedTuples of leading-B leaves (nested
    tuples recurse, None stays None)."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return type(a)(*(_lane_where(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _pmpc_episodes(ctlr, n_steps: int, dt: float, control_every: int,
                   warmup_steps: int, tol: float, tray_lag):
    """The PMPC evaluators' episode loop around `ctlr` (`PMPC` or
    `PMPCBatch`): `ctlr.solve` per control step, per-object weights per
    lane, the model's friction the plant's. Returns `evaluate(kappa_inv
    (B,2), mass (B,), mu (B,), target_xy (B,2)) -> PMPCScenarioResult` with
    per-lane Metrics."""

    def evaluate(shape_kappa_inv, mass, mu, target_xy):
        dtype, dev = mass.dtype, mass.device
        B = mass.shape[0]
        obj_params = _tray_params(shape_kappa_inv, mass, mu, dtype, tray_lag)
        # The model assumes the plant's friction; a python-float gravity
        # keeps the kernel branch open.
        params = dyn.PMPCParams(mu=mu, dt=dt)
        weights = _select_weights(_shape_id(shape_kappa_inv), dtype)
        zero = torch.zeros((B,), dtype=dtype, device=dev)
        target6 = torch.stack([target_xy[:, 0], zero, target_xy[:, 1], zero,
                               torch.full_like(zero, 0.43), zero], -1)

        def observe(s):
            pos, vel = to_mod.observe_world(s, obj_params)
            return torch.stack([pos[:, 0], vel[:, 0], pos[:, 1], vel[:, 1],
                                pos[:, 2], vel[:, 2]], -1)

        carry = ctlr.init_carry(B, dtype, dev)
        s = to_mod.init_state(dtype=dtype, device=dev, batch=B)
        # The held control stays 0 until the first solve, at warmup_steps.
        u = torch.zeros((B, 2), dtype=dtype, device=dev)
        ps = torch.empty((n_steps, B, 2), dtype=dtype, device=dev)
        us = torch.empty_like(ps)
        with torch.no_grad():
            for k in range(n_steps):
                if _solves_at(k, warmup_steps, control_every):
                    carry, u, _ = ctlr.solve(carry, observe(s), target6,
                                             params, weights)
                s = to_mod.step(s, u, obj_params, dt)
                ps[k] = s.p
                us[k] = u
        m = _trace_metrics(ps, us, target_xy, dt, tol)
        return PMPCScenarioResult(metrics=m, final_p=s.p)

    return evaluate


def make_pmpc_evaluator(n_steps: int = 2500, dt: float = 0.002,
                        control_every: int = 5, warmup_steps: int = 250,
                        N: int = 15, u_bound: float = 0.6,
                        max_iters: int = 10, tol: float = 0.01,
                        tray_lag=None):
    """Per-scenario PMPC evaluator: JAX's single-episode evaluator on a
    lane per row, one `PMPC.solve` (`ilqr.solve`, cfg.max_iters =
    `max_iters`) per control step. The MPC runs every `control_every` sim
    steps (10 ms, the reference's ~100 Hz parallel solve rate) on a
    controller discretised at the sim dt, as the reference discretises;
    the plant at the 2 ms sim cadence with the tray tracking lag standing
    in for the dual-arm layer.

    Returns `evaluate(kappa_inv (B,2), mass (B,), mu (B,), target_xy (B,2))
    -> PMPCScenarioResult` with per-lane Metrics."""
    ctlr = mpc_mod.PMPC(N=N, dt=dt, u_bound=u_bound,
                        cfg=ilqr.ILQRConfig(max_iters=max_iters))
    return _pmpc_episodes(ctlr, n_steps, dt, control_every, warmup_steps,
                          tol, tray_lag)


def make_pmpc_batch_evaluator(n_steps: int = 2500, dt: float = 0.002,
                              control_every: int = 5, warmup_steps: int = 250,
                              N: int = 15, u_bound: float = 0.6,
                              max_iters: int = 4, tol: float = 0.01,
                              use_kernel: bool = True, kernel_iters: int = 2,
                              kernel_alphas: int = 3, tray_lag=None):
    """Batch-major PMPC evaluator: one `PMPCBatch.solve` per control step
    for the whole batch, the whole-solve kernel on the card when
    B % 128 == 0, per-object weights per lane. `max_iters` governs the
    non-kernel branch; `kernel_iters`/`kernel_alphas` the kernel budget
    (under-converged batches escalate, see PMPCBatch). The controller's
    Ts is the sim dt, as the reference discretises.

    Returns `evaluate(kappa_inv (B,2), mass (B,), mu (B,), target_xy (B,2))
    -> PMPCScenarioResult` with per-lane Metrics."""
    ctlr = mpc_mod.PMPCBatch(N=N, dt=dt, u_bound=u_bound,
                             cfg=ilqr.ILQRConfig(max_iters=max_iters),
                             use_kernel=use_kernel, kernel_iters=kernel_iters,
                             kernel_alphas=kernel_alphas)
    return _pmpc_episodes(ctlr, n_steps, dt, control_every, warmup_steps,
                          tol, tray_lag)


def _rmpc_episodes(ctlr, solve, n_steps: int, dt: float,
                   control_every: int, warmup_steps: int, tol: float,
                   tray_lag, trace: bool = False, skip_frozen: bool = False):
    """The RMPC evaluators' episode loop: `solve(carry, obs (B, 4),
    target4 (B, 4)) -> (carry, u, diag)` per control step, `ctlr` the
    `RMPC` whose carry it advances. A lane freezes (carry, held control
    and plant state) once its object is within `tol` of the target
    (`rob_ctrl.py:391-414`), which also avoids RLS covariance wind-up
    under zero excitation; the RLS finite difference divides by the
    controller's dt, the sim dt, although a solve comes every
    `control_every` steps, as the reference does when solves are
    throttled. With `trace`, `evaluate` also returns the per-lane
    trajectories (B, T, ...) of positions, applied controls and the RLS
    estimate."""

    def evaluate(shape_kappa_inv, mass, mu, target_xy):
        dtype, dev = mass.dtype, mass.device
        B = mass.shape[0]
        obj_params = _tray_params(shape_kappa_inv, mass, mu, dtype, tray_lag)
        zero = torch.zeros((B,), dtype=dtype, device=dev)
        target4 = torch.stack([target_xy[:, 0], zero, target_xy[:, 1], zero],
                              -1)

        def observe(s):
            pos, vel = to_mod.observe_world(s, obj_params)
            return torch.stack([pos[:, 0], vel[:, 0], pos[:, 1], vel[:, 1]],
                               -1)

        s = to_mod.init_state(dtype=dtype, device=dev, batch=B)
        carry = ctlr.init_carry(observe(s), dtype)
        # The held control stays 0 until the first solve, at warmup_steps.
        u = torch.zeros((B, 2), dtype=dtype, device=dev)
        stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
        ps = torch.empty((n_steps, B, 2), dtype=dtype, device=dev)
        us = torch.empty_like(ps)
        thetas = []
        with torch.no_grad():
            for k in range(n_steps):
                # The per-scenario evaluator skips a control step on which
                # every lane is frozen (one host read), as JAX's cond does.
                if _solves_at(k, warmup_steps, control_every) and (
                        not skip_frozen or
                        not ilqr.host_bool(stopped.all())):
                    cc_new, u_new, _ = solve(carry, observe(s), target4)
                    # Frozen lanes keep their carry and held control.
                    carry = _lane_where(stopped, carry, cc_new)
                    u = torch.where(stopped[:, None], u, u_new)
                s_next = to_mod.step(s, u, obj_params, dt)
                if k >= warmup_steps:
                    dx = s_next.p[:, 0] - target_xy[:, 0]
                    dy = s_next.p[:, 1] - target_xy[:, 1]
                    stopped_n = stopped | (torch.sqrt(dx * dx + dy * dy)
                                           < tol)
                else:
                    stopped_n = stopped
                s = _lane_where(stopped, s, s_next)
                stopped = stopped_n
                ps[k] = s.p
                us[k] = u
                if trace:
                    thetas.append(torch.cat([carry.rls_x.theta,
                                             carry.rls_y.theta], -1))
        m = _trace_metrics(ps, us, target_xy, dt, tol)
        res = PMPCScenarioResult(metrics=m, final_p=s.p)
        if trace:
            return res, (ps.movedim(0, 1), us.movedim(0, 1),
                         torch.stack(thetas, 1))
        return res

    return evaluate


def make_rmpc_evaluator(n_steps: int = 2500, dt: float = 0.002,
                        control_every: int = 5, warmup_steps: int = 250,
                        N: int = 20, max_iters: int = 10, tol: float = 0.01,
                        trace: bool = False, tray_lag=None):
    """Per-scenario RMPC (RLS-adaptive) evaluator: JAX's single-episode
    evaluator on a lane per row, the closed-loop analogue of
    `rob_ctrl.py:331-416`: one `RMPC.solve` (`ilqr.solve`, `max_iters` x 3
    AL rounds, slew-exact) per control step of the lanes not yet frozen.
    With `trace=True` it returns (result, (positions, controls, RLS
    estimates)), each (B, T, ...), for the episode-JSON logs.

    Returns `evaluate(kappa_inv (B,2), mass (B,), mu (B,), target_xy (B,2))
    -> PMPCScenarioResult` with per-lane Metrics."""
    ctlr = mpc_mod.RMPC(N=N, dt=dt,
                        cfg=ilqr.ILQRConfig(max_iters=max_iters, al_iters=3))
    return _rmpc_episodes(ctlr, ctlr.solve, n_steps, dt, control_every,
                          warmup_steps, tol, tray_lag, trace=trace,
                          skip_frozen=True)


def make_rmpc_batch_evaluator(n_steps: int = 2500, dt: float = 0.002,
                              control_every: int = 5, warmup_steps: int = 250,
                              N: int = 20, max_iters: int = 10,
                              tol: float = 0.01, use_kernel: bool = True,
                              kernel_iters: int = 6, kernel_alphas: int = 4,
                              kernel_al_rounds: int = 3,
                              kernel_max_extra_rounds: int = 2,
                              kernel_xla_fallback: bool = True,
                              tray_lag=None):
    """Batch-major RMPC evaluator: one `RMPCBatch.solve_batched` per
    control step for the whole batch, the whole-solve kernel on the card
    when B % 128 == 0, with escalation and the per-lane rescue. A lane
    freezes as in `make_rmpc_evaluator`; the batch is still solved whole
    on every control step, so B keeps the kernel's grid.

    The kernel budget defaults (6 iterations x 4 alphas x 3 AL rounds) are
    higher than RMPCBatch's: closed-loop RLS adaptation can drive the
    regressor stiff on rolling objects, where an under-converged solve
    feeds bad control back into the estimator.

    Returns `evaluate(kappa_inv (B,2), mass (B,), mu (B,), target_xy (B,2))
    -> PMPCScenarioResult` with per-lane Metrics."""
    ctlr = mpc_mod.RMPCBatch(
        N=N, dt=dt, cfg=ilqr.ILQRConfig(max_iters=max_iters, al_iters=3),
        kernel_iters=kernel_iters, kernel_alphas=kernel_alphas,
        kernel_al_rounds=kernel_al_rounds,
        kernel_max_extra_rounds=kernel_max_extra_rounds,
        kernel_xla_fallback=kernel_xla_fallback)

    def solve(carry, obs, target4):
        return ctlr.solve_batched(carry, obs, target4, use_kernel=use_kernel)

    return _rmpc_episodes(ctlr, solve, n_steps, dt, control_every,
                          warmup_steps, tol, tray_lag)
