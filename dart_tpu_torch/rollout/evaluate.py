"""Batch-major scenario evaluation: closed-loop PMPC / RMPC against the
tray-object contact plant (port of the batch evaluators of
`dart_tpu.rollout.evaluate`).

A scenario batch advances in one host loop: the plant at the 2 ms sim
cadence, one batched solve every `control_every` steps after
`warmup_steps` of rest, and the reference's metrics (steady-state error,
convergence time, control effort; `logger.py:154-176`) per lane at the
end. JAX's `lax.cond` on the step index is a host `if` here, so the loop
reads nothing from the device beyond what the controllers' escalation
reads. Tensors follow the scenario tensors' device: on the card the
solves launch the `pmpc_solve` / `rmpc_solve` kernels when B % 128 == 0.
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
    freezes (carry, held control and plant state) once its object is
    within `tol` of the target (`rob_ctrl.py:391-414`); the batch is
    still solved whole, so B keeps the kernel's grid.

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
        carry = ctlr.init_carry_batch(observe(s), dtype)
        # The held control stays 0 until the first solve, at warmup_steps.
        u = torch.zeros((B, 2), dtype=dtype, device=dev)
        stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
        ps = torch.empty((n_steps, B, 2), dtype=dtype, device=dev)
        us = torch.empty_like(ps)
        with torch.no_grad():
            for k in range(n_steps):
                if _solves_at(k, warmup_steps, control_every):
                    cc_new, u_new, _ = ctlr.solve_batched(
                        carry, observe(s), target4, use_kernel=use_kernel)
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
        m = _trace_metrics(ps, us, target_xy, dt, tol)
        return PMPCScenarioResult(metrics=m, final_p=s.p)

    return evaluate
