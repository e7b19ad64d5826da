"""Scenario evaluation: closed-loop PMPC / MPPI / RMPC / LMPC against the
tray-object contact plant (port of `dart_tpu.rollout.evaluate`).

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
control step; `make_mppi_evaluator` solves the same PMPC OCP by MPPI
ensembles on a (lane x sample) axis instead. The batch ones solve with
`PMPCBatch` / `RMPCBatch`, whose whole-solve kernels run on the card when
B % 128 == 0; their loop reads nothing from the device beyond what the
controllers' escalation reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dart_tpu_torch.adapt import lmpc_trainer as trainer
from dart_tpu_torch.adapt import ppo as ppo_mod
from dart_tpu_torch.adapt.lmpc_lagplant import observe8
from dart_tpu_torch.control import mpc as mpc_mod
from dart_tpu_torch.models import dynamics as dyn
from dart_tpu_torch.physics import tray_object as to_mod
from dart_tpu_torch.rollout.metrics import Metrics, compute_metrics
from dart_tpu_torch.solver import ilqr
from dart_tpu_torch.solver import mppi as mppi_mod
from dart_tpu_torch.solver.ocp import PMPCAux, make_pmpc_ocp
from dart_tpu_torch.utils.tree import lane_where


class PMPCScenarioResult(NamedTuple):
    metrics: Metrics
    final_p: torch.Tensor
    # Sticky contact-loss flag of the LMPC evaluator (None where not
    # tracked, as in both batch evaluators).
    contact_lost: torch.Tensor | None = None


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


def _solves_at(k: int, warmup_steps: int, control_every: int) -> bool:
    return k >= warmup_steps and (k - warmup_steps) % control_every == 0


def _trace_metrics(ps: torch.Tensor, us: torch.Tensor,
                   target_xy: torch.Tensor, dt: float, tol: float) -> Metrics:
    """Per-lane metrics of the tray-frame positions (T, B, 2) after each
    step and the applied controls (T, B, 2)."""
    zt = torch.zeros_like(ps[..., 0])
    X = torch.stack([ps[..., 0], zt, ps[..., 1], zt], -1)
    return compute_metrics(X, us, target_xy, dt, tol=tol)


def _pmpc_episodes(ctlr, n_steps: int, dt: float, control_every: int,
                   warmup_steps: int, tol: float, tray_lag, tap=None):
    """The PMPC evaluators' episode loop around `ctlr` (`PMPC`,
    `PMPCBatch` or the MPPI front end): `ctlr.solve` per control step,
    per-object weights per lane, the model's friction the plant's. With a
    `tap` (`io.streaming.TelemetryTap` of `EPISODE_STREAM_DTYPE`, one
    episode only) every step emits its record. Returns `evaluate(kappa_inv
    (B,2), mass (B,), mu (B,), target_xy (B,2)) -> PMPCScenarioResult` with
    per-lane Metrics."""

    def evaluate(shape_kappa_inv, mass, mu, target_xy):
        dtype, dev = mass.dtype, mass.device
        B = mass.shape[0]
        if tap is not None and B != 1:
            raise ValueError(f"a telemetry tap streams one episode, got "
                             f"B={B} lanes")
        obj_params = to_mod.scenario_params(shape_kappa_inv, mass, mu, dtype, tray_lag)
        # The model assumes the plant's friction; a python-float gravity
        # keeps the kernel branch open.
        params = dyn.PMPCParams(mu=mu, dt=dt)
        weights = _select_weights(to_mod.shape_from_kappa(shape_kappa_inv), dtype)
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
                if tap is not None:
                    d = s.p[0] - target_xy[0]
                    tap.emit(k=k, px=s.p[0, 0], py=s.p[0, 1], ux=u[0, 0],
                             uy=u[0, 1],
                             err=torch.sqrt(d[0] ** 2 + d[1] ** 2))
        m = _trace_metrics(ps, us, target_xy, dt, tol)
        return PMPCScenarioResult(metrics=m, final_p=s.p)

    return evaluate


def make_pmpc_evaluator(n_steps: int = 2500, dt: float = 0.002,
                        control_every: int = 5, warmup_steps: int = 250,
                        N: int = 15, u_bound: float = 0.6,
                        max_iters: int = 10, tol: float = 0.01,
                        tray_lag=None, tap=None):
    """Per-scenario PMPC evaluator: JAX's single-episode evaluator on a
    lane per row, one `PMPC.solve` (`ilqr.solve`, cfg.max_iters =
    `max_iters`) per control step. The MPC runs every `control_every` sim
    steps (10 ms, the reference's ~100 Hz parallel solve rate) on a
    controller discretised at the sim dt, as the reference discretises;
    the plant at the 2 ms sim cadence with the tray tracking lag standing
    in for the dual-arm layer. A `tap` (`io.streaming.TelemetryTap`,
    B=1 only) receives every step's record, as `pmpc --stream` asks.

    Returns `evaluate(kappa_inv (B,2), mass (B,), mu (B,), target_xy (B,2))
    -> PMPCScenarioResult` with per-lane Metrics."""
    ctlr = mpc_mod.PMPC(N=N, dt=dt, u_bound=u_bound,
                        cfg=ilqr.ILQRConfig(max_iters=max_iters))
    return _pmpc_episodes(ctlr, n_steps, dt, control_every, warmup_steps,
                          tol, tray_lag, tap=tap)


class _MPPIFrontEnd:
    """`mppi.solve` behind the PMPC controllers' interface for
    `_pmpc_episodes`: a warm nominal sequence per lane, shifted a stage
    after each solve, and the perturbations of the j-th solve of an
    episode from `draw(j, dtype, device)`."""

    def __init__(self, ocp, cfg, N: int, draw):
        self.ocp, self.cfg, self.N, self.draw = ocp, cfg, N, draw

    def init_carry(self, B: int, dtype, device):
        return torch.zeros((B, self.N, 2), dtype=dtype, device=device), 0

    def solve(self, carry, obs, target6, params, weights):
        U, j = carry
        aux = PMPCAux(target=target6, Qp=weights.Qp, Qv=weights.Qv,
                      R=weights.R)
        U_new, cost = mppi_mod.solve(self.ocp, self.cfg, params, aux, obs, U,
                                     self.draw(j, U.dtype, U.device))
        return (mppi_mod.shift(U_new), j + 1), U_new[:, 0], cost


def make_mppi_evaluator(n_steps: int = 2500, dt: float = 0.002,
                        control_every: int = 5, warmup_steps: int = 250,
                        N: int = 15, u_bound: float = 0.6,
                        n_samples: int = 256, n_iters: int = 2,
                        tol: float = 0.01, seed: int = 0, tray_lag=None,
                        draw=None):
    """Sampling-MPC evaluator: the per-scenario PMPC evaluator's episode
    with the same OCP (discretised at the sim dt) solved by MPPI ensembles
    of `n_samples` rollouts, `n_iters` refinements, temperature 0.05 and
    sigma 0.08, the B*K rollouts of all lanes as one batched rollout.

    As in JAX, where every row's closure starts from `PRNGKey(seed)`,
    every lane sees the same perturbations: one (n_iters, K, N, 2) draw
    per control step, broadcast over the lanes. `draw(j, dtype, device)`
    gives the draw of an episode's j-th solve; by default a
    `torch.Generator` on the lanes' device, seeded with `seed` at the start
    of each episode, draws it.

    Returns `evaluate(kappa_inv (B,2), mass (B,), mu (B,), target_xy (B,2))
    -> PMPCScenarioResult` with per-lane Metrics."""
    ocp = make_pmpc_ocp(dt=dt, u_bound=u_bound)
    cfg = mppi_mod.MPPIConfig(n_samples=n_samples, temperature=0.05,
                              sigma=0.08, n_iters=n_iters)

    def evaluate(shape_kappa_inv, mass, mu, target_xy):
        draw_j = draw
        if draw_j is None:
            gen = torch.Generator(device=mass.device).manual_seed(seed)

            def draw_j(j, dtype, device):
                return mppi_mod.draw_noise(cfg, gen, (), N, 2, dtype, device)

        ctlr = _MPPIFrontEnd(ocp, cfg, N, draw_j)
        return _pmpc_episodes(ctlr, n_steps, dt, control_every, warmup_steps,
                              tol, tray_lag)(shape_kappa_inv, mass, mu,
                                             target_xy)

    return evaluate


def make_lmpc_evaluator(model, n_steps: int = 2500, dt: float = 0.002,
                        control_every: int = 5, warmup_steps: int = 250,
                        N: int = 12, max_iters: int = 4, tol: float = 0.01,
                        param_update_every: int = 8, u_sign: float = -1.0,
                        trace: bool = False, tray_lag=None,
                        hold_after_convergence: bool = False,
                        reengage_tol: float | None = None):
    """LMPC scenario evaluator on the CONTACT PLANT with the trained policy
    `model` (an `adapt.ppo.ActorCritic`) tuning the 34 model parameters
    online: the closed-loop analogue of `LMPC/src/run.py:243-311` with the
    plant swapped from MuJoCo to `tray_object`. JAX's single-episode
    evaluator on a lane per row: one `LMPC.solve` (`ilqr.solve`, each
    backward pass a `riccati_backward` launch on the card) for every lane
    at every control period of `control_every` 2 ms plant steps, the
    warm-up included, whose controls reach the plant only from
    `warmup_steps` on. The policy adjusts the parameter vector every
    `param_update_every` control steps (`rlmpc2.py:742`), with the mean
    action; the learned model's tilt sign is inverted against the world
    (`run.py:257`), hence ``u_sign=-1``.

    Reference protocol (default): a lane freezes whole (carry, held
    control, plant) at its first tolerance crossing after the warm-up
    (`run.py:300-306`). ``hold_after_convergence=True``, the SETTLED
    protocol: control keeps running and only the adaptation freezes, once
    the lane is inside `tol` and slower than 2 cm/s, and re-engages past
    ``reengage_tol`` (default ``1.2 * tol``), a hysteretic clutch. In both,
    a lane that loses contact (off the tray or toppled) freezes whole from
    there on and is flagged `contact_lost`.

    Returns `evaluate(kappa_inv (B,2), mass (B,), mu (B,), target_xy (B,2),
    init_k (B,34)) -> PMPCScenarioResult`; `init_k` is the policy's
    starting 34-vector (`adapt.lmpc_trainer.sample_init_k`, the mid-range
    jittered init of `rlmpc2.py:618-623`). With `trace=True` it returns
    (result, (positions, applied controls)), each (B, T, 2) over the
    control periods."""
    ctrl_dt = dt * control_every
    ctlr = mpc_mod.LMPC(N=N, dt=ctrl_dt,
                        cfg=ilqr.ILQRConfig(max_iters=max_iters))
    n_ctrl = n_steps // control_every
    act_cfg = ppo_mod.ParamActionConfig()
    if reengage_tol is None:
        reengage_tol = 1.2 * tol

    def evaluate(shape_kappa_inv, mass, mu, target_xy, init_k):
        dtype, dev = mass.dtype, mass.device
        B = mass.shape[0]
        obj_params = to_mod.scenario_params(shape_kappa_inv, mass, mu, dtype, tray_lag)
        zero = torch.zeros((B,), dtype=dtype, device=dev)
        target8 = torch.stack([target_xy[:, 0], zero, target_xy[:, 1]]
                              + [zero] * 5, -1)

        def substep(s, u):
            for _ in range(control_every):
                s = to_mod.step(s, u, obj_params, dt)
            return s

        cc = ctlr.init_carry(B, dtype, dev)
        s = to_mod.init_state(dtype=dtype, device=dev, batch=B)
        current_k = init_k
        welford = ppo_mod.welford_init(trainer.BASE_OBS_DIM, dtype, dev,
                                       (B,))
        history = torch.zeros((B, trainer.HISTORY_LEN, trainer.BASE_OBS_DIM),
                              dtype=dtype, device=dev)
        u_prev = torch.zeros((B, 2), dtype=dtype, device=dev)
        stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
        lost = torch.zeros_like(stopped)
        ps = torch.empty((n_ctrl, B, 2), dtype=dtype, device=dev)
        us = torch.empty_like(ps)
        with torch.no_grad():
            for k in range(n_ctrl):
                x = observe8(s, obj_params)
                base = torch.cat([x, target8, u_prev, current_k], -1)
                welford_c, history_c, obs = trainer.observe(welford, history,
                                                            base)
                mean, _, _ = model(obs)
                # The first tolerance crossing (`stopped`) gates the
                # parameter updates: the zero-excitation clutch.
                k_new = ppo_mod.apply_param_action(current_k, mean, act_cfg)
                upd = ~stopped if k % param_update_every == 0 \
                    else torch.zeros_like(stopped)
                current_k_c = torch.where(upd[:, None], k_new, current_k)
                cc_new, u, _ = ctlr.solve(cc, x, target8, current_k_c)
                warm = k * control_every >= warmup_steps
                if hold_after_convergence:
                    cc_c = cc_new
                    u_apply = u_sign * u if warm else torch.zeros_like(u)
                    s_keep = substep(s, u_apply)
                else:
                    cc_c = lane_where(stopped, cc, cc_new)
                    u = torch.where(stopped[:, None], u_prev, u)
                    go = (~stopped) if warm else torch.zeros_like(stopped)
                    u_apply = torch.where(
                        go[:, None], u_sign * u,
                        torch.where(stopped[:, None], u_sign * u_prev,
                                    torch.zeros_like(u)))
                    s_keep = lane_where(stopped, s, substep(s, u_apply))
                # A lane that lost contact stays as it was, whole.
                cc, s_keep, current_k, welford, history, u = (
                    lane_where(lost, a, b) for a, b in zip(
                        (cc, s, current_k, welford, history, u_prev),
                        (cc_c, s_keep, current_k_c, welford_c, history_c,
                         u)))
                u_apply = torch.where(lost[:, None], torch.zeros_like(u_apply),
                                      u_apply)
                lost = lost | to_mod.contact_lost(s_keep)
                err = torch.sqrt((s_keep.p[:, 0] - target_xy[:, 0]) ** 2
                                 + (s_keep.p[:, 1] - target_xy[:, 1]) ** 2)
                if hold_after_convergence:
                    speed = torch.hypot(s_keep.v[:, 0], s_keep.v[:, 1])
                    settled = (err < tol) & (speed < 0.02) if warm \
                        else torch.zeros_like(stopped)
                    stopped = (stopped | settled) & (err < reengage_tol)
                elif warm:
                    stopped = stopped | ((err < tol) & ~lost)
                s, u_prev = s_keep, u
                ps[k] = s.p
                us[k] = u_apply
        m = _trace_metrics(ps, us, target_xy, ctrl_dt, tol)
        res = PMPCScenarioResult(metrics=m, final_p=s.p, contact_lost=lost)
        if trace:
            return res, (ps.movedim(0, 1), us.movedim(0, 1))
        return res

    return evaluate


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
        obj_params = to_mod.scenario_params(shape_kappa_inv, mass, mu, dtype, tray_lag)
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
                    carry = lane_where(stopped, carry, cc_new)
                    u = torch.where(stopped[:, None], u, u_new)
                s_next = to_mod.step(s, u, obj_params, dt)
                if k >= warmup_steps:
                    dx = s_next.p[:, 0] - target_xy[:, 0]
                    dy = s_next.p[:, 1] - target_xy[:, 1]
                    stopped_n = stopped | (torch.sqrt(dx * dx + dy * dy)
                                           < tol)
                else:
                    stopped_n = stopped
                s = lane_where(stopped, s, s_next)
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
