"""The full-fidelity end-to-end stack (port of `dart_tpu.rollout.full_stack`):

    MPC solve -> tilt -> DACTL EE targets -> 2x impedance QP -> torques
      -> 2x 7-DoF arm forward dynamics -> tray pose from the rigid grasp
      -> object contact step -> observation back to the MPC

the reference's 5-process topology (main sim + 2 arm-QP workers + MPC
worker) as one host loop, MuJoCo's `mj_step` and `mj_*` dynamics queries
included.

Grasp coupling model: the tray is welded to both end-effectors (the
reference's rigid-grasp assumption, `dualctl.py:30-33`); its pose is the
average of the two grasp-implied poses, and each arm feels half the
tray+object weight as an external end-effector force. Two asymmetries of
the JAX module are kept as they are: the controller's QP gets the
flange-origin Jacobian but the tool-point Jdot (`_arm_dynamics`), and the
weight acts at the flange origin, not at the tool point (`advance_world`).

Every `FullState` leaf has a leading lane axis B (the scenarios, or a
trainer's envs). The two arms run as one batch on a leading arm axis,
(2, B, ...), each lane with its own chain's parameters; the results are
those of the JAX module's two calls. The world's FK, M and h at a state
are computed once, for the controller and for the arm step that follows
it at the same state.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from dart_tpu_torch.control import arm as arm_mod
from dart_tpu_torch.control.dualarm import (L_GRASP_QUAT, R_GRASP_QUAT,
                                            resolve_ee_targets)
from dart_tpu_torch.ops.qp import mv, spd_inv
from dart_tpu_torch.physics import chain as chain_mod
from dart_tpu_torch.physics import tray_object as to_mod
from dart_tpu_torch.utils.device import constant, resolve
from dart_tpu_torch.utils.quat import (matrix_to_quat, quat_conj, quat_mul,
                                       quat_rotate, quat_to_euler_xyz,
                                       tilt_to_quat)

EE_OFFSET = (0.0, 0.0, 0.125)   # tool offset along EE z (`run.py:73`)
# The keyframe `home` (world_general.xml:205).
HOME_QL = (2.0, -0.15, -0.38, 0.49, 0.11, -0.93, 1.4)
HOME_QR = (-1.1, -0.12, -0.47, 0.5, -0.018, -0.97, -1.6)
TRAY_MASS = 1.0                  # world_general.xml:136


class DualArmScene(NamedTuple):
    """Static scene: the two chains + controller gains."""

    left: chain_mod.ChainParams
    right: chain_mod.ChainParams
    arm_params: arm_mod.ArmParams


def make_scene(dt: float = 0.002, dtype=torch.float32,
               device: torch.device | str = "cuda") -> DualArmScene:
    dev = resolve(device)
    return DualArmScene(
        left=chain_mod.make_xarm7_chain((-0.7, 0, -0.12),
                                        (0.707, 0, 0, -0.707), dtype, dev),
        right=chain_mod.make_xarm7_chain((0.7, 0, -0.12),
                                         (0.707, 0, 0, -0.707), dtype, dev),
        arm_params=arm_mod.default_arm_params(dt=dt, dtype=dtype, device=dev),
    )


class FullState(NamedTuple):
    qL: torch.Tensor                 # (B, 7)
    qdL: torch.Tensor
    qR: torch.Tensor
    qdR: torch.Tensor
    armL: arm_mod.ArmCarry
    armR: arm_mod.ArmCarry
    obj: to_mod.TrayObjectState


def init_full_state(dtype=torch.float32, p0=(0.0, 0.0),
                    device: torch.device | str = "cuda",
                    batch: int = 1) -> FullState:
    """`batch` lanes at the home keyframe, the object at rest at p0."""
    dev = resolve(device)

    def home(q):
        return torch.tensor(q, dtype=dtype, device=dev).expand(
            batch, 7).clone()

    zeros = torch.zeros((batch, 7), dtype=dtype, device=dev)
    return FullState(
        qL=home(HOME_QL), qdL=zeros, qR=home(HOME_QR), qdR=zeros.clone(),
        armL=arm_mod.arm_init_carry(dtype, dev, batch),
        armR=arm_mod.arm_init_carry(dtype, dev, batch),
        obj=to_mod.init_state(p0, dtype, dev, batch))


def _arms(scene: DualArmScene) -> chain_mod.ChainParams:
    """Both chains on a leading arm axis, (2, 1, ...), against (2, B, ...)
    lanes."""
    return chain_mod.ChainParams(*(torch.stack([a, b])[:, None]
                                   for a, b in zip(scene.left, scene.right)))


def _pair(a, b):
    """Two NamedTuples (or tensors) of (B, ...) leaves -> one of (2, B, ...)
    leaves."""
    if isinstance(a, tuple):
        return type(a)(*(_pair(x, y) for x, y in zip(a, b)))
    return torch.stack(torch.broadcast_tensors(a, b))


def _ee_from(f: chain_mod.FK):
    """The tool point's position and orientation from FK."""
    R = f.R[..., 7, :, :]
    pos = f.p[..., 7, :] + mv(R, constant(EE_OFFSET, R.dtype, R.device))
    return pos, matrix_to_quat(R)


def _ee_pose(params: chain_mod.ChainParams, q: torch.Tensor):
    f = chain_mod.fk(params, q)
    return (*_ee_from(f), f)


def _snapshot(params: chain_mod.ChainParams, q, qd):
    """The controller's dynamics snapshot at (q, qd), its EE pose included,
    and the FK it was taken from (`_arm_dynamics`)."""
    t = chain_mod.dynamics_terms(params, q, qd, 7, EE_OFFSET)
    pos, quat = _ee_from(t.f)
    J_body = chain_mod.point_jacobian(t.f, t.f.p[..., 7, :], 7)
    Minv = spd_inv(t.M)
    return arm_mod.ArmDynamics(q=q, qd=qd, jac=J_body, jac_dot=t.Jdot,
                               M=t.M, h=t.h, Mx_inv=J_body @ Minv @ J_body.mT,
                               ee_pos=pos, ee_quat=quat), t.f


def _arm_dynamics(params: chain_mod.ChainParams, q, qd, ee_pos, ee_quat):
    """The controller's dynamics snapshot (== compute_dynamics,
    `arm.py:111-199`: body-origin Jacobian for Mx, offset-point Jdot)."""
    dyn, _ = _snapshot(params, q, qd)
    return dyn._replace(ee_pos=ee_pos, ee_quat=ee_quat)


def _tray_pose_from_arms(posL, quatL, posR, quatR):
    """Rigid-grasp pose fit: the EE points ARE the tray-frame (+-0.175,0,0)
    grasp points, so the tray x-axis is fixed by the two positions (which
    makes theta_x tilts structurally stiff: the height difference of the
    grasp points); only the roll about that grasp line comes from the
    wrist orientations."""
    def c(x):
        return constant(x, posL.dtype, posL.device)

    def unit(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True),
                               min=1e-9)

    x_axis = unit(posR - posL)
    # Tray z-axes implied by each wrist orientation, averaged.
    qL_tray = quat_mul(quatL, quat_conj(c(L_GRASP_QUAT)))
    qR_tray = quat_mul(quatR, quat_conj(c(R_GRASP_QUAT)))
    zhat = c((0.0, 0.0, 1.0))
    z_avg = 0.5 * (quat_rotate(qL_tray, zhat) + quat_rotate(qR_tray, zhat))
    z_axis = unit(z_avg - (z_avg * x_axis).sum(-1, keepdim=True) * x_axis)
    y_axis = torch.linalg.cross(z_axis, x_axis)
    R = torch.stack([x_axis, y_axis, z_axis], -1)
    return 0.5 * (posL + posR), matrix_to_quat(R)


def tray_tilt_from_quat(quat: torch.Tensor) -> torch.Tensor:
    """Invert the tilt convention: quat = from_euler('xyz', [u1, -u0, 0])
    =>  theta = [-(euler_y), euler_x]."""
    e = quat_to_euler_xyz(quat)
    return torch.stack([-e[..., 1], e[..., 0]], -1)


def _torques(arms, arm_params, state: FullState, u_cmd, obj_params,
             qp_iters: int):
    """DACTL and both impedance QPs on the arm axis. Returns (ArmCarry
    (2, B), tau (2, B, 7), (M, h, FK) at the state)."""
    tray_target_quat = tilt_to_quat(u_cmd).to(state.qL.dtype)
    # DACTL: tray target -> EE mocap targets (`dualctl.py:22-56`).
    tgtL, tgtR = resolve_ee_targets(obj_params.tray_pos, tray_target_quat)
    dyn, f = _snapshot(arms, _pair(state.qL, state.qR),
                       _pair(state.qdL, state.qdR))
    carry, tau, _ = arm_mod.compute_torque(
        _pair(state.armL, state.armR), dyn, _pair(tgtL.pos, tgtR.pos),
        _pair(tgtL.quat, tgtR.quat), arm_params, qp_iters=qp_iters)
    return carry, tau, (dyn.M, dyn.h, f)


def _split(carry: arm_mod.ArmCarry):
    return (arm_mod.ArmCarry(carry.qdd_prev[0], carry.y[0]),
            arm_mod.ArmCarry(carry.qdd_prev[1], carry.y[1]))


def compute_arm_torques(scene: DualArmScene, state: FullState,
                        u_cmd: torch.Tensor,
                        obj_params: to_mod.TrayObjectParams,
                        qp_iters: int = 60):
    """DACTL + both impedance QPs at the current state: tray tilt command
    (B, 2) -> (armL', armR', tauL, tauR). Apart from `full_step` so the QP
    rate can differ from the world rate (stale-torque replay,
    `arm.py:221-229`)."""
    carry, tau, _ = _torques(_arms(scene), scene.arm_params, state, u_cmd,
                             obj_params, qp_iters)
    armL, armR = _split(carry)
    return armL, armR, tau[0], tau[1]


def _advance(arms, state: FullState, carry: arm_mod.ArmCarry,
             tau: torch.Tensor, obj_params, dt: float, dyn=None):
    """`advance_world` on the arm axis: torques (2, B, 7); `dyn`, where
    given, `_torques`' M, h and FK at the state's (q, qd)."""
    B = state.qL.shape[0]
    # Each arm carries half the tray+object weight at the flange origin.
    load = -(TRAY_MASS + obj_params.mass) * chain_mod.GRAVITY / 2.0
    f_ext = torch.zeros((B, 6), dtype=state.qL.dtype, device=state.qL.device)
    f_ext[:, 2] = load
    M, h, f = (None, None, None) if dyn is None else dyn
    q, qd = chain_mod.step(arms, _pair(state.qL, state.qR),
                           _pair(state.qdL, state.qdR), tau, dt,
                           f_ext=f_ext, M=M, h=h, f=f)

    # Tray pose from the rigid grasp; its tilt drives the object step.
    pos, quat, _ = _ee_pose(arms, q)
    _, tray_quat = _tray_pose_from_arms(pos[0], quat[0], pos[1], quat[1])
    theta = tray_tilt_from_quat(tray_quat)
    theta_dot = (theta - state.obj.theta) / dt
    obj = to_mod.step_object(state.obj, theta, theta_dot, obj_params, dt)
    armL, armR = _split(carry)
    return FullState(qL=q[0], qdL=qd[0], qR=q[1], qdR=qd[1], armL=armL,
                     armR=armR, obj=obj)


def advance_world(scene: DualArmScene, state: FullState,
                  armL, armR, tauL, tauR,
                  obj_params: to_mod.TrayObjectParams,
                  dt: float) -> FullState:
    """Apply given torques and advance arms + tray + object by one dt."""
    return _advance(_arms(scene), state, _pair(armL, armR),
                    _pair(tauL, tauR), obj_params, dt)


def _full_step(arms, arm_params, state, u_cmd, obj_params, dt, qp_iters):
    carry, tau, dyn = _torques(arms, arm_params, state, u_cmd, obj_params,
                               qp_iters)
    return _advance(arms, state, carry, tau, obj_params, dt, dyn)


def full_step(scene: DualArmScene, state: FullState, u_cmd: torch.Tensor,
              obj_params: to_mod.TrayObjectParams, dt: float,
              qp_iters: int = 60) -> FullState:
    """One 2 ms step of the complete dual-arm + tray + object world."""
    return _full_step(_arms(scene), scene.arm_params, state, u_cmd,
                      obj_params, dt, qp_iters)


def observe_object(state: FullState, obj_params: to_mod.TrayObjectParams):
    """6-state observation (B, 6) [px, vx, py, vy, pz, vz] for the PMPC
    front-end."""
    pos, vel = to_mod.observe_world(state.obj, obj_params)
    return torch.stack([pos[..., 0], vel[..., 0], pos[..., 1], vel[..., 1],
                        pos[..., 2], vel[..., 2]], -1)


def observe_object_4(state: FullState, obj_params: to_mod.TrayObjectParams):
    """[px, vx, py, vy] for the RMPC front-end (`np_mpc...py:195-198`)."""
    pos, vel = to_mod.observe_world(state.obj, obj_params)
    return torch.stack([pos[..., 0], vel[..., 0], pos[..., 1], vel[..., 1]],
                       -1)


def observe_object_8(state: FullState, obj_params: to_mod.TrayObjectParams):
    """8-state [px,vx,py,vy,th_x,om_x,th_y,om_y] for the LMPC front-end
    (`rlmpc2.py:1034-1042`): the object rides the tray, so its roll/pitch
    are the tray's euler angles (e_x = theta[1], e_y = -theta[0])."""
    pos, vel = to_mod.observe_world(state.obj, obj_params)
    th = state.obj.theta
    thd = state.obj.theta_dot
    return torch.stack([pos[..., 0], vel[..., 0], pos[..., 1], vel[..., 1],
                        th[..., 1], thd[..., 1], -th[..., 0], -thd[..., 0]],
                       -1)


@torch.no_grad()
def run_full_stack(scene: DualArmScene, solve_fn: Callable, ctrl_carry0: Any,
                   state0: FullState, target: torch.Tensor,
                   obj_params: to_mod.TrayObjectParams, n_steps: int,
                   dt: float = 0.002, control_every: int = 1,
                   warmup_steps: int = 0, qp_iters: int = 60,
                   observe: Callable = observe_object, qp_every: int = 1,
                   record_joints: bool = False):
    """Closed loop over the full stack, a host loop over the world steps.
    solve_fn(carry, obs, target) -> (carry, u (B, 2), diag), called at
    every `control_every`-th step from `warmup_steps` on (the control
    stays 0 before). Returns (object positions (B, n_steps, 2), tilts
    (B, n_steps, 2), applied controls (B, n_steps, 2), final state); with
    ``record_joints`` the per-step joints (qL, qR), each (B, n_steps, 7),
    come before the final state.

    `qp_every` replays the reference's arm-QP deadline semantics
    (`PMPC/src/controller/arm.py:221-229`): the impedance QPs re-solve at
    every `qp_every`-th world step, and the last torques are held in
    between (3 reproduces a persistent ~5 ms deadline miss; 1, the
    default, the deadline met)."""
    arms = _arms(scene)
    st = state0
    B, dtype, dev = st.qL.shape[0], st.qL.dtype, st.qL.device
    ctrl_carry = ctrl_carry0
    u = torch.zeros((B, 2), dtype=dtype, device=dev)
    zero_u = torch.zeros_like(u)
    tau = torch.zeros((2, B, 7), dtype=dtype, device=dev)
    ps = torch.empty((B, n_steps, 2), dtype=dtype, device=dev)
    thetas = torch.empty_like(ps)
    us = torch.empty_like(ps)
    if record_joints:
        qLs = torch.empty((B, n_steps, 7), dtype=dtype, device=dev)
        qRs = torch.empty_like(qLs)
    for k in range(n_steps):
        if k >= warmup_steps and (k - warmup_steps) % control_every == 0:
            ctrl_carry, u, _ = solve_fn(ctrl_carry, observe(st, obj_params),
                                        target)
        u_apply = u if k >= warmup_steps else zero_u
        dyn = None
        if k % qp_every == 0:
            carry, tau, dyn = _torques(arms, scene.arm_params, st, u_apply,
                                       obj_params, qp_iters)
        else:
            carry = _pair(st.armL, st.armR)
        st = _advance(arms, st, carry, tau, obj_params, dt, dyn)
        ps[:, k] = st.obj.p
        thetas[:, k] = st.obj.theta
        us[:, k] = u_apply
        if record_joints:
            qLs[:, k] = st.qL
            qRs[:, k] = st.qR
    if record_joints:
        return ps, thetas, us, qLs, qRs, st
    return ps, thetas, us, st
