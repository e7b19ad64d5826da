"""Closed-form operational-space controller, the legacy OPSPACE/CONVIMP
lineage of the reference (port of `dart_tpu.control.opspace`,
`RMPC/dev_dual/controller/opspace.py:5-147`).

Not on the main control path (the impedance QP of `control.arm` is), but
part of the reference's API: a cheap fallback torque law over the same
`ArmDynamics` snapshot, on a leading lane shape.

tau = J' Mx (K twist - D (J qd) + mu)
      + (I - J' Jbar') (K_null (q0 - q) - 2 zeta sqrt(K_null) qd)
      + h                                     (gravity compensation)
with Jbar = M^-1 J' Mx (dynamically-consistent pseudoinverse), then
actuator clipping and a one-pole low-pass (alpha = 0.001). Both branches
of the Mx selection are computed, as in the JAX module.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dart_tpu_torch.control.arm import ArmDynamics
from dart_tpu_torch.ops.qp import mv, spd_inv
from dart_tpu_torch.utils.device import resolve
from dart_tpu_torch.utils.quat import quat_error_rotvec


class OpspaceParams(NamedTuple):
    K: torch.Tensor           # (6,) task stiffness (diagonal)
    K_null: torch.Tensor      # (7,) null-space stiffness (diagonal)
    q0: torch.Tensor          # (7,) posture target (home keyframe)
    taumin: torch.Tensor      # (7,)
    taumax: torch.Tensor
    damping_ratio: float = 1.0
    gravity_compensation: bool = True
    lowpass_alpha: float = 0.001


class OpspaceCarry(NamedTuple):
    prev_tau: torch.Tensor    # (..., 7) low-pass state


def opspace_init(dtype=torch.float32, device: torch.device | str = "cuda",
                 batch: tuple[int, ...] | int = ()) -> OpspaceCarry:
    batch = (batch,) if isinstance(batch, int) else tuple(batch)
    return OpspaceCarry(prev_tau=torch.zeros((*batch, 7), dtype=dtype,
                                             device=resolve(device)))


def opspace_torque(carry: OpspaceCarry, dyn: ArmDynamics,
                   target_pos: torch.Tensor, target_quat: torch.Tensor,
                   p: OpspaceParams):
    """One control step. Returns (carry', tau, twist_norm)."""
    J = dyn.jac
    qd = dyn.qd
    dx = target_pos - dyn.ee_pos
    twist = torch.cat(torch.broadcast_tensors(
        dx, quat_error_rotvec(target_quat, dyn.ee_quat)), -1)

    Minv = spd_inv(dyn.M)
    Mx_inv = dyn.Mx_inv
    det = torch.linalg.det(Mx_inv)
    eye6 = torch.eye(6, dtype=J.dtype, device=J.device)
    Mx = torch.where(
        (torch.abs(det) >= 1e-2)[..., None, None],
        spd_inv(Mx_inv + 1e-30 * eye6),
        torch.linalg.pinv(Mx_inv, rtol=1e-2))

    D = 2.0 * p.damping_ratio * torch.sqrt(p.K)
    mu = mv(Mx, mv(J @ Minv, dyn.h) - mv(dyn.jac_dot, qd))
    tau = mv(J.mT, mv(Mx, p.K * twist - D * mv(J, qd) + mu))

    Jbar = Minv @ J.mT @ Mx
    ddq = p.K_null * (p.q0 - dyn.q) \
        - 2.0 * p.damping_ratio * torch.sqrt(p.K_null) * qd
    tau = tau + mv(torch.eye(7, dtype=J.dtype, device=J.device)
                    - J.mT @ Jbar.mT, ddq)
    if p.gravity_compensation:
        tau = tau + dyn.h

    tau = torch.clamp(tau, p.taumin, p.taumax)
    tau_f = p.lowpass_alpha * tau + (1.0 - p.lowpass_alpha) * carry.prev_tau
    return (OpspaceCarry(prev_tau=tau_f), tau_f,
            torch.linalg.vector_norm(twist, dim=-1))
