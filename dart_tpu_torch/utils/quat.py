"""Quaternion / rotation utilities, scalar-first [w, x, y, z] (port of
`dart_tpu.utils.quat`).

The Euler->quaternion tray-tilt conversion of the reference drivers, the
grasp-transform composition of DACTL and the quaternion-error ->
rotation-vector of the arm impedance controller. Every function works on
any leading shape: quaternions (..., 4), vectors (..., 3), matrices
(..., 3, 3). The JAX module's `matrix_to_quat` reads one matrix (it
indexes `R[2, 1]` and takes `jnp.trace`) and batches only under `vmap`;
this one indexes `R[..., 2, 1]`.
"""

from __future__ import annotations

import torch

from dart_tpu_torch.utils.device import constant


def quat_mul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q * r, scalar-first."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rw, rx, ry, rz = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return torch.stack([
        qw * rw - qx * rx - qy * ry - qz * rz,
        qw * rx + qx * rw + qy * rz - qz * ry,
        qw * ry - qx * rz + qy * rw + qz * rx,
        qw * rz + qx * ry - qy * rx + qz * rw,
    ], -1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions). Mirrors mju_negQuat."""
    return q * constant((1.0, -1.0, -1.0, -1.0), q.dtype, q.device)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by unit quaternion q (w,x,y,z)."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def matrix_to_quat(R: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> scalar-first unit quaternion (trace
    method with a positive-trace guard; adequate away from pi rotations,
    which the tray and EE frames never reach)."""
    t = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = torch.sqrt(torch.clamp(1.0 + t, min=eps)) / 2.0
    d = torch.clamp(4.0 * w, min=eps)
    x = (R[..., 2, 1] - R[..., 1, 2]) / d
    y = (R[..., 0, 2] - R[..., 2, 0]) / d
    z = (R[..., 1, 0] - R[..., 0, 1]) / d
    return quat_normalize(torch.stack([w, x, y, z], -1))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix from unit quaternion (scalar-first)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return r.reshape(*q.shape[:-1], 3, 3)


def quat_from_euler_xyz(angles: torch.Tensor) -> torch.Tensor:
    """Extrinsic x-y-z Euler angles -> scalar-first quaternion, R = Rz(c)
    @ Ry(b) @ Rx(a) (scipy's `from_euler('xyz')`, scalar-first)."""
    half = angles * 0.5
    cx, cy, cz = (torch.cos(half[..., 0]), torch.cos(half[..., 1]),
                  torch.cos(half[..., 2]))
    sx, sy, sz = (torch.sin(half[..., 0]), torch.sin(half[..., 1]),
                  torch.sin(half[..., 2]))
    return torch.stack([
        cx * cy * cz + sx * sy * sz,
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
    ], -1)


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """Extrinsic x-y-z Euler angles from a unit quaternion (the inverse of
    `quat_from_euler_xyz`; scipy's `as_euler('xyz')`)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - x * z), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], -1)


def quat_to_rotvec(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation vector (axis * angle) from a unit quaternion (scipy's
    `as_rotvec()`), with the scalar part made non-negative first."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    sin_half = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half[..., 0], w)[..., None]
    # angle/sin(angle/2), with its series 2 + angle^2/12 near zero.
    scale = torch.where(sin_half > eps,
                        angle / torch.clamp(sin_half, min=eps),
                        2.0 + angle * angle / 12.0)
    return scale * v


def rotvec_to_quat(rv: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit quaternion from a rotation vector."""
    angle = torch.linalg.vector_norm(rv, dim=-1, keepdim=True)
    half = 0.5 * angle
    # sin(half)/angle, with its series 0.5 - angle^2/48 near zero.
    k = torch.where(angle > eps, torch.sin(half) / torch.clamp(angle, min=eps),
                    0.5 - angle * angle / 48.0)
    return torch.cat([torch.cos(half), k * rv], -1)


def tilt_to_quat(u: torch.Tensor) -> torch.Tensor:
    """Tray tilt command u = [theta_x, theta_y] -> tray target quaternion:
    `Rot.from_euler('xyz', [u1, -u0, 0])`, scalar-first (`PMPC/main.py:
    107-116`, `RMPC/dev_dual/rob_ctrl.py:355`, `LMPC/src/run.py:259-261`)."""
    angles = torch.stack([u[..., 1], -u[..., 0], torch.zeros_like(u[..., 0])],
                         -1)
    return quat_from_euler_xyz(angles)


def quat_error_rotvec(target_quat: torch.Tensor,
                      current_quat: torch.Tensor) -> torch.Tensor:
    """Rotation vector taking the current orientation to the target
    (mju_negQuat -> mju_mulQuat -> as_rotvec, `PMPC/src/controller/arm.py:
    176-183`)."""
    return quat_to_rotvec(quat_mul(target_quat, quat_conj(current_quat)))
