"""Dual-arm coordination (DACTL): tray pose -> end-effector targets (port
of `dart_tpu.control.dualarm`, the reference's `PMPC/src/dualctl.py:7-66`).

The two grasp transforms are the rigid tray-grasp offsets fixed at grasp
time: +-0.175 m along the tray x-axis with fixed relative orientations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dart_tpu_torch.utils.device import constant
from dart_tpu_torch.utils.quat import quat_mul, quat_rotate

# Grasp transforms (`dualctl.py:32-33`), scalar-first quaternions.
L_GRASP_POS = (-0.175, 0.0, 0.0)
L_GRASP_QUAT = (0.5, 0.5, 0.5, 0.5)
R_GRASP_POS = (0.175, 0.0, 0.0)
R_GRASP_QUAT = (0.5, -0.5, -0.5, 0.5)


class EEPose(NamedTuple):
    pos: torch.Tensor    # (..., 3)
    quat: torch.Tensor   # (..., 4) scalar-first


def resolve_ee_targets(obj_pos: torch.Tensor, obj_quat: torch.Tensor):
    """Desired tray pose (..., 3), (..., 4) -> (left EE target, right EE
    target): EE = T_obj * T_grasp, position obj_pos + R(obj_quat) @
    grasp_pos, orientation obj_quat * grasp_quat (`dualctl.py:43-49`)."""

    def c(x):
        return constant(x, obj_pos.dtype, obj_pos.device)

    left = EEPose(pos=obj_pos + quat_rotate(obj_quat, c(L_GRASP_POS)),
                  quat=quat_mul(obj_quat, c(L_GRASP_QUAT)))
    right = EEPose(pos=obj_pos + quat_rotate(obj_quat, c(R_GRASP_POS)),
                   quat=quat_mul(obj_quat, c(R_GRASP_QUAT)))
    return left, right
