"""Impedance-QP arm controller, the ARMCONTROL replacement (port of
`dart_tpu.control.arm`).

The per-arm torque optimisation of `PMPC/src/controller/arm.py:338-447`:
the QP data assembled with dense linear algebra and solved by the
fixed-iteration ADMM of `ops.qp`, warm-started from the previous step,
both arms (and whole scenario batches) as lanes of one call.

The QP over qdd in R^7:

  min  E_imp' Wimp E_imp + E_pos' Wpos E_pos + qddd' Wsmooth qddd
  s.t. Qmin    <= q + qd dt + 0.5 qdd dt^2 <= Qmax      (integrated position)
       Qdotmin <= qd + qdd dt              <= Qdotmax   (integrated velocity)
       taumin  <= M qdd + h                <= taumax    (actuator torque)

with E_imp = J qdd + Jdot qd - Mx_inv F,
     F     = -D (J qd) + K twist + mu          (`arm.py:384-385`)
     mu    = Mx (J M^-1 h + Jdot qd)           (`arm.py:361`)
     D     = sqrt(Mx) sqrt(K) + sqrt(K) sqrt(Mx)  (`arm.py:363-370`)
     E_pos = qdd - beta,
     beta  = 2 sqrt(diag(K_null)) (-qd) + K_null (-q)  (`arm.py:387-389`)
     qddd  = (qdd - qdd_prev)/dt.

Returned torque: tau = M qdd* + h (`arm.py:432`), clipped to the limits.

Every `ArmDynamics`/`ArmCarry` leaf has a leading lane shape; `ArmParams`
is shared. As in the JAX module both branches of the Mx selection are
computed; the inverse is `ops.qp.spd_inv`, which raises nothing on a
singular matrix (JAX returns inf or NaN there).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dart_tpu_torch.ops.qp import mv, solve_qp_admm, spd_inv
from dart_tpu_torch.utils.device import resolve
from dart_tpu_torch.utils.quat import quat_error_rotvec


class ArmParams(NamedTuple):
    """Static controller gains/limits (the reference's L_params/R_params
    dicts, e.g. `LMPC/src/run.py:68-116`)."""

    Wimp: torch.Tensor       # (6, 6)
    Wpos: torch.Tensor       # (7, 7)
    Wsmooth: torch.Tensor    # (7, 7)
    Qmin: torch.Tensor       # (7,)
    Qmax: torch.Tensor
    Qdotmin: torch.Tensor
    Qdotmax: torch.Tensor
    taumin: torch.Tensor
    taumax: torch.Tensor
    K: torch.Tensor          # (6, 6) task stiffness
    K_null: torch.Tensor     # (7, 7) null-space stiffness
    dt: float | torch.Tensor


def default_arm_params(dt: float = 0.002, dtype=torch.float32,
                       device: torch.device | str = "cuda") -> ArmParams:
    """The xArm7 gains of the reference's run scripts (`run.py:68-116`)."""
    device = resolve(device)

    def a(x):
        return torch.tensor(x, dtype=dtype, device=device)

    return ArmParams(
        Wimp=torch.diag(a([10.0, 10.0, 10.0, 1.0, 1.0, 1.0])),
        Wpos=torch.eye(7, dtype=dtype, device=device) * 0.1,
        Wsmooth=torch.zeros((7, 7), dtype=dtype, device=device),
        Qmin=a([-6.28319, -2.059, -6.28319, -0.19198, -6.28319, -1.69297,
                -6.28319]),
        Qmax=a([6.28319, 2.0944, 6.28319, 3.927, 6.28319, 3.14159, 6.28319]),
        Qdotmin=-torch.ones(7, dtype=dtype, device=device) * 20.0,
        Qdotmax=torch.ones(7, dtype=dtype, device=device) * 20.0,
        taumin=a([-50, -50, -30, -30, -30, -20, -20]),
        taumax=a([50, 50, 30, 30, 30, 20, 20]),
        K=torch.diag(a([5000.0, 5000.0, 5000.0, 50.0, 50.0, 50.0])) * 0.1
        * 10,
        K_null=torch.eye(7, dtype=dtype, device=device),
        dt=dt,
    )


class ArmDynamics(NamedTuple):
    """Per-step dynamics snapshot (the 15-field shm schema of
    `arm.py:67-83`, minus the outputs), produced by the physics layer."""

    q: torch.Tensor          # (..., 7)
    qd: torch.Tensor         # (..., 7)
    jac: torch.Tensor        # (..., 6, 7)
    jac_dot: torch.Tensor    # (..., 6, 7)
    M: torch.Tensor          # (..., 7, 7)
    h: torch.Tensor          # (..., 7) bias forces
    Mx_inv: torch.Tensor     # (..., 6, 6) task-space inertia inverse
    ee_pos: torch.Tensor     # (..., 3)
    ee_quat: torch.Tensor    # (..., 4) scalar-first


class ArmCarry(NamedTuple):
    qdd_prev: torch.Tensor   # (..., 7)
    y: torch.Tensor          # (..., 21) ADMM dual warm start


def arm_init_carry(dtype=torch.float32, device: torch.device | str = "cuda",
                   batch: tuple[int, ...] | int = ()) -> ArmCarry:
    device = resolve(device)
    batch = (batch,) if isinstance(batch, int) else tuple(batch)
    return ArmCarry(
        qdd_prev=torch.zeros((*batch, 7), dtype=dtype, device=device),
        y=torch.zeros((*batch, 21), dtype=dtype, device=device))


def _safe_matrix_sqrt(mat: torch.Tensor) -> torch.Tensor:
    """eigh-based sqrt of |eigenvalues| (`arm.py:234-244`); the free signs
    of the eigenvectors cancel in v diag(sqrt|w|) v'."""
    w, v = torch.linalg.eigh(mat)
    return (v * torch.sqrt(torch.abs(w))[..., None, :]) @ v.mT


def compute_torque(carry: ArmCarry, dynamics: ArmDynamics,
                   target_pos: torch.Tensor, target_quat: torch.Tensor,
                   params: ArmParams, qp_iters: int = 200):
    """One impedance control step. Returns (carry', tau, loss)."""
    q, qd = dynamics.q, dynamics.qd
    J, Jd = dynamics.jac, dynamics.jac_dot
    M, h, Mx_inv = dynamics.M, dynamics.h, dynamics.Mx_inv
    dt = params.dt
    eye = torch.eye(7, dtype=q.dtype, device=q.device)

    # Task-space error twist (`arm.py:341-344` + `arm.py:176-183`).
    dx = target_pos - dynamics.ee_pos
    rotvec = quat_error_rotvec(target_quat, dynamics.ee_quat)
    twist = torch.cat(torch.broadcast_tensors(dx, rotvec), -1)

    # Dynamics quantities (`arm.py:347-370`). `jnp.linalg.pinv`'s rcond is
    # relative to the largest singular value, torch's rtol. M and Mx_inv
    # are symmetric, so their singular values are |eigenvalues| and the
    # pseudo-inverse is taken from `eigh` (JAX takes an SVD): the same
    # matrix to round-off, for one host read of the error check, not two.
    Minv = torch.linalg.pinv(M, rtol=1e-6, hermitian=True)
    det = torch.linalg.det(Mx_inv)
    Mx_direct = spd_inv(Mx_inv + 1e-30 * eye[:6, :6])
    Mx_pinv = torch.linalg.pinv(Mx_inv, rtol=1e-3, hermitian=True)
    Mx = torch.where((torch.abs(det) > 1e-8)[..., None, None], Mx_direct,
                     Mx_pinv)

    mu = mv(Mx, mv(J, mv(Minv, h)) + mv(Jd, qd))
    sqrt_Mx = _safe_matrix_sqrt(Mx)
    sqrt_K = torch.sqrt(params.K)  # K diagonal: elementwise == matrix sqrt
    D = sqrt_Mx @ sqrt_K + sqrt_K @ sqrt_Mx

    F = -mv(D, mv(J, qd)) + mv(params.K, twist) + mu
    b_imp = mv(Jd, qd) - mv(Mx_inv, F)          # E_imp = J qdd + b_imp
    beta = 2.0 * torch.sqrt(torch.diagonal(params.K_null)) * (-qd) \
        + mv(params.K_null, -q)

    # Quadratic form: cost = qdd' P/2 qdd + g' qdd + const.
    Ws = params.Wsmooth / (dt * dt)
    P = 2.0 * (J.mT @ params.Wimp @ J + params.Wpos + Ws)
    P = 0.5 * (P + P.mT)
    g = 2.0 * (mv(J.mT, mv(params.Wimp, b_imp)) - mv(params.Wpos, beta)
               - mv(Ws, carry.qdd_prev))

    # Two-sided constraints (`arm.py:399-405`).
    A = torch.cat([torch.broadcast_to(0.5 * dt * dt * eye, M.shape),
                   torch.broadcast_to(dt * eye, M.shape), M], -2)
    l = torch.cat([params.Qmin - q - qd * dt, params.Qdotmin - qd,
                   params.taumin - h], -1)
    u = torch.cat([params.Qmax - q - qd * dt, params.Qdotmax - qd,
                   params.taumax - h], -1)

    sol = solve_qp_admm(P, g, A, l, u, x0=carry.qdd_prev, y0=carry.y,
                        iters=qp_iters)
    qdd = sol.x
    # Final clamp to the actuator limits: the plant's actuators saturate at
    # forcerange anyway (world_general.xml:18-29), so residual ADMM
    # constraint slack never reaches the joints.
    tau = torch.clamp(mv(M, qdd) + h, params.taumin, params.taumax)
    e_imp = mv(J, qdd) + b_imp
    e_pos = qdd - beta
    qddd = (qdd - carry.qdd_prev) / dt
    loss = ((e_imp * mv(params.Wimp, e_imp)).sum(-1)
            + (e_pos * mv(params.Wpos, e_pos)).sum(-1)
            + (qddd * mv(params.Wsmooth, qddd)).sum(-1))
    return ArmCarry(qdd_prev=qdd, y=sol.y), tau, loss
