"""Rigid-body dynamics of serial revolute chains, the xArm7 arms (port of
`dart_tpu.physics.chain`).

Replaces the MuJoCo dynamics queries of the reference's arm controller
(`PMPC/src/controller/arm.py:111-199`: `mj_jacBody`, `mj_fullM`,
`mj_solveM`, `mj_jacDot`, `qfrc_bias`, body poses), all from one
forward-kinematics function:

- world joint frames down the chain;
- Jacobians in closed form (revolute columns a_j x (p - p_j));
- the mass matrix in the Gauss composite form M = sum_i (m_i Jc_i' Jc_i
  + Jw_i' I_i Jw_i) + diag(armature);
- bias forces by autodiff of the Lagrangian: h = Mdot qd - dL/dq (==
  Coriolis + gravity == mj qfrc_bias), Mdot qd a `jvp` of M(q) qd along
  qd, dL/dq a gradient of L = T - V;
- Jdot as a `jvp` of the Jacobian along qd (replacing mj_jacDot);
- all of them from one forward pass on dual numbers and one reverse pass
  (`dynamics_terms`);
- forward dynamics and a semi-implicit Euler plant step, with the joint
  damping, armature and frictionloss of the MJCF defaults.

Every function works on a leading lane shape: q and qd (..., 7), and each
`ChainParams` leaf either one chain's (as `make_xarm7_chain` builds it)
or with leading axes that broadcast against q's, so the two arms of a
dual-arm scene run as one batch with a chain per lane. Lanes are
independent, so a gradient of the sum over lanes is each lane's gradient.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from dart_tpu_torch.ops.qp import mv, spd_solve
from dart_tpu_torch.physics import xarm7_data as DATA
from dart_tpu_torch.utils.device import constant, resolve
from dart_tpu_torch.utils.quat import quat_to_matrix

GRAVITY = 9.81
N_JOINTS = 7
N_BODIES = 8

# ACTIVE[i][j]: joint j moves body i (j <= i), for all bodies at once.
_ACTIVE = tuple(tuple(float(j <= i) for j in range(N_JOINTS))
                for i in range(N_BODIES))


class ChainParams(NamedTuple):
    """Static description of one chain (8 bodies: link1..7 + lumped
    gripper). Offsets are parent-frame; joints rotate about the body-frame
    z axis and sit at the body origin."""

    base_pos: torch.Tensor        # (..., 3) world position of the root frame
    base_quat: torch.Tensor       # (..., 4) world orientation of the root
    body_pos: torch.Tensor        # (..., 8, 3) offset from the parent frame
    body_quat: torch.Tensor       # (..., 8, 4)
    mass: torch.Tensor            # (..., 8)
    com: torch.Tensor             # (..., 8, 3) body-frame COM
    inertia: torch.Tensor         # (..., 8, 3, 3) about the COM, body frame
    damping: torch.Tensor         # (..., 7)
    armature: torch.Tensor        # (..., 7)
    frictionloss: torch.Tensor    # (..., 7)
    q_lo: torch.Tensor            # (..., 7)
    q_hi: torch.Tensor            # (..., 7)


def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """`quat_to_matrix` of one quaternion in float64 numpy."""
    return quat_to_matrix(torch.from_numpy(np.asarray(q, np.float64))).numpy()


def make_xarm7_chain(world_pos=(0.0, 0.0, 0.0),
                     world_quat=(1.0, 0.0, 0.0, 0.0),
                     dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cuda") -> ChainParams:
    """One xArm7 chain from the extracted MJCF data, built in float64 and
    cast to `dtype` once at the end.

    `world_pos/quat` place the enclosing virtual-link frame (the reference
    mounts the chains at (-0.7,0,-0.12)/quat(.707,0,0,-.707) and mirrored,
    `RMPC/models_dual/xarm7/world_general.xml:124-131`); the chain's own
    `L_link_base` offset (0,0,0.12) is composed in here. (The JAX module
    takes its two rotations, of `world_quat` and of each inertia frame,
    through `jnp` and so in float32 unless x64 is on: its float32 chain is
    not its float64 one rounded once, this one is.)"""
    dev = resolve(device)
    wq = np.asarray(world_quat, np.float64)
    wq = wq / np.linalg.norm(wq)
    wR = _quat_to_matrix_np(wq)
    bp = np.asarray(world_pos) + wR @ np.asarray(DATA.BASE["pos"])
    bq_local = np.asarray(DATA.BASE["quat"], np.float64)

    def qmul(q, r):
        w1, x1, y1, z1 = q
        w2, x2, y2, z2 = r
        return np.array([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ])

    bq = qmul(wq, bq_local / np.linalg.norm(bq_local))

    body_pos, body_quat, mass, com, inertia = [], [], [], [], []
    for link in DATA.LINKS:
        q = np.asarray(link["quat"], np.float64)
        body_pos.append(link["pos"])
        body_quat.append(q / np.linalg.norm(q))
        mass.append(link["mass"])
        com.append(link["com"])
        iq = np.asarray(link["icom_quat"], np.float64)
        R = _quat_to_matrix_np(iq / np.linalg.norm(iq))
        inertia.append(R @ np.diag(link["diaginertia"]) @ R.T)
    g = DATA.GRIPPER
    gq = np.asarray(g["quat"], np.float64)
    body_pos.append(g["pos"])
    body_quat.append(gq / np.linalg.norm(gq))
    mass.append(g["mass"])
    com.append(g["com"])
    inertia.append(np.asarray(g["inertia_full"]))

    def a(x):
        return torch.tensor(np.asarray(x, np.float64), dtype=dtype,
                            device=dev)

    return ChainParams(
        base_pos=a(bp), base_quat=a(bq),
        body_pos=a(body_pos), body_quat=a(body_quat),
        mass=a(mass), com=a(com), inertia=a(inertia),
        damping=a([lk["damping"] for lk in DATA.LINKS]),
        armature=a(DATA.ARMATURE),
        frictionloss=a(DATA.FRICTIONLOSS),
        q_lo=a([lk["range"][0] for lk in DATA.LINKS]),
        q_hi=a([lk["range"][1] for lk in DATA.LINKS]),
    )


def _rz(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(theta)
    o = torch.ones_like(theta)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


class FK(NamedTuple):
    R: torch.Tensor       # (..., 8, 3, 3) world orientations (after joints)
    p: torch.Tensor       # (..., 8, 3) world body-frame origins (anchors)
    axis: torch.Tensor    # (..., 7, 3) world joint axes
    com: torch.Tensor     # (..., 8, 3) world COM positions


# The rotations of a chain's base and body-offset quaternions, constants of
# the chain, memoised per quaternion tensor (an entry lives as long as its
# tensor and is dropped if the tensor is written): every FK of a world
# step shares them.
_ROTATIONS: dict[int, tuple] = {}


def _offset_rotations(params: ChainParams):
    bq, base = params.body_quat, params.base_quat
    hit = _ROTATIONS.get(id(bq))
    if (hit is not None and hit[0]() is bq and hit[1]() is base
            and hit[2] == (bq._version, base._version)):
        return hit[3], hit[4]
    R_base, R_off = quat_to_matrix(base), quat_to_matrix(bq)
    key = id(bq)
    _ROTATIONS[key] = (weakref.ref(bq), weakref.ref(base),
                       (bq._version, base._version), R_base, R_off)
    weakref.finalize(bq, _ROTATIONS.pop, key, None)
    return R_base, R_off


def fk(params: ChainParams, q: torch.Tensor) -> FK:
    R_par, R_off = _offset_rotations(params)
    p_par = params.base_pos
    rz = _rz(q)
    Rs, ps = [], []
    for i in range(N_BODIES):
        p_i = p_par + mv(R_par, params.body_pos[..., i, :])
        R_i = R_par @ R_off[..., i, :, :]
        if i < N_JOINTS:
            R_i = R_i @ rz[..., i, :, :]
        Rs.append(R_i)
        ps.append(p_i)
        R_par, p_par = R_i, p_i
    R = torch.stack(torch.broadcast_tensors(*Rs), -3)
    p = torch.stack(torch.broadcast_tensors(*ps), -2)
    axis = R[..., :N_JOINTS, :, 2]      # z column (Rz keeps the z axis)
    com = p + mv(R, params.com)
    return FK(R=R, p=p, axis=axis, com=com)


def point_jacobian(f: FK, point: torch.Tensor, body: int) -> torch.Tensor:
    """(..., 6, 7) world Jacobian [Jv; Jw] of a world-frame point (..., 3)
    on `body`."""
    active = constant(_ACTIVE[body], point.dtype, point.device)
    a = f.axis * active[:, None]                            # (..., 7, 3)
    r = point[..., None, :] - f.p[..., :N_JOINTS, :]
    a, r = torch.broadcast_tensors(a, r)
    cols_v = torch.linalg.cross(a, r)
    return torch.cat([cols_v.mT, a.mT], -2)


def body_jacobian(params: ChainParams, q: torch.Tensor,
                  body: int = 7) -> torch.Tensor:
    """Jacobian of the body-frame origin (== mj_jacBody, `arm.py:120-126`)."""
    f = fk(params, q)
    return point_jacobian(f, f.p[..., body, :], body)


def mass_matrix_fk(params: ChainParams, f: FK) -> torch.Tensor:
    """`mass_matrix` from the FK it evaluates (shared where the same q has
    one already): the 8 bodies' COM Jacobians at once."""
    active = constant(_ACTIVE, f.p.dtype, f.p.device)
    a = f.axis[..., None, :, :] * active[:, :, None]        # (..., 8, 7, 3)
    r = f.com[..., :, None, :] - f.p[..., None, :N_JOINTS, :]
    a, r = torch.broadcast_tensors(a, r)
    Jv = torch.linalg.cross(a, r)                           # (..., 8, 7, 3)
    I_w = f.R @ params.inertia @ f.R.mT                     # (..., 8, 3, 3)
    M = torch.diag_embed(params.armature) \
        + torch.einsum("...i,...ijc,...ikc->...jk", params.mass, Jv, Jv) \
        + torch.einsum("...ijc,...icd,...ikd->...jk", a, I_w, a)
    return 0.5 * (M + M.mT)


def mass_matrix(params: ChainParams, q: torch.Tensor) -> torch.Tensor:
    """(..., 7, 7) joint-space inertia incl. armature (== mj_fullM)."""
    return mass_matrix_fk(params, fk(params, q))


def potential_energy(params: ChainParams, q: torch.Tensor) -> torch.Tensor:
    f = fk(params, q)
    return GRAVITY * (params.mass * f.com[..., 2]).sum(-1)


def _point(f: FK, body: int, offset, dtype, device) -> torch.Tensor:
    point = f.p[..., body, :]
    if offset is not None:
        point = point + mv(f.R[..., body, :, :],
                           constant(tuple(offset), dtype, device))
    return point


class DynamicsTerms(NamedTuple):
    f: FK                 # fk at q
    M: torch.Tensor       # (..., 7, 7) mass matrix
    h: torch.Tensor       # (..., 7) bias forces
    J: torch.Tensor       # (..., 6, 7) Jacobian of the body point
    Jdot: torch.Tensor    # (..., 6, 7) its rate along qd


def dynamics_terms(params: ChainParams, q: torch.Tensor, qd: torch.Tensor,
                   body: int = 7, local_offset=None) -> DynamicsTerms:
    """FK, M, the bias forces and the Jacobian of a body point with its
    rate, all at (q, qd), by autodiff of FK: one forward pass on dual
    numbers (q with tangent qd) carries the `jvp`s of M(q) qd and of the
    point's Jacobian, and one reverse pass the gradient of the Lagrangian
    L = T - V = 1/2 qd' M(q) qd - V(q); then h = Mdot qd - dL/dq (==
    Coriolis + gravity == mjData.qfrc_bias, `arm.py:155`). The JAX module
    takes the same derivatives as four traces of FK (`jax.jvp` of M qd,
    `jax.grad` of T and of V, `jax.jvp` of J); one pass of
    `torch.autograd`'s dual numbers and one backward give them with a
    third of the host's ops, to round-off the same."""
    with torch.enable_grad():
        q_ = q.detach().requires_grad_(True)
        with fwAD.dual_level():
            fd = fk(params, fwAD.make_dual(q_, qd))
            Md = mass_matrix_fk(params, fd)
            Jd = point_jacobian(fd, _point(fd, body, local_offset, q.dtype,
                                           q.device), body)
            Mdot_qd = fwAD.unpack_dual(mv(Md, qd)).tangent
            M = fwAD.unpack_dual(Md).primal
            J, Jdot = fwAD.unpack_dual(Jd)
            f = FK(*(fwAD.unpack_dual(x).primal for x in fd))
        T = 0.5 * torch.einsum("...j,...jk,...k->...", qd, M, qd)
        V = GRAVITY * (params.mass * f.com[..., 2]).sum(-1)
        dLdq, = torch.autograd.grad((T - V).sum(), q_)
    return DynamicsTerms(FK(*(x.detach() for x in f)), M.detach(),
                         (Mdot_qd - dLdq).detach(), J.detach(),
                         Jdot.detach())


def bias_forces(params: ChainParams, q: torch.Tensor,
                qd: torch.Tensor) -> torch.Tensor:
    """Coriolis + gravity (== mjData.qfrc_bias, `arm.py:155`):
    h = Mdot qd - dL/dq, by autodiff of FK (`dynamics_terms`)."""
    return dynamics_terms(params, q, qd).h


def jac_and_jacdot(params: ChainParams, q: torch.Tensor, qd: torch.Tensor,
                   body: int = 7, local_offset=None):
    """J and Jdot at a body point (replacing mj_jacBody + mj_jacDot), Jdot
    the `jvp` of the Jacobian along qd (`dynamics_terms`). `local_offset`
    is in the body frame (the reference's +0.125 m tool offset along the
    EE z axis, `arm.py:142-152, 157-165`)."""
    t = dynamics_terms(params, q, qd, body, local_offset)
    return t.J, t.Jdot


def forward_dynamics(params: ChainParams, q: torch.Tensor, qd: torch.Tensor,
                     tau: torch.Tensor, f_ext=None, ee_body: int = 7,
                     ee_offset=None, M: torch.Tensor | None = None,
                     h: torch.Tensor | None = None,
                     f: FK | None = None) -> torch.Tensor:
    """qdd given applied torques and an optional EE wrench f_ext (..., 6)
    (world [F; T]). `M`, `h` and `f`, where given, are `mass_matrix`,
    `bias_forces` and `fk` at these (q, qd), computed once for the
    controller."""
    if M is None:
        M = mass_matrix(params, q)
    if h is None:
        h = bias_forces(params, q, qd)
    passive = -params.damping * qd - params.frictionloss * torch.tanh(
        qd / 1e-3)
    rhs = tau + passive - h
    if f_ext is not None:
        if f is None:
            f = fk(params, q)
        J = point_jacobian(f, _point(f, ee_body, ee_offset, q.dtype,
                                     q.device), ee_body)
        rhs = rhs + mv(J.mT, f_ext)
    return spd_solve(M, rhs[..., None])[..., 0]


def step(params: ChainParams, q: torch.Tensor, qd: torch.Tensor,
         tau: torch.Tensor, dt: float, f_ext=None,
         M: torch.Tensor | None = None, h: torch.Tensor | None = None,
         f: FK | None = None):
    """Semi-implicit Euler plant step (MuJoCo-style velocity-first).
    Returns (q', qd')."""
    qdd = forward_dynamics(params, q, qd, tau, f_ext=f_ext, M=M, h=h, f=f)
    qd_new = qd + dt * qdd
    q_new = q + dt * qd_new
    return q_new, qd_new
