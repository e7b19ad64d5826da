"""PMPC, RMPC and LMPC optimal-control problems (port of
`dart_tpu.solver.ocp`).

PMPC mirrors the reference NLP `PMPC/src/controller/mpc_3d.py:36-85`
(nx=6, nu=2); RMPC the adaptive NLP of
`RMPC/dev_dual/controller/np_mpc_adaptive_with_linear_regressor.py:76-168`
(nx=4, nu=2, state augmented with the previous tilt, z = [x, u_prev]);
LMPC the learning-enhanced NLP of `LMPC/src/controller/rlmpc2.py:236-491`
(nx=8, nu=2, 34 model parameters, z = [x, u_prev], nz=10).

Every function is written with ``...`` indexing: it takes a batch (B, nz)
with per-lane cost data (B, ...), or one lane under `torch.func.vmap`, as
the generic linearisation of `solver.ilqr` calls it. Wherever a clip or a
max is differentiated (`_clip`, the PHR penalty), it is written with
`torch.minimum`/`torch.maximum`, whose derivative at a tie is 0.5 like
`jnp.clip`/`jnp.maximum`'s; `torch.clamp` would give 1 there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dart_tpu_torch.models import dynamics as dyn
from dart_tpu_torch.solver.ilqr import OCPDef


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip with its derivative: 0.5 at a bound, NaN propagated."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def _zeros(like: torch.Tensor, *shape: int) -> torch.Tensor:
    """Zeros of trailing `shape` with `like`'s leading dims (all but the
    last), dtype and device."""
    return torch.zeros((*like.shape[:-1], *shape), dtype=like.dtype,
                       device=like.device)


def _stage(ref: torch.Tensor, k) -> torch.Tensor:
    """Row k of a (..., N+1, 4) reference; k is an int, or a 0-d index
    tensor under `torch.func.vmap` (where plain indexing would sync)."""
    if isinstance(k, int):
        return ref[..., k, :]
    return torch.index_select(ref, -2, k.reshape(1)).squeeze(-2)


class PMPCAux(NamedTuple):
    """Per-solve cost data, batch-first: target (B, 6), Qp/Qv/R (B,)."""

    target: torch.Tensor         # (B, 6) reference state
    Qp: torch.Tensor             # (B,) position weight
    Qv: torch.Tensor             # (B,) velocity weight
    R: torch.Tensor              # (B,) control weight


def _pmpc_w(aux: PMPCAux, dtype) -> torch.Tensor:
    """Diagonal state weights (B, 6): Qp on positions, Qv on velocities."""
    dev = aux.Qp.device
    sel_p = torch.tensor([1, 0, 1, 0, 0, 0], dtype=dtype, device=dev)
    sel_v = torch.tensor([0, 1, 0, 1, 0, 0], dtype=dtype, device=dev)
    return aux.Qp[..., None] * sel_p + aux.Qv[..., None] * sel_v


def _sq_err(z, target, i, j):
    return (z[..., i] - target[..., i]) ** 2 + (z[..., j] - target[..., j]) ** 2


def make_pmpc_ocp(dt: float = 0.002, u_bound: float = 0.6,
                  fast: bool = False) -> OCPDef:
    step_x = dyn.discretize(dyn.pmpc_dynamics, dt)

    def stage_cost(z, v, k, aux: PMPCAux):
        return (aux.Qp * _sq_err(z, aux.target, 0, 2)
                + aux.Qv * _sq_err(z, aux.target, 1, 3)
                + aux.R * torch.sum(v ** 2, dim=-1))

    def term_cost(z, aux: PMPCAux):
        return (aux.Qp * _sq_err(z, aux.target, 0, 2)
                + aux.Qv * _sq_err(z, aux.target, 1, 3))

    # Closed-form linearisation (fast=True), see dynamics.pmpc_jac.
    def dyn_jac(z, v, p):
        return dyn.rk4_jac(dyn.pmpc_dynamics, dyn.pmpc_jac, z, v, p, dt)

    def cost_quad(k, z, v, lam_k, mu, aux: PMPCAux):
        w = _pmpc_w(aux, z.dtype)
        R = aux.R[..., None, None]
        eye2 = torch.eye(2, dtype=z.dtype, device=z.device)
        return (2.0 * w * (z - aux.target), 2.0 * aux.R[..., None] * v,
                2.0 * torch.diag_embed(w), _zeros(w, 2, 6), 2.0 * R * eye2)

    def term_quad(z, aux: PMPCAux):
        w = _pmpc_w(aux, z.dtype)
        return 2.0 * w * (z - aux.target), 2.0 * torch.diag_embed(w)

    return OCPDef(
        step=step_x,
        stage_cost=stage_cost,
        term_cost=term_cost,
        u_lo=(-u_bound, -u_bound),
        u_hi=(u_bound, u_bound),
        dyn_jac=dyn_jac if fast else None,
        cost_quad=cost_quad if fast else None,
        term_quad=term_quad if fast else None,
    )


class RMPCAux(NamedTuple):
    """Per-solve cost data: ref (..., N+1, 4) staged reference, weights
    Qp/Qv/Ru/Rdu per lane."""

    ref: torch.Tensor
    Qp: torch.Tensor
    Qv: torch.Tensor
    Ru: torch.Tensor
    Rdu: torch.Tensor


def _rmpc_w4(aux: RMPCAux) -> torch.Tensor:
    return torch.stack([aux.Qp, aux.Qv, aux.Qp, aux.Qv], dim=-1)


def _track_cost(z, r, aux: RMPCAux) -> torch.Tensor:
    pos_err = torch.stack([z[..., 0] - r[..., 0], z[..., 2] - r[..., 2]], -1)
    vel_err = torch.stack([z[..., 1] - r[..., 1], z[..., 3] - r[..., 3]], -1)
    return (aux.Qp * torch.sum(pos_err ** 2, dim=-1)
            + aux.Qv * torch.sum(vel_err ** 2, dim=-1))


def _vcap(z, vmax: float) -> torch.Tensor:
    """Velocity caps |vx|, |vy| <= vmax as four rows c <= 0.

    vmax is subtracted from the stacked (..., 4) rows, not from each 0-d
    lane entry: under `torch.func.hessian` a python float meeting a 0-d
    tensor promotes it to float64."""
    v = torch.stack([z[..., 1], -z[..., 1], z[..., 3], -z[..., 3]], -1)
    return v - vmax


def _rmpc_term_quad(z, aux: RMPCAux):
    w4 = _rmpc_w4(aux).to(z.dtype)
    e4 = z[..., :4] - aux.ref[..., -1, :]
    z2 = torch.zeros_like(w4[..., :2])
    return (torch.cat([2.0 * w4 * e4, z2], -1),
            2.0 * torch.diag_embed(torch.cat([w4, z2], -1)))


def _blocks(a, b, c, d) -> torch.Tensor:
    """[[a, b], [c, d]] from (..., n, m) blocks."""
    return torch.cat([torch.cat([a, b], -1), torch.cat([c, d], -1)], -2)


def make_rmpc_ocp(dt: float = 0.002, u_bound: float = 0.4,
                  du_bound: float = 0.05, vmax: float = 0.25,
                  fast: bool = False) -> OCPDef:
    """State z = [px, vx, py, vy, u_prev0, u_prev1] (nz=6). Constraints
    (c <= 0), 8 per stage: du - du_hi, du_lo - du (two controls each) and
    the four velocity caps."""
    step_x = dyn.discretize(dyn.rmpc_dynamics, dt)

    def step(z, v, p):
        return torch.cat([step_x(z[..., :4], v, p), v], -1)

    def stage_cost(z, v, k, aux: RMPCAux):
        du = v - z[..., 4:6]
        return (_track_cost(z, _stage(aux.ref, k), aux)
                + aux.Ru * torch.sum(v ** 2, dim=-1)
                + aux.Rdu * torch.sum(du ** 2, dim=-1))

    def term_cost(z, aux: RMPCAux):
        return _track_cost(z, aux.ref[..., -1, :], aux)

    def constraints(z, v, k, aux: RMPCAux):
        du = v - z[..., 4:6]
        return torch.cat([du - du_bound, -du_bound - du, _vcap(z, vmax)], -1)

    def dyn_jac(z, v, p):
        Ad, Bd = dyn.rk4_jac(dyn.rmpc_dynamics, dyn.rmpc_jac, z[..., :4], v,
                             p, dt)
        z42 = torch.zeros_like(Bd)
        z24 = torch.zeros_like(Ad[..., :2, :])
        eye2 = torch.eye(2, dtype=z.dtype, device=z.device).expand_as(
            z24[..., :2])
        A = _blocks(Ad, z42, z24, torch.zeros_like(eye2))
        return A, torch.cat([Bd, eye2], -2)

    def cost_quad(k, z, v, lam_k, mu, aux: RMPCAux):
        dtype = z.dtype
        w4 = _rmpc_w4(aux).to(dtype)
        Ru, Rdu = aux.Ru[..., None], aux.Rdu[..., None]
        e4 = z[..., :4] - _stage(aux.ref, k)
        du = v - z[..., 4:6]
        t = torch.maximum(torch.zeros_like(lam_k), lam_k + mu[..., None]
                          * constraints(z, v, k, aux))
        act = (t > 0).to(dtype)
        gv = t[..., 0:2] - t[..., 2:4]
        s = mu[..., None] * (act[..., 0:2] + act[..., 2:4])
        lz = torch.cat([2.0 * w4 * e4, -2.0 * Rdu * du], -1)
        lz = lz + torch.stack([
            torch.zeros_like(gv[..., 0]), t[..., 4] - t[..., 5],
            torch.zeros_like(gv[..., 0]), t[..., 6] - t[..., 7],
            -gv[..., 0], -gv[..., 1]], -1)
        lv = 2.0 * Ru * v + 2.0 * Rdu * du + gv
        lzz_d = 2.0 * torch.cat([w4, Rdu, Rdu], -1)
        lzz_d = lzz_d + torch.stack([
            torch.zeros_like(s[..., 0]), mu * (act[..., 4] + act[..., 5]),
            torch.zeros_like(s[..., 0]), mu * (act[..., 6] + act[..., 7]),
            s[..., 0], s[..., 1]], -1)
        lvv = torch.diag_embed(2.0 * (Ru + Rdu) * torch.ones_like(v) + s)
        lvz = torch.cat([_zeros(s, 2, 4), torch.diag_embed(-2.0 * Rdu - s)],
                        -1)
        return lz, lv, torch.diag_embed(lzz_d), lvz, lvv

    return OCPDef(
        step=step,
        stage_cost=stage_cost,
        term_cost=term_cost,
        u_lo=(-u_bound, -u_bound),
        u_hi=(u_bound, u_bound),
        constraints=constraints,
        n_con=8,
        dyn_jac=dyn_jac if fast else None,
        cost_quad=cost_quad if fast else None,
        term_quad=_rmpc_term_quad if fast else None,
    )


def make_rmpc_ocp_du(dt: float = 0.002, u_bound: float = 0.4,
                     du_bound: float = 0.05, vmax: float = 0.25,
                     fast: bool = False) -> OCPDef:
    """Slew-exact RMPC: the decision variable is the tilt increment v = du
    with box bounds +-du_bound, handled exactly by the DDP box QP; the
    applied tilt is u = clip(u_prev + v, +-u_bound). The velocity caps stay
    augmented-Lagrangian constraints."""
    step_x = dyn.discretize(dyn.rmpc_dynamics, dt)

    def u_of(z, v):
        return _clip(z[..., 4:6] + v, -u_bound, u_bound)

    def step(z, v, p):
        u = u_of(z, v)
        return torch.cat([step_x(z[..., :4], u, p), u], -1)

    def stage_cost(z, v, k, aux: RMPCAux):
        u = u_of(z, v)
        return (_track_cost(z, _stage(aux.ref, k), aux)
                + aux.Ru * torch.sum(u ** 2, dim=-1)
                + aux.Rdu * torch.sum(v ** 2, dim=-1))

    def term_cost(z, aux: RMPCAux):
        return _track_cost(z, aux.ref[..., -1, :], aux)

    def constraints(z, v, k, aux: RMPCAux):
        return _vcap(z, vmax)

    def mask(z, v):
        # Clip pass-through mask, strictly inside (the bound set has
        # measure zero on the solve path).
        return (torch.abs(z[..., 4:6] + v) < u_bound).to(z.dtype)

    def dyn_jac(z, v, p):
        u = u_of(z, v)
        m = mask(z, v)
        Ad, Bd = dyn.rk4_jac(dyn.rmpc_dynamics, dyn.rmpc_jac, z[..., :4], u,
                             p, dt)
        Bm = Bd * m[..., None, :]
        Dm = torch.diag_embed(m)
        A = _blocks(Ad, Bm, torch.zeros_like(Ad[..., :2, :]), Dm)
        return A, torch.cat([Bm, Dm], -2)

    def cost_quad(k, z, v, lam_k, mu, aux: RMPCAux):
        dtype = z.dtype
        u = u_of(z, v)
        m = mask(z, v)
        w4 = _rmpc_w4(aux).to(dtype)
        e4 = z[..., :4] - _stage(aux.ref, k)
        gu = 2.0 * aux.Ru[..., None] * u * m
        hu = 2.0 * aux.Ru[..., None] * m
        t = torch.maximum(torch.zeros_like(lam_k), lam_k + mu[..., None]
                          * constraints(z, v, k, aux))
        act = (t > 0).to(dtype)
        zero = torch.zeros_like(hu[..., 0])
        lz = torch.cat([2.0 * w4 * e4, gu], -1) + torch.stack([
            zero, t[..., 0] - t[..., 1], zero, t[..., 2] - t[..., 3],
            zero, zero], -1)
        lv = 2.0 * aux.Rdu[..., None] * v + gu
        lzz_d = torch.cat([2.0 * w4, hu], -1) + torch.stack([
            zero, mu * (act[..., 0] + act[..., 1]),
            zero, mu * (act[..., 2] + act[..., 3]), zero, zero], -1)
        lvv = torch.diag_embed(2.0 * aux.Rdu[..., None] + hu)
        lvz = torch.cat([_zeros(hu, 2, 4), torch.diag_embed(hu)], -1)
        return lz, lv, torch.diag_embed(lzz_d), lvz, lvv

    return OCPDef(
        step=step,
        stage_cost=stage_cost,
        term_cost=term_cost,
        u_lo=(-du_bound, -du_bound),
        u_hi=(du_bound, du_bound),
        constraints=constraints,
        n_con=4,
        dyn_jac=dyn_jac if fast else None,
        cost_quad=cost_quad if fast else None,
        term_quad=_rmpc_term_quad if fast else None,
    )


class LMPCAux(NamedTuple):
    """Per-solve cost data, batch-first: target (B, 8) constant reference,
    Q (B, 8) stage state weights, R (B, 4) weights on [u0, u1, du0, du1],
    Qt (B, 8) terminal state weights."""

    target: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    Qt: torch.Tensor


def make_lmpc_ocp(dt: float = 0.002, u_bound: float = 0.4,
                  fast: bool = False) -> OCPDef:
    """State z = [x(8), u_prev(2)] (nz=10); params = raw 34-vector. No
    python float meets a 0-d lane value of z or v in `step` or the costs,
    so the generic linearisation keeps the input dtype under
    `torch.func.jacfwd`/`hessian`."""
    step_x = dyn.discretize(dyn.lmpc_dynamics, dt)

    def step(z, v, p):
        return torch.cat([step_x(z[..., :8], v, p), v], -1)

    def stage_cost(z, v, k, aux: LMPCAux):
        e = z[..., :8] - aux.target
        du = v - z[..., 8:10]
        ctrl = torch.cat([v, du], -1)
        return (torch.sum(aux.Q * e * e, dim=-1)
                + torch.sum(aux.R * ctrl * ctrl, dim=-1))

    def term_cost(z, aux: LMPCAux):
        e = z[..., :8] - aux.target
        return torch.sum(aux.Qt * e * e, dim=-1)

    def dyn_jac(z, v, p):
        Ad, Bd = dyn.rk4_jac(dyn.lmpc_dynamics, dyn.lmpc_jac, z[..., :8], v,
                             p, dt)
        eye2 = torch.eye(2, dtype=z.dtype, device=z.device).expand(
            *Bd.shape[:-2], 2, 2)
        A = _blocks(Ad, torch.zeros_like(Bd), torch.zeros_like(Bd).mT,
                    torch.zeros_like(eye2))
        return A, torch.cat([Bd, eye2], -2)

    def cost_quad(k, z, v, lam_k, mu, aux: LMPCAux):
        dtype = z.dtype
        Q = aux.Q.to(dtype)
        Ru, Rdu = aux.R[..., 0:2].to(dtype), aux.R[..., 2:4].to(dtype)
        e = z[..., :8] - aux.target
        du = v - z[..., 8:10]
        lz = torch.cat([2.0 * Q * e, -2.0 * Rdu * du], -1)
        lv = 2.0 * Ru * v + 2.0 * Rdu * du
        lzz = 2.0 * torch.diag_embed(torch.cat([Q, Rdu], -1))
        lvv = 2.0 * torch.diag_embed(Ru + Rdu)
        lvz = torch.cat([_zeros(Rdu, 2, 8), torch.diag_embed(-2.0 * Rdu)],
                        -1)
        return lz, lv, lzz, lvz, lvv

    def term_quad(z, aux: LMPCAux):
        Qt = aux.Qt.to(z.dtype)
        e = z[..., :8] - aux.target
        z2 = torch.zeros_like(Qt[..., :2])
        return (torch.cat([2.0 * Qt * e, z2], -1),
                2.0 * torch.diag_embed(torch.cat([Qt, z2], -1)))

    return OCPDef(
        step=step,
        stage_cost=stage_cost,
        term_cost=term_cost,
        u_lo=(-u_bound, -u_bound),
        u_hi=(u_bound, u_bound),
        dyn_jac=dyn_jac if fast else None,
        cost_quad=cost_quad if fast else None,
        term_quad=term_quad if fast else None,
    )
