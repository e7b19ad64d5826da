"""PMPC optimal-control problem (port of `dart_tpu.solver.ocp`, PMPC part).

The problem mirrors the reference NLP `PMPC/src/controller/mpc_3d.py:36-85`
(nx=6, nu=2). The closed-form quadratics of the JAX `fast=True` variant
belong to the generic solver, which is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dart_tpu_torch.models import dynamics as dyn
from dart_tpu_torch.solver.ilqr import OCPDef


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


def make_pmpc_ocp(dt: float = 0.002, u_bound: float = 0.6) -> OCPDef:
    step_x = dyn.discretize(dyn.pmpc_dynamics, dt)

    def stage_cost(z, v, k, aux: PMPCAux):
        return (aux.Qp * _sq_err(z, aux.target, 0, 2)
                + aux.Qv * _sq_err(z, aux.target, 1, 3)
                + aux.R * torch.sum(v ** 2, dim=-1))

    def term_cost(z, aux: PMPCAux):
        return (aux.Qp * _sq_err(z, aux.target, 0, 2)
                + aux.Qv * _sq_err(z, aux.target, 1, 3))

    return OCPDef(
        step=step_x,
        stage_cost=stage_cost,
        term_cost=term_cost,
        u_lo=(-u_bound, -u_bound),
        u_hi=(u_bound, u_bound),
    )
