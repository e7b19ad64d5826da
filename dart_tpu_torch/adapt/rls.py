"""Recursive least squares with forgetting (port of `dart_tpu.adapt.rls`).

K = P phi / (lam + phi' P phi); theta += K err; P = (P - K phi' P) / lam.
The state is an explicit NamedTuple with any leading batch shape: a
scenario batch is theta (B, p), P (B, p, p).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RLSState(NamedTuple):
    theta: torch.Tensor   # (..., p)
    P: torch.Tensor       # (..., p, p)


def rls_init(p: int, P0: float = 1e3, theta0: torch.Tensor | None = None,
             dtype: torch.dtype = torch.float32, *,
             device: torch.device | str,
             batch_shape: tuple = ()) -> RLSState:
    """Initial estimate on `device`, which the caller names: the state
    lives beside the controller's carry, on the card or the CPU."""
    theta = (torch.zeros((*batch_shape, p), dtype=dtype, device=device)
             if theta0 is None else
             torch.as_tensor(theta0, dtype=dtype, device=device)
             .expand(*batch_shape, p).clone())
    P = torch.eye(p, dtype=dtype, device=device).expand(
        *batch_shape, p, p) * P0
    return RLSState(theta=theta, P=P)


def rls_update(s: RLSState, phi: torch.Tensor, y: torch.Tensor,
               lam: float = 0.995, P_max: float | None = None) -> RLSState:
    """One RLS step; phi (..., p), y (...). `P_max` (optional) caps
    trace(P): with forgetting and vanishing excitation (the object parked
    at its target) P grows without bound and theta eventually blows up;
    the clamp keeps long steady-state operation safe."""
    Pphi = (s.P @ phi[..., None])[..., 0]
    denom = lam + (phi[..., None, :] @ Pphi[..., None])[..., 0, 0]
    K = Pphi / denom[..., None]
    err = y - (phi[..., None, :] @ s.theta[..., None])[..., 0, 0]
    theta = s.theta + K * err[..., None]
    P = (s.P - (K[..., :, None] * phi[..., None, :]) @ s.P) / lam
    if P_max is not None:
        tr = torch.diagonal(P, dim1=-2, dim2=-1).sum(-1)
        one = torch.ones_like(tr)
        scale = torch.minimum(one, P_max / torch.maximum(
            tr, torch.full_like(tr, 1e-12)))
        P = P * scale[..., None, None]
    return RLSState(theta=theta, P=P)
