"""Reference trajectory and governor of the RMPC driver (port of
`dart_tpu.control.reference`, RMPC part). Both take any leading batch
shape."""

from __future__ import annotations

import torch


def _pos_mask(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 1.0, 0.0], dtype=x.dtype, device=x.device)


def build_ref_traj(r_v: torch.Tensor, target: torch.Tensor, N: int,
                   step_fraction: float = 0.2) -> torch.Tensor:
    """Staged reference (..., N+1, 4): stage i tracks
    ``r_v + (1 - (1-f)^(i+1)) (target - r_v)`` on positions, with zero
    velocity. r_v and target are (..., 4)."""
    i = torch.arange(N + 1, dtype=r_v.dtype, device=r_v.device)
    w = 1.0 - torch.pow(1.0 - step_fraction, i + 1.0)
    r = r_v[..., None, :] + w[:, None] * (target - r_v)[..., None, :]
    return r * _pos_mask(r_v)


def reference_governor(r_v: torch.Tensor, target: torch.Tensor,
                       dr_max: float = 0.01,
                       alpha: float = 0.5) -> torch.Tensor:
    """One governor update on the position channels:
    r_v += alpha * clip(target - r_v, +-dr_max)."""
    err = (target - r_v) * _pos_mask(r_v)
    return r_v + alpha * torch.clamp(err, -dr_max, dr_max)
