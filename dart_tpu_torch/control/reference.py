"""Reference trajectories and the governor (port of
`dart_tpu.control.reference`): the staged reference and the per-step
governor of the RMPC driver, and LMPC's quintic minimum-jerk reference.
Each takes any leading batch shape."""

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


def quintic_trajectory(state: torch.Tensor, target: torch.Tensor, N: int,
                       nx: int, dt: float) -> torch.Tensor:
    """Quintic (minimum-jerk) position reference (..., N+1, nx) over
    T = N*dt from (p0, v0, a0=0) to (pf, vf=0, af=0) per axis, positions
    only (channels 0 and 2), as `RLMPC.gen_Trajectory`. state and target
    (..., >= 4)."""
    dtype, dev = state.dtype, state.device
    p0 = torch.stack([state[..., 0], state[..., 2]], -1)
    v0 = torch.stack([state[..., 1], state[..., 3]], -1)
    pf = torch.stack([target[..., 0], target[..., 2]], -1)
    T = N * dt
    # Coefficients c5 t^5 + ... + c1 t + c0 per axis.
    tm = torch.tensor([
        [0, 0, 0, 0, 0, 1],
        [0, 0, 0, 0, 1, 0],
        [0, 0, 0, 2, 0, 0],
        [T**5, T**4, T**3, T**2, T, 1],
        [5 * T**4, 4 * T**3, 3 * T**2, 2 * T, 1, 0],
        [20 * T**3, 12 * T**2, 6 * T, 2, 0, 0],
    ], dtype=dtype, device=dev)
    zeros = torch.zeros_like(p0)
    b = torch.stack([p0, v0, zeros, pf, zeros, zeros], -2)      # (..., 6, 2)
    coeffs = torch.linalg.solve(tm, b)                          # high->low
    t = torch.arange(N + 1, dtype=dtype, device=dev) * dt
    powers = torch.stack([t**5, t**4, t**3, t**2, t, torch.ones_like(t)],
                         -1)
    pos = powers @ coeffs                                       # (..., N+1, 2)
    R = torch.zeros((*pos.shape[:-1], nx), dtype=dtype, device=dev)
    R[..., 0] = pos[..., 0]
    R[..., 2] = pos[..., 1]
    return R
