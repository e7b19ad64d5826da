"""Box-constrained QPs of the control-limited DDP backward pass (port of
`dart_tpu.ops.boxqp`).

At every Riccati stage the trajectory optimiser solves

    min_d  0.5 d' Quu d + Qu' d    s.t.  lo <= d <= hi

For nu == 2 (the tray tilt) `boxqp2` solves it exactly by enumerating the
3^2 = 9 active sets; `boxqp_pn` is projected Newton for any nu. All three
functions are batch-first: Quu (..., nu, nu), Qu, lo, hi (..., nu), and
return (d (..., nu), free (..., nu)) with free 1.0 where a dimension is
off its bounds.
"""

from __future__ import annotations

import torch

from dart_tpu_torch.ops.kernels.lanes import _boxqp2_lanes


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def boxqp2(Quu: torch.Tensor, Qu: torch.Tensor, lo: torch.Tensor,
           hi: torch.Tensor):
    """Exact 2-d box QP by active-set enumeration: all 9 candidate sets
    (each dimension free, at lo or at hi), the feasible one of least
    objective, the first on ties; a free dimension must lie in its bounds
    and a fixed one have the gradient sign of its bound, each to 1e-9.
    This is the kernels' own enumeration (`ops.kernels.lanes.
    _boxqp2_lanes`) on the flattened batch. Returns (d, free)."""
    batch = Qu.shape[:-1]
    lo, hi = (torch.broadcast_to(b, Qu.shape).reshape(-1, 2).T
              for b in (lo, hi))
    d, free = _boxqp2_lanes(Quu.reshape(-1, 2, 2).permute(1, 2, 0),
                            Qu.reshape(-1, 2).T, lo, hi)
    return d.T.reshape(*batch, 2), free.T.reshape(*batch, 2)


def _clamped(Quu, Qu, d, lo, hi) -> torch.Tensor:
    g = _mv(Quu, d) + Qu
    return ((d <= lo + 1e-9) & (g > 0)) | ((d >= hi - 1e-9) & (g < 0))


def boxqp_pn(Quu: torch.Tensor, Qu: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor, iters: int = 12):
    """Projected-Newton box QP for any nu (Bertsekas 1982; Tassa 2014):
    `iters` Newton steps on the free subspace, each scaled by the exact
    minimiser of the quadratic along it in [0, 1], then clipped. Returns
    (d, free)."""
    lo, hi = torch.broadcast_to(lo, Qu.shape), torch.broadcast_to(hi, Qu.shape)
    eye = torch.eye(Qu.shape[-1], dtype=Qu.dtype, device=Qu.device)
    d = torch.minimum(torch.maximum(torch.zeros_like(Qu), lo), hi)
    for _ in range(iters):
        g = _mv(Quu, d) + Qu
        fm = (~_clamped(Quu, Qu, d, lo, hi)).to(Qu.dtype)
        H = Quu * fm[..., :, None] * fm[..., None, :] + eye * (1.0 - fm)[
            ..., None, :]
        step = -torch.linalg.solve(H, g * fm) * fm
        num = -torch.sum(g * step, -1)
        den = torch.sum(step * _mv(Quu, step), -1)
        alpha = torch.where(den > 1e-30, torch.clamp(num / den, 0.0, 1.0),
                            torch.ones_like(den))
        d = torch.minimum(torch.maximum(d + alpha[..., None] * step, lo), hi)
    free = (~_clamped(Quu, Qu, d, lo, hi)).to(Qu.dtype)
    return d, free


def boxqp(Quu: torch.Tensor, Qu: torch.Tensor, lo: torch.Tensor,
          hi: torch.Tensor):
    """Exact enumeration for nu == 2, projected Newton otherwise."""
    if Qu.shape[-1] == 2:
        return boxqp2(Quu, Qu, lo, hi)
    return boxqp_pn(Quu, Qu, lo, hi)
