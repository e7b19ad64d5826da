"""Batch-last lane algebra: the building blocks of the kernels' plain
versions (port of the helpers in `dart_tpu.ops.pallas.riccati` and
`dart_tpu.ops.pallas.pmpc_solve._diag_embed`).

Every matrix entry is a lane vector: a (n, m, L) tensor holds one n x m
matrix per scenario lane, with the batch on the last axis. Products sum in
the order t = 0..k-1, as the Pallas helpers do, so the plain versions
repeat the TPU kernels' arithmetic operation for operation.
"""

from __future__ import annotations

import torch

_BIG = 1e30


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n,k,L) @ (k,m,L) -> (n,m,L): entry (i, j) is sum_t a[i,t] * b[t,j],
    each product rounded and added in the order t = 0..k-1 (one
    elementwise product and sum over all (i, j) per t)."""
    k = a.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"_mm: inner sizes {k} and {b.shape[0]} differ")
    acc = a[:, 0, None] * b[None, 0]
    for t in range(1, k):
        acc = acc + a[:, t, None] * b[None, t]
    return acc


def _mT(a: torch.Tensor) -> torch.Tensor:
    return torch.swapaxes(a, 0, 1)


def _eye_mask(M: torch.Tensor) -> torch.Tensor:
    """(n, n, 1) boolean diagonal for an (n, n, L) lane matrix."""
    n = M.shape[0]
    return torch.eye(n, dtype=torch.bool, device=M.device)[..., None]


def _add_diag(M: torch.Tensor, val) -> torch.Tensor:
    """(n,n,L) + val on the diagonal; val is a scalar or an (L,) lane. The
    off-diagonal entries are M's own (a select, not an added zero)."""
    return torch.where(_eye_mask(M), M + val, M)


def _scale_add_eye(M: torch.Tensor, s) -> torch.Tensor:
    """I + s*M for (n,n,L)."""
    sM = s * M
    return torch.where(_eye_mask(M), sM + 1.0, sM)


def _rk4_jac_lanes(f, jac, x, v, dt: float):
    """Exact (Ad, Bd) of an RK4 step in lane algebra (the chain rule of
    `models.dynamics.rk4_jac`): f(x, v) -> (n,L), jac(x, v) -> (A (n,n,L),
    B (n,m,L)). dt is a python float, folded in double as the TPU kernel
    folds it."""
    k1 = f(x, v)
    x2 = x + 0.5 * dt * k1
    k2 = f(x2, v)
    x3 = x + 0.5 * dt * k2
    x4 = x + dt * f(x3, v)
    A1, B1 = jac(x, v)
    A2, B2 = jac(x2, v)
    A3, B3 = jac(x3, v)
    A4, B4 = jac(x4, v)
    dk2x = _mm(A2, _scale_add_eye(A1, 0.5 * dt))
    dk2u = _mm(A2, 0.5 * dt * B1) + B2
    dk3x = _mm(A3, _scale_add_eye(dk2x, 0.5 * dt))
    dk3u = _mm(A3, 0.5 * dt * dk2u) + B3
    dk4x = _mm(A4, _scale_add_eye(dk3x, dt))
    dk4u = _mm(A4, dt * dk3u) + B4
    Ad = _scale_add_eye(A1 + 2.0 * dk2x + 2.0 * dk3x + dk4x, dt / 6.0)
    Bd = dt / 6.0 * (B1 + 2.0 * dk2u + 2.0 * dk3u + dk4u)
    return Ad, Bd


def _gains_lanes(Quu: torch.Tensor, free: torch.Tensor, Qux_cols):
    """Feedback gains on the free set: solve H K = -(Qux * free) column by
    column, H = free*Quu*free + diag(1 - free). Quu (2,2,L), free (2,L),
    Qux_cols an iterable of (b0, b1) pairs: one column's two rows (L,), or
    a block of columns, each row (..., L). Returns a list of (k0, k1) of
    the same shapes."""
    f0, f1 = free[0], free[1]
    h00 = Quu[0, 0] * f0 * f0 + (1.0 - f0)
    h01 = Quu[0, 1] * f0 * f1
    h11 = Quu[1, 1] * f1 * f1 + (1.0 - f1)
    deth = h00 * h11 - h01 * h01
    deth = torch.where(torch.abs(deth) < 1e-30, torch.full_like(deth, 1e-30),
                       deth)
    out = []
    for b0, b1 in Qux_cols:
        b0 = b0 * f0
        b1 = b1 * f1
        out.append((-(h11 * b0 - h01 * b1) / deth,
                    -(-h01 * b0 + h00 * b1) / deth))
    return out


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(n,k,L) @ (k,L) -> (n,L), summed in the order t = 0..k-1."""
    acc = a[:, 0] * v[0]
    for t in range(1, a.shape[1]):
        acc = acc + a[:, t] * v[t]
    return acc


def _add_diag_vec(M: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n,n,L) + diag(w) with w (n,L)."""
    return torch.where(_eye_mask(M), M + w[:, None], M)


def _diag_embed(w: torch.Tensor) -> torch.Tensor:
    """(n, L) -> (n, n, L) diagonal embedding."""
    return torch.where(_eye_mask(w[:, None]), w[None],
                       torch.zeros_like(w[None]))


def _boxqp2_lanes(Quu: torch.Tensor, Qu: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact lane-wise 2x2 box QP: min 0.5 d'Quu d + Qu'd, lo <= d <= hi.

    Enumerates the 9 active sets in (s0, s1) order (0 free, 1 at lo, 2 at
    hi), keeps the KKT-feasible ones (tolerance 1e-9) and takes the lowest
    objective with a strict `<`, so the first of equal candidates wins.
    Each candidate's d is clipped after its objective is computed. The
    candidates are rows of one (9, L) stack, each computed with its own
    operations in the kernel's order.
    Quu: (2,2,L), Qu/lo/hi: (2,L). Returns d (2,L), free (2,L).
    """
    q00, q01, q11 = Quu[0, 0], Quu[0, 1], Quu[1, 1]
    det = q00 * q11 - q01 * q01
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
    # Both dims free.
    ff0 = -(q11 * Qu[0] - q01 * Qu[1]) / det
    ff1 = -(-q01 * Qu[0] + q00 * Qu[1]) / det
    # One dim free, the other at (lo, hi).
    c1 = torch.stack([lo[1], hi[1]])
    fx0 = -(Qu[0] + q01 * c1) / torch.clamp_min(q00, 1e-30)
    c0 = torch.stack([lo[0], hi[0]])
    xf1 = -(Qu[1] + q01 * c0) / torch.clamp_min(q11, 1e-30)
    # Rows in (s0, s1) order: (0,0) (0,1) (0,2) (1,0) ... (2,2).
    d0 = torch.stack([ff0, fx0[0], fx0[1], lo[0], lo[0], lo[0],
                      hi[0], hi[0], hi[0]])
    d1 = torch.stack([ff1, lo[1], hi[1], xf1[0], lo[1], hi[1],
                      xf1[1], lo[1], hi[1]])
    g0 = q00 * d0 + q01 * d1 + Qu[0]
    g1 = q01 * d0 + q11 * d1 + Qu[1]
    dev = Qu.device
    s0 = torch.tensor([0, 0, 0, 1, 1, 1, 2, 2, 2], device=dev)[:, None]
    s1 = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1, 2], device=dev)[:, None]

    def kkt(s, d, g, lo_i, hi_i):
        return torch.where(s == 0, (d >= lo_i - 1e-9) & (d <= hi_i + 1e-9),
                           torch.where(s == 1, g >= -1e-9, g <= 1e-9))

    ok = kkt(s0, d0, g0, lo[0], hi[0]) & kkt(s1, d1, g1, lo[1], hi[1])
    obj = 0.5 * (d0 * g0 + d1 * g1) + 0.5 * (Qu[0] * d0 + Qu[1] * d1)
    obj = torch.where(ok, obj, torch.full_like(obj, _BIG))

    best_obj = obj[0]
    best = torch.zeros_like(q00, dtype=torch.long)
    for i in range(1, 9):
        better = obj[i] < best_obj
        best_obj = torch.where(better, obj[i], best_obj)
        best = torch.where(better, i, best)
    pick = best[None]
    d = torch.cat([torch.clamp(d0, lo[0], hi[0]).gather(0, pick),
                   torch.clamp(d1, lo[1], hi[1]).gather(0, pick)])
    one, zero = torch.ones_like(q00), torch.zeros_like(q00)
    free = torch.stack([torch.where(best < 3, one, zero),
                        torch.where(best % 3 == 0, one, zero)])
    return d, free


# Structural operation counts for the kernels' `work()`: boolean masks of
# the non-zeros a product or sum propagates, and the FLOPs it needs.
def _mask(shape, nz=()):
    m = torch.zeros(shape, dtype=torch.bool)
    for ij in nz:
        m[ij] = True
    return m


def _nnz(m) -> int:
    return int(m.sum())


def _mmc(a, b, unit=None, out=None):
    """(mask, FLOPs) of the product of two structurally sparse matrices:
    m non-zero pairs into one entry are m multiplies, less those by the
    entries of `a` that `unit` marks as exactly 1, and m - 1 adds. With
    `out`, only the entries it marks are counted (the upper triangle of a
    symmetric product)."""
    pairs = a.long() @ b.long()
    mults = pairs - (0 if unit is None else unit.long() @ b.long())
    flops = mults + (pairs - 1).clamp(min=0)
    return pairs > 0, int((flops if out is None else flops[out]).sum())


def _addc(*ms):
    """(mask, FLOPs) of a sum of structurally sparse terms."""
    out, n = ms[0], 0
    for m in ms[1:]:
        n += _nnz(out & m)
        out = out | m
    return out, n
