"""Batch-last lane algebra: the building blocks of the kernels' plain
versions (port of the helpers in `dart_tpu.ops.pallas.riccati` and
`dart_tpu.ops.pallas.pmpc_solve._diag_embed`).

Every matrix entry is a lane vector: a (n, m, L) tensor holds one n x m
matrix per scenario lane, with the batch on the last axis.
"""

from __future__ import annotations

import torch

_BIG = 1e30


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(n,k,L) @ (k,L) -> (n,L), summed in the order t = 0..k-1."""
    n, k = a.shape[0], a.shape[1]
    out = []
    for i in range(n):
        acc = a[i, 0] * v[0]
        for t in range(1, k):
            acc = acc + a[i, t] * v[t]
        out.append(acc)
    return torch.stack(out)


def _add_diag_vec(M: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n,n,L) + diag(w) with w (n,L)."""
    n = M.shape[0]
    return torch.stack([torch.stack([M[i, j] + w[i] if i == j else M[i, j]
                                     for j in range(n)]) for i in range(n)])


def _diag_embed(w: torch.Tensor) -> torch.Tensor:
    """(n, L) -> (n, n, L) diagonal embedding."""
    n = w.shape[0]
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([w[i] if i == j else z for j in range(n)])
                        for i in range(n)])


def _boxqp2_lanes(Quu: torch.Tensor, Qu: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact lane-wise 2x2 box QP: min 0.5 d'Quu d + Qu'd, lo <= d <= hi.

    Enumerates the 9 active sets in (s0, s1) order (0 free, 1 at lo, 2 at
    hi), keeps the KKT-feasible ones (tolerance 1e-9) and takes the lowest
    objective with a strict `<`, so the first of equal candidates wins.
    Each candidate's d is clipped after its objective is computed.
    Quu: (2,2,L), Qu/lo/hi: (2,L). Returns d (2,L), free (2,L).
    """
    q00, q01, q11 = Quu[0, 0], Quu[0, 1], Quu[1, 1]
    det = q00 * q11 - q01 * q01
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
    one, zero = torch.ones_like(q00), torch.zeros_like(q00)

    cand_d, cand_obj, cand_free = [], [], []
    for s0 in range(3):
        for s1 in range(3):
            f0 = one if s0 == 0 else zero
            f1 = one if s1 == 0 else zero
            c0 = lo[0] if s0 == 1 else (hi[0] if s0 == 2 else 0.0 * q00)
            c1 = lo[1] if s1 == 1 else (hi[1] if s1 == 2 else 0.0 * q00)
            if s0 == 0 and s1 == 0:
                d0 = -(q11 * Qu[0] - q01 * Qu[1]) / det
                d1 = -(-q01 * Qu[0] + q00 * Qu[1]) / det
            elif s0 == 0:
                d1 = c1
                d0 = -(Qu[0] + q01 * d1) / torch.clamp_min(q00, 1e-30)
            elif s1 == 0:
                d0 = c0
                d1 = -(Qu[1] + q01 * d0) / torch.clamp_min(q11, 1e-30)
            else:
                d0, d1 = c0, c1
            g0 = q00 * d0 + q01 * d1 + Qu[0]
            g1 = q01 * d0 + q11 * d1 + Qu[1]
            ok = torch.ones_like(q00, dtype=torch.bool)
            for s, d, g, lo_i, hi_i in ((s0, d0, g0, lo[0], hi[0]),
                                        (s1, d1, g1, lo[1], hi[1])):
                if s == 0:
                    ok = ok & (d >= lo_i - 1e-9) & (d <= hi_i + 1e-9)
                elif s == 1:
                    ok = ok & (g >= -1e-9)
                else:
                    ok = ok & (g <= 1e-9)
            obj = 0.5 * (d0 * g0 + d1 * g1) + 0.5 * (Qu[0] * d0 + Qu[1] * d1)
            cand_d.append((torch.clamp(d0, lo[0], hi[0]),
                           torch.clamp(d1, lo[1], hi[1])))
            cand_obj.append(torch.where(ok, obj, torch.full_like(obj, _BIG)))
            cand_free.append((f0, f1))

    best_obj = cand_obj[0]
    best_d0, best_d1 = cand_d[0]
    best_f0, best_f1 = cand_free[0]
    for i in range(1, 9):
        better = cand_obj[i] < best_obj
        best_obj = torch.where(better, cand_obj[i], best_obj)
        best_d0 = torch.where(better, cand_d[i][0], best_d0)
        best_d1 = torch.where(better, cand_d[i][1], best_d1)
        best_f0 = torch.where(better, cand_free[i][0], best_f0)
        best_f1 = torch.where(better, cand_free[i][1], best_f1)
    return torch.stack([best_d0, best_d1]), torch.stack([best_f0, best_f1])
