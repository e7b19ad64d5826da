"""Horizon-parallel LQR by an associative scan (port of
`dart_tpu.ops.lqr_parallel`; Sarkka & Garcia-Fernandez, "Temporal
Parallelization of Bayesian Smoothers and LQT", 2021).

The Riccati backward recursion as an associative combination of
conditional-value-function elements: the dependency depth over the
horizon drops from O(N) to O(log N). The scan is written in torch: at
level d every suffix element k combines with the one at k + d, all k at
once (batched `torch.linalg.solve` over the stages), for d = 1, 2, 4, ...

Problem: x_{k+1} = A_k x_k + B_k u_k, cost sum_k 0.5 x'Q_k x + 0.5 u'R_k u
+ terminal 0.5 x'Q_N x. Element e = (Aa, b, C, eta, J); combining e_j (the
later suffix) with e_i (the earlier):
  e_j o e_i = (Aa_j M Aa_i, Aa_j M (b_i + C_i eta_j) + b_j,
               Aa_j M C_i Aa_j' + C_j, Aa_i' N (eta_j - J_j b_i) + eta_i,
               Aa_i' N J_j Aa_i + J_i),
with M = (I + C_i J_j)^-1 and N = (I + J_j C_i)^-1. The value function at
k is V_k(x) = 0.5 x' S_k x - v_k' x, (S_k, v_k) = (J, eta) of the suffix
k..N.

Every function takes optional leading batch axes: A (..., N, n, n),
B (..., N, n, m), Q (..., N, n, n), R (..., N, m, m), QN (..., n, n).
"""

from __future__ import annotations

import torch


def _mT(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _combine(ej, ei):
    """Combine the later suffix element ej with the earlier element ei."""
    Aj, bj, Cj, etaj, Jj = ej
    Ai, bi, Ci, etai, Ji = ei
    eye = torch.eye(Ai.shape[-1], dtype=Ai.dtype, device=Ai.device)
    eye = eye.expand(Ci.shape)
    M = torch.linalg.solve(eye + Ci @ Jj, eye)
    Nn = torch.linalg.solve(eye + Jj @ Ci, eye)
    AjM = Aj @ M
    AiTN = _mT(Ai) @ Nn
    return (AjM @ Ai, _mv(AjM, bi + _mv(Ci, etaj)) + bj,
            AjM @ Ci @ _mT(Aj) + Cj, _mv(AiTN, etaj - _mv(Jj, bi)) + etai,
            AiTN @ Jj @ Ai + Ji)


def _suffix_scan(elems):
    """Inclusive reverse scan over the stage axis of the elements (Aa, b,
    C, eta, J): element k becomes e_k o ... o e_{L-1}, in ceil(log2 L)
    levels of batched combines."""
    # The stage axis of each field: -3 for the matrices, -2 for vectors.
    axes = (-3, -2, -3, -2, -3)
    L = elems[0].shape[-3]
    d = 1
    while d < L:
        later = tuple(x.narrow(a, d, L - d) for x, a in zip(elems, axes))
        earlier = tuple(x.narrow(a, 0, L - d) for x, a in zip(elems, axes))
        head = _combine(later, earlier)
        elems = tuple(torch.cat([h, x.narrow(a, L - d, d)], a)
                      for h, x, a in zip(head, elems, axes))
        d *= 2
    return elems


def lqr_backward_parallel(A, B, Q, R, QN):
    """All value matrices S_k, k = 0..N, in O(log N) depth. Returns S
    (..., N+1, n, n) with S[N] = QN (the v terms are zero for the
    homogeneous regulator; tracking is a coordinate shift at the call
    site)."""
    n = A.shape[-1]
    batch = A.shape[:-3]
    z_vec = torch.zeros((*A.shape[:-2], n), dtype=A.dtype, device=A.device)
    C = B @ torch.linalg.inv(R) @ _mT(B)                 # B R^-1 B'
    zero_mat = torch.zeros((*batch, 1, n, n), dtype=A.dtype, device=A.device)
    zero_v = torch.zeros((*batch, 1, n), dtype=A.dtype, device=A.device)
    full = (torch.cat([A, zero_mat], -3), torch.cat([z_vec, zero_v], -2),
            torch.cat([C, zero_mat], -3), torch.cat([z_vec, zero_v], -2),
            torch.cat([Q, QN[..., None, :, :]], -3))
    return _suffix_scan(full)[4]


def lqr_backward_sequential(A, B, Q, R, QN):
    """Reference: the classic Riccati recursion, same convention."""
    S = QN
    Ss = [S]
    for k in range(A.shape[-3] - 1, -1, -1):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        K = torch.linalg.solve(R[..., k, :, :] + _mT(B_k) @ S @ B_k,
                               _mT(B_k) @ S @ A_k)
        S = Q[..., k, :, :] + _mT(A_k) @ S @ (A_k - B_k @ K)
        Ss.append(S)
    return torch.stack(Ss[::-1], -3)


def lqr_gains(A, B, R, S):
    """Feedback gains K_k = (R + B'S_{k+1}B)^-1 B'S_{k+1}A from the value
    matrices (S has N+1 entries)."""
    BtS = _mT(B) @ S[..., 1:, :, :]
    return torch.linalg.solve(R + BtS @ B, BtS @ A)
