"""The complete LMPC box-DDP solve in one launch (port of
`dart_tpu.ops.pallas.lmpc_solve`).

The OCP is `solver.ocp.make_lmpc_ocp`: the 8-state, 34-parameter
Stribeck / rolling / toppling model (squashed inside the solve), the state
augmented with the previous tilt, z = [x(8), u_prev(2)], box bounds
+-u_bound on the tilt handled exactly by per-stage 2x2 box QPs. The RK4
linearisation is the closed-form chain rule of `models.dynamics.rk4_jac`;
the Riccati backward pass is partitioned over z into P (8,8), q (8,2),
r (2,2), with the constant block Qux2 = diag(-2 Rdu). A multi-alpha line
search with per-lane acceptance and done masks runs a fixed number of
iterations.

`lmpc_solve` keeps `lmpc_solve_pallas`'s batch-last layout: pvec (34,B),
Q/Qt/target (8,B), R (4,B) = [Ru0, Ru1, Rdu0, Rdu1], z0 (10,B) =
[x0, u_prev], V0 (N,2,B). Returns V (N,2,B), cost and gnorm (B,). V0 is
clipped to +-u_bound first, and the cost is that of the clipped V0's
rollout until a trial improves on it. gnorm is the max |feedforward| of the
last backward pass, taken before its line search. On CUDA tensors it
launches `csrc/lmpc_solve.cu`, which holds a lane with a group of threads
split along the model's two decoupled axes (x: px, vx, th_y, om_y under
u0; y: py, vy, th_x, om_x under u1) and keeps the horizon in shared
memory; on CPU tensors it runs `lmpc_solve_reference`, the plain PyTorch
version of `_lmpc_kernel`.
"""

from __future__ import annotations

import ctypes

import torch

from dart_tpu_torch.models import dynamics as dyn
from dart_tpu_torch.ops.kernels import _build
from dart_tpu_torch.ops.kernels.lanes import (_add_diag_vec, _addc,
                                              _boxqp2_lanes, _diag_embed,
                                              _gains_lanes, _mask, _mm, _mmc,
                                              _mT, _mv, _nnz, _rk4_jac_lanes)

N_INSTANCES = (6, 12, 20)
MAX_ALPHAS = 16


def _solve_lanes(praw, Q, Rfull, Qt, target, z0, V, *, N, n_iters,
                 n_alphas, dt, u_b, stats=None):
    """Plain version of the kernel body `_lmpc_kernel`, on (..., L) lanes.
    Returns V (N,2,L), cost and gnorm (L,). A `stats` dict gets "trials"
    (L,): the line-search trials the kernel runs per lane (it stops at the
    first accepted alpha and skips done lanes)."""
    Ru, Rdu = Rfull[0:2], Rfull[2:4]
    x0, up0 = z0[0:8], z0[8:10]
    u_lo = torch.full_like(up0, -u_b)
    u_hi = torch.full_like(up0, u_b)
    # The model and its Jacobians are `models.dynamics`' on the transposed
    # lanes: the same operations as the kernel's in-lane transcription
    # (which squashes the parameters once; the values are the same).
    p_lanes = praw.T

    def f8(x, v):
        return dyn.lmpc_dynamics(x.T, v.T, p_lanes).T

    def jac8(x, v):
        A, Bm = dyn.lmpc_jac(x.T, v.T, p_lanes)
        return A.permute(1, 2, 0), Bm.permute(1, 2, 0)

    def rk4(x, v):
        return dyn.rk4_step(dyn.lmpc_dynamics, x.T, v.T, p_lanes, dt).T

    def stage_cost(x, v, up):
        e = x - target
        du = v - up
        return (torch.sum(Q * e * e, dim=0)
                + Ru[0] * v[0] * v[0] + Ru[1] * v[1] * v[1]
                + Rdu[0] * du[0] * du[0] + Rdu[1] * du[1] * du[1])

    def rollout_cost(V):
        xs = [x0]
        up = up0
        cost = torch.zeros_like(Ru[0])
        for k in range(N):
            cost = cost + stage_cost(xs[k], V[k], up)
            xs.append(rk4(xs[k], V[k]))
            up = V[k]
        e = xs[N] - target
        cost = cost + torch.sum(Qt * e * e, dim=0)
        return torch.stack(xs), cost

    alphas = [0.6 ** i for i in range(n_alphas)]
    zl = torch.zeros_like(Ru[0])

    def iteration(X, V, cost, done):
        # The u_prev trajectory is implied by V: UP[0] = up0, UP[k] = V[k-1].
        UP = [up0] + [V[k] for k in range(N - 1)]

        # ---- backward: partitioned Riccati over z = [x(8), u_prev(2)] ----
        eT = X[N] - target
        vx8 = 2.0 * Qt * eT                       # dV/dx
        vu2 = torch.zeros_like(up0)               # dV/du_prev
        P = 2.0 * _diag_embed(Qt)                 # (8, 8, L)
        q = torch.stack([torch.stack([zl] * 2)] * 8)
        r = torch.stack([torch.stack([zl] * 2)] * 2)
        Ds, K1s, K2s, gns = [None] * N, [None] * N, [None] * N, []
        Qux2 = torch.stack([torch.stack([-2.0 * Rdu[0], zl]),
                            torch.stack([zl, -2.0 * Rdu[1]])])
        for k in range(N - 1, -1, -1):
            x, v_k = X[k], V[k]
            Ad, Bd = _rk4_jac_lanes(f8, jac8, x, v_k, dt)
            e = x - target
            du = v_k - UP[k]
            lx8 = 2.0 * Q * e
            lx2 = -2.0 * Rdu * du
            lv = 2.0 * Ru * v_k + 2.0 * Rdu * du
            AdT, BdT = _mT(Ad), _mT(Bd)
            Qx8 = lx8 + _mv(AdT, vx8)
            Qx2 = lx2
            Qu = lv + _mv(BdT, vx8) + vu2
            Qxx11 = _add_diag_vec(_mm(_mm(AdT, P), Ad), 2.0 * Q)
            T2 = _mm(BdT, P) + _mT(q)             # (2, 8, L)
            Qux1 = _mm(T2, Ad)                    # (2, 8, L)
            Quu = _mm(T2, Bd) + _mm(BdT, q) + r
            Quu = 0.5 * (Quu + _mT(Quu))
            Quu = _add_diag_vec(Quu, 2.0 * (Ru + Rdu) + 1e-8)

            d, free = _boxqp2_lanes(Quu, Qu, u_lo - v_k, u_hi - v_k)
            gns.append(torch.maximum(torch.abs(d[0]), torch.abs(d[1])))
            # Every column of Qux1 and Qux2 at once (the same operations
            # per column).
            (k1, k2) = _gains_lanes(Quu, free, [(Qux1[0], Qux1[1]),
                                                (Qux2[0], Qux2[1])])
            K1, K2 = torch.stack(k1), torch.stack(k2)

            w2 = _mv(Quu, d) + Qu
            vx8 = Qx8 + _mv(_mT(K1), w2) + _mv(_mT(Qux1), d)
            vu2 = Qx2 + _mv(_mT(K2), w2) + _mv(_mT(Qux2), d)
            K1T_Quu = _mm(_mT(K1), Quu)           # (8, 2, L)
            M = _mm(_mT(K1), Qux1)                # (8, 8, L)
            P = Qxx11 + _mm(K1T_Quu, K1) + M + _mT(M)
            P = 0.5 * (P + _mT(P))
            q = (_mm(K1T_Quu, K2) + _mm(_mT(K1), Qux2)
                 + _mm(_mT(Qux1), K2))
            K2T_Quu = _mm(_mT(K2), Quu)
            M2 = _mm(_mT(K2), Qux2)
            r = _mm(K2T_Quu, K2) + M2 + _mT(M2)
            r = _add_diag_vec(0.5 * (r + _mT(r)), 2.0 * Rdu)
            Ds[k], K1s[k], K2s[k] = d, K1, K2

        # ---- forward line search with per-lane acceptance ----
        accepted = done
        X_best, V_best, c_best = X, V, cost
        for al in alphas:
            if stats is not None:
                stats["trials"] = stats["trials"] + (~accepted).long()
            x, up = x0, up0
            xs_new, vs_new = [x0], []
            c_new = torch.zeros_like(Ru[0])
            for k in range(N):
                v = (V[k] + al * Ds[k] + _mv(K1s[k], x - X[k])
                     + _mv(K2s[k], up - UP[k]))
                v = torch.clamp(v, -u_b, u_b)
                c_new = c_new + stage_cost(x, v, up)
                x = rk4(x, v)
                up = v
                xs_new.append(x)
                vs_new.append(v)
            e = x - target
            c_new = c_new + torch.sum(Qt * e * e, dim=0)
            newly = (~accepted) & (c_new < cost - 1e-12)
            X_best = torch.where(newly, torch.stack(xs_new), X_best)
            V_best = torch.where(newly, torch.stack(vs_new), V_best)
            c_best = torch.where(newly, c_new, c_best)
            accepted = accepted | newly

        rel = (cost - c_best) / (torch.abs(cost) + 1.0)
        done_n = done | (accepted & (rel < 1e-9)) | (~accepted)
        gnorm = gns[0]
        for g_k in gns[1:]:
            gnorm = torch.maximum(gnorm, g_k)
        return X_best, V_best, c_best, done_n, gnorm

    X, cost = rollout_cost(V)
    done = torch.zeros_like(cost, dtype=torch.bool)
    gnorm = zl
    if stats is not None:
        stats["trials"] = torch.zeros_like(cost, dtype=torch.long)
    for _ in range(n_iters):
        X, V, cost, done, gnorm = iteration(X, V, cost, done)
    return V, cost, gnorm


def _check(pvec, Q, R, Qt, target, z0, V0):
    if V0.dim() != 3 or V0.shape[1] != 2:
        raise ValueError(f"V0 must be (N, 2, B), got {tuple(V0.shape)}")
    N, _, Bt = V0.shape
    want = {"pvec": (34, Bt), "Q": (8, Bt), "R": (4, Bt), "Qt": (8, Bt),
            "target": (8, Bt), "z0": (10, Bt), "V0": (N, 2, Bt)}
    got = {"pvec": pvec, "Q": Q, "R": R, "Qt": Qt, "target": target,
           "z0": z0, "V0": V0}
    if V0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lmpc_solve takes float32 or float64, "
                        f"got {V0.dtype}")
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, "
                             f"got {tuple(t.shape)}")
        if t.device != V0.device:
            raise ValueError(f"{name} is on {t.device}, V0 on {V0.device}")


def lmpc_solve_reference(pvec, Q, R, Qt, target, z0, V0, dt: float,
                         u_bound: float = 0.4, n_iters: int = 2,
                         n_alphas: int = 3, stats=None):
    """Plain PyTorch version of `lmpc_solve`, on any device; `stats` as in
    `_solve_lanes`."""
    _check(pvec, Q, R, Qt, target, z0, V0)
    dtype = V0.dtype
    V = torch.clamp(V0, -u_bound, u_bound)
    return _solve_lanes(
        *(t.to(dtype) for t in (pvec, Q, R, Qt, target, z0)), V,
        N=V0.shape[0], n_iters=n_iters, n_alphas=n_alphas, dt=dt,
        u_b=u_bound, stats=stats)


def lmpc_solve(pvec, Q, R, Qt, target, z0, V0, dt: float,
               u_bound: float = 0.4, n_iters: int = 2, n_alphas: int = 3):
    """Whole LMPC solve, batch-last. Returns (V (N,2,B), cost, gnorm (B,)).

    CPU tensors run the plain version. CUDA tensors launch the kernel and
    add one to `lmpc_solve.launches`; a horizon without an instance
    (`N_INSTANCES`), a budget outside 1 <= n_iters, 1 <= n_alphas <= 16,
    or a failed launch raises.
    """
    if V0.device.type == "cpu":
        return lmpc_solve_reference(pvec, Q, R, Qt, target, z0, V0, dt,
                                    u_bound, n_iters, n_alphas)
    _check(pvec, Q, R, Qt, target, z0, V0)
    if V0.device.type != "cuda":
        raise ValueError(f"lmpc_solve runs on cpu or cuda, not {V0.device}")
    N, _, Bt = V0.shape
    dtype = V0.dtype
    ins = [t.to(dtype).contiguous() for t in (pvec, Q, R, Qt, target, z0)]
    ins.append(torch.clamp(V0, -u_bound, u_bound).contiguous())
    V = torch.empty_like(ins[-1])
    cost, gnorm = (torch.empty((Bt,), dtype=dtype, device=V0.device)
                   for _ in range(2))
    lib = _build.library()
    fn = lib.lmpc_solve_f32 if dtype == torch.float32 else lib.lmpc_solve_f64
    stream = torch.cuda.current_stream(V0.device).cuda_stream
    with torch.cuda.device(V0.device):
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (*ins, V, cost,
                                                          gnorm)),
                 Bt, N, n_iters, n_alphas, float(dt), float(u_bound),
                 ctypes.c_void_p(stream))
    if err == _build.BAD_SHAPE:
        raise NotImplementedError(
            f"the CUDA kernel has no instance for N={N} (it has "
            f"{N_INSTANCES}): add one to launch() in csrc/lmpc_solve.cu")
    if err == _build.BAD_BUDGET:
        raise ValueError(
            f"budget n_iters={n_iters}, n_alphas={n_alphas} outside "
            f"1 <= n_iters, 1 <= n_alphas <= {MAX_ALPHAS}")
    if err != 0:
        raise RuntimeError(f"lmpc_solve kernel launch failed: "
                           f"{_build.error_string(err)} (code {err})")
    lmpc_solve.launches += 1
    return V, cost, gnorm


lmpc_solve.launches = 0


def launch_geometry(N: int, dtype: torch.dtype) -> dict:
    """Launch geometry of the CUDA instance for horizon N and `dtype`
    (`_build.launch_geometry`). Needs the built library and a card."""
    return _build.launch_geometry("lmpc_solve", N,
                                  torch.empty((), dtype=dtype).element_size())


# Per-lane operation counts of the solve (FLOPs; exp, tanh, sin and cos
# apart as transcendentals), over the function's structural non-zeros.
# The continuous Jacobian A of `models.dynamics.lmpc_jac` has 16 fixed
# non-zeros of 64 and B 2 of 16, and the x axis {px, vx, th_y, om_y} never
# meets the y axis {py, vy, th_x, om_x}: Ad, Bd, P, q, r and the gains stay
# two blocks. `_rk4_jac_counts` and `_stage_counts` count the products of
# the RK4 Jacobian chain, the Riccati recursion and the control law over
# the non-zeros they propagate (a product of m non-zero pairs into one
# entry is m multiplies and m - 1 adds). The scalar parts:
#   model f8           ~94 + 16 (6 Stribeck terms ~9 each, the slip
#                      arguments, forcing, topple torques and the sums;
#                      6 exp, 6 tanh, 4 sin)
#   Jacobian jac8      ~136 + 16 (6 Stribeck slopes ~16 each and the
#                      rows; 6 exp, 6 tanh, 4 cos)
#   rk4 step           4 f8 + 104 state updates
#   stage cost         ~45
#   backward stage     3 f8 + 4 jac8 + 48 (the RK4 stage states) + box QP
#                      ~150 + the control gradients' scalars 20
#   backward pass      + 32 (the terminal value)
#   trial stage        rk4 + stage cost, and the control law
_F8, _JAC8, _T_F8, _T_JAC8 = 94, 136, 16, 16
_RK4 = 4 * _F8 + 104
_ROLLOUT = _RK4 + 45
_BACKWARD = 3 * _F8 + 4 * _JAC8 + 48 + 150 + 20
_TERM = 31
_T_RK4 = 4 * _T_F8
_T_BACKWARD = 3 * _T_F8 + 4 * _T_JAC8
# Structural non-zeros (row, column) of lmpc_jac's A and B.
A_NZ = ((0, 1), (1, 0), (1, 1), (1, 7), (2, 3), (3, 2), (3, 3), (3, 5),
        (4, 5), (5, 3), (5, 4), (5, 5), (6, 7), (7, 1), (7, 6), (7, 7))
B_NZ = ((1, 0), (3, 1))


def _rk4_jac_counts():
    """(Ad mask, Bd mask, FLOPs) of `rk4_jac` on the model and the cost
    gradients Qx8 = 2 Q (x - tg) + Ad' vx8 and Qu's Bd' vx8 (vx8 dense).
    dk = A_s (I + s dk_prev) and A_s (s dku_prev) + B_s for the stages 2-4
    (dk_1 = A, B), summed S += 2 dk, 2 dk, dk; Ad = I + dt/6 Sx and
    Bd = dt/6 Su. The masks are the same at every stage."""
    A, B = _mask((8, 8), A_NZ), _mask((8, 2), B_NZ)
    eye = torch.eye(8) > 0
    n = 0
    Sx, Su, dkx, dku = A, B, A, B
    for stage in range(3):
        E, c = _addc(dkx, eye)
        n += _nnz(dkx) + c + _nnz(dku)              # I + s dkx, s dku
        dkx, c1 = _mmc(A, E)
        dku, c2 = _mmc(A, dku)
        dku, c3 = _addc(dku, B)
        Sx, c4 = _addc(Sx, dkx)
        Su, c5 = _addc(Su, dku)
        n += c1 + c2 + c3 + c4 + c5
        if stage < 2:
            n += _nnz(dkx) + _nnz(dku)              # the factor 2
    Ad, c = _addc(Sx, eye)
    n += _nnz(Sx) + c + _nnz(Su)
    dense = torch.ones((8, 1), dtype=torch.bool)
    n += _mmc(Ad.T, dense)[1] + 32 + _mmc(Su.T, dense)[1]
    return Ad, Su, n


def _stage_counts(N: int) -> tuple[int, int]:
    """(FLOPs of one backward pass's products over its N stages, FLOPs of
    one trial's N control laws), over the structural non-zeros, in the
    order `csrc/lmpc_solve.cu` writes the algebra: `rk4_jac` and the cost
    gradients, the partitioned Riccati update with `gains2`, and the
    trial's control law."""
    Ad, Bd, jac = _rk4_jac_counts()
    eye, eye2 = torch.eye(8) > 0, torch.eye(2) > 0
    Qux2 = eye2
    P, q, r = eye, _mask((8, 2)), _mask((2, 2))
    back = ctrl = 0
    for _ in range(N):
        n = jac
        # Qxx11 = Ad'P Ad + diag(2Q); T2 = Bd'P + q'; Qux1 = T2 Ad;
        # Quu = T2 Bd + Bd'q + r, symmetrised, plus the jitter.
        T1, c1 = _mmc(Ad.T, P)
        Qxx, c2 = _mmc(T1, Ad)
        T2, c3 = _mmc(Bd.T, P)
        T2, c4 = _addc(T2, q.T)
        Qux1, c5 = _mmc(T2, Ad)
        G1, c6 = _mmc(T2, Bd)
        G2, c7 = _mmc(Bd.T, q)
        Gm, c8 = _addc(G1, G2, r)
        Quu = Gm | Gm.T | eye2
        n += c1 + c2 + 16 + c3 + c4 + c5 + c6 + c7 + c8
        n += 2 * _nnz(Gm | Gm.T) + 8
        # gains2 on the columns b = [Qux1 | Qux2]: h00, h11, det (and h01
        # where Quu couples the two tilts), b * f, then per gain entry
        # h11 b0 - h01 b1 (or its other row) and -(.)/det.
        h01 = bool(Quu[0, 1])
        b0 = torch.cat([Qux1[0], Qux2[0]])
        b1 = torch.cat([Qux1[1], Qux2[1]])
        t0 = b0.long() + (b1 & h01).long()
        t1 = b1.long() + (b0 & h01).long()
        k0, k1 = t0 > 0, t1 > 0
        n += 9 + 4 * h01 + _nnz(b0) + _nnz(b1)
        n += int((2 * torch.cat([t0, t1]) - 1).clamp(min=0).sum())
        n += 2 * (_nnz(k0) + _nnz(k1))
        K1 = torch.stack([k0[:8], k1[:8]])
        K2 = torch.stack([k0[8:], k1[8:]])
        # Value update: w2 = Quu d + Qu, vx8 and vu2, then P', q', r'.
        n += 2 * _nnz(Quu)
        n += 2 * (_nnz(K1) + _nnz(Qux1) + _nnz(K2) + _nnz(Qux2))
        K1Q, c1 = _mmc(K1.T, Quu)
        M, c2 = _mmc(K1.T, Qux1)
        KQK, c3 = _mmc(K1Q, K1)
        T1, c4 = _addc(Qxx, KQK, M, M.T)
        P = T1 | T1.T
        n += c1 + c2 + c3 + c4 + 2 * _nnz(P)
        a1, c1 = _mmc(K1Q, K2)
        a2, c2 = _mmc(K1.T, Qux2)
        a3, c3 = _mmc(Qux1.T, K2)
        q, c4 = _addc(a1, a2, a3)
        n += c1 + c2 + c3 + c4
        K2Q, c1 = _mmc(K2.T, Quu)
        M2, c2 = _mmc(K2.T, Qux2)
        KQK2, c3 = _mmc(K2Q, K2)
        rn, c4 = _addc(KQK2, M2, M2.T)
        r = rn | rn.T
        n += c1 + c2 + c3 + c4 + 2 * _nnz(r) + 4
        back += n
        # The trial's control law at this stage: Xt - X and tp - np where
        # the gains read them, K1 dx + K2 du per tilt, V + al D + both, and
        # the clip.
        ctrl += _nnz(K1.any(0)) + _nnz(K2.any(0)) + 12 + sum(
            max(2 * _nnz(K[a]) - 1, 0) for K in (K1, K2) for a in range(2))
    return back + 32, ctrl


def _counts(N, n_iters, trials):
    """(FLOPs, transcendentals) of one lane that ran `trials` line-search
    trials in all."""
    back, ctrl = _stage_counts(N)
    flops = (N * _ROLLOUT + _TERM + n_iters * (N * _BACKWARD + back)
             + trials * (N * _ROLLOUT + ctrl + _TERM))
    trans = N * _T_RK4 + n_iters * N * _T_BACKWARD + trials * N * _T_RK4
    return flops, trans


def flops_per_solve(N: int = 20, n_iters: int = 2,
                    n_alphas: int = 3) -> tuple[int, int]:
    """(FLOPs, transcendentals) of ONE lane's solve when every iteration
    runs all `n_alphas` trials, as the TPU kernel does."""
    return _counts(N, n_iters, n_iters * n_alphas)


def work(N: int, n_iters: int, B: int, trials: int,
         itemsize: int) -> tuple[int, int, int]:
    """(FLOPs, transcendentals, bytes) of one call over B lanes that ran
    `trials` line-search trials in all (`stats["trials"].sum()` of the
    plain version): the work this call's data needs, for the roofline
    bound. Bytes: pvec, Q, R, Qt, target, z0, V0 read once; V, cost, gnorm
    written once."""
    (flops, trans), (_, ctrl) = _counts(N, n_iters, 0), _stage_counts(N)
    flops = B * flops + trials * (N * _ROLLOUT + ctrl + _TERM)
    trans = B * trans + trials * N * _T_RK4
    values = 34 + 8 + 4 + 8 + 8 + 10 + N * 2 + N * 2 + 2
    return flops, trans, B * values * itemsize
