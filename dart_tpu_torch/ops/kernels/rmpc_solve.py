"""The complete slew-exact RMPC solve, augmented-Lagrangian outer loop
included, in one launch (port of `dart_tpu.ops.pallas.rmpc_solve`).

The OCP is `solver.ocp.make_rmpc_ocp_du`: decision variable v = du with
box bounds +-du_bound handled exactly by per-stage 2x2 box QPs, applied
tilt u = clip(u_prev + v, +-u_bound), velocity caps |vx|,|vy| <= vmax as
PHR augmented-Lagrangian rows with per-lane multipliers lam (N,4) and
penalty mu. The RK4 linearisation is the closed-form chain rule of
`models.dynamics.rk4_jac`; the Riccati backward pass is partitioned over
the augmented state z = [x(4), u_prev(2)] into P (4,4), q (4,2), r (2,2).

`rmpc_solve` keeps `rmpc_solve_pallas`'s batch-last layout: theta (14,B),
ref (N+1,4,B), w (4,B) = [Qp, Qv, Ru, Rdu], z0 (6,B) = [x0, u_prev],
V0 (N,2,B). Returns V (N,2,B), and the raw cost, viol and gnorm (B,). V0
is clipped to +-du_bound first. gnorm is the max |feedforward| of the last
backward pass, taken before its line search. On CUDA tensors it launches
`csrc/rmpc_solve.cu` (a lane per group of 4 threads, the horizon in shared
memory, the line search's alphas in parallel); on CPU tensors it runs
`rmpc_solve_reference`, the plain PyTorch version of `_rmpc_kernel`.
"""

from __future__ import annotations

import ctypes

import torch

from dart_tpu_torch.ops.kernels import _build
from dart_tpu_torch.ops.kernels.lanes import (_add_diag_vec, _addc,
                                              _boxqp2_lanes, _gains_lanes,
                                              _mask, _mm, _mmc, _mT, _mv,
                                              _nnz, _rk4_jac_lanes)

# Signed gravity of the kernel, like model.opt.gravity[2]; the kernel does
# not take RMPCParams.g.
G = -9.81
N_INSTANCES = (6, 20)
MAX_ALPHAS = 16


def _solve_lanes(th, ref, wv, z0, V, *, N, n_iters, n_alphas, al_rounds, dt,
                 u_b, du_b, vmax, v_eps, mu_init, mu_scale, mu_max, tol_con,
                 stats=None):
    """Plain version of the kernel body `_rmpc_kernel`, on (..., L) lanes.
    Returns V (N,2,L), raw cost, viol and gnorm (L,). A `stats` dict gets
    "trials" (L,): the line-search trials the kernel runs per lane (it
    stops at the first accepted alpha and skips done lanes)."""
    Qp, Qv, Ru, Rdu = wv[0], wv[1], wv[2], wv[3]
    w4 = torch.stack([Qp, Qv, Qp, Qv])
    x0, up0 = z0[0:4], z0[4:6]

    def f4(x, u):
        px, vx, py, vy = x[0], x[1], x[2], x[3]
        tx = torch.tanh(vx / v_eps)
        ty = torch.tanh(vy / v_eps)
        ax = (G * torch.sin(u[0]) + th[0] * px + th[1] * vx + th[2] * py
              + th[3] * vy + th[4] * tx + th[5] * ty + th[6])
        ay = (G * torch.sin(u[1]) + th[7] * px + th[8] * vx + th[9] * py
              + th[10] * vy + th[11] * tx + th[12] * ty + th[13])
        return torch.stack([vx, ax, vy, ay])

    def jac4(x, u):
        vx, vy = x[1], x[3]
        tx = torch.tanh(vx / v_eps)
        ty = torch.tanh(vy / v_eps)
        dtx = (1.0 - tx * tx) / v_eps
        dty = (1.0 - ty * ty) / v_eps
        z, o = torch.zeros_like(vx), torch.ones_like(vx)
        r_ax = [th[0], th[1] + th[4] * dtx, th[2], th[3] + th[5] * dty]
        r_ay = [th[7], th[8] + th[11] * dtx, th[9], th[10] + th[12] * dty]
        A = torch.stack([torch.stack([z, o, z, z]), torch.stack(r_ax),
                         torch.stack([z, z, z, o]), torch.stack(r_ay)])
        ca = G * torch.cos(u[0])
        cb = G * torch.cos(u[1])
        Bm = torch.stack([torch.stack([z, z]), torch.stack([ca, z]),
                          torch.stack([z, z]), torch.stack([z, cb])])
        return A, Bm

    def rk4(x, u):
        k1 = f4(x, u)
        k2 = f4(x + 0.5 * dt * k1, u)
        k3 = f4(x + 0.5 * dt * k2, u)
        k4 = f4(x + dt * k3, u)
        return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def con4(x):
        return torch.stack([x[1] - vmax, -x[1] - vmax,
                            x[3] - vmax, -x[3] - vmax])

    def stage_cost_al(x, up, v, k, lam_k, mu):
        u = torch.clamp(up + v, -u_b, u_b)
        e = x - ref[k]
        c = (torch.sum(w4 * e * e, dim=0)
             + Ru * (u[0] * u[0] + u[1] * u[1])
             + Rdu * (v[0] * v[0] + v[1] * v[1]))
        t = torch.clamp_min(lam_k + mu * con4(x), 0.0)
        return c + torch.sum(t * t - lam_k * lam_k, dim=0) / (2.0 * mu)

    def rollout_cost(V, lam, mu):
        xs, us = [x0], [up0]
        cost = torch.zeros_like(Qp)
        for k in range(N):
            cost = cost + stage_cost_al(xs[k], us[k], V[k], k, lam[k], mu)
            u = torch.clamp(us[k] + V[k], -u_b, u_b)
            xs.append(rk4(xs[k], u))
            us.append(u)
        e = xs[N] - ref[N]
        cost = cost + torch.sum(w4 * e * e, dim=0)
        return torch.stack(xs), torch.stack(us), cost

    alphas = [0.6 ** i for i in range(n_alphas)]
    zl = torch.zeros_like(Qp)

    def iteration(carry, lam, mu):
        X, U, V, cost, done, _ = carry
        # ---- backward: partitioned Riccati over z = [x(4), u_prev(2)] ----
        vx4 = 2.0 * w4 * (X[N] - ref[N])
        vu2 = torch.zeros_like(up0)
        P = _add_diag_vec(torch.stack([torch.stack([zl] * 4)] * 4), 2.0 * w4)
        q = torch.stack([torch.stack([zl] * 2)] * 4)
        r = torch.stack([torch.stack([zl] * 2)] * 2)
        Ds, K1s, K2s, gns = [None] * N, [None] * N, [None] * N, []
        for k in range(N - 1, -1, -1):
            x, up, v_k = X[k], U[k], V[k]
            s = up + v_k
            m = (torch.abs(s) < u_b).to(Qp.dtype)
            u = torch.clamp(s, -u_b, u_b)
            Ad, Bd = _rk4_jac_lanes(f4, jac4, x, u, dt)
            Bm = Bd * m[None]

            e = x - ref[k]
            gu = 2.0 * Ru * u * m
            hu = 2.0 * Ru * m
            e4 = 2.0 * w4 * e
            lv = 2.0 * Rdu * v_k + gu
            t = torch.clamp_min(lam[k] + mu * con4(x), 0.0)
            act = (t > 0).to(Qp.dtype)
            lx4 = torch.stack([e4[0], e4[1] + t[0] - t[1],
                               e4[2], e4[3] + t[2] - t[3]])
            diag_al = torch.stack([zl, mu * (act[0] + act[1]),
                                   zl, mu * (act[2] + act[3])])

            AdT, BmT = _mT(Ad), _mT(Bm)
            core = _mv(BmT, vx4) + m * vu2
            Qx4 = lx4 + _mv(AdT, vx4)
            Qu2 = gu + core
            Qvl = lv + core

            W = _mm(P, Bm) + q * m[None]
            S1 = _mT(W)
            S2 = _mm(BmT, q) + r * m[:, None]
            Qxx11 = _add_diag_vec(_mm(_mm(AdT, P), Ad), 2.0 * w4 + diag_al)
            Qxx12 = _mm(AdT, W)
            Gm = _mm(S1, Bm) + S2 * m[None]
            Qvz1 = _mm(S1, Ad)
            Qvz2 = _add_diag_vec(Gm, hu)
            Qxx22 = Qvz2
            Qvv = _add_diag_vec(Gm, 2.0 * Rdu + hu + 1e-8)
            Qvv = 0.5 * (Qvv + _mT(Qvv))

            d, free = _boxqp2_lanes(Qvv, Qvl, -du_b - v_k, du_b - v_k)
            gns.append(torch.maximum(torch.abs(d[0]), torch.abs(d[1])))
            # Every column of Qvz1 and Qvz2 at once (the same operations
            # per column).
            (k1, k2) = _gains_lanes(Qvv, free, [(Qvz1[0], Qvz1[1]),
                                                (Qvz2[0], Qvz2[1])])
            K1, K2 = torch.stack(k1), torch.stack(k2)

            w2 = _mv(Qvv, d) + Qvl
            vx4 = Qx4 + _mv(_mT(K1), w2) + _mv(_mT(Qvz1), d)
            vu2 = Qu2 + _mv(_mT(K2), w2) + _mv(_mT(Qvz2), d)
            K1T_Qvv = _mm(_mT(K1), Qvv)
            M1 = _mm(_mT(K1), Qvz1)
            P = Qxx11 + _mm(K1T_Qvv, K1) + M1 + _mT(M1)
            P = 0.5 * (P + _mT(P))
            q = (Qxx12 + _mm(K1T_Qvv, K2) + _mm(_mT(K1), Qvz2)
                 + _mm(_mT(Qvz1), K2))
            K2T_Qvv = _mm(_mT(K2), Qvv)
            M2 = _mm(_mT(K2), Qvz2)
            r = Qxx22 + _mm(K2T_Qvv, K2) + M2 + _mT(M2)
            r = 0.5 * (r + _mT(r))
            Ds[k], K1s[k], K2s[k] = d, K1, K2

        # ---- forward line search with per-lane acceptance ----
        accepted = done
        X_best, U_best, V_best, c_best = X, U, V, cost
        for al in alphas:
            if stats is not None:
                stats["trials"] = stats["trials"] + (~accepted).long()
            x, up = x0, up0
            xs_new, us_new, vs_new = [x0], [up0], []
            c_new = torch.zeros_like(Qp)
            for k in range(N):
                v = (V[k] + al * Ds[k] + _mv(K1s[k], x - X[k])
                     + _mv(K2s[k], up - U[k]))
                v = torch.clamp(v, -du_b, du_b)
                c_new = c_new + stage_cost_al(x, up, v, k, lam[k], mu)
                u = torch.clamp(up + v, -u_b, u_b)
                x = rk4(x, u)
                up = u
                xs_new.append(x)
                us_new.append(u)
                vs_new.append(v)
            e = x - ref[N]
            c_new = c_new + torch.sum(w4 * e * e, dim=0)
            newly = (~accepted) & (c_new < cost - 1e-12)
            X_best = torch.where(newly, torch.stack(xs_new), X_best)
            U_best = torch.where(newly, torch.stack(us_new), U_best)
            V_best = torch.where(newly, torch.stack(vs_new), V_best)
            c_best = torch.where(newly, c_new, c_best)
            accepted = accepted | newly

        rel = (cost - c_best) / (torch.abs(cost) + 1.0)
        done_n = done | (accepted & (rel < 1e-9)) | (~accepted)
        gnorm = gns[0]
        for g_k in gns[1:]:
            gnorm = torch.maximum(gnorm, g_k)
        return X_best, U_best, V_best, c_best, done_n, gnorm

    # ---- augmented-Lagrangian outer loop (per-lane lam/mu) ----
    lam = torch.stack([torch.stack([zl] * 4)] * N)
    mu = torch.full_like(Qp, mu_init)
    viol, gnorm = zl, zl
    if stats is not None:
        stats["trials"] = torch.zeros_like(Qp, dtype=torch.long)
    for _ in range(al_rounds):
        X, U, cost = rollout_cost(V, lam, mu)
        carry = (X, U, V, cost, torch.zeros_like(Qp, dtype=torch.bool), zl)
        for _ in range(n_iters):
            carry = iteration(carry, lam, mu)
        X, U, V, cost, _, gnorm = carry
        # PHR multiplier update on the round's final trajectory.
        viol = torch.zeros_like(Qp)
        new_lam = []
        for k in range(N):
            C = con4(X[k])
            new_lam.append(torch.clamp_min(lam[k] + mu[None] * C, 0.0))
            viol = torch.maximum(viol, torch.amax(torch.clamp_min(C, 0.0),
                                                  dim=0))
        lam = torch.stack(new_lam)
        mu = torch.where(viol > tol_con,
                         torch.clamp_max(mu * mu_scale, mu_max), mu)

    # Raw (unpenalised) cost of the final iterate.
    raw = torch.zeros_like(Qp)
    x, up = x0, up0
    for k in range(N):
        u = torch.clamp(up + V[k], -u_b, u_b)
        e = x - ref[k]
        raw = raw + (torch.sum(w4 * e * e, dim=0)
                     + Ru * (u[0] * u[0] + u[1] * u[1])
                     + Rdu * (V[k][0] * V[k][0] + V[k][1] * V[k][1]))
        x = rk4(x, u)
        up = u
    e = x - ref[N]
    raw = raw + torch.sum(w4 * e * e, dim=0)
    return V, raw, viol, gnorm


def _check(theta, ref, w, z0, V0):
    if V0.dim() != 3 or V0.shape[1] != 2:
        raise ValueError(f"V0 must be (N, 2, B), got {tuple(V0.shape)}")
    N, _, Bt = V0.shape
    want = {"theta": (14, Bt), "ref": (N + 1, 4, Bt), "w": (4, Bt),
            "z0": (6, Bt), "V0": (N, 2, Bt)}
    got = {"theta": theta, "ref": ref, "w": w, "z0": z0, "V0": V0}
    if V0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rmpc_solve takes float32 or float64, "
                        f"got {V0.dtype}")
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, "
                             f"got {tuple(t.shape)}")
        if t.device != V0.device:
            raise ValueError(f"{name} is on {t.device}, V0 on {V0.device}")


def rmpc_solve_reference(theta, ref, w, z0, V0, dt: float,
                         u_bound: float = 0.4, du_bound: float = 0.05,
                         vmax: float = 0.25, v_eps: float = 0.1,
                         n_iters: int = 2, n_alphas: int = 3,
                         al_rounds: int = 2, mu_init: float = 10.0,
                         mu_scale: float = 10.0, mu_max: float = 1e8,
                         tol_con: float = 1e-8, stats=None):
    """Plain PyTorch version of `rmpc_solve`, on any device; `stats` as in
    `_solve_lanes`."""
    _check(theta, ref, w, z0, V0)
    dtype = V0.dtype
    V = torch.clamp(V0, -du_bound, du_bound)
    return _solve_lanes(
        theta.to(dtype), ref.to(dtype), w.to(dtype), z0.to(dtype), V,
        N=V0.shape[0], n_iters=n_iters, n_alphas=n_alphas,
        al_rounds=al_rounds, dt=dt, u_b=u_bound, du_b=du_bound, vmax=vmax,
        v_eps=v_eps, mu_init=mu_init, mu_scale=mu_scale, mu_max=mu_max,
        tol_con=tol_con, stats=stats)


def rmpc_solve(theta, ref, w, z0, V0, dt: float, u_bound: float = 0.4,
               du_bound: float = 0.05, vmax: float = 0.25,
               v_eps: float = 0.1, n_iters: int = 2, n_alphas: int = 3,
               al_rounds: int = 2, mu_init: float = 10.0,
               mu_scale: float = 10.0, mu_max: float = 1e8,
               tol_con: float = 1e-8):
    """Whole RMPC solve, batch-last. Returns (V (N,2,B), cost, viol,
    gnorm (B,)).

    CPU tensors run the plain version. CUDA tensors launch the kernel and
    add one to `rmpc_solve.launches`; a horizon without an instance
    (`N_INSTANCES`), a budget outside 1 <= n_iters, 1 <= al_rounds,
    1 <= n_alphas <= 16, or a failed launch raises.
    """
    if V0.device.type == "cpu":
        return rmpc_solve_reference(
            theta, ref, w, z0, V0, dt, u_bound, du_bound, vmax, v_eps,
            n_iters, n_alphas, al_rounds, mu_init, mu_scale, mu_max, tol_con)
    _check(theta, ref, w, z0, V0)
    if V0.device.type != "cuda":
        raise ValueError(f"rmpc_solve runs on cpu or cuda, not {V0.device}")
    N, _, Bt = V0.shape
    dtype = V0.dtype
    ins = [t.to(dtype).contiguous() for t in (theta, ref, w, z0, V0)]
    V = torch.empty_like(ins[-1])
    cost, viol, gnorm = (torch.empty((Bt,), dtype=dtype, device=V0.device)
                         for _ in range(3))
    lib = _build.library()
    fn = lib.rmpc_solve_f32 if dtype == torch.float32 else lib.rmpc_solve_f64
    stream = torch.cuda.current_stream(V0.device).cuda_stream
    with torch.cuda.device(V0.device):
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in
                   (*ins, V, cost, viol, gnorm)),
                 Bt, N, n_iters, n_alphas, al_rounds, float(dt),
                 float(u_bound), float(du_bound), float(vmax), float(v_eps),
                 float(mu_init), float(mu_scale), float(mu_max),
                 float(tol_con), ctypes.c_void_p(stream))
    if err == _build.BAD_SHAPE:
        raise NotImplementedError(
            f"the CUDA kernel has no instance for N={N} (it has "
            f"{N_INSTANCES}): add one to launch() in csrc/rmpc_solve.cu")
    if err == _build.BAD_BUDGET:
        raise ValueError(
            f"budget n_iters={n_iters}, n_alphas={n_alphas}, al_rounds="
            f"{al_rounds} outside 1 <= n_iters, 1 <= al_rounds, "
            f"1 <= n_alphas <= {MAX_ALPHAS}")
    if err != 0:
        raise RuntimeError(f"rmpc_solve kernel launch failed: "
                           f"{_build.error_string(err)} (code {err})")
    rmpc_solve.launches += 1
    return V, cost, viol, gnorm


rmpc_solve.launches = 0


def launch_geometry(N: int, dtype: torch.dtype) -> dict:
    """Launch geometry of the CUDA instance for horizon N and `dtype`
    (`_build.launch_geometry`). Needs the built library and a card."""
    return _build.launch_geometry("rmpc_solve", N,
                                  torch.empty((), dtype=dtype).element_size())


# Per-lane operation counts of the solve (FLOPs; tanh, sin and cos apart
# as transcendentals), over the function's structural non-zeros. The
# continuous Jacobian A of `models.dynamics.rmpc_jac` has 10 fixed
# non-zeros of 16, two of them the unit entries of the position rows, which
# multiply nothing, and B has 2 of 8. The x and y axes couple through theta,
# so the RK4 chain makes Ad and Bd dense and the Riccati recursion is dense
# from its second stage on; `_rk4_jac_counts` and `_stage_counts` count the
# products over the non-zeros they propagate (m non-zero pairs into one
# entry are m multiplies, less the unit factors, and m - 1 adds). The
# scalar parts:
#   model f4           32 (two velocity rows copy; 2 tanh)
#   rk4 step           4 f4 + 52 state updates = 180 (8 tanh, 2 sin)
#   rollout stage      rk4 + AL stage cost ~65 = 245
#   trial stage        rk4 + AL stage cost + control law ~40 = 285
#   backward stage     3 f4, A's rows at 4 states 56, the stage states 24,
#                      u and its mask 2, the cost quadratics and PHR rows
#                      48, Qvv 16, the box QP ~150, the gains' H 13, w2 8
#                      = 413 (8 tanh, 2 sin, 2 cos), and the products
#   multiplier update  24 per stage
_ROLLOUT, _TRIAL, _AL_UPDATE = 245, 285, 24
_BACK_SCALAR = 3 * 32 + 56 + 24 + 2 + 48 + 16 + 150 + 13 + 8
_T_STEP, _T_BACKWARD = 10, 12
# Structural non-zeros (row, column) of rmpc_jac's A and B, and A's units.
A_NZ = ((0, 1), (1, 0), (1, 1), (1, 2), (1, 3), (2, 3), (3, 0), (3, 1),
        (3, 2), (3, 3))
A_UNIT = ((0, 1), (2, 3))
B_NZ = ((1, 0), (3, 1))


def _rk4_jac_counts():
    """(Ad mask, Bd mask, FLOPs) of the RK4 Jacobian chain of `rk4_jac`:
    dk = A_s (I + h dk_prev) and A_s (h dku_prev) + B_s for the stages 2-4
    (dk_1 = A, B), summed S += 2 dk, 2 dk, dk; Ad = I + dt/6 Sx and
    Bd = dt/6 Su. A's mask is the same at every stage."""
    A, B = _mask((4, 4), A_NZ), _mask((4, 2), B_NZ)
    unit = _mask((4, 4), A_UNIT)
    eye = torch.eye(4) > 0
    n = 0
    Sx, Su, dkx, dku = A, B, A, B
    for stage in range(3):
        E, c = _addc(dkx, eye)
        n += _nnz(dkx) + c + _nnz(dku)              # I + h dkx, h dku
        dkx, c1 = _mmc(A, E, unit)
        dku, c2 = _mmc(A, dku, unit)
        dku, c3 = _addc(dku, B)
        Sx, c4 = _addc(Sx, dkx)
        Su, c5 = _addc(Su, dku)
        n += c1 + c2 + c3 + c4 + c5
        if stage < 2:
            n += _nnz(dkx) + _nnz(dku)              # the factor 2
    Ad, c = _addc(Sx, eye)
    n += _nnz(Sx) + c + _nnz(Su)
    return Ad, Su, n


def _stage_counts(N: int) -> int:
    """FLOPs of one backward pass's products over its N stages, over the
    structural non-zeros, in the order `csrc/rmpc_solve.cu` writes the
    algebra: the RK4 Jacobian chain, the cost gradients, the partitioned
    Riccati update over z = [x(4), u_prev(2)] with `gains2` on the columns
    of [Qvz1 | Qvz2], and the value update. P starts diagonal and q, r at
    zero, so the last stage is cheaper than the others."""
    Ad, Bd, jac = _rk4_jac_counts()
    eye = torch.eye(4) > 0
    col = torch.ones((4, 1), dtype=torch.bool)
    P, q, r = eye, _mask((4, 2)), _mask((2, 2))
    back = 0
    for _ in range(N):
        n = jac + _nnz(Bd)                            # Bm = Bd m
        n += _mmc(Bd.T, col)[1] + 4 + 4               # core, Qu2, Qvl
        n += _mmc(Ad.T, col)[1] + 4                   # Qx4
        W, c1 = _mmc(P, Bd)
        W, c2 = _addc(W, q)
        n += c1 + _nnz(q) + c2                        # W = P Bm + q m
        S2, c1 = _mmc(Bd.T, q)
        S2, c2 = _addc(S2, r)
        n += c1 + _nnz(r) + c2                        # S2 = Bm'q + r m
        T1, c1 = _mmc(Ad.T, P)
        Qxx11, c2 = _mmc(T1, Ad)
        n += c1 + c2 + 12                             # + diag(2 w4 + dal)
        Qxx12, c1 = _mmc(Ad.T, W)                     # Qvz1 = Qxx12'
        G, c2 = _mmc(W.T, Bd)
        G, c3 = _addc(G, S2)
        n += c1 + c2 + _nnz(S2) + c3
        Qvz1, Qvz2 = Qxx12.T, G | eye[:2, :2]         # Qvz2 = G + diag(hu)
        n += 2
        # gains2 per non-zero column of [Qvz1 | Qvz2] (both rows, since H
        # couples them): b * f, two products, two divisions.
        K1 = Qvz1.any(0).expand(2, 4)
        K2 = Qvz2.any(0).expand(2, 2)
        n += 12 * (_nnz(K1[0]) + _nnz(K2[0]))
        two = torch.ones((2, 1), dtype=torch.bool)
        Quu = torch.ones((2, 2), dtype=torch.bool)
        # vx4 = Qx4 + K1'w2 + Qvz1'd and vu2 = Qu2 + K2'w2 + Qvz2'd.
        n += _mmc(K1.T, two)[1] + _mmc(Qvz1.T, two)[1] + 8
        n += _mmc(K2.T, two)[1] + _mmc(Qvz2.T, two)[1] + 4
        K1Q, c1 = _mmc(K1.T, Quu)
        M1, c2 = _mmc(K1.T, Qvz1)
        KQK, c3 = _mmc(K1Q, K1)
        Pn, c4 = _addc(Qxx11, KQK, M1, M1.T)
        P = Pn | Pn.T
        n += c1 + c2 + c3 + c4 + 2 * _nnz(P)
        a1, c1 = _mmc(K1Q, K2)
        a2, c2 = _mmc(K1.T, Qvz2)
        a3, c3 = _mmc(Qvz1.T, K2)
        q, c4 = _addc(Qxx12, a1, a2, a3)
        n += c1 + c2 + c3 + c4
        K2Q, c1 = _mmc(K2.T, Quu)
        M2, c2 = _mmc(K2.T, Qvz2)
        KQK2, c3 = _mmc(K2Q, K2)
        rn, c4 = _addc(Qvz2, KQK2, M2, M2.T)
        r = rn | rn.T
        n += c1 + c2 + c3 + c4 + 2 * _nnz(r)
        back += _BACK_SCALAR + n
    return back + 16                                  # the terminal value


def _counts(N, n_iters, al_rounds, trials):
    """(FLOPs, transcendentals) of one lane that ran `trials` line-search
    trials in all."""
    rollout = N * _ROLLOUT + 12
    flops = (al_rounds * (rollout + N * _AL_UPDATE + n_iters * _stage_counts(N))
             + rollout + trials * (N * _TRIAL + 12))
    trans = (al_rounds * (N * _T_STEP + n_iters * N * _T_BACKWARD)
             + N * _T_STEP + trials * N * _T_STEP)
    return flops, trans


def flops_per_solve(N: int = 20, n_iters: int = 6, n_alphas: int = 4,
                    al_rounds: int = 3) -> tuple[int, int]:
    """(FLOPs, transcendentals) of ONE lane's solve when every iteration
    runs all `n_alphas` trials, as the TPU kernel does."""
    return _counts(N, n_iters, al_rounds, al_rounds * n_iters * n_alphas)


def work(N: int, n_iters: int, al_rounds: int, B: int, trials: int,
         itemsize: int) -> tuple[int, int, int]:
    """(FLOPs, transcendentals, bytes) of one call over B lanes that ran
    `trials` line-search trials in all (`stats["trials"].sum()` of the
    plain version): the work this call's data needs, for the roofline
    bound, however the kernel schedules its trials. Bytes: theta, ref, w,
    z0, V0 read once; V, cost, viol, gnorm written once."""
    flops, trans = _counts(N, n_iters, al_rounds, 0)
    flops = B * flops + trials * (N * _TRIAL + 12)
    trans = B * trans + trials * N * _T_STEP
    values = 14 + (N + 1) * 4 + 4 + 6 + N * 2 + N * 2 + 3
    return flops, trans, B * values * itemsize
