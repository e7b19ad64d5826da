"""The complete PMPC box-DDP solve in one launch (port of
`dart_tpu.ops.pallas.pmpc_solve`).

Because the PMPC dynamics are affine in the state (x+ = Ad x + Sd c(u), see
`solver.pmpc_fast`), every stage of the solve is closed-form per-lane
algebra: rollout, reg-free Riccati backward with an exact 2x2 box QP per
stage, multi-alpha line search with per-lane accept and done masks, and a
fixed number of iterations. Only the free entries of the structured
operators enter the solve: Ad = blkdiag([[1,a],[0,b]] x2, diag(1, g5)),
Sd = dt-diagonal plus the same pattern (3 and 4 lane values).

`pmpc_solve` keeps `pmpc_solve_pallas`'s signature and batch-last layout:
Ad/Sd (6,6,B), wdiag/target/z0 (6,B), rw (B,), V0 (N,2,B). On CUDA tensors
it launches the hand-written kernel `csrc/pmpc_solve.cu` (a lane per group
of 8 threads), which also runs the structure guard; on CPU tensors it runs
`pmpc_solve_reference`, the plain PyTorch version that follows the TPU
kernel body line for line and runs the guard (`structure_residual`) after
it.
"""

from __future__ import annotations

import ctypes

import torch

from dart_tpu_torch.ops.kernels import _build
from dart_tpu_torch.ops.kernels.lanes import (_add_diag_vec, _addc,
                                              _boxqp2_lanes, _diag_embed,
                                              _mask, _mmc, _mv, _nnz)


def _solve_lanes(ad, sd, wdiag, rw, target, z0, V, u_lo, u_hi, dt, g,
                 n_iters, n_alphas, stats=None):
    """Plain version of the kernel body `_pmpc_kernel`, on (…, L) lanes.

    ad (3,L), sd (4,L), wdiag/target/z0 (6,L), rw (L,), V (N,2,L),
    u_lo/u_hi (2,L). Returns V (N,2,L), cost (L,), gnorm (L,). A `stats`
    dict gets "trials" (L,): the line-search trials the kernel runs per
    lane (it stops at the first accepted alpha and skips done lanes).
    """
    N = V.shape[0]
    a_, b_, g_ = ad[0], ad[1], ad[2]
    sg0, sg1, s44, s55 = sd[0], sd[1], sd[2], sd[3]
    s5dt = s55 * (1.0 / dt)
    w2 = 2.0 * wdiag

    def step_dyn(x, v):
        """x+ = Ad x + Sd c(v), specialised to the sparsity."""
        s0 = torch.sin(v[0])
        s1 = torch.sin(v[1])
        w = -g * (v[0] * v[0] + v[1] * v[1])
        gs0 = g * s0
        gs1 = g * s1
        return torch.stack([x[0] + a_ * x[1] + gs0 * sg0,
                            b_ * x[1] + gs0 * sg1,
                            x[2] + a_ * x[3] + gs1 * sg0,
                            b_ * x[3] + gs1 * sg1,
                            x[4] + s44 * w,
                            g_ * x[5] + s5dt * w])

    def stage_cost(x, v):
        e = x - target
        return torch.sum(wdiag * e * e, dim=0) \
            + rw * (v[0] * v[0] + v[1] * v[1])

    def rollout_cost(V):
        zs = [z0]
        cost = torch.zeros_like(rw)
        for k in range(N):
            cost = cost + stage_cost(zs[k], V[k])
            zs.append(step_dyn(zs[k], V[k]))
        e = zs[N] - target
        cost = cost + torch.sum(wdiag * e * e, dim=0)
        return zs, cost

    zs, cost = rollout_cost(V)
    Z = torch.stack(zs)           # (N+1, 6, L)
    alphas = [0.6 ** i for i in range(n_alphas)]

    def iteration(Z, V, cost, done):
        # ---- backward (reg-free: Quu is PD for this problem) ----
        eT = Z[N] - target
        Vx = w2 * eT
        Vxx = _diag_embed(w2)
        Ds, Ks, gns = [], [], []
        for k in range(N - 1, -1, -1):
            v_k = V[k]
            # B = Sd dc/du: col0 on rows (0,1,4,5), col1 on (2,3,4,5).
            gc0 = g * torch.cos(v_k[0])
            gc1 = g * torch.cos(v_k[1])
            m2g0 = -2.0 * g * v_k[0]
            m2g1 = -2.0 * g * v_k[1]
            p0, p1, p4, p5 = gc0 * sg0, gc0 * sg1, m2g0 * s44, m2g0 * s5dt
            q2, q3, q4, q5 = gc1 * sg0, gc1 * sg1, m2g1 * s44, m2g1 * s5dt
            e = Z[k] - target
            lx = w2 * e
            lu = 2.0 * rw * v_k
            Qx = torch.stack([lx[0] + Vx[0],
                              lx[1] + a_ * Vx[0] + b_ * Vx[1],
                              lx[2] + Vx[2],
                              lx[3] + a_ * Vx[2] + b_ * Vx[3],
                              lx[4] + Vx[4],
                              lx[5] + g_ * Vx[5]])
            Qu = torch.stack([
                lu[0] + p0 * Vx[0] + p1 * Vx[1] + p4 * Vx[4] + p5 * Vx[5],
                lu[1] + q2 * Vx[2] + q3 * Vx[3] + q4 * Vx[4] + q5 * Vx[5]])
            # W = Vxx @ Ad: columns 0,2,4 are copies, 1,3,5 short FMAs.
            W = torch.stack([Vxx[:, 0], a_ * Vxx[:, 0] + b_ * Vxx[:, 1],
                             Vxx[:, 2], a_ * Vxx[:, 2] + b_ * Vxx[:, 3],
                             Vxx[:, 4], g_ * Vxx[:, 5]], dim=1)
            # Qxx = 2 diag(w) + Ad^T W.
            Qxx = torch.stack([W[0], a_ * W[0] + b_ * W[1],
                               W[2], a_ * W[2] + b_ * W[3],
                               W[4], g_ * W[5]])
            Qxx = _add_diag_vec(Qxx, w2)
            Qux = torch.stack([
                p0 * W[0] + p1 * W[1] + p4 * W[4] + p5 * W[5],
                q2 * W[2] + q3 * W[3] + q4 * W[4] + q5 * W[5]])
            # Quu = B^T Vxx B through t0 = Vxx b0, t1 = Vxx b1.
            t0 = [Vxx[j, 0] * p0 + Vxx[j, 1] * p1
                  + Vxx[j, 4] * p4 + Vxx[j, 5] * p5 for j in range(6)]
            t1 = [Vxx[j, 2] * q2 + Vxx[j, 3] * q3
                  + Vxx[j, 4] * q4 + Vxx[j, 5] * q5 for j in (2, 3, 4, 5)]
            rdiag = 2.0 * rw + 1e-8
            q00 = p0 * t0[0] + p1 * t0[1] + p4 * t0[4] + p5 * t0[5] + rdiag
            q01 = q2 * t0[2] + q3 * t0[3] + q4 * t0[4] + q5 * t0[5]
            q11 = q2 * t1[0] + q3 * t1[1] + q4 * t1[2] + q5 * t1[3] + rdiag
            Quu = torch.stack([torch.stack([q00, q01]),
                               torch.stack([q01, q11])])
            d, free = _boxqp2_lanes(Quu, Qu, u_lo - v_k, u_hi - v_k)
            gn_k = torch.maximum(torch.abs(d[0]), torch.abs(d[1]))
            f0, f1 = free[0], free[1]
            h00 = q00 * f0 * f0 + (1.0 - f0)
            h01 = q01 * f0 * f1
            h11 = q11 * f1 * f1 + (1.0 - f1)
            deth = h00 * h11 - h01 * h01
            deth = torch.where(torch.abs(deth) < 1e-30,
                               torch.full_like(deth, 1e-30), deth)
            ideth = 1.0 / deth
            k0s, k1s = [], []
            for j in range(6):
                b0j = Qux[0, j] * f0
                b1j = Qux[1, j] * f1
                k0s.append(-(h11 * b0j - h01 * b1j) * ideth)
                k1s.append(-(-h01 * b0j + h00 * b1j) * ideth)
            K = torch.stack([torch.stack(k0s), torch.stack(k1s)])  # (2,6,L)
            # Vx = Qx + K^T (Quu d + Qu) + Qux^T d
            r0 = q00 * d[0] + q01 * d[1] + Qu[0]
            r1 = q01 * d[0] + q11 * d[1] + Qu[1]
            Vx = torch.stack([Qx[j] + K[0, j] * r0 + K[1, j] * r1
                              + Qux[0, j] * d[0] + Qux[1, j] * d[1]
                              for j in range(6)])
            # Vxx = Qxx + K^T Quu K + K^T Qux + (K^T Qux)^T, symmetric by
            # construction from its 21 unique entries.
            kq = [(K[0, j] * q00 + K[1, j] * q01,
                   K[0, j] * q01 + K[1, j] * q11) for j in range(6)]
            rows = [[None] * 6 for _ in range(6)]
            for i in range(6):
                for j in range(i, 6):
                    s_ij = Qxx[i, j] + kq[i][0] * K[0, j] \
                        + kq[i][1] * K[1, j]
                    m_ij = K[0, i] * Qux[0, j] + K[1, i] * Qux[1, j]
                    m_ji = K[0, j] * Qux[0, i] + K[1, j] * Qux[1, i]
                    v_ij = s_ij + m_ij + m_ji
                    rows[i][j] = v_ij
                    if i != j:
                        rows[j][i] = v_ij
            Vxx = torch.stack([torch.stack(r) for r in rows])
            Ds.append(d)
            Ks.append(K)
            gns.append(gn_k)
        Ds = Ds[::-1]
        Ks = Ks[::-1]
        gnorm = gns[0]
        for gn_k in gns[1:]:
            gnorm = torch.maximum(gnorm, gn_k)

        # ---- forward line search with per-lane acceptance ----
        accepted = done                     # done lanes never move
        Z_best, V_best, c_best = Z, V, cost
        for al in alphas:
            if stats is not None:
                stats["trials"] = stats["trials"] + (~accepted).long()
            x = z0
            zs_new = [z0]
            vs_new = []
            c_new = torch.zeros_like(rw)
            for k in range(N):
                v = V[k] + al * Ds[k] + _mv(Ks[k], x - Z[k])
                v = torch.clamp(v, u_lo, u_hi)
                c_new = c_new + stage_cost(x, v)
                x = step_dyn(x, v)
                zs_new.append(x)
                vs_new.append(v)
            e = x - target
            c_new = c_new + torch.sum(wdiag * e * e, dim=0)
            newly = (~accepted) & (c_new < cost - 1e-12)
            Z_best = torch.where(newly, torch.stack(zs_new), Z_best)
            V_best = torch.where(newly, torch.stack(vs_new), V_best)
            c_best = torch.where(newly, c_new, c_best)
            accepted = accepted | newly

        rel = (cost - c_best) / (torch.abs(cost) + 1.0)
        done_n = done | (accepted & (rel < 1e-9)) | (~accepted)
        return Z_best, V_best, c_best, done_n, gnorm

    done = torch.zeros_like(rw, dtype=torch.bool)
    gnorm = torch.zeros_like(rw)
    if stats is not None:
        stats["trials"] = torch.zeros_like(rw, dtype=torch.long)
    for _ in range(n_iters):
        Z, V, cost, done, gnorm = iteration(Z, V, cost, done)
    return V, cost, gnorm


def flops_per_solve(N: int = 15, n_iters: int = 2, n_alphas: int = 3) -> int:
    """Analytic FLOP count of ONE whole-solve lane (one PMPC solve).

    Counts the algebra of the structure-specialised solve as useful work and
    transcendentals (sin/cos) as 1 FLOP, a deliberate undercount. Per-lane
    ledger:

      rollout stage    ~50 = step_dyn ~22 (sparse Ad/Sd) + stage cost ~28
      backward stage ~1190 = B cols 16, lx/lu 16, Qx 13, Qu 18,
                        Vxx@Ad 42, Qxx 48, Qux 96, Quu 108,
                        boxqp2 enumeration ~355, gains ~80, gnorm 2,
                        Vx update ~64, symmetric Vxx update ~330
      forward/alpha    ~75/stage = control law+clip 26, stage cost 28,
                        dynamics 22; +~80/alpha acceptance masking
    """
    rollout = 50 * N + 23
    backward = 1190 * N
    forward = n_alphas * (75 * N + 80)
    return rollout + n_iters * (backward + forward + 10)


# The structural non-zeros of Ad = blkdiag([[1, a], [0, b]] x2, diag(1, g5))
# (its ones multiply nothing) and of B = Sd dc/du (column 0 on rows 0, 1, 4,
# 5, column 1 on rows 2, 3, 4, 5).
_AD_NZ = _mask((6, 6), ((0, 0), (0, 1), (1, 1), (2, 2), (2, 3), (3, 3),
                        (4, 4), (5, 5)))
_AD_ONE = _mask((6, 6), ((0, 0), (2, 2), (4, 4)))
_B_NZ = _mask((6, 2), ((0, 0), (1, 0), (4, 0), (5, 0), (2, 1), (3, 1),
                       (4, 1), (5, 1)))


def _backward_counts(N: int, w_nz) -> int:
    """FLOPs of one backward pass of `_solve_lanes` over the structural
    non-zeros of Ad, B and the value function, whose Hessian starts as
    diag(wdiag != 0) (`w_nz`, six bools) and follows the recursion. Each
    value is computed once: the symmetric results (Qxx, Quu, the new Vxx)
    count their upper triangle."""
    AdT, oneT, BT = _AD_NZ.T, _AD_ONE.T, _B_NZ.T
    up = torch.triu(torch.ones(6, 6, dtype=torch.bool))
    up2 = torch.triu(torch.ones(2, 2, dtype=torch.bool))
    col = torch.ones(2, 1, dtype=torch.bool)
    lx = torch.tensor([bool(w) for w in w_nz])[:, None]
    Vx, Vxx = lx, torch.diag(lx[:, 0])
    # Quu[i][j] = b_i'(Vxx b_j) on the upper triangle reads Vxx b_j on the
    # rows of b_0 .. b_j.
    need = _B_NZ.cumsum(1) > 0
    total = 0
    for _ in range(N):
        n = 2 + 2 + 8 + 6 + 6 + 3                 # gc, m2g, p/q, e, lx, lu
        AVx, c = _mmc(AdT, Vx, unit=oneT)
        Qx, c2 = _addc(lx, AVx)
        n += c + c2
        n += _mmc(BT, Vx)[1] + 2                  # Qu = lu + B'Vx
        W, c = _mmc(AdT, Vxx, unit=oneT)          # (Vxx Ad)' = Ad'Vxx
        W = W.T
        n += c
        Qxx, c = _mmc(AdT, W, unit=oneT, out=up)
        Qxx, c2 = _addc(Qxx, torch.diag(lx[:, 0]))   # + diag(2 wdiag)
        n += c + c2
        Qux, c = _mmc(BT, W)
        n += c
        t, c = _mmc(Vxx, _B_NZ, out=need)
        n += c + _mmc(BT, t, out=up2)[1] + 2 + 2   # + rdiag on the diagonal
        # The box QP's nine candidates (~150); the gains: h00, h01, h11,
        # det, 1/det (12), per column of K b0, b1 and the two solves (10).
        kc = Qux.any(0)
        n += 150 + 12 + 10 * int(kc.sum())
        KT = kc[:, None].expand(6, 2)
        # Vx = Qx + K'(Quu d + Qu) + Qux'd, with r = Quu d + Qu (8).
        Kr, c = _mmc(KT, col)
        Qd, c2 = _mmc(Qux.T, col)
        Vx, c3 = _addc(Qx, Kr, Qd)
        n += 8 + c + c2 + c3
        # Vxx' = Qxx + (K'Quu) K + K'Qux + (K'Qux)' on the upper triangle.
        kq, c = _mmc(KT, torch.ones(2, 2, dtype=torch.bool))
        S, c2 = _mmc(kq, KT.T, out=up)
        M, c3 = _mmc(KT, Qux)
        n += c + c2 + c3 + _nnz(M & up.T)        # K'Qux on both triangles
        U, c = _addc(Qxx & up, S & up, M & up, M.T & up)
        n += c
        Vxx = U | U.T
        total += n
    return total


# FLOPs of one rollout stage (the dynamics specialised to the sparsity,
# ~22, and the stage cost, ~28), of one trial stage (the control law and
# clip, ~26, the stage cost and the dynamics) and of one trial's
# acceptance masking (~80), as `flops_per_solve` counts them.
_ROLLOUT, _TRIAL, _ACCEPT = 50, 75, 80


def work(N: int, n_iters: int, B: int, trials: int, itemsize: int,
         w_nz) -> tuple[int, int]:
    """(FLOPs, bytes) of one call over B lanes that ran `trials`
    line-search trials in all (`stats["trials"].sum()` of the plain
    version), for the roofline bound. FLOPs: the rollout and the trials as
    `flops_per_solve` counts them (the trials as run), and each backward
    pass over its structural non-zeros (`_backward_counts`; `w_nz` the
    six bools wdiag != 0 of the call's lanes); the structure guard's 72
    compares are not counted. Bytes: every input read once (the dense
    Ad and Sd, which the kernel's structure guard reads whole, wdiag, rw,
    target, z0, V0), every output written once (V, cost, gnorm)."""
    back = _backward_counts(N, w_nz)
    flops = B * (_ROLLOUT * N + 23 + n_iters * (back + 10)) \
        + trials * (_TRIAL * N + _ACCEPT)
    values = B * (36 + 36 + 6 + 1 + 6 + 6 + 2 * N) + B * (2 * N + 2)
    return flops, values * itemsize


def structure_residual(Ad: torch.Tensor, Sd: torch.Tensor,
                       dt: float) -> torch.Tensor:
    """Per-lane max abs deviation of dense (6,6,L) Ad/Sd from the sparsity
    the solve assumes. Exactly 0 for operators from
    `pmpc_fast._affine_discretization`; any other nonzero entry, or x/y
    block asymmetry, shows here instead of being dropped by the
    7-free-entry read."""
    a, b, g5 = Ad[0, 1], Ad[1, 1], Ad[5, 5]
    s01, s11, s44, s55 = Sd[0, 1], Sd[1, 1], Sd[4, 4], Sd[5, 5]
    o = torch.ones_like(a)
    EAd = torch.zeros_like(Ad)
    for (i, j), v in (((0, 0), o), ((2, 2), o), ((4, 4), o), ((0, 1), a),
                      ((2, 3), a), ((1, 1), b), ((3, 3), b), ((5, 5), g5)):
        EAd[i, j] = v
    ESd = torch.zeros_like(Sd)
    for (i, j), v in (((0, 0), dt * o), ((2, 2), dt * o), ((0, 1), s01),
                      ((2, 3), s01), ((1, 1), s11), ((3, 3), s11),
                      ((4, 4), s44), ((5, 5), s55)):
        ESd[i, j] = v
    return torch.maximum(torch.amax(torch.abs(Ad - EAd), dim=(0, 1)),
                         torch.amax(torch.abs(Sd - ESd), dim=(0, 1)))


def _free_entries(Ad, Sd):
    ad3 = torch.stack([Ad[0, 1], Ad[1, 1], Ad[5, 5]])
    sd4 = torch.stack([Sd[0, 1], Sd[1, 1], Sd[4, 4], Sd[5, 5]])
    return ad3, sd4


def _check(Ad, Sd, wdiag, rw, target, z0, V0):
    tensors = {"Ad": Ad, "Sd": Sd, "wdiag": wdiag, "rw": rw,
               "target": target, "z0": z0, "V0": V0}
    if V0.dim() != 3 or V0.shape[1] != 2:
        raise ValueError(f"V0 must be (N, 2, B), got {tuple(V0.shape)}")
    N, _, B = V0.shape
    want = {"Ad": (6, 6, B), "Sd": (6, 6, B), "wdiag": (6, B), "rw": (B,),
            "target": (6, B), "z0": (6, B), "V0": (N, 2, B)}
    dtype, device = V0.dtype, V0.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pmpc_solve takes float32 or float64, got {dtype}")
    for name, t in tensors.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, V0 is {dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, V0 on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bad_structure_to_inf(bad, cost, gnorm):
    inf = torch.full_like(cost, float("inf"))
    return torch.where(bad, inf, cost), torch.where(bad, inf, gnorm)


def pmpc_solve_reference(Ad, Sd, wdiag, rw, target, z0, V0, dt: float,
                         u_bound: float = 0.6, g: float = -9.81,
                         n_iters: int = 3, n_alphas: int = 4, stats=None):
    """Plain PyTorch version of `pmpc_solve`, on any device.
    Returns (V (N,2,B), cost (B,), gnorm (B,)); `stats` as in
    `_solve_lanes`."""
    _check(Ad, Sd, wdiag, rw, target, z0, V0)
    ad3, sd4 = _free_entries(Ad, Sd)
    B = V0.shape[-1]
    lo = torch.full((2, B), -u_bound, dtype=V0.dtype, device=V0.device)
    hi = torch.full((2, B), u_bound, dtype=V0.dtype, device=V0.device)
    V, cost, gnorm = _solve_lanes(ad3, sd4, wdiag, rw, target, z0, V0, lo,
                                  hi, dt, float(g), n_iters, n_alphas,
                                  stats)
    bad = structure_residual(Ad, Sd, dt) > 1e-6
    cost, gnorm = _bad_structure_to_inf(bad, cost, gnorm)
    return V, cost, gnorm


def pmpc_solve(Ad, Sd, wdiag, rw, target, z0, V0, dt: float,
               u_bound: float = 0.6, g: float = -9.81, n_iters: int = 3,
               n_alphas: int = 4):
    """Whole PMPC solve, batch-last. Returns (V (N,2,B), cost (B,),
    gnorm (B,)), gnorm being the max |feedforward| of the last iteration.

    CPU tensors run the plain version. CUDA tensors launch the kernel,
    which also sets a lane's cost and gnorm to +inf where Ad/Sd break the
    structure the solve assumes, and add one to `pmpc_solve.launches`; a
    horizon the kernel has no instance for (`csrc/pmpc_solve.cu`,
    `launch`), a budget outside 1 <= n_iters, 1 <= n_alphas <= 16, or a
    failed launch raises.
    """
    if V0.device.type == "cpu":
        return pmpc_solve_reference(Ad, Sd, wdiag, rw, target, z0, V0, dt,
                                    u_bound, g, n_iters, n_alphas)
    _check(Ad, Sd, wdiag, rw, target, z0, V0)
    if V0.device.type != "cuda":
        raise ValueError(f"pmpc_solve runs on cpu or cuda, not {V0.device}")
    N, _, B = V0.shape
    V = torch.empty_like(V0)
    cost = torch.empty_like(rw)
    gnorm = torch.empty_like(rw)
    lib = _build.library()
    fn = lib.pmpc_solve_f32 if V0.dtype == torch.float32 else \
        lib.pmpc_solve_f64
    stream = torch.cuda.current_stream(V0.device).cuda_stream
    with torch.cuda.device(V0.device):
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in
                   (Ad, Sd, wdiag, rw, target, z0, V0, V, cost, gnorm)),
                 B, N, n_iters, n_alphas, float(dt), float(u_bound),
                 float(g), ctypes.c_void_p(stream))
    if err == _build.BAD_SHAPE:
        raise NotImplementedError(
            f"the CUDA kernel has no instance for N={N}: add one to "
            "launch() in csrc/pmpc_solve.cu")
    if err == _build.BAD_BUDGET:
        raise ValueError(f"budget n_iters={n_iters}, n_alphas={n_alphas} "
                         "outside 1 <= n_iters, 1 <= n_alphas <= 16")
    if err != 0:
        raise RuntimeError(f"pmpc_solve kernel launch failed: "
                           f"{_build.error_string(err)} (code {err})")
    pmpc_solve.launches += 1
    return V, cost, gnorm


pmpc_solve.launches = 0


def launch_geometry(N: int, dtype: torch.dtype) -> dict:
    """Launch geometry of the CUDA instance for horizon N and `dtype`
    (`_build.launch_geometry`). Needs the built library and a card."""
    return _build.launch_geometry("pmpc_solve", N,
                                  torch.empty((), dtype=dtype).element_size())
