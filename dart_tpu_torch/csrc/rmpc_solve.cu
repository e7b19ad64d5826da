// Whole slew-exact RMPC solve, augmented-Lagrangian outer loop included,
// one thread per scenario lane, for Hopper (sm_90a).
//
// Replaces the TPU kernel dart_tpu/ops/pallas/rmpc_solve.py::_rmpc_kernel
// (rmpc_solve_pallas) and computes what it computes, step for step: the
// RK4 model x' = g sin(u) + phi(x) . theta over [px, vx, py, vy], its
// closed-form RK4 Jacobian by the chain rule, the applied tilt
// u = clip(u_prev + v, +-u_bound) with its pass-through mask, the Riccati
// backward pass partitioned over z = [x(4), u_prev(2)] into P (4x4),
// q (4x2), r (2x2), an exact 2x2 box QP over the slew v per stage, PHR
// velocity caps with per-lane multipliers, and an alpha = 0.6^i line search
// with per-lane accept and done masks. Its semantics are the TPU kernel's,
// not ilqr.solve_batch's: the done mask and the cost restart at each AL
// round, a lane that accepts no alpha is done, gnorm is the max |d| of the
// last backward pass (taken before its line search), the multipliers
// update on the round's final trajectory, and gravity is the constant
// -9.81. The plain PyTorch version is
// dart_tpu_torch/ops/kernels/rmpc_solve.py::_solve_lanes.
//
// Layout: every array is batch-last, element (i, lane) at i * B + lane, so
// neighbouring threads touch neighbouring addresses and loads coalesce.
//
// What bounds it on this card, and what the design does about it:
// - It is compute-bound: ~1.2 MFLOP and ~10k tanh/sin/cos per lane at the
//   production budget (N = 20, 6 iterations x 4 alphas x 3 AL rounds)
//   against ~0.5 KB of inputs and outputs. Each thread runs one long chain
//   of dependent FP operations, so latency, not the FP rate, is the limit
//   until enough lanes are in flight.
// - The batch is small against the card: B = 4096 lanes are 4096 threads.
//   Blocks of 32 threads give 128 blocks, one warp on all but four of the
//   132 SMs (PMPC's 128-thread blocks left 100 SMs idle at this B).
// - Per-lane state is far beyond the register file: X, U, V, lam, D, K1,
//   K2, the line search's trial X/U/V and the reference come to ~780
//   values at N = 20, against 255 registers per thread. The horizon arrays
//   live in local memory (cached in L1/L2); only one stage's 4x4 algebra
//   stays in registers. A later PR could keep the horizon in shared memory
//   with several threads per lane, or fuse the rollout into the backward
//   pass to shrink the trial arrays.
// - The escalation front end (control/mpc.py) reads max(viol) and
//   max(gnorm) on the host after each round, so every control step syncs.
//
// Two shortcuts that change no result: a lane that accepts an alpha skips
// the remaining trials (the TPU kernel computes and discards them), and a
// done lane skips the line search (its trials are never accepted).
//
// Numerics: precise tanh/sin/cos and IEEE division (no --use_fast_math).
// Constants the TPU kernel folds in python double (dt/2, dt/6, 0.6^i) are
// folded on the host in double and rounded once. nvcc's default FMA
// contraction is left on, so float32 results differ from the plain version
// by a few ulps per operation; chip_smoke.py states the tolerance. Every
// max and clip propagates NaN, so a lane with NaN inputs reports a NaN viol
// or gnorm.

#include <cuda_runtime.h>

#include <cmath>

#include "lanes.cuh"

namespace {

using namespace dart;

constexpr int kThreads = 32;

template <typename T>
struct Consts {
  RK4Consts<T> rk;
  T v_eps, g;
  T u_b, du_b, vmax;
  T mu_init, mu_scale, mu_max, tol_con;
  T alpha[kMaxAlphas];   // 0.6^i
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
rmpc_solve_kernel(const T* __restrict__ th_in, const T* __restrict__ ref_in,
                  const T* __restrict__ w_in, const T* __restrict__ z0_in,
                  const T* __restrict__ V0, T* __restrict__ V_out,
                  T* __restrict__ cost_out, T* __restrict__ viol_out,
                  T* __restrict__ gnorm_out, int B, int n_iters, int n_alphas,
                  int al_rounds, const Consts<T> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t sB = static_cast<size_t>(B);
  auto at = [&](const T* p, int i) { return p[static_cast<size_t>(i) * sB + lane]; };

  T th[14];
#pragma unroll
  for (int i = 0; i < 14; ++i) th[i] = at(th_in, i);
  const T Qp = at(w_in, 0), Qv = at(w_in, 1), Ru = at(w_in, 2), Rdu = at(w_in, 3);
  const T w4[4] = {Qp, Qv, Qp, Qv};
  T x0[4], up0[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) x0[i] = at(z0_in, i);
  up0[0] = at(z0_in, 4);
  up0[1] = at(z0_in, 5);

  T ref[N + 1][4], X[N + 1][4], U[N + 1][2], V[N][2], lam[N][4];
  T D[N][2], K1[N][2][4], K2[N][2][2], Xt[N + 1][4], Ut[N + 1][2], Vt[N][2];
#pragma unroll 1
  for (int k = 0; k <= N; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) ref[k][i] = at(ref_in, 4 * k + i);
  }
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    V[k][0] = clip(at(V0, 2 * k), -c.du_b, c.du_b);
    V[k][1] = clip(at(V0, 2 * k + 1), -c.du_b, c.du_b);
  }

  // xdot of the model (f4) and its continuous-time Jacobians (jac4).
  auto f4 = [&](const T (&x)[4], const T (&u)[2], T (&xd)[4]) {
    const T tx = dtanh(x[1] / c.v_eps), ty = dtanh(x[3] / c.v_eps);
    const T ax = c.g * dsin(u[0]) + th[0] * x[0] + th[1] * x[1] + th[2] * x[2]
                 + th[3] * x[3] + th[4] * tx + th[5] * ty + th[6];
    const T ay = c.g * dsin(u[1]) + th[7] * x[0] + th[8] * x[1] + th[9] * x[2]
                 + th[10] * x[3] + th[11] * tx + th[12] * ty + th[13];
    xd[0] = x[1];
    xd[1] = ax;
    xd[2] = x[3];
    xd[3] = ay;
  };
  auto jac4 = [&](const T (&x)[4], const T (&u)[2], T (&A)[4][4], T (&Bj)[4][2]) {
    const T tx = dtanh(x[1] / c.v_eps), ty = dtanh(x[3] / c.v_eps);
    const T dtx = (T(1) - tx * tx) / c.v_eps;
    const T dty = (T(1) - ty * ty) / c.v_eps;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) A[i][j] = T(0);
    A[0][1] = T(1);
    A[1][0] = th[0];
    A[1][1] = th[1] + th[4] * dtx;
    A[1][2] = th[2];
    A[1][3] = th[3] + th[5] * dty;
    A[2][3] = T(1);
    A[3][0] = th[7];
    A[3][1] = th[8] + th[11] * dtx;
    A[3][2] = th[9];
    A[3][3] = th[10] + th[12] * dty;
#pragma unroll
    for (int i = 0; i < 4; ++i) Bj[i][0] = Bj[i][1] = T(0);
    Bj[1][0] = c.g * dcos(u[0]);
    Bj[3][1] = c.g * dcos(u[1]);
  };
  auto rk4 = [&](const T (&x)[4], const T (&u)[2], T (&xn)[4]) {
    T k1[4], k2[4], k3[4], k4[4], xt[4];
    f4(x, u, k1);
#pragma unroll
    for (int i = 0; i < 4; ++i) xt[i] = x[i] + c.rk.half_dt * k1[i];
    f4(xt, u, k2);
#pragma unroll
    for (int i = 0; i < 4; ++i) xt[i] = x[i] + c.rk.half_dt * k2[i];
    f4(xt, u, k3);
#pragma unroll
    for (int i = 0; i < 4; ++i) xt[i] = x[i] + c.rk.dt * k3[i];
    f4(xt, u, k4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xn[i] = x[i] + c.rk.dt6 * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + k4[i]);
  };
  // Velocity caps c(x) <= 0.
  auto con4 = [&](const T (&x)[4], T (&C)[4]) {
    C[0] = x[1] - c.vmax;
    C[1] = -x[1] - c.vmax;
    C[2] = x[3] - c.vmax;
    C[3] = -x[3] - c.vmax;
  };
  auto track = [&](const T (&x)[4], int k) {
    T s = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T e = x[i] - ref[k][i];
      s = (i == 0) ? w4[0] * e * e : s + w4[i] * e * e;
    }
    return s;
  };
  // AL-penalised stage cost (make_rmpc_ocp_du.stage_cost + PHR).
  auto stage_cost_al = [&](const T (&x)[4], const T (&up)[2], const T (&v)[2],
                           int k, T mu) {
    const T u0 = clip(up[0] + v[0], -c.u_b, c.u_b);
    const T u1 = clip(up[1] + v[1], -c.u_b, c.u_b);
    const T cs = track(x, k) + Ru * (u0 * u0 + u1 * u1) + Rdu * (v[0] * v[0] + v[1] * v[1]);
    T C[4];
    con4(x, C);
    T pen = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T t = nan_max(T(0), lam[k][i] + mu * C[i]);
      const T term = t * t - lam[k][i] * lam[k][i];
      pen = (i == 0) ? term : pen + term;
    }
    return cs + pen / (T(2) * mu);
  };

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    X[0][i] = x0[i];
    Xt[0][i] = x0[i];
  }
  U[0][0] = Ut[0][0] = up0[0];
  U[0][1] = Ut[0][1] = up0[1];
#pragma unroll 1
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) lam[k][i] = T(0);
  T mu = c.mu_init, viol = T(0), gnorm = T(0);

#pragma unroll 1
  for (int round = 0; round < al_rounds; ++round) {
    // Rollout and AL cost of the round's starting V.
    T cost = T(0);
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      cost = cost + stage_cost_al(X[k], U[k], V[k], k, mu);
      T u[2] = {clip(U[k][0] + V[k][0], -c.u_b, c.u_b),
                clip(U[k][1] + V[k][1], -c.u_b, c.u_b)};
      rk4(X[k], u, X[k + 1]);
      U[k + 1][0] = u[0];
      U[k + 1][1] = u[1];
    }
    cost = cost + track(X[N], N);
    bool done = false;

#pragma unroll 1
    for (int it = 0; it < n_iters; ++it) {
      // ---- backward: partitioned Riccati over z = [x(4), u_prev(2)] ----
      T vx4[4], vu2[2] = {T(0), T(0)}, P[4][4], q[4][2], r[2][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        vx4[i] = T(2) * w4[i] * (X[N][i] - ref[N][i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) P[i][j] = (i == j) ? T(2) * w4[i] : T(0);
        q[i][0] = q[i][1] = T(0);
      }
      r[0][0] = r[0][1] = r[1][0] = r[1][1] = T(0);
      T gn = T(0);
#pragma unroll 1
      for (int k = N - 1; k >= 0; --k) {
        T x[4], u[2], m[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = X[k][i];
        const T v0 = V[k][0], v1 = V[k][1];
        const T s0 = U[k][0] + v0, s1 = U[k][1] + v1;
        m[0] = (dabs(s0) < c.u_b) ? T(1) : T(0);
        m[1] = (dabs(s1) < c.u_b) ? T(1) : T(0);
        u[0] = clip(s0, -c.u_b, c.u_b);
        u[1] = clip(s1, -c.u_b, c.u_b);
        T Ad[4][4], Bd[4][2], Bm[4][2];
        rk4_jac<T, 4, 2>(f4, jac4, x, u, c.rk, Ad, Bd);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          Bm[i][0] = Bd[i][0] * m[0];
          Bm[i][1] = Bd[i][1] * m[1];
        }

        // Stage cost quadratics (make_rmpc_ocp_du.cost_quad) and PHR rows.
        const T gu[2] = {T(2) * Ru * u[0] * m[0], T(2) * Ru * u[1] * m[1]};
        const T hu[2] = {T(2) * Ru * m[0], T(2) * Ru * m[1]};
        T e4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e4[i] = T(2) * w4[i] * (x[i] - ref[k][i]);
        const T lv[2] = {T(2) * Rdu * v0 + gu[0], T(2) * Rdu * v1 + gu[1]};
        T C[4], t[4], act[4];
        con4(x, C);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          t[i] = nan_max(T(0), lam[k][i] + mu * C[i]);
          act[i] = (t[i] > T(0)) ? T(1) : T(0);
        }
        const T lx4[4] = {e4[0], e4[1] + t[0] - t[1], e4[2], e4[3] + t[2] - t[3]};
        const T dal[4] = {T(0), mu * (act[0] + act[1]), T(0), mu * (act[2] + act[3])};

        T core[2], Qx4[4], Qu2[2], Qvl[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          T acc = Bm[0][j] * vx4[0];
#pragma unroll
          for (int tt = 1; tt < 4; ++tt) acc = acc + Bm[tt][j] * vx4[tt];
          core[j] = acc + m[j] * vu2[j];
          Qu2[j] = gu[j] + core[j];
          Qvl[j] = lv[j] + core[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          T acc = Ad[0][i] * vx4[0];
#pragma unroll
          for (int tt = 1; tt < 4; ++tt) acc = acc + Ad[tt][i] * vx4[tt];
          Qx4[i] = lx4[i] + acc;
        }

        // W = P Bm + q*m; S2 = Bm^T q + r*m (rows); T2 = (Ad^T P) Ad.
        T W[4][2], S2[2][2], AdT[4][4], T1[4][4], T2[4][4];
        mm(P, Bm, W);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          W[i][0] = W[i][0] + q[i][0] * m[0];
          W[i][1] = W[i][1] + q[i][1] * m[1];
#pragma unroll
          for (int j = 0; j < 4; ++j) AdT[i][j] = Ad[j][i];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            T acc = Bm[0][a] * q[0][b];
#pragma unroll
            for (int tt = 1; tt < 4; ++tt) acc = acc + Bm[tt][a] * q[tt][b];
            S2[a][b] = acc + r[a][b] * m[a];
          }
        }
        mm(AdT, P, T1);
        mm(T1, Ad, T2);
        T Qxx11[4][4], Qxx12[4][2], G[2][2], Qvz1[2][4], Qvz2[2][2], Qvv[2][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Qxx11[i][j] = (i == j) ? T2[i][j] + (T(2) * w4[i] + dal[i]) : T2[i][j];
        mm(AdT, W, Qxx12);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            T acc = W[0][a] * Bm[0][b];
#pragma unroll
            for (int tt = 1; tt < 4; ++tt) acc = acc + W[tt][a] * Bm[tt][b];
            G[a][b] = acc + S2[a][b] * m[b];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            T acc = W[0][a] * Ad[0][j];
#pragma unroll
            for (int tt = 1; tt < 4; ++tt) acc = acc + W[tt][a] * Ad[tt][j];
            Qvz1[a][j] = acc;
          }
        }
        T Gv[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            Qvz2[a][b] = (a == b) ? G[a][b] + hu[a] : G[a][b];
            Gv[a][b] = (a == b) ? G[a][b] + (T(2) * Rdu + hu[a] + T(1e-8)) : G[a][b];
          }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) Qvv[a][b] = T(0.5) * (Gv[a][b] + Gv[b][a]);

        T d0, d1, f0, f1;
        boxqp2(Qvv[0][0], Qvv[0][1], Qvv[1][1], Qvl[0], Qvl[1], -c.du_b - v0,
               -c.du_b - v1, c.du_b - v0, c.du_b - v1, d0, d1, f0, f1);
        const T gn_k = nan_max(dabs(d0), dabs(d1));
        gn = (k == N - 1) ? gn_k : nan_max(gn, gn_k);
        const T b0[6] = {Qvz1[0][0], Qvz1[0][1], Qvz1[0][2], Qvz1[0][3],
                         Qvz2[0][0], Qvz2[0][1]};
        const T b1[6] = {Qvz1[1][0], Qvz1[1][1], Qvz1[1][2], Qvz1[1][3],
                         Qvz2[1][0], Qvz2[1][1]};
        T g0[6], g1[6];
        gains2<T, 6>(Qvv[0][0], Qvv[0][1], Qvv[1][1], f0, f1, b0, b1, g0, g1);
        T k1m[2][4], k2m[2][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          k1m[0][j] = g0[j];
          k1m[1][j] = g1[j];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          k2m[0][j] = g0[4 + j];
          k2m[1][j] = g1[4 + j];
        }
        D[k][0] = d0;
        D[k][1] = d1;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int j = 0; j < 4; ++j) K1[k][a][j] = k1m[a][j];
          K2[k][a][0] = k2m[a][0];
          K2[k][a][1] = k2m[a][1];
        }

        // Value update.
        const T w2[2] = {Qvv[0][0] * d0 + Qvv[0][1] * d1 + Qvl[0],
                         Qvv[1][0] * d0 + Qvv[1][1] * d1 + Qvl[1]};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          vx4[i] = Qx4[i] + (k1m[0][i] * w2[0] + k1m[1][i] * w2[1])
                   + (Qvz1[0][i] * d0 + Qvz1[1][i] * d1);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          vu2[j] = Qu2[j] + (k2m[0][j] * w2[0] + k2m[1][j] * w2[1])
                   + (Qvz2[0][j] * d0 + Qvz2[1][j] * d1);
        T K1Q[4][2], M1[4][4], Pn[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int b = 0; b < 2; ++b)
            K1Q[i][b] = k1m[0][i] * Qvv[0][b] + k1m[1][i] * Qvv[1][b];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            M1[i][j] = k1m[0][i] * Qvz1[0][j] + k1m[1][i] * Qvz1[1][j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Pn[i][j] = Qxx11[i][j] + (K1Q[i][0] * k1m[0][j] + K1Q[i][1] * k1m[1][j])
                       + M1[i][j] + M1[j][i];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) P[i][j] = T(0.5) * (Pn[i][j] + Pn[j][i]);
#pragma unroll
          for (int b = 0; b < 2; ++b)
            q[i][b] = Qxx12[i][b] + (K1Q[i][0] * k2m[0][b] + K1Q[i][1] * k2m[1][b])
                      + (k1m[0][i] * Qvz2[0][b] + k1m[1][i] * Qvz2[1][b])
                      + (Qvz1[0][i] * k2m[0][b] + Qvz1[1][i] * k2m[1][b]);
        }
        T K2Q[2][2], M2[2][2], rn[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            K2Q[a][b] = k2m[0][a] * Qvv[0][b] + k2m[1][a] * Qvv[1][b];
            M2[a][b] = k2m[0][a] * Qvz2[0][b] + k2m[1][a] * Qvz2[1][b];
          }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            rn[a][b] = Qvz2[a][b] + (K2Q[a][0] * k2m[0][b] + K2Q[a][1] * k2m[1][b])
                       + M2[a][b] + M2[b][a];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) r[a][b] = T(0.5) * (rn[a][b] + rn[b][a]);
      }
      gnorm = gn;

      // ---- forward line search with per-lane acceptance ----
      bool accepted = done;   // done lanes never move
      T c_best = cost;
#pragma unroll 1
      for (int ia = 0; ia < n_alphas && !accepted; ++ia) {
        const T al = c.alpha[ia];
        T c_new = T(0);
#pragma unroll 1
        for (int k = 0; k < N; ++k) {
          T v[2], u[2];
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            T mv1 = K1[k][a][0] * (Xt[k][0] - X[k][0]);
#pragma unroll
            for (int tt = 1; tt < 4; ++tt) mv1 = mv1 + K1[k][a][tt] * (Xt[k][tt] - X[k][tt]);
            const T mv2 = K2[k][a][0] * (Ut[k][0] - U[k][0])
                          + K2[k][a][1] * (Ut[k][1] - U[k][1]);
            v[a] = clip(V[k][a] + al * D[k][a] + mv1 + mv2, -c.du_b, c.du_b);
          }
          c_new = c_new + stage_cost_al(Xt[k], Ut[k], v, k, mu);
          u[0] = clip(Ut[k][0] + v[0], -c.u_b, c.u_b);
          u[1] = clip(Ut[k][1] + v[1], -c.u_b, c.u_b);
          rk4(Xt[k], u, Xt[k + 1]);
          Ut[k + 1][0] = u[0];
          Ut[k + 1][1] = u[1];
          Vt[k][0] = v[0];
          Vt[k][1] = v[1];
        }
        c_new = c_new + track(Xt[N], N);
        if (c_new < cost - T(1e-12)) {
          accepted = true;
          c_best = c_new;
#pragma unroll 1
          for (int k = 0; k < N; ++k) {
            V[k][0] = Vt[k][0];
            V[k][1] = Vt[k][1];
            U[k + 1][0] = Ut[k + 1][0];
            U[k + 1][1] = Ut[k + 1][1];
#pragma unroll
            for (int i = 0; i < 4; ++i) X[k + 1][i] = Xt[k + 1][i];
          }
        }
      }
      const T rel = (cost - c_best) / (dabs(cost) + T(1));
      done = done || (accepted && rel < T(1e-9)) || !accepted;
      cost = c_best;
    }

    // PHR multiplier update on the round's final trajectory.
    viol = T(0);
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      T C[4];
      con4(X[k], C);
      T cm = nan_max(C[0], T(0));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lam[k][i] = nan_max(T(0), lam[k][i] + mu * C[i]);
        if (i > 0) cm = nan_max(cm, nan_max(C[i], T(0)));
      }
      viol = nan_max(viol, cm);
    }
    mu = (viol > c.tol_con) ? nan_min(mu * c.mu_scale, c.mu_max) : mu;
  }

  // Raw (unpenalised) cost of the final iterate.
  T raw = T(0), x[4], up[2] = {up0[0], up0[1]};
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = x0[i];
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    T u[2] = {clip(up[0] + V[k][0], -c.u_b, c.u_b),
              clip(up[1] + V[k][1], -c.u_b, c.u_b)};
    raw = raw + (track(x, k) + Ru * (u[0] * u[0] + u[1] * u[1])
                 + Rdu * (V[k][0] * V[k][0] + V[k][1] * V[k][1]));
    T xn[4];
    rk4(x, u, xn);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = xn[i];
    up[0] = u[0];
    up[1] = u[1];
  }
  raw = raw + track(x, N);

#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    V_out[static_cast<size_t>(2 * k) * sB + lane] = V[k][0];
    V_out[static_cast<size_t>(2 * k + 1) * sB + lane] = V[k][1];
  }
  cost_out[lane] = raw;
  viol_out[lane] = viol;
  gnorm_out[lane] = gnorm;
}

template <typename T>
int launch(const T* th, const T* ref, const T* w, const T* z0, const T* V0,
           T* V, T* cost, T* viol, T* gnorm, int B, int N, int n_iters,
           int n_alphas, int al_rounds, double dt, double u_bound,
           double du_bound, double vmax, double v_eps, double mu_init,
           double mu_scale, double mu_max, double tol_con, void* stream) {
  if (n_iters < 1 || al_rounds < 1 || n_alphas < 1 || n_alphas > kMaxAlphas)
    return kBadBudget;
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Consts<T> c;
  c.rk.half_dt = static_cast<T>(0.5 * dt);
  c.rk.dt = static_cast<T>(dt);
  c.rk.dt6 = static_cast<T>(dt / 6.0);
  c.v_eps = static_cast<T>(v_eps);
  c.g = static_cast<T>(-9.81);
  c.u_b = static_cast<T>(u_bound);
  c.du_b = static_cast<T>(du_bound);
  c.vmax = static_cast<T>(vmax);
  c.mu_init = static_cast<T>(mu_init);
  c.mu_scale = static_cast<T>(mu_scale);
  c.mu_max = static_cast<T>(mu_max);
  c.tol_con = static_cast<T>(tol_con);
  for (int i = 0; i < kMaxAlphas; ++i)
    c.alpha[i] = static_cast<T>(std::pow(0.6, i));
  const dim3 grid((B + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 6:
      rmpc_solve_kernel<T, 6><<<grid, kThreads, 0, s>>>(
          th, ref, w, z0, V0, V, cost, viol, gnorm, B, n_iters, n_alphas,
          al_rounds, c);
      break;
    case 20:
      rmpc_solve_kernel<T, 20><<<grid, kThreads, 0, s>>>(
          th, ref, w, z0, V0, V, cost, viol, gnorm, B, n_iters, n_alphas,
          al_rounds, c);
      break;
    default:
      return kBadShape;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rmpc_solve_f32(const float* th, const float* ref, const float* w,
                   const float* z0, const float* V0, float* V, float* cost,
                   float* viol, float* gnorm, int B, int N, int n_iters,
                   int n_alphas, int al_rounds, double dt, double u_bound,
                   double du_bound, double vmax, double v_eps, double mu_init,
                   double mu_scale, double mu_max, double tol_con,
                   void* stream) {
  return launch<float>(th, ref, w, z0, V0, V, cost, viol, gnorm, B, N,
                       n_iters, n_alphas, al_rounds, dt, u_bound, du_bound,
                       vmax, v_eps, mu_init, mu_scale, mu_max, tol_con,
                       stream);
}

int rmpc_solve_f64(const double* th, const double* ref, const double* w,
                   const double* z0, const double* V0, double* V,
                   double* cost, double* viol, double* gnorm, int B, int N,
                   int n_iters, int n_alphas, int al_rounds, double dt,
                   double u_bound, double du_bound, double vmax, double v_eps,
                   double mu_init, double mu_scale, double mu_max,
                   double tol_con, void* stream) {
  return launch<double>(th, ref, w, z0, V0, V, cost, viol, gnorm, B, N,
                        n_iters, n_alphas, al_rounds, dt, u_bound, du_bound,
                        vmax, v_eps, mu_init, mu_scale, mu_max, tol_con,
                        stream);
}

}  // extern "C"
