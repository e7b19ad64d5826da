// Whole LMPC box-DDP solve, one thread per scenario lane, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dart_tpu/ops/pallas/lmpc_solve.py::_lmpc_kernel
// (lmpc_solve_pallas) and computes what it computes, step for step: the
// 8-state, 34-parameter Stribeck / rolling / toppling model with its
// positivity-constrained entries squashed (|p| + 1e-6) once per lane, its
// closed-form RK4 Jacobian by the chain rule, the Riccati backward pass
// partitioned over z = [x(8), u_prev(2)] into P (8x8), q (8x2), r (2x2)
// with the constant block Qux2 = diag(-2 Rdu), an exact 2x2 box QP over the
// tilt per stage, and an alpha = 0.6^i line search with per-lane accept and
// done masks over a fixed number of iterations. Its semantics are the TPU
// kernel's, not ilqr.solve_batch's: the wrapper clips V0 to +-u_bound before
// the launch, the cost starts as the clipped V0's rollout cost, a trial is
// accepted on c_new < cost - 1e-12 against the iteration's starting cost, a
// lane that accepts no alpha is done, gnorm is the max |d| of the last
// backward pass (taken before its line search), the Quu jitter is
// 2 (Ru + Rdu) + 1e-8, and gravity is the constant +9.81 (RMPC's kernel
// uses -9.81). d|v|/dv is sign(v), 0 at v = 0, as in jnp.sign. The plain
// PyTorch version is dart_tpu_torch/ops/kernels/lmpc_solve.py::_solve_lanes.
//
// Layout: every array is batch-last, element (i, lane) at i * B + lane, so
// neighbouring threads touch neighbouring addresses and loads coalesce.
//
// What bounds it on this card, and what the design does about it:
// - It is compute-bound: ~0.25 MFLOP and ~5k exp/tanh/sin/cos per lane at
//   N = 12 and 2 iterations (ops/kernels/lmpc_solve.py::work), against
//   ~0.5 KB of float32 inputs and outputs. Each thread runs one long chain of
//   dependent FP operations, so latency, not the FP rate, is the limit
//   until enough lanes are in flight.
// - The batch is small against the card: B = 4096 lanes are 4096 threads.
//   Blocks of 32 threads give 128 blocks, one warp on all but four of the
//   132 SMs (the RMPC kernel measured 32 ahead of 128 at this B).
// - Per-lane state is far beyond the register file: X, V, D, K1, K2 and the
//   line search's trial X and V come to ~860 values at N = 20, and the RK4
//   Jacobian's 8x8 temporaries to ~400 more, against 255 registers per
//   thread. The horizon arrays live in local memory (cached in L1/L2); one
//   stage's algebra stays in registers as far as ptxas manages. A faster
//   version could split a lane's 8x8 products over several threads or
//   exploit the Jacobian's sparsity (the dense products are ~60% of the
//   FLOPs).
// - The escalation front end (control/mpc.py) reads max(gnorm) on the host
//   after each round, so every control step syncs.
//
// Two shortcuts that change no result: a lane that accepts an alpha skips
// the remaining trials (the TPU kernel computes and discards them), and a
// done lane skips the line search (its trials are never accepted).
//
// Numerics: precise exp/tanh/sin/cos and IEEE division (no
// --use_fast_math). Constants the TPU kernel folds in python double (dt/2,
// dt/6, 0.6^i) are folded on the host in double and rounded once. nvcc's
// default FMA contraction is left on, so float32 results differ from the
// plain version by a few ulps per operation; chip_smoke.py states the
// tolerance. Every max, clip and sign propagates NaN, so a lane with NaN
// inputs reports a NaN cost and gnorm and leaves the other lanes alone.

#include <cuda_runtime.h>

#include <cmath>

#include "lanes.cuh"

namespace {

using namespace dart;

constexpr int kThreads = 32;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }

// jnp.sign: -1, 0 or 1, NaN for NaN.
template <typename T>
__device__ __forceinline__ T nan_sign(T v) {
  return (v != v) ? v : T((v > T(0)) - (v < T(0)));
}

template <typename T>
struct Consts {
  RK4Consts<T> rk;
  T u_b;
  T alpha[kMaxAlphas];   // 0.6^i
};

// Stribeck friction term (F_s, F_c, B, v_s, eps), v_s and eps squashed.
template <typename T>
struct Fric {
  T f_s, f_c, b, v_s, eps;
};

// sign_smooth(v) (F_c + (F_s - F_c) e^{-|v|/v_s}) + B v.
template <typename T>
__device__ __forceinline__ T strib(T v, const Fric<T>& f) {
  const T stc = f.f_c + (f.f_s - f.f_c) * dexp(-dabs(v) / (f.v_s + T(1e-12)));
  return dtanh(v / f.eps) * stc + f.b * v;
}

// d/dv of strib, with d|v|/dv = sign(v).
template <typename T>
__device__ __forceinline__ T dstrib(T v, const Fric<T>& f) {
  const T vs = f.v_s + T(1e-12);
  const T ex = dexp(-dabs(v) / vs);
  const T stc = f.f_c + (f.f_s - f.f_c) * ex;
  const T t = dtanh(v / f.eps);
  return (T(1) - t * t) / f.eps * stc + t * (f.f_s - f.f_c) * ex * (-nan_sign(v) / vs) + f.b;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
lmpc_solve_kernel(const T* __restrict__ p_in, const T* __restrict__ Q_in,
                  const T* __restrict__ R_in, const T* __restrict__ Qt_in,
                  const T* __restrict__ t_in, const T* __restrict__ z0_in,
                  const T* __restrict__ V0, T* __restrict__ V_out,
                  T* __restrict__ cost_out, T* __restrict__ gnorm_out, int B,
                  int n_iters, int n_alphas, const Consts<T> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t sB = static_cast<size_t>(B);
  auto at = [&](const T* p, int i) { return p[static_cast<size_t>(i) * sB + lane]; };
  const T G = T(9.81);

  // ---- squash the positivity-constrained parameters once ----
  auto raw = [&](int i) { return at(p_in, i); };
  auto sq = [&](int i) { return dabs(at(p_in, i)) + T(1e-6); };
  const T m_x = sq(0), m_y = sq(1), c_x = sq(2), c_y = sq(3);
  const T k_x = sq(4), k_y = sq(5);
  const Fric<T> fx{raw(6), raw(7), raw(8), sq(9), sq(10)};
  const Fric<T> fy{raw(11), raw(12), raw(13), sq(14), sq(15)};
  const T r_x = sq(18), r_y = sq(19), c_rot_x = sq(20), c_rot_y = sq(21);
  const Fric<T> frx{raw(22), raw(23), raw(24), sq(25), sq(26)};
  const Fric<T> fry{raw(27), raw(28), raw(29), sq(30), sq(31)};
  const T h_com_x = sq(32), h_com_y = sq(33);
  const T ix = sq(16) + T(1e-12), iy = sq(17) + T(1e-12);

  T Q[8], Qt[8], tg[8], x0[8], up0[2], Ru[2], Rdu[2];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    Q[i] = at(Q_in, i);
    Qt[i] = at(Qt_in, i);
    tg[i] = at(t_in, i);
    x0[i] = at(z0_in, i);
  }
  up0[0] = at(z0_in, 8);
  up0[1] = at(z0_in, 9);
  Ru[0] = at(R_in, 0);
  Ru[1] = at(R_in, 1);
  Rdu[0] = at(R_in, 2);
  Rdu[1] = at(R_in, 3);

  T X[N + 1][8], V[N][2], D[N][2], K1[N][2][8], K2[N][2][2];
  T Xt[N + 1][8], Vt[N][2];
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    V[k][0] = at(V0, 2 * k);
    V[k][1] = at(V0, 2 * k + 1);
  }

  // xdot of the model (f8) and its continuous-time Jacobians (jac8).
  auto f8 = [&](const T (&x)[8], const T (&v)[2], T (&xd)[8]) {
    const T px = x[0], vx = x[1], py = x[2], vy = x[3];
    const T th_x = x[4], om_x = x[5], th_y = x[6], om_y = x[7];
    const T g_x = m_x * G * dsin(v[0]);
    const T g_y = m_y * G * dsin(v[1]);
    const T ff_x = strib(vx, fx), ff_y = strib(vy, fy);
    const T f_roll_x = strib(vx - r_x * om_y, fx);
    const T f_roll_y = strib(vy + r_y * om_x, fy);
    const T t_noslip_x = strib(om_x, frx), t_noslip_y = strib(om_y, fry);
    const T tau_x = -r_y * f_roll_y - t_noslip_x - c_rot_x * om_x
                    - m_y * G * h_com_x * dsin(th_x);
    const T tau_y = -r_x * f_roll_x - t_noslip_y - c_rot_y * om_y
                    - m_x * G * h_com_y * dsin(th_y);
    xd[0] = vx;
    xd[1] = (g_x - c_x * vx - k_x * px - ff_x - f_roll_x) / m_x;
    xd[2] = vy;
    xd[3] = (g_y - c_y * vy - k_y * py - ff_y - f_roll_y) / m_y;
    xd[4] = om_x;
    xd[5] = tau_x / ix;
    xd[6] = om_y;
    xd[7] = tau_y / iy;
  };
  auto jac8 = [&](const T (&x)[8], const T (&v)[2], T (&A)[8][8], T (&Bj)[8][2]) {
    const T vx = x[1], vy = x[3];
    const T th_x = x[4], om_x = x[5], th_y = x[6], om_y = x[7];
    const T Dff_x = dstrib(vx, fx), Dff_y = dstrib(vy, fy);
    const T Dfr_x = dstrib(vx - r_x * om_y, fx);
    const T Dfr_y = dstrib(vy + r_y * om_x, fy);
    const T Dtn_x = dstrib(om_x, frx), Dtn_y = dstrib(om_y, fry);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) A[i][j] = T(0);
      Bj[i][0] = Bj[i][1] = T(0);
    }
    A[0][1] = T(1);
    A[1][0] = -k_x / m_x;
    A[1][1] = (-c_x - Dff_x - Dfr_x) / m_x;
    A[1][7] = r_x * Dfr_x / m_x;
    A[2][3] = T(1);
    A[3][2] = -k_y / m_y;
    A[3][3] = (-c_y - Dff_y - Dfr_y) / m_y;
    A[3][5] = -r_y * Dfr_y / m_y;
    A[4][5] = T(1);
    A[5][3] = -r_y * Dfr_y / ix;
    A[5][4] = -m_y * G * h_com_x * dcos(th_x) / ix;
    A[5][5] = (-r_y * r_y * Dfr_y - Dtn_x - c_rot_x) / ix;
    A[6][7] = T(1);
    A[7][1] = -r_x * Dfr_x / iy;
    A[7][6] = -m_x * G * h_com_y * dcos(th_y) / iy;
    A[7][7] = (r_x * r_x * Dfr_x - Dtn_y - c_rot_y) / iy;
    Bj[1][0] = G * dcos(v[0]);
    Bj[3][1] = G * dcos(v[1]);
  };
  auto rk4 = [&](const T (&x)[8], const T (&v)[2], T (&xn)[8]) {
    T k1[8], k2[8], k3[8], k4[8], xt[8];
    f8(x, v, k1);
#pragma unroll
    for (int i = 0; i < 8; ++i) xt[i] = x[i] + c.rk.half_dt * k1[i];
    f8(xt, v, k2);
#pragma unroll
    for (int i = 0; i < 8; ++i) xt[i] = x[i] + c.rk.half_dt * k2[i];
    f8(xt, v, k3);
#pragma unroll
    for (int i = 0; i < 8; ++i) xt[i] = x[i] + c.rk.dt * k3[i];
    f8(xt, v, k4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xn[i] = x[i] + c.rk.dt6 * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + k4[i]);
  };
  // sum_i W[i] e_i^2, e = x - target, summed in the order i = 0..7.
  auto track = [&](const T (&x)[8], const T (&W)[8]) {
    T s = T(0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const T e = x[i] - tg[i];
      s = (i == 0) ? W[0] * e * e : s + W[i] * e * e;
    }
    return s;
  };
  auto stage_cost = [&](const T (&x)[8], T v0, T v1, T up_0, T up_1) {
    const T du0 = v0 - up_0, du1 = v1 - up_1;
    return track(x, Q) + Ru[0] * v0 * v0 + Ru[1] * v1 * v1
           + Rdu[0] * du0 * du0 + Rdu[1] * du1 * du1;
  };

  // Rollout and cost of the (clipped) warm start.
  T cost = T(0);
#pragma unroll
  for (int i = 0; i < 8; ++i) X[0][i] = Xt[0][i] = x0[i];
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const T up_0 = (k == 0) ? up0[0] : V[k - 1][0];
    const T up_1 = (k == 0) ? up0[1] : V[k - 1][1];
    cost = cost + stage_cost(X[k], V[k][0], V[k][1], up_0, up_1);
    rk4(X[k], V[k], X[k + 1]);
  }
  cost = cost + track(X[N], Qt);
  bool done = false;
  T gnorm = T(0);
  const T Qux2[2][2] = {{T(-2) * Rdu[0], T(0)}, {T(0), T(-2) * Rdu[1]}};

#pragma unroll 1
  for (int it = 0; it < n_iters; ++it) {
    // ---- backward: partitioned Riccati over z = [x(8), u_prev(2)] ----
    T vx8[8], vu2[2] = {T(0), T(0)}, P[8][8], q[8][2], r[2][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      vx8[i] = T(2) * Qt[i] * (X[N][i] - tg[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) P[i][j] = (i == j) ? T(2) * Qt[i] : T(0);
      q[i][0] = q[i][1] = T(0);
    }
    r[0][0] = r[0][1] = r[1][0] = r[1][1] = T(0);
    T gn = T(0);
#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      T x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = X[k][i];
      const T v0 = V[k][0], v1 = V[k][1];
      const T up_0 = (k == 0) ? up0[0] : V[k - 1][0];
      const T up_1 = (k == 0) ? up0[1] : V[k - 1][1];
      T Ad[8][8], Bd[8][2];
      rk4_jac<T, 8, 2>(f8, jac8, x, V[k], c.rk, Ad, Bd);

      // Stage cost quadratics (make_lmpc_ocp.cost_quad).
      const T du[2] = {v0 - up_0, v1 - up_1};
      const T vv[2] = {v0, v1};
      T Qx8[8], Qu[2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        T acc = Ad[0][i] * vx8[0];
#pragma unroll
        for (int t = 1; t < 8; ++t) acc = acc + Ad[t][i] * vx8[t];
        Qx8[i] = T(2) * Q[i] * (x[i] - tg[i]) + acc;
      }
      T Qx2[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        Qx2[j] = T(-2) * Rdu[j] * du[j];
        const T lv = T(2) * Ru[j] * vv[j] + T(2) * Rdu[j] * du[j];
        T acc = Bd[0][j] * vx8[0];
#pragma unroll
        for (int t = 1; t < 8; ++t) acc = acc + Bd[t][j] * vx8[t];
        Qu[j] = lv + acc + vu2[j];
      }

      // Qxx11 = Ad'P Ad + diag(2Q); T2 = Bd'P + q'; Qux1 = T2 Ad;
      // Quu = T2 Bd + Bd'q + r, symmetrised, plus the jitter.
      T AdT[8][8], T1[8][8], Qxx11[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) AdT[i][j] = Ad[j][i];
      mm(AdT, P, T1);
      mm(T1, Ad, Qxx11);
#pragma unroll
      for (int i = 0; i < 8; ++i) Qxx11[i][i] = Qxx11[i][i] + T(2) * Q[i];
      T T2[2][8], Qux1[2][8], Gm[2][2], Quu[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          T acc = Bd[0][a] * P[0][j];
#pragma unroll
          for (int t = 1; t < 8; ++t) acc = acc + Bd[t][a] * P[t][j];
          T2[a][j] = acc + q[j][a];
        }
      mm(T2, Ad, Qux1);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          T acc1 = T2[a][0] * Bd[0][b];
          T acc2 = Bd[0][a] * q[0][b];
#pragma unroll
          for (int t = 1; t < 8; ++t) {
            acc1 = acc1 + T2[a][t] * Bd[t][b];
            acc2 = acc2 + Bd[t][a] * q[t][b];
          }
          Gm[a][b] = acc1 + acc2 + r[a][b];
        }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const T s = T(0.5) * (Gm[a][b] + Gm[b][a]);
          Quu[a][b] = (a == b) ? s + (T(2) * (Ru[a] + Rdu[a]) + T(1e-8)) : s;
        }

      T d0, d1, f0, f1;
      boxqp2(Quu[0][0], Quu[0][1], Quu[1][1], Qu[0], Qu[1], -c.u_b - v0,
             -c.u_b - v1, c.u_b - v0, c.u_b - v1, d0, d1, f0, f1);
      const T gn_k = nan_max(dabs(d0), dabs(d1));
      gn = (k == N - 1) ? gn_k : nan_max(gn, gn_k);
      T b0[10], b1[10], g0[10], g1[10];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b0[j] = Qux1[0][j];
        b1[j] = Qux1[1][j];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b0[8 + j] = Qux2[0][j];
        b1[8 + j] = Qux2[1][j];
      }
      gains2<T, 10>(Quu[0][0], Quu[0][1], Quu[1][1], f0, f1, b0, b1, g0, g1);
      T k1m[2][8], k2m[2][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        k1m[0][j] = g0[j];
        k1m[1][j] = g1[j];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        k2m[0][j] = g0[8 + j];
        k2m[1][j] = g1[8 + j];
      }
      D[k][0] = d0;
      D[k][1] = d1;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int j = 0; j < 8; ++j) K1[k][a][j] = k1m[a][j];
        K2[k][a][0] = k2m[a][0];
        K2[k][a][1] = k2m[a][1];
      }

      // Value update.
      const T w2[2] = {Quu[0][0] * d0 + Quu[0][1] * d1 + Qu[0],
                       Quu[1][0] * d0 + Quu[1][1] * d1 + Qu[1]};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        vx8[i] = Qx8[i] + (k1m[0][i] * w2[0] + k1m[1][i] * w2[1])
                 + (Qux1[0][i] * d0 + Qux1[1][i] * d1);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        vu2[j] = Qx2[j] + (k2m[0][j] * w2[0] + k2m[1][j] * w2[1])
                 + (Qux2[0][j] * d0 + Qux2[1][j] * d1);
      T K1Q[8][2], M[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int b = 0; b < 2; ++b)
          K1Q[i][b] = k1m[0][i] * Quu[0][b] + k1m[1][i] * Quu[1][b];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          M[i][j] = k1m[0][i] * Qux1[0][j] + k1m[1][i] * Qux1[1][j];
      }
      // P' = Qxx11 + K1'Quu K1 + M + M', symmetrised (into T1, then P).
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          T1[i][j] = Qxx11[i][j] + (K1Q[i][0] * k1m[0][j] + K1Q[i][1] * k1m[1][j])
                     + M[i][j] + M[j][i];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) P[i][j] = T(0.5) * (T1[i][j] + T1[j][i]);
#pragma unroll
        for (int b = 0; b < 2; ++b)
          q[i][b] = (K1Q[i][0] * k2m[0][b] + K1Q[i][1] * k2m[1][b])
                    + (k1m[0][i] * Qux2[0][b] + k1m[1][i] * Qux2[1][b])
                    + (Qux1[0][i] * k2m[0][b] + Qux1[1][i] * k2m[1][b]);
      }
      T K2Q[2][2], M2[2][2], rn[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          K2Q[a][b] = k2m[0][a] * Quu[0][b] + k2m[1][a] * Quu[1][b];
          M2[a][b] = k2m[0][a] * Qux2[0][b] + k2m[1][a] * Qux2[1][b];
        }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          rn[a][b] = (K2Q[a][0] * k2m[0][b] + K2Q[a][1] * k2m[1][b])
                     + M2[a][b] + M2[b][a];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const T s = T(0.5) * (rn[a][b] + rn[b][a]);
          r[a][b] = (a == b) ? s + T(2) * Rdu[a] : s;
        }
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
        // u_prev of the trial and of the nominal: up0 at stage 0, else the
        // previous stage's control.
        const T tp0 = (k == 0) ? up0[0] : Vt[k - 1][0];
        const T tp1 = (k == 0) ? up0[1] : Vt[k - 1][1];
        const T np0 = (k == 0) ? up0[0] : V[k - 1][0];
        const T np1 = (k == 0) ? up0[1] : V[k - 1][1];
        T v[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          T mv1 = K1[k][a][0] * (Xt[k][0] - X[k][0]);
#pragma unroll
          for (int t = 1; t < 8; ++t) mv1 = mv1 + K1[k][a][t] * (Xt[k][t] - X[k][t]);
          const T mv2 = K2[k][a][0] * (tp0 - np0) + K2[k][a][1] * (tp1 - np1);
          v[a] = clip(V[k][a] + al * D[k][a] + mv1 + mv2, -c.u_b, c.u_b);
        }
        c_new = c_new + stage_cost(Xt[k], v[0], v[1], tp0, tp1);
        rk4(Xt[k], v, Xt[k + 1]);
        Vt[k][0] = v[0];
        Vt[k][1] = v[1];
      }
      c_new = c_new + track(Xt[N], Qt);
      if (c_new < cost - T(1e-12)) {
        accepted = true;
        c_best = c_new;
#pragma unroll 1
        for (int k = 0; k < N; ++k) {
          V[k][0] = Vt[k][0];
          V[k][1] = Vt[k][1];
#pragma unroll
          for (int i = 0; i < 8; ++i) X[k + 1][i] = Xt[k + 1][i];
        }
      }
    }
    const T rel = (cost - c_best) / (dabs(cost) + T(1));
    done = done || (accepted && rel < T(1e-9)) || !accepted;
    cost = c_best;
  }

#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    V_out[static_cast<size_t>(2 * k) * sB + lane] = V[k][0];
    V_out[static_cast<size_t>(2 * k + 1) * sB + lane] = V[k][1];
  }
  cost_out[lane] = cost;
  gnorm_out[lane] = gnorm;
}

template <typename T, int N>
void launch_n(const T* p, const T* Q, const T* R, const T* Qt, const T* tg,
              const T* z0, const T* V0, T* V, T* cost, T* gnorm, int B,
              int n_iters, int n_alphas, const Consts<T>& c, cudaStream_t s) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  lmpc_solve_kernel<T, N><<<grid, kThreads, 0, s>>>(
      p, Q, R, Qt, tg, z0, V0, V, cost, gnorm, B, n_iters, n_alphas, c);
}

template <typename T>
int launch(const T* p, const T* Q, const T* R, const T* Qt, const T* tg,
           const T* z0, const T* V0, T* V, T* cost, T* gnorm, int B, int N,
           int n_iters, int n_alphas, double dt, double u_bound,
           void* stream) {
  if (n_iters < 1 || n_alphas < 1 || n_alphas > kMaxAlphas) return kBadBudget;
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Consts<T> c;
  c.rk.half_dt = static_cast<T>(0.5 * dt);
  c.rk.dt = static_cast<T>(dt);
  c.rk.dt6 = static_cast<T>(dt / 6.0);
  c.u_b = static_cast<T>(u_bound);
  for (int i = 0; i < kMaxAlphas; ++i)
    c.alpha[i] = static_cast<T>(std::pow(0.6, i));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 6:
      launch_n<T, 6>(p, Q, R, Qt, tg, z0, V0, V, cost, gnorm, B, n_iters, n_alphas, c, s);
      break;
    case 12:
      launch_n<T, 12>(p, Q, R, Qt, tg, z0, V0, V, cost, gnorm, B, n_iters, n_alphas, c, s);
      break;
    case 20:
      launch_n<T, 20>(p, Q, R, Qt, tg, z0, V0, V, cost, gnorm, B, n_iters, n_alphas, c, s);
      break;
    default:
      return kBadShape;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lmpc_solve_f32(const float* p, const float* Q, const float* R,
                   const float* Qt, const float* tg, const float* z0,
                   const float* V0, float* V, float* cost, float* gnorm,
                   int B, int N, int n_iters, int n_alphas, double dt,
                   double u_bound, void* stream) {
  return launch<float>(p, Q, R, Qt, tg, z0, V0, V, cost, gnorm, B, N,
                       n_iters, n_alphas, dt, u_bound, stream);
}

int lmpc_solve_f64(const double* p, const double* Q, const double* R,
                   const double* Qt, const double* tg, const double* z0,
                   const double* V0, double* V, double* cost, double* gnorm,
                   int B, int N, int n_iters, int n_alphas, double dt,
                   double u_bound, void* stream) {
  return launch<double>(p, Q, R, Qt, tg, z0, V0, V, cost, gnorm, B, N,
                        n_iters, n_alphas, dt, u_bound, stream);
}

}  // extern "C"
