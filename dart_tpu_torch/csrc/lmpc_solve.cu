// Whole LMPC box-DDP solve, one scenario lane per group of 8 threads split
// along the model's two decoupled axes, for Hopper (sm_90a).
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
// accepted on c_new < cost - 1e-12 against the iteration's starting cost,
// the smallest accepted alpha index wins, a lane that accepts no alpha is
// done and a done lane never moves, gnorm is the max |d| of the last
// backward pass (taken before its line search), the Quu jitter is
// 2 (Ru + Rdu) + 1e-8, and gravity is the constant +9.81 (RMPC's kernel
// uses -9.81). d|v|/dv is sign(v), 0 at v = 0, as in jnp.sign. The plain
// PyTorch version is dart_tpu_torch/ops/kernels/lmpc_solve.py::_solve_lanes.
//
// Layout: every global array is batch-last, element (i, lane) at
// i * B + lane, so neighbouring lanes touch neighbouring addresses.
//
// What bounds it on this card, and what the design does about it:
// - It is compute-bound: ~86 kFLOP and ~5k exp/tanh/sin/cos per lane at
//   N = 12 and 2 iterations, counted over the model's structural non-zeros
//   (ops/kernels/lmpc_solve.py::work), against ~0.5 KB of float32 inputs
//   and outputs, and most of it is a chain of dependent operations through
//   the stages of each backward pass and trial rollout. B = 4096 lanes fill
//   few warps, so the limit is each warp's instruction stream and its
//   latency, not the FP rate.
// - The model's two axes never meet: x = {px, vx, th_y, om_y} (states 0, 1,
//   6, 7) is driven by the tilt u0 alone and y = {py, vy, th_x, om_x}
//   (states 2, 3, 4, 5) by u1. Ad, Bd, P, q, r and the gains are two
//   4-state blocks, so the lane's backward pass is two independent
//   partitioned Riccati recursions over [x_a(4), u_prev_a] (Ad_a 4x4, Bd_a
//   4, P_a 4x4, q_a 4, r_a, K1_a 4, K2_a, d_a), and a trial's control law
//   for one axis reads that axis's state alone. A group of G = 8 threads
//   holds a lane: threads 0..3 the x axis, 4..7 the y axis. The axes
//   meet at three points only: the 2x2 box QP (gathered; its off-diagonal
//   is an exact 0, and boxqp2's first minimum is kept), the stage cost
//   (track sums i = 0..7 in order, interleaving the axes, so each thread
//   gets its partner's errors and controls by shuffle and sums them in the
//   plain order), and the line search's acceptance and done mask.
// - The stages' (Ad_a, Bd_a) depend on the trajectory only, so they come
//   first: thread r of an axis runs the RK4 Jacobian chain of stages r,
//   r + 4, ... (lanes.cuh::rk4_jac4: the unit rows copied, the model and
//   its Jacobian rows sharing their exp and tanh) into shared memory. In
//   the recursion thread r of an axis owns row r of Qx, Qxx, Qux1, K1, the
//   new P, q and vx (column r of Ad), and the axis exchanges K1 with Qux1
//   and the new rows with __shfl_sync (lanes.cuh::group_gather4: 32
//   shuffles per stage, 11 more in the box QP and 3 with the partner); the
//   box QP's nine candidates are spread over the axis's threads
//   (boxqp2_group, bit for bit boxqp2's first minimum); the scalars (Qu,
//   Quu, K2, vu, r) are
//   held alike by every thread of the axis. Two threads per lane (one per
//   axis, the whole 4x4 algebra each, one alpha at a time) were built and
//   measured: 0.199 ms per launch on the card against 0.137 for eight.
// - The line search runs the alphas in parallel: thread (axis, r) rolls
//   out its axis's trial under alpha 0.6^(a0 + r) for chunks a0 = 0, 4, ...
//   in order, the two axis threads of an alpha trading their stage terms,
//   and the lane takes the smallest index whose cost passes the test (a
//   ballot over the group). Every trial starts from the same X, V, D, K,
//   so this is the TPU kernel's `~accepted & (c_new < cost - 1e-12)`
//   exactly. Done lanes skip the search.
// - The horizon lives in dynamic shared memory, per lane and axis: X[1..N],
//   V, D, K1_a, K2_a, the stages' (Ad_a, Bd_a) and 4 trial trajectories,
//   52 N values (624 at N = 12: 2496 bytes in float, 4992 in double). A
//   block is one warp of 4 lanes (19968 bytes in float at N = 12, 39936 in
//   double; 33280 and 66560 at N = 20, above the default 48 KB, so
//   launch() raises the instance's dynamic shared limit once). Element idx
//   of the warp's lane-axis slot lw, axis sits at idx * 8 + 2 lw + axis,
//   so the threads of a warp reading a row, a broadcast value or their own
//   trial slices hit distinct banks (rows r of one axis 8 banks apart).
// - The escalation front end (control/mpc.py) reads max(gnorm) on the host
//   after each round, so every control step syncs.
//
// One launch per call, no atomics, no fallback; a group whose lane is past
// the batch's end returns at once (the others use group masks only).
//
// Numerics: precise exp/tanh/sin/cos and IEEE division (no
// --use_fast_math). Constants the TPU kernel folds in python double (dt/2,
// dt/6, 0.6^i) are folded on the host in double and rounded once. Each
// element keeps the dense algebra's order of operations with the
// structural zeros skipped, which adds or multiplies nothing for finite
// values (a product whose dense partner term is an exact 0 is rounded on
// its own, lanes.cuh::mul_rn); nvcc's default FMA contraction is left on,
// so float32 results differ from the plain version by a few ulps per
// operation; chip_smoke.py states the tolerance. Every max, clip and sign
// propagates NaN, so a lane with NaN inputs reports a NaN cost and gnorm
// and leaves the other lanes alone.

#include <cuda_runtime.h>

#include <cmath>

#include "lanes.cuh"

namespace {

using namespace dart;

constexpr int kWarp = 32;
constexpr int kThreads = 32;   // threads per block: one warp
constexpr int R = 4;           // threads per axis
constexpr int G = 2 * R;       // threads per lane
constexpr int LW = kWarp / G;  // lanes per warp (= per block)

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

// strib and its slope d/dv (d|v|/dv = sign(v)) from one exp and one tanh.
template <typename T>
__device__ __forceinline__ void strib_d(T v, const Fric<T>& f, T& s, T& ds) {
  const T vs = f.v_s + T(1e-12);
  const T ex = dexp(-dabs(v) / vs);
  const T stc = f.f_c + (f.f_s - f.f_c) * ex;
  const T t = dtanh(v / f.eps);
  s = t * stc + f.b * v;
  ds = (T(1) - t * t) / f.eps * stc + t * (f.f_s - f.f_c) * ex * (-nan_sign(v) / vs) + f.b;
}

// One axis of the model over its local state [p, v, th, om] and tilt u:
// p' = v, v' = (m g sin u - c v - k p - F(v) - F(v + sr om)) / m,
// th' = om, om' = (-r F(v + sr om) - T(om) - c_rot om - m g h sin th) / I,
// with (sr, nr) = (-r_x, r_x) on the x axis and (r_y, -r_y) on the y axis.
template <typename T>
struct Axis {
  T m, c, k, r, sr, nr, c_rot, h, inertia;
  Fric<T> ff, tn;
};

// Global state index of local state s of axis a: x {0, 1, 6, 7}, y {2..5}.
__device__ __forceinline__ int gidx(int a, int s) {
  return a == 0 ? (s < 2 ? s : s + 4) : s + 2;
}

// A lane-axis's shared-memory arrays, as element offsets. X[1..N] (4N) and
// V (N) form the trajectory the line search replaces; X[0] stays in
// registers. Stage k's Ad_a (row-major) and Bd_a sit at kJac + 21 k (21,
// not 20: the four threads of an axis storing four stages hit four banks).
// Element e of trial slot j (alpha a0 + j) sits at kTrial + e * R + j.
template <int N>
struct Layout {
  static constexpr int kX = 0;
  static constexpr int kV = 4 * N;
  static constexpr int kTraj = 5 * N;
  static constexpr int kD = 5 * N;
  static constexpr int kK1 = 6 * N;
  static constexpr int kK2 = 10 * N;
  static constexpr int kJac = 11 * N;
  static constexpr int kJacStride = 21;
  static constexpr int kTrial = kJac + kJacStride * N;
  static constexpr int kPerAxis = kTrial + R * kTraj;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
lmpc_solve_kernel(const T* __restrict__ p_in, const T* __restrict__ Q_in,
                  const T* __restrict__ R_in, const T* __restrict__ Qt_in,
                  const T* __restrict__ t_in, const T* __restrict__ z0_in,
                  const T* __restrict__ V0, T* __restrict__ V_out,
                  T* __restrict__ cost_out, T* __restrict__ gnorm_out, int B,
                  int n_iters, int n_alphas, const Consts<T> c) {
  constexpr int SL = 2 * LW;        // lane-axis slots per warp
  using L = Layout<N>;
  const int tid = threadIdx.x;
  const int t = tid % G;
  const int ax = t / R;                      // 0: x axis, 1: y axis
  const int r = t % R;                       // row r, alpha a0 + r
  const int lw = tid / G;
  const int lane = blockIdx.x * LW + lw;
  if (lane >= B) return;                     // the whole group leaves together
  const int gfirst = lw * G;
  const unsigned gmask = ((1u << G) - 1u) << gfirst;
  const unsigned hmask = ((1u << R) - 1u) << (gfirst + ax * R);
  const unsigned pmask = (1u << (gfirst + r)) | (1u << (gfirst + R + r));
  // The partner: the other axis's thread with the same r (the same alpha).
  auto xchg = [&](T v) { return __shfl_sync(pmask, v, t ^ R, G); };

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const base = reinterpret_cast<T*>(smem_raw) + 2 * lw + ax;
  auto S = [&](int idx) -> T& { return base[idx * SL]; };

  const size_t sB = static_cast<size_t>(B);
  auto at = [&](const T* p, int i) { return p[static_cast<size_t>(i) * sB + lane]; };
  const T Gc = T(9.81);

  // ---- this axis's parameters, squashed once ----
  auto sq = [&](int i) { return dabs(at(p_in, i)) + T(1e-6); };
  auto fric = [&](int b) {
    return Fric<T>{at(p_in, b), at(p_in, b + 1), at(p_in, b + 2), sq(b + 3), sq(b + 4)};
  };
  Axis<T> P;
  P.m = sq(ax);
  P.c = sq(2 + ax);
  P.k = sq(4 + ax);
  P.ff = fric(6 + 5 * ax);
  P.r = sq(18 + ax);
  P.sr = (ax == 0) ? -P.r : P.r;
  P.nr = -P.sr;
  P.c_rot = sq(21 - ax);
  P.tn = fric(27 - 5 * ax);
  P.h = sq(33 - ax);
  P.inertia = sq(17 - ax) + T(1e-12);

  T Q8[8], Qt8[8], Qa[4], Qta[4], tga[4], x0a[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    Q8[i] = at(Q_in, i);
    Qt8[i] = at(Qt_in, i);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    Qa[s] = (ax == 0) ? Q8[gidx(0, s)] : Q8[gidx(1, s)];
    Qta[s] = (ax == 0) ? Qt8[gidx(0, s)] : Qt8[gidx(1, s)];
    tga[s] = at(t_in, gidx(ax, s));
    x0a[s] = at(z0_in, gidx(ax, s));
  }
  const T up0a = at(z0_in, 8 + ax);
  const T Ru[2] = {at(R_in, 0), at(R_in, 1)};
  const T Rdu[2] = {at(R_in, 2), at(R_in, 3)};
  const T Rua = (ax == 0) ? Ru[0] : Ru[1], Rdua = (ax == 0) ? Rdu[0] : Rdu[1];

#pragma unroll 1
  for (int k = r; k < N; k += R) S(L::kV + k) = at(V0, 2 * k + ax);
  __syncwarp(hmask);

  auto Xk = [&](int k, T (&x)[4]) {
#pragma unroll
    for (int s = 0; s < 4; ++s) x[s] = (k == 0) ? x0a[s] : S(L::kX + 4 * (k - 1) + s);
  };

  // xdot of this axis from its friction terms (gs = m g sin u).
  auto xdot = [&](const T (&x)[4], T gs, T ff, T fr, T tn, T (&xd)[4]) {
    const T tau = -P.r * fr - tn - P.c_rot * x[3] - P.m * Gc * P.h * dsin(x[2]);
    xd[0] = x[1];
    xd[1] = (gs - P.c * x[1] - P.k * x[0] - ff - fr) / P.m;
    xd[2] = x[3];
    xd[3] = tau / P.inertia;
  };
  auto model = [&](const T (&x)[4], T gs, T (&xd)[4]) {
    xdot(x, gs, strib(x[1], P.ff), strib(x[1] + P.sr * x[3], P.ff), strib(x[3], P.tn), xd);
  };
  // Rows 1 and 3 of this axis's continuous A from the friction slopes.
  auto arows = [&](const T (&x)[4], T Dff, T Dfr, T Dtn, T (&a1)[4], T (&a3)[4]) {
    a1[0] = -P.k / P.m;
    a1[1] = (-P.c - Dff - Dfr) / P.m;
    a1[2] = T(0);
    a1[3] = P.nr * Dfr / P.m;
    a3[0] = T(0);
    a3[1] = -P.r * Dfr / P.inertia;
    a3[2] = -P.m * Gc * P.h * dcos(x[2]) / P.inertia;
    a3[3] = (P.nr * P.r * Dfr - Dtn - P.c_rot) / P.inertia;
  };
  auto rk4 = [&](const T (&x)[4], T u, T (&xn)[4]) {
    const T gs = P.m * Gc * dsin(u);
    T k1[4], k2[4], k3[4], k4[4], xt[4];
    model(x, gs, k1);
#pragma unroll
    for (int i = 0; i < 4; ++i) xt[i] = x[i] + c.rk.half_dt * k1[i];
    model(xt, gs, k2);
#pragma unroll
    for (int i = 0; i < 4; ++i) xt[i] = x[i] + c.rk.half_dt * k2[i];
    model(xt, gs, k3);
#pragma unroll
    for (int i = 0; i < 4; ++i) xt[i] = x[i] + c.rk.dt * k3[i];
    model(xt, gs, k4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xn[i] = x[i] + c.rk.dt6 * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + k4[i]);
  };
  // The lane's errors e = x - target in the global order i = 0..7, this
  // axis's from e and the partner's by shuffle.
  auto full8 = [&](const T (&e)[4], T (&e8)[8]) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const T o = xchg(e[s]);
      e8[gidx(0, s)] = (ax == 0) ? e[s] : o;
      e8[gidx(1, s)] = (ax == 1) ? e[s] : o;
    }
  };
  // sum_i W[i] e_i^2 in the order i = 0..7.
  auto track = [&](const T (&e8)[8], const T (&W)[8]) {
    T s = T(0);
#pragma unroll
    for (int i = 0; i < 8; ++i) s = (i == 0) ? W[0] * e8[0] * e8[0] : s + W[i] * e8[i] * e8[i];
    return s;
  };
  auto errors = [&](const T (&x)[4], T (&e)[4]) {
#pragma unroll
    for (int s = 0; s < 4; ++s) e[s] = x[s] - tga[s];
  };
  // Stage cost of make_lmpc_ocp, this axis's (x, v, u_prev) and the
  // partner's, summed as the plain version sums them.
  auto stage_cost = [&](const T (&x)[4], T v, T up) {
    T e[4], e8[8];
    errors(x, e);
    full8(e, e8);
    const T du = v - up;
    const T vo = xchg(v), duo = xchg(du);
    const T v0 = (ax == 0) ? v : vo, v1 = (ax == 0) ? vo : v;
    const T du0 = (ax == 0) ? du : duo, du1 = (ax == 0) ? duo : du;
    return track(e8, Q8) + Ru[0] * v0 * v0 + Ru[1] * v1 * v1
           + Rdu[0] * du0 * du0 + Rdu[1] * du1 * du1;
  };
  auto terminal_cost = [&](const T (&x)[4]) {
    T e[4], e8[8];
    errors(x, e);
    full8(e, e8);
    return track(e8, Qt8);
  };

  // Rollout and cost of the (clipped) warm start; every thread of the
  // axis computes it, thread r = 0 stores X.
  T cost = T(0);
  {
    T x[4] = {x0a[0], x0a[1], x0a[2], x0a[3]}, up = up0a;
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      const T v = S(L::kV + k);
      cost = cost + stage_cost(x, v, up);
      T xn[4];
      rk4(x, v, xn);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (r == 0) S(L::kX + 4 * k + s) = xn[s];
        x[s] = xn[s];
      }
      up = v;
    }
    cost = cost + terminal_cost(x);
  }
  __syncwarp(hmask);
  bool done = false;
  T gnorm = T(0);
  const T Qux2 = T(-2) * Rdua;

#pragma unroll 1
  for (int it = 0; it < n_iters; ++it) {
    // ---- the stages' (Ad_a, Bd_a), spread over the axis's threads ----
#pragma unroll 1
    for (int k = r; k < N; k += R) {
      T x[4];
      Xk(k, x);
      const T u = S(L::kV + k);
      const T gs = P.m * Gc * dsin(u), bg = Gc * dcos(u);
      auto fj = [&](const T (&xs)[4], T (&xd)[4], T (&a1)[4], T (&a3)[4]) {
        T ff, Dff, fr, Dfr, tn, Dtn;
        strib_d(xs[1], P.ff, ff, Dff);
        strib_d(xs[1] + P.sr * xs[3], P.ff, fr, Dfr);
        strib_d(xs[3], P.tn, tn, Dtn);
        xdot(xs, gs, ff, fr, tn, xd);
        arows(xs, Dff, Dfr, Dtn, a1, a3);
      };
      auto jac = [&](const T (&xs)[4], T (&a1)[4], T (&a3)[4]) {
        T s, Dff, Dfr, Dtn;
        strib_d(xs[1], P.ff, s, Dff);
        strib_d(xs[1] + P.sr * xs[3], P.ff, s, Dfr);
        strib_d(xs[3], P.tn, s, Dtn);
        arows(xs, Dff, Dfr, Dtn, a1, a3);
      };
      T Ad[4][4], Bd[4];
      rk4_jac4(fj, jac, x, bg, c.rk, Ad, Bd);
      const int o = L::kJac + L::kJacStride * k;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) S(o + 4 * i + j) = Ad[i][j];
        S(o + 16 + i) = Bd[i];
      }
    }
    __syncwarp(hmask);

    // ---- backward: partitioned Riccati over [x_a(4), u_prev_a] ----
    // Held alike by the axis's threads: vx, vu, P (symmetric), q, ra.
    T vx[4], vu = T(0), Pm[4][4], q[4], ra = T(0);
    {
      T xN[4];
      Xk(N, xN);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        vx[i] = T(2) * Qta[i] * (xN[i] - tga[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) Pm[i][j] = (i == j) ? T(2) * Qta[i] : T(0);
        q[i] = T(0);
      }
    }
    T gn = T(0);
#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      T x[4];
      Xk(k, x);
      const T v = S(L::kV + k);
      const T up = (k == 0) ? up0a : S(L::kV + k - 1);
      const int o = L::kJac + L::kJacStride * k;
      T Ad[4][4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) Ad[i][j] = S(o + 4 * i + j);
        b[i] = S(o + 16 + i);
      }
      // Stage cost quadratics (make_lmpc_ocp.cost_quad).
      const T du = v - up;
      const T Qx2 = T(-2) * Rdua * du;
      T Qu;
      {
        const T lv = T(2) * Rua * v + T(2) * Rdua * du;
        T acc = b[0] * vx[0];
#pragma unroll
        for (int tt = 1; tt < 4; ++tt) acc = acc + b[tt] * vx[tt];
        Qu = lv + acc + vu;
      }
      // Row r of Qx = 2Q e + Ad'vx, Qxx = Ad'P Ad + diag(2Q) and Qux1 =
      // T2 Ad with T2 = b'P + q'; Quu = T2 b + b'q + r, symmetrised, plus
      // the jitter.
      T T2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T acc = b[0] * Pm[0][j];
#pragma unroll
        for (int tt = 1; tt < 4; ++tt) acc = acc + b[tt] * Pm[tt][j];
        T2[j] = acc + q[j];
      }
      T Qxx[4];   // row r
      const T Qr = pick4(Qa, r);
      T adc[4];   // column r of Ad
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) adc[tt] = S(o + 4 * tt + r);
      T Qx;
      {
        T acc = adc[0] * vx[0];
#pragma unroll
        for (int tt = 1; tt < 4; ++tt) acc = acc + adc[tt] * vx[tt];
        Qx = T(2) * Qr * (pick4(x, r) - pick4(tga, r)) + acc;
      }
      {
        T T1r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          T a = adc[0] * Pm[0][j];
#pragma unroll
          for (int tt = 1; tt < 4; ++tt) a = a + adc[tt] * Pm[tt][j];
          T1r[j] = a;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          T a = T1r[0] * Ad[0][j];
#pragma unroll
          for (int tt = 1; tt < 4; ++tt) a = a + T1r[tt] * Ad[tt][j];
          Qxx[j] = (j == r) ? a + T(2) * Qr : a;
        }
      }
      T Qux1;
      {
        T a = T2[0] * adc[0];
#pragma unroll
        for (int tt = 1; tt < 4; ++tt) a = a + T2[tt] * adc[tt];
        Qux1 = a;
      }
      T Quu;
      {
        T acc1 = T2[0] * b[0], acc2 = b[0] * q[0];
#pragma unroll
        for (int tt = 1; tt < 4; ++tt) {
          acc1 = acc1 + T2[tt] * b[tt];
          acc2 = acc2 + b[tt] * q[tt];
        }
        const T Gm = acc1 + acc2 + ra;
        const T s = T(0.5) * (Gm + Gm);
        Quu = s + (T(2) * (Rua + Rdua) + T(1e-8));
      }

      // The 2x2 box QP over both tilts; Quu's off-diagonal is 0.
      const T Quu_p = xchg(Quu), Qu_p = xchg(Qu), v_p = xchg(v);
      const T q00 = (ax == 0) ? Quu : Quu_p, q11 = (ax == 0) ? Quu_p : Quu;
      const T Qu0 = (ax == 0) ? Qu : Qu_p, Qu1 = (ax == 0) ? Qu_p : Qu;
      const T v0 = (ax == 0) ? v : v_p, v1 = (ax == 0) ? v_p : v;
      T d0, d1, f0, f1;
      boxqp2_group(hmask, R, r, q00, T(0), q11, Qu0, Qu1, -c.u_b - v0,
                   -c.u_b - v1, c.u_b - v0, c.u_b - v1, d0, d1, f0, f1);
      const T gn_k = nan_max(dabs(d0), dabs(d1));
      gn = (k == N - 1) ? gn_k : nan_max(gn, gn_k);
      // Gains on the free set (lanes.cuh::gains2 with h01 = 0): entry r of
      // K1 and K2 divide the other axis's h times this axis's term by det.
      const T d = (ax == 0) ? d0 : d1, fo = (ax == 0) ? f0 : f1;
      const T h00 = q00 * f0 * f0 + (T(1) - f0);
      const T h11 = q11 * f1 * f1 + (T(1) - f1);
      const T deth = guard_tiny(h00 * h11);
      const T hp = (ax == 0) ? h11 : h00;
      const T K1 = -(hp * (Qux1 * fo)) / deth;
      S(L::kK1 + 4 * k + r) = K1;
      T K2;
      {
        const T bo = Qux2 * fo;
        K2 = -(hp * bo) / deth;
      }
      if (r == 0) {
        S(L::kD + k) = d;
        S(L::kK2 + k) = K2;
      }

      // Value update: row r of vx, P and q; vu and ra alike.
      const T w2 = mul_rn(Quu, d) + Qu;
      const T kq[2] = {K1, Qux1};
      T KQ[4][2];   // {K1[j], Qux1[j]} for j = 0..3
      group_gather4(hmask, R, kq, KQ);
      const T K1Q = mul_rn(K1, Quu);
      T own[6];   // row r of the new P, then vx[r] and q[r]
#pragma unroll
      for (int j = 0; j < 4; ++j)
        own[j] = Qxx[j] + mul_rn(K1Q, KQ[j][0]) + mul_rn(K1, KQ[j][1])
                 + mul_rn(KQ[j][0], Qux1);
      own[4] = Qx + mul_rn(K1, w2) + mul_rn(Qux1, d);
      own[5] = mul_rn(K1Q, K2) + mul_rn(K1, Qux2) + mul_rn(Qux1, K2);
      vu = Qx2 + mul_rn(K2, w2) + mul_rn(Qux2, d);
      {
        const T K2Q = mul_rn(K2, Quu);
        const T M2 = mul_rn(K2, Qux2);
        const T rn = mul_rn(K2Q, K2) + M2 + M2;
        const T s = T(0.5) * (rn + rn);
        ra = s + T(2) * Rdua;
      }
      T full[4][6];
      group_gather4(hmask, R, own, full);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) Pm[i][j] = T(0.5) * (full[i][j] + full[j][i]);
        vx[i] = full[i][4];
        q[i] = full[i][5];
      }
    }
    gnorm = gn;
    __syncwarp(hmask);

    // ---- forward line search, the alphas in parallel over the axis ----
    bool accepted = done;   // done lanes never move
    T c_best = cost;
#pragma unroll 1
    for (int a0 = 0; a0 < n_alphas && !accepted; a0 += R) {
      const int ia = a0 + r;
      T c_new = T(0);
      bool ok = false;
      if (ia < n_alphas) {
        T al = c.alpha[0];   // c.alpha[ia], by selects: no local copy
#pragma unroll
        for (int i = 1; i < kMaxAlphas; ++i) al = (i == ia) ? c.alpha[i] : al;
        T xt[4] = {x0a[0], x0a[1], x0a[2], x0a[3]}, ut = up0a;
        const int e0 = L::kTrial + r;
#pragma unroll 1
        for (int k = 0; k < N; ++k) {
          T x[4];
          Xk(k, x);
          const T np = (k == 0) ? up0a : S(L::kV + k - 1);
          const int k1 = L::kK1 + 4 * k;
          T mv1 = S(k1) * (xt[0] - x[0]);
#pragma unroll
          for (int s = 1; s < 4; ++s) mv1 = mv1 + S(k1 + s) * (xt[s] - x[s]);
          const T mv2 = mul_rn(S(L::kK2 + k), ut - np);
          const T v = clip(S(L::kV + k) + al * S(L::kD + k) + mv1 + mv2, -c.u_b, c.u_b);
          c_new = c_new + stage_cost(xt, v, ut);
          T xn[4];
          rk4(xt, v, xn);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            S(e0 + (L::kX + 4 * k + s) * R) = xn[s];
            xt[s] = xn[s];
          }
          S(e0 + (L::kV + k) * R) = v;
          ut = v;
        }
        c_new = c_new + terminal_cost(xt);
        ok = c_new < cost - T(1e-12);
      }
      // Bit r of the x axis's threads: alpha a0 + r passed (its y thread
      // computed the same c_new).
      const unsigned hit = (__ballot_sync(gmask, ok) >> gfirst) & ((1u << R) - 1u);
      if (hit != 0u) {
        const int win = __ffs(hit) - 1;
        accepted = true;
        c_best = __shfl_sync(gmask, c_new, win, G);
        __syncwarp(hmask);   // the winner's trial stores before the copy's loads
#pragma unroll 1
        for (int e = r; e < L::kTraj; e += R) S(L::kX + e) = S(L::kTrial + e * R + win);
        __syncwarp(hmask);
      }
    }
    const T rel = (cost - c_best) / (dabs(cost) + T(1));
    done = done || (accepted && rel < T(1e-9)) || !accepted;
    cost = c_best;
  }

#pragma unroll 1
  for (int k = r; k < N; k += R)
    V_out[static_cast<size_t>(2 * k + ax) * sB + lane] = S(L::kV + k);
  if (t == 0) {
    cost_out[lane] = cost;
    gnorm_out[lane] = gnorm;
  }
}

// Launch geometry of one instance: lanes and dynamic shared bytes per block.
template <typename T, int N>
struct Instance {
  static constexpr int kLanes = LW;
  static constexpr size_t kShared = sizeof(T) * 2 * kLanes * Layout<N>::kPerAxis;

  // Raise the dynamic shared limit above the default 48 KB, once.
  static cudaError_t prepare() {
    static cudaError_t err = cudaFuncSetAttribute(
        lmpc_solve_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kShared));
    return err;
  }

  static int run(const T* p, const T* Q, const T* Rw, const T* Qt, const T* tg,
                 const T* z0, const T* V0, T* V, T* cost, T* gnorm, int B,
                 int n_iters, int n_alphas, const Consts<T>& c, cudaStream_t s) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((B + kLanes - 1) / kLanes);
    lmpc_solve_kernel<T, N><<<grid, kThreads, kShared, s>>>(
        p, Q, Rw, Qt, tg, z0, V0, V, cost, gnorm, B, n_iters, n_alphas, c);
    return static_cast<int>(cudaGetLastError());
  }

  static int geometry(int* threads, int* lanes, int* shared, int* blocks_per_sm) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    *threads = kThreads;
    *lanes = kLanes;
    *shared = static_cast<int>(kShared);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, lmpc_solve_kernel<T, N>, kThreads, kShared);
    return static_cast<int>(err);
  }
};

template <typename T>
int launch(const T* p, const T* Q, const T* Rw, const T* Qt, const T* tg,
           const T* z0, const T* V0, T* V, T* cost, T* gnorm, int B, int N,
           int n_iters, int n_alphas, double dt, double u_bound,
           void* stream) {
  if (N != 6 && N != 12 && N != 20) return kBadShape;
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
  if (N == 6)
    return Instance<T, 6>::run(p, Q, Rw, Qt, tg, z0, V0, V, cost, gnorm, B, n_iters, n_alphas, c, s);
  if (N == 12)
    return Instance<T, 12>::run(p, Q, Rw, Qt, tg, z0, V0, V, cost, gnorm, B, n_iters, n_alphas, c, s);
  return Instance<T, 20>::run(p, Q, Rw, Qt, tg, z0, V0, V, cost, gnorm, B, n_iters, n_alphas, c, s);
}

template <typename T>
int geometry(int N, int* threads, int* lanes, int* shared, int* blocks_per_sm) {
  if (N == 6) return Instance<T, 6>::geometry(threads, lanes, shared, blocks_per_sm);
  if (N == 12) return Instance<T, 12>::geometry(threads, lanes, shared, blocks_per_sm);
  return Instance<T, 20>::geometry(threads, lanes, shared, blocks_per_sm);
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

// Threads and lanes per block, dynamic shared bytes per block and resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the
// instance a call with horizon N and element size itemsize (4 or 8) runs.
int lmpc_solve_geometry(int N, int itemsize, int* threads, int* lanes,
                        int* shared, int* blocks_per_sm) {
  if ((N != 6 && N != 12 && N != 20) || (itemsize != 4 && itemsize != 8))
    return kBadShape;
  if (itemsize == 4) return geometry<float>(N, threads, lanes, shared, blocks_per_sm);
  return geometry<double>(N, threads, lanes, shared, blocks_per_sm);
}

}  // extern "C"
