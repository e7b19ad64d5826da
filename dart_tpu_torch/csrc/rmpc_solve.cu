// Whole slew-exact RMPC solve, augmented-Lagrangian outer loop included,
// one scenario lane per group of G threads, for Hopper (sm_90a).
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
// not ilqr.solve_batch's: V0 is clipped to +-du_bound, the done mask and
// the cost restart at each AL round, the lane takes the first alpha in the
// order 0.6^i whose cost is below cost - 1e-12, a lane that accepts no
// alpha is done, gnorm is the max |d| of the last backward pass (taken
// before its line search), the multipliers update on the round's final
// trajectory, and gravity is the constant -9.81. The plain PyTorch version
// is dart_tpu_torch/ops/kernels/rmpc_solve.py::_solve_lanes.
//
// Layout: every global array is batch-last, element (i, lane) at
// i * B + lane, so neighbouring lanes touch neighbouring addresses.
//
// What bounds it on this card, and what the design does about it:
// - It is compute-bound: ~0.76 MFLOP and ~8.6k tanh/sin/cos per lane at the
//   production budget (N = 20, 6 iterations x 4 alphas x 3 AL rounds,
//   counted over the model's structural non-zeros by ops/kernels/
//   rmpc_solve.py::work) against ~0.8 KB of inputs and outputs, and most of
//   it is a chain of dependent operations through the stages of each
//   backward pass. With B = 4096 lanes the card holds few warps, so the
//   limit is the issue and latency of each warp's instruction stream, not
//   the FP rate: the design cuts the instructions each warp issues per
//   stage and the dependent chain through it.
// - A lane per group of G = 4 threads. B = 4096 lanes are 16384 threads,
//   512 one-warp blocks, ~3.9 warps per SM (one thread per lane gave one
//   warp per SM). The stages' (Ad, Bd) depend only on the trajectory, so
//   they come first: thread t computes the RK4 Jacobian chain of stages
//   t, t + 4, ... (dk_s = A_s (I + h dk_{s-1}), A's two unit rows copied,
//   B's zeros skipped) into shared memory. In the Riccati recursion thread
//   r owns row r of P, q, W, Qxx11, Qxx12 and the value update, and column
//   r of Ad, Qvz1 and K1; the group exchanges W, q, Ad, K1 with Qvz1, the
//   new P and vx with __shfl_sync (83 shuffles per stage with the box QP's
//   and K2's). The box QP's nine candidates are spread over the group
//   (boxqp2_group: three each, the first minimum in boxqp2's order, bit
//   for bit), and so are the gains' divisions (column r of K1, entry r of
//   K2). Every thread holds
//   the replicated values (vx, vu, P, r, the box QP's step) bit for bit, so
//   the group branches alike.
// - The line search runs the alphas in parallel: thread a of the group
//   runs the trial with alpha 0.6^a (in chunks of G, in order, when
//   n_alphas > G), each into its own slice of shared memory, and the lane
//   takes the smallest index whose cost passes the test (a ballot over the
//   group). Every trial starts from the same X, U, V, D, K, so this is the
//   TPU kernel's `~accepted & (c_new < cost - 1e-12)` exactly. The group
//   then copies the winner's slice over X, U, V. Done lanes skip the
//   search.
// - The horizon lives in dynamic shared memory, per lane: ref, lam, D, K1,
//   K2, the current X[1..N], U[1..N], V, G trial trajectories and the
//   stages' (Ad, Bd), 55N + 4 + 8GN values (1744 at N = 20: 6976 bytes in
//   float, 13952 in double). A block is one warp of 8 lanes (55808 bytes in
//   float at N = 20, 111616 in double, above the default 48 KB, so launch()
//   raises the instance's dynamic shared limit once): four float blocks
//   fit an SM, 4224 lanes on 132 SMs, so B = 4096 runs in one wave.
//   Element idx of the warp's lane slot lw sits at idx * 8 + lw, so the
//   threads of a warp reading a row, a broadcast value or their own trial
//   slices hit distinct banks.
// - The escalation front end (control/mpc.py) reads max(viol) and
//   max(gnorm) on the host after each round, so every control step syncs.
//
// One launch per call, no atomics, no fallback; a group whose lane is past
// the batch's end returns at once (the others use group masks only).
//
// Numerics: precise tanh/sin/cos and IEEE division (no --use_fast_math).
// Constants the TPU kernel folds in python double (dt/2, dt/6, 0.6^i) are
// folded on the host in double and rounded once. Each element keeps the
// plain version's order of operations (sums over t = 0..3 in order, the
// structural zeros of A and B skipped, which adds or multiplies nothing);
// nvcc's default FMA contraction is left on, so float32 results differ
// from the plain version by a few ulps per operation; chip_smoke.py states
// the tolerance. Every max and clip propagates NaN, so a lane with NaN
// inputs reports a NaN viol or gnorm.

#include <cuda_runtime.h>

#include <cmath>

#include "lanes.cuh"

namespace {

using namespace dart;

constexpr int kWarp = 32;
constexpr int kThreads = 32;   // threads per block: one warp
constexpr int G = 4;           // threads per lane
constexpr int LW = kWarp / G;  // lanes per warp

template <typename T>
struct Consts {
  RK4Consts<T> rk;
  T v_eps, g;
  T u_b, du_b, vmax;
  T mu_init, mu_scale, mu_max, tol_con;
  T alpha[kMaxAlphas];   // 0.6^i
};

// A lane's shared-memory arrays, as element offsets. A trajectory is
// X[1..N] (4N), U[1..N] (2N), V[0..N-1] (2N); X[0], U[0] stay in registers.
// Element e of the trial trajectory of thread a sits at kTrial + e * G + a.
// Stage k's Ad (row-major) and Bd sit at kJac + kJacStride * k; the stride
// is 25, not 24, so the four threads storing four stages hit four banks.
template <int N>
struct Layout {
  static constexpr int kRef = 0;                    // ref[k][i], (N+1) x 4
  static constexpr int kLam = kRef + 4 * (N + 1);   // lam[k][i], N x 4
  static constexpr int kD = kLam + 4 * N;           // D[k][a], N x 2
  static constexpr int kK1 = kD + 2 * N;            // K1[k][a][j], N x 2 x 4
  static constexpr int kK2 = kK1 + 8 * N;           // K2[k][a][b], N x 2 x 2
  static constexpr int kTraj = 8 * N;
  static constexpr int kCur = kK2 + 4 * N;
  static constexpr int kTrial = kCur + kTraj;
  static constexpr int kJac = kTrial + G * kTraj;
  static constexpr int kJacStride = 25;
  static constexpr int kPerLane = kJac + kJacStride * N;
  static constexpr int kU = 4 * N;                  // U[1] within a trajectory
  static constexpr int kV = 6 * N;                  // V[0] within a trajectory
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
rmpc_solve_kernel(const T* __restrict__ th_in, const T* __restrict__ ref_in,
                  const T* __restrict__ w_in, const T* __restrict__ z0_in,
                  const T* __restrict__ V0, T* __restrict__ V_out,
                  T* __restrict__ cost_out, T* __restrict__ viol_out,
                  T* __restrict__ gnorm_out, int B, int n_iters, int n_alphas,
                  int al_rounds, const Consts<T> c) {
  using L = Layout<N>;
  const int tid = threadIdx.x;
  const int t = tid % G;          // thread within the lane's group: the
  const int r = t;                // row / column it owns, its alpha
  const int lw = (tid % kWarp) / G;
  const int lane = (blockIdx.x * blockDim.x + tid) / G;
  if (lane >= B) return;          // the whole group leaves together
  const int gfirst = tid % kWarp - t;
  const unsigned gmask = ((1u << G) - 1u) << gfirst;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const base = reinterpret_cast<T*>(smem_raw)
                  + (tid / kWarp) * (L::kPerLane * LW) + lw;
  auto S = [&](int idx) -> T& { return base[idx * LW]; };

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

#pragma unroll 1
  for (int e = t; e < 4 * (N + 1); e += G) S(L::kRef + e) = at(ref_in, e);
#pragma unroll 1
  for (int e = t; e < 2 * N; e += G)
    S(L::kCur + L::kV + e) = clip(at(V0, e), -c.du_b, c.du_b);
#pragma unroll 1
  for (int e = t; e < 4 * N; e += G) S(L::kLam + e) = T(0);
  __syncwarp(gmask);

  auto Xk = [&](int k, T (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = (k == 0) ? x0[i] : S(L::kCur + 4 * (k - 1) + i);
  };
  auto Uk = [&](int k, T (&u)[2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      u[j] = (k == 0) ? up0[j] : S(L::kCur + L::kU + 2 * (k - 1) + j);
  };
  auto Vk = [&](int k, int j) -> T& { return S(L::kCur + L::kV + 2 * k + j); };

  // xdot of the model (f4) with gs = g sin(u), returning the tanh features;
  // rows 1 and 3 of the continuous A from them (rows 0 and 2 are unit).
  auto f4 = [&](const T (&x)[4], T gs0, T gs1, T (&xd)[4], T& tx, T& ty) {
    tx = dtanh(x[1] / c.v_eps);
    ty = dtanh(x[3] / c.v_eps);
    xd[0] = x[1];
    xd[1] = gs0 + th[0] * x[0] + th[1] * x[1] + th[2] * x[2] + th[3] * x[3]
            + th[4] * tx + th[5] * ty + th[6];
    xd[2] = x[3];
    xd[3] = gs1 + th[7] * x[0] + th[8] * x[1] + th[9] * x[2] + th[10] * x[3]
            + th[11] * tx + th[12] * ty + th[13];
  };
  auto arows = [&](T tx, T ty, T (&a1)[4], T (&a3)[4]) {
    const T dtx = (T(1) - tx * tx) / c.v_eps;
    const T dty = (T(1) - ty * ty) / c.v_eps;
    a1[0] = th[0];
    a1[1] = th[1] + th[4] * dtx;
    a1[2] = th[2];
    a1[3] = th[3] + th[5] * dty;
    a3[0] = th[7];
    a3[1] = th[8] + th[11] * dtx;
    a3[2] = th[9];
    a3[3] = th[10] + th[12] * dty;
  };
  auto rk4 = [&](const T (&x)[4], const T (&u)[2], T (&xn)[4]) {
    const T gs0 = c.g * dsin(u[0]), gs1 = c.g * dsin(u[1]);
    T k1[4], k2[4], k3[4], k4[4], xt[4], tx, ty;
    f4(x, gs0, gs1, k1, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) xt[i] = x[i] + c.rk.half_dt * k1[i];
    f4(xt, gs0, gs1, k2, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) xt[i] = x[i] + c.rk.half_dt * k2[i];
    f4(xt, gs0, gs1, k3, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) xt[i] = x[i] + c.rk.dt * k3[i];
    f4(xt, gs0, gs1, k4, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xn[i] = x[i] + c.rk.dt6 * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + k4[i]);
  };
  // Ad and Bd of one RK4 step at (x, u), by the chain rule of lanes.cuh's
  // rk4_jac, column by column: dk_1 = A_1, dk_s = A_s (I + h dk_{s-1}) and
  // dku_s = A_s (h dku_{s-1}) + B_s, S = dk_1 + 2 dk_2 + 2 dk_3 + dk_4,
  // Ad = I + dt/6 Sx, Bd = dt/6 Su. A_s's unit rows 0 and 2 copy rows 1 and
  // 3 of their operand; B_s = g cos(u) at (1, 0) and (3, 1).
  auto rk4_jac = [&](const T (&x)[4], const T (&u)[2], T (&Ad)[4][4],
                     T (&Bd)[4][2]) {
    const T gs0 = c.g * dsin(u[0]), gs1 = c.g * dsin(u[1]);
    const T gc0 = c.g * dcos(u[0]), gc1 = c.g * dcos(u[1]);
    T a1[4][4], a3[4][4], kd[4], xs[4], tx, ty;
    f4(x, gs0, gs1, kd, tx, ty);
    arows(tx, ty, a1[0], a3[0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) xs[i] = x[i] + c.rk.half_dt * kd[i];
    f4(xs, gs0, gs1, kd, tx, ty);
    arows(tx, ty, a1[1], a3[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) xs[i] = x[i] + c.rk.half_dt * kd[i];
    f4(xs, gs0, gs1, kd, tx, ty);
    arows(tx, ty, a1[2], a3[2]);
#pragma unroll
    for (int i = 0; i < 4; ++i) xs[i] = x[i] + c.rk.dt * kd[i];
    arows(dtanh(xs[1] / c.v_eps), dtanh(xs[3] / c.v_eps), a1[3], a3[3]);

    T dk[4][4], Sx[4][4];   // [column][row]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[j][0] = (j == 1) ? T(1) : T(0);
      dk[j][1] = a1[0][j];
      dk[j][2] = (j == 3) ? T(1) : T(0);
      dk[j][3] = a3[0][j];
#pragma unroll
      for (int i = 0; i < 4; ++i) Sx[j][i] = dk[j][i];
    }
    T du[2][4] = {{T(0), gc0, T(0), T(0)}, {T(0), T(0), T(0), gc1}};
    T Su[2][4] = {{T(0), gc0, T(0), T(0)}, {T(0), T(0), T(0), gc1}};
#pragma unroll
    for (int s = 1; s < 4; ++s) {
      const T h = (s == 3) ? c.rk.dt : c.rk.half_dt;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T E[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) E[i] = (i == j) ? h * dk[j][i] + T(1) : h * dk[j][i];
        dk[j][0] = E[1];
        dk[j][1] = a1[s][0] * E[0] + a1[s][1] * E[1] + a1[s][2] * E[2] + a1[s][3] * E[3];
        dk[j][2] = E[3];
        dk[j][3] = a3[s][0] * E[0] + a3[s][1] * E[1] + a3[s][2] * E[2] + a3[s][3] * E[3];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Sx[j][i] = (s < 3) ? Sx[j][i] + T(2) * dk[j][i] : Sx[j][i] + dk[j][i];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        T sb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sb[i] = h * du[j][i];
        const T r1 = a1[s][0] * sb[0] + a1[s][1] * sb[1] + a1[s][2] * sb[2]
                     + a1[s][3] * sb[3];
        const T r3 = a3[s][0] * sb[0] + a3[s][1] * sb[1] + a3[s][2] * sb[2]
                     + a3[s][3] * sb[3];
        du[j][0] = sb[1];
        du[j][1] = (j == 0) ? r1 + gc0 : r1;
        du[j][2] = sb[3];
        du[j][3] = (j == 1) ? r3 + gc1 : r3;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Su[j][i] = (s < 3) ? Su[j][i] + T(2) * du[j][i] : Su[j][i] + du[j][i];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ad[i][j] = (i == j) ? c.rk.dt6 * Sx[j][i] + T(1) : c.rk.dt6 * Sx[j][i];
      Bd[i][0] = c.rk.dt6 * Su[0][i];
      Bd[i][1] = c.rk.dt6 * Su[1][i];
    }
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
      const T e = x[i] - S(L::kRef + 4 * k + i);
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
      const T lam = S(L::kLam + 4 * k + i);
      const T tt = nan_max(T(0), lam + mu * C[i]);
      const T term = tt * tt - lam * lam;
      pen = (i == 0) ? term : pen + term;
    }
    return cs + pen / (T(2) * mu);
  };

  T mu = c.mu_init, viol = T(0), gnorm = T(0);

#pragma unroll 1
  for (int round = 0; round < al_rounds; ++round) {
    // Rollout and AL cost of the round's starting V (every thread of the
    // group computes it; thread 0 stores X, U).
    T cost = T(0);
    {
      T x[4] = {x0[0], x0[1], x0[2], x0[3]}, up[2] = {up0[0], up0[1]};
#pragma unroll 1
      for (int k = 0; k < N; ++k) {
        const T v[2] = {Vk(k, 0), Vk(k, 1)};
        cost = cost + stage_cost_al(x, up, v, k, mu);
        const T u[2] = {clip(up[0] + v[0], -c.u_b, c.u_b),
                        clip(up[1] + v[1], -c.u_b, c.u_b)};
        T xn[4];
        rk4(x, u, xn);
        if (t == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) S(L::kCur + 4 * k + i) = xn[i];
          S(L::kCur + L::kU + 2 * k) = u[0];
          S(L::kCur + L::kU + 2 * k + 1) = u[1];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = xn[i];
        up[0] = u[0];
        up[1] = u[1];
      }
      cost = cost + track(x, N);
    }
    __syncwarp(gmask);
    bool done = false;

#pragma unroll 1
    for (int it = 0; it < n_iters; ++it) {
      // ---- backward: partitioned Riccati over z = [x(4), u_prev(2)] ----
      // Replicated: vx4, vu2, P (symmetric), rr; owned: row r of q.
      T vx4[4], vu2[2] = {T(0), T(0)}, P[4][4], qr[2] = {T(0), T(0)}, rr[2][2];
      {
        T xN[4];
        Xk(N, xN);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          vx4[i] = T(2) * w4[i] * (xN[i] - S(L::kRef + 4 * N + i));
#pragma unroll
          for (int j = 0; j < 4; ++j) P[i][j] = (i == j) ? T(2) * w4[i] : T(0);
        }
      }
      rr[0][0] = rr[0][1] = rr[1][0] = rr[1][1] = T(0);
      // The stages' (Ad, Bd) first, the stages spread over the group: they
      // depend on the trajectory only, not on the Riccati recursion.
#pragma unroll 1
      for (int k = t; k < N; k += G) {
        T x[4], up[2], Ad[4][4], Bd[4][2];
        Xk(k, x);
        Uk(k, up);
        const T u[2] = {clip(up[0] + Vk(k, 0), -c.u_b, c.u_b),
                        clip(up[1] + Vk(k, 1), -c.u_b, c.u_b)};
        rk4_jac(x, u, Ad, Bd);
        const int o = L::kJac + L::kJacStride * k;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) S(o + 4 * i + j) = Ad[i][j];
          S(o + 16 + 2 * i) = Bd[i][0];
          S(o + 17 + 2 * i) = Bd[i][1];
        }
      }
      __syncwarp(gmask);
      const T w4r = pick4(w4, r);
      T gn = T(0);
#pragma unroll 1
      for (int k = N - 1; k >= 0; --k) {
        T x[4], up[2], m[2], u[2];
        Xk(k, x);
        Uk(k, up);
        const T v0 = Vk(k, 0), v1 = Vk(k, 1);
        const T s0 = up[0] + v0, s1 = up[1] + v1;
        m[0] = (dabs(s0) < c.u_b) ? T(1) : T(0);
        m[1] = (dabs(s1) < c.u_b) ? T(1) : T(0);
        u[0] = clip(s0, -c.u_b, c.u_b);
        u[1] = clip(s1, -c.u_b, c.u_b);
        T adc[4], Bm[4][2];   // column r of Ad; Bd m
        const int o = L::kJac + L::kJacStride * k;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          adc[i] = S(o + 4 * i + r);
          Bm[i][0] = S(o + 16 + 2 * i) * m[0];
          Bm[i][1] = S(o + 17 + 2 * i) * m[1];
        }

        // Stage cost quadratics (make_rmpc_ocp_du.cost_quad) and PHR rows.
        const T gu[2] = {T(2) * Ru * u[0] * m[0], T(2) * Ru * u[1] * m[1]};
        const T hu[2] = {T(2) * Ru * m[0], T(2) * Ru * m[1]};
        const T e4r = T(2) * w4r * (pick4(x, r) - S(L::kRef + 4 * k + r));
        const T lv[2] = {T(2) * Rdu * v0 + gu[0], T(2) * Rdu * v1 + gu[1]};
        T C[4], tc[4], act[4];
        con4(x, C);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tc[i] = nan_max(T(0), S(L::kLam + 4 * k + i) + mu * C[i]);
          act[i] = (tc[i] > T(0)) ? T(1) : T(0);
        }
        const T lxr = (r == 1) ? e4r + tc[0] - tc[1]
                      : (r == 3) ? e4r + tc[2] - tc[3] : e4r;
        const T dalr = (r == 1) ? mu * (act[0] + act[1])
                       : (r == 3) ? mu * (act[2] + act[3]) : T(0);

        T core[2], Qu2[2], Qvl[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          T acc = Bm[0][j] * vx4[0];
#pragma unroll
          for (int tt = 1; tt < 4; ++tt) acc = acc + Bm[tt][j] * vx4[tt];
          core[j] = acc + m[j] * vu2[j];
          Qu2[j] = gu[j] + core[j];
          Qvl[j] = lv[j] + core[j];
        }
        T Qxr;
        {
          T acc = adc[0] * vx4[0];
#pragma unroll
          for (int tt = 1; tt < 4; ++tt) acc = acc + adc[tt] * vx4[tt];
          Qxr = lxr + acc;
        }

        // W = P Bm + q*m (row r), gathered; S2 = Bm^T q + r*m.
        T Pr[4], Wr[2], W[4][2], q[4][2], S2[2][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) Pr[j] = pick4(P[j], r);   // P symmetric
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          T acc = Pr[0] * Bm[0][b];
#pragma unroll
          for (int tt = 1; tt < 4; ++tt) acc = acc + Pr[tt] * Bm[tt][b];
          Wr[b] = acc + qr[b] * m[b];
        }
        group_gather4(gmask, G, Wr, W);
        group_gather4(gmask, G, qr, q);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            T acc = Bm[0][a] * q[0][b];
#pragma unroll
            for (int tt = 1; tt < 4; ++tt) acc = acc + Bm[tt][a] * q[tt][b];
            S2[a][b] = acc + rr[a][b] * m[a];
          }
        }
        // Row r of T2 = (Ad^T P) Ad, of Qxx11 and of Qxx12 = Ad^T W; column r
        // of Qvz1 = W^T Ad. AdT[j] is column j of Ad, gathered.
        T AdT[4][4], T1r[4], Qxx11r[4], Qxx12r[2], Qvz1c[2];
        group_gather4(gmask, G, adc, AdT);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          T acc = adc[0] * P[0][j];
#pragma unroll
          for (int tt = 1; tt < 4; ++tt) acc = acc + adc[tt] * P[tt][j];
          T1r[j] = acc;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          T acc = T1r[0] * AdT[j][0];
#pragma unroll
          for (int tt = 1; tt < 4; ++tt) acc = acc + T1r[tt] * AdT[j][tt];
          Qxx11r[j] = (j == r) ? acc + (T(2) * w4r + dalr) : acc;
        }
        // Qvz1 = W^T Ad is Qxx12's transpose term for term, so column r of
        // Qvz1 is row r of Qxx12 bit for bit.
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          T acc = adc[0] * W[0][b];
#pragma unroll
          for (int tt = 1; tt < 4; ++tt) acc = acc + adc[tt] * W[tt][b];
          Qxx12r[b] = acc;
          Qvz1c[b] = acc;
        }
        T G2[2][2], Qvz2[2][2], Gv[2][2], Qvv[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            T acc = W[0][a] * Bm[0][b];
#pragma unroll
            for (int tt = 1; tt < 4; ++tt) acc = acc + W[tt][a] * Bm[tt][b];
            G2[a][b] = acc + S2[a][b] * m[b];
          }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            Qvz2[a][b] = (a == b) ? G2[a][b] + hu[a] : G2[a][b];
            Gv[a][b] = (a == b) ? G2[a][b] + (T(2) * Rdu + hu[a] + T(1e-8)) : G2[a][b];
          }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) Qvv[a][b] = T(0.5) * (Gv[a][b] + Gv[b][a]);

        T d0, d1, f0, f1;
        boxqp2_group(gmask, G, r, Qvv[0][0], Qvv[0][1], Qvv[1][1], Qvl[0], Qvl[1],
                     -c.du_b - v0, -c.du_b - v1, c.du_b - v0, c.du_b - v1, d0,
                     d1, f0, f1);
        const T gn_k = nan_max(dabs(d0), dabs(d1));
        gn = (k == N - 1) ? gn_k : nan_max(gn, gn_k);
        // Gains on the free set, as lanes.cuh's gains2 computes them: column
        // r of K1, and entry r (row r / 2, column r % 2) of K2, gathered.
        const T h00 = Qvv[0][0] * f0 * f0 + (T(1) - f0);
        const T h01 = Qvv[0][1] * f0 * f1;
        const T h11 = Qvv[1][1] * f1 * f1 + (T(1) - f1);
        const T deth = guard_tiny(h00 * h11 - h01 * h01);
        T k1c[2], k2m[2][2];
        {
          const T b0 = Qvz1c[0] * f0, b1 = Qvz1c[1] * f1;
          k1c[0] = -(h11 * b0 - h01 * b1) / deth;
          k1c[1] = -(-h01 * b0 + h00 * b1) / deth;
          const T c0 = (r & 1) ? Qvz2[0][1] : Qvz2[0][0];
          const T c1 = (r & 1) ? Qvz2[1][1] : Qvz2[1][0];
          const T e0 = c0 * f0, e1 = c1 * f1;
          const T num = (r < 2) ? h11 * e0 - h01 * e1 : -h01 * e0 + h00 * e1;
          const T k2r = -num / deth;
          k2m[0][0] = __shfl_sync(gmask, k2r, 0, G);
          k2m[0][1] = __shfl_sync(gmask, k2r, 1, G);
          k2m[1][0] = __shfl_sync(gmask, k2r, 2, G);
          k2m[1][1] = __shfl_sync(gmask, k2r, 3, G);
          S(L::kK1 + 8 * k + r) = k1c[0];
          S(L::kK1 + 8 * k + 4 + r) = k1c[1];
          S(L::kK2 + 4 * k + r) = k2r;
          if (r < 2) S(L::kD + 2 * k + r) = (r == 0) ? d0 : d1;
        }

        // Value update: row r of P and q, vx4[r]; vu2 and rr replicated.
        const T w2[2] = {Qvv[0][0] * d0 + Qvv[0][1] * d1 + Qvl[0],
                         Qvv[1][0] * d0 + Qvv[1][1] * d1 + Qvl[1]};
        const T vxr = Qxr + (k1c[0] * w2[0] + k1c[1] * w2[1])
                      + (Qvz1c[0] * d0 + Qvz1c[1] * d1);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          vu2[j] = Qu2[j] + (k2m[0][j] * w2[0] + k2m[1][j] * w2[1])
                   + (Qvz2[0][j] * d0 + Qvz2[1][j] * d1);
        const T K1Qr[2] = {k1c[0] * Qvv[0][0] + k1c[1] * Qvv[1][0],
                           k1c[0] * Qvv[0][1] + k1c[1] * Qvv[1][1]};
        const T kq[4] = {k1c[0], k1c[1], Qvz1c[0], Qvz1c[1]};
        T KQ[4][4];   // KQ[j] = {K1[0][j], K1[1][j], Qvz1[0][j], Qvz1[1][j]}
        group_gather4(gmask, G, kq, KQ);
        T Pnr[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T M1rj = k1c[0] * KQ[j][2] + k1c[1] * KQ[j][3];
          const T M1jr = KQ[j][0] * Qvz1c[0] + KQ[j][1] * Qvz1c[1];
          Pnr[j] = Qxx11r[j] + (K1Qr[0] * KQ[j][0] + K1Qr[1] * KQ[j][1]) + M1rj + M1jr;
        }
#pragma unroll
        for (int b = 0; b < 2; ++b)
          qr[b] = Qxx12r[b] + (K1Qr[0] * k2m[0][b] + K1Qr[1] * k2m[1][b])
                  + (k1c[0] * Qvz2[0][b] + k1c[1] * Qvz2[1][b])
                  + (Qvz1c[0] * k2m[0][b] + Qvz1c[1] * k2m[1][b]);
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
          for (int b = 0; b < 2; ++b) rr[a][b] = T(0.5) * (rn[a][b] + rn[b][a]);
        T Pn[4][4];
        group_gather4(gmask, G, Pnr, Pn);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = i; j < 4; ++j) {
            P[i][j] = T(0.5) * (Pn[i][j] + Pn[j][i]);
            P[j][i] = P[i][j];
          }
        T vxs[1] = {vxr}, vxg[4][1];
        group_gather4(gmask, G, vxs, vxg);
#pragma unroll
        for (int i = 0; i < 4; ++i) vx4[i] = vxg[i][0];
      }
      gnorm = gn;
      __syncwarp(gmask);

      // ---- forward line search, the alphas in parallel over the group ----
      bool accepted = done;   // done lanes never move
      T c_best = cost;
#pragma unroll 1
      for (int a0 = 0; a0 < n_alphas && !accepted; a0 += G) {
        const int ia = a0 + t;
        T c_new = T(0);
        bool ok = false;
        if (ia < n_alphas) {
          T al = c.alpha[0];   // c.alpha[ia], by selects: no local copy
#pragma unroll
          for (int i = 1; i < kMaxAlphas; ++i) al = (i == ia) ? c.alpha[i] : al;
          T xt[4] = {x0[0], x0[1], x0[2], x0[3]}, ut[2] = {up0[0], up0[1]};
#pragma unroll 1
          for (int k = 0; k < N; ++k) {
            T x[4], up[2], v[2], u[2], xn[4];
            Xk(k, x);
            Uk(k, up);
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              const int k1 = L::kK1 + 8 * k + 4 * a;
              T mv1 = S(k1) * (xt[0] - x[0]);
#pragma unroll
              for (int tt = 1; tt < 4; ++tt) mv1 = mv1 + S(k1 + tt) * (xt[tt] - x[tt]);
              const int k2 = L::kK2 + 4 * k + 2 * a;
              const T mv2 = S(k2) * (ut[0] - up[0]) + S(k2 + 1) * (ut[1] - up[1]);
              v[a] = clip(Vk(k, a) + al * S(L::kD + 2 * k + a) + mv1 + mv2,
                          -c.du_b, c.du_b);
            }
            c_new = c_new + stage_cost_al(xt, ut, v, k, mu);
            u[0] = clip(ut[0] + v[0], -c.u_b, c.u_b);
            u[1] = clip(ut[1] + v[1], -c.u_b, c.u_b);
            rk4(xt, u, xn);
            const int e = L::kTrial + t;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              S(e + (4 * k + i) * G) = xn[i];
              xt[i] = xn[i];
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              S(e + (L::kU + 2 * k + j) * G) = u[j];
              S(e + (L::kV + 2 * k + j) * G) = v[j];
              ut[j] = u[j];
            }
          }
          c_new = c_new + track(xt, N);
          ok = c_new < cost - T(1e-12);
        }
        const unsigned hit = (__ballot_sync(gmask, ok) >> gfirst) & ((1u << G) - 1u);
        if (hit != 0u) {
          const int win = __ffs(hit) - 1;
          accepted = true;
          c_best = __shfl_sync(gmask, c_new, win, G);
          __syncwarp(gmask);
#pragma unroll 1
          for (int e = t; e < L::kTraj; e += G)
            S(L::kCur + e) = S(L::kTrial + e * G + win);
          __syncwarp(gmask);
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
      T x[4], C[4];
      Xk(k, x);
      con4(x, C);
      T cm = nan_max(C[0], T(0));
#pragma unroll
      for (int i = 1; i < 4; ++i) cm = nan_max(cm, nan_max(C[i], T(0)));
      viol = nan_max(viol, cm);
      {
        T& lam = S(L::kLam + 4 * k + r);
        lam = nan_max(T(0), lam + mu * pick4(C, r));
      }
    }
    mu = (viol > c.tol_con) ? nan_min(mu * c.mu_scale, c.mu_max) : mu;
    __syncwarp(gmask);
  }

  // Raw (unpenalised) cost of the final iterate.
  T raw = T(0), x[4], up[2] = {up0[0], up0[1]};
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = x0[i];
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const T v0 = Vk(k, 0), v1 = Vk(k, 1);
    T u[2] = {clip(up[0] + v0, -c.u_b, c.u_b), clip(up[1] + v1, -c.u_b, c.u_b)};
    raw = raw + (track(x, k) + Ru * (u[0] * u[0] + u[1] * u[1])
                 + Rdu * (v0 * v0 + v1 * v1));
    T xn[4];
    rk4(x, u, xn);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = xn[i];
    up[0] = u[0];
    up[1] = u[1];
  }
  raw = raw + track(x, N);

#pragma unroll 1
  for (int e = t; e < 2 * N; e += G)
    V_out[static_cast<size_t>(e) * sB + lane] = S(L::kCur + L::kV + e);
  if (t == 0) {
    cost_out[lane] = raw;
    viol_out[lane] = viol;
    gnorm_out[lane] = gnorm;
  }
}

// Launch geometry of one instance: lanes and dynamic shared bytes per block.
template <typename T, int N>
struct Instance {
  static constexpr int kLanes = kThreads / G;
  static constexpr size_t kShared = sizeof(T) * kLanes * Layout<N>::kPerLane;

  // Raise the dynamic shared limit above the default 48 KB, once.
  static cudaError_t prepare() {
    static cudaError_t err = cudaFuncSetAttribute(
        rmpc_solve_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kShared));
    return err;
  }

  static int run(const T* th, const T* ref, const T* w, const T* z0, const T* V0,
                 T* V, T* cost, T* viol, T* gnorm, int B, int n_iters,
                 int n_alphas, int al_rounds, const Consts<T>& c,
                 cudaStream_t s) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((B + kLanes - 1) / kLanes);
    rmpc_solve_kernel<T, N><<<grid, kThreads, kShared, s>>>(
        th, ref, w, z0, V0, V, cost, viol, gnorm, B, n_iters, n_alphas,
        al_rounds, c);
    return static_cast<int>(cudaGetLastError());
  }

  static int geometry(int* threads, int* lanes, int* shared, int* blocks_per_sm) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    *threads = kThreads;
    *lanes = kLanes;
    *shared = static_cast<int>(kShared);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, rmpc_solve_kernel<T, N>, kThreads, kShared);
    return static_cast<int>(err);
  }
};

template <typename T>
int launch(const T* th, const T* ref, const T* w, const T* z0, const T* V0,
           T* V, T* cost, T* viol, T* gnorm, int B, int N, int n_iters,
           int n_alphas, int al_rounds, double dt, double u_bound,
           double du_bound, double vmax, double v_eps, double mu_init,
           double mu_scale, double mu_max, double tol_con, void* stream) {
  if (N != 6 && N != 20) return kBadShape;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 6)
    return Instance<T, 6>::run(th, ref, w, z0, V0, V, cost, viol, gnorm,
                                       B, n_iters, n_alphas, al_rounds, c, s);
  return Instance<T, 20>::run(th, ref, w, z0, V0, V, cost, viol, gnorm,
                                      B, n_iters, n_alphas, al_rounds, c, s);
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

// Threads and lanes per block, dynamic shared bytes per block and resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the
// instance a call with horizon N and element size itemsize (4 or 8) runs.
int rmpc_solve_geometry(int N, int itemsize, int* threads, int* lanes,
                        int* shared, int* blocks_per_sm) {
  if ((N != 6 && N != 20) || (itemsize != 4 && itemsize != 8)) return kBadShape;
  if (itemsize == 4)
    return N == 6 ? Instance<float, 6>::geometry(threads, lanes, shared, blocks_per_sm)
                  : Instance<float, 20>::geometry(threads, lanes, shared, blocks_per_sm);
  return N == 6 ? Instance<double, 6>::geometry(threads, lanes, shared, blocks_per_sm)
                : Instance<double, 20>::geometry(threads, lanes, shared, blocks_per_sm);
}

}  // extern "C"
