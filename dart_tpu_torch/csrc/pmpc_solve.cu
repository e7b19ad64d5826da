// Whole PMPC box-DDP solve, structure guard included, one scenario lane
// per group of G = 8 threads, for Hopper (sm_90a).
//
// Replaces the TPU kernel dart_tpu/ops/pallas/pmpc_solve.py::_pmpc_kernel
// and computes what it computes, step for step: the sparse rollout
// x+ = Ad x + Sd c(u) from the 3 + 4 free entries of Ad/Sd, constant
// diagonal costs, a reg-free Riccati backward pass with an exact 2x2 box QP
// per stage and masked gains, the symmetric Vxx update from its 21 unique
// entries, and an alpha = 0.6^i line search with per-lane accept and done
// masks, for a fixed number of iterations. It also runs the wrapper's
// structure guard (ops/kernels/pmpc_solve.py::structure_residual; JAX's
// pmpc_solve.py:300-320): the lane's max |Ad - E(Ad)| and |Sd - E(Sd)| over
// all 72 entries of the dense operators, NaN-propagating, with E's Sd
// diagonal dt rounded once to T; a lane whose residual exceeds 1e-6 (a NaN
// residual does not) reports cost and gnorm +inf. The plain PyTorch
// version is dart_tpu_torch/ops/kernels/pmpc_solve.py::pmpc_solve_reference.
//
// Layout: every global array is batch-last, element (i, lane) at
// i * B + lane; Ad and Sd are dense (6, 6, B).
//
// What bounds it on this card, and what the design does about it:
// - It is compute-bound by count: ~19k FLOPs per lane at the 2x3 budget
//   (over the structural non-zeros, ops/kernels/pmpc_solve.py::work)
//   against ~0.6 KB of inputs and outputs. Tensor cores do not apply: the
//   algebra is a lane's own 6x6 and 2x2 products. But most of it is a chain
//   of dependent operations through the stages of each backward pass and
//   each trial, and with B = 4096 lanes the card holds few warps, so each
//   warp's chain sets the time (a launch at B = 512 takes four fifths of
//   its time at B = 4096; PERF.md, section 6), not the FP rate.
// - A lane per group of G = 8 threads, two-warp blocks of 8 lanes: B =
//   4096 is 512 blocks, ~7.8 warps per SM, on every SM (one thread per lane
//   in 128-thread blocks gave 32 blocks for 132 SMs; G = 4 was as fast at
//   B = 4096 and slower at B = 512). In the backward pass thread r < 6 owns
//   column r of W = Vxx Ad, Qxx, Qux and the gains, and Vx[r]; the ten
//   products of Quu = B^T Vxx B's two halves and its three entries, the box
//   QP's nine candidates (boxqp2_dealt: a free dimension's division by
//   selects, not branches) and the 21 unique entries of the new Vxx are
//   dealt round the group. B = Sd dc/du
//   of every stage depends on V only, so its cosines are taken for all
//   stages at once, a stage per thread, ahead of the recursion. Every
//   thread holds Vx, Qu, Quu, the box QP's step and free set and the cost
//   bit for bit, so the group branches alike; work for a runtime column is
//   indexed or selected, never branched on, and each section's stores come
//   after its loads. lmpc_solve.cu's split by axis does not carry over:
//   rows 4 and 5 of B take both controls, so the axes meet in every stage.
// - The horizon lives in dynamic shared memory, per lane: Z (N + 1 states),
//   V, D, K, the stages' B, the value Hessian and the stage's Qxx, Qux, the
//   halves of Quu and the new Vx, and G trial trajectories: 30 N + 106 +
//   8 G N values (1516 at N = 15: 6064 bytes in float, 12128 in double;
//   48512 and 97024 per block of 8 lanes, so launch() raises the instance's
//   dynamic shared limit once), nothing on the stack. Element
//   idx of the block's lane slot lw sits at idx * 8 + lw, so the lane
//   slots of a warp reading one element hit distinct banks.
// - The line search runs the alphas in parallel: thread a of the group
//   runs the trial with alpha 0.6^a (in chunks of G, in order, when
//   n_alphas > G) into its own slice, loading each stage's operands a stage
//   ahead, and the lane takes the smallest index whose cost passes c_new <
//   cost - 1e-12 (a ballot), which is the TPU kernel's first accepted alpha
//   in alpha order. The group then copies the winner's slice; __syncwarp
//   orders the trials' stores before the copy and the copy before the next
//   reads. Done lanes, and lanes that accepted in an earlier chunk, sit the
//   search out; the backward pass runs for every lane, because gnorm is the
//   last iteration's max |feed-forward| for every lane.
// - The guard's 72 deviations are read 9 per thread and reduced over the
//   group, so the wrapper launches no device work of its own.
// - Every thread runs to the end (a lane past the batch's end solves lane
//   B - 1 and writes nothing), so the warp is converged at each exchange
//   and its shuffles, ballots and __syncwarp name the whole warp.
// - The escalation front end (control/mpc.py) reads max(gnorm) on the host
//   after each round, so every control step syncs host and device.
//
// One launch per call, no atomics, no fallback.
//
// Numerics: precise sin/cos and IEEE division (no --use_fast_math).
// Constants the TPU kernel folds in python double (1/dt, -2g, 0.6^i) are
// folded on the host in double and rounded once. Each entry keeps the plain
// version's order of operations; nvcc's default FMA contraction is left on,
// so float32 results differ from the plain version by a few ulps per
// operation; chip_smoke.py states the tolerance. Every max and clip
// propagates NaN like jnp.maximum/jnp.clip, so a diverged lane reports a
// NaN gnorm and the escalation sees it.

#include <cuda_runtime.h>

#include <cmath>

#include "lanes.cuh"

namespace {

using namespace dart;

constexpr int G = 8;               // threads per lane
constexpr int LW = 8;              // lanes per block
constexpr int kThreads = G * LW;   // threads per block: two warps

template <typename T>
struct Consts {
  T inv_dt;   // 1 / dt
  T dt;       // E(Sd)'s diagonal
  T g;        // signed gravity
  T neg_g;    // -g
  T m2g;      // -2 g
  T u_lo;     // -u_bound
  T u_hi;     // +u_bound
  T alpha[kMaxAlphas];   // 0.6^i
};

// A lane's shared-memory arrays, as element offsets. Z[k][i] sits at
// 6 k + i for k = 0..N; a trajectory is Z[1..N] (6N) then V (2N), at kCur.
// Element e of the trial trajectory of thread a sits at kTrial + e * G + a.
template <int N>
struct Layout {
  static constexpr int kCur = 6;                   // Z[1][0]
  static constexpr int kTraj = 8 * N;
  static constexpr int kV = kCur + 6 * N;          // V[k][j] at kV + 2k + j
  static constexpr int kD = kCur + kTraj;          // D[k][j], N x 2
  static constexpr int kK = kD + 2 * N;            // K[k][u][j], N x 2 x 6
  static constexpr int kVxx = kK + 12 * N;         // Vxx[i][j], 6 x 6
  static constexpr int kQxx = kVxx + 36;           // this stage's Qxx[i][j]
  static constexpr int kQux = kQxx + 36;           // Qux[u][j], 2 x 6
  static constexpr int kT = kQux + 12;             // t0[0..5], t1[0..3]
  static constexpr int kVx = kT + 10;              // the new Vx
  static constexpr int kBc = kVx + 6;              // B's 8 entries, N x 8
  static constexpr int kTrial = kBc + 8 * N;
  static constexpr int kPerLane = kTrial + G * kTraj;
};

// a[i] for a runtime i, by selects (a register array indexed at run time
// would go to local memory).
template <typename T, int M>
__device__ __forceinline__ T pick(const T (&a)[M], int i) {
  T v = a[0];
#pragma unroll
  for (int m = 1; m < M; ++m) v = (i == m) ? a[m] : v;
  return v;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
pmpc_solve_kernel(const T* __restrict__ Ad, const T* __restrict__ Sd,
                  const T* __restrict__ wdiag, const T* __restrict__ rw_in,
                  const T* __restrict__ target, const T* __restrict__ z0_in,
                  const T* __restrict__ V0, T* __restrict__ V_out,
                  T* __restrict__ cost_out, T* __restrict__ gnorm_out, int B,
                  int n_iters, int n_alphas, const Consts<T> c) {
  using L = Layout<N>;
  const int tid = threadIdx.x;
  const int r = tid % G;           // column / entry owner, its alpha
  const int lw = tid / G;
  // Every thread of the block runs to the end (a lane past the batch's
  // end solves lane B - 1 and writes nothing), so the warp is converged at
  // each exchange and the exchanges name the whole warp.
  const int out_lane = blockIdx.x * LW + lw;
  const int lane = (out_lane < B) ? out_lane : B - 1;
  const int gfirst = tid % 32 - r;   // the group's first thread in its warp
  constexpr unsigned kFull = 0xffffffffu;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const base = reinterpret_cast<T*>(smem_raw) + lw;
  auto S = [&](int idx) -> T& { return base[idx * LW]; };

  const size_t sB = static_cast<size_t>(B);
  auto at = [&](const T* p, int i) { return p[static_cast<size_t>(i) * sB + lane]; };

  // The 7 free entries of Ad = blkdiag([[1, a], [0, b]] x2, diag(1, g5))
  // and Sd = dt-diagonal plus [[., s01], [0, s11]] x2, diag(s44, s55).
  const T a = at(Ad, 1), b = at(Ad, 7), g5 = at(Ad, 35);
  const T sg0 = at(Sd, 1), sg1 = at(Sd, 7), s44 = at(Sd, 28), s55 = at(Sd, 35);
  // Structure guard: entries e = r, r + G, ... of both operators against
  // their expectations (a slot past the end repeats entry 35), the max
  // over the group.
  T resid = T(0);
#pragma unroll
  for (int q = 0; q < (36 + G - 1) / G; ++q) {
    const int e = (r + G * q < 36) ? r + G * q : 35;
    const T ea = (e == 0 || e == 14 || e == 28) ? T(1)
               : (e == 1 || e == 15) ? a : (e == 7 || e == 21) ? b
               : (e == 35) ? g5 : T(0);
    const T es = (e == 0 || e == 14) ? c.dt
               : (e == 1 || e == 15) ? sg0 : (e == 7 || e == 21) ? sg1
               : (e == 28) ? s44 : (e == 35) ? s55 : T(0);
    const T dev = nan_max(dabs(at(Ad, e) - ea), dabs(at(Sd, e) - es));
    resid = (q == 0) ? dev : nan_max(resid, dev);
  }
  {
    T all = __shfl_sync(kFull, resid, 0, G);
#pragma unroll
    for (int t = 1; t < G; ++t) all = nan_max(all, __shfl_sync(kFull, resid, t, G));
    resid = all;
  }
  const bool bad = resid > T(1e-6);

  const T s5dt = s55 * c.inv_dt;
  const T g = c.g;
  const T rw = rw_in[lane];
  T wd[6], w2[6], tg[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    wd[i] = at(wdiag, i);
    w2[i] = T(2) * wd[i];
    tg[i] = at(target, i);
  }
#pragma unroll 1
  for (int e = r; e < 6; e += G) S(e) = at(z0_in, e);
#pragma unroll 1
  for (int e = r; e < 2 * N; e += G) S(L::kV + e) = at(V0, e);
  __syncwarp(kFull);

  // x+ = Ad x + Sd c(v), specialised to the sparsity.
  auto step = [&](const T (&x)[6], T v0, T v1, T (&xn)[6]) {
    const T s0 = dsin(v0), s1 = dsin(v1);
    const T w = c.neg_g * (v0 * v0 + v1 * v1);
    const T gs0 = g * s0, gs1 = g * s1;
    xn[0] = x[0] + a * x[1] + gs0 * sg0;
    xn[1] = b * x[1] + gs0 * sg1;
    xn[2] = x[2] + a * x[3] + gs1 * sg0;
    xn[3] = b * x[3] + gs1 * sg1;
    xn[4] = x[4] + s44 * w;
    xn[5] = g5 * x[5] + s5dt * w;
  };
  auto state_cost = [&](const T (&x)[6]) {
    T s = T(0);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const T e = x[i] - tg[i];
      s = (i == 0) ? wd[0] * e * e : s + wd[i] * e * e;
    }
    return s;
  };
  auto stage_cost = [&](const T (&x)[6], T v0, T v1) {
    return state_cost(x) + rw * (v0 * v0 + v1 * v1);
  };
  auto Zk = [&](int k, T (&x)[6]) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = S(6 * k + i);
  };

  // Rollout of V0 (every thread of the group; thread 0 stores Z).
  T cost = T(0);
  {
    T x[6];
    Zk(0, x);
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      const T v0 = S(L::kV + 2 * k), v1 = S(L::kV + 2 * k + 1);
      cost = cost + stage_cost(x, v0, v1);
      T xn[6];
      step(x, v0, v1, xn);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        if (r == 0) S(6 * (k + 1) + i) = xn[i];
        x[i] = xn[i];
      }
    }
    cost = cost + state_cost(x);
  }
  __syncwarp(kFull);

  bool done = false;
  T gnorm = T(0);
#pragma unroll 1
  for (int it = 0; it < n_iters; ++it) {
    // ---- backward (reg-free: Quu is PD for this problem) ----
    T Vx[6];
    {
      T xN[6];
      Zk(N, xN);
#pragma unroll
      for (int i = 0; i < 6; ++i) Vx[i] = w2[i] * (xN[i] - tg[i]);
    }
#pragma unroll
    for (int q = 0; q < (36 + G - 1) / G; ++q) {
      const int e = r + G * q;
      if (e < 36) S(L::kVxx + e) = (e % 7 == 0) ? pick(w2, e / 7) : T(0);
    }
    // B = Sd dc/du of every stage (col0 on rows (0,1,4,5), col1 on
    // (2,3,4,5)): it depends on V only, so the stages are dealt round the
    // group ahead of the recursion.
#pragma unroll 1
    for (int k = r; k < N; k += G) {
      const T v0 = S(L::kV + 2 * k), v1 = S(L::kV + 2 * k + 1);
      const T gc0 = g * dcos(v0), gc1 = g * dcos(v1);
      const T m2g0 = c.m2g * v0, m2g1 = c.m2g * v1;
      const T bk[8] = {gc0 * sg0, gc0 * sg1, m2g0 * s44, m2g0 * s5dt,
                       gc1 * sg0, gc1 * sg1, m2g1 * s44, m2g1 * s5dt};
#pragma unroll
      for (int i = 0; i < 8; ++i) S(L::kBc + 8 * k + i) = bk[i];
    }
    __syncwarp(kFull);
    T gn = T(0);
#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      const T v0 = S(L::kV + 2 * k), v1 = S(L::kV + 2 * k + 1);
      const int bc = L::kBc + 8 * k;
      const T p0 = S(bc), p1 = S(bc + 1), p4 = S(bc + 2), p5 = S(bc + 3);
      const T q2 = S(bc + 4), q3 = S(bc + 5), q4 = S(bc + 6), q5 = S(bc + 7);
      T lx[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) lx[i] = w2[i] * (S(6 * k + i) - tg[i]);
      const T lu0 = T(2) * rw * v0, lu1 = T(2) * rw * v1;
      const T Qx[6] = {lx[0] + Vx[0], lx[1] + a * Vx[0] + b * Vx[1],
                       lx[2] + Vx[2], lx[3] + a * Vx[2] + b * Vx[3],
                       lx[4] + Vx[4], lx[5] + g5 * Vx[5]};
      const T Qu0 = lu0 + p0 * Vx[0] + p1 * Vx[1] + p4 * Vx[4] + p5 * Vx[5];
      const T Qu1 = lu1 + q2 * Vx[2] + q3 * Vx[3] + q4 * Vx[4] + q5 * Vx[5];

      // Owned columns j: column j of W = Vxx Ad (columns 0, 2, 4 copies,
      // 1, 3 short FMAs, 5 scaled), of Qxx = 2 diag(w) + Ad^T W and of
      // Qux = B^T W; then the items of Quu = B^T Vxx B through t0 = Vxx b0
      // (6 rows) and t1 = Vxx b1 (rows 2..5): item it < 6 is t0[it], item
      // it >= 6 is t1 of row it - 4. A slot past the end repeats the last
      // column or item and is dropped; the stores come last, so the
      // section's loads can be issued ahead of its arithmetic.
      constexpr int kCols = (6 + G - 1) / G, kItems = (10 + G - 1) / G;
      T qux0[kCols], qux1[kCols], qxx[kCols][6], tv[kItems];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = (r + G * q < 6) ? r + G * q : 5;
        const int jm = (j > 0) ? j - 1 : j;
        T W[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const T x0 = S(L::kVxx + 6 * i + j), xm = S(L::kVxx + 6 * i + jm);
          W[i] = (j == 1 || j == 3) ? a * xm + b * x0 : ((j == 5) ? g5 * x0 : x0);
        }
        const T Qc[6] = {W[0], a * W[0] + b * W[1], W[2], a * W[2] + b * W[3],
                         W[4], g5 * W[5]};
#pragma unroll
        for (int i = 0; i < 6; ++i) qxx[q][i] = (i == j) ? Qc[i] + w2[i] : Qc[i];
        qux0[q] = p0 * W[0] + p1 * W[1] + p4 * W[4] + p5 * W[5];
        qux1[q] = q2 * W[2] + q3 * W[3] + q4 * W[4] + q5 * W[5];
      }
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        const int it = (r + G * q < 10) ? r + G * q : 9;
        const bool first = it < 6;
        const int row = first ? it : it - 4, c0 = first ? 0 : 2;
        const int o = L::kVxx + 6 * row;
        tv[q] = S(o + c0) * (first ? p0 : q2) + S(o + c0 + 1) * (first ? p1 : q3)
                + S(o + 4) * (first ? p4 : q4) + S(o + 5) * (first ? p5 : q5);
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = r + G * q;
        if (j < 6) {
#pragma unroll
          for (int i = 0; i < 6; ++i) S(L::kQxx + 6 * i + j) = qxx[q][i];
          S(L::kQux + j) = qux0[q];
          S(L::kQux + 6 + j) = qux1[q];
        }
      }
#pragma unroll
      for (int q = 0; q < kItems; ++q)
        if (r + G * q < 10) S(L::kT + r + G * q) = tv[q];
      __syncwarp(kFull);

      // q00 (thread 0), q01 (thread 1), q11 (threads 2, 3), shared.
      const T rdiag = T(2) * rw + T(1e-8);
      T qv;
      {
        const int i0 = (r == 0) ? 0 : ((r == 1) ? 2 : 6);
        const int i2 = (r >= 2) ? 8 : 4;
        const bool h0 = r == 0;
        const T sum = (h0 ? p0 : q2) * S(L::kT + i0)
                      + (h0 ? p1 : q3) * S(L::kT + i0 + 1)
                      + (h0 ? p4 : q4) * S(L::kT + i2)
                      + (h0 ? p5 : q5) * S(L::kT + i2 + 1);
        qv = (r == 1) ? sum : sum + rdiag;
      }
      const T q00 = __shfl_sync(kFull, qv, 0, G);
      const T q01 = __shfl_sync(kFull, qv, 1, G);
      const T q11 = __shfl_sync(kFull, qv, 2, G);
      T d0, d1, f0, f1;
      boxqp2_dealt<G>(kFull, r, q00, q01, q11, Qu0, Qu1, c.u_lo - v0,
                      c.u_lo - v1, c.u_hi - v0, c.u_hi - v1, d0, d1, f0, f1);
      const T gn_k = nan_max(dabs(d0), dabs(d1));
      gn = (k == N - 1) ? gn_k : nan_max(gn, gn_k);
      // Feedback gains on the free set, the owned columns.
      const T h00 = q00 * f0 * f0 + (T(1) - f0);
      const T h01 = q01 * f0 * f1;
      const T h11 = q11 * f1 * f1 + (T(1) - f1);
      const T ideth = T(1) / guard_tiny(h00 * h11 - h01 * h01);
      // Vx = Qx + K^T (Quu d + Qu) + Qux^T d
      const T r0 = q00 * d0 + q01 * d1 + Qu0;
      const T r1 = q01 * d0 + q11 * d1 + Qu1;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = r + G * q;
        if (j < 6) {
          const T b0j = qux0[q] * f0;
          const T b1j = qux1[q] * f1;
          const T k0 = -(h11 * b0j - h01 * b1j) * ideth;
          const T k1 = -(-h01 * b0j + h00 * b1j) * ideth;
          S(L::kK + 12 * k + j) = k0;
          S(L::kK + 12 * k + 6 + j) = k1;
          S(L::kVx + j) = pick(Qx, j) + k0 * r0 + k1 * r1 + qux0[q] * d0 + qux1[q] * d1;
        }
      }
      if (r < 2) S(L::kD + 2 * k + r) = (r == 0) ? d0 : d1;
      __syncwarp(kFull);

#pragma unroll
      for (int i = 0; i < 6; ++i) Vx[i] = S(L::kVx + i);
      // Vxx = Qxx + K^T Quu K + K^T Qux + (K^T Qux)^T from 21 entries
      // dealt round the group (a slot past the end repeats entry 20 and is
      // dropped); the stores come last.
      constexpr int kEntries = (21 + G - 1) / G;
      T vv[kEntries];
      int vi[kEntries], vj[kEntries];
#pragma unroll
      for (int q = 0; q < kEntries; ++q) {
        const int e = r + G * q;
        tri_ij<6>(e < 21 ? e : 20, vi[q], vj[q]);
        const int i = vi[q], j = vj[q];
        const int kk = L::kK + 12 * k;
        const T k0i = S(kk + i), k1i = S(kk + 6 + i);
        const T k0j = S(kk + j), k1j = S(kk + 6 + j);
        const T kq0 = k0i * q00 + k1i * q01;
        const T kq1 = k0i * q01 + k1i * q11;
        const T s_ij = S(L::kQxx + 6 * i + j) + kq0 * k0j + kq1 * k1j;
        const T m_ij = k0i * S(L::kQux + j) + k1i * S(L::kQux + 6 + j);
        const T m_ji = k0j * S(L::kQux + i) + k1j * S(L::kQux + 6 + i);
        vv[q] = s_ij + m_ij + m_ji;
      }
#pragma unroll
      for (int q = 0; q < kEntries; ++q) {
        if (r + G * q < 21) {
          S(L::kVxx + 6 * vi[q] + vj[q]) = vv[q];
          S(L::kVxx + 6 * vj[q] + vi[q]) = vv[q];
        }
      }
      __syncwarp(kFull);
    }
    gnorm = gn;

    // ---- forward line search, the alphas in parallel over the group ----
    // The chunks of G alphas run in step over the warp, while some group
    // of it still searches; a group that has accepted (or is done) sits
    // the later chunks out.
    bool accepted = done;   // done lanes never move
    T c_best = cost;
#pragma unroll 1
    for (int a0 = 0; a0 < n_alphas && !__all_sync(kFull, accepted); a0 += G) {
      const int ia = a0 + r;
      T c_new = T(0);
      bool ok = false;
      if (!accepted && ia < n_alphas) {
        T al = c.alpha[0];   // c.alpha[ia], by selects: no local copy
#pragma unroll
        for (int i = 1; i < kMaxAlphas; ++i) al = (i == ia) ? c.alpha[i] : al;
        T xt[6];
        Zk(0, xt);
        // Stage k's operands (Z[k], K[k], V[k], D[k]), loaded one stage
        // ahead so the loads do not wait behind the trial's stores.
        T zk[6], kk[12], vd[4];
        auto fetch = [&](int k) {
          const int kc = (k < N) ? k : N - 1;
#pragma unroll
          for (int t = 0; t < 6; ++t) zk[t] = S(6 * kc + t);
#pragma unroll
          for (int t = 0; t < 12; ++t) kk[t] = S(L::kK + 12 * kc + t);
          vd[0] = S(L::kV + 2 * kc);
          vd[1] = S(L::kV + 2 * kc + 1);
          vd[2] = S(L::kD + 2 * kc);
          vd[3] = S(L::kD + 2 * kc + 1);
        };
        fetch(0);
#pragma unroll 1
        for (int k = 0; k < N; ++k) {
          T dx[6];
#pragma unroll
          for (int t = 0; t < 6; ++t) dx[t] = xt[t] - zk[t];
          T mv0 = kk[0] * dx[0], mv1 = kk[6] * dx[0];
#pragma unroll
          for (int t = 1; t < 6; ++t) {
            mv0 = mv0 + kk[t] * dx[t];
            mv1 = mv1 + kk[6 + t] * dx[t];
          }
          const T v0 = clip(vd[0] + al * vd[2] + mv0, c.u_lo, c.u_hi);
          const T v1 = clip(vd[1] + al * vd[3] + mv1, c.u_lo, c.u_hi);
          fetch(k + 1);
          c_new = c_new + stage_cost(xt, v0, v1);
          T xn[6];
          step(xt, v0, v1, xn);
          const int e = L::kTrial + r;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            S(e + (6 * k + i) * G) = xn[i];
            xt[i] = xn[i];
          }
          S(e + (6 * N + 2 * k) * G) = v0;
          S(e + (6 * N + 2 * k + 1) * G) = v1;
        }
        c_new = c_new + state_cost(xt);
        ok = c_new < cost - T(1e-12);
      }
      const unsigned hit = (__ballot_sync(kFull, ok) >> gfirst) & ((1u << G) - 1u);
      const int win = (hit != 0u) ? __ffs(hit) - 1 : 0;
      const T c_win = __shfl_sync(kFull, c_new, win, G);
      __syncwarp(kFull);
      if (hit != 0u) {
        accepted = true;
        c_best = c_win;
#pragma unroll 1
        for (int e = r; e < L::kTraj; e += G)
          S(L::kCur + e) = S(L::kTrial + e * G + win);
      }
      __syncwarp(kFull);
    }
    const T rel = (cost - c_best) / (dabs(cost) + T(1));
    done = done || (accepted && rel < T(1e-9)) || !accepted;
    cost = c_best;
  }

  if (out_lane >= B) return;
#pragma unroll 1
  for (int e = r; e < 2 * N; e += G)
    V_out[static_cast<size_t>(e) * sB + lane] = S(L::kV + e);
  if (r == 0) {
    const T inf = T(INFINITY);
    cost_out[lane] = bad ? inf : cost;
    gnorm_out[lane] = bad ? inf : gnorm;
  }
}

// Launch geometry of one instance: lanes and dynamic shared bytes per block.
template <typename T, int N>
struct Instance {
  static constexpr size_t kShared = sizeof(T) * LW * Layout<N>::kPerLane;

  // Raise the dynamic shared limit above the default 48 KB, once.
  static cudaError_t prepare() {
    static cudaError_t err = cudaFuncSetAttribute(
        pmpc_solve_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kShared));
    return err;
  }

  static int run(const T* Ad, const T* Sd, const T* wdiag, const T* rw,
                 const T* target, const T* z0, const T* V0, T* V, T* cost,
                 T* gnorm, int B, int n_iters, int n_alphas,
                 const Consts<T>& c, cudaStream_t s) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((B + LW - 1) / LW);
    pmpc_solve_kernel<T, N><<<grid, kThreads, kShared, s>>>(
        Ad, Sd, wdiag, rw, target, z0, V0, V, cost, gnorm, B, n_iters,
        n_alphas, c);
    return static_cast<int>(cudaGetLastError());
  }

  static int geometry(int* threads, int* lanes, int* shared, int* blocks_per_sm) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    *threads = kThreads;
    *lanes = LW;
    *shared = static_cast<int>(kShared);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, pmpc_solve_kernel<T, N>, kThreads, kShared);
    return static_cast<int>(err);
  }
};

template <typename T>
int launch(const T* Ad, const T* Sd, const T* wdiag, const T* rw,
           const T* target, const T* z0, const T* V0, T* V, T* cost,
           T* gnorm, int B, int N, int n_iters, int n_alphas, double dt,
           double u_bound, double g, void* stream) {
  if (N != 15) return kBadShape;
  if (n_iters < 1 || n_alphas < 1 || n_alphas > kMaxAlphas) return kBadBudget;
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // Scalars are formed in double and rounded once to T, as the JAX kernel
  // folds its Python-float constants before they meet the lane arrays.
  Consts<T> c;
  c.inv_dt = static_cast<T>(1.0 / dt);
  c.dt = static_cast<T>(dt);
  c.g = static_cast<T>(g);
  c.neg_g = static_cast<T>(-g);
  c.m2g = static_cast<T>(-2.0 * g);
  c.u_lo = static_cast<T>(-u_bound);
  c.u_hi = static_cast<T>(u_bound);
  for (int i = 0; i < kMaxAlphas; ++i)
    c.alpha[i] = static_cast<T>(std::pow(0.6, i));
  return Instance<T, 15>::run(Ad, Sd, wdiag, rw, target, z0, V0, V, cost,
                              gnorm, B, n_iters, n_alphas, c,
                              static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int pmpc_solve_f32(const float* Ad, const float* Sd, const float* wdiag,
                   const float* rw, const float* target, const float* z0,
                   const float* V0, float* V, float* cost, float* gnorm, int B,
                   int N, int n_iters, int n_alphas, double dt, double u_bound,
                   double g, void* stream) {
  return launch<float>(Ad, Sd, wdiag, rw, target, z0, V0, V, cost, gnorm, B,
                       N, n_iters, n_alphas, dt, u_bound, g, stream);
}

int pmpc_solve_f64(const double* Ad, const double* Sd, const double* wdiag,
                   const double* rw, const double* target, const double* z0,
                   const double* V0, double* V, double* cost, double* gnorm,
                   int B, int N, int n_iters, int n_alphas, double dt,
                   double u_bound, double g, void* stream) {
  return launch<double>(Ad, Sd, wdiag, rw, target, z0, V0, V, cost, gnorm,
                        B, N, n_iters, n_alphas, dt, u_bound, g, stream);
}

// Threads and lanes per block, dynamic shared bytes per block and resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the
// instance a call with horizon N and element size itemsize (4 or 8) runs.
int pmpc_solve_geometry(int N, int itemsize, int* threads, int* lanes,
                        int* shared, int* blocks_per_sm) {
  if (N != 15 || (itemsize != 4 && itemsize != 8)) return kBadShape;
  return itemsize == 4
             ? Instance<float, 15>::geometry(threads, lanes, shared, blocks_per_sm)
             : Instance<double, 15>::geometry(threads, lanes, shared, blocks_per_sm);
}

const char* dart_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
