// Whole PMPC box-DDP solve, one thread per scenario lane, for Hopper (sm_90a).
//
// Replaces the TPU kernel dart_tpu/ops/pallas/pmpc_solve.py::_pmpc_kernel
// and computes what it computes, step for step: the sparse rollout
// x+ = Ad x + Sd c(u) from the 3 + 4 free entries of Ad/Sd, constant
// diagonal costs, a reg-free Riccati backward pass with an exact 2x2 box QP
// per stage and masked gains, the symmetric Vxx update from its 21 unique
// entries, and an alpha = 0.6^i line search with per-lane accept and done
// masks, for a fixed number of iterations. The plain PyTorch version of the
// same solve is dart_tpu_torch/ops/kernels/pmpc_solve.py::_solve_lanes.
//
// Layout: every array is batch-last, element (i, lane) at i * B + lane, so
// neighbouring threads touch neighbouring addresses and loads coalesce.
// The per-lane helpers (box QP, NaN-propagating max/min/clip) are in
// lanes.cuh, shared with riccati.cu and rmpc_solve.cu.
//
// What bounds it on this card, and what the design does about it:
// - Per-lane state is far larger than the register file. At N = 15 a lane
//   holds Z (16x6), V and D (15x2 each), K (15x2x6 = 180), Vxx (36) and the
//   line search's trial Z/V: about 460 values against 255 registers per
//   thread. The horizon-indexed arrays live in local memory (spills through
//   L1/L2). The design keeps only the 6x6 stage algebra in registers and
//   accepts the spills for now.
// - The card is mostly idle at the deployment batch: B = 4096 gives 32
//   blocks of 128 threads for 132 SMs, each thread a long serial chain of
//   dependent FP operations. Nothing here hides that latency yet.
// - The escalation front end (control/mpc.py) reads max(gnorm) on the host
//   after each round, so every control step syncs host and device.
// Later work: a warp-cooperative lane layout, more lanes per launch, and a
// device-side escalation under a CUDA graph.
//
// Two shortcuts that change no result: a lane that accepts an alpha skips
// the remaining trials (the TPU kernel computes and discards them), and a
// done lane skips the line search (its trials are never accepted). The
// backward pass runs for every lane, done or not, because gnorm is the
// last iteration's max |feedforward| for every lane.
//
// Numerics: precise sin/cos and IEEE division (no --use_fast_math). nvcc's
// default FMA contraction is left on, so float32 results differ from the
// plain version by a few ulps per operation; chip_smoke.py states the
// tolerance. Every max and clip propagates NaN like jnp.maximum/jnp.clip,
// so a diverged lane reports a NaN gnorm and the escalation sees it.

#include <cuda_runtime.h>

#include <cmath>

#include "lanes.cuh"

namespace {

using namespace dart;

constexpr int kThreads = 128;

template <typename T>
struct Consts {
  T inv_dt;   // 1 / dt
  T g;        // signed gravity
  T neg_g;    // -g
  T m2g;      // -2 g
  T u_lo;     // -u_bound
  T u_hi;     // +u_bound
  T alpha[kMaxAlphas];   // 0.6^i
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
pmpc_solve_kernel(const T* __restrict__ ad3, const T* __restrict__ sd4,
                  const T* __restrict__ wdiag, const T* __restrict__ rw_in,
                  const T* __restrict__ target, const T* __restrict__ z0_in,
                  const T* __restrict__ V0, T* __restrict__ V_out,
                  T* __restrict__ cost_out, T* __restrict__ gnorm_out, int B,
                  int n_iters, int n_alphas, const Consts<T> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t sB = static_cast<size_t>(B);
  auto at = [&](const T* p, int i) { return p[static_cast<size_t>(i) * sB + lane]; };

  const T a = at(ad3, 0), b = at(ad3, 1), g5 = at(ad3, 2);
  const T sg0 = at(sd4, 0), sg1 = at(sd4, 1), s44 = at(sd4, 2), s55 = at(sd4, 3);
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

  T Z[N + 1][6], V[N][2], D[N][2], K[N][2][6], Zt[N + 1][6], Vt[N][2];
#pragma unroll
  for (int i = 0; i < 6; ++i) Z[0][i] = at(z0_in, i);
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    V[k][0] = at(V0, 2 * k);
    V[k][1] = at(V0, 2 * k + 1);
  }

  // x+ = Ad x + Sd c(v), specialised to the sparsity.
  auto step = [&](const T* x, T v0, T v1, T* xn) {
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
  auto state_cost = [&](const T* x) {
    T s = T(0);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const T e = x[i] - tg[i];
      s = (i == 0) ? wd[0] * e * e : s + wd[i] * e * e;
    }
    return s;
  };
  auto stage_cost = [&](const T* x, T v0, T v1) {
    return state_cost(x) + rw * (v0 * v0 + v1 * v1);
  };

  T cost = T(0);
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    cost = cost + stage_cost(Z[k], V[k][0], V[k][1]);
    step(Z[k], V[k][0], V[k][1], Z[k + 1]);
  }
  cost = cost + state_cost(Z[N]);

  bool done = false;
  T gnorm = T(0);
#pragma unroll 1
  for (int it = 0; it < n_iters; ++it) {
    // ---- backward (reg-free: Quu is PD for this problem) ----
    T Vx[6], Vxx[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      Vx[i] = w2[i] * (Z[N][i] - tg[i]);
#pragma unroll
      for (int j = 0; j < 6; ++j) Vxx[i][j] = (i == j) ? w2[i] : T(0);
    }
    T gn = T(0);
#pragma unroll 1
    for (int k = N - 1; k >= 0; --k) {
      const T v0 = V[k][0], v1 = V[k][1];
      // B = Sd dc/du: col0 on rows (0,1,4,5), col1 on (2,3,4,5).
      const T gc0 = g * dcos(v0), gc1 = g * dcos(v1);
      const T m2g0 = c.m2g * v0, m2g1 = c.m2g * v1;
      const T p0 = gc0 * sg0, p1 = gc0 * sg1, p4 = m2g0 * s44, p5 = m2g0 * s5dt;
      const T q2 = gc1 * sg0, q3 = gc1 * sg1, q4 = m2g1 * s44, q5 = m2g1 * s5dt;
      T lx[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) lx[i] = w2[i] * (Z[k][i] - tg[i]);
      const T lu0 = T(2) * rw * v0, lu1 = T(2) * rw * v1;
      const T Qx[6] = {lx[0] + Vx[0], lx[1] + a * Vx[0] + b * Vx[1],
                       lx[2] + Vx[2], lx[3] + a * Vx[2] + b * Vx[3],
                       lx[4] + Vx[4], lx[5] + g5 * Vx[5]};
      const T Qu0 = lu0 + p0 * Vx[0] + p1 * Vx[1] + p4 * Vx[4] + p5 * Vx[5];
      const T Qu1 = lu1 + q2 * Vx[2] + q3 * Vx[3] + q4 * Vx[4] + q5 * Vx[5];
      // W = Vxx @ Ad: columns 0,2,4 are copies, 1,3,5 short FMAs.
      T W[6][6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        W[j][0] = Vxx[j][0];
        W[j][1] = a * Vxx[j][0] + b * Vxx[j][1];
        W[j][2] = Vxx[j][2];
        W[j][3] = a * Vxx[j][2] + b * Vxx[j][3];
        W[j][4] = Vxx[j][4];
        W[j][5] = g5 * Vxx[j][5];
      }
      // Qxx = 2 diag(w) + Ad^T W; Qux = B^T W.
      T Qxx[6][6], Qux[2][6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        Qxx[0][j] = W[0][j];
        Qxx[1][j] = a * W[0][j] + b * W[1][j];
        Qxx[2][j] = W[2][j];
        Qxx[3][j] = a * W[2][j] + b * W[3][j];
        Qxx[4][j] = W[4][j];
        Qxx[5][j] = g5 * W[5][j];
        Qux[0][j] = p0 * W[0][j] + p1 * W[1][j] + p4 * W[4][j] + p5 * W[5][j];
        Qux[1][j] = q2 * W[2][j] + q3 * W[3][j] + q4 * W[4][j] + q5 * W[5][j];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) Qxx[i][i] = Qxx[i][i] + w2[i];
      // Quu = B^T Vxx B through t0 = Vxx b0, t1 = Vxx b1.
      T t0[6], t1[4];
#pragma unroll
      for (int j = 0; j < 6; ++j)
        t0[j] = Vxx[j][0] * p0 + Vxx[j][1] * p1 + Vxx[j][4] * p4 + Vxx[j][5] * p5;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = jj + 2;
        t1[jj] = Vxx[j][2] * q2 + Vxx[j][3] * q3 + Vxx[j][4] * q4 + Vxx[j][5] * q5;
      }
      const T rdiag = T(2) * rw + T(1e-8);
      const T q00 = p0 * t0[0] + p1 * t0[1] + p4 * t0[4] + p5 * t0[5] + rdiag;
      const T q01 = q2 * t0[2] + q3 * t0[3] + q4 * t0[4] + q5 * t0[5];
      const T q11 = q2 * t1[0] + q3 * t1[1] + q4 * t1[2] + q5 * t1[3] + rdiag;
      T d0, d1, f0, f1;
      boxqp2(q00, q01, q11, Qu0, Qu1, c.u_lo - v0, c.u_lo - v1, c.u_hi - v0,
             c.u_hi - v1, d0, d1, f0, f1);
      const T gn_k = nan_max(dabs(d0), dabs(d1));
      gn = (k == N - 1) ? gn_k : nan_max(gn, gn_k);
      // Feedback gains on the free set.
      const T h00 = q00 * f0 * f0 + (T(1) - f0);
      const T h01 = q01 * f0 * f1;
      const T h11 = q11 * f1 * f1 + (T(1) - f1);
      const T ideth = T(1) / guard_tiny(h00 * h11 - h01 * h01);
      T k0[6], k1[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const T b0j = Qux[0][j] * f0;
        const T b1j = Qux[1][j] * f1;
        k0[j] = -(h11 * b0j - h01 * b1j) * ideth;
        k1[j] = -(-h01 * b0j + h00 * b1j) * ideth;
        K[k][0][j] = k0[j];
        K[k][1][j] = k1[j];
      }
      D[k][0] = d0;
      D[k][1] = d1;
      // Vx = Qx + K^T (Quu d + Qu) + Qux^T d
      const T r0 = q00 * d0 + q01 * d1 + Qu0;
      const T r1 = q01 * d0 + q11 * d1 + Qu1;
#pragma unroll
      for (int j = 0; j < 6; ++j)
        Vx[j] = Qx[j] + k0[j] * r0 + k1[j] * r1 + Qux[0][j] * d0 + Qux[1][j] * d1;
      // Vxx = Qxx + K^T Quu K + K^T Qux + (K^T Qux)^T from 21 entries.
      T kq0[6], kq1[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        kq0[j] = k0[j] * q00 + k1[j] * q01;
        kq1[j] = k0[j] * q01 + k1[j] * q11;
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) {
          const T s_ij = Qxx[i][j] + kq0[i] * k0[j] + kq1[i] * k1[j];
          const T m_ij = k0[i] * Qux[0][j] + k1[i] * Qux[1][j];
          const T m_ji = k0[j] * Qux[0][i] + k1[j] * Qux[1][i];
          const T v_ij = s_ij + m_ij + m_ji;
          Vxx[i][j] = v_ij;
          Vxx[j][i] = v_ij;
        }
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
#pragma unroll
      for (int i = 0; i < 6; ++i) Zt[0][i] = Z[0][i];
#pragma unroll 1
      for (int k = 0; k < N; ++k) {
        const T* x = Zt[k];
        T dx[6];
#pragma unroll
        for (int t = 0; t < 6; ++t) dx[t] = x[t] - Z[k][t];
        T mv0 = K[k][0][0] * dx[0], mv1 = K[k][1][0] * dx[0];
#pragma unroll
        for (int t = 1; t < 6; ++t) {
          mv0 = mv0 + K[k][0][t] * dx[t];
          mv1 = mv1 + K[k][1][t] * dx[t];
        }
        const T v0 = clip(V[k][0] + al * D[k][0] + mv0, c.u_lo, c.u_hi);
        const T v1 = clip(V[k][1] + al * D[k][1] + mv1, c.u_lo, c.u_hi);
        c_new = c_new + stage_cost(x, v0, v1);
        step(x, v0, v1, Zt[k + 1]);
        Vt[k][0] = v0;
        Vt[k][1] = v1;
      }
      c_new = c_new + state_cost(Zt[N]);
      if (c_new < cost - T(1e-12)) {
        accepted = true;
        c_best = c_new;
#pragma unroll 1
        for (int k = 0; k < N; ++k) {
          V[k][0] = Vt[k][0];
          V[k][1] = Vt[k][1];
#pragma unroll
          for (int i = 0; i < 6; ++i) Z[k + 1][i] = Zt[k + 1][i];
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

template <typename T>
int launch(const T* ad3, const T* sd4, const T* wdiag, const T* rw,
           const T* target, const T* z0, const T* V0, T* V, T* cost,
           T* gnorm, int B, int N, int n_iters, int n_alphas, double dt,
           double u_bound, double g, void* stream) {
  if (n_iters < 1 || n_alphas < 1 || n_alphas > kMaxAlphas) return kBadBudget;
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // Scalars are formed in double and rounded once to T, as the JAX kernel
  // folds its Python-float constants before they meet the lane arrays.
  Consts<T> c;
  c.inv_dt = static_cast<T>(1.0 / dt);
  c.g = static_cast<T>(g);
  c.neg_g = static_cast<T>(-g);
  c.m2g = static_cast<T>(-2.0 * g);
  c.u_lo = static_cast<T>(-u_bound);
  c.u_hi = static_cast<T>(u_bound);
  for (int i = 0; i < kMaxAlphas; ++i)
    c.alpha[i] = static_cast<T>(std::pow(0.6, i));
  const dim3 grid((B + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 15:
      pmpc_solve_kernel<T, 15><<<grid, kThreads, 0, s>>>(
          ad3, sd4, wdiag, rw, target, z0, V0, V, cost, gnorm, B, n_iters,
          n_alphas, c);
      break;
    default:
      return kBadShape;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pmpc_solve_f32(const float* ad3, const float* sd4, const float* wdiag,
                   const float* rw, const float* target, const float* z0,
                   const float* V0, float* V, float* cost, float* gnorm, int B,
                   int N, int n_iters, int n_alphas, double dt, double u_bound,
                   double g, void* stream) {
  return launch<float>(ad3, sd4, wdiag, rw, target, z0, V0, V, cost, gnorm, B,
                       N, n_iters, n_alphas, dt, u_bound, g, stream);
}

int pmpc_solve_f64(const double* ad3, const double* sd4, const double* wdiag,
                   const double* rw, const double* target, const double* z0,
                   const double* V0, double* V, double* cost, double* gnorm,
                   int B, int N, int n_iters, int n_alphas, double dt,
                   double u_bound, double g, void* stream) {
  return launch<double>(ad3, sd4, wdiag, rw, target, z0, V0, V, cost, gnorm,
                        B, N, n_iters, n_alphas, dt, u_bound, g, stream);
}

const char* dart_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
