// Batched box-DDP Riccati backward pass, one thread per scenario lane, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel dart_tpu/ops/pallas/riccati.py::_backward_kernel
// (riccati_backward_pallas) and computes what it computes, stage for stage:
// Qx/Qu, Qxx from the unregularised Vxx, Qux/Quu from Vxx + reg I, Quu
// symmetrised with a 1e-9 jitter, the exact 2x2 box QP over the control
// step (first of equal candidates wins), the feedback gains on the free set
// with the determinant guarded at 1e-30, and the symmetrised value update.
// The plain PyTorch version is
// dart_tpu_torch/ops/kernels/riccati.py::_backward_lanes.
//
// Layout: every array is batch-last, element (i, lane) at i * B + lane, so
// neighbouring threads touch neighbouring addresses and loads coalesce.
// The state size NZ is a template parameter (6: PMPC and the augmented
// RMPC state; 10: LMPC's augmented state); the horizon N is a runtime loop.
//
// What bounds it on this card, and what the design does about it:
// - It is memory-bound. Per lane and stage it reads 2 NZ^2 + 5 NZ + 8
//   values (A, B, the cost expansion, V) and writes 2 + 2 NZ (D, K): 110 in
//   and 14 out at NZ = 6, against ~2,500 FLOPs, so ~5 FLOPs per byte in
//   float32 where the card needs ~20 to be compute-bound. Each value is read
//   exactly once, coalesced; nothing is staged through shared memory
//   because nothing is reused across lanes.
// - The batch is small against the card: B = 4096 lanes are 4096 threads.
//   Blocks of 32 threads give 128 blocks, so every SM but four holds one
//   warp; with one warp per SM little memory latency is hidden. A later PR
//   could split a lane's stage work across a few threads to put more loads
//   in flight.
// - Vxx, Qxx and a stage's A stay per thread (3 NZ^2 values): in registers
//   at NZ = 6, partly in local memory at NZ = 10.
//
// Numerics: IEEE division, no --use_fast_math. nvcc's default FMA
// contraction is left on, so float32 results differ from the plain version
// by a few ulps per operation; chip_smoke.py states the tolerance. Max and
// clip propagate NaN (lanes.cuh).

#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

using namespace dart;

constexpr int kThreads = 32;

template <typename T, int NZ>
__global__ void __launch_bounds__(kThreads)
riccati_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ lx, const T* __restrict__ lu,
               const T* __restrict__ lxx, const T* __restrict__ lux,
               const T* __restrict__ luu, const T* __restrict__ gx,
               const T* __restrict__ gxx, const T* __restrict__ V,
               const T* __restrict__ reg_in, T* __restrict__ D,
               T* __restrict__ K, int B, int N, T lo0, T lo1, T hi0, T hi1) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t sB = static_cast<size_t>(B);
  auto at = [&](const T* p, size_t i) { return p[i * sB + lane]; };

  T Vx[NZ], Vxx[NZ][NZ];
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
    Vx[i] = at(gx, i);
#pragma unroll
    for (int j = 0; j < NZ; ++j) Vxx[i][j] = at(gxx, i * NZ + j);
  }
  const T reg = reg_in[lane];

#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    const size_t k_nn = static_cast<size_t>(k) * NZ * NZ;
    const size_t k_n2 = static_cast<size_t>(k) * NZ * 2;
    T Ak[NZ][NZ], Bk[NZ][2];
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
#pragma unroll
      for (int j = 0; j < NZ; ++j) Ak[i][j] = at(A, k_nn + i * NZ + j);
      Bk[i][0] = at(Bm, k_n2 + i * 2);
      Bk[i][1] = at(Bm, k_n2 + i * 2 + 1);
    }

    // Qx = lx + A^T Vx, Qu = lu + B^T Vx
    T Qx[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      T acc = Ak[0][i] * Vx[0];
#pragma unroll
      for (int t = 1; t < NZ; ++t) acc = acc + Ak[t][i] * Vx[t];
      Qx[i] = at(lx, static_cast<size_t>(k) * NZ + i) + acc;
    }
    T Qu[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      T acc = Bk[0][u] * Vx[0];
#pragma unroll
      for (int t = 1; t < NZ; ++t) acc = acc + Bk[t][u] * Vx[t];
      Qu[u] = at(lu, static_cast<size_t>(k) * 2 + u) + acc;
    }

    // Column j of Vxx A (m) and of (Vxx + reg I) A (mr), then column j of
    // Qxx = lxx + A^T (Vxx A) and Qux = lux + B^T ((Vxx + reg I) A).
    T Qxx[NZ][NZ], Qux[2][NZ];
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      T m[NZ], mr[NZ];
#pragma unroll
      for (int t = 0; t < NZ; ++t) {
        T acc = Vxx[t][0] * Ak[0][j];
        T accr = ((t == 0) ? Vxx[0][0] + reg : Vxx[t][0]) * Ak[0][j];
#pragma unroll
        for (int s = 1; s < NZ; ++s) {
          acc = acc + Vxx[t][s] * Ak[s][j];
          accr = accr + ((t == s) ? Vxx[t][s] + reg : Vxx[t][s]) * Ak[s][j];
        }
        m[t] = acc;
        mr[t] = accr;
      }
#pragma unroll
      for (int i = 0; i < NZ; ++i) {
        T acc = Ak[0][i] * m[0];
#pragma unroll
        for (int t = 1; t < NZ; ++t) acc = acc + Ak[t][i] * m[t];
        Qxx[i][j] = at(lxx, k_nn + i * NZ + j) + acc;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        T acc = Bk[0][u] * mr[0];
#pragma unroll
        for (int t = 1; t < NZ; ++t) acc = acc + Bk[t][u] * mr[t];
        Qux[u][j] = at(lux, k_n2 + u * NZ + j) + acc;
      }
    }
    // Quu = luu + B^T ((Vxx + reg I) B), symmetrised, + 1e-9 on the diagonal.
    T Quu[2][2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      T nr[NZ];
#pragma unroll
      for (int t = 0; t < NZ; ++t) {
        T acc = ((t == 0) ? Vxx[0][0] + reg : Vxx[t][0]) * Bk[0][w];
#pragma unroll
        for (int s = 1; s < NZ; ++s)
          acc = acc + ((t == s) ? Vxx[t][s] + reg : Vxx[t][s]) * Bk[s][w];
        nr[t] = acc;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        T acc = Bk[0][u] * nr[0];
#pragma unroll
        for (int t = 1; t < NZ; ++t) acc = acc + Bk[t][u] * nr[t];
        Quu[u][w] = at(luu, static_cast<size_t>(k) * 4 + u * 2 + w) + acc;
      }
    }
    const T q00 = T(0.5) * (Quu[0][0] + Quu[0][0]) + T(1e-9);
    const T q01 = T(0.5) * (Quu[0][1] + Quu[1][0]);
    const T q11 = T(0.5) * (Quu[1][1] + Quu[1][1]) + T(1e-9);

    const T v0 = at(V, static_cast<size_t>(k) * 2);
    const T v1 = at(V, static_cast<size_t>(k) * 2 + 1);
    T d0, d1, f0, f1;
    boxqp2(q00, q01, q11, Qu[0], Qu[1], lo0 - v0, lo1 - v1, hi0 - v0,
           hi1 - v1, d0, d1, f0, f1);
    T k0[NZ], k1[NZ];
    gains2<T, NZ>(q00, q01, q11, f0, f1, Qux[0], Qux[1], k0, k1);

    D[(static_cast<size_t>(k) * 2) * sB + lane] = d0;
    D[(static_cast<size_t>(k) * 2 + 1) * sB + lane] = d1;
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      K[(k_n2 + j) * sB + lane] = k0[j];
      K[(k_n2 + NZ + j) * sB + lane] = k1[j];
    }

    // Vx = Qx + K^T (Quu d) + K^T Qu + Qux^T d
    const T Qd0 = q00 * d0 + q01 * d1;
    const T Qd1 = q01 * d0 + q11 * d1;
#pragma unroll
    for (int i = 0; i < NZ; ++i)
      Vx[i] = Qx[i] + (k0[i] * Qd0 + k1[i] * Qd1) + (k0[i] * Qu[0] + k1[i] * Qu[1])
              + (Qux[0][i] * d0 + Qux[1][i] * d1);
    // Vxx = Qxx + (K^T Quu) K + K^T Qux + Qux^T K, then symmetrised.
    T kq0[NZ], kq1[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      kq0[i] = k0[i] * q00 + k1[i] * q01;
      kq1[i] = k0[i] * q01 + k1[i] * q11;
    }
    auto vxx_entry = [&](int i, int j) {
      return Qxx[i][j] + (kq0[i] * k0[j] + kq1[i] * k1[j])
             + (k0[i] * Qux[0][j] + k1[i] * Qux[1][j])
             + (Qux[0][i] * k0[j] + Qux[1][i] * k1[j]);
    };
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
#pragma unroll
      for (int j = i; j < NZ; ++j) {
        const T a = vxx_entry(i, j);
        const T s = T(0.5) * (a + ((i == j) ? a : vxx_entry(j, i)));
        Vxx[i][j] = s;
        Vxx[j][i] = s;
      }
    }
  }
}

template <typename T>
int launch(const T* A, const T* Bm, const T* lx, const T* lu, const T* lxx,
           const T* lux, const T* luu, const T* gx, const T* gxx, const T* V,
           const T* reg, T* D, T* K, int B, int N, int nz, double lo0,
           double lo1, double hi0, double hi1, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T l0 = static_cast<T>(lo0), l1 = static_cast<T>(lo1);
  const T h0 = static_cast<T>(hi0), h1 = static_cast<T>(hi1);
  switch (nz) {
    case 6:
      riccati_kernel<T, 6><<<grid, kThreads, 0, s>>>(
          A, Bm, lx, lu, lxx, lux, luu, gx, gxx, V, reg, D, K, B, N, l0, l1,
          h0, h1);
      break;
    case 10:
      riccati_kernel<T, 10><<<grid, kThreads, 0, s>>>(
          A, Bm, lx, lu, lxx, lux, luu, gx, gxx, V, reg, D, K, B, N, l0, l1,
          h0, h1);
      break;
    default:
      return kBadShape;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int riccati_f32(const float* A, const float* Bm, const float* lx,
                const float* lu, const float* lxx, const float* lux,
                const float* luu, const float* gx, const float* gxx,
                const float* V, const float* reg, float* D, float* K, int B,
                int N, int nz, double lo0, double lo1, double hi0, double hi1,
                void* stream) {
  return launch<float>(A, Bm, lx, lu, lxx, lux, luu, gx, gxx, V, reg, D, K, B,
                       N, nz, lo0, lo1, hi0, hi1, stream);
}

int riccati_f64(const double* A, const double* Bm, const double* lx,
                const double* lu, const double* lxx, const double* lux,
                const double* luu, const double* gx, const double* gxx,
                const double* V, const double* reg, double* D, double* K,
                int B, int N, int nz, double lo0, double lo1, double hi0,
                double hi1, void* stream) {
  return launch<double>(A, Bm, lx, lu, lxx, lux, luu, gx, gxx, V, reg, D, K,
                        B, N, nz, lo0, lo1, hi0, hi1, stream);
}

}  // extern "C"
