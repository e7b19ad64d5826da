// Per-lane device helpers shared by the kernels in this directory: one
// thread holds one scenario lane, and these functions are that thread's
// scalar algebra. They transcribe the lane helpers of
// dart_tpu/ops/pallas/riccati.py (_boxqp2_lanes, _gains_lanes, _mm,
// _rk4_jac_lanes) with the same operation order, so each kernel repeats its
// TPU kernel's arithmetic; the plain PyTorch versions are in
// dart_tpu_torch/ops/kernels/lanes.py.
//
// Every max, min and clip propagates NaN like jnp.maximum/jnp.clip, so a
// diverged lane reports NaN diagnostics instead of a plausible number.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace dart {

// Returned by the C entry points before any launch; every other nonzero
// code is a cudaError_t.
constexpr int kBadShape = -1;    // a horizon or state size with no instance
constexpr int kBadBudget = -2;   // an iteration budget the kernel refuses
constexpr int kMaxAlphas = 16;

__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ float dtanh(float x) { return tanhf(x); }
__device__ __forceinline__ double dtanh(double x) { return tanh(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi)
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return nan_min(nan_max(x, lo), hi);
}

template <typename T>
__device__ __forceinline__ T guard_tiny(T x) {
  return dabs(x) < T(1e-30) ? T(1e-30) : x;
}

// Exact 2x2 box QP, min 0.5 d'Q d + Qu'd over lo <= d <= hi
// (_boxqp2_lanes): the 9 active sets in (s0, s1) order, KKT tolerance
// 1e-9, strict `<` tie-break so the first of equal candidates wins, each
// candidate clipped after its objective is computed. Q = [[q00, q01],
// [q01, q11]]. f0/f1 come back 1 where the dimension is free.
template <typename T>
__device__ __forceinline__ void boxqp2(T q00, T q01, T q11, T Qu0, T Qu1,
                                       T lo0, T lo1, T hi0, T hi1,
                                       T& d0_out, T& d1_out,
                                       T& f0_out, T& f1_out) {
  const T tol = T(1e-9);
  const T det = guard_tiny(q00 * q11 - q01 * q01);
  T best_obj = T(0), bd0 = T(0), bd1 = T(0), bf0 = T(0), bf1 = T(0);
#pragma unroll
  for (int s0 = 0; s0 < 3; ++s0) {
#pragma unroll
    for (int s1 = 0; s1 < 3; ++s1) {
      const T c0 = (s0 == 1) ? lo0 : hi0;   // read only when s0 != 0
      const T c1 = (s1 == 1) ? lo1 : hi1;
      T d0, d1;
      if (s0 == 0 && s1 == 0) {
        d0 = -(q11 * Qu0 - q01 * Qu1) / det;
        d1 = -(-q01 * Qu0 + q00 * Qu1) / det;
      } else if (s0 == 0) {
        d1 = c1;
        d0 = -(Qu0 + q01 * d1) / nan_max(q00, T(1e-30));
      } else if (s1 == 0) {
        d0 = c0;
        d1 = -(Qu1 + q01 * d0) / nan_max(q11, T(1e-30));
      } else {
        d0 = c0;
        d1 = c1;
      }
      const T g0 = q00 * d0 + q01 * d1 + Qu0;
      const T g1 = q01 * d0 + q11 * d1 + Qu1;
      const bool ok0 = (s0 == 0) ? (d0 >= lo0 - tol && d0 <= hi0 + tol)
                     : (s0 == 1) ? (g0 >= -tol) : (g0 <= tol);
      const bool ok1 = (s1 == 0) ? (d1 >= lo1 - tol && d1 <= hi1 + tol)
                     : (s1 == 1) ? (g1 >= -tol) : (g1 <= tol);
      const T obj = T(0.5) * (d0 * g0 + d1 * g1) + T(0.5) * (Qu0 * d0 + Qu1 * d1);
      const T objm = (ok0 && ok1) ? obj : T(1e30);
      const T d0c = clip(d0, lo0, hi0);
      const T d1c = clip(d1, lo1, hi1);
      const T f0 = (s0 == 0) ? T(1) : T(0);
      const T f1 = (s1 == 0) ? T(1) : T(0);
      if ((s0 == 0 && s1 == 0) || objm < best_obj) {
        best_obj = objm;
        bd0 = d0c;
        bd1 = d1c;
        bf0 = f0;
        bf1 = f1;
      }
    }
  }
  d0_out = bd0;
  d1_out = bd1;
  f0_out = bf0;
  f1_out = bf1;
}

// Feedback gains on the free set (_gains_lanes): H k = -(b * free) with
// H = free*Q*free + diag(1 - free), for NC columns b = (B0[j], B1[j]).
// Divides by the guarded determinant, as the TPU kernels do.
template <typename T, int NC>
__device__ __forceinline__ void gains2(T q00, T q01, T q11, T f0, T f1,
                                       const T (&B0)[NC], const T (&B1)[NC],
                                       T (&k0)[NC], T (&k1)[NC]) {
  const T h00 = q00 * f0 * f0 + (T(1) - f0);
  const T h01 = q01 * f0 * f1;
  const T h11 = q11 * f1 * f1 + (T(1) - f1);
  const T deth = guard_tiny(h00 * h11 - h01 * h01);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const T b0 = B0[j] * f0;
    const T b1 = B1[j] * f1;
    k0[j] = -(h11 * b0 - h01 * b1) / deth;
    k1[j] = -(-h01 * b0 + h00 * b1) / deth;
  }
}

// c = a @ b for an (n,k) and a (k,m) matrix, each entry summed in the
// order t = 0..k-1 (_mm).
template <typename T, int NR, int NK, int NM>
__device__ __forceinline__ void mm(const T (&a)[NR][NK], const T (&b)[NK][NM],
                                   T (&c)[NR][NM]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) {
#pragma unroll
    for (int j = 0; j < NM; ++j) {
      T acc = a[i][0] * b[0][j];
#pragma unroll
      for (int t = 1; t < NK; ++t) acc = acc + a[i][t] * b[t][j];
      c[i][j] = acc;
    }
  }
}

// I + s*M (_scale_add_eye).
template <typename T, int NX>
__device__ __forceinline__ void scale_add_eye(const T (&M)[NX][NX], T s,
                                              T (&out)[NX][NX]) {
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j)
      out[i][j] = (i == j) ? s * M[i][j] + T(1) : s * M[i][j];
  }
}

// Step sizes of one RK4 step, each folded in double and rounded once, as
// the TPU kernels fold their python-float constants.
template <typename T>
struct RK4Consts {
  T half_dt;   // 0.5 * dt
  T dt;
  T dt6;       // dt / 6
};

// Exact (Ad, Bd) of one RK4 step by the chain rule through its four stages
// (_rk4_jac_lanes): f(x, u, xdot) is the model and jac(x, u, A, B) its
// continuous-time Jacobians.
template <typename T, int NX, int NU, typename F, typename J>
__device__ __forceinline__ void rk4_jac(F f, J jac, const T (&x)[NX],
                                        const T (&u)[NU],
                                        const RK4Consts<T>& c,
                                        T (&Ad)[NX][NX], T (&Bd)[NX][NU]) {
  T k[NX], x2[NX], x3[NX], x4[NX];
  f(x, u, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) x2[i] = x[i] + c.half_dt * k[i];
  f(x2, u, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) x3[i] = x[i] + c.half_dt * k[i];
  f(x3, u, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) x4[i] = x[i] + c.dt * k[i];

  T A1[NX][NX], B1[NX][NU], Aj[NX][NX], Bj[NX][NU];
  T E[NX][NX], Sx[NX][NX], Su[NX][NU], dkx[NX][NX], dku[NX][NU];
  jac(x, u, A1, B1);
  // Running sums S = A1 + 2 dk2 + 2 dk3 + dk4, accumulated in that order.
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) Sx[i][j] = A1[i][j];
#pragma unroll
    for (int j = 0; j < NU; ++j) Su[i][j] = B1[i][j];
  }
  // dk2x = A2 (I + dt/2 A1), dk2u = A2 (dt/2 B1) + B2
  jac(x2, u, Aj, Bj);
  scale_add_eye(A1, c.half_dt, E);
  mm(Aj, E, dkx);
  T sB[NX][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) sB[i][j] = c.half_dt * B1[i][j];
  mm(Aj, sB, dku);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) dku[i][j] = dku[i][j] + Bj[i][j];
#pragma unroll
    for (int j = 0; j < NX; ++j) Sx[i][j] = Sx[i][j] + T(2) * dkx[i][j];
#pragma unroll
    for (int j = 0; j < NU; ++j) Su[i][j] = Su[i][j] + T(2) * dku[i][j];
  }
  // dk3x = A3 (I + dt/2 dk2x), dk3u = A3 (dt/2 dk2u) + B3
  jac(x3, u, Aj, Bj);
  scale_add_eye(dkx, c.half_dt, E);
  mm(Aj, E, dkx);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) sB[i][j] = c.half_dt * dku[i][j];
  mm(Aj, sB, dku);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) dku[i][j] = dku[i][j] + Bj[i][j];
#pragma unroll
    for (int j = 0; j < NX; ++j) Sx[i][j] = Sx[i][j] + T(2) * dkx[i][j];
#pragma unroll
    for (int j = 0; j < NU; ++j) Su[i][j] = Su[i][j] + T(2) * dku[i][j];
  }
  // dk4x = A4 (I + dt dk3x), dk4u = A4 (dt dk3u) + B4
  jac(x4, u, Aj, Bj);
  scale_add_eye(dkx, c.dt, E);
  mm(Aj, E, dkx);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) sB[i][j] = c.dt * dku[i][j];
  mm(Aj, sB, dku);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) dku[i][j] = dku[i][j] + Bj[i][j];
#pragma unroll
    for (int j = 0; j < NX; ++j) Sx[i][j] = Sx[i][j] + dkx[i][j];
#pragma unroll
    for (int j = 0; j < NU; ++j) Su[i][j] = Su[i][j] + dku[i][j];
  }
  scale_add_eye(Sx, c.dt6, Ad);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) Bd[i][j] = c.dt6 * Su[i][j];
}

// ---------------------------------------------------------------------------
// Group-cooperative helpers: a lane held by a group of G threads (G a power
// of two, 4 <= G <= 32), thread r < 4 of the group owning row or column r of
// the lane's 4x4 algebra. `mask` names the group's threads in the warp and
// `width` is G, so a source index is relative to the group.
// ---------------------------------------------------------------------------

// a[i] for a runtime i in 0..3, by selects (a register array indexed at run
// time would go to local memory).
template <typename T>
__device__ __forceinline__ T pick4(const T (&a)[4], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : (i == 2 ? a[2] : a[3]));
}

// full[i][j] = own[j] of the group's thread i, for i = 0..3, in every
// thread of the group.
template <typename T, int M>
__device__ __forceinline__ void group_gather4(unsigned mask, int width,
                                              const T (&own)[M],
                                              T (&full)[4][M]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) full[i][j] = __shfl_sync(mask, own[j], i, width);
}

// boxqp2 over a group of 4 threads: thread r evaluates the candidates
// i = r, r + 4, r + 8 (i = 3 s0 + s1, boxqp2's order) with the same
// operations as boxqp2, the group gathers the 9 masked objectives, every
// thread takes the first minimum in boxqp2's order (candidate 0, then
// strict `<`), and the winner's clipped step comes from its thread. The
// result is boxqp2's, bit for bit, in every thread of the group; the warp
// issues three candidates' work instead of nine.
template <typename T>
__device__ __forceinline__ void boxqp2_group(unsigned mask, int width, int r,
                                             T q00, T q01, T q11, T Qu0, T Qu1,
                                             T lo0, T lo1, T hi0, T hi1,
                                             T& d0_out, T& d1_out,
                                             T& f0_out, T& f1_out) {
  const T tol = T(1e-9);
  const T det = guard_tiny(q00 * q11 - q01 * q01);
  T objm[3], d0c[3], d1c[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = r + 4 * j;             // only i < 9 is ever read
    const int s0 = i / 3, s1 = i % 3;
    const bool fr0 = (j < 2) && s0 == 0, fr1 = (j < 2) && s1 == 0;
    T d0 = (s0 == 1) ? lo0 : hi0;
    T d1 = (s1 == 1) ? lo1 : hi1;
    if (fr0) {
      const T num = fr1 ? q11 * Qu0 - q01 * Qu1 : Qu0 + q01 * d1;
      const T den = fr1 ? det : nan_max(q00, T(1e-30));
      d0 = -num / den;
    }
    if (fr1) {
      const T num = fr0 ? -q01 * Qu0 + q00 * Qu1 : Qu1 + q01 * d0;
      const T den = fr0 ? det : nan_max(q11, T(1e-30));
      d1 = -num / den;
    }
    const T g0 = q00 * d0 + q01 * d1 + Qu0;
    const T g1 = q01 * d0 + q11 * d1 + Qu1;
    const bool ok0 = fr0 ? (d0 >= lo0 - tol && d0 <= hi0 + tol)
                   : (s0 == 1) ? (g0 >= -tol) : (g0 <= tol);
    const bool ok1 = fr1 ? (d1 >= lo1 - tol && d1 <= hi1 + tol)
                   : (s1 == 1) ? (g1 >= -tol) : (g1 <= tol);
    const T obj = T(0.5) * (d0 * g0 + d1 * g1) + T(0.5) * (Qu0 * d0 + Qu1 * d1);
    objm[j] = (ok0 && ok1) ? obj : T(1e30);
    d0c[j] = clip(d0, lo0, hi0);
    d1c[j] = clip(d1, lo1, hi1);
  }
  int w = 0;
  T best = __shfl_sync(mask, objm[0], 0, width);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const T o = __shfl_sync(mask, objm[i / 4], i % 4, width);
    if (o < best) {
      best = o;
      w = i;
    }
  }
  const int slot = w / 4, src = w % 4;
  d0_out = __shfl_sync(mask, slot == 0 ? d0c[0] : (slot == 1 ? d0c[1] : d0c[2]), src, width);
  d1_out = __shfl_sync(mask, slot == 0 ? d1c[0] : (slot == 1 ? d1c[1] : d1c[2]), src, width);
  f0_out = (w / 3 == 0) ? T(1) : T(0);
  f1_out = (w % 3 == 0) ? T(1) : T(0);
}

// boxqp2 over a group of W threads (W a power of two, 4 <= W <= 32): thread
// r evaluates the candidates i = r, r + W, ... (i = 3 s0 + s1, boxqp2's
// order) with boxqp2's expressions, the divisions of a free dimension
// taken by selects rather than branches (a candidate without one divides
// and drops the quotient, and a slot whose candidates are all bound
// divides nothing), every thread takes the first minimum of the nine masked
// objectives in boxqp2's order, and the winner's clipped step comes from
// its thread. The result is boxqp2's in every thread of the group.
template <int W, typename T>
__device__ __forceinline__ void boxqp2_dealt(unsigned mask, int r, T q00, T q01,
                                             T q11, T Qu0, T Qu1, T lo0, T lo1,
                                             T hi0, T hi1, T& d0_out, T& d1_out,
                                             T& f0_out, T& f1_out) {
  constexpr int kSlots = (9 + W - 1) / W;
  const T tol = T(1e-9);
  const T det = guard_tiny(q00 * q11 - q01 * q01);
  T objm[kSlots], d0c[kSlots], d1c[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = (r + W * j < 9) ? r + W * j : 8;
    const int s0 = i / 3, s1 = i % 3;
    const bool fr0 = s0 == 0, fr1 = s1 == 0;
    const T c0 = (s0 == 1) ? lo0 : hi0;
    const T c1 = (s1 == 1) ? lo1 : hi1;
    T d0 = c0, d1 = c1;
    if (W * j <= 6) {   // some candidate of the slot has a free dimension
      const bool both = fr0 && fr1;
      const T x0 = -(both ? q11 * Qu0 - q01 * Qu1 : Qu0 + q01 * c1)
                   / (both ? det : nan_max(q00, T(1e-30)));
      const T x1 = -(both ? -q01 * Qu0 + q00 * Qu1 : Qu1 + q01 * c0)
                   / (both ? det : nan_max(q11, T(1e-30)));
      d0 = fr0 ? x0 : c0;
      d1 = fr1 ? x1 : c1;
    }
    const T g0 = q00 * d0 + q01 * d1 + Qu0;
    const T g1 = q01 * d0 + q11 * d1 + Qu1;
    const bool ok0 = fr0 ? (d0 >= lo0 - tol && d0 <= hi0 + tol)
                   : (s0 == 1) ? (g0 >= -tol) : (g0 <= tol);
    const bool ok1 = fr1 ? (d1 >= lo1 - tol && d1 <= hi1 + tol)
                   : (s1 == 1) ? (g1 >= -tol) : (g1 <= tol);
    const T obj = T(0.5) * (d0 * g0 + d1 * g1) + T(0.5) * (Qu0 * d0 + Qu1 * d1);
    objm[j] = (ok0 && ok1) ? obj : T(1e30);
    d0c[j] = clip(d0, lo0, hi0);
    d1c[j] = clip(d1, lo1, hi1);
  }
  int w = 0;
  T best = __shfl_sync(mask, objm[0], 0, W);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const T o = __shfl_sync(mask, objm[i / W], i % W, W);
    if (o < best) {
      best = o;
      w = i;
    }
  }
  const int slot = w / W, src = w % W;
  T s0v = d0c[0], s1v = d1c[0];
#pragma unroll
  for (int j = 1; j < kSlots; ++j) {
    s0v = (slot == j) ? d0c[j] : s0v;
    s1v = (slot == j) ? d1c[j] : s1v;
  }
  d0_out = __shfl_sync(mask, s0v, src, W);
  d1_out = __shfl_sync(mask, s1v, src, W);
  f0_out = (w / 3 == 0) ? T(1) : T(0);
  f1_out = (w % 3 == 0) ? T(1) : T(0);
}

// Row i and column j >= i of entry e of an NZ x NZ upper triangle in row
// order, by selects.
template <int NZ>
__device__ __forceinline__ void tri_ij(int e, int& i, int& j) {
  int row = 0, rem = e;
#pragma unroll
  for (int q = 0; q < NZ; ++q) {
    const bool next = rem >= NZ - row;
    rem = next ? rem - (NZ - row) : rem;
    row = next ? row + 1 : row;
  }
  i = row;
  j = row + rem;
}

// ---------------------------------------------------------------------------
// Block helpers: a lane's algebra split into independent 4-state blocks
// (the LMPC model's x and y axes).
// ---------------------------------------------------------------------------

// a * b rounded once and never fused into a neighbouring add. A dense
// kernel's a*b + 0*c is contracted to one FMA whose value is round(a*b);
// a kernel that skips the structural zero writes mul_rn(a, b) to keep it.
__device__ __forceinline__ float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
__device__ __forceinline__ double mul_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

// Exact (Ad, Bd) of one RK4 step of a 4-state, 1-input block by the chain
// rule of rk4_jac, for a continuous A whose rows 0 and 2 are the unit rows
// e_1 and e_3 (positions driven by velocities) and a B that is bg in row 1
// only: dk_1 = A_1, dk_s = A_s (I + h dk_{s-1}), dku_s = A_s (h dku_{s-1})
// + B, S = dk_1 + 2 dk_2 + 2 dk_3 + dk_4, Ad = I + dt/6 Sx, Bd = dt/6 Su.
// fj(x, xd, a1, a3) gives the model's xdot and rows 1 and 3 of A at x;
// jac(x, a1, a3) the rows alone. Each entry sums its products in rk4_jac's
// order with the unit rows' zeros skipped, which changes no value.
template <typename T, typename FJ, typename J>
__device__ __forceinline__ void rk4_jac4(FJ fj, J jac, const T (&x)[4], T bg,
                                         const RK4Consts<T>& c,
                                         T (&Ad)[4][4], T (&Bd)[4]) {
  T a1[4][4], a3[4][4], kd[4], xs[4];
  fj(x, kd, a1[0], a3[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) xs[i] = x[i] + c.half_dt * kd[i];
  fj(xs, kd, a1[1], a3[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) xs[i] = x[i] + c.half_dt * kd[i];
  fj(xs, kd, a1[2], a3[2]);
#pragma unroll
  for (int i = 0; i < 4; ++i) xs[i] = x[i] + c.dt * kd[i];
  jac(xs, a1[3], a3[3]);

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
  T du[4] = {T(0), bg, T(0), T(0)};
  T Su[4] = {T(0), bg, T(0), T(0)};
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    const T h = (s == 3) ? c.dt : c.half_dt;
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
    T sb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sb[i] = h * du[i];
    du[0] = sb[1];
    du[1] = a1[s][0] * sb[0] + a1[s][1] * sb[1] + a1[s][2] * sb[2] + a1[s][3] * sb[3] + bg;
    du[2] = sb[3];
    du[3] = a3[s][0] * sb[0] + a3[s][1] * sb[1] + a3[s][2] * sb[2] + a3[s][3] * sb[3];
#pragma unroll
    for (int i = 0; i < 4; ++i) Su[i] = (s < 3) ? Su[i] + T(2) * du[i] : Su[i] + du[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Ad[i][j] = (i == j) ? c.dt6 * Sx[j][i] + T(1) : c.dt6 * Sx[j][i];
    Bd[i] = c.dt6 * Su[i];
  }
}

}  // namespace dart
