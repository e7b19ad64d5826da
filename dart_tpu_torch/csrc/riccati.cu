// Batched box-DDP Riccati backward pass, one scenario lane per group of
// G = 8 threads, each stage's inputs staged in shared memory by
// asynchronous copies issued stages ahead, for Hopper (sm_90a).
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
// Layout: every global array is batch-last, element (i, lane) at
// i * B + lane. The state size NZ is a template parameter (6: PMPC and the
// augmented RMPC state; 10: LMPC's augmented state); the horizon N is a
// runtime loop.
//
// What bounds it on this card, and what the design does about it:
// - By its bytes it is memory-bound: per lane and stage it reads 2 NZ^2 +
//   5 NZ + 8 values (A, B, the cost expansion, V) and writes 2 + 2 NZ (D,
//   K), 110 in and 14 out at NZ = 6, against ~1,700 FLOPs: ~4 FLOPs per
//   byte in float32, where the card needs ~20 to be compute-bound. Tensor
//   cores do not apply: the algebra is a lane's own 2x2 ... 10x10 products.
// - So the bytes are taken off the stage's chain. A block holds LB = 8
//   lanes; its threads copy each stage's rows for the 8 lanes (a run of 8
//   values per row) into a ring of kStages stage tiles in shared memory
//   with cp.async (<cuda_pipeline.h>), kStages - 1 = 3 stages ahead of the
//   stage being computed (2 for NZ = 10 in double, whose deeper ring would
//   leave fewer than three blocks on an SM). Where every row starts 16-byte
//   aligned (B a multiple of 4 in float, 2 in double; the arrays aligned),
//   a copy moves 16 bytes and each thread's share of a stage is a fixed
//   list of copies whose addresses are formed once; otherwise (B = 37 gives
//   148-byte rows) a copy moves one element. Lanes past the batch's end
//   copy lane B - 1 and write nothing. TMA is not used: its row strides
//   must be multiples of 16 bytes, and the element path covers the rest.
// - What is left is each warp's chain of dependent instructions through a
//   stage: on the H100 a launch at B = 512 takes three quarters of its
//   time at B = 4096, and the copies have landed when a stage waits for them
//   (PERF.md, section 6). So a stage's work is spread over G = 8 threads per
//   lane: B = 4096 lanes are 512 two-warp blocks, ~7.8 warps per SM (one
//   thread per lane gave one warp per SM; G = 4 was a quarter slower at
//   NZ = 6 and half as fast at NZ = 10). Thread r owns column r (and r + 8) of
//   Vxx A, (Vxx + reg I) A, Qxx and Qux and the entries of K and Qx that
//   follow; the 2 NZ rows of (Vxx + reg I) B, the four entries of Quu, the
//   box QP's nine candidates (boxqp2_dealt: a free dimension's division by
//   selects, not branches) and the new Vxx's NZ (NZ + 1) / 2 unique
//   entries are dealt round the group. The
//   lane's Vxx, Qxx, Qux, K and the new Vx live in shared memory; every
//   thread holds Vx, Qu, Quu, the box QP's step and free set bit for bit,
//   so the group branches alike. Work for a runtime column or entry is
//   indexed, not branched on, each section's stores come after its loads,
//   and every thread runs every stage, so the warp is converged at each
//   exchange and its shuffles and __syncwarp name the whole warp.
// - D and K go to a small output tile in shared memory and leave at the
//   next stage as runs of 8 lanes per row.
// - No NZ^2 array is held per thread; ptxas still spills a few hundred
//   bytes at NZ = 10 (PERF.md, section 6).
//
// Numerics: IEEE division, no --use_fast_math. Every entry keeps the plain
// version's order of summation (sums over t = 0 .. NZ - 1, as _mm does),
// reg only on the diagonal of the Vxx that meets Qux and Quu, the 0.5 (Q +
// Q^T) symmetrisations and the 1e-9 jitter. nvcc's default FMA contraction
// is left on, so float32 results differ from the plain version by a few
// ulps per operation; chip_smoke.py states the tolerance. Max and clip
// propagate NaN (lanes.cuh).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "lanes.cuh"

namespace {

using namespace dart;

constexpr int G = 8;               // threads per lane
constexpr int LB = 8;              // lanes per block
constexpr int kThreads = G * LB;   // threads per block

// Rows of one stage's inputs, and of the per-lane scratch, as row offsets;
// row rho of lane slot l sits at rho * LB + l of its region.
template <int NZ>
struct Rows {
  static constexpr int kA = 0;                 // A[s][j] at s * NZ + j
  static constexpr int kB = kA + NZ * NZ;      // B[s][w] at s * 2 + w
  static constexpr int kLx = kB + 2 * NZ;
  static constexpr int kLu = kLx + NZ;
  static constexpr int kLxx = kLu + 2;
  static constexpr int kLux = kLxx + NZ * NZ;  // lux[u][j] at u * NZ + j
  static constexpr int kLuu = kLux + 2 * NZ;
  static constexpr int kV = kLuu + 4;
  static constexpr int kStage = kV + 2;        // 2 NZ^2 + 5 NZ + 8
  // Scratch: the value Hessian, this stage's Qxx, Qux, K, (Vxx + reg I) B
  // and the new Vx.
  static constexpr int kVxx = 0;
  static constexpr int kQxx = kVxx + NZ * NZ;
  static constexpr int kQux = kQxx + NZ * NZ;
  static constexpr int kK = kQux + 2 * NZ;
  static constexpr int kNr = kK + 2 * NZ;      // nr[w][t] at w * NZ + t
  static constexpr int kVx = kNr + 2 * NZ;
  static constexpr int kScratch = kVx + NZ;
  static constexpr int kOut = 2 + 2 * NZ;      // D, then K[u][j]
  // Per-thread slot counts: columns, (w, t) pairs, upper-triangle entries.
  static constexpr int kCols = (NZ + G - 1) / G;
  static constexpr int kPairs = (2 * NZ + G - 1) / G;
  static constexpr int kUnique = NZ * (NZ + 1) / 2;
  static constexpr int kTri = (kUnique + G - 1) / G;
};

// Stage k's rows [k NROWS, (k + 1) NROWS) of a batch-last array, for the
// block's LB lanes, into dst[row * LB + lane slot] by cp.async, one element
// per copy: element e = tid + kThreads q of the tile is row e / LB of lane
// slot tid % LB, which copies lane copy_lane (B - 1 past the batch's end).
// Used where the rows do not all start 16-byte aligned.
template <int NROWS, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int k,
                                          size_t sB, int tid, int copy_lane) {
  const size_t first = static_cast<size_t>(k) * NROWS;
#pragma unroll
  for (int q = 0; q < (NROWS * LB + kThreads - 1) / kThreads; ++q) {
    const int row = (tid + q * kThreads) / LB;
    if (row < NROWS)
      __pipeline_memcpy_async(dst + row * LB + tid % LB,
                              src + (first + row) * sB + copy_lane, sizeof(T));
  }
}

// The same rows of a batch-last (NROWS, B) array by plain loads.
template <int NROWS, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, size_t sB,
                                          int tid, int copy_lane) {
#pragma unroll
  for (int q = 0; q < (NROWS * LB + kThreads - 1) / kThreads; ++q) {
    const int row = (tid + q * kThreads) / LB;
    if (row < NROWS) dst[row * LB + tid % LB] = src[row * sB + copy_lane];
  }
}

template <typename T, int NZ, int S>
__global__ void __launch_bounds__(kThreads)
riccati_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ lx, const T* __restrict__ lu,
               const T* __restrict__ lxx, const T* __restrict__ lux,
               const T* __restrict__ luu, const T* __restrict__ gx,
               const T* __restrict__ gxx, const T* __restrict__ V,
               const T* __restrict__ reg_in, T* __restrict__ D,
               T* __restrict__ K, int B, int N, T lo0, T lo1, T hi0, T hi1,
               bool vec) {
  using R = Rows<NZ>;
  const int tid = threadIdx.x;
  const int r = tid % G;            // the thread's place in its group
  const int lw = tid / G;           // the group's lane slot in the block
  const int L0 = blockIdx.x * LB;
  // Every thread of the block runs every stage (a lane past the batch's
  // end computes on lane B - 1 and writes nothing), so the warp is
  // converged at each exchange and the exchanges name the whole warp.
  constexpr unsigned kFull = 0xffffffffu;
  const size_t sB = static_cast<size_t>(B);
  // The lane this thread copies and drains for (element e = tid +
  // kThreads q of a tile has lane slot tid % LB): past the batch's end,
  // lane B - 1.
  const int cl = tid % LB;
  const int copy_lane = (L0 + cl < B) ? L0 + cl : B - 1;
  // Where every row starts 16-byte aligned (vec: B a multiple of kVec =
  // 16 / sizeof(T), the arrays 16-byte aligned) a copy moves kVec lanes,
  // and each thread's share of a stage is fixed over the stages: item q is
  // chunk tid % C of stage row (tid + kThreads q) / C. The item keeps its
  // array's element for stage 0 and the array's rows per stage, so stage
  // k's copy is one multiply-add away. Past the batch's end a chunk copies
  // the last aligned one.
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int C = LB / kVec;
  constexpr int kItems = (R::kStage * C + kThreads - 1) / kThreads;
  const T* vsrc[kItems];
  int vrows[kItems], vdst[kItems];
  {
    const int chunk = L0 + (tid % C) * kVec;
    const int vl = (chunk < B - kVec) ? chunk : B - kVec;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int row = (tid + q * kThreads) / C;
      const T* src = A;
      int first = R::kA, n = NZ * NZ;
      if (row >= R::kB) { src = Bm; first = R::kB; n = 2 * NZ; }
      if (row >= R::kLx) { src = lx; first = R::kLx; n = NZ; }
      if (row >= R::kLu) { src = lu; first = R::kLu; n = 2; }
      if (row >= R::kLxx) { src = lxx; first = R::kLxx; n = NZ * NZ; }
      if (row >= R::kLux) { src = lux; first = R::kLux; n = 2 * NZ; }
      if (row >= R::kLuu) { src = luu; first = R::kLuu; n = 4; }
      if (row >= R::kV) { src = V; first = R::kV; n = 2; }
      vsrc[q] = src + static_cast<size_t>(row - first) * sB + vl;
      vrows[q] = n;
      vdst[q] = (row < R::kStage) ? row * LB + (tid % C) * kVec : -1;
    }
  }
  // Each thread's share of a stage's D and K rows, the same way: item q is
  // lane slot cl of output row (tid + kThreads q) / LB.
  constexpr int kOutItems = (R::kOut * LB + kThreads - 1) / kThreads;
  T* odst[kOutItems];
  int orows[kOutItems], osrc[kOutItems];
#pragma unroll
  for (int q = 0; q < kOutItems; ++q) {
    const int row = (tid + q * kThreads) / LB;
    odst[q] = (row < 2) ? D + static_cast<size_t>(row) * sB + L0 + cl
                        : K + static_cast<size_t>(row - 2) * sB + L0 + cl;
    orows[q] = (row < 2) ? 2 : 2 * NZ;
    osrc[q] = (row < R::kOut && L0 + cl < B) ? row * LB + cl : -1;
  }
  const int lane = L0 + lw;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);          // S stage tiles
  T* const scr = ring + S * R::kStage * LB;                 // scratch
  T* const outt = scr + R::kScratch * LB;                   // 2 output tiles

  // Stage k's inputs into ring slot k % S, one commit per call.
  auto issue = [&](int k) {
    if (k >= 0) {
      T* dst = ring + (k % S) * R::kStage * LB;
      if (vec) {
#pragma unroll
        for (int q = 0; q < kItems; ++q)
          if (vdst[q] >= 0)
            __pipeline_memcpy_async(
                dst + vdst[q], vsrc[q] + static_cast<size_t>(k * vrows[q]) * sB, 16);
      } else {
        copy_rows<NZ * NZ>(dst + R::kA * LB, A, k, sB, tid, copy_lane);
        copy_rows<2 * NZ>(dst + R::kB * LB, Bm, k, sB, tid, copy_lane);
        copy_rows<NZ>(dst + R::kLx * LB, lx, k, sB, tid, copy_lane);
        copy_rows<2>(dst + R::kLu * LB, lu, k, sB, tid, copy_lane);
        copy_rows<NZ * NZ>(dst + R::kLxx * LB, lxx, k, sB, tid, copy_lane);
        copy_rows<2 * NZ>(dst + R::kLux * LB, lux, k, sB, tid, copy_lane);
        copy_rows<4>(dst + R::kLuu * LB, luu, k, sB, tid, copy_lane);
        copy_rows<2>(dst + R::kV * LB, V, k, sB, tid, copy_lane);
      }
    }
    __pipeline_commit();
  };
  // Stage k's D and K, from output tile k % 2, to global memory.
  auto drain = [&](int k) {
    const T* src = outt + (k % 2) * R::kOut * LB;
#pragma unroll
    for (int q = 0; q < kOutItems; ++q)
      if (osrc[q] >= 0) odst[q][static_cast<size_t>(k * orows[q]) * sB] = src[osrc[q]];
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(N - 1 - s);

  // The value function at the horizon's end: Vxx into scratch, Vx through
  // the scratch's Vx rows; every thread then reads its lane's Vx.
  load_rows<NZ * NZ>(scr + R::kVxx * LB, gxx, sB, tid, copy_lane);
  load_rows<NZ>(scr + R::kVx * LB, gx, sB, tid, copy_lane);
  const T reg = reg_in[lane < B ? lane : B - 1];
  T* const sc = scr + lw;
  auto SC = [&](int row) -> T& { return sc[row * LB]; };
  __syncthreads();
  T Vx[NZ];
#pragma unroll
  for (int i = 0; i < NZ; ++i) Vx[i] = SC(R::kVx + i);
  // The thread's unique entries of Vxx, (vi, vj) with vi <= vj.
  int vi[R::kTri], vj[R::kTri];
#pragma unroll
  for (int q = 0; q < R::kTri; ++q)
    tri_ij<NZ>((r + G * q < R::kUnique) ? r + G * q : R::kUnique - 1, vi[q], vj[q]);

#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    // Stage k has landed once at most S - 2 newer groups are pending; the
    // barrier makes every thread's copies (and the last stage's Vxx and
    // output tile) visible to the block.
    __pipeline_wait_prior(S - 2);
    __syncthreads();
    if (k + 1 < N) drain(k + 1);
    issue(k - (S - 1));   // into the slot stage k + 1 left

    const T* const st = ring + (k % S) * R::kStage * LB + lw;
    auto IN = [&](int row) { return st[row * LB]; };
    T* const ot = outt + (k % 2) * R::kOut * LB + lw;

    // Qu[r & 1] = lu + B^T Vx; every thread computes one.
    T QuR;
    {
      const int u = r & 1;
      T acc = IN(R::kB + u) * Vx[0];
#pragma unroll
      for (int t = 1; t < NZ; ++t) acc = acc + IN(R::kB + 2 * t + u) * Vx[t];
      QuR = IN(R::kLu + u) + acc;
    }

    // Owned columns j: Qx[j], and column j of m = Vxx A, mr = (Vxx + reg I)
    // A, Qxx = lxx + A^T m and Qux = lux + B^T mr; then the pairs (w, t) of
    // nr[w][t] = row t of (Vxx + reg I) B[:, w], dealt round. Every slot is
    // computed (a column or pair past the end reads rows inside the tile
    // and is dropped) and the stores come last, so the loads of the whole
    // section can be issued ahead of its arithmetic.
    T qx[R::kCols], qux0[R::kCols], qux1[R::kCols], qxx[R::kCols][NZ];
#pragma unroll
    for (int q = 0; q < R::kCols; ++q) {
      const int j = r + G * q;
      T ac[NZ];   // column j of A
#pragma unroll
      for (int s = 0; s < NZ; ++s) ac[s] = IN(R::kA + s * NZ + j);
      {
        T acc = ac[0] * Vx[0];
#pragma unroll
        for (int t = 1; t < NZ; ++t) acc = acc + ac[t] * Vx[t];
        qx[q] = IN(R::kLx + j) + acc;
      }
      T m[NZ], mr[NZ];
#pragma unroll
      for (int t = 0; t < NZ; ++t) {
        const T v0 = SC(R::kVxx + t * NZ);
        T acc = v0 * ac[0];
        T accr = ((t == 0) ? v0 + reg : v0) * ac[0];
#pragma unroll
        for (int s = 1; s < NZ; ++s) {
          const T v = SC(R::kVxx + t * NZ + s);
          acc = acc + v * ac[s];
          accr = accr + ((t == s) ? v + reg : v) * ac[s];
        }
        m[t] = acc;
        mr[t] = accr;
      }
#pragma unroll
      for (int i = 0; i < NZ; ++i) {
        T acc = IN(R::kA + i) * m[0];
#pragma unroll
        for (int t = 1; t < NZ; ++t) acc = acc + IN(R::kA + t * NZ + i) * m[t];
        qxx[q][i] = IN(R::kLxx + i * NZ + j) + acc;
      }
      T qu[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        T acc = IN(R::kB + u) * mr[0];
#pragma unroll
        for (int t = 1; t < NZ; ++t) acc = acc + IN(R::kB + 2 * t + u) * mr[t];
        qu[u] = IN(R::kLux + u * NZ + j) + acc;
      }
      qux0[q] = qu[0];
      qux1[q] = qu[1];
    }
    T nr[R::kPairs];
#pragma unroll
    for (int q = 0; q < R::kPairs; ++q) {
      const int p = r + G * q;
      const int w = p / NZ, t = p % NZ;
      T acc = ((t == 0) ? SC(R::kVxx + t * NZ) + reg : SC(R::kVxx + t * NZ))
              * IN(R::kB + w);
#pragma unroll
      for (int s = 1; s < NZ; ++s) {
        const T v = SC(R::kVxx + t * NZ + s);
        acc = acc + ((t == s) ? v + reg : v) * IN(R::kB + 2 * s + w);
      }
      nr[q] = acc;
    }
#pragma unroll
    for (int q = 0; q < R::kCols; ++q) {
      const int j = r + G * q;
      if (j < NZ) {
#pragma unroll
        for (int i = 0; i < NZ; ++i) SC(R::kQxx + i * NZ + j) = qxx[q][i];
        SC(R::kQux + j) = qux0[q];
        SC(R::kQux + NZ + j) = qux1[q];
      }
    }
#pragma unroll
    for (int q = 0; q < R::kPairs; ++q)
      if (r + G * q < 2 * NZ) SC(R::kNr + r + G * q) = nr[q];
    __syncwarp(kFull);

    // Quu[u][w] = luu + B^T nr_w, entry r % 4 = (u, w) = (r / 2 % 2, r % 2).
    T quu;
    {
      const int u = r / 2 % 2, w = r % 2;
      T acc = IN(R::kB + u) * SC(R::kNr + w * NZ);
#pragma unroll
      for (int t = 1; t < NZ; ++t)
        acc = acc + IN(R::kB + 2 * t + u) * SC(R::kNr + w * NZ + t);
      quu = IN(R::kLuu + r % 4) + acc;
    }
    const T Qu0 = __shfl_sync(kFull, QuR, 0, G);
    const T Qu1 = __shfl_sync(kFull, QuR, 1, G);
    const T Quu00 = __shfl_sync(kFull, quu, 0, G);
    const T Quu01 = __shfl_sync(kFull, quu, 1, G);
    const T Quu10 = __shfl_sync(kFull, quu, 2, G);
    const T Quu11 = __shfl_sync(kFull, quu, 3, G);
    const T q00 = T(0.5) * (Quu00 + Quu00) + T(1e-9);
    const T q01 = T(0.5) * (Quu01 + Quu10);
    const T q11 = T(0.5) * (Quu11 + Quu11) + T(1e-9);

    const T v0 = IN(R::kV), v1 = IN(R::kV + 1);
    T d0, d1, f0, f1;
    boxqp2_dealt<G>(kFull, r, q00, q01, q11, Qu0, Qu1, lo0 - v0, lo1 - v1,
                    hi0 - v0, hi1 - v1, d0, d1, f0, f1);
    if (r < 2) ot[r * LB] = (r == 0) ? d0 : d1;

    // Gains on the free set (gains2) for the owned columns, and the new
    // Vx = Qx + K^T (Quu d) + K^T Qu + Qux^T d there.
    const T h00 = q00 * f0 * f0 + (T(1) - f0);
    const T h01 = q01 * f0 * f1;
    const T h11 = q11 * f1 * f1 + (T(1) - f1);
    const T deth = guard_tiny(h00 * h11 - h01 * h01);
    const T Qd0 = q00 * d0 + q01 * d1;
    const T Qd1 = q01 * d0 + q11 * d1;
#pragma unroll
    for (int q = 0; q < R::kCols; ++q) {
      const int j = r + G * q;
      if (j < NZ) {
        const T b0 = qux0[q] * f0;
        const T b1 = qux1[q] * f1;
        const T k0 = -(h11 * b0 - h01 * b1) / deth;
        const T k1 = -(-h01 * b0 + h00 * b1) / deth;
        SC(R::kK + j) = k0;
        SC(R::kK + NZ + j) = k1;
        ot[(2 + j) * LB] = k0;
        ot[(2 + NZ + j) * LB] = k1;
        SC(R::kVx + j) = qx[q] + (k0 * Qd0 + k1 * Qd1) + (k0 * Qu0 + k1 * Qu1)
                         + (qux0[q] * d0 + qux1[q] * d1);
      }
    }
    __syncwarp(kFull);

#pragma unroll
    for (int i = 0; i < NZ; ++i) Vx[i] = SC(R::kVx + i);
    // Vxx = Qxx + (K^T Quu) K + K^T Qux + Qux^T K, then symmetrised, over
    // the unique entries dealt round the group (a slot past the end
    // repeats the last entry and is dropped); the stores come last.
    T vs[R::kTri];
#pragma unroll
    for (int q = 0; q < R::kTri; ++q) {
      const int i = vi[q], j = vj[q];
      const T k0i = SC(R::kK + i), k1i = SC(R::kK + NZ + i);
      const T k0j = SC(R::kK + j), k1j = SC(R::kK + NZ + j);
      const T x0i = SC(R::kQux + i), x1i = SC(R::kQux + NZ + i);
      const T x0j = SC(R::kQux + j), x1j = SC(R::kQux + NZ + j);
      // (K^T Qux)[i][j] and [j][i]: each is a term of both entries.
      const T mij = k0i * x0j + k1i * x1j;
      const T mji = k0j * x0i + k1j * x1i;
      const T a = SC(R::kQxx + i * NZ + j)
                  + ((k0i * q00 + k1i * q01) * k0j + (k0i * q01 + k1i * q11) * k1j)
                  + mij + mji;
      const T b = SC(R::kQxx + j * NZ + i)
                  + ((k0j * q00 + k1j * q01) * k0i + (k0j * q01 + k1j * q11) * k1i)
                  + mji + mij;
      vs[q] = T(0.5) * (a + ((i == j) ? a : b));
    }
#pragma unroll
    for (int q = 0; q < R::kTri; ++q) {
      if (r + G * q < R::kUnique) {
        SC(R::kVxx + vi[q] * NZ + vj[q]) = vs[q];
        SC(R::kVxx + vj[q] * NZ + vi[q]) = vs[q];
      }
    }
  }
  __syncthreads();
  drain(0);
}

// Launch geometry of one instance: the stage ring's depth, dynamic shared
// bytes per block.
template <typename T, int NZ>
struct Instance {
  // Three stages in flight, two where a deeper ring would keep fewer than
  // three blocks on an SM (NZ = 10 in double).
  static constexpr int kStages =
      (sizeof(T) * LB * (4 * Rows<NZ>::kStage + Rows<NZ>::kScratch
                         + 2 * Rows<NZ>::kOut) > 72 * 1024) ? 3 : 4;
  static constexpr size_t kShared =
      sizeof(T) * LB * (kStages * Rows<NZ>::kStage + Rows<NZ>::kScratch
                        + 2 * Rows<NZ>::kOut);

  // Raise the dynamic shared limit above the default 48 KB, once.
  static cudaError_t prepare() {
    static cudaError_t err = cudaFuncSetAttribute(
        riccati_kernel<T, NZ, kStages>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kShared));
    return err;
  }

  static int run(const T* A, const T* Bm, const T* lx, const T* lu,
                 const T* lxx, const T* lux, const T* luu, const T* gx,
                 const T* gxx, const T* V, const T* reg, T* D, T* K, int B,
                 int N, T lo0, T lo1, T hi0, T hi1, cudaStream_t s) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    // 16-byte copies where every stage input's rows start 16-byte aligned.
    std::uintptr_t addr = 0;
    for (const T* p : {A, Bm, lx, lu, lxx, lux, luu, V})
      addr |= reinterpret_cast<std::uintptr_t>(p);
    const bool vec = B % (16 / static_cast<int>(sizeof(T))) == 0 && addr % 16 == 0;
    const dim3 grid((B + LB - 1) / LB);
    riccati_kernel<T, NZ, kStages><<<grid, kThreads, kShared, s>>>(
        A, Bm, lx, lu, lxx, lux, luu, gx, gxx, V, reg, D, K, B, N, lo0, lo1,
        hi0, hi1, vec);
    return static_cast<int>(cudaGetLastError());
  }

  static int geometry(int* threads, int* lanes, int* shared, int* blocks_per_sm) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return static_cast<int>(err);
    *threads = kThreads;
    *lanes = LB;
    *shared = static_cast<int>(kShared);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, riccati_kernel<T, NZ, kStages>, kThreads, kShared);
    return static_cast<int>(err);
  }
};

template <typename T>
int launch(const T* A, const T* Bm, const T* lx, const T* lu, const T* lxx,
           const T* lux, const T* luu, const T* gx, const T* gxx, const T* V,
           const T* reg, T* D, T* K, int B, int N, int nz, double lo0,
           double lo1, double hi0, double hi1, void* stream) {
  if (nz != 6 && nz != 10) return kBadShape;
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T l0 = static_cast<T>(lo0), l1 = static_cast<T>(lo1);
  const T h0 = static_cast<T>(hi0), h1 = static_cast<T>(hi1);
  if (nz == 6)
    return Instance<T, 6>::run(A, Bm, lx, lu, lxx, lux, luu, gx, gxx, V, reg,
                               D, K, B, N, l0, l1, h0, h1, s);
  return Instance<T, 10>::run(A, Bm, lx, lu, lxx, lux, luu, gx, gxx, V, reg,
                              D, K, B, N, l0, l1, h0, h1, s);
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

// Threads and lanes per block, dynamic shared bytes per block and resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the
// instance a call with state size nz and element size itemsize (4 or 8)
// runs.
int riccati_geometry(int nz, int itemsize, int* threads, int* lanes,
                     int* shared, int* blocks_per_sm) {
  if ((nz != 6 && nz != 10) || (itemsize != 4 && itemsize != 8)) return kBadShape;
  if (itemsize == 4)
    return nz == 6 ? Instance<float, 6>::geometry(threads, lanes, shared, blocks_per_sm)
                   : Instance<float, 10>::geometry(threads, lanes, shared, blocks_per_sm);
  return nz == 6 ? Instance<double, 6>::geometry(threads, lanes, shared, blocks_per_sm)
                 : Instance<double, 10>::geometry(threads, lanes, shared, blocks_per_sm);
}

}  // extern "C"
