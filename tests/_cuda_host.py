"""Build a CUDA kernel source of `dart_tpu_torch/csrc/` for the host CPU.

A CUDA kernel runs only on the card, but its logic can be checked on the
host: the header below stands in for the CUDA runtime and the warp
primitives the kernels use, running one std::thread per CUDA thread of a
block, the blocks in turn. Each `__shfl_sync`, `__ballot_sync`,
`__all_sync` and `__syncwarp` goes through a barrier over the threads its
mask names (one barrier per warp and mask, so the masks of a lane's group,
of one of its axes and of a pair of threads may be in use at once), and
`__syncthreads` through a barrier over the block. Shared memory starts as
0xff bytes, so a read of an element no thread wrote is NaN. The
asynchronous copies of `<cuda_pipeline.h>` (`__pipeline_memcpy_async`,
`__pipeline_commit`, `__pipeline_wait_prior`) land at the wait that covers
them, never at issue, so a read of a copy's destination before that wait,
or another thread's read before a barrier after it, sees what the shared
memory held. The host compiler does not contract multiplies and adds.
Times from such a build mean nothing.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "dart_tpu_torch" / "csrc"

EMULATION = r"""
#pragma once
#include <condition_variable>
#include <cstring>
#include <map>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1) : x(a), y(1), z(1) {} };
struct U3 { unsigned x, y, z; };
inline thread_local U3 threadIdx, blockIdx;
inline U3 blockDim;
inline unsigned char* g_smem = nullptr;
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
struct GroupBarrier {
  std::mutex m; std::condition_variable cv; int count = 0, gen = 0;
  void wait(int n) {
    std::unique_lock<std::mutex> l(m);
    const int g = gen;
    if (++count == n) { count = 0; ++gen; cv.notify_all(); }
    else cv.wait(l, [&] { return gen != g; });
  }
};
inline std::mutex g_bar_lock;
inline std::map<unsigned long long, GroupBarrier> g_bar;
inline double g_slot[1024];
inline bool g_pred[1024];
inline void __syncwarp(unsigned mask) {
  GroupBarrier* b;
  {
    std::lock_guard<std::mutex> l(g_bar_lock);
    const unsigned long long warp = threadIdx.x / 32;
    b = &g_bar[(warp << 32) | mask];
  }
  b->wait(__builtin_popcount(mask));
}
template <class T> T __shfl_sync(unsigned mask, T v, int src, int width) {
  const int w = threadIdx.x / 32 * 32, l = threadIdx.x % 32;
  std::memcpy(&g_slot[w + l], &v, sizeof(T));
  __syncwarp(mask);
  T out;
  std::memcpy(&out, &g_slot[w + l / width * width + src], sizeof(T));
  __syncwarp(mask);
  return out;
}
inline unsigned __ballot_sync(unsigned mask, bool p) {
  const int w = threadIdx.x / 32 * 32;
  g_pred[w + threadIdx.x % 32] = p;
  __syncwarp(mask);
  unsigned out = 0;
  for (int i = 0; i < 32; ++i)
    if ((mask >> i) & 1u) out |= (g_pred[w + i] ? 1u : 0u) << i;
  __syncwarp(mask);
  return out;
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline bool __all_sync(unsigned mask, bool p) {
  return __ballot_sync(mask, p) == __ballot_sync(mask, true);
}
inline GroupBarrier g_block_bar;
inline void __syncthreads() { g_block_bar.wait(static_cast<int>(blockDim.x)); }
template <class F> void emulate_launch(dim3 grid, int threads, size_t shared, F f) {
  std::vector<unsigned char> smem(shared);
  blockDim = {static_cast<unsigned>(threads), 1, 1};
  for (unsigned b = 0; b < grid.x; ++b) {
    std::fill(smem.begin(), smem.end(), 0xff);   // stale shared memory: NaN
    g_smem = smem.data();
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        blockIdx = {b, 0, 0};
        f();
      });
    for (auto& th : ts) th.join();
  }
}
"""

# <cuda_pipeline.h>: each thread keeps its own copies, grouped by commit; a
# wait for all but the newest `prior` groups performs the older groups'
# copies then (zero-filling the last `zfill` bytes of each).
PIPELINE = r"""
#pragma once
#include <cstring>
#include <deque>
#include <vector>
struct PendingCopy { void* dst; const void* src; size_t size, zfill; };
inline thread_local std::vector<PendingCopy> g_pipe_open;
inline thread_local std::deque<std::vector<PendingCopy>> g_pipe_groups;
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t zfill = 0) {
  g_pipe_open.push_back({dst, src, size, zfill});
}
inline void __pipeline_commit() {
  g_pipe_groups.push_back(std::move(g_pipe_open));
  g_pipe_open.clear();
}
inline void __pipeline_wait_prior(size_t prior) {
  while (g_pipe_groups.size() > prior) {
    for (const PendingCopy& c : g_pipe_groups.front()) {
      std::memcpy(c.dst, c.src, c.size - c.zfill);
      std::memset(static_cast<char*>(c.dst) + c.size - c.zfill, 0, c.zfill);
    }
    g_pipe_groups.pop_front();
  }
}
"""

_SHARED = "extern __shared__ __align__(16) unsigned char smem_raw[];"
_LAUNCH = re.compile(
    r"(\w+_kernel<[^>]*>)<<<grid, kThreads, kShared, s>>>\(([^;]*)\);")


def build_host_library(src_name: str, out: Path) -> ctypes.CDLL | None:
    """`csrc/<src_name>` compiled for the host into `out`, its one kernel
    launch run through the emulation; None without a host C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    (out / "cuda_runtime.h").write_text(EMULATION)
    (out / "cuda_pipeline.h").write_text(PIPELINE)
    shutil.copy(CSRC / "lanes.cuh", out / "lanes.cuh")
    src = (CSRC / src_name).read_text()
    src, n_shared = re.subn(re.escape(_SHARED),
                            "unsigned char* smem_raw = g_smem;", src)
    src, n_launch = _LAUNCH.subn(
        r"emulate_launch(grid, kThreads, kShared, [&] { \1(\2); });", src)
    assert n_shared == 1 and n_launch == 1, "the kernel's launch changed"
    cpp = out / (Path(src_name).stem + ".cpp")
    cpp.write_text(src)
    lib_path = out / f"lib{Path(src_name).stem}_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", str(out), "-o",
                    str(lib_path), str(cpp)], check=True)
    return ctypes.CDLL(str(lib_path))
