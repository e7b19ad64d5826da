"""The CUDA source of the RMPC solve, `dart_tpu_torch/csrc/rmpc_solve.cu`,
compiled for the host CPU and held to its plain version
`rmpc_solve_reference`.

A CUDA kernel runs only on the card, but its logic can be checked here: a
small header (below) stands in for the CUDA runtime and the warp
primitives the kernel uses, running one std::thread per CUDA thread of a
block, the blocks in turn, and each `__shfl_sync`, `__ballot_sync` and
`__syncwarp` through a barrier over the group of threads its mask names.
So the kernel's own code decides which thread owns which row, what the
group exchanges, how the box QP's candidates are shared, which alpha the
parallel line search takes and how the ragged edge of the batch is masked.
The host compiler does not contract multiplies and adds, so float64 agrees
with the plain version to a few ulps. Times mean nothing here; the card's
comparison is `chip_smoke.py rmpc`."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dart_tpu_torch.ops.kernels import rmpc_solve as trs

CSRC = Path(trs.__file__).resolve().parents[2] / "csrc"
KW = dict(dt=0.002, u_bound=0.4, du_bound=0.05, vmax=0.25, v_eps=0.1,
          mu_init=10.0, mu_scale=10.0, mu_max=1e8, tol_con=1e-8)

EMULATION = r"""
#pragma once
#include <condition_variable>
#include <cstring>
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
struct GroupBarrier {
  std::mutex m; std::condition_variable cv; int count = 0, gen = 0;
  void wait(int n) {
    std::unique_lock<std::mutex> l(m);
    const int g = gen;
    if (++count == n) { count = 0; ++gen; cv.notify_all(); }
    else cv.wait(l, [&] { return gen != g; });
  }
};
inline GroupBarrier g_bar[32];
inline double g_slot[32];
inline bool g_pred[32];
inline void __syncwarp(unsigned mask) {
  g_bar[__builtin_ctz(mask)].wait(__builtin_popcount(mask));
}
template <class T> T __shfl_sync(unsigned mask, T v, int src, int width) {
  const int l = threadIdx.x % 32;
  std::memcpy(&g_slot[l], &v, sizeof(T));
  __syncwarp(mask);
  T out;
  std::memcpy(&out, &g_slot[l / width * width + src], sizeof(T));
  __syncwarp(mask);
  return out;
}
inline unsigned __ballot_sync(unsigned mask, bool p) {
  g_pred[threadIdx.x % 32] = p;
  __syncwarp(mask);
  unsigned out = 0;
  for (int i = 0; i < 32; ++i)
    if ((mask >> i) & 1u) out |= (g_pred[i] ? 1u : 0u) << i;
  __syncwarp(mask);
  return out;
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
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


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built for the host, its entry points typed."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel source")
    out = tmp_path_factory.mktemp("rmpc_kernel_source")
    (out / "cuda_runtime.h").write_text(EMULATION)
    shutil.copy(CSRC / "lanes.cuh", out / "lanes.cuh")
    src = (CSRC / "rmpc_solve.cu").read_text()
    src, n_shared = re.subn(
        r"extern __shared__ __align__\(16\) unsigned char smem_raw\[\];",
        "unsigned char* smem_raw = g_smem;", src)
    src, n_launch = re.subn(
        r"(rmpc_solve_kernel<T, N>)<<<grid, kThreads, kShared, s>>>\(([^;]*)\);",
        r"emulate_launch(grid, kThreads, kShared, [&] { \1(\2); });", src)
    assert n_shared == 1 and n_launch == 1, "the kernel's launch changed"
    (out / "rmpc_solve.cpp").write_text(src)
    lib_path = out / "librmpc_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", str(out), "-o",
                    str(lib_path), str(out / "rmpc_solve.cpp")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("rmpc_solve_f32", "rmpc_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_double] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _run(lib, args, budget):
    V0 = args[-1]
    N, _, Bt = V0.shape
    V = torch.empty_like(V0)
    outs = [torch.empty(Bt, dtype=V0.dtype) for _ in range(3)]
    fn = lib.rmpc_solve_f32 if V0.dtype == torch.float32 else lib.rmpc_solve_f64
    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (*args, V, *outs)),
             Bt, N, budget[0], budget[1], budget[2],
             *(float(KW[k]) for k in ("dt", "u_bound", "du_bound", "vmax",
                                      "v_eps", "mu_init", "mu_scale",
                                      "mu_max", "tol_con")), None)
    assert err == 0, err
    return [V, *outs]


def _problem(seed, N, B, dtype):
    """chip_smoke.py's RMPC problem at a small batch: random estimates, a
    quarter of the lanes near or past the velocity caps, an eighth on a
    tilt bound, a warm start partly outside +-du_bound."""
    rng = np.random.default_rng(seed)
    thetas = rng.normal(size=(B, 14)) * 0.3
    states = rng.normal(size=(B, 4)) * 0.05
    q = B // 4
    states[:q, 1] = rng.uniform(-0.3, 0.3, q)
    states[:q, 3] = rng.uniform(-0.3, 0.3, q)
    up0 = rng.uniform(-0.1, 0.1, (B, 2))
    up0[q:q + B // 8] = rng.choice([-0.4, 0.4], size=(B // 8, 2))
    targets = rng.uniform(-0.08, 0.08, (B, 4)) * np.array([1.0, 0, 1, 0])
    ref = np.linspace(states * [1.0, 0, 1, 0], targets, N + 1)   # (N+1,B,4)
    z0 = np.concatenate([states, up0], -1)
    V0 = rng.uniform(-0.08, 0.08, (N, B, 2))
    w = np.stack([np.full(B, v) for v in (100.0, 1.0, 0.05, 1.0)])

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)

    return [t(thetas.T), t(np.moveaxis(ref, 1, -1)), t(w), t(z0.T),
            t(np.moveaxis(V0, 1, -1))]


# (N, budget (iterations, alphas, AL rounds), dtype): the production budget
# at N=6; 6 alphas in two chunks of the group's 4 at N=20.
CASES = {"N6-6x4x3-f64": (6, (6, 4, 3), torch.float64),
         "N6-6x4x3-f32": (6, (6, 4, 3), torch.float32),
         "N20-2x6x2-f64": (20, (2, 6, 2), torch.float64)}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_matches_plain(emulated, case):
    """37 lanes, a ragged batch (4 blocks of 8 lanes and 5 more)."""
    N, (it, na, al), dtype = CASES[case]
    args = _problem(3, N, 37, dtype)
    V, cost, viol, gn = _run(emulated, args, (it, na, al))
    Vp, cp, vp, gp = trs.rmpc_solve_reference(
        *args, **KW, n_iters=it, n_alphas=na, al_rounds=al)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(V.numpy(), Vp.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(cost.numpy(), cp.numpy(), rtol=tol, atol=0)
    np.testing.assert_allclose(viol.numpy(), vp.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(gn.numpy(), gp.numpy(), rtol=0, atol=tol)
    assert float(V.abs().max()) <= KW["du_bound"] + 1e-6   # float32 0.05


def test_kernel_source_nan_lane_stays_alone(emulated):
    """A NaN theta in lane 13 (the second block's sixth lane) reports NaN
    and leaves every other lane exactly as it was."""
    args = _problem(4, 6, 37, torch.float64)
    clean = _run(emulated, args, (6, 4, 3))
    args[0][:, 13] = float("nan")
    got = _run(emulated, args, (6, 4, 3))
    assert bool(torch.isnan(got[2][13])) or bool(torch.isnan(got[3][13]))
    rest = torch.arange(37) != 13
    for x, y in zip(got, clean):
        assert torch.equal(x[..., rest], y[..., rest])
