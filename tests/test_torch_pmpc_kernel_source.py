"""The CUDA source of the PMPC solve, `dart_tpu_torch/csrc/pmpc_solve.cu`,
compiled for the host CPU and held to its plain version
`pmpc_solve_reference`.

The source is built for the host through the emulation of the CUDA runtime
and warp primitives in `tests/_cuda_host.py`, so the kernel's own code
decides which thread owns which column and entry, what the group
exchanges, which alpha the parallel line search takes, how the ragged edge
of the batch is masked and which lanes the in-kernel structure guard sends
to +inf. float64 agrees with the plain version to a few ulps. Times mean
nothing here; the card's comparison is `chip_smoke.py pmpc`."""

import ctypes

import numpy as np
import pytest
import torch

from _cuda_host import build_host_library

from dart_tpu_torch.ops.kernels import pmpc_solve as tps
from dart_tpu_torch.solver import pmpc_fast

B, N, DT = 37, 15, 0.002   # 4 blocks of 8 lanes and 5 more: ragged


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built for the host, its entry points typed."""
    lib = build_host_library("pmpc_solve.cu",
                             tmp_path_factory.mktemp("pmpc_kernel_source"))
    if lib is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel source")
    for name in ("pmpc_solve_f32", "pmpc_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_double] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _run(lib, args, n_iters, n_alphas):
    V0 = args[-1]
    V = torch.empty_like(V0)
    cost, gnorm = torch.empty(B, dtype=V0.dtype), torch.empty(B, dtype=V0.dtype)
    fn = lib.pmpc_solve_f32 if V0.dtype == torch.float32 else lib.pmpc_solve_f64
    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (*args, V, cost, gnorm)),
             B, N, n_iters, n_alphas, DT, 0.6, -9.81, None)
    assert err == 0, err
    return [V, cost, gnorm]


def _problem(seed, dtype, w45=0.0):
    """The bench's distributions at B lanes, batch-last, a warm start partly
    outside the +-0.6 box; `w45` weights states 4 and 5, where the
    Gauss-Newton step overshoots and some lanes need a late alpha."""
    rng = np.random.default_rng(seed)
    mus = rng.uniform(0.05, 0.2, B)
    tgts = rng.uniform(-0.1, 0.1, (B, 6)) * np.array([1, 0, 1, 0, 0, 0])
    z0 = rng.normal(size=(B, 6)) * 0.02
    V0 = rng.uniform(-0.8, 0.8, (B, N, 2))
    Ad, Sd = pmpc_fast._affine_discretization(
        torch.as_tensor(mus, dtype=dtype), -9.81, DT)
    wdiag = np.tile([300.0, 2.0, 300.0, 2.0, w45, w45], (B, 1))

    def bl(x):
        return torch.as_tensor(np.ascontiguousarray(
            np.moveaxis(np.asarray(x), 0, -1)), dtype=dtype)

    return [bl(Ad), bl(Sd), bl(wdiag), torch.full((B,), 0.2, dtype=dtype),
            bl(tgts), bl(z0), bl(V0)]


# (iterations, alphas, dtype, seed, w45): the production budget 2x3 in
# float64 and float32; 2x6 in float64, whose alphas run in two chunks of
# the group's 4 threads, on a problem where a lane takes alpha 5 or 6.
CASES = {"2x3-f64": (2, 3, torch.float64, 3, 0.0),
         "2x3-f32": (2, 3, torch.float32, 3, 0.0),
         "2x6-f64-late": (2, 6, torch.float64, 1, 100.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_matches_plain(emulated, case):
    it, na, dtype, seed, w45 = CASES[case]
    args = _problem(seed, dtype, w45)
    V, cost, gn = _run(emulated, args, it, na)
    Vp, cp, gp = tps.pmpc_solve_reference(*args, dt=DT, n_iters=it,
                                          n_alphas=na)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(V.numpy(), Vp.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(cost.numpy(), cp.numpy(), rtol=tol, atol=0)
    np.testing.assert_allclose(gn.numpy(), gp.numpy(), rtol=0, atol=tol)


def test_late_alphas_decide_lanes():
    """The 2x6 case tests the second chunk of alphas: in the plain version
    some of its lanes accept an alpha past the first four."""
    _, _, dtype, seed, w45 = CASES["2x6-f64-late"]
    args = _problem(seed, dtype, w45)
    V6 = tps.pmpc_solve_reference(*args, dt=DT, n_iters=2, n_alphas=6)[0]
    V4 = tps.pmpc_solve_reference(*args, dt=DT, n_iters=2, n_alphas=4)[0]
    assert int((V6 != V4).flatten(0, 1).any(0).sum()) > 0


def test_kernel_source_structure_guard(emulated):
    """Lane 13 (the second block's sixth lane) with a non-zero at Ad[3, 0]
    comes back with cost and gnorm +inf and the plain V, every other lane
    exactly as without it; lane 21 with a NaN at a structural zero of Sd
    has a NaN residual, which is not past 1e-6, and matches the plain
    version, finite."""
    args = _problem(4, torch.float64)
    clean = _run(emulated, args, 2, 3)
    args[0][3, 0, 13] = 0.01
    args[1][5, 2, 21] = float("nan")
    got = _run(emulated, args, 2, 3)
    want = tps.pmpc_solve_reference(*args, dt=DT, n_iters=2, n_alphas=3)
    assert float(got[1][13]) == float("inf") == float(got[2][13])
    assert bool(torch.isinf(want[1][13])) and bool(torch.isinf(want[2][13]))
    assert bool(torch.isfinite(got[1][21])) and bool(torch.isfinite(got[2][21]))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12, atol=0)
    rest = (torch.arange(B) != 13) & (torch.arange(B) != 21)
    for x, y in zip(got, clean):
        assert torch.equal(x[..., rest], y[..., rest])
    assert torch.equal(got[0][..., 21], clean[0][..., 21])
