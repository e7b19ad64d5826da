"""The CUDA source of the LMPC solve, `dart_tpu_torch/csrc/lmpc_solve.cu`,
compiled for the host CPU and held to its plain version
`lmpc_solve_reference`.

The source is built for the host through the emulation of the CUDA runtime
and warp primitives in `tests/_cuda_host.py`, so the kernel's own code
decides which thread holds which axis and row, what the two axes and the
threads of an axis exchange, which alpha the parallel line search takes and
how the ragged edge of the batch is masked. float64 agrees with the plain
version to a few ulps. Times mean nothing here; the card's comparison is
`chip_smoke.py lmpc`."""

import ctypes

import numpy as np
import pytest
import torch

from _cuda_host import build_host_library

from dart_tpu_torch.ops.kernels import lmpc_solve as tls

KW = dict(dt=0.01, u_bound=0.4)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built for the host, its entry points typed."""
    lib = build_host_library("lmpc_solve.cu",
                             tmp_path_factory.mktemp("lmpc_kernel_source"))
    if lib is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel source")
    for name in ("lmpc_solve_f32", "lmpc_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_double] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _run(lib, args, n_iters, n_alphas):
    """The emulated kernel on the wrapper's inputs (V0 clipped first)."""
    V0 = torch.clamp(args[-1], -KW["u_bound"], KW["u_bound"]).contiguous()
    N, _, Bt = V0.shape
    V = torch.empty_like(V0)
    cost, gnorm = torch.empty(Bt, dtype=V0.dtype), torch.empty(Bt, dtype=V0.dtype)
    fn = lib.lmpc_solve_f32 if V0.dtype == torch.float32 else lib.lmpc_solve_f64
    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (*args[:-1], V0, V,
                                                        cost, gnorm)),
             Bt, N, n_iters, n_alphas, KW["dt"], KW["u_bound"], None)
    assert err == 0, err
    return [V, cost, gnorm]


def _problem(seed, N, B, dtype):
    """chip_smoke.py's LMPC problem at a small batch: random 34-vectors,
    targets on px and py, a previous tilt, the default weights and a warm
    start partly outside +-0.4."""
    from dart_tpu_torch.control import mpc

    rng = np.random.default_rng(seed)
    pv = rng.uniform(0.05, 0.5, (34, B))
    tmask = np.array([1, 0, 1, 0, 0, 0, 0, 0.])[:, None]
    tg = rng.uniform(-0.08, 0.08, (8, B)) * tmask
    z0 = np.concatenate([rng.normal(size=(8, B)) * 0.02,
                         rng.uniform(-0.2, 0.2, (2, B))])
    V0 = rng.uniform(-0.6, 0.6, (N, 2, B))
    w = mpc.LMPC_DEFAULT_WEIGHTS
    Q = np.repeat(np.asarray(w.Q)[:, None], B, 1)
    R = np.repeat(np.asarray(w.R)[:, None], B, 1)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)

    return [t(pv), t(Q), t(R), t(Q), t(tg), t(z0), t(V0)]


def _stiff_problem(dtype):
    """37 lanes (250..286 of 1024) of the problem with every friction's
    eps scaled by 0.3: stiffer friction, where lane 270 accepts an alpha
    past the first four in the plain version."""
    args = _problem(2, 6, 1024, dtype)
    args[0][[10, 15, 26, 31]] *= 0.3
    return [a[..., 250:287].contiguous() for a in args]


# (N, iterations, alphas, dtype): the production budget 2x3 in float64 and
# float32, at N=6 and N=12; 2x6 in float64 on the stiff problem, whose
# alphas run in two chunks of an axis's 4 threads.
CASES = {"N6-2x3-f64": (6, 2, 3, torch.float64),
         "N6-2x3-f32": (6, 2, 3, torch.float32),
         "N12-2x3-f64": (12, 2, 3, torch.float64),
         "N6-2x6-f64-stiff": (6, 2, 6, torch.float64)}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_matches_plain(emulated, case):
    """37 lanes, a ragged batch (9 blocks of 4 lanes and one more)."""
    N, it, na, dtype = CASES[case]
    args = _problem(3, N, 37, dtype) if na <= 4 else _stiff_problem(dtype)
    V, cost, gn = _run(emulated, args, it, na)
    Vp, cp, gp = tls.lmpc_solve_reference(*args, **KW, n_iters=it,
                                          n_alphas=na)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(V.numpy(), Vp.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(cost.numpy(), cp.numpy(), rtol=tol, atol=0)
    np.testing.assert_allclose(gn.numpy(), gp.numpy(), rtol=0, atol=tol)
    assert float(V.abs().max()) <= KW["u_bound"] + 1e-6


def test_late_alphas_decide_lanes():
    """The 2x6 cases test the second chunk of alphas: in the plain version
    some of the stiff problem's lanes accept an alpha past the first four."""
    args = _stiff_problem(torch.float64)
    V6 = tls.lmpc_solve_reference(*args, **KW, n_iters=2, n_alphas=6)[0]
    V4 = tls.lmpc_solve_reference(*args, **KW, n_iters=2, n_alphas=4)[0]
    assert int((V6 != V4).flatten(0, 1).any(0).sum()) > 0


def test_kernel_source_nan_lane_stays_alone(emulated):
    """A NaN 34-vector in lane 21 (not a block's first lane) reports NaN
    cost and gnorm and leaves every other lane exactly as it was."""
    args = _problem(4, 6, 37, torch.float64)
    clean = _run(emulated, args, 2, 3)
    args[0][:, 21] = float("nan")
    got = _run(emulated, args, 2, 3)
    assert bool(torch.isnan(got[1][21])) and bool(torch.isnan(got[2][21]))
    rest = torch.arange(37) != 21
    for x, y in zip(got, clean):
        assert torch.equal(x[..., rest], y[..., rest])
