"""The CUDA source of the RMPC solve, `dart_tpu_torch/csrc/rmpc_solve.cu`,
compiled for the host CPU and held to its plain version
`rmpc_solve_reference`.

The source is built for the host through the emulation of the CUDA
runtime and warp primitives in `tests/_cuda_host.py`, so the kernel's own
code decides which thread owns which row, what the group exchanges, how the
box QP's candidates are shared, which alpha the parallel line search takes
and how the ragged edge of the batch is masked. float64 agrees with the
plain version to a few ulps. Times mean nothing here; the card's
comparison is `chip_smoke.py rmpc`."""

import ctypes

import numpy as np
import pytest
import torch

from _cuda_host import build_host_library

from dart_tpu_torch.ops.kernels import rmpc_solve as trs

KW = dict(dt=0.002, u_bound=0.4, du_bound=0.05, vmax=0.25, v_eps=0.1,
          mu_init=10.0, mu_scale=10.0, mu_max=1e8, tol_con=1e-8)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built for the host, its entry points typed."""
    lib = build_host_library("rmpc_solve.cu",
                             tmp_path_factory.mktemp("rmpc_kernel_source"))
    if lib is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel source")
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
