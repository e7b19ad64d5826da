"""The CUDA source of the Riccati backward pass, `dart_tpu_torch/csrc/
riccati.cu`, compiled for the host CPU and held to its plain version
`riccati_backward_reference`.

The source is built for the host through the emulation of the CUDA runtime,
the warp primitives and the asynchronous copies in `tests/_cuda_host.py`,
so the kernel's own code decides which thread owns which column and entry,
what the group exchanges, which stage's inputs each ring slot holds when a
stage reads it (a copy lands only at the wait that covers it) and how the
ragged edge of the batch is masked. float64 agrees with the plain version
to a few ulps. Times mean nothing here; the card's comparison is
`chip_smoke.py riccati`."""

import ctypes

import numpy as np
import pytest
import torch

from _cuda_host import build_host_library

from dart_tpu_torch.ops.kernels import riccati as tric



@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built for the host, its entry points typed."""
    lib = build_host_library("riccati.cu",
                             tmp_path_factory.mktemp("riccati_kernel_source"))
    if lib is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel source")
    for name in ("riccati_f32", "riccati_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 3
                       + [ctypes.c_double] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _problem(seed, N, nz, box=0.6, B=37, dtype=torch.float64):
    """chip_smoke.py's Riccati problem at B lanes, batch-last."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.normal(size=shape) * 0.1

    eye = np.eye(nz)
    h = mk(B, N, nz, nz)
    h2 = mk(B, N, 2, 2)
    h3 = mk(B, nz, nz)
    arrays = [mk(B, N, nz, nz) + eye, mk(B, N, nz, 2), mk(B, N, nz),
              mk(B, N, 2), np.einsum("bnij,bnkj->bnik", h, h) + 2 * eye,
              mk(B, N, 2, nz) * 0.1,
              np.einsum("bnij,bnkj->bnik", h2, h2) + 0.5 * np.eye(2),
              mk(B, nz), np.einsum("bij,bkj->bik", h3, h3) + eye,
              np.clip(mk(B, N, 2), -box, box)]
    args = [torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)),
                            dtype=dtype) for a in arrays]
    reg = torch.as_tensor(rng.uniform(1e-7, 1e-5, size=B), dtype=dtype)
    return args, (-box, -box), (box, box), reg


def _run(lib, args, lo, hi, reg):
    N, nz, _, B = args[0].shape
    D = torch.empty((N, 2, B), dtype=reg.dtype)
    K = torch.empty((N, 2, nz, B), dtype=reg.dtype)
    fn = lib.riccati_f32 if reg.dtype == torch.float32 else lib.riccati_f64
    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (*args, reg, D, K)),
             B, N, nz, lo[0], lo[1], hi[0], hi[1], None)
    assert err == 0, err
    return D, K


# (N, nz, box, B): the main path's state size over more stages than the
# ring holds, fewer stages than the ring's depth, LMPC's nz = 10 (a
# three-deep ring in double), a tight box where many steps sit on a bound,
# all at B = 37 (4 blocks of 8 lanes and 5 more: one element per copy) in
# float64; and B = 44, whose rows start 16-byte aligned (2 lanes per copy
# in double, 4 in float), its last block half past the batch's end.
F64, F32 = torch.float64, torch.float32
CASES = {"nz6-N9": (9, 6, 0.6, 37, F64), "nz6-N2": (2, 6, 0.6, 37, F64),
         "nz10-N7": (7, 10, 0.6, 37, F64),
         "nz6-N9-box0.05": (9, 6, 0.05, 37, F64),
         "nz6-N9-B44": (9, 6, 0.6, 44, F64),
         "nz10-N7-B44": (7, 10, 0.6, 44, F64),
         "nz6-N9-B44-f32": (9, 6, 0.6, 44, F32)}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_matches_plain(emulated, case):
    N, nz, box, B, dtype = CASES[case]
    args, lo, hi, reg = _problem(nz * 10 + N, N, nz, box, B, dtype)
    D, K = _run(emulated, args, lo, hi, reg)
    D_p, K_p = tric.riccati_backward_reference(*args, lo, hi, reg)
    tol = 1e-12 if dtype == F64 else 1e-5
    np.testing.assert_allclose(D.numpy(), D_p.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(K.numpy(), K_p.numpy(), rtol=0, atol=tol)
    if box < 0.6:
        Vn = args[-1] + D
        assert float((Vn.abs() - box).max()) <= 1e-12
        assert float((Vn.abs() > box - 1e-9).double().mean()) > 0.2


def test_kernel_source_nan_lane_stays_alone(emulated):
    """A NaN entry of A in lane 13 (the second block's sixth lane) makes
    that lane's D NaN and leaves every other lane exactly as it was."""
    args, lo, hi, reg = _problem(5, 9, 6)
    clean = _run(emulated, args, lo, hi, reg)
    args[0][4, 2, 3, 13] = float("nan")
    got = _run(emulated, args, lo, hi, reg)
    assert bool(torch.isnan(got[0][..., 13]).any())
    rest = torch.arange(37) != 13
    for x, y in zip(got, clean):
        assert torch.equal(x[..., rest], y[..., rest])
