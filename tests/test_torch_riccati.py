"""Port parity: the batched box-DDP Riccati backward pass
(`dart_tpu_torch.ops.kernels.riccati`, plain PyTorch version of
`csrc/riccati.cu`) against `dart_tpu`'s Pallas kernel and its XLA scan
(`ilqr._backward`) on the same numpy problems.

The Pallas kernel runs as the JAX package's tests run it on the CPU: at
nz=6 through `riccati_backward_pallas(interpret=True)`; at nz=10 the
interpreter's compile of the unrolled body takes many minutes, so its body
`_backward_kernel` runs eagerly on whole arrays instead (the same
operations, stage for stage, without the interpreter). Each JAX run is
made once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.ops.pallas import riccati as jric
from dart_tpu.solver import ilqr as jilqr
from dart_tpu_torch.ops.kernels import riccati as tric
from dart_tpu_torch.solver import ilqr as tilqr

B, N = 128, 15
LO, HI = (-0.6, -0.6), (0.6, 0.6)
# float64: the plain version repeats the kernel's operations in the same
# order; the XLA scan sums its small products in another order, so a few
# ulps of values up to ~1e2 (K) and ~1 (D).
F64 = dict(rtol=0, atol=1e-10)
# float32: tests/test_pallas_riccati.py's own kernel-vs-scan tolerances.
F32_D, F32_K = 2e-5, 2e-4


def _problem(seed, nz, dtype=np.float64, box=0.6):
    """tests/test_pallas_riccati.py:16-35's problem, batch-first numpy, with
    a per-lane reg."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.normal(size=shape) * 0.1

    eye = np.eye(nz)
    A = mk(B, N, nz, nz) + eye
    Bm = mk(B, N, nz, 2)
    lx = mk(B, N, nz)
    lu = mk(B, N, 2)
    h = mk(B, N, nz, nz)
    lxx = np.einsum("bnij,bnkj->bnik", h, h) + 2 * eye
    lux = mk(B, N, 2, nz) * 0.1
    h2 = mk(B, N, 2, 2)
    luu = np.einsum("bnij,bnkj->bnik", h2, h2) + 0.5 * np.eye(2)
    gx = mk(B, nz)
    h3 = mk(B, nz, nz)
    gxx = np.einsum("bij,bkj->bik", h3, h3) + eye
    V = np.clip(mk(B, N, 2), -box, box)
    reg = rng.uniform(1e-7, 1e-5, size=B)
    derivs = tuple(a.astype(dtype) for a in
                   (A, Bm, lx, lu, lxx, lux, luu, gx, gxx))
    return derivs, V.astype(dtype), reg.astype(dtype)


def _bl(x):
    return np.ascontiguousarray(np.moveaxis(x, 0, -1))


def _plain(derivs, V, reg, lo=LO, hi=HI):
    D, K = tric.riccati_backward(*(torch.from_numpy(_bl(d)) for d in derivs),
                                 torch.from_numpy(_bl(V)), lo, hi,
                                 torch.from_numpy(reg))
    return D.numpy(), K.numpy()


def _xla_scan(derivs, V, reg, lo=LO, hi=HI):
    dtype = V.dtype
    u_lo, u_hi = jnp.asarray(lo, dtype), jnp.asarray(hi, dtype)
    D, K, _, _ = jax.vmap(lambda d, v, r: jilqr._backward(
        d, v, u_lo, u_hi, r))(tuple(map(jnp.asarray, derivs)),
                              jnp.asarray(V), jnp.asarray(reg))
    return _bl(np.asarray(D)), _bl(np.asarray(K))


class _Ref:
    """A whole array standing in for a Pallas ref in the eager body."""

    def __init__(self, x):
        self.x = jnp.asarray(x)

    def __getitem__(self, idx):
        return self.x[idx]

    def __setitem__(self, idx, value):
        self.x = self.x.at[idx].set(value)


def _kernel_body(derivs, V, reg, nz):
    ins = [_Ref(_bl(d)) for d in derivs] + [_Ref(_bl(V))]
    ins += [_Ref(np.broadcast_to(np.asarray(LO)[:, None], (2, B))),
            _Ref(np.broadcast_to(np.asarray(HI)[:, None], (2, B))),
            _Ref(reg[None, :])]
    D = _Ref(np.zeros((N, 2, B)))
    K = _Ref(np.zeros((N, 2, nz, B)))
    jric._backward_kernel(nz, N, *ins, D, K)
    return np.asarray(D.x), np.asarray(K.x)


@pytest.fixture(scope="module")
def jax_kernel():
    """The Pallas kernel's answer per nz, float64."""
    out = {}
    derivs, V, reg = _problem(6, 6)
    D, K = jric.riccati_backward_pallas(
        *(jnp.asarray(_bl(d)) for d in derivs), jnp.asarray(_bl(V)),
        jnp.asarray(LO), jnp.asarray(HI), jnp.asarray(reg), interpret=True)
    out[6] = (np.asarray(D), np.asarray(K))
    derivs, V, reg = _problem(10, 10)
    out[10] = _kernel_body(derivs, V, reg, 10)
    return out


@pytest.mark.parametrize("nz", [6, 10])
def test_plain_matches_pallas_kernel(jax_kernel, nz):
    derivs, V, reg = _problem(nz, nz)
    D, K = _plain(derivs, V, reg)
    Dj, Kj = jax_kernel[nz]
    np.testing.assert_allclose(D, Dj, **F64)
    np.testing.assert_allclose(K, Kj, **F64)
    assert np.abs(K).max() > 0.1      # the gains are not trivially zero


@pytest.mark.parametrize("nz", [6, 10])
def test_plain_matches_xla_scan(nz):
    derivs, V, reg = _problem(20 + nz, nz)
    D, K = _plain(derivs, V, reg)
    Dx, Kx = _xla_scan(derivs, V, reg)
    np.testing.assert_allclose(D, Dx, **F64)
    np.testing.assert_allclose(K, Kx, **F64)


@pytest.mark.parametrize("nz", [6, 10])
def test_float32_matches_xla_scan(nz):
    derivs, V, reg = _problem(40 + nz, nz, np.float32)
    D, K = _plain(derivs, V, reg)
    Dx, Kx = _xla_scan(derivs, V, reg)
    assert D.dtype == np.float32 and K.dtype == np.float32
    np.testing.assert_allclose(D, Dx, rtol=0, atol=F32_D)
    np.testing.assert_allclose(K, Kx, rtol=0, atol=F32_K)


def test_scalar_reg_equals_lane_vector():
    derivs, V, reg = _problem(3, 6)
    D1, K1 = _plain(derivs, V, np.full(B, 1e-6))
    D2, K2 = tric.riccati_backward(
        *(torch.from_numpy(_bl(d)) for d in derivs),
        torch.from_numpy(_bl(V)), LO, HI, 1e-6)
    np.testing.assert_array_equal(D1, D2.numpy())
    np.testing.assert_array_equal(K1, K2.numpy())


def test_tight_box_steps_stay_inside():
    """tests/test_pallas_riccati.py:54-68: with bounds +-0.05 many steps sit
    on a bound, and V + D stays inside the box; the scan agrees."""
    lo, hi = (-0.05, -0.05), (0.05, 0.05)
    derivs, V, reg = _problem(1, 6, box=0.05)
    D, K = _plain(derivs, V, reg, lo, hi)
    Vn = _bl(V) + D
    assert np.all(Vn >= -0.05 - 1e-12) and np.all(Vn <= 0.05 + 1e-12)
    assert np.mean(np.abs(Vn) > 0.05 - 1e-9) > 0.2
    Dx, Kx = _xla_scan(derivs, V, reg, lo, hi)
    np.testing.assert_allclose(D, Dx, **F64)
    np.testing.assert_allclose(K, Kx, **F64)


def test_batch_first_backward_matches_batch_last():
    """`ilqr.backward` (solve_batch's backward pass) moves the batch axis
    and back around the same call."""
    derivs, V, reg = _problem(5, 6)
    D, K = tilqr.backward(tuple(torch.from_numpy(d) for d in derivs),
                          torch.from_numpy(V), LO, HI, torch.from_numpy(reg))
    Dl, Kl = _plain(derivs, V, reg)
    np.testing.assert_array_equal(D.numpy(), np.moveaxis(Dl, -1, 0))
    np.testing.assert_array_equal(K.numpy(), np.moveaxis(Kl, -1, 0))


def test_wrapper_rejects_bad_inputs():
    derivs, V, reg = _problem(2, 6)
    args = [torch.from_numpy(_bl(d)) for d in derivs] + \
        [torch.from_numpy(_bl(V))]
    bad = list(args)
    bad[2] = bad[2][:, :5]
    with pytest.raises(ValueError, match="lx must be"):
        tric.riccati_backward(*bad, LO, HI, 1e-6)
    bad = list(args)
    bad[4] = bad[4].float()
    with pytest.raises(TypeError, match="lxx is torch.float32"):
        tric.riccati_backward(*bad, LO, HI, 1e-6)
    with pytest.raises(ValueError, match="reg must be"):
        tric.riccati_backward(*args, LO, HI, torch.ones(3))
    with pytest.raises(ValueError, match="two bounds"):
        tric.riccati_backward(*args, (-1.0,), HI, 1e-6)


@pytest.mark.parametrize("nz", [6, 10])
def test_work_counts_each_input_and_output_once(nz):
    derivs, V, _ = _problem(4, nz, np.float32)
    nbytes = sum(d.nbytes for d in derivs) + V.nbytes + B * 4   # + reg
    nbytes += (N * 2 * B + N * 2 * nz * B) * 4                  # D, K
    flops, got = tric.work(N, nz, B, 4)
    assert got == nbytes
    # Dense inputs: Vxx A once (2 nz^3 - nz^2) and A'(Vxx A) on the upper
    # triangle, below the dense algebra as written (6 nz^3 + 21 nz^2 +
    # 40 nz + 170 per stage); a diagonal A needs less.
    written = (6 * nz ** 3 + 21 * nz * nz + 40 * nz + 170) * N * B
    assert 2 * nz ** 3 * N * B < flops < written
    diag = torch.eye(nz, dtype=torch.bool)
    Bm = torch.ones(nz, 2, dtype=torch.bool)
    assert B * tric._stage_counts(N, diag, Bm) < flops
