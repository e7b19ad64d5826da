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
# The Pallas kernel's horizon in the comparison with it: its stages are
# unrolled, so the interpreter's trace and the eager body take time in
# proportion (53 s at N=15 for nz=6); every stage runs the same code.
N_KERNEL = 5


def _problem(seed, nz, dtype=np.float64, box=0.6, n=N):
    """tests/test_pallas_riccati.py:16-35's problem, batch-first numpy, with
    a per-lane reg."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.normal(size=shape) * 0.1

    eye = np.eye(nz)
    A = mk(B, n, nz, nz) + eye
    Bm = mk(B, n, nz, 2)
    lx = mk(B, n, nz)
    lu = mk(B, n, 2)
    h = mk(B, n, nz, nz)
    lxx = np.einsum("bnij,bnkj->bnik", h, h) + 2 * eye
    lux = mk(B, n, 2, nz) * 0.1
    h2 = mk(B, n, 2, 2)
    luu = np.einsum("bnij,bnkj->bnik", h2, h2) + 0.5 * np.eye(2)
    gx = mk(B, nz)
    h3 = mk(B, nz, nz)
    gxx = np.einsum("bij,bkj->bik", h3, h3) + eye
    V = np.clip(mk(B, n, 2), -box, box)
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
    n = V.shape[1]
    ins = [_Ref(_bl(d)) for d in derivs] + [_Ref(_bl(V))]
    ins += [_Ref(np.broadcast_to(np.asarray(LO)[:, None], (2, B))),
            _Ref(np.broadcast_to(np.asarray(HI)[:, None], (2, B))),
            _Ref(reg[None, :])]
    D = _Ref(np.zeros((n, 2, B)))
    K = _Ref(np.zeros((n, 2, nz, B)))
    jric._backward_kernel(nz, n, *ins, D, K)
    return np.asarray(D.x), np.asarray(K.x)


@pytest.fixture(scope="module")
def jax_kernel():
    """The Pallas kernel's answer per nz, float64."""
    out = {}
    derivs, V, reg = _problem(6, 6, n=N_KERNEL)
    D, K = jric.riccati_backward_pallas(
        *(jnp.asarray(_bl(d)) for d in derivs), jnp.asarray(_bl(V)),
        jnp.asarray(LO), jnp.asarray(HI), jnp.asarray(reg), interpret=True)
    out[6] = (np.asarray(D), np.asarray(K))
    derivs, V, reg = _problem(10, 10, n=N_KERNEL)
    out[10] = _kernel_body(derivs, V, reg, 10)
    return out


@pytest.mark.parametrize("nz", [6, 10])
def test_plain_matches_pallas_kernel(jax_kernel, nz):
    derivs, V, reg = _problem(nz, nz, n=N_KERNEL)
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


# The lane algebra as written one entry and one candidate at a time: every
# sum in the order t = 0..k-1, the box QP's nine candidates one after the
# other. `lanes` forms each product over all entries and the candidates
# as one stack with the same operations per element, so it must agree bit
# for bit.
def _mm_loop(a, b):
    rows = []
    for i in range(a.shape[0]):
        acc = a[i, 0] * b[0]
        for t in range(1, a.shape[1]):
            acc = acc + a[i, t] * b[t]
        rows.append(acc)
    return torch.stack(rows)


def _boxqp2_loop(Quu, Qu, lo, hi):
    q00, q01, q11 = Quu[0, 0], Quu[0, 1], Quu[1, 1]
    det = q00 * q11 - q01 * q01
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
    one, zero = torch.ones_like(q00), torch.zeros_like(q00)
    best = None
    for s0 in range(3):
        for s1 in range(3):
            c0 = lo[0] if s0 == 1 else hi[0]
            c1 = lo[1] if s1 == 1 else hi[1]
            if s0 == 0 and s1 == 0:
                d0 = -(q11 * Qu[0] - q01 * Qu[1]) / det
                d1 = -(-q01 * Qu[0] + q00 * Qu[1]) / det
            elif s0 == 0:
                d1 = c1
                d0 = -(Qu[0] + q01 * d1) / torch.clamp_min(q00, 1e-30)
            elif s1 == 0:
                d0 = c0
                d1 = -(Qu[1] + q01 * d0) / torch.clamp_min(q11, 1e-30)
            else:
                d0, d1 = c0, c1
            g0 = q00 * d0 + q01 * d1 + Qu[0]
            g1 = q01 * d0 + q11 * d1 + Qu[1]
            ok = torch.ones_like(q00, dtype=torch.bool)
            for s, d, g, lo_i, hi_i in ((s0, d0, g0, lo[0], hi[0]),
                                        (s1, d1, g1, lo[1], hi[1])):
                if s == 0:
                    ok = ok & (d >= lo_i - 1e-9) & (d <= hi_i + 1e-9)
                elif s == 1:
                    ok = ok & (g >= -1e-9)
                else:
                    ok = ok & (g <= 1e-9)
            obj = 0.5 * (d0 * g0 + d1 * g1) + 0.5 * (Qu[0] * d0 + Qu[1] * d1)
            cand = (torch.where(ok, obj, torch.full_like(obj, 1e30)),
                    torch.clamp(d0, lo[0], hi[0]),
                    torch.clamp(d1, lo[1], hi[1]),
                    one if s0 == 0 else zero, one if s1 == 0 else zero)
            if best is None:
                best = cand
            else:
                better = cand[0] < best[0]
                best = tuple(torch.where(better, x, y)
                             for x, y in zip(cand, best))
    return torch.stack(best[1:3]), torch.stack(best[3:])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lane_algebra_matches_the_loop_form_bit_for_bit(dtype):
    """Products (with a -0.0 entry), the diagonal helpers and the box QP on
    boxes around, beside and pinched to zero, degenerate and huge
    off-diagonal Quu, ties (a zero gradient) and NaN/inf entries."""
    from dart_tpu_torch.ops.kernels import lanes

    def bits(t):
        return t.contiguous().view(torch.int64 if dtype == torch.float64
                                   else torch.int32)

    g = torch.Generator().manual_seed(3)
    L = 64
    for n, k, m in ((6, 6, 6), (2, 6, 6), (6, 2, 1), (10, 10, 2)):
        a = torch.randn(n, k, L, generator=g, dtype=dtype)
        b = torch.randn(k, m, L, generator=g, dtype=dtype)
        a[0, 0, 0] = -0.0
        assert torch.equal(bits(lanes._mm(a, b)), bits(_mm_loop(a, b)))
        v = b[:, 0]
        assert torch.equal(bits(lanes._mv(a, v)),
                           bits(_mm_loop(a, v[:, None])[:, 0]))
    M = torch.randn(6, 6, L, generator=g, dtype=dtype)
    M[0, 1, 0] = -0.0
    w = torch.randn(6, L, generator=g, dtype=dtype)
    eye = torch.eye(6, dtype=torch.bool)
    loops = {
        "_add_diag": (lanes._add_diag(M, w[0]),
                      [[M[i, j] + w[0] if i == j else M[i, j]
                        for j in range(6)] for i in range(6)]),
        "_add_diag_vec": (lanes._add_diag_vec(M, w),
                          [[M[i, j] + w[i] if i == j else M[i, j]
                            for j in range(6)] for i in range(6)]),
        "_scale_add_eye": (lanes._scale_add_eye(M, 0.37),
                           [[0.37 * M[i, j] + 1.0 if i == j
                             else 0.37 * M[i, j] for j in range(6)]
                            for i in range(6)]),
        "_diag_embed": (lanes._diag_embed(w),
                        [[w[i] if eye[i, j] else torch.zeros_like(w[0])
                          for j in range(6)] for i in range(6)]),
    }
    for name, (got, rows) in loops.items():
        want = torch.stack([torch.stack(r) for r in rows])
        assert torch.equal(bits(got), bits(want)), name
    for trial in range(60):
        A = torch.randn(2, 2, L, generator=g, dtype=dtype)
        Quu = _mm_loop(A, A.transpose(0, 1)) + 0.01
        if trial % 5 == 0:
            Quu[:, :, :8] = 0.0
        if trial % 7 == 0:
            Quu[0, 1, 8:16] = Quu[1, 0, 8:16] = 1e6
        Qu = torch.randn(2, L, generator=g, dtype=dtype) * 10.0 ** (
            trial % 4 - 2)
        half = torch.rand(2, L, generator=g, dtype=dtype) * 0.5
        lo, hi = -half, half * (1 + trial % 3)
        if trial % 3 == 0:
            lo = lo + 0.3
        if trial % 11 == 0:
            Qu[0, 3] = float("nan")
            Quu[1, 1, 4] = float("nan")
            lo[0, 5] = float("inf")
        if trial % 13 == 0:
            Qu[:, 20:30] = 0.0
            lo[:, 20:25] = hi[:, 20:25] = 0.0
        for got, want in zip(lanes._boxqp2_lanes(Quu, Qu, lo, hi),
                             _boxqp2_loop(Quu, Qu, lo, hi)):
            assert torch.equal(bits(got), bits(want)), trial
