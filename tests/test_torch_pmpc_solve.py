"""Port parity: the whole-solve PMPC kernel's plain version and its lane
helpers (`dart_tpu_torch.ops.kernels`) against the Pallas kernel of
`dart_tpu.ops.pallas.pmpc_solve`.

The JAX side runs the Pallas kernel as the JAX package's own tests do on
the CPU: once through `pmpc_solve_pallas(interpret=True)`, and otherwise by
calling the kernel body `_pmpc_kernel` eagerly with plain ref holders (the
same arithmetic, ~10x faster than interpret mode). The CUDA kernel itself
runs only on the card, where `chip_smoke.py` holds it to this plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.ops.pallas import pmpc_solve as jps
from dart_tpu.ops.pallas import riccati as jric
from dart_tpu.solver import pmpc_fast as jfast
from dart_tpu_torch.ops.kernels import lanes
from dart_tpu_torch.ops.kernels import pmpc_solve as tps

B, N, DT = 128, 8, 0.002
# float64: identical operation order on both sides; agreement is to a few
# ulps, so 1e-9 leaves a wide margin. float32: a few ulps per operation
# through the Newton iterations; tighter than the JAX kernel's own f32
# tolerances (tests/test_pmpc_solve_kernel.py:40-43: cost rtol 5e-3,
# atol 1e-4; 99th percentile of |dV0| < 5e-3).
TOL = {np.float64: dict(V=1e-9, cost_rtol=1e-9, gnorm=1e-9),
       np.float32: dict(V=1e-4, cost_rtol=1e-5, gnorm=1e-4)}


class _Ref:
    """Stands in for a Pallas ref when the kernel body runs eagerly."""

    def __init__(self, x=None):
        self.x = x

    def __getitem__(self, idx):
        return self.x[idx]

    def __setitem__(self, idx, value):
        assert idx is Ellipsis
        self.x = value


def _jax_kernel_body(Ad, Sd, wdiag, rw, target, z0, V0, n_iters, n_alphas,
                     u_bound=0.6, g=-9.81):
    """`_pmpc_kernel` on the whole batch as one lane tile, with the
    wrapper's prep (pmpc_solve.py:336-362). No structure guard: the
    operators here are structured."""
    Nh, _, Bt = V0.shape
    Ad, Sd = jnp.asarray(Ad), jnp.asarray(Sd)
    ad3 = jnp.stack([Ad[0, 1], Ad[1, 1], Ad[5, 5]])
    sd4 = jnp.stack([Sd[0, 1], Sd[1, 1], Sd[4, 4], Sd[5, 5]])
    lo = jnp.full((2, Bt), -u_bound, V0.dtype)
    hi = jnp.full((2, Bt), u_bound, V0.dtype)
    outs = [_Ref() for _ in range(3)]
    ins = [_Ref(jnp.asarray(x)) for x in
           (ad3, sd4, wdiag, rw[None], target, z0, V0, lo, hi)]
    jps._pmpc_kernel(Nh, n_iters, n_alphas, float(g), DT, None, *ins, *outs)
    return (np.asarray(outs[0].x), np.asarray(outs[1].x[0]),
            np.asarray(outs[2].x[0]))


def _problem(dtype, warm, seed=0):
    """Batch-last numpy inputs at the bench's distributions; `warm` draws
    V0 partly outside the +-0.6 box (the kernel must not clip it)."""
    rng = np.random.default_rng(seed)
    mus = rng.uniform(0.05, 0.2, B)
    tgts = rng.uniform(-0.1, 0.1, (B, 6)) * np.array([1, 0, 1, 0, 0, 0])
    z0 = rng.normal(size=(B, 6)) * 0.02
    V0 = rng.uniform(-0.8, 0.8, (B, N, 2)) if warm else np.zeros((B, N, 2))
    Ad, Sd = jfast._affine_discretization(jnp.asarray(mus, dtype), -9.81,
                                          DT)
    wdiag = np.tile(300.0 * np.array([1, 0, 1, 0, 0, 0]) +
                    2.0 * np.array([0, 1, 0, 1, 0, 0]), (B, 1))
    rw = np.full(B, 0.2)

    def tl(x):
        return np.ascontiguousarray(np.moveaxis(np.asarray(x, dtype), 0, -1))

    return [tl(Ad), tl(Sd), tl(wdiag), rw.astype(dtype), tl(tgts), tl(z0),
            tl(V0)]


def _torch_solve(args, n_iters, n_alphas):
    V, cost, gnorm = tps.pmpc_solve(*map(torch.from_numpy, args), dt=DT,
                                    n_iters=n_iters, n_alphas=n_alphas)
    return V.numpy(), cost.numpy(), gnorm.numpy()


def _assert_close(got, want, dtype):
    tol = TOL[dtype]
    (V, cost, gnorm), (V_j, cost_j, gnorm_j) = got, want
    assert np.all(np.isfinite(cost)) and np.all(np.isfinite(gnorm))
    np.testing.assert_allclose(V, V_j, rtol=0, atol=tol["V"])
    np.testing.assert_allclose(cost, cost_j, rtol=tol["cost_rtol"], atol=0)
    np.testing.assert_allclose(gnorm, gnorm_j, rtol=0, atol=tol["gnorm"])
    assert np.all(np.abs(V) <= 0.6 + 1e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_iters,n_alphas,warm",
                         [(1, 2, False), (2, 3, False), (2, 3, True)])
def test_plain_solve_matches_jax_kernel_body(n_iters, n_alphas, warm, dtype):
    args = _problem(dtype, warm)
    want = _jax_kernel_body(*args, n_iters=n_iters, n_alphas=n_alphas)
    _assert_close(_torch_solve(args, n_iters, n_alphas), want, dtype)


def test_plain_solve_matches_pallas_interpret():
    """The one case through the real `pallas_call` in interpret mode."""
    args = _problem(np.float64, warm=False, seed=5)
    V, cost, gnorm = jps.pmpc_solve_pallas(
        *map(jnp.asarray, args), dt=DT, n_iters=1, n_alphas=2,
        interpret=True)
    want = (np.asarray(V), np.asarray(cost), np.asarray(gnorm))
    _assert_close(_torch_solve(args, 1, 2), want, np.float64)


def test_structure_guard_poisons_one_lane():
    """A lane whose Ad breaks the sparsity comes back with cost and gnorm
    +inf; the other lanes keep their solution. The residual itself matches
    JAX's on clean and broken operators."""
    args = _problem(np.float64, warm=False, seed=2)
    clean = _torch_solve(args, 1, 2)
    bad = [a.copy() for a in args]
    bad[0][0, 3, 0] = 0.01
    V, cost, gnorm = _torch_solve(bad, 1, 2)
    assert np.isinf(cost[0]) and cost[0] > 0
    assert np.isinf(gnorm[0]) and gnorm[0] > 0
    np.testing.assert_array_equal(cost[1:], clean[1][1:])
    np.testing.assert_array_equal(gnorm[1:], clean[2][1:])
    for ops in (args, bad):
        got = tps.structure_residual(torch.from_numpy(ops[0]),
                                     torch.from_numpy(ops[1]), DT).numpy()
        want = np.asarray(jps.structure_residual(jnp.asarray(ops[0]),
                                                 jnp.asarray(ops[1]), DT))
        np.testing.assert_array_equal(got, want)
    assert float(tps.structure_residual(torch.from_numpy(args[0]),
                                        torch.from_numpy(args[1]),
                                        DT).max()) == 0.0


@pytest.mark.parametrize("N_,n_iters,n_alphas",
                         [(15, 2, 3), (8, 1, 2), (20, 6, 4)])
def test_flops_per_solve_equals_jax(N_, n_iters, n_alphas):
    assert tps.flops_per_solve(N_, n_iters, n_alphas) == \
        jps.flops_per_solve(N_, n_iters, n_alphas)


def test_trial_count_and_work():
    """The plain version counts the line-search trials the kernel runs
    (none for a done lane, none after a lane's first accepted alpha);
    `work` counts them as run, the rollout as `flops_per_solve` does, each
    backward pass over its structural non-zeros, and each input and output
    once."""
    args = _problem(np.float64, warm=True, seed=3)
    stats = {}
    tps.pmpc_solve_reference(*map(torch.from_numpy, args), dt=DT, n_iters=2,
                             n_alphas=3, stats=stats)
    trials = stats["trials"].numpy()
    assert trials.shape == (B,) and np.all(trials <= 2 * 3)
    assert np.all(trials >= 1)            # the first iteration searches
    w_nz = (args[2] != 0).any(axis=1).tolist()
    flops, nbytes = tps.work(N, 2, B, int(trials.sum()), 8, w_nz)
    assert flops == B * (50 * N + 23 + 2 * (tps._backward_counts(N, w_nz)
                                             + 10)) + \
        int(trials.sum()) * (75 * N + 80)
    ins = sum(a.size for a in args)   # Ad/Sd whole: the guard reads them
    assert nbytes == (ins + (N * 2 + 2) * B) * 8


def test_work_counts_the_structural_nonzeros():
    """The backward pass's count follows the value Hessian's mask: below
    the dense hand count of `flops_per_solve` (1190 per stage), and lower
    still where wdiag's zeros keep states 4 and 5 out of the value. With
    wdiag = 0 the value stays 0 and a stage costs only its fixed work:
    27 element-wise (B's entries, e, lx, lu), lu's and Quu's diagonal adds
    (2 + 4), the box QP (150), the gains' determinant (12) and Quu d + Qu
    (8)."""
    dense = tps._backward_counts(N, [True] * 6)
    assert dense < 1190 * N
    assert tps._backward_counts(N, [True, True, True, True, False,
                                    False]) < dense
    assert tps._backward_counts(N, [False] * 6) == 203 * N
    assert tps.work(N, 2, B, 0, 4, [True] * 6)[0] == \
        B * (50 * N + 23 + 2 * (dense + 10))


def test_cpu_tensors_take_plain_path_without_launching():
    args = [torch.from_numpy(a) for a in _problem(np.float64, warm=True)]
    before = tps.pmpc_solve.launches
    got = tps.pmpc_solve(*args, dt=DT, n_iters=1, n_alphas=2)
    want = tps.pmpc_solve_reference(*args, dt=DT, n_iters=1, n_alphas=2)
    assert tps.pmpc_solve.launches == before == 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    args = [torch.from_numpy(a) for a in _problem(np.float64, warm=False)]
    kw = dict(dt=DT, n_iters=1, n_alphas=1)
    with pytest.raises(ValueError, match="wdiag"):
        tps.pmpc_solve(args[0], args[1], args[2][:5], *args[3:], **kw)
    with pytest.raises(TypeError, match="rw"):
        tps.pmpc_solve(*args[:3], args[3].float(), *args[4:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        V0 = args[6].transpose(0, 1).contiguous().transpose(0, 1)
        tps.pmpc_solve(*args[:6], V0, **kw)
    with pytest.raises(ValueError, match="meta"):
        tps.pmpc_solve(*(a.to("meta") for a in args), **kw)


def _boxqp_problems(dtype):
    """Random PD 2x2 problems whose solutions are interior, on one bound or
    on both, by scaling the linear term."""
    rng = np.random.default_rng(7)
    L = 3 * B
    M = rng.normal(size=(L, 2, 2))
    Quu = M @ np.swapaxes(M, 1, 2) + 0.1 * np.eye(2)
    scale = np.repeat([0.02, 1.0, 50.0], B)
    Qu = rng.normal(size=(L, 2)) * scale[:, None]
    v = rng.uniform(-0.6, 0.6, size=(L, 2))
    lo, hi = -0.6 - v, 0.6 - v

    def tl(x):
        return np.ascontiguousarray(np.moveaxis(x, 0, -1).astype(dtype))

    return tl(Quu), tl(Qu), tl(lo), tl(hi)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_boxqp2_lanes_matches_jax(dtype):
    probs = _boxqp_problems(dtype)
    d_j, free_j = jric._boxqp2_lanes(*map(jnp.asarray, probs))
    d_t, free_t = lanes._boxqp2_lanes(*map(torch.from_numpy, probs))
    np.testing.assert_array_equal(free_t.numpy(), np.asarray(free_j))
    atol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=atol)
    n_free = free_t.numpy().sum(axis=0)
    # every regime is exercised: interior, one bound active, both active
    for k in (0, 1, 2):
        assert np.sum(n_free == k) >= 20, (k, np.bincount(n_free.astype(int)))


def test_boxqp2_lanes_exact_tie_keeps_first_candidate():
    """Unconstrained optimum exactly on the upper bound of d0: the interior
    candidate (s0, s1) = (0, 0) and the d0-at-hi candidate (2, 0) have the
    same objective. The strict `<` keeps the first, so both axes stay free
    (this decides which gains the backward pass masks)."""
    L = 4
    hi0 = np.array([0.25, 0.5, 0.125, 1.0])
    Quu = np.zeros((2, 2, L))
    Quu[0, 0] = Quu[1, 1] = 1.0
    Qu = np.stack([-hi0, np.full(L, 0.1)])
    lo = np.stack([-hi0 - 1.0, np.full(L, -1.0)])
    hi = np.stack([hi0, np.full(L, 1.0)])
    d_j, free_j = jric._boxqp2_lanes(*map(jnp.asarray, (Quu, Qu, lo, hi)))
    d_t, free_t = lanes._boxqp2_lanes(*map(torch.from_numpy,
                                           (Quu, Qu, lo, hi)))
    np.testing.assert_array_equal(np.asarray(free_j), 1.0)
    np.testing.assert_array_equal(free_t.numpy(), np.asarray(free_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_lane_helpers_match_jax():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(2, 6, B))
    v = rng.normal(size=(6, B))
    M = rng.normal(size=(6, 6, B))
    w = rng.normal(size=(6, B))
    np.testing.assert_array_equal(
        lanes._mv(torch.from_numpy(a), torch.from_numpy(v)).numpy(),
        np.asarray(jric._mv(jnp.asarray(a), jnp.asarray(v))))
    np.testing.assert_array_equal(
        lanes._add_diag_vec(torch.from_numpy(M), torch.from_numpy(w)).numpy(),
        np.asarray(jric._add_diag_vec(jnp.asarray(M), jnp.asarray(w))))
    np.testing.assert_array_equal(
        lanes._diag_embed(torch.from_numpy(w)).numpy(),
        np.asarray(jps._diag_embed(jnp.asarray(w))))
    # The helpers the Riccati and RMPC kernels add: products summed in the
    # same order, so bitwise equal in float64; the RK4 chain rule and the
    # gains compose a few of them.
    b = rng.normal(size=(6, 3, B))
    np.testing.assert_array_equal(
        lanes._mm(torch.from_numpy(M), torch.from_numpy(b)).numpy(),
        np.asarray(jric._mm(jnp.asarray(M), jnp.asarray(b))))
    np.testing.assert_array_equal(lanes._mT(torch.from_numpy(b)).numpy(),
                                  np.asarray(jric._mT(jnp.asarray(b))))
    r = rng.uniform(1e-7, 1e-5, B)
    for val in (0.25, r):
        np.testing.assert_array_equal(
            lanes._add_diag(torch.from_numpy(M), torch.as_tensor(val)
                            if np.ndim(val) else val).numpy(),
            np.asarray(jric._add_diag(jnp.asarray(M), jnp.asarray(val)
                                      if np.ndim(val) else val)))
    np.testing.assert_array_equal(
        lanes._scale_add_eye(torch.from_numpy(M), 0.01).numpy(),
        np.asarray(jric._scale_add_eye(jnp.asarray(M), 0.01)))
    Quu = rng.normal(size=(2, 2, B)) + 3 * np.eye(2)[..., None]
    free = rng.integers(0, 2, size=(2, B)).astype(np.float64)
    cols = [(rng.normal(size=B), rng.normal(size=B)) for _ in range(3)]
    got = lanes._gains_lanes(torch.from_numpy(Quu), torch.from_numpy(free),
                             [tuple(map(torch.from_numpy, c)) for c in cols])
    want = jric._gains_lanes(jnp.asarray(Quu), jnp.asarray(free),
                             [tuple(map(jnp.asarray, c)) for c in cols])
    for (g0, g1), (w0, w1) in zip(got, want):
        np.testing.assert_array_equal(g0.numpy(), np.asarray(w0))
        np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))

    def model(xp):
        def f(x, v):
            return xp.stack([x[1], -0.5 * x[0] + v[0] * x[1]])

        def jac(x, v):
            z, o = 0.0 * x[0], 1.0 + 0.0 * x[0]
            A = xp.stack([xp.stack([z, o]), xp.stack([-0.5 + z, v[0]])])
            Bm = xp.stack([xp.stack([z]), xp.stack([x[1]])])
            return A, Bm
        return f, jac

    x = rng.normal(size=(2, B))
    v = rng.normal(size=(1, B))
    got = lanes._rk4_jac_lanes(*model(torch), torch.from_numpy(x),
                               torch.from_numpy(v), 0.002)
    want = jric._rk4_jac_lanes(*model(jnp), jnp.asarray(x), jnp.asarray(v),
                               0.002)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15,
                                   atol=1e-15)
