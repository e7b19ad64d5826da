"""Port parity: the whole LMPC box-DDP solve
(`dart_tpu_torch.ops.kernels.lmpc_solve`, plain PyTorch version of
`csrc/lmpc_solve.cu`) against `dart_tpu`'s Pallas kernel on the same numpy
problems, at tests/test_lmpc_solve_kernel.py's size (B=128, N=6, 2
iterations x 3 alphas).

The JAX side runs the kernel body `_lmpc_kernel` eagerly on whole arrays:
the same per-element operations as `lmpc_solve_pallas(interpret=True)`,
without the interpreter, which takes minutes at this size. The wrapper's
clip of V0 is applied before the body, as `lmpc_solve_pallas` does. Each
JAX run is made once per module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.control.mpc import LMPC_DEFAULT_WEIGHTS
from dart_tpu.ops.pallas import lmpc_solve as jls
from dart_tpu_torch.models import dynamics as tdyn
from dart_tpu_torch.ops.kernels import lmpc_solve as tls
from dart_tpu_torch.solver import ilqr as tilqr
from dart_tpu_torch.solver import ocp as tocp

B, N, DT, U_BOUND = 128, 6, 0.02, 0.4
KW = dict(dt=DT, u_bound=U_BOUND, n_iters=2, n_alphas=3)


def _problem(seed=1, V_scale=0.6):
    """tests/test_lmpc_solve_kernel.py's scenario (pvecs U(0.05, 0.5),
    targets U(-0.08, 0.08) on px/py, x0 ~ N(0, 0.02^2)), with a previous
    tilt and a random warm start partly outside +-u_bound (the solve clips
    it first). Batch-last numpy arrays."""
    rng = np.random.default_rng(seed)
    pvecs = rng.uniform(0.05, 0.5, (B, 34))
    tmask = np.array([1, 0, 1, 0, 0, 0, 0, 0.])
    tgts = rng.uniform(-0.08, 0.08, (B, 8)) * tmask
    x0 = rng.normal(size=(B, 8)) * 0.02
    up0 = rng.uniform(-0.2, 0.2, (B, 2))
    z0 = np.concatenate([x0, up0], -1)
    V0 = rng.uniform(-V_scale, V_scale, (B, N, 2))
    w = LMPC_DEFAULT_WEIGHTS

    def bl(x, n=None):
        x = np.broadcast_to(np.asarray(x, np.float64), (B, n)) if n else x
        return np.ascontiguousarray(np.moveaxis(x, 0, -1))

    return [bl(pvecs), bl(w.Q, 8), bl(w.R, 4), bl(w.Qt, 8), bl(tgts),
            bl(z0), bl(V0)]


def _plain(args, dtype=np.float64, stats=None):
    ts = [torch.from_numpy(a.astype(dtype)) for a in args]
    if stats is not None:
        out = tls.lmpc_solve_reference(*ts, **KW, stats=stats)
    else:
        out = tls.lmpc_solve(*ts, **KW)
    return [o.numpy() for o in out]


class _Ref:
    """A whole array standing in for a Pallas ref in the eager body."""

    def __init__(self, x=None):
        self.x = None if x is None else jnp.asarray(x)

    def __getitem__(self, idx):
        return self.x[idx]

    def __setitem__(self, idx, value):
        assert idx is Ellipsis
        self.x = value


def kernel_fn(N, dt, n_iters=KW["n_iters"], n_alphas=KW["n_alphas"],
              roll=False):
    """`_lmpc_kernel` as a function of whole batch-last arrays (pvec, Q, R,
    Qt, target, z0, V0) -> (V, cost, gnorm), with lo/hi lanes at
    +-u_bound. Eager as it is; under jax.jit with `roll` its iteration loop
    is one fori_loop body, which compiles in half the time of the unrolled
    loops."""

    def body(*args):
        lo = jnp.full((2, args[-1].shape[-1]), -U_BOUND, args[-1].dtype)
        ins = [_Ref(a) for a in (*args, lo, -lo)]
        outs = [_Ref() for _ in range(3)]
        jls._lmpc_kernel(N, n_iters, n_alphas, dt, roll, *ins, *outs)
        return outs[0].x, outs[1].x[0], outs[2].x[0]

    return body


def kernel_body(args, dtype):
    """The eager body on batch-last numpy arrays, V0 clipped first as
    `lmpc_solve_pallas` does. Returns numpy (V, cost, gnorm)."""
    V0 = np.clip(args[-1], -U_BOUND, U_BOUND)
    out = kernel_fn(V0.shape[0], DT)(*(a.astype(dtype) for a in args[:6]),
                                     V0.astype(dtype))
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def jax_runs():
    args = _problem()
    return dict(args=args, f64=kernel_body(args, np.float64),
                f32=kernel_body(args, np.float32))


def test_plain_matches_kernel_body_float64(jax_runs):
    """Same operations in the same order: agreement to a few ulps (the
    transcendentals come from different libraries), held at 1e-9."""
    V, cost, gn = _plain(jax_runs["args"])
    Vj, cj, gj = jax_runs["f64"]
    np.testing.assert_allclose(V, Vj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(cost, cj, rtol=1e-9, atol=0)
    np.testing.assert_allclose(gn, gj, rtol=0, atol=1e-9)
    # The warm start reached outside the box and came back inside it; some
    # controls sit on the bound.
    assert np.abs(jax_runs["args"][-1]).max() > U_BOUND
    assert np.abs(V).max() <= U_BOUND
    assert (np.abs(V) == U_BOUND).any()


def test_plain_matches_kernel_body_float32(jax_runs):
    """float32: a few ulps per operation through 2 Newton iterations; the
    line search accepts on c_new < cost - 1e-12, below float32's
    resolution, so a lane at a near tie may take another alpha. Held to
    tests/test_lmpc_solve_kernel.py's rule: cost rtol 5e-3 + atol 1e-4,
    99th percentile of |dV0| < 5e-3."""
    V, cost, gn = _plain(jax_runs["args"], np.float32)
    Vj, cj, gj = jax_runs["f32"]
    assert V.dtype == cost.dtype == gn.dtype == np.float32
    np.testing.assert_allclose(cost, cj, rtol=5e-3, atol=1e-4)
    dV0 = np.abs(V[0] - Vj[0])
    assert np.percentile(dV0, 99) < 5e-3, np.percentile(dV0, 99)
    assert np.all(np.abs(V) <= U_BOUND + 1e-6)


def test_v0_outside_the_box_is_clipped():
    """The solve starts from clip(V0): a warm start far outside the box
    gives the same answer as its clipped copy."""
    args = _problem(2, V_scale=3.0)
    clipped = args[:-1] + [np.clip(args[-1], -U_BOUND, U_BOUND)]
    for got, want in zip(_plain(args), _plain(clipped)):
        np.testing.assert_array_equal(got, want)


def test_plain_matches_generic_solver():
    """tests/test_lmpc_solve_kernel.py's own check, on the port: the whole
    solve and `ilqr.solve_batch` on the generic LMPC OCP at a matched
    budget reach the same solution, to that test's tolerances."""
    args = _problem(V_scale=0.0)
    args[5] = args[5].copy()
    args[5][8:] = 0.0
    V, cost, _ = _plain(args, np.float32)
    pv, Q, R, Qt, tg, z0 = (torch.from_numpy(np.moveaxis(a, -1, 0).copy()
                                             .astype(np.float32))
                            for a in args[:6])
    aux = tocp.LMPCAux(target=tg, Q=Q, R=R, Qt=Qt)
    ocp = tocp.make_lmpc_ocp(dt=DT, u_bound=U_BOUND)
    cfg = tilqr.ILQRConfig(max_iters=2, n_alphas=3, reg_init=1e-9,
                           tol_cost=1e-9)
    sol = tilqr.solve_batch(ocp, cfg, pv, aux, z0,
                            torch.zeros((B, N, 2), dtype=torch.float32))
    np.testing.assert_allclose(cost, sol.cost.numpy(), rtol=5e-3, atol=1e-4)
    d = np.abs(V[0].T - sol.V[:, 0].numpy())
    assert np.percentile(d, 99) < 5e-3, np.percentile(d, 99)


def test_nan_lane_reports_nan_and_leaves_others_alone():
    args = _problem(3)
    clean = _plain(args)
    args[0] = args[0].copy()
    args[0][:, 7] = np.nan
    V, cost, gn = _plain(args)
    assert np.isnan(cost[7]) and np.isnan(gn[7])
    rest = np.arange(B) != 7
    for got, want in zip((V, cost, gn), clean):
        np.testing.assert_array_equal(got[..., rest], want[..., rest])


def test_trial_count_and_work():
    """The plain version counts the line-search trials the kernel runs
    (it stops at a lane's first accepted alpha and skips done lanes);
    `work` turns them into the call's FLOPs and bytes."""
    args = _problem(4)
    stats = {}
    _plain(args, stats=stats)
    trials = stats["trials"].numpy()
    assert trials.shape == (B,)
    assert np.all(trials <= KW["n_iters"] * KW["n_alphas"])
    assert trials.sum() >= B                     # every lane searched
    flops, trans, nbytes = tls.work(N, KW["n_iters"], B, int(trials.sum()), 8)
    full, full_t = tls.flops_per_solve(N, KW["n_iters"], KW["n_alphas"])
    assert flops <= B * full and trans <= B * full_t
    ins = sum(a.size for a in args) * 8
    outs = (N * 2 * B + 2 * B) * 8
    assert nbytes == ins + outs


def test_work_counts_the_structural_nonzeros():
    """`work` counts the products over the model's structural non-zeros:
    they are exactly those of `lmpc_jac`'s A and B at random states, and
    those of the RK4 step's (Ad, Bd), two 4x4 blocks, as its mask
    propagation finds."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(64, 8)) * 0.3)
    u = torch.from_numpy(rng.uniform(-0.4, 0.4, (64, 2)))
    p = torch.from_numpy(rng.uniform(0.05, 0.5, (64, 34)))
    A, Bm = tdyn.lmpc_jac(x, u, p)
    Ad, Bd = tdyn.rk4_jac(tdyn.lmpc_dynamics, tdyn.lmpc_jac, x, u, p, DT)
    A_nz = tls._mask((8, 8), tls.A_NZ)
    B_nz = tls._mask((8, 2), tls.B_NZ)
    Ad_nz, Bd_nz, _ = tls._rk4_jac_counts()
    for got, want in ((A, A_nz), (Bm, B_nz), (Ad, Ad_nz), (Bd, Bd_nz)):
        np.testing.assert_array_equal((got != 0).numpy(),
                                      want.expand_as(got).numpy())
    assert int(Ad_nz.sum()) == 32 and int(Bd_nz.sum()) == 8
    # The dense 8x8 algebra as written would count over 3x more.
    back, _ = tls._stage_counts(N)
    assert back < N * 3000


def test_wrapper_rejects_bad_inputs():
    args = [torch.from_numpy(a) for a in _problem(5)]
    bad = list(args)
    bad[0] = bad[0][:-1]
    with pytest.raises(ValueError, match="pvec must be"):
        tls.lmpc_solve(*bad, **KW)
    with pytest.raises(ValueError, match="V0 must be"):
        tls.lmpc_solve(*args[:6], args[6][:, 0], **KW)
    with pytest.raises(TypeError, match="float32 or float64"):
        tls.lmpc_solve(*args[:6], args[6].half(), **KW)
