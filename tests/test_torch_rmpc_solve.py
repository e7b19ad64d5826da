"""Port parity: the whole slew-exact RMPC solve
(`dart_tpu_torch.ops.kernels.rmpc_solve`, plain PyTorch version of
`csrc/rmpc_solve.cu`) against `dart_tpu`'s Pallas kernel on the same numpy
problems, at tests/test_rmpc_solve_kernel.py's size (B=128, N=6, 2
iterations x 3 alphas x 2 AL rounds).

The Pallas kernel runs as the JAX package's tests run it on the CPU:
float64 through `rmpc_solve_pallas(interpret=True)`, with its loops rolled
(`roll_loops=True`, the same per-element operations; the interpreter then
compiles one iteration body instead of four, 35 s instead of 200 s).
float32 runs the kernel body `_rmpc_kernel` eagerly on whole arrays (the
same operations again, without the interpreter's compile). Each JAX run is
made once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.control.reference import build_ref_traj
from dart_tpu.ops.pallas import rmpc_solve as jrs
from dart_tpu_torch.models import dynamics as tdyn
from dart_tpu_torch.ops.kernels import rmpc_solve as trs
from dart_tpu_torch.solver import ilqr as tilqr
from dart_tpu_torch.solver import ocp as tocp

B, N, DT = 128, 6, 0.02
KW = dict(dt=DT, u_bound=0.4, du_bound=0.05, vmax=0.25, v_eps=0.1,
          n_iters=2, n_alphas=3, al_rounds=2)


def _problem(seed=2, fast_lanes=True):
    """tests/test_rmpc_solve_kernel.py's scenario, with a random warm start
    partly outside +-du_bound (the solve clips it first) and, with
    `fast_lanes`, a quarter of the lanes starting past the velocity caps so
    the AL rows and multiplier updates act."""
    rng = np.random.default_rng(seed)
    thetas = rng.normal(size=(B, 14)) * 0.3
    states = rng.normal(size=(B, 4)) * 0.05
    if fast_lanes:
        states[:B // 4, 1] = rng.uniform(-0.35, 0.35, B // 4)
    up0 = rng.uniform(-0.1, 0.1, (B, 2))
    tmask = np.array([1, 0, 1, 0.])
    targets = rng.uniform(-0.08, 0.08, (B, 4)) * tmask
    refs = np.asarray(jax.vmap(lambda s, t: build_ref_traj(
        s * jnp.asarray(tmask), t, N, 0.2))(jnp.asarray(states),
                                           jnp.asarray(targets)))
    z0 = np.concatenate([states, up0], -1)
    V0 = rng.uniform(-0.08, 0.08, (B, N, 2))
    w = np.stack([np.full(B, v) for v in (100.0, 1.0, 0.05, 1.0)])
    bl = lambda x: np.ascontiguousarray(np.moveaxis(x, 0, -1))  # noqa
    return [bl(thetas), bl(refs), w, bl(z0), bl(V0)]


def _plain(args, dtype=np.float64, **over):
    out = trs.rmpc_solve(*(torch.from_numpy(a.astype(dtype)) for a in args),
                         **{**KW, **over})
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


def _kernel_body(args, dtype):
    ins = [_Ref(a.astype(dtype)) for a in args]
    ins[-1] = _Ref(np.clip(args[-1], -KW["du_bound"],
                           KW["du_bound"]).astype(dtype))
    outs = [_Ref() for _ in range(4)]
    jrs._rmpc_kernel(N, KW["n_iters"], KW["n_alphas"], KW["al_rounds"], DT,
                     KW["u_bound"], KW["du_bound"], KW["vmax"], KW["v_eps"],
                     10.0, 10.0, 1e8, 1e-8, False, *ins, *outs)
    V, c, v, g = (np.asarray(o.x) for o in outs)
    return [V, c[0], v[0], g[0]]


@pytest.fixture(scope="module")
def jax_runs():
    args = _problem()
    f64 = jrs.rmpc_solve_pallas(*(jnp.asarray(a) for a in args), **KW,
                                interpret=True, roll_loops=True)
    return dict(args=args, f64=[np.asarray(x) for x in f64],
                f32=_kernel_body(args, np.float32))


def test_plain_matches_pallas_kernel_float64(jax_runs):
    """Same operations in the same order: agreement to a few ulps (the
    transcendentals come from different libraries)."""
    V, cost, viol, gn = _plain(jax_runs["args"])
    Vj, cj, vj, gj = jax_runs["f64"]
    np.testing.assert_allclose(V, Vj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(cost, cj, rtol=1e-12, atol=0)
    np.testing.assert_allclose(viol, vj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gn, gj, rtol=0, atol=1e-12)
    assert (vj > 0).any()           # the AL rows were active somewhere
    assert np.abs(V).max() <= KW["du_bound"]


def test_plain_matches_kernel_body_float32(jax_runs):
    """float32: a few ulps per operation through 4 Newton iterations; the
    line search accepts on c_new < cost - 1e-12, below float32's
    resolution, so a lane at a near tie may take another alpha. Bounds
    well inside tests/test_rmpc_solve_kernel.py's (cost rtol 5e-3, p99
    |dV0| 2e-3, viol atol 1e-4)."""
    V, cost, viol, gn = _plain(jax_runs["args"], np.float32)
    Vj, cj, vj, gj = jax_runs["f32"]
    assert V.dtype == np.float32
    dV0 = np.abs(V[0] - Vj[0])
    assert np.percentile(dV0, 99) < 1e-4, np.percentile(dV0, 99)
    assert np.abs(V - Vj).max() < 2e-3
    np.testing.assert_allclose(cost, cj, rtol=1e-5, atol=0)
    np.testing.assert_allclose(viol, vj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gn, gj, rtol=0, atol=2e-3)


def test_plain_matches_generic_al_solver():
    """tests/test_rmpc_solve_kernel.py's own check, on the port: the whole
    solve and `ilqr.solve_batch` on the slew-exact OCP at a matched budget
    reach the same solution, to that test's tolerances."""
    args = _problem(fast_lanes=False)
    V, cost, viol, _ = _plain(args[:4] + [np.zeros((N, 2, B))], np.float32)
    th, ref, w, z0 = (torch.from_numpy(np.moveaxis(a, -1, 0).copy()
                                       .astype(np.float32))
                      for a in (args[0], args[1], args[2], args[3]))
    params = tdyn.RMPCParams(theta=th, g=torch.full((B,), -9.81),
                             v_eps=torch.full((B,), 0.1))
    aux = tocp.RMPCAux(ref=ref, Qp=w[:, 0], Qv=w[:, 1], Ru=w[:, 2],
                       Rdu=w[:, 3])
    ocp = tocp.make_rmpc_ocp_du(dt=DT, u_bound=0.4, du_bound=0.05,
                                vmax=0.25)
    cfg = tilqr.ILQRConfig(max_iters=2, n_alphas=3, al_iters=2,
                           reg_init=1e-9, tol_cost=1e-9)
    sol = tilqr.solve_batch(ocp, cfg, params, aux, z0,
                            torch.zeros((B, N, 2)))
    np.testing.assert_allclose(cost, sol.cost.numpy(), rtol=5e-3, atol=1e-4)
    d = np.abs(V[0].T - sol.V[:, 0].numpy())
    assert np.percentile(d, 99) < 2e-3, np.percentile(d, 99)
    np.testing.assert_allclose(viol, sol.viol.numpy(), atol=1e-4)


def test_nan_lane_reports_nan_and_leaves_others_alone():
    args = _problem(3)
    clean = _plain(args)
    args[0] = args[0].copy()
    args[0][:, 7] = np.nan
    V, cost, viol, gn = _plain(args)
    assert np.isnan(viol[7]) or np.isnan(gn[7])
    rest = np.arange(B) != 7
    for got, want in zip((V, cost, viol, gn), clean):
        np.testing.assert_array_equal(got[..., rest], want[..., rest])


def test_trial_count_and_work():
    """The plain version counts the line-search trials the kernel runs
    (it stops at a lane's first accepted alpha and skips done lanes);
    `work` turns them into the call's FLOPs and bytes."""
    args = _problem(4)
    stats = {}
    trs.rmpc_solve_reference(*(torch.from_numpy(a) for a in args), **KW,
                             stats=stats)
    trials = stats["trials"].numpy()
    budget = KW["n_iters"] * KW["al_rounds"]
    assert trials.shape == (B,)
    assert np.all(trials <= budget * KW["n_alphas"])
    assert trials.sum() >= B                     # every lane searched
    flops, trans, nbytes = trs.work(N, KW["n_iters"], KW["al_rounds"], B,
                                    int(trials.sum()), 8)
    full, full_t = trs.flops_per_solve(N, KW["n_iters"], KW["n_alphas"],
                                       KW["al_rounds"])
    assert flops <= B * full and trans <= B * full_t
    ins = sum(a.size for a in args) * 8
    outs = (N * 2 * B + 3 * B) * 8
    assert nbytes == ins + outs


def test_work_counts_the_structural_nonzeros():
    """`work` counts the products over the model's structural non-zeros:
    they are exactly those of `rmpc_jac`'s A (with its two unit entries)
    and B at random states, and the RK4 step's (Ad, Bd) come out dense, as
    the mask propagation finds. The recount is below the dense algebra as
    written (2224 FLOPs per backward stage, ~950 of them the RK4 chain)."""
    rng = np.random.default_rng(6)
    L = 64
    x = torch.from_numpy(rng.normal(size=(L, 4)) * 0.1)
    u = torch.from_numpy(rng.uniform(-0.4, 0.4, (L, 2)))
    p = tdyn.RMPCParams(
        theta=torch.from_numpy(rng.normal(size=(L, 14)) * 0.3),
        g=torch.full((L,), -9.81, dtype=torch.float64),
        v_eps=torch.full((L,), 0.1, dtype=torch.float64))
    A, Bm = tdyn.rmpc_jac(x, u, p)
    Ad, Bd = tdyn.rk4_jac(tdyn.rmpc_dynamics, tdyn.rmpc_jac, x, u, p, DT)
    A_nz = trs._mask((4, 4), trs.A_NZ)
    B_nz = trs._mask((4, 2), trs.B_NZ)
    Ad_nz, Bd_nz, jac = trs._rk4_jac_counts()
    for got, want in ((A, A_nz), (Bm, B_nz), (Ad, Ad_nz), (Bd, Bd_nz)):
        np.testing.assert_array_equal((got != 0).numpy(),
                                      want.expand_as(got).numpy())
    unit = trs._mask((4, 4), trs.A_UNIT)
    assert bool((A[:, unit] == 1).all())
    assert int(A_nz.sum()) == 10 and int(B_nz.sum()) == 2
    assert int(Ad_nz.sum()) == 16 and int(Bd_nz.sum()) == 8
    assert jac < 950 // 2
    back = trs._stage_counts(N)
    assert back < N * 2224
    full, _ = trs.flops_per_solve(N, KW["n_iters"], KW["n_alphas"],
                                  KW["al_rounds"])
    assert full > KW["al_rounds"] * KW["n_iters"] * back


def test_wrapper_rejects_bad_inputs():
    args = [torch.from_numpy(a) for a in _problem(5)]
    bad = list(args)
    bad[1] = bad[1][:-1]
    with pytest.raises(ValueError, match="ref must be"):
        trs.rmpc_solve(*bad, **KW)
    with pytest.raises(ValueError, match="V0 must be"):
        trs.rmpc_solve(*args[:4], args[4][:, 0], **KW)
    with pytest.raises(TypeError, match="float32 or float64"):
        trs.rmpc_solve(*args[:4], args[4].half(), **KW)
