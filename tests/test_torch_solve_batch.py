"""Port parity: the batched constrained box-DDP solver
(`dart_tpu_torch.solver.ilqr.solve_batch`, its linearisation and
certificates) and the structure-exploiting PMPC solver
(`dart_tpu_torch.solver.pmpc_fast.solve_batch_fast`) against `dart_tpu`'s
on the same numpy problems. On the CPU the Riccati backward pass is the
plain version of `csrc/riccati.cu`; JAX runs its XLA scan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.control.reference import build_ref_traj
from dart_tpu.models import dynamics as jdyn
from dart_tpu.solver import ilqr as jilqr
from dart_tpu.solver import ocp as jocp
from dart_tpu.solver import pmpc_fast as jfast
from dart_tpu_torch.models import dynamics as tdyn
from dart_tpu_torch.solver import ilqr as tilqr
from dart_tpu_torch.solver import ocp as tocp
from dart_tpu_torch.solver import pmpc_fast as tfast
from dart_tpu_torch.utils.convert import from_jax

B, N, DT = 6, 10, 0.02
# float64: both sides run the same iterations with the same masks; the
# only differences are the summation order of small products (XLA's dot
# against the lane algebra and torch.matmul), a few ulps per iteration.
ATOL = 1e-10


def _rmpc_problem(seed=2, V_scale=0.0):
    """tests/test_solve_batch.py:68-96's RMPC scenario."""
    rng = np.random.default_rng(seed)
    thetas = rng.normal(size=(B, 14)) * 0.05
    refs = np.stack([np.asarray(build_ref_traj(
        jnp.zeros(4), jnp.asarray(rng.uniform(-0.08, 0.08, 4)
                                  * np.array([1, 0, 1, 0])), N))
        for _ in range(B)])
    z0 = rng.normal(size=(B, 6)) * 0.02
    V0 = rng.uniform(-1, 1, size=(B, N, 2)) * V_scale
    jp = jdyn.RMPCParams(theta=jnp.asarray(thetas), g=jnp.full(B, -9.81),
                         v_eps=jnp.full(B, 0.1))
    ja = jocp.RMPCAux(ref=jnp.asarray(refs), Qp=jnp.full(B, 100.0),
                      Qv=jnp.full(B, 1.0), Ru=jnp.full(B, 0.05),
                      Rdu=jnp.full(B, 1.0))
    return jp, ja, z0, V0


def _ocps(make, fast, **kw):
    kw = dict(dt=DT, u_bound=0.4, du_bound=0.05, vmax=0.25, fast=fast, **kw)
    return getattr(jocp, make)(**kw), getattr(tocp, make)(**kw)


@pytest.mark.parametrize("make", ["make_rmpc_ocp_du", "make_rmpc_ocp"])
@pytest.mark.parametrize("fast", [False, True])
def test_solve_batch_matches_jax(make, fast):
    jo, to = _ocps(make, fast)
    jp, ja, z0, V0 = _rmpc_problem()
    cfg = dict(max_iters=15, al_iters=3)
    js = jilqr.solve_batch(jo, jilqr.ILQRConfig(**cfg), jp, ja,
                           jnp.asarray(z0), jnp.asarray(V0),
                           use_pallas=False)
    ts = tilqr.solve_batch(to, tilqr.ILQRConfig(**cfg), from_jax(jp, "cpu"),
                           from_jax(ja, "cpu"), torch.from_numpy(z0),
                           torch.from_numpy(V0))
    for name in ("V", "Z", "cost", "viol", "grad_norm"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=0,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(ts.iters.numpy(), np.asarray(js.iters))
    assert int(ts.iters[0]) > 3           # it really iterated
    # The slew-exact OCP keeps only the velocity caps as AL rows, and meets
    # them; make_rmpc_ocp's slew rows are AL rows too, and three rounds
    # leave ~5e-4 on them, on both sides alike.
    assert float(ts.viol.max()) < (1e-5 if make == "make_rmpc_ocp_du"
                                   else 1e-3)


def test_solve_batch_lanes_are_independent():
    """`RMPCBatch`'s rescue solves only the flagged lanes: each lane of a
    sub-batch must get the answer it gets in the whole batch. (The closed
    form linearisation keeps this quick; the masks are the same code.)"""
    _, to = _ocps("make_rmpc_ocp_du", True)
    jp, ja, z0, V0 = _rmpc_problem(3, V_scale=0.03)
    cfg = tilqr.ILQRConfig(max_iters=15, al_iters=3)
    p, a = from_jax(jp, "cpu"), from_jax(ja, "cpu")
    whole = tilqr.solve_batch(to, cfg, p, a, torch.from_numpy(z0),
                              torch.from_numpy(V0))
    idx = torch.tensor([1, 4])

    def rows(t):
        return type(t)(*(x.index_select(0, idx) for x in t))

    part = tilqr.solve_batch(to, cfg, rows(p), rows(a),
                             torch.from_numpy(z0)[idx],
                             torch.from_numpy(V0)[idx])
    for name in ("V", "cost", "viol"):
        np.testing.assert_allclose(getattr(part, name).numpy(),
                                   getattr(whole, name).numpy()[idx],
                                   rtol=0, atol=1e-13, err_msg=name)


def test_clip_tie_derivative_is_one_half():
    """u = clip(u_prev + v, +-u_bound) sits exactly on the bound whenever
    the tilt saturates. jnp.clip's derivative there is 0.5; the port writes
    the clip with torch.minimum/maximum to get the same (torch.clamp gives
    1). The generic linearisation of the slew-exact OCP at such a point
    matches JAX's, and du/du_prev and du/dv are 0.5."""
    jo, to = _ocps("make_rmpc_ocp_du", False)
    jp, ja, _, _ = _rmpc_problem(4)
    z0 = np.zeros((B, 6))
    z0[:, 4] = 0.4                        # u_prev on +u_bound
    z0[:, 5] = -0.4                       # and on -u_bound
    V = np.zeros((B, N, 2))               # so every stage's u is on a tie
    lam = np.zeros((B, N, 4))
    mu = np.full(B, 10.0)
    tp, ta = from_jax(jp, "cpu"), from_jax(ja, "cpu")
    Z = tilqr._rollout(to, tp, torch.from_numpy(z0), torch.from_numpy(V))
    got = tilqr._linearize(to, tp, ta, Z, torch.from_numpy(V),
                           torch.from_numpy(lam), torch.from_numpy(mu))
    want = jax.jit(jax.vmap(lambda p, a, Zl, Vl, ll, m: jilqr._linearize(
        jo, p, a, Zl, Vl, ll, m)))(jp, ja, jnp.asarray(Z.numpy()),
                                   jnp.asarray(V), jnp.asarray(lam),
                                   jnp.asarray(mu))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    A, Bm = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(Z.numpy()[:, :, 4], 0.4)
    np.testing.assert_array_equal(A[:, :, 4, 4], 0.5)
    np.testing.assert_array_equal(A[:, :, 5, 5], 0.5)
    np.testing.assert_array_equal(Bm[:, :, 4, 0], 0.5)
    np.testing.assert_array_equal(Bm[:, :, 5, 1], 0.5)


@pytest.mark.parametrize("make", ["make_pmpc_ocp", "make_rmpc_ocp",
                                  "make_rmpc_ocp_du", "make_lmpc_ocp"])
def test_generic_linearisation_keeps_float32(make):
    """Under torch.func's hessian a python float meeting a 0-d lane value
    promotes it to float64; the OCPs keep their expansions in float32, the
    main path's type, which the Riccati kernel requires of every input."""
    f = torch.float32
    if make == "make_pmpc_ocp":
        o = tocp.make_pmpc_ocp(dt=DT)
        p = tdyn.PMPCParams(mu=torch.full((B,), 0.1, dtype=f), dt=DT)
        a = tocp.PMPCAux(target=torch.full((B, 6), 0.05, dtype=f),
                         Qp=torch.ones(B, dtype=f), Qv=torch.ones(B, dtype=f),
                         R=torch.ones(B, dtype=f))
        nz, n_con = 6, 1
    elif make == "make_lmpc_ocp":
        o = tocp.make_lmpc_ocp(dt=DT)
        p = torch.full((B, 34), 0.2, dtype=f)
        a = tocp.LMPCAux(target=torch.full((B, 8), 0.05, dtype=f),
                         Q=torch.ones((B, 8), dtype=f),
                         R=torch.ones((B, 4), dtype=f),
                         Qt=torch.ones((B, 8), dtype=f))
        nz, n_con = 10, 1
    else:
        o = getattr(tocp, make)(dt=DT)
        p = tdyn.RMPCParams(theta=torch.zeros((B, 14), dtype=f),
                            g=torch.full((B,), -9.81, dtype=f),
                            v_eps=torch.full((B,), 0.1, dtype=f))
        a = tocp.RMPCAux(ref=torch.zeros((B, N + 1, 4), dtype=f),
                         Qp=torch.ones(B, dtype=f), Qv=torch.ones(B, dtype=f),
                         Ru=torch.ones(B, dtype=f), Rdu=torch.ones(B, dtype=f))
        nz, n_con = 6, o.n_con
    Z = torch.zeros((B, N + 1, nz), dtype=f)
    V = torch.full((B, N, 2), 0.01, dtype=f)
    d = tilqr._linearize(o, p, a, Z, V, torch.zeros((B, N, n_con), dtype=f),
                         torch.ones(B, dtype=f))
    assert [x.dtype for x in d] == [f] * 9


def test_constraint_max_and_projected_grad_norm_match_jax():
    jo, to = _ocps("make_rmpc_ocp_du", False)
    jp, ja, z0, _ = _rmpc_problem(5)
    rng = np.random.default_rng(5)
    z0[:, 1] = rng.uniform(-0.4, 0.4, B)   # some lanes past the vx cap
    V = rng.uniform(-0.05, 0.05, (B, N, 2))
    V[0] = 0.05                            # one lane on the slew bound
    args = (jnp.asarray(z0), jnp.asarray(V))
    tp, ta = from_jax(jp, "cpu"), from_jax(ja, "cpu")
    targs = (torch.from_numpy(z0), torch.from_numpy(V))
    want_c = np.asarray(jilqr.constraint_max(jo, jp, ja, *args))
    got_c = tilqr.constraint_max(to, tp, ta, *targs).numpy()
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-12)
    assert (want_c > 0).any() and (want_c < 0).any()
    want_g = np.asarray(jilqr.projected_grad_norm(jo, jp, ja, *args))
    got_g = tilqr.projected_grad_norm(to, tp, ta, *targs).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_batch_fast_matches_jax(dtype):
    Bf, Nf = 16, 12
    rng = np.random.default_rng(1)
    mus = rng.uniform(0.05, 0.2, Bf).astype(dtype)
    tgts = (rng.uniform(-0.1, 0.1, (Bf, 6))
            * np.array([1, 0, 1, 0, 0, 0])).astype(dtype)
    z0 = (rng.normal(size=(Bf, 6)) * 0.02).astype(dtype)
    V0 = rng.uniform(-0.7, 0.7, (Bf, Nf, 2)).astype(dtype)  # some clipped
    full = lambda v: np.full(Bf, v, dtype)                  # noqa: E731
    ja = jocp.PMPCAux(target=jnp.asarray(tgts), Qp=jnp.asarray(full(300.)),
                      Qv=jnp.asarray(full(2.)), R=jnp.asarray(full(.2)))
    jV, jZ, jc = jfast.solve_batch_fast(jnp.asarray(mus), ja,
                                        jnp.asarray(z0), jnp.asarray(V0),
                                        dt=DT, use_pallas=False)
    tV, tZ, tc = tfast.solve_batch_fast(torch.from_numpy(mus),
                                        from_jax(ja, "cpu"),
                                        torch.from_numpy(z0),
                                        torch.from_numpy(V0), dt=DT)
    assert tV.dtype == torch.from_numpy(V0).dtype
    if dtype == np.float64:
        tol = dict(rtol=0, atol=ATOL)
        ctol = dict(rtol=1e-10, atol=0)
    else:
        # float32: four Newton iterations from a far warm start; a few
        # float32 ulps per operation, amplified by the 300-weight costs.
        tol = dict(rtol=0, atol=2e-4)
        ctol = dict(rtol=1e-4, atol=0)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), **tol)
    np.testing.assert_allclose(tZ.numpy(), np.asarray(jZ), **tol)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **ctol)
    assert np.abs(tV.numpy() - np.clip(V0, -0.6, 0.6)).max() > 1e-2
