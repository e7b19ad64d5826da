"""Port parity: the PMPC batch front end (`dart_tpu_torch.control.mpc`)
and the stationarity certificate against `dart_tpu`.

The JAX side runs `PMPCBatch(kernel_interpret=True)`: the whole-solve
Pallas kernel in interpret mode inside JAX's escalation loop. Each JAX
budget compiles once per module (module-scoped fixtures), at N=4 to keep
interpret mode affordable on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.control import mpc as jmpc
from dart_tpu.models import dynamics as jdyn
from dart_tpu.solver import ilqr as jilqr
from dart_tpu.solver import ocp as jocp
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.models import dynamics as tdyn
from dart_tpu_torch.solver import ilqr as tilqr
from dart_tpu_torch.solver import ocp as tocp
from dart_tpu_torch.utils.convert import from_jax, to_numpy

B, N, DT = 128, 4, 0.01
# float64 throughout: both sides run the same operations in the same order,
# so solutions agree to a few ulps; 1e-9 leaves a wide margin.
ATOL = 1e-9


def _scenario(seed, spread=0.12):
    """States, targets, shared mu as the JAX escalation tests draw them
    (tests/test_pmpc_solve_kernel.py:98-105)."""
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(B, 6)) * 0.05
    z = np.zeros(B)
    tgts = np.stack([rng.uniform(-spread, spread, B), z,
                     rng.uniform(-spread, spread, B), z,
                     np.full(B, 0.43), z], -1)
    return states, tgts


def _jax_solver(ctlr, states, tgts):
    """One jitted JAX solve (one compile) from a numpy warm start."""
    params = jdyn.PMPCParams(mu=jnp.asarray(0.1), dt=DT)
    w = jmpc.PMPC_WEIGHTS["general"]
    solve = jax.jit(lambda c: ctlr.solve(c, jnp.asarray(states),
                                         jnp.asarray(tgts), params, w))
    return lambda V: solve(jmpc.PMPCCarry(V=jnp.asarray(V)))


def _torch_solve(ctlr, states, tgts, V):
    params = tdyn.PMPCParams(mu=0.1, dt=DT)
    w = tmpc.PMPC_WEIGHTS["general"]
    return ctlr.solve(tmpc.PMPCCarry(V=torch.from_numpy(V)),
                      torch.from_numpy(states), torch.from_numpy(tgts),
                      params, w)


def _assert_same(t_out, j_out):
    (t_carry, t_u, t_diag), (j_carry, j_u, j_diag) = t_out, j_out
    np.testing.assert_allclose(t_u.numpy(), np.asarray(j_u), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(t_carry.V.numpy(), np.asarray(j_carry.V),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_diag.cost.numpy(), np.asarray(j_diag.cost),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(t_diag.grad_norm.numpy(),
                               np.asarray(j_diag.grad_norm), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(t_diag.iters.numpy(),
                                  np.asarray(j_diag.iters))


@pytest.fixture(scope="module")
def warm_budget():
    """Default budget (2 iters x 3 alphas, <= 2 extra rounds): a cold solve,
    the warm solve that follows it, and a cold solve with lane 0's warm
    start poisoned to NaN."""
    states, tgts = _scenario(3, spread=0.1)
    zeros = np.zeros((B, N, 2))
    poisoned = zeros.copy()
    poisoned[0] = np.nan
    solve = _jax_solver(jmpc.PMPCBatch(N=N, dt=DT, kernel_max_extra_rounds=2,
                                       kernel_interpret=True), states, tgts)
    cold = solve(zeros)
    warm = solve(np.asarray(cold[0].V))
    bad = solve(poisoned)
    return dict(states=states, tgts=tgts, zeros=zeros, poisoned=poisoned,
                cold=cold, warm=warm, bad=bad)


def test_pmpc_batch_solve_matches_jax(warm_budget):
    ctlr = tmpc.PMPCBatch(N=N, dt=DT, kernel_max_extra_rounds=2)
    s, t = warm_budget["states"], warm_budget["tgts"]
    cold = _torch_solve(ctlr, s, t, warm_budget["zeros"])
    _assert_same(cold, warm_budget["cold"])
    warm = _torch_solve(ctlr, s, t, cold[0].V.numpy())
    _assert_same(warm, warm_budget["warm"])


def test_escalation_rescues_nan_lane(warm_budget):
    """A lane whose warm start is NaN restarts cold before the extra round
    and ends near the clean solve's control; the other lanes are untouched,
    as on the JAX side (tests/test_pmpc_solve_kernel.py:129). The port
    matches JAX's own run of the poisoned batch to roundoff."""
    ctlr = tmpc.PMPCBatch(N=N, dt=DT, kernel_max_extra_rounds=2)
    s, t = warm_budget["states"], warm_budget["tgts"]
    bad = _torch_solve(ctlr, s, t, warm_budget["poisoned"])
    clean = _torch_solve(ctlr, s, t, warm_budget["zeros"])
    u_bad, u_clean = bad[1].numpy(), clean[1].numpy()
    assert np.all(np.isfinite(u_bad))
    assert int(bad[2].iters[0]) > ctlr.kernel_iters   # it escalated
    # The rescued lane restarts one round (2 iterations) later than the
    # clean lane, so it sits one Newton round short of it: ~1e-4 here.
    np.testing.assert_allclose(u_bad[0], u_clean[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(u_bad[1:], u_clean[1:], rtol=0, atol=ATOL)
    _assert_same(bad, warm_budget["bad"])


def test_starved_budget_escalates_like_jax():
    """1 iter x 1 alpha leaves lanes non-stationary; the batch re-solves warm
    while max gnorm > tol. The JAX side must itself take extra rounds, so
    the case really exercises escalation; the port takes the same rounds
    and ends at the same solution."""
    states, tgts = _scenario(1)
    zeros = np.zeros((B, N, 2))
    jctlr = jmpc.PMPCBatch(N=N, dt=DT, kernel_iters=1, kernel_alphas=1,
                           kernel_max_extra_rounds=3, kernel_interpret=True)
    j_out = _jax_solver(jctlr, states, tgts)(zeros)
    assert int(j_out[2].iters[0]) >= 2          # >= 1 extra round in JAX
    esc = tmpc.PMPCBatch(N=N, dt=DT, kernel_iters=1, kernel_alphas=1,
                         kernel_max_extra_rounds=3)
    t_out = _torch_solve(esc, states, tgts, zeros)
    _assert_same(t_out, j_out)
    starved = tmpc.PMPCBatch(N=N, dt=DT, kernel_iters=1, kernel_alphas=1,
                             kernel_max_extra_rounds=0)
    s_out = _torch_solve(starved, states, tgts, zeros)
    g0 = float(s_out[2].grad_norm.max())
    g3 = float(t_out[2].grad_norm.max())
    assert g0 > esc.kernel_tol_grad, g0
    assert g3 < g0 / 2, (g0, g3)
    assert float(t_out[2].cost.mean()) <= float(s_out[2].cost.mean())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_projected_grad_norm_matches_jax(dtype):
    rng = np.random.default_rng(11)
    Nh = 15
    z0 = (rng.normal(size=(B, 6)) * 0.05).astype(dtype)
    V = rng.uniform(-0.7, 0.7, size=(B, Nh, 2)).astype(dtype)
    mus = rng.uniform(0.05, 0.2, B).astype(dtype)
    tgts = (rng.uniform(-0.1, 0.1, (B, 6)) *
            np.array([1, 0, 1, 0, 0, 0])).astype(dtype)
    full = lambda v: np.full(B, v, dtype)        # noqa: E731
    jaux = jocp.PMPCAux(target=jnp.asarray(tgts), Qp=jnp.asarray(full(300.)),
                        Qv=jnp.asarray(full(2.)), R=jnp.asarray(full(.2)))
    want = np.asarray(jilqr.projected_grad_norm(
        jocp.make_pmpc_ocp(dt=0.002), jdyn.PMPCParams(mu=jnp.asarray(mus),
                                                      dt=0.002),
        jaux, jnp.asarray(z0), jnp.asarray(V)))
    taux = from_jax(jaux, "cpu")
    got = tilqr.projected_grad_norm(
        tocp.make_pmpc_ocp(dt=0.002),
        tdyn.PMPCParams(mu=torch.from_numpy(mus), dt=0.002), taux,
        torch.from_numpy(z0), torch.from_numpy(V))
    # float32: the gradient sums ~15 stages of terms up to ~1e2, so a few
    # float32 ulps of the largest term.
    atol = 1e-9 if dtype == np.float64 else 5e-4
    assert got.dtype == torch.from_numpy(V).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    assert float(got.max()) > 0.01      # V is far from stationary here


@pytest.mark.parametrize("case", ["B=100", "tensor g", "use_kernel=False",
                                  "fast=False"])
def test_fallback_branches_match_jax(case):
    """The branches off the whole-solve kernel, each against JAX's own:
    B % 128 != 0 and use_kernel=False take `pmpc_fast.solve_batch_fast`, a
    gravity tensor and fast=False the generic `ilqr.solve_batch`. Both
    run the Riccati backward pass (its plain version on the CPU, JAX's XLA
    scan), in float64 at the same budget."""
    states, tgts = _scenario(5, spread=0.1)
    Bc = 100 if case == "B=100" else B
    states, tgts = states[:Bc], tgts[:Bc]
    kw = dict(N=N, dt=DT, use_kernel=case != "use_kernel=False",
              fast=case != "fast=False")
    g = -9.81
    jg, tg = (jnp.asarray(g), torch.tensor(g, dtype=torch.float64)) \
        if case == "tensor g" else (g, g)
    V0 = np.random.default_rng(6).uniform(-0.3, 0.3, (Bc, N, 2))
    jctlr = jmpc.PMPCBatch(**kw)
    w = jmpc.PMPC_WEIGHTS["general"]
    j_out = jax.jit(lambda V: jctlr.solve(
        jmpc.PMPCCarry(V=V), jnp.asarray(states), jnp.asarray(tgts),
        jdyn.PMPCParams(mu=jnp.asarray(0.1), g=jg, dt=DT), w))(
            jnp.asarray(V0))
    tctlr = tmpc.PMPCBatch(**kw)
    t_out = tctlr.solve(tmpc.PMPCCarry(V=torch.from_numpy(V0)),
                        torch.from_numpy(states), torch.from_numpy(tgts),
                        tdyn.PMPCParams(mu=0.1, g=tg, dt=DT),
                        tmpc.PMPC_WEIGHTS["general"])
    _assert_same(t_out, j_out)
    # The solve moved the warm start: the branch really iterated.
    assert float(np.abs(t_out[0].V.numpy()[:, :-1] - V0[:, 1:]).max()) > 1e-3


def test_weight_tables_and_schedule_match_jax():
    for name, jw in jmpc.PMPC_WEIGHTS.items():
        assert tuple(tmpc.PMPC_WEIGHTS[name]) == \
            tuple(float(x) for x in jw)
    mu = np.array([0.05, 0.15, 0.2, 0.1, 0.3])
    sliding = np.array([True, True, False, True, True])
    jw = jmpc.pmpc_schedule_weights(jmpc.PMPC_WEIGHTS["cube"],
                                    jnp.asarray(mu), jnp.asarray(sliding))
    tw = tmpc.pmpc_schedule_weights(tmpc.PMPC_WEIGHTS["cube"],
                                    torch.from_numpy(mu),
                                    torch.from_numpy(sliding))
    np.testing.assert_array_equal(tw.Qp.numpy(), np.asarray(jw.Qp))
    np.testing.assert_array_equal(tw.R.numpy(), np.asarray(jw.R))
    assert float(tw.Qv) == float(jw.Qv)


def test_shift_drops_stage_zero_and_repeats_tail():
    V = np.arange(2 * N * 2, dtype=np.float64).reshape(2, N, 2)
    got = to_numpy(tmpc._shift(torch.from_numpy(V)))
    np.testing.assert_array_equal(got[0], np.asarray(jmpc._shift(V[0])))
    np.testing.assert_array_equal(got[1], np.asarray(jmpc._shift(V[1])))
