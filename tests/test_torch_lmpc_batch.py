"""Port parity: the batched LMPC front end (`dart_tpu_torch.control.mpc.
LMPCBatch`: the whole-solve kernel with escalation, the `ilqr.solve_batch`
branch with the closed-form and the autodiff linearisation, the stale-plan
shift), the LMPC plant and closed loop (`rollout.loop`) and the plant
sampling (`adapt.lmpc_trainer`) against `dart_tpu`'s.

JAX's kernel branch runs only on a TPU, so the kernel-branch loop is held
to a reconstruction of it on the CPU: JAX's kernel body `_lmpc_kernel` with
its iteration loop rolled, jitted once per module (the same per-element
operations as the eager body, to 1e-16; 45 s to compile against ~14 s per
eager call), inside the escalation of `dart_tpu.control.mpc._escalate`
written as a host loop. Everything runs in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.adapt import lmpc_trainer as jtrainer
from dart_tpu.control import mpc as jmpc
from dart_tpu.models import dynamics as jdyn
from dart_tpu_torch.adapt import lmpc_trainer as ttrainer
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.ops.kernels import lmpc_solve as tls
from dart_tpu_torch.rollout import loop
from dart_tpu_torch.utils.convert import from_jax, to_numpy
from test_torch_lmpc_solve import kernel_fn

DT = 0.01
# float64, same operations: the kernel branch agrees to a few ulps per
# solve; solve_batch sums its dot products in another order than XLA's
# scan (the Riccati plain version against jnp), a few ulps per iteration.
ATOL = 1e-10


def _plant_scenario(seed: int, B: int):
    """Plant parameters and targets from JAX's own samplers (so both sides
    get the same numbers), as numpy float64."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 2 * B)
    pv = jax.vmap(jtrainer.sample_true_params)(keys[:B])
    tg = jax.vmap(jtrainer.sample_target)(keys[B:])
    return np.array(pv, np.float64), np.array(tg, np.float64)


def _carry_close(got, want, atol=ATOL):
    for name, g, w in zip(got._fields, to_numpy(got), want):
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
            assert g.dtype == w.dtype, name
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("fast", [False, True])
def test_solve_batch_branch_matches_jax(fast):
    """tests/test_solve_batch.py:119-145's batch (B=3, N=10): off the
    128-lane grid, so both take `solve_batch`."""
    B = 3
    rng = np.random.default_rng(5)
    states = rng.normal(size=(B, 8)) * 0.03
    targets = rng.uniform(-0.08, 0.08, (B, 8)) * np.array(
        [1, 0, 1, 0, 0, 0, 0, 0.])
    pvecs = rng.uniform(0.05, 0.3, (B, 34))
    kw = dict(N=10, dt=0.002, fast=fast)
    jc = jmpc.LMPCBatch(cfg=jmpc.ilqr.ILQRConfig(max_iters=15), **kw)
    tc = tmpc.LMPCBatch(cfg=tmpc.ilqr.ILQRConfig(max_iters=15), **kw)
    jcarry = jc.init_carry_batch(B, jnp.float64)
    jcarry = jcarry._replace(u_prev=jnp.asarray(rng.uniform(-0.1, 0.1,
                                                            (B, 2))))
    want = jc.solve_batched(jcarry, *map(jnp.asarray,
                                         (states, targets, pvecs)),
                            use_pallas=False)
    got = tc.solve_batched(from_jax(jcarry, "cpu"),
                           *map(torch.from_numpy, (states, targets, pvecs)))
    _carry_close(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=ATOL)
    for name in ("cost", "grad_norm"):
        np.testing.assert_allclose(getattr(got[2], name).numpy(),
                                   np.asarray(getattr(want[2], name)),
                                   rtol=1e-10, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got[2].iters.numpy(),
                                  np.asarray(want[2].iters))
    assert int(got[2].iters[0]) > 2            # it really iterated


def test_shift_plan_matches_jax():
    """The stale-plan shift, batched and single-lane, through the clamp at
    the plan's last entry."""
    B, N = 6, 5
    rng = np.random.default_rng(6)
    jc = jmpc.LMPCBatch(N=N, dt=DT)
    tc = tmpc.LMPCBatch(N=N, dt=DT)
    jcarry = jmpc.LMPCCarry(
        V=jnp.asarray(rng.normal(size=(B, N, 2))),
        U_plan=jnp.asarray(rng.normal(size=(B, N, 2))),
        plan_idx=jnp.asarray([0, 1, 3, 4, 5, 9], jnp.int32),
        u_prev=jnp.asarray(rng.normal(size=(B, 2))))
    tcarry = from_jax(jcarry, "cpu")
    for _ in range(3):
        jcarry, ju = jc.shift_plan_batched(jcarry)
        tcarry, tu = tc.shift_plan(tcarry)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        _carry_close(tcarry, jcarry, atol=0)
    one = jmpc.LMPCCarry(*(x[2] for x in jcarry))
    want = jc.shift_plan(one)
    got = tc.shift_plan(from_jax(one, "cpu"))
    _carry_close(got[0], want[0], atol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ---- the kernel branch in closed loop (B=128, N=6) ----

BK, NK, STEPS_K = 128, 6, 3
KCFG = dict(kernel_iters=2, kernel_alphas=3, kernel_tol_grad=5e-3,
            kernel_max_extra_rounds=2)


@pytest.fixture(scope="module")
def jax_kernel_body():
    """The kernel body at the controller's budget, rolled and jitted."""
    return jax.jit(kernel_fn(NK, DT, roll=True))


def _jax_kernel_step(body, ctlr, carry, states, targets, pvecs):
    """JAX's `LMPCBatch.solve_batched` kernel branch (dart_tpu/control/
    mpc.py:679-724) on the CPU: `lmpc_solve_pallas` is its clip of V0 and
    the body; `_escalate` is its while_loop as a host loop."""
    B = states.shape[0]
    w = jax.tree.map(lambda x: jnp.broadcast_to(
        jnp.asarray(x, states.dtype), (B,) + jnp.shape(x)),
        jmpc.LMPC_DEFAULT_WEIGHTS)
    z0 = jnp.concatenate([states, carry.u_prev], axis=-1)
    tl = lambda x: jnp.moveaxis(x, 0, -1)     # noqa: E731

    def one_round(V):
        Vn, cost, gn = body(tl(pvecs), tl(w.Q), tl(w.R), tl(w.Qt),
                            tl(targets), tl(z0),
                            jnp.clip(jnp.moveaxis(V, 0, -1), -0.4, 0.4))
        return jnp.moveaxis(Vn, -1, 0), cost, gn

    st, rounds = one_round(carry.V), 0
    while rounds < ctlr.kernel_max_extra_rounds and bool(
            ~(jnp.max(st[2]) <= ctlr.kernel_tol_grad)):
        V = st[0]
        lane_ok = jnp.all(jnp.isfinite(V.reshape(V.shape[0], -1)), axis=1)
        st, rounds = one_round(jnp.where(lane_ok[:, None, None], V,
                                         jnp.zeros_like(V))), rounds + 1
    V = st[0]
    new_carry = jmpc.LMPCCarry(
        V=jnp.concatenate([V[:, 1:], V[:, -1:]], axis=1), U_plan=V,
        plan_idx=jnp.ones((B,), jnp.int32), u_prev=V[:, 0])
    return new_carry, V[:, 0], st[1], st[2], rounds


def test_kernel_branch_closed_loop_matches_jax(jax_kernel_body):
    """Three closed-loop steps from rest on the LMPC plant, controller
    parameters equal to the plant's. At every step of JAX's loop the port's
    kernel branch (the plain version on the CPU) solves from the same carry
    and state: escalation rounds, control, carry and diagnostics must agree.
    The plant's friction is stiff (eps = 0.01, a slope of up to 1/eps F_s
    at rest), so the Newton iterations amplify the libraries' one-ulp
    exp/tanh differences: the applied control agrees to 1e-9 and the tail
    of the plan to 1e-6 (7e-11 and 2e-8 at this seed). Beside it the port
    runs its own loop, `run_batch_closed_loop` with `lmpc_solve_fn`; after
    three steps the two trajectories have carried those differences
    through the plant and agree to 1e-5 (4e-7 at this seed)."""
    pv, tg = _plant_scenario(0, BK)
    jc = jmpc.LMPCBatch(N=NK, dt=DT, **KCFG)
    tc = tmpc.LMPCBatch(N=NK, dt=DT, **KCFG)
    jplant = jax.vmap(lambda x, u, p: jdyn.rk4_step(jdyn.lmpc_dynamics, x, u,
                                                    p, DT))
    tg_t, pv_t = torch.from_numpy(tg), torch.from_numpy(pv)
    jcarry = jc.init_carry_batch(BK, jnp.float64)
    jx, j_us, rounds = jnp.zeros((BK, 8)), [], []
    for _ in range(STEPS_K):
        tcarry, tu, diag = tc.solve_batched(
            from_jax(jcarry, "cpu"), torch.from_numpy(np.array(jx)), tg_t,
            pv_t)
        jcarry, ju, jcost, jgn, r = _jax_kernel_step(
            jax_kernel_body, jc, jcarry, jx, jnp.asarray(tg), jnp.asarray(pv))
        rounds.append(r)
        np.testing.assert_array_equal(
            diag.iters.numpy(), np.full(BK, (1 + r) * jc.kernel_iters))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                                   atol=1e-9)
        _carry_close(tcarry, jcarry, atol=1e-6)
        np.testing.assert_allclose(diag.cost.numpy(), np.asarray(jcost),
                                   rtol=1e-9)
        np.testing.assert_allclose(diag.grad_norm.numpy(), np.asarray(jgn),
                                   rtol=0, atol=1e-9)
        np.testing.assert_array_equal(diag.viol.numpy(), 0.0)
        jx = jplant(jx, ju, jnp.asarray(pv))
        j_us.append(np.asarray(ju))
    assert max(rounds) > 0                     # the escalation ran
    assert np.abs(np.asarray(jx)[:, [0, 2]]).max() > 0   # the plant moved

    _, tx, t_us = loop.run_batch_closed_loop(
        loop.lmpc_solve_fn(tc, tg_t, pv_t), loop.lmpc_plant_step(pv_t, DT),
        tc.init_carry(BK, torch.float64, "cpu"),
        torch.zeros((BK, 8), dtype=torch.float64), STEPS_K)
    np.testing.assert_allclose(t_us.numpy(), np.stack(j_us), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)


def test_kernel_branch_counts_rounds_and_restarts_nan_lanes(monkeypatch):
    """The escalation's host loop: each extra round is one more wrapper
    call while max(gnorm) > tol (NaN counts as too large), at most
    kernel_max_extra_rounds, and a lane whose V is not finite restarts
    from zeros."""
    pv, tg = _plant_scenario(1, BK)
    pv[5] = np.nan
    calls = []
    real = tls.lmpc_solve

    def counted(*args, **kw):
        calls.append(args[6].clone())
        return real(*args, **kw)

    monkeypatch.setattr(tmpc, "lmpc_solve", counted)
    tc = tmpc.LMPCBatch(N=NK, dt=DT, **KCFG)
    carry = tc.init_carry(BK, torch.float64, "cpu")
    _, u, diag = tc.solve_batched(carry, torch.zeros((BK, 8)).double(),
                                  torch.from_numpy(tg), torch.from_numpy(pv))
    assert len(calls) == 1 + KCFG["kernel_max_extra_rounds"]
    assert np.isnan(diag.grad_norm[5].item())
    assert bool(torch.isfinite(u[torch.arange(BK) != 5]).all())
    for V0 in calls[1:]:                       # the NaN lane restarted cold
        assert bool((V0[..., 5] == 0).all())


# ---- the solve_batch branch in a 20-step closed loop (B=8) ----

def test_lmpc_plant_closed_loop_matches_jax():
    """10 steps at B=8 (off the kernel's grid: solve_batch with the
    closed-form linearisation, the CLI's 4 iterations) on the LMPC plant.
    At every step of JAX's loop the port solves from the same carry and
    state, to 1e-10. The port's own loop, `run_batch_closed_loop` with
    `lmpc_solve_fn` and `lmpc_plant_step`, carries those ulps through the
    stiff plant (eps = 0.01) and a saturating tilt: it agrees with JAX's to
    1e-7 (3e-9 at this seed, largest at step 2, decaying after)."""
    B, N, steps = 8, 6, 10
    pv, tg = _plant_scenario(2, B)
    pv_t, tg_t = torch.from_numpy(pv), torch.from_numpy(tg)
    kw = dict(N=N, dt=DT, fast=True)
    jc = jmpc.LMPCBatch(cfg=jmpc.ilqr.ILQRConfig(max_iters=4), **kw)
    tc = tmpc.LMPCBatch(cfg=tmpc.ilqr.ILQRConfig(max_iters=4), **kw)
    plant = jax.vmap(lambda x, u, p: jdyn.rk4_step(jdyn.lmpc_dynamics, x, u,
                                                   p, DT))

    @jax.jit
    def jstep(carry, x):
        carry, u, diag = jc.solve_batched(carry, x, jnp.asarray(tg),
                                          jnp.asarray(pv), use_pallas=False)
        return carry, plant(x, u, jnp.asarray(pv)), u, diag

    jcarry, jx, j_us = jc.init_carry_batch(B, jnp.float64), \
        jnp.zeros((B, 8)), []
    for _ in range(steps):
        tcarry, tu, tdiag = tc.solve_batched(
            from_jax(jcarry, "cpu"), torch.from_numpy(np.array(jx)), tg_t,
            pv_t)
        jcarry, jx, ju, jdiag = jstep(jcarry, jx)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                                   atol=ATOL)
        _carry_close(tcarry, jcarry)
        np.testing.assert_array_equal(tdiag.iters.numpy(),
                                      np.asarray(jdiag.iters))
        j_us.append(np.asarray(ju))
    solve_fn = loop.lmpc_solve_fn(tc, tg_t, pv_t)
    tcarry, tx, t_us = loop.run_batch_closed_loop(
        solve_fn, loop.lmpc_plant_step(pv_t, DT),
        tc.init_carry(B, torch.float64, "cpu"),
        torch.zeros((B, 8), dtype=torch.float64), steps)
    np.testing.assert_allclose(t_us.numpy(), np.stack(j_us), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-7)
    _carry_close(tcarry, jcarry, atol=1e-7)
    assert np.abs(t_us.numpy()).max() == 0.4         # the tilt saturated


def test_sample_true_params_and_target_support():
    """The port's samplers cannot repeat jax.random's bits: hold their
    support and structure to the JAX sampler's."""
    gen = torch.Generator().manual_seed(0)
    B = 4096
    p = ttrainer.sample_true_params(gen, B, torch.float64).numpy()
    t = ttrainer.sample_target(gen, B, torch.float64).numpy()
    pj, tj = _plant_scenario(3, 256)
    assert p.shape == (B, 34) and t.shape == (B, 8)
    for got in (p, pj):
        m = got[:, 0]
        assert set(np.unique(m)) == {1.0, 2.0, 3.0}
        np.testing.assert_array_equal(got[:, 1], m)
        mu = got[:, 6] / (m * 9.81)
        np.testing.assert_allclose(np.unique(np.round(mu, 12)),
                                   [0.05, 0.1, 0.2])
        np.testing.assert_allclose(got[:, 11], got[:, 6], rtol=1e-6)
        np.testing.assert_allclose(got[:, [7, 12]],
                                   0.8 * got[:, [6, 11]], rtol=1e-6)
        np.testing.assert_array_equal(got[:, [9, 14]], 0.05)
        np.testing.assert_array_equal(got[:, [10, 15]], 0.01)
        np.testing.assert_array_equal(got[:, [4, 5]], 0.01)
        rest = np.delete(got, [0, 1, 4, 5, 6, 7, 9, 10, 11, 12, 14, 15], 1)
        assert rest.min() >= 0.05 and rest.max() < 0.3
    for got in (t, tj):
        assert np.abs(got[:, [0, 2]]).max() <= 0.1
        np.testing.assert_array_equal(np.delete(got, [0, 2], 1), 0.0)
    # Every combination of mass and friction is drawn.
    assert len({(a, round(b, 9)) for a, b in zip(p[:, 0], p[:, 6])}) == 9
    # A seeded generator repeats itself.
    again = ttrainer.sample_true_params(torch.Generator().manual_seed(0), B,
                                        torch.float64).numpy()
    np.testing.assert_array_equal(again, p)


def test_carry_converts_and_init_matches_jax():
    jc, tc = jmpc.LMPCBatch(N=7), tmpc.LMPCBatch(N=7)
    want = jc.init_carry_batch(5, jnp.float64)
    got = tc.init_carry(5, torch.float64, "cpu")
    _carry_close(got, want, atol=0)
    conv = from_jax(want, "cpu")
    assert type(conv) is tmpc.LMPCCarry and conv.plan_idx.dtype == torch.int32
    w = from_jax(jmpc.LMPC_DEFAULT_WEIGHTS, "cpu")
    assert type(w) is tmpc.LMPCWeights
    for a, b in zip(w, tmpc.LMPC_DEFAULT_WEIGHTS):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
