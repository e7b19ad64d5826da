"""Port parity: the batched RMPC front end (`dart_tpu_torch.control.mpc.
RMPCBatch.solve_batched`: RLS, stiction integrator, governor, staged
reference, the whole-solve kernel with escalation and the per-lane
`ilqr.solve_batch` rescue) and its closed loop against `dart_tpu`'s.

The JAX side runs `RMPCBatch(kernel_interpret=True, kernel_xla_fallback=
True)`: the Pallas kernel in interpret mode inside JAX's own escalation and
rescue, jitted once per module (one compile serves every call below). The
scenario is tests/test_rmpc_kernel_rescue.py's starved budget (1 iteration
x 2 alphas x 1 AL round, N=6) on stiff-estimate lanes, so the rescue
really runs. Both sides run in float64, where they take the same
operations in the same order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.adapt.rls import RLSState as JRLSState
from dart_tpu.control import mpc as jmpc
from dart_tpu.models import dynamics as jdyn
from dart_tpu_torch.adapt.rls import RLSState
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.ops.kernels import riccati as tric
from dart_tpu_torch.rollout import loop
from dart_tpu_torch.utils.convert import from_jax, to_numpy

B, N, DT = 128, 6, 0.01
TOL_GRAD = 5e-3
STEPS = 4
# float64, same operations in the same order: a few ulps, amplified by at
# most the rescue's 30 Newton iterations.
ATOL = 1e-9


def _controller(mod, fallback, **kw):
    return mod.RMPCBatch(
        N=N, dt=DT, cfg=mod.ilqr.ILQRConfig(max_iters=10, al_iters=3),
        kernel_iters=1, kernel_alphas=2, kernel_al_rounds=1,
        kernel_tol_grad=TOL_GRAD, kernel_max_extra_rounds=0,
        kernel_xla_fallback=fallback, **kw)


def _batch():
    """tests/test_rmpc_kernel_rescue.py:_make_batch, in float64."""
    rng = np.random.default_rng(7)
    states = rng.normal(size=(B, 4)) * 0.02
    targets = np.tile([0.112, 0.0, 0.06, 0.0], (B, 1))
    half = B // 2
    states[:half, 1] = 0.0
    states[:half, 3] = 0.0
    targets[:half] = states[:half]
    th = rng.normal(size=(B, 14)) * 0.3
    th[half:] = rng.normal(size=(half, 14)) * 0.2
    th[half:, 1] = -rng.uniform(10, 40, half)
    th[half:, 4] = -rng.uniform(2, 8, half)
    th[half:, 6] = rng.uniform(-1, 1, half)
    th[half:, 10] = -rng.uniform(10, 40, half)
    th[half:, 12] = -rng.uniform(2, 8, half)
    th[half:, 13] = rng.uniform(-1, 1, half)
    return states, targets, th


def _jax_carry(ctlr, states, th):
    carry = ctlr.init_carry_batch(jnp.asarray(states), jnp.float64)
    return carry._replace(
        rls_x=JRLSState(theta=jnp.asarray(th[:, :7]), P=carry.rls_x.P),
        rls_y=JRLSState(theta=jnp.asarray(th[:, 7:]), P=carry.rls_y.P))


def _torch_carry(ctlr, states, th):
    carry = ctlr.init_carry(torch.from_numpy(states), torch.float64)
    return carry._replace(
        rls_x=RLSState(theta=torch.from_numpy(th[:, :7]), P=carry.rls_x.P),
        rls_y=RLSState(theta=torch.from_numpy(th[:, 7:]), P=carry.rls_y.P))


@pytest.fixture(scope="module")
def jax_solve():
    """JAX's jitted `solve_batched` with the rescue on."""
    ctlr = _controller(jmpc, True, kernel_interpret=True)
    return jax.jit(ctlr.solve_batched)


@pytest.fixture(scope="module")
def jax_starved(jax_solve):
    states, targets, th = _batch()
    ctlr = _controller(jmpc, True, kernel_interpret=True)
    return jax.tree.map(np.asarray, jax_solve(
        _jax_carry(ctlr, states, th), jnp.asarray(states),
        jnp.asarray(targets)))


def _flat(tree):
    """(name, array) leaves of a nested NamedTuple."""
    for name, x in zip(tree._fields, tree):
        if isinstance(x, tuple):
            for sub, y in _flat(x):
                yield f"{name}.{sub}", y
        elif x is not None:
            yield name, np.asarray(x)


def _certified(diag):
    return (diag.viol <= 1e-8) & (diag.grad_norm <= TOL_GRAD)


@pytest.mark.parametrize("fallback", [False, True])
def test_solve_batched_matches_jax(jax_starved, fallback):
    """With the rescue the port matches JAX's whole answer, the carry (RLS
    estimates and covariances, governor reference, stiction integral)
    included. Without it, the lanes the kernel certified carry the kernel's
    answer, which JAX passes through its rescue bit for bit, so they match
    JAX's too."""
    states, targets, th = _batch()
    ctlr = _controller(tmpc, fallback)
    carry, u, diag = ctlr.solve_batched(_torch_carry(ctlr, states, th),
                                        torch.from_numpy(states),
                                        torch.from_numpy(targets))
    j_carry, j_u, j_diag = jax_starved
    lanes = np.ones(B, bool) if fallback else _certified(diag).numpy()
    assert lanes.sum() >= B // 2
    np.testing.assert_allclose(u.numpy()[lanes], j_u[lanes], rtol=0,
                               atol=ATOL)
    got_carry = dict(_flat(to_numpy(carry)))
    for name, want in _flat(j_carry):
        np.testing.assert_allclose(got_carry[name][lanes], want[lanes],
                                   rtol=1e-12, atol=ATOL, err_msg=name)
    for name in ("viol", "grad_norm"):
        np.testing.assert_allclose(getattr(diag, name).numpy()[lanes],
                                   getattr(j_diag, name)[lanes], rtol=0,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(diag.cost.numpy()[lanes], j_diag.cost[lanes],
                               rtol=1e-10, atol=0)
    np.testing.assert_array_equal(diag.iters.numpy(), j_diag.iters)


def test_rescue_certifies_and_leaves_certified_lanes_alone(monkeypatch):
    """tests/test_rmpc_kernel_rescue.py's gate on the port: without the
    rescue the starved budget leaves lanes uncertified; with it every lane
    is certified, its backward passes go through the Riccati wrapper, and
    the lanes the kernel certified keep its answer bit for bit."""
    calls = []
    plain = tric.riccati_backward_reference

    def counted(*args):
        calls.append(args[0].shape[-1])
        return plain(*args)

    monkeypatch.setattr(tric, "riccati_backward_reference", counted)
    states, targets, th = _batch()
    outs = {}
    for fallback in (False, True):
        ctlr = _controller(tmpc, fallback)
        outs[fallback] = ctlr.solve_batched(_torch_carry(ctlr, states, th),
                                            torch.from_numpy(states),
                                            torch.from_numpy(targets))
    _, u0, d0 = outs[False]
    _, u1, d1 = outs[True]
    bad0 = ~_certified(d0)
    assert bool(bad0.any()) and not bool(bad0.all())
    assert bool((d1.viol <= ctlr.cfg.tol_con + 1e-6).all())
    assert bool((d1.grad_norm <= TOL_GRAD).all()), float(d1.grad_norm.max())
    assert torch.equal(u1[~bad0], u0[~bad0])
    # Every backward pass of the rescue ran on the flagged lanes alone.
    assert calls and set(calls) == {int(bad0.sum())}


def test_closed_loop_matches_jax(jax_solve):
    """A few closed-loop steps (solve -> apply u -> analytic RK4 plant with
    viscous friction the nominal model lacks), with the rescue on, against
    the same loop in JAX."""
    rng = np.random.default_rng(8)
    mus = rng.uniform(0.05, 0.2, B)
    t4 = np.zeros((B, 4))
    t4[:, 0] = rng.uniform(-0.1, 0.1, B)
    t4[:, 2] = rng.uniform(-0.1, 0.1, B)
    x0 = np.zeros((B, 6))

    jc = _controller(jmpc, True, kernel_interpret=True)
    plant = jdyn.discretize(jdyn.pmpc_dynamics, DT)
    jplant = jax.vmap(lambda x, u, mu: plant(
        x, u, jdyn.PMPCParams(mu=mu, dt=DT)))
    jcarry = jc.init_carry_batch(jnp.asarray(x0[:, :4]), jnp.float64)
    jx, j_us = jnp.asarray(x0), []
    for _ in range(STEPS):
        jcarry, ju, _ = jax_solve(jcarry, jx[:, :4], jnp.asarray(t4))
        jx = jplant(jx, ju, jnp.asarray(mus))
        j_us.append(np.asarray(ju))

    tc = _controller(tmpc, True)
    solve_fn = loop.rmpc_solve_fn(tc, torch.from_numpy(t4))
    tcarry, tx, t_us = loop.run_batch_closed_loop(
        solve_fn, loop.pmpc_plant_step(torch.from_numpy(mus), DT),
        tc.init_carry(torch.from_numpy(x0[:, :4]), torch.float64),
        torch.from_numpy(x0), STEPS)
    np.testing.assert_allclose(t_us.numpy(), np.stack(j_us), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=ATOL)
    conv = from_jax(jcarry, "cpu")
    for (name, got), (_, want) in zip(_flat(tcarry), _flat(conv)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=ATOL,
                                   err_msg=name)
    assert np.abs(t_us.numpy()).max() > 0.01       # the loop really moved


def test_rls_transient_is_infeasible_in_jax_too():
    """The production configuration (N=20, 2 ms, u 0.4, du 0.05, vmax 0.25,
    10 iterations x 3 AL rounds) from rest, on the first 16 lanes of
    chip_smoke.py's RMPC main-path scenario, through the generic AL solve on
    both sides (B=16 is off the kernel's grid). At step 3 the RLS estimate
    has fitted three samples and puts strong positive velocity feedback on
    some lanes; no solve meets their velocity caps. JAX and the port leave
    the same lanes infeasible with the same violation, and every lane is
    feasible before and after: the uncertified step that chip_smoke.py
    reports in its transient is the design's, not the port's."""
    b, bf, dt, steps = 16, 4096, 0.002, 5
    rng = np.random.default_rng(1)
    mus = rng.uniform(0.05, 0.2, size=bf)[:b]
    t4 = np.zeros((bf, 4))
    t4[:, 0] = rng.uniform(-0.1, 0.1, bf)
    t4[:, 2] = rng.uniform(-0.1, 0.1, bf)
    t4 = t4[:b]

    def ctl(mod):
        return mod.RMPCBatch(N=20, dt=dt, u_bound=0.4, du_bound=0.05,
                             vmax=0.25,
                             cfg=mod.ilqr.ILQRConfig(max_iters=10, al_iters=3))

    jc = ctl(jmpc)
    plant = jdyn.discretize(jdyn.pmpc_dynamics, dt)
    jplant = jax.jit(jax.vmap(lambda x, u, mu: plant(
        x, u, jdyn.PMPCParams(mu=mu, dt=dt))))
    jsolve = jax.jit(jc.solve_batched)
    jx = jnp.zeros((b, 6))
    jcarry = jc.init_carry_batch(jx[:, :4], jnp.float64)
    tc = ctl(tmpc)
    tplant = loop.pmpc_plant_step(torch.from_numpy(mus), dt)
    tx = torch.zeros((b, 6), dtype=torch.float64)
    tcarry = tc.init_carry(tx[:, :4], torch.float64)
    for step in range(steps):
        jcarry, ju, jd = jsolve(jcarry, jx[:, :4], jnp.asarray(t4))
        jx = jplant(jx, ju, jnp.asarray(mus))
        tcarry, tu, td = tc.solve_batched(tcarry, tx[:, :4],
                                          torch.from_numpy(t4))
        tx = tplant(tx, tu)
        j_bad = np.asarray(jd.viol) > tc.cfg.tol_con
        t_bad = td.viol.numpy() > tc.cfg.tol_con
        np.testing.assert_array_equal(t_bad, j_bad, err_msg=f"step {step}")
        np.testing.assert_allclose(td.viol.numpy(), np.asarray(jd.viol),
                                   rtol=0, atol=ATOL, err_msg=f"step {step}")
        assert t_bad.any() == (step == 3), (step, np.nonzero(t_bad)[0])
