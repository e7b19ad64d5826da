"""Port parity: the single-lane controllers (`PMPC.solve`, `RMPC.solve`,
`LMPC.solve` with `shift_plan`) inside `rollout.loop.run_closed_loop`, on
a lane axis, against `jax.vmap` of `dart_tpu`'s closed loop, in float64,
and `control.reference.quintic_trajectory`.

The loops take tests/test_closed_loop.py's inputs (its 20 ms control
period, targets, friction, weights, its RMPC plant with the friction the
model lacks, and its LMPC parameter vectors), cut to a few solves at a
shorter horizon so the port's host-looped solves stay inside a few
seconds on the CPU. Both sides run the same iterations, so a closed loop
agrees to round-off (the backward passes sum in another order); the
tolerance is 1e-9 on every state, control, diagnostic and carry leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.control import mpc as jmpc
from dart_tpu.models import dynamics as jdyn
from dart_tpu.rollout import loop as jloop
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.control import reference as tref
from dart_tpu_torch.models import dynamics as tdyn
from dart_tpu_torch.rollout import loop as tloop
from dart_tpu_torch.utils.convert import from_jax, to_numpy

DT = 0.02      # tests/test_closed_loop.py's control period
ATOL = 1e-9


def _flat(tree, prefix=""):
    """(name, array) leaves of a nested NamedTuple."""
    for name, x in zip(tree._fields, tree):
        if isinstance(x, tuple):
            yield from _flat(x, f"{prefix}{name}.")
        elif x is not None:
            yield prefix + name, np.asarray(x)


def _close(got, want, atol=ATOL):
    got = dict(_flat(to_numpy(got)))
    for name, w in _flat(want):
        np.testing.assert_allclose(got[name], w, rtol=1e-12, atol=atol,
                                   err_msg=name)


def _lmpc_pvecs():
    """tests/test_closed_loop.py:97-100's true and model 34-vectors."""
    rng = np.random.default_rng(0)
    pvec_true = rng.uniform(0.05, 0.3, size=34)
    return pvec_true, pvec_true * rng.uniform(0.8, 1.2, size=34)


def test_quintic_trajectory_matches_jax():
    from dart_tpu.control.reference import quintic_trajectory as jq

    rng = np.random.default_rng(1)
    states = rng.normal(size=(4, 8)) * 0.05
    targets = rng.normal(size=(4, 8)) * 0.05
    want = jax.vmap(lambda s, t: jq(s, t, 20, 8, 0.01))(
        jnp.asarray(states), jnp.asarray(targets))
    got = tref.quintic_trajectory(torch.from_numpy(states),
                                  torch.from_numpy(targets), 20, 8, 0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-15)
    one = tref.quintic_trajectory(torch.from_numpy(states[1]),
                                  torch.from_numpy(targets[1]), 20, 8, 0.01)
    np.testing.assert_allclose(one.numpy(), np.asarray(want)[1], atol=1e-15)


def _rmpc_plant(mod, lib):
    """tests/test_closed_loop.py:66-76's plant: the 4-state tilt dynamics
    with Coulomb-ish and viscous friction the nominal model lacks."""
    def plant_dyn(x, u, p):
        vx, vy = x[..., 1], x[..., 3]
        ax = -9.81 * lib.sin(u[..., 0]) * 1.1 - 0.4 * vx - \
            0.3 * lib.tanh(vx / 0.01)
        ay = -9.81 * lib.sin(u[..., 1]) * 1.1 - 0.4 * vy - \
            0.3 * lib.tanh(vy / 0.01)
        return lib.stack([vx, ax, vy, ay], -1)

    return mod.discretize(plant_dyn, DT)


@pytest.mark.parametrize("case", ["pmpc", "rmpc", "lmpc"])
def test_run_closed_loop_matches_vmapped_jax(case):
    """`run_closed_loop` on three lanes with a warm-up and `control_every`,
    two solves each: PMPC (friction per lane) and RMPC (its RLS estimate,
    governor and stiction integral in the carry) hold their control
    between solves, LMPC shifts its stale plan (`hold_fn`) between solves.
    Compared: X with x0 first, U (zero through the warm-up), the
    per-step diagnostics (zero on hold steps) and the final carry."""
    B, n_steps, warm = 3, 7, 2
    if case == "pmpc":
        every = 3
        mus = np.asarray([0.05, 0.1, 0.2])
        target = np.tile([0.05, 0.0, 0.05, 0.0, 0.0, 0.0], (B, 1))
        x0 = np.zeros((B, 6))
        kw = dict(N=8, dt=DT, u_bound=0.6)
        jc = jmpc.PMPC(cfg=jmpc.ilqr.ILQRConfig(max_iters=10), **kw)
        tc = tmpc.PMPC(cfg=tmpc.ilqr.ILQRConfig(max_iters=10), **kw)
        jw = jmpc.PMPC_WEIGHTS["general"]
        jplant = jdyn.discretize(jdyn.pmpc_dynamics, DT)

        def run_one(x, t, mu):
            params = jdyn.PMPCParams(mu=mu, dt=DT)

            def solve_fn(c, obs, tt):
                return jc.solve(c, obs, tt, params, jw)

            return jloop.run_closed_loop(
                solve_fn, jplant, jc.init_carry(jnp.float64), x, t, params,
                n_steps=n_steps, control_every=every, warmup_steps=warm)

        want = jax.jit(jax.vmap(run_one))(jnp.asarray(x0),
                                          jnp.asarray(target),
                                          jnp.asarray(mus))
        tparams = tdyn.PMPCParams(mu=torch.from_numpy(mus), dt=DT)

        def tsolve(c, obs, tt):
            return tc.solve(c, obs, tt, tparams,
                            tmpc.PMPC_WEIGHTS["general"])

        got = tloop.run_closed_loop(
            tsolve, tdyn.discretize(tdyn.pmpc_dynamics, DT),
            tc.init_carry(B, torch.float64, "cpu"), torch.from_numpy(x0),
            torch.from_numpy(target), tparams, n_steps=n_steps,
            control_every=every, warmup_steps=warm)
    elif case == "rmpc":
        every = 3
        target = np.tile([0.08, 0.0, -0.06, 0.0], (B, 1))
        target[1, 0], target[2, 2] = -0.05, 0.04
        x0 = np.zeros((B, 4))
        kw = dict(N=8, dt=DT)
        jc = jmpc.RMPC(cfg=jmpc.ilqr.ILQRConfig(max_iters=10, al_iters=3),
                       **kw)
        tc = tmpc.RMPC(cfg=tmpc.ilqr.ILQRConfig(max_iters=10, al_iters=3),
                       **kw)
        jplant = _rmpc_plant(jdyn, jnp)

        def run_one(x, t):
            return jloop.run_closed_loop(
                jc.solve, jplant, jc.init_carry(x, jnp.float64), x, t, None,
                n_steps=n_steps, control_every=every, warmup_steps=warm)

        want = jax.jit(jax.vmap(run_one))(jnp.asarray(x0),
                                          jnp.asarray(target))
        got = tloop.run_closed_loop(
            tc.solve, _rmpc_plant(tdyn, torch),
            tc.init_carry(torch.from_numpy(x0), torch.float64),
            torch.from_numpy(x0), torch.from_numpy(target), None,
            n_steps=n_steps, control_every=every, warmup_steps=warm)
        dU = np.diff(got.U.numpy(), axis=1)
        assert np.abs(dU).max() <= 0.05 + 1e-9       # the slew bound holds
    else:
        # tests/test_closed_loop.py:92-121: the solver at 1/4 rate with
        # the plan shift in between, the model's parameters perturbed.
        every = 4
        pvec_true, pvec_model = _lmpc_pvecs()
        target = np.tile([0.05, 0, 0.05, 0, 0, 0, 0, 0], (B, 1))
        target[1, 2] = -0.03
        target[2, 0] = -0.04
        x0 = np.zeros((B, 8))
        kw = dict(N=8, dt=DT)
        jc = jmpc.LMPC(cfg=jmpc.ilqr.ILQRConfig(max_iters=10), **kw)
        tc = tmpc.LMPC(cfg=tmpc.ilqr.ILQRConfig(max_iters=10), **kw)

        def jsolve(c, obs, t):
            return jc.solve(c, obs, t, jnp.asarray(pvec_model))

        def jhold(c, obs, t):
            nc, u = jc.shift_plan(c)
            z = jnp.zeros(())
            return nc, u, jmpc.SolveDiag(z, z, jnp.zeros((), jnp.int32), z)

        jplant = jdyn.discretize(jdyn.lmpc_dynamics, DT)

        def run_one(x, t):
            return jloop.run_closed_loop(
                jsolve, jplant, jc.init_carry(jnp.float64), x, t,
                jnp.asarray(pvec_true), n_steps=n_steps, control_every=every,
                warmup_steps=warm, hold_fn=jhold)

        want = jax.jit(jax.vmap(run_one))(jnp.asarray(x0),
                                          jnp.asarray(target))

        def tsolve(c, obs, t):
            return tc.solve(c, obs, t, torch.from_numpy(pvec_model))

        def thold(c, obs, t):
            nc, u = tc.shift_plan(c)
            return nc, u, tloop._zero_diag(B, torch.float64, "cpu")

        got = tloop.run_closed_loop(
            tsolve, tdyn.discretize(tdyn.lmpc_dynamics, DT),
            tc.init_carry(B, torch.float64, "cpu"), torch.from_numpy(x0),
            torch.from_numpy(target), torch.from_numpy(pvec_true),
            n_steps=n_steps, control_every=every, warmup_steps=warm,
            hold_fn=thold)
    assert got.X.shape == (B, n_steps + 1, x0.shape[1])
    np.testing.assert_array_equal(got.X.numpy()[:, 0], x0)
    _close(got, want)
    U = got.U.numpy()
    assert (U[:, :warm] == 0).all() and np.abs(U[:, warm]).max() > 1e-3
    iters = got.diag.iters.numpy()
    solves = [k for k in range(n_steps) if k >= warm
              and (k - warm) % every == 0]
    assert (iters[:, solves] > 0).all()
    assert (np.delete(iters, solves, axis=1) == 0).all()
    if case in ("pmpc", "rmpc"):     # the held control between solves
        np.testing.assert_array_equal(U[:, warm + 1], U[:, warm])
    elif case == "lmpc":   # the plan's next entry
        assert not np.array_equal(U[:, warm + 1], U[:, warm])
    assert from_jax(want, "cpu")._fields == got._fields
