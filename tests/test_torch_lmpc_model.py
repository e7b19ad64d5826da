"""Port parity: the 34-parameter LMPC model, its closed-form Jacobians, the
RK4 chain rule through it and both LMPC OCPs
(`dart_tpu_torch.models.dynamics`, `.solver.ocp.make_lmpc_ocp`) against
their `dart_tpu` twins on the same numpy inputs, in float64.

The loop starts from rest, so lanes with a velocity or rate exactly 0 are
part of every input: there sign(0) = 0 and d|v|/dv = 0, in JAX's
convention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.models import dynamics as jdyn
from dart_tpu.solver import ilqr as jilqr
from dart_tpu.solver import ocp as jocp
from dart_tpu_torch.models import dynamics as tdyn
from dart_tpu_torch.solver import ilqr as tilqr
from dart_tpu_torch.solver import ocp as tocp
from dart_tpu_torch.utils.convert import from_jax

B, N, DT = 64, 5, 0.01
# float64: the same operations in the same order, so agreement is to a few
# ulps (exp/tanh/sin/cos come from different libraries); 1e-12 relative
# leaves a wide margin. Entries exactly 0 on both sides pass the absolute
# term.
TOL = dict(rtol=1e-12, atol=1e-12)


def _inputs(seed=0):
    """States, tilts and raw parameters (some negative, so the squash
    acts); the first lanes sit at rest (x = 0), the next ones have only
    the velocities and rates at 0, one lane a slip velocity of exactly 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 8)) * np.array([0.05, 0.2, 0.05, 0.2,
                                            0.1, 0.5, 0.1, 0.5])
    x[:4] = 0.0
    x[4:8, [1, 3, 5, 7]] = 0.0
    x[8, 1] = 0.3
    x[8, 7] = 1.0
    u = rng.uniform(-0.4, 0.4, size=(B, 2))
    p = rng.uniform(0.05, 0.5, size=(B, 34)) * rng.choice([-1.0, 1.0],
                                                          size=(B, 34))
    p[8, 18] = 0.3 - 1e-6                 # r_x = 0.3 after the squash
    return x, u, p


def _jax_lanes(f, *arrays):
    out = jax.vmap(f)(*(jnp.asarray(a) for a in arrays))
    return jax.tree.map(np.asarray, out)


def test_squash_and_stribeck_match_jax():
    x, _, p = _inputs()
    np.testing.assert_array_equal(
        tdyn.lmpc_squash_params(torch.from_numpy(p)).numpy(),
        np.asarray(jdyn.lmpc_squash_params(jnp.asarray(p))))
    v = np.concatenate([x[:, 1], [0.0, -0.0]])
    f = [np.abs(np.resize(p[:, i], v.shape)) + 1e-3 for i in range(5)]
    for name in ("stribeck_friction", "stribeck_friction_deriv"):
        want = np.asarray(getattr(jdyn, name)(*map(jnp.asarray, (v, *f))))
        got = getattr(tdyn, name)(*map(torch.from_numpy, (v, *f))).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    # At v = 0 the slope has no sign term: (1/eps) F_s + B.
    d0 = tdyn.stribeck_friction_deriv(*map(torch.from_numpy, (v, *f)))
    np.testing.assert_allclose(d0.numpy()[v == 0],
                               (f[0] / f[4] + f[2])[v == 0], rtol=1e-15)


def test_lmpc_dynamics_matches_jax():
    x, u, p = _inputs(1)
    want = _jax_lanes(jdyn.lmpc_dynamics, x, u, p)
    got = tdyn.lmpc_dynamics(*map(torch.from_numpy, (x, u, p)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The same function serves one lane under torch.func.vmap.
    lanes = torch.func.vmap(tdyn.lmpc_dynamics)(
        *map(torch.from_numpy, (x, u, p)))
    np.testing.assert_array_equal(lanes.numpy(), got.numpy())


def test_lmpc_jac_matches_jax_and_autodiff():
    x, u, p = _inputs(2)
    wA, wB = _jax_lanes(jdyn.lmpc_jac, x, u, p)
    A, Bm = tdyn.lmpc_jac(*map(torch.from_numpy, (x, u, p)))
    np.testing.assert_allclose(A.numpy(), wA, **TOL)
    np.testing.assert_allclose(Bm.numpy(), wB, **TOL)
    # The closed form is the model's derivative, at rest too.
    Ax, Bu = torch.func.vmap(torch.func.jacfwd(tdyn.lmpc_dynamics,
                                               argnums=(0, 1)))(
        *map(torch.from_numpy, (x, u, p)))
    np.testing.assert_allclose(A.numpy(), Ax.numpy(), **TOL)
    np.testing.assert_allclose(Bm.numpy(), Bu.numpy(), **TOL)


def test_rk4_jac_matches_jax():
    x, u, p = _inputs(3)
    want = _jax_lanes(lambda xi, ui, pi: jdyn.rk4_jac(
        jdyn.lmpc_dynamics, jdyn.lmpc_jac, xi, ui, pi, DT), x, u, p)
    got = tdyn.rk4_jac(tdyn.lmpc_dynamics, tdyn.lmpc_jac,
                       *map(torch.from_numpy, (x, u, p)), DT)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    step = _jax_lanes(lambda xi, ui, pi: jdyn.rk4_step(
        jdyn.lmpc_dynamics, xi, ui, pi, DT), x, u, p)
    np.testing.assert_allclose(
        tdyn.rk4_step(tdyn.lmpc_dynamics, *map(torch.from_numpy, (x, u, p)),
                      DT).numpy(), step, **TOL)


def _aux(seed):
    rng = np.random.default_rng(seed)
    tmask = np.array([1, 0, 1, 0, 0, 0, 0, 0.])
    return jocp.LMPCAux(target=rng.uniform(-0.08, 0.08, (B, 8)) * tmask,
                        Q=rng.uniform(0.5, 200.0, (B, 8)),
                        R=rng.uniform(0.05, 1.0, (B, 4)),
                        Qt=rng.uniform(0.5, 200.0, (B, 8)))


@pytest.mark.parametrize("fast", [False, True])
def test_lmpc_ocp_matches_jax(fast):
    """Step, stage and terminal costs on one stage of every lane, and the
    whole linearisation (dynamics Jacobians and cost quadratics) of a
    rollout: the closed form (fast) and torch.func autodiff (generic)
    against JAX's of the same variant."""
    x, u, p = _inputs(4)
    aux = _aux(4)
    rng = np.random.default_rng(4)
    z = np.concatenate([x, rng.uniform(-0.4, 0.4, (B, 2))], -1)
    jo = jocp.make_lmpc_ocp(dt=DT, fast=fast)
    to = tocp.make_lmpc_ocp(dt=DT, fast=fast)
    assert to.u_lo == jo.u_lo and to.u_hi == jo.u_hi
    ta = from_jax(aux, "cpu")
    zt, ut, pt = map(torch.from_numpy, (z, u, p))
    np.testing.assert_allclose(to.step(zt, ut, pt).numpy(),
                               _jax_lanes(jo.step, z, u, p), **TOL)
    ja = jax.tree.map(jnp.asarray, aux)
    want_s = jax.vmap(lambda zi, ui, a: jo.stage_cost(zi, ui, 0, a))(
        jnp.asarray(z), jnp.asarray(u), ja)
    np.testing.assert_allclose(to.stage_cost(zt, ut, 0, ta).numpy(),
                               np.asarray(want_s), **TOL)
    np.testing.assert_allclose(to.term_cost(zt, ta).numpy(),
                               np.asarray(jax.vmap(jo.term_cost)(
                                   jnp.asarray(z), ja)), **TOL)

    V = rng.uniform(-0.4, 0.4, (B, N, 2))
    lam, mu = np.zeros((B, N, 1)), np.ones(B)
    Z = tilqr._rollout(to, pt, zt, torch.from_numpy(V))
    got = tilqr._linearize(to, pt, ta, Z, torch.from_numpy(V),
                           torch.from_numpy(lam), torch.from_numpy(mu))
    want = jax.jit(jax.vmap(lambda pp, a, Zl, Vl, ll, m: jilqr._linearize(
        jo, pp, a, Zl, Vl, ll, m)))(jnp.asarray(p), ja,
                                    jnp.asarray(Z.numpy()), jnp.asarray(V),
                                    jnp.asarray(lam), jnp.asarray(mu))
    names = ("A", "B", "lx", "lu", "lxx", "lux", "luu", "gx", "gxx")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
