"""Port parity: the RMPC model, its closed-form Jacobians, the RK4 chain
rule, RLS, the reference governor, the staged reference and the stiction
integrator (`dart_tpu_torch.models.dynamics`, `.adapt.rls`,
`.control.reference`, `.control.mpc.RMPC`) against their `dart_tpu` twins
on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.adapt import rls as jrls
from dart_tpu.control import mpc as jmpc
from dart_tpu.control import reference as jref
from dart_tpu.models import dynamics as jdyn
from dart_tpu_torch.adapt import rls as trls
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.control import reference as tref
from dart_tpu_torch.models import dynamics as tdyn
from dart_tpu_torch.utils.convert import from_jax

B, DT = 128, 0.002
# float64: same operations in the same order, so agreement is to roundoff
# of a few ulps (tanh/sin/cos come from different libraries); 1e-12
# relative leaves a wide margin. Entries that are exactly 0 on both sides
# pass through the absolute term.
TOL = dict(rtol=1e-12, atol=1e-14)


def _close_normwise(got, want):
    """1e-12 relative to the array's largest entry. RLS sums its dot
    products in another order than XLA's dot, and P holds entries from
    ~1e-3 to ~1e3 whose small ones come from cancellation, so twenty
    recursive updates leave ~1e-13 of the largest entry, not of each."""
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def _model_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 4)) * np.array([0.05, 0.2, 0.05, 0.2])
    u = rng.uniform(-0.4, 0.4, size=(B, 2))
    theta = rng.normal(size=(B, 14)) * 0.5
    v_eps = rng.uniform(0.05, 0.2, size=B)
    return x, u, theta, v_eps


def _tparams(theta, v_eps):
    return tdyn.RMPCParams(theta=torch.from_numpy(theta), g=tdyn.GRAVITY_Z,
                           v_eps=torch.from_numpy(v_eps))


def _jax_lanes(f, *arrays):
    """f over the lanes of numpy arrays, through jax.vmap."""
    out = jax.vmap(f)(*(jnp.asarray(a) for a in arrays))
    return jax.tree.map(np.asarray, out)


def test_rmpc_features_and_dynamics_match_jax():
    x, u, theta, v_eps = _model_inputs()
    want_phi = _jax_lanes(jdyn.rmpc_features, x, v_eps)
    want = _jax_lanes(lambda xi, ui, th, ve: jdyn.rmpc_dynamics(
        xi, ui, jdyn.RMPCParams(theta=th, v_eps=ve)), x, u, theta, v_eps)
    got_phi = tdyn.rmpc_features(torch.from_numpy(x),
                                 torch.from_numpy(v_eps))
    got = tdyn.rmpc_dynamics(torch.from_numpy(x), torch.from_numpy(u),
                             _tparams(theta, v_eps))
    np.testing.assert_allclose(got_phi.numpy(), want_phi, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_single_lane_under_vmap_equals_batch():
    """The `...` indexing lets one function serve a batch and one lane
    under torch.func.vmap, as the generic linearisation calls it."""
    x, u, theta, v_eps = (torch.from_numpy(a) for a in _model_inputs(1))
    batch = tdyn.rmpc_dynamics(x, u, tdyn.RMPCParams(theta, -9.81, v_eps))
    lanes = torch.func.vmap(lambda xi, ui, th, ve: tdyn.rmpc_dynamics(
        xi, ui, tdyn.RMPCParams(th, -9.81, ve)))(x, u, theta, v_eps)
    np.testing.assert_array_equal(lanes.numpy(), batch.numpy())
    A, Bm = tdyn.rmpc_jac(x, u, tdyn.RMPCParams(theta, -9.81, v_eps))
    A1, B1 = torch.func.vmap(lambda xi, ui, th, ve: tdyn.rmpc_jac(
        xi, ui, tdyn.RMPCParams(th, -9.81, ve)))(x, u, theta, v_eps)
    np.testing.assert_array_equal(A1.numpy(), A.numpy())
    np.testing.assert_array_equal(B1.numpy(), Bm.numpy())


def test_rmpc_jac_matches_jax_and_autodiff():
    x, u, theta, v_eps = _model_inputs(2)
    wA, wB = _jax_lanes(lambda xi, ui, th, ve: jdyn.rmpc_jac(
        xi, ui, jdyn.RMPCParams(theta=th, v_eps=ve)), x, u, theta, v_eps)
    tp = _tparams(theta, v_eps)
    A, Bm = tdyn.rmpc_jac(torch.from_numpy(x), torch.from_numpy(u), tp)
    np.testing.assert_allclose(A.numpy(), wA, **TOL)
    np.testing.assert_allclose(Bm.numpy(), wB, **TOL)
    # And the closed form is the model's derivative (autodiff, per lane).
    jac = torch.func.vmap(torch.func.jacfwd(
        lambda xi, ui, th, ve: tdyn.rmpc_dynamics(
            xi, ui, tdyn.RMPCParams(th, tdyn.GRAVITY_Z, ve)),
        argnums=(0, 1)))
    Ax, Bu = jac(torch.from_numpy(x), torch.from_numpy(u),
                 tp.theta, tp.v_eps)
    np.testing.assert_allclose(A.numpy(), Ax.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(Bm.numpy(), Bu.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_pmpc_jac_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 6)) * 0.1
    u = rng.uniform(-0.6, 0.6, size=(B, 2))
    mu = rng.uniform(0.05, 0.2, size=B)
    wA, wB = _jax_lanes(lambda xi, ui, mi: jdyn.pmpc_jac(
        xi, ui, jdyn.PMPCParams(mu=mi, dt=DT)), x, u, mu)
    A, Bm = tdyn.pmpc_jac(torch.from_numpy(x), torch.from_numpy(u),
                          tdyn.PMPCParams(mu=torch.from_numpy(mu), dt=DT))
    np.testing.assert_allclose(A.numpy(), wA, **TOL)
    np.testing.assert_allclose(Bm.numpy(), wB, **TOL)


@pytest.mark.parametrize("model", ["rmpc", "pmpc"])
def test_rk4_jac_matches_jax(model):
    rng = np.random.default_rng(4)
    if model == "rmpc":
        x, u, theta, v_eps = _model_inputs(4)
        jf = lambda xi, ui, th, ve: jdyn.rk4_jac(       # noqa: E731
            jdyn.rmpc_dynamics, jdyn.rmpc_jac, xi, ui,
            jdyn.RMPCParams(theta=th, v_eps=ve), DT)
        want = _jax_lanes(jf, x, u, theta, v_eps)
        got = tdyn.rk4_jac(tdyn.rmpc_dynamics, tdyn.rmpc_jac,
                           torch.from_numpy(x), torch.from_numpy(u),
                           _tparams(theta, v_eps), DT)
        step = lambda xi, ui: tdyn.rk4_step(             # noqa: E731
            tdyn.rmpc_dynamics, xi, ui, _tparams(theta, v_eps), DT)
    else:
        x = rng.normal(size=(B, 6)) * 0.1
        u = rng.uniform(-0.6, 0.6, size=(B, 2))
        mu = rng.uniform(0.05, 0.2, size=B)
        jf = lambda xi, ui, mi: jdyn.rk4_jac(            # noqa: E731
            jdyn.pmpc_dynamics, jdyn.pmpc_jac, xi, ui,
            jdyn.PMPCParams(mu=mi, dt=DT), DT)
        want = _jax_lanes(jf, x, u, mu)
        tp = tdyn.PMPCParams(mu=torch.from_numpy(mu), dt=DT)
        got = tdyn.rk4_jac(tdyn.pmpc_dynamics, tdyn.pmpc_jac,
                           torch.from_numpy(x), torch.from_numpy(u), tp, DT)
        step = lambda xi, ui: tdyn.rk4_step(             # noqa: E731
            tdyn.pmpc_dynamics, xi, ui, tp, DT)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # The chain rule is the RK4 step's exact derivative: autodiff of the
    # batched step (lanes are independent, so the batch Jacobian is
    # block-diagonal and its diagonal blocks are the lanes' Jacobians).
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    Jx = torch.autograd.functional.jacobian(lambda a: step(a, ut).sum(0), xt)
    Ju = torch.autograd.functional.jacobian(lambda a: step(xt, a).sum(0), ut)
    np.testing.assert_allclose(got[0].numpy(),
                               Jx.permute(1, 0, 2).numpy(), rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(got[1].numpy(),
                               Ju.permute(1, 0, 2).numpy(), rtol=1e-11,
                               atol=1e-13)


@pytest.mark.parametrize("P_max", [None, 2e3])
def test_rls_updates_match_jax(P_max):
    """Twenty updates from the same start; with P_max = 2e3 the trace clamp
    (trace(P0) = 7e3) acts from the first update on."""
    rng = np.random.default_rng(5)
    j = jax.vmap(lambda _: jrls.rls_init(7, dtype=jnp.float64))(jnp.zeros(B))
    t = trls.rls_init(7, dtype=torch.float64, device="cpu", batch_shape=(B,))
    for _ in range(20):
        phi = rng.normal(size=(B, 7))
        y = rng.normal(size=B)
        j = jax.vmap(lambda s, p, yy: jrls.rls_update(s, p, yy, 0.995,
                                                      P_max))(
            j, jnp.asarray(phi), jnp.asarray(y))
        t = trls.rls_update(t, torch.from_numpy(phi), torch.from_numpy(y),
                            0.995, P_max)
    _close_normwise(t.theta.numpy(), np.asarray(j.theta))
    _close_normwise(t.P.numpy(), np.asarray(j.P))
    tr = np.trace(t.P.numpy(), axis1=-2, axis2=-1)
    if P_max is not None:
        assert np.all(tr <= P_max * (1 + 1e-12))


def test_governor_and_staged_reference_match_jax():
    rng = np.random.default_rng(6)
    r_v = rng.normal(size=(B, 4)) * 0.05
    target = rng.uniform(-0.1, 0.1, size=(B, 4))
    want_rv = _jax_lanes(lambda r, t: jref.reference_governor(r, t, 0.01,
                                                              0.5),
                         r_v, target)
    want_ref = _jax_lanes(lambda r, t: jref.build_ref_traj(r, t, 20, 0.2),
                          r_v, target)
    got_rv = tref.reference_governor(torch.from_numpy(r_v),
                                     torch.from_numpy(target), 0.01, 0.5)
    got_ref = tref.build_ref_traj(torch.from_numpy(r_v),
                                  torch.from_numpy(target), 20, 0.2)
    np.testing.assert_allclose(got_rv.numpy(), want_rv, **TOL)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, **TOL)
    assert got_ref.shape == (B, 21, 4)


def test_stiction_update_and_init_carry_match_jax():
    rng = np.random.default_rng(7)
    jc = jmpc.RMPCBatch(N=20, dt=DT)
    tc = tmpc.RMPCBatch(N=20, dt=DT)
    state = rng.normal(size=(B, 4)) * np.array([0.05, 0.01, 0.05, 0.01])
    target = rng.uniform(-0.1, 0.1, size=(B, 4))
    err_int = rng.uniform(-0.1, 0.1, size=(B, 2))     # some past int_max
    want = _jax_lanes(jc._stiction_update, err_int, state, target)
    got = tc._stiction_update(torch.from_numpy(err_int),
                              torch.from_numpy(state),
                              torch.from_numpy(target))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # Both branches (stalled and moving) and the clamp are exercised.
    stalled = np.abs(state[:, [1, 3]]) < tc.stiction_vstall
    assert stalled.any() and (~stalled).any()
    assert np.any(np.abs(got[0].numpy()) == tc.int_max)

    jcarry = jc.init_carry_batch(jnp.asarray(state), jnp.float64)
    tcarry = tc.init_carry(torch.from_numpy(state), torch.float64)
    conv = from_jax(jcarry, "cpu")
    for name in tcarry._fields:
        a, b = getattr(tcarry, name), getattr(conv, name)
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), y.numpy())
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
