"""Port parity: the PMPC model, RK4 and the exact affine discretisation
(`dart_tpu_torch.models.dynamics`, `dart_tpu_torch.solver.pmpc_fast`)
against their `dart_tpu` twins on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.models import dynamics as jdyn
from dart_tpu.solver import pmpc_fast as jfast
from dart_tpu_torch.models import dynamics as tdyn
from dart_tpu_torch.solver import pmpc_fast as tfast

B, DT = 128, 0.002
# float64: same operations in the same order, so agreement is to roundoff
# of a few ulps (sin/cos come from different libraries). float32: a few
# float32 ulps on values of order 1-500 (az carries a 1/dt = 500 factor).
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=1e-5, atol=1e-5)}
DTYPES = [np.float64, np.float32]


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, 6)) * 0.1).astype(dtype)
    u = rng.uniform(-0.6, 0.6, size=(B, 2)).astype(dtype)
    mu = rng.uniform(0.05, 0.2, size=(B,)).astype(dtype)
    return x, u, mu


def _jax_batched(f, x, u, mu):
    return np.asarray(jax.vmap(
        lambda xi, ui, mi: f(xi, ui, jdyn.PMPCParams(mu=mi, dt=DT)))(
            jnp.asarray(x), jnp.asarray(u), jnp.asarray(mu)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pmpc_dynamics_matches_jax(dtype):
    x, u, mu = _inputs(dtype)
    want = _jax_batched(jdyn.pmpc_dynamics, x, u, mu)
    got = tdyn.pmpc_dynamics(torch.from_numpy(x), torch.from_numpy(u),
                             tdyn.PMPCParams(mu=torch.from_numpy(mu), dt=DT))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rk4_step_matches_jax(dtype):
    x, u, mu = _inputs(dtype, seed=1)
    jstep = jdyn.discretize(jdyn.pmpc_dynamics, DT)
    want = _jax_batched(jstep, x, u, mu)
    tstep = tdyn.discretize(tdyn.pmpc_dynamics, DT)
    got = tstep(torch.from_numpy(x), torch.from_numpy(u),
                tdyn.PMPCParams(mu=torch.from_numpy(mu), dt=DT))
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_affine_discretization_matches_jax(dtype):
    """Ad/Sd are polynomials of a 3-nonzero companion matrix: every entry is
    one product chain, so both frameworks agree bitwise."""
    _, _, mu = _inputs(dtype, seed=2)
    jAd, jSd = jfast._affine_discretization(jnp.asarray(mu), -9.81, DT)
    tAd, tSd = tfast._affine_discretization(torch.from_numpy(mu), -9.81, DT)
    np.testing.assert_array_equal(tAd.numpy(), np.asarray(jAd))
    np.testing.assert_array_equal(tSd.numpy(), np.asarray(jSd))


@pytest.mark.parametrize("dtype", DTYPES)
def test_affine_step_matches_rk4(dtype):
    """x+ = Ad x + Sd c(u) is the RK4 step of the plant, in the port."""
    x, u, mu = _inputs(dtype, seed=3)
    tx, tu, tmu = map(torch.from_numpy, (x, u, mu))
    Ad, Sd = tfast._affine_discretization(tmu, -9.81, DT)
    affine = (Ad @ tx[..., None])[..., 0] + \
        (Sd @ tfast._c_of_u(tu, -9.81, DT)[..., None])[..., 0]
    rk4 = tdyn.rk4_step(tdyn.pmpc_dynamics, tx, tu,
                        tdyn.PMPCParams(mu=tmu, dt=DT), DT)
    np.testing.assert_allclose(affine.numpy(), rk4.numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_c_of_u_and_dcdu_match_jax(dtype):
    _, u, _ = _inputs(dtype, seed=4)
    for jf, tf in ((jfast._c_of_u, tfast._c_of_u),
                   (jfast._dcdu, tfast._dcdu)):
        want = np.asarray(jf(jnp.asarray(u), -9.81, DT))
        got = tf(torch.from_numpy(u), -9.81, DT)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
