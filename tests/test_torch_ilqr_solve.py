"""Port parity: the single-lane box-DDP / AL solve on a lane axis
(`dart_tpu_torch.solver.ilqr.solve`) against `jax.vmap(dart_tpu.solver.
ilqr.solve)` on the same numpy problems, in float64.

Cases: the PMPC, slew-exact RMPC (AL), soft-slew RMPC (AL) and LMPC OCPs
at N=6, both line searches, lanes that finish at their first iteration
while others go on (so the freeze of a finished lane's gnorm,
regularisation and iteration count shows), and a NaN lane under the
parallel search (jnp.argmin and torch.argmin both take the first NaN). On
the CPU every backward pass is the plain version of `csrc/riccati.cu`;
JAX's vmapped solve runs its XLA scan `_backward`, which the last test
holds the Riccati route to on an OCP's own linearisation, as
tests/test_pallas_riccati.py:38 does on random data.

Tolerances: V, Z and K to 1e-9, viol and grad_norm to 1e-9 and the cost
to 1e-12 relative (the same iterations on both sides; the backward passes
sum their small products in another order, a few ulps each); iters equal
on every lane."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.models import dynamics as jdyn
from dart_tpu.solver import ilqr as jilqr
from dart_tpu.solver import ocp as jocp
from dart_tpu_torch.solver import ilqr as tilqr
from dart_tpu_torch.solver import ocp as tocp
from dart_tpu_torch.utils.convert import from_jax

N, DT = 6, 0.01
ATOL = 1e-9
COST_RTOL = 1e-12
LMPC_Q = [200.0, 2.0, 200.0, 2.0, 0.0, 0.0, 0.0, 0.0]


def _problem(kind: str, B: int, seed: int):
    """(JAX ocp, port ocp, JAX params, JAX aux, z0, V0) in float64. Lane 0
    starts at its target with V0 = 0: a zero feedforward ends its loop at
    the first iteration."""
    rng = np.random.default_rng(seed)
    V0 = rng.normal(size=(B, N, 2)) * 0.05
    V0[0] = 0.0
    full = lambda v: jnp.full(B, v)    # noqa: E731
    if kind == "pmpc":
        kw = dict(dt=DT, u_bound=0.6)
        mk = "make_pmpc_ocp"
        z0 = np.zeros((B, 6))
        z0[:, 0] = rng.uniform(-0.05, 0.05, B)
        z0[:, 1] = rng.uniform(-0.1, 0.1, B)
        tgt = np.zeros((B, 6))
        tgt[:, 0] = rng.uniform(-0.1, 0.1, B)
        tgt[:, 2] = rng.uniform(-0.1, 0.1, B)
        tgt[0], z0[0] = 0.0, 0.0
        params = jdyn.PMPCParams(mu=jnp.asarray(rng.uniform(0.05, 0.2, B)),
                                 g=full(jdyn.GRAVITY_Z), dt=full(DT))
        aux = jocp.PMPCAux(target=jnp.asarray(tgt), Qp=full(300.0),
                           Qv=full(2.0), R=full(0.2))
    elif kind in ("rmpc_du", "rmpc"):
        kw = dict(dt=DT, u_bound=0.4, du_bound=0.05, vmax=0.25)
        mk = "make_rmpc_ocp_du" if kind == "rmpc_du" else "make_rmpc_ocp"
        z0 = np.zeros((B, 6))
        z0[:, 1] = rng.uniform(-0.2, 0.2, B)     # some lanes near the caps
        z0[:, 3] = rng.uniform(-0.2, 0.2, B)
        z0[0] = 0.0
        ref = np.zeros((B, N + 1, 4))
        ref[..., 0] = rng.uniform(-0.1, 0.1, (B, 1))
        ref[..., 2] = rng.uniform(-0.1, 0.1, (B, 1))
        ref[0] = 0.0
        theta = rng.normal(size=(B, 14)) * 0.3
        theta[0] = 0.0
        params = jdyn.RMPCParams(theta=jnp.asarray(theta),
                                 g=full(jdyn.GRAVITY_Z), v_eps=full(0.1))
        aux = jocp.RMPCAux(ref=jnp.asarray(ref), Qp=full(100.0),
                           Qv=full(1.0), Ru=full(0.05), Rdu=full(1.0))
    else:
        kw = dict(dt=DT, u_bound=0.4)
        mk = "make_lmpc_ocp"
        z0 = np.zeros((B, 10))
        z0[:, 1] = rng.uniform(-0.1, 0.1, B)
        tgt = np.zeros((B, 8))
        tgt[:, 0] = rng.uniform(-0.1, 0.1, B)
        tgt[:, 2] = rng.uniform(-0.1, 0.1, B)
        tgt[0], z0[0] = 0.0, 0.0
        params = jnp.asarray(rng.uniform(0.05, 0.3, (B, 34)))
        tile = lambda w: jnp.tile(jnp.asarray(w), (B, 1))   # noqa: E731
        aux = jocp.LMPCAux(target=jnp.asarray(tgt), Q=tile(LMPC_Q),
                           R=tile([0.1, 0.1, 1.0, 1.0]), Qt=tile(LMPC_Q))
    return (getattr(jocp, mk)(**kw), getattr(tocp, mk)(**kw), params, aux,
            z0, V0)


def _port(tree):
    if hasattr(tree, "_fields"):
        return from_jax(tree, "cpu")
    return torch.from_numpy(np.array(tree))


def _check(got, want, lanes=slice(None)):
    for name in ("V", "Z", "K", "viol", "grad_norm"):
        np.testing.assert_allclose(getattr(got, name).numpy()[lanes],
                                   np.asarray(getattr(want, name))[lanes],
                                   rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(got.cost.numpy()[lanes],
                               np.asarray(want.cost)[lanes],
                               rtol=COST_RTOL, atol=0)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert got.iters.dtype == torch.int32


@pytest.mark.parametrize("kind,linesearch,max_iters", [
    ("pmpc", "parallel", 8), ("rmpc_du", "backtrack", 6),
    ("rmpc", "parallel", 6), ("lmpc", "backtrack", 8)])
def test_solve_matches_vmapped_jax(kind, linesearch, max_iters):
    """Lane by lane, the port's solve is JAX's vmapped solve. Lane 0
    finishes at its first iteration; under `vmap` its gnorm, reg and
    iteration count stay as they were then while the others iterate on,
    unlike `solve_batch`, whose iteration count is the batch's. The
    PMPC parallel case adds a lane whose z0 is NaN."""
    B = 5
    jo, to, params, aux, z0, V0 = _problem(kind, B, seed=len(kind))
    nan_lane = kind == "pmpc" and linesearch == "parallel"
    if nan_lane:
        z0[3, 1] = np.nan
    al = {} if kind in ("pmpc", "lmpc") else {"al_iters": 3}
    jcfg = jilqr.ILQRConfig(max_iters=max_iters, linesearch=linesearch, **al)
    tcfg = tilqr.ILQRConfig(max_iters=max_iters, linesearch=linesearch, **al)
    want = jax.vmap(lambda p, a, z, v: jilqr.solve(jo, jcfg, p, a, z, v))(
        params, aux, jnp.asarray(z0), jnp.asarray(V0))
    tilqr.host_bool.count = 0
    got = tilqr.solve(to, tcfg, _port(params), _port(aux),
                      torch.from_numpy(z0), torch.from_numpy(V0))
    reads = tilqr.host_bool.count
    _check(got, want)
    iters = got.iters.numpy()
    rounds = al.get("al_iters", 1)
    assert iters[0] == rounds          # one iteration a round, then frozen
    assert iters.max() > iters[0]      # while the other lanes went on
    assert float(got.grad_norm[0]) == 0.0
    # One read per iteration of the longest lane and one to stop; the
    # backtracking search adds one per trial, at least one per iteration.
    if rounds == 1:
        n = int(iters.max())
        if linesearch == "parallel":
            assert reads == n + 1
        else:
            assert reads >= 2 * n + 1
    if nan_lane:
        # No trial beats a NaN cost: the lane keeps its warm start, its x
        # axis and gnorm are NaN, and it runs every iteration.
        np.testing.assert_array_equal(got.V.numpy()[3], V0[3])
        assert np.isnan(got.Z.numpy()[3, 1:, :2]).all()
        assert np.isnan(float(got.grad_norm[3]))
        assert np.isfinite(np.delete(got.Z.numpy(), 3, axis=0)).all()
        assert iters[3] == max_iters


def test_riccati_route_matches_xla_backward():
    """The backward pass `solve` runs (`ilqr.backward` -> `riccati_backward`)
    against JAX's vmapped XLA scan `ilqr._backward` on an OCP's own
    autodiff linearisation (the port's, which tests/test_torch_solve_batch.
    py holds to JAX's) with an AL penalty, a per-lane regularisation and V
    inside the box: the slew-exact RMPC OCP (nz 6) and the LMPC OCP (nz
    10)."""
    for kind in ("rmpc_du", "lmpc"):
        B = 7
        jo, to, params, aux, z0, V0 = _problem(kind, B, seed=11)
        n_con = max(jo.n_con, 1)
        rng = np.random.default_rng(12)
        lam = np.abs(rng.normal(size=(B, N, n_con)))
        mu = rng.uniform(1.0, 10.0, B)
        reg = rng.uniform(1e-7, 1e-5, B)
        tp, ta, tV = _port(params), _port(aux), torch.from_numpy(V0)
        Z = tilqr._rollout(to, tp, torch.from_numpy(z0), tV)
        derivs = tilqr._linearize(to, tp, ta, Z, tV, torch.from_numpy(lam),
                                  torch.from_numpy(mu))
        D_t, K_t = tilqr.backward(derivs, tV, to.u_lo, to.u_hi,
                                  torch.from_numpy(reg))
        lo, hi = jnp.asarray(jo.u_lo), jnp.asarray(jo.u_hi)
        D_j, K_j, _, _ = jax.jit(jax.vmap(
            lambda d, v, r: jilqr._backward(d, v, lo, hi, r)))(
                tuple(jnp.asarray(d.numpy()) for d in derivs),
                jnp.asarray(V0), jnp.asarray(reg))
        np.testing.assert_allclose(D_t.numpy(), np.asarray(D_j), rtol=0,
                                   atol=1e-10, err_msg=kind)
        np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), rtol=0,
                                   atol=1e-10, err_msg=kind)
        assert np.abs(np.asarray(D_j)).max() > 1e-3
