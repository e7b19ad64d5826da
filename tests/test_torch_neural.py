"""Port parity: the box QPs (`ops.boxqp`), the Riccati backward pass
`ilqr.backward` on the shapes the kernel has no instance for and the
route it takes by shape, the
learned-dynamics model and its OCP (`models.neural`) through `ilqr.solve`,
its Adam fit, and the horizon-parallel LQR (`ops.lqr_parallel`), against
`dart_tpu`'s on the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.models import neural as jn
from dart_tpu.ops import boxqp as jbq
from dart_tpu.ops import lqr_parallel as jlq
from dart_tpu.solver import ilqr as jil
from dart_tpu_torch.models import neural as tn
from dart_tpu_torch.ops import boxqp as tbq
from dart_tpu_torch.ops import lqr_parallel as tlq
from dart_tpu_torch.ops.kernels import riccati as kric
from dart_tpu_torch.solver import ilqr as til
from dart_tpu_torch.utils.convert import actor_critic_state_dict

ATOL = 1e-9


def _spd(rng, B, n, scale=1.0):
    L = rng.normal(size=(B, n, n)) * scale
    return L @ L.transpose(0, 2, 1) + 0.1 * np.eye(n)


def _qps(seed, B, n):
    """Random SPD problems whose boxes hold 0 or not, some tight."""
    rng = np.random.default_rng(seed)
    Quu = _spd(rng, B, n)
    Qu = rng.normal(size=(B, n)) * 2.0
    lo = -rng.uniform(0.01, 1.0, (B, n)) + rng.normal(size=(B, n)) * 0.2
    hi = lo + rng.uniform(0.0, 1.5, (B, n))
    return Quu, Qu, lo, hi


@pytest.mark.parametrize("fn,n", [("boxqp2", 2), ("boxqp_pn", 2),
                                  ("boxqp_pn", 3), ("boxqp", 2),
                                  ("boxqp", 4)])
def test_boxqp_matches_jax(fn, n):
    """`boxqp2`, `boxqp_pn` and the dispatch `boxqp` on 64 random SPD
    problems against JAX's, vmapped: the step and the free mask. float64;
    the nine candidates and the 12 projected-Newton steps are the same
    operations."""
    args = _qps(n * 10 + len(fn), 64, n)
    dj, fj = jax.vmap(getattr(jbq, fn))(*(jnp.asarray(a) for a in args))
    dt, ft = getattr(tbq, fn)(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    lo, hi = args[2], args[3]
    d = dt.numpy()
    assert (d >= lo - 1e-12).all() and (d <= hi + 1e-12).all()


def _derivs(seed, B, N, nz, nu):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, N, nz, nz)) * 0.3 + np.eye(nz)
    Bm = rng.normal(size=(B, N, nz, nu)) * 0.3
    lx, lu = rng.normal(size=(B, N, nz)), rng.normal(size=(B, N, nu))
    lxx = _spd(rng, B * N, nz).reshape(B, N, nz, nz)
    lux = rng.normal(size=(B, N, nu, nz)) * 0.1
    luu = _spd(rng, B * N, nu).reshape(B, N, nu, nu) + np.eye(nu)
    gx, gxx = rng.normal(size=(B, nz)), _spd(rng, B, nz)
    V = rng.uniform(-0.3, 0.3, (B, N, nu))
    reg = rng.uniform(1e-6, 1e-2, B)
    return [A, Bm, lx, lu, lxx, lux, luu, gx, gxx], V, reg


@pytest.mark.parametrize("nz,nu", [(6, 2), (8, 2), (5, 3)])
def test_generic_backward_matches_jax(nz, nu):
    """`ilqr.backward` against JAX's `_backward`, vmapped over 7 lanes of
    random derivatives (N=5, a tight box): D and K within 1e-9, float64.
    nz=6, nu=2 routes to `riccati_backward` (its plain version here); nz=8
    and nu=3 take the same lane recursion without it, nu=3 through the
    projected-Newton QP."""
    ders, V, reg = _derivs(nz + nu, 7, 5, nz, nu)
    lo, hi = (-0.4,) * nu, (0.4,) * nu
    Dj, Kj, _, _ = jax.vmap(lambda d, v, r: jil._backward(
        d, v, jnp.asarray(lo), jnp.asarray(hi), r))(
        [jnp.asarray(x) for x in ders], jnp.asarray(V), jnp.asarray(reg))
    tders = [torch.from_numpy(x) for x in ders]
    Dt, Kt = til.backward(tders, torch.from_numpy(V), lo, hi,
                          torch.from_numpy(reg))
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(Kt.numpy(), np.asarray(Kj), rtol=0, atol=ATOL)
    assert til.kernel_route(nz, nu) == (nu == 2 and nz in (6, 10))


def _plant_j(x, u):
    """tests/test_neural.py's 4-state tray plant with nonlinear friction."""
    vx, vy = x[1], x[3]
    ax = -9.81 * jnp.sin(u[0]) - 0.3 * vx - 0.5 * jnp.tanh(vx / 0.05)
    ay = -9.81 * jnp.sin(u[1]) - 0.3 * vy - 0.5 * jnp.tanh(vy / 0.05)
    return jnp.stack([vx, ax, vy, ay])


def _plant_t(x, u):
    vx, vy = x[..., 1], x[..., 3]
    ax = -9.81 * torch.sin(u[..., 0]) - 0.3 * vx - 0.5 * torch.tanh(vx / 0.05)
    ay = -9.81 * torch.sin(u[..., 1]) - 0.3 * vy - 0.5 * torch.tanh(vy / 0.05)
    return torch.stack([vx, ax, vy, ay], -1)


def _module(nx: int, hidden=(64, 64)):
    """JAX's `DynamicsMLP` initialised from PRNGKey(0) and the port's
    module holding the same weights."""
    mj = jn.DynamicsMLP(nx=nx, hidden=hidden)
    pj = mj.init(jax.random.PRNGKey(0), jnp.zeros(nx, jnp.float32),
                 jnp.zeros(2, jnp.float32))
    mt = tn.DynamicsMLP(nx, hidden, device="cpu")
    mt.load_state_dict(actor_critic_state_dict(pj))
    return mj, pj, mt


def test_transitions_module_and_converter_match_jax(monkeypatch):
    """`collect_transitions` draws JAX's states and controls from the same
    numpy generator (bit for bit) and the plant's xdot to float32
    round-off; the converted module's forward pass equals flax's apply to
    float32 round-off; `reset_parameters` draws flax's initialisation law
    (zero biases, truncated-normal kernels of variance 1 / fan_in).
    Without CUDA the module and the dataset raise unless the CPU is asked
    for, before anything is drawn."""
    Xj, Uj, Yj = jn.collect_transitions(_plant_j, np.random.default_rng(0),
                                        512, 4)
    Xt, Ut, Yt = tn.collect_transitions(_plant_t, np.random.default_rng(0),
                                        512, 4, device="cpu")
    np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))
    np.testing.assert_array_equal(Ut.numpy(), np.asarray(Uj))
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0, atol=2e-6)
    mj, pj, mt = _module(4)
    with torch.no_grad():
        out = mt(Xt, Ut)
    np.testing.assert_allclose(out.numpy(), np.asarray(mj.apply(pj, Xj, Uj)),
                               rtol=0, atol=1e-6)
    m = tn.DynamicsMLP(4, (256, 256), device="cpu").reset_parameters(
        torch.Generator().manual_seed(0))
    for layer in m.layers():
        w = layer.weight.detach()
        assert (layer.bias == 0).all()
        std = float(w.std()) * np.sqrt(layer.in_features)
        assert 0.9 < std < 1.1, std
        assert float(w.abs().max()) * np.sqrt(layer.in_features) < 2.3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tn.collect_transitions(_plant_t, rng, 8, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tn.DynamicsMLP(4)
    assert rng.normal() == np.random.default_rng(0).normal()


def test_fit_dynamics_matches_jax():
    """50 Adam steps at tests/test_neural.py's settings (4096 transitions,
    64-64, batch 256, lr 1e-3) from the same weights on JAX's own data,
    with the minibatch indices JAX's `randint` draws from its key chain,
    float32: the weights within 5e-7 and the last loss within 1e-6
    relative (the runs differ by 6e-8 and 7e-8: the gradients' float32
    round-off).
    Without indices the draws come from the generator, reproducibly;
    without either, the fit raises."""
    X, U, Y = jn.collect_transitions(_plant_j, np.random.default_rng(0),
                                     4096, 4)
    mj, pj, mt = _module(4)
    nm_j, nm_t = jn.NeuralModel(module=mj), tn.NeuralModel(mt)
    key, steps = jax.random.PRNGKey(1), 50
    wj, lj = jn.fit_dynamics(nm_j, pj, X, U, Y, key, steps=steps)
    idx = np.stack([np.asarray(jax.random.randint(k, (256,), 0, 4096))
                    for k in jax.random.split(key, steps)])
    data = [torch.tensor(np.asarray(a)) for a in (X, U, Y)]
    wt, lt = tn.fit_dynamics(nm_t, tn.weights(mt), *data, steps=steps,
                             indices=torch.from_numpy(idx))
    want = actor_critic_state_dict(wj)
    assert set(wt) == set(want)
    for k in want:
        np.testing.assert_allclose(wt[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=5e-7, err_msg=k)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    runs = [tn.fit_dynamics(nm_t, tn.weights(mt), *data,
                            gen=torch.Generator().manual_seed(4), steps=5)
            for _ in range(2)]
    for k in want:
        assert torch.equal(runs[0][0][k], runs[1][0][k])
    with pytest.raises(ValueError, match="torch.Generator"):
        tn.fit_dynamics(nm_t, tn.weights(mt), *data, steps=1)


@pytest.mark.parametrize("nx", [4, 6])
def test_neural_ocp_solve_matches_jax(nx, monkeypatch):
    """`ilqr.solve` through the network (`make_neural_ocp`, autodiff
    linearisation through the MLP, 15 iterations, N=10) on three lanes
    against JAX's `ilqr.solve` vmapped, the weights JAX's init cast to
    float64: V, Z, K, cost and iterations within 1e-9. nx=4 gives nz=6,
    which the Riccati kernel covers (`riccati_backward` runs, its plain
    version on the CPU); nx=6 gives nz=8, which takes the generic
    `_backward` and never calls `riccati_backward`."""
    mj, pj, mt = _module(nx, (32, 32))
    pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), pj)
    mt = mt.double()
    N, B, dt = 10, 3, 0.02
    rng = np.random.default_rng(nx)
    target = np.zeros(nx)
    target[[0, 2]] = [0.06, -0.05]
    Q = np.where(np.arange(nx) % 2 == 0, 200.0, 2.0)
    aux = (target, Q, np.asarray([0.1, 0.1, 1.0, 1.0]), Q)
    z0 = np.concatenate([rng.normal(size=(B, nx)) * 0.02,
                         rng.uniform(-0.1, 0.1, (B, 2))], -1)
    V0 = rng.uniform(-0.2, 0.2, (B, N, 2))
    cfg = jil.ILQRConfig(max_iters=15)
    ocp_j = jn.make_neural_ocp(jn.NeuralModel(module=mj), dt=dt, nx=nx)
    want = jax.vmap(lambda z, v: jil.solve(
        ocp_j, cfg, pj, tuple(jnp.asarray(a) for a in aux), z, v))(
        jnp.asarray(z0), jnp.asarray(V0))
    calls = []
    real = kric.riccati_backward
    monkeypatch.setattr(til, "riccati_backward",
                        lambda *a: calls.append(1) or real(*a))
    ocp_t = tn.make_neural_ocp(tn.NeuralModel(mt), dt=dt, nx=nx)
    got = til.solve(ocp_t, til.ILQRConfig(*cfg), tn.weights(mt),
                    tuple(torch.from_numpy(a) for a in aux),
                    torch.from_numpy(z0), torch.from_numpy(V0))
    for name in ("V", "Z", "K", "cost"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert (got.iters.numpy() >= 2).all()
    assert (len(calls) > 0) == (nx == 4)


def _lqr(rng, N, n=6, m=2):
    """tests/test_lqr_parallel.py's random problem."""
    A = rng.normal(size=(N, n, n)) * 0.2 + np.eye(n)
    Bm = rng.normal(size=(N, n, m)) * 0.3
    Qh = rng.normal(size=(N, n, n)) * 0.3
    Q = np.einsum("kij,klj->kil", Qh, Qh) + np.eye(n)[None] * 0.5
    Rh = rng.normal(size=(N, m, m)) * 0.2
    R = np.einsum("kij,klj->kil", Rh, Rh) + np.eye(m)[None]
    return A, Bm, Q, R, np.eye(n) * 2.0


@pytest.mark.parametrize("N", [1, 2, 7, 20, 64])
def test_lqr_parallel_matches_sequential_and_jax(N):
    """tests/test_lqr_parallel.py's problems: the associative scan against
    the sequential recursion (1e-9, as JAX's test holds JAX's) and against
    JAX's scan, and the gains from either; then three problems on a
    leading batch axis, each its own; float64."""
    A, Bm, Q, R, QN = _lqr(np.random.default_rng(N), N)
    args = [torch.from_numpy(a) for a in (A, Bm, Q, R, QN)]
    S_par = tlq.lqr_backward_parallel(*args)
    assert S_par.shape == (N + 1, 6, 6)
    torch.testing.assert_close(S_par, tlq.lqr_backward_sequential(*args),
                               rtol=0, atol=ATOL)
    S_j = jlq.lqr_backward_parallel(*(jnp.asarray(a) for a in (A, Bm, Q, R,
                                                               QN)))
    np.testing.assert_allclose(S_par.numpy(), np.asarray(S_j), rtol=0,
                               atol=ATOL)
    K_par = tlq.lqr_gains(args[0], args[1], args[3], S_par)
    K_j = jlq.lqr_gains(jnp.asarray(A), jnp.asarray(Bm), jnp.asarray(R), S_j)
    np.testing.assert_allclose(K_par.numpy(), np.asarray(K_j), rtol=0,
                               atol=ATOL)
    probs = [_lqr(np.random.default_rng(N + 100 * i), N) for i in range(3)]
    batch = [torch.from_numpy(np.stack(a)) for a in zip(*probs)]
    S_b = tlq.lqr_backward_parallel(*batch)
    for i in range(3):
        torch.testing.assert_close(
            S_b[i], tlq.lqr_backward_sequential(*(b[i] for b in batch)),
            rtol=0, atol=ATOL)
