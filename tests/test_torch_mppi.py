"""Port parity: the MPPI sampling solver (`solver.mppi`), its receding-
horizon front end, the MPPI scenario evaluator and `sweep --controller
mppi`, against `dart_tpu`'s on the same perturbations, in float64.

JAX draws the perturbations inside its solve from a key chain; the port
takes them as an argument. Each test walks JAX's chain (`_jax_noise`) and
passes the draws to the port.
"""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.models import dynamics as jdyn
from dart_tpu.rollout import evaluate as jev
from dart_tpu.solver import mppi as jm
from dart_tpu.solver.ocp import PMPCAux as JAux
from dart_tpu.solver.ocp import make_pmpc_ocp as j_ocp
from dart_tpu_torch.cli import sweep as tcli_sweep
from dart_tpu_torch.models import dynamics as tdyn
from dart_tpu_torch.rollout import evaluate as tev
from dart_tpu_torch.solver import ilqr as til
from dart_tpu_torch.solver import mppi as tm
from dart_tpu_torch.solver.ocp import PMPCAux as TAux
from dart_tpu_torch.solver.ocp import make_pmpc_ocp as t_ocp

ATOL = 1e-9
DT = 0.02
SIM_DT = 0.002
# The four rows of tests/test_torch_scenario_eval.py.
KAPPA = [[0.0, 0.0], [2.0, 0.0], [2.5, 2.5], [0.0, 0.0]]
MASS = [1.0, 2.0, 1.0, 2.0]
MU = [0.1, 0.05, 0.2, 0.1]
TARGET = [[0.05, -0.03], [-0.04, 0.02], [0.03, 0.05], [-0.05, -0.05]]


def _jax_noise(key, cfg, N: int, nu: int = 2) -> np.ndarray:
    """The perturbations `dart_tpu.solver.mppi.solve` draws from `key`:
    sigma * normal(k_i, (K, N, nu)) for k_i in split(key, n_iters)."""
    return np.stack([np.asarray(cfg.sigma * jax.random.normal(
        k, (cfg.n_samples, N, nu), jnp.float64))
        for k in jax.random.split(key, cfg.n_iters)])


def _aux(target):
    return (JAux(target=jnp.asarray(target), Qp=jnp.asarray(300.0),
                 Qv=jnp.asarray(2.0), R=jnp.asarray(0.2)),
            TAux(*(torch.tensor(x, dtype=torch.float64) for x in (
                [target], [300.0], [2.0], [0.2]))))


def test_solve_matches_jax():
    """One solve at tests/test_mppi.py's configuration (K=512, 8
    refinements, temperature 0.05, sigma 0.08) from zero controls and from
    a warm, partly clipped sequence, on JAX's perturbations: U within
    1e-9 and the weighted cost to 1e-9 relative. The solve closes most of
    the gap to the box-DDP optimum, as JAX's test asks."""
    N = 15
    cfg = jm.MPPIConfig(n_samples=512, temperature=0.05, sigma=0.08,
                        n_iters=8)
    aux_j, aux_t = _aux([0.08, 0.0, -0.05, 0.0, 0.0, 0.0])
    U0 = np.zeros((N, 2))
    U1 = np.clip(np.random.default_rng(3).normal(size=(N, 2)) * 0.4, -0.7,
                 0.7)
    for U_init, seed in ((U0, 0), (U1, 5)):
        key = jax.random.PRNGKey(seed)
        Uj, cj = jm.solve(j_ocp(dt=DT, u_bound=0.6), cfg,
                          jdyn.PMPCParams(mu=0.1, dt=DT), aux_j,
                          jnp.zeros(6), jnp.asarray(U_init), key)
        Ut, ct = tm.solve(t_ocp(dt=DT, u_bound=0.6), tm.MPPIConfig(*cfg),
                          tdyn.PMPCParams(mu=0.1, dt=DT), aux_t,
                          torch.zeros(1, 6, dtype=torch.float64),
                          torch.from_numpy(U_init)[None],
                          torch.from_numpy(_jax_noise(key, cfg, N)))
        np.testing.assert_allclose(Ut[0].numpy(), np.asarray(Uj), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(float(ct[0]), float(cj), rtol=ATOL)
        assert (Ut.abs() <= 0.6 + 1e-12).all()
    z0 = torch.zeros(1, 6, dtype=torch.float64)
    p = tdyn.PMPCParams(mu=0.1, dt=DT)
    ocp = t_ocp(dt=DT, u_bound=0.6)
    zero = float(tm._rollout_cost(ocp, p, aux_t, z0, torch.zeros(1, N, 2,
                                                        dtype=torch.float64)))
    opt = float(til.solve(ocp, til.ILQRConfig(), p, aux_t, z0,
                          torch.zeros(1, N, 2, dtype=torch.float64)).cost[0])
    key = jax.random.PRNGKey(0)
    Ut, _ = tm.solve(ocp, tm.MPPIConfig(*cfg), p, aux_t, z0,
                     torch.zeros(1, N, 2, dtype=torch.float64),
                     torch.from_numpy(_jax_noise(key, cfg, N)))
    got = float(tm._rollout_cost(ocp, p, aux_t, z0, Ut))
    assert got - opt < 0.15 * (zero - opt), (zero, got, opt)


def test_solve_lanes_and_noise_shapes():
    """Lanes solve independently: a batch of three lanes (per-lane
    targets, per-lane noise) equals each lane alone; noise shared by the
    lanes (n_iters, K, N, nu) equals the same draw repeated per lane; a
    noise of another shape raises."""
    N, cfg = 6, tm.MPPIConfig(n_samples=16, temperature=0.05, sigma=0.08,
                              n_iters=2)
    ocp = t_ocp(dt=DT, u_bound=0.6)
    g = torch.Generator().manual_seed(0)
    tgt = torch.randn(3, 6, generator=g, dtype=torch.float64) * 0.05
    aux = TAux(target=tgt, Qp=torch.full((3,), 300.0, dtype=torch.float64),
               Qv=torch.full((3,), 2.0, dtype=torch.float64),
               R=torch.full((3,), 0.2, dtype=torch.float64))
    p = tdyn.PMPCParams(mu=torch.tensor([0.1, 0.2, 0.05],
                                        dtype=torch.float64), dt=DT)
    z0 = torch.randn(3, 6, generator=g, dtype=torch.float64) * 0.01
    U = torch.zeros(3, N, 2, dtype=torch.float64)
    noise = tm.draw_noise(cfg, g, (3,), N, 2, torch.float64, "cpu")
    Ub, cb = tm.solve(ocp, cfg, p, aux, z0, U, noise)
    for i in range(3):
        one = tm.solve(ocp, cfg, tdyn.PMPCParams(mu=p.mu[i:i + 1], dt=DT),
                       TAux(*(x[i:i + 1] for x in aux)), z0[i:i + 1],
                       U[i:i + 1], noise[i:i + 1])
        torch.testing.assert_close(Ub[i:i + 1], one[0], rtol=0, atol=1e-14)
        torch.testing.assert_close(cb[i:i + 1], one[1], rtol=1e-14, atol=0)
    shared = noise[0]
    torch.testing.assert_close(
        tm.solve(ocp, cfg, p, aux, z0, U, shared)[0],
        tm.solve(ocp, cfg, p, aux, z0, U, shared.expand(3, *shared.shape))[0],
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="noise must be"):
        tm.solve(ocp, cfg, p, aux, z0, U, noise[:, :1])


def test_controller_closed_loop_matches_jax():
    """`make_controller` in closed loop with the analytic plant (tests/
    test_mppi.py's receding-horizon loop, 40 of its 300 steps), each step
    fed the perturbations JAX's carry key draws: states within 1e-9. Then
    the port's own generator drives the whole 300 steps to the target
    within 1 cm, as JAX's test asks of JAX."""
    N = 15
    cfg = jm.MPPIConfig(n_samples=256, temperature=0.05, sigma=0.08,
                        n_iters=2)
    target = [0.06, 0.0, 0.04, 0.0, 0.0, 0.0]
    aux_j, aux_t = _aux(target)
    jo, to = j_ocp(dt=DT, u_bound=0.6), t_ocp(dt=DT, u_bound=0.6)
    pj, pt = jdyn.PMPCParams(mu=0.1, dt=DT), tdyn.PMPCParams(mu=0.1, dt=DT)
    init_j, step_j = jm.make_controller(jo, cfg, N)
    init_t, step_t = tm.make_controller(to, tm.MPPIConfig(*cfg), N)
    plant_j = jdyn.discretize(jdyn.pmpc_dynamics, DT)
    plant_t = tdyn.discretize(tdyn.pmpc_dynamics, DT)
    step_j = jax.jit(step_j)

    cj = init_j(jax.random.PRNGKey(1), jnp.float64)
    ct = init_t(torch.Generator().manual_seed(0), 1, torch.float64)
    xj, xt = jnp.zeros(6), torch.zeros(1, 6, dtype=torch.float64)
    for _ in range(40):
        _, sub = jax.random.split(cj.key)
        noise = torch.from_numpy(_jax_noise(sub, cfg, N))
        cj, uj, _ = step_j(cj, pj, aux_j, xj)
        ct, ut, _ = step_t(ct, pt, aux_t, xt, noise)
        xj, xt = plant_j(xj, uj, pj), plant_t(xt, ut, pt)
        np.testing.assert_allclose(xt[0].numpy(), np.asarray(xj), rtol=0,
                                   atol=ATOL)

    ct = init_t(torch.Generator().manual_seed(1), 1, torch.float64)
    x = torch.zeros(1, 6, dtype=torch.float64)
    with torch.no_grad():
        for _ in range(300):
            ct, u, _ = step_t(ct, pt, aux_t, x)
            x = plant_t(x, u, pt)
    err = float(torch.hypot(x[0, 0] - target[0], x[0, 2] - target[2]))
    assert err < 0.01, err


def _rows():
    return [np.asarray(x, np.float64) for x in (KAPPA, MASS, MU, TARGET)]


def test_mppi_evaluator_matches_vmapped_jax():
    """`make_mppi_evaluator` on the four rows against `jax.vmap` of JAX's,
    at tests/test_torch_scenario_eval.py's shortened shape (45 steps, two
    solves 15 steps apart after 25 at rest, N=8), K=256 and 2 iterations,
    every lane fed the perturbations of JAX's shared key chain: metrics
    and final positions within 1e-9."""
    kw = dict(n_steps=45, dt=SIM_DT, control_every=15, warmup_steps=25,
              N=8, tol=0.01, seed=3)
    cfg = jm.MPPIConfig(n_samples=256, temperature=0.05, sigma=0.08,
                        n_iters=2)
    key, draws = jax.random.PRNGKey(3), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(_jax_noise(sub, cfg, 8)))
    ev_j = jev.make_mppi_evaluator(**kw)
    ev_t = tev.make_mppi_evaluator(**kw, draw=lambda j, dtype, dev: draws[j])
    rows = _rows()
    rj = jax.jit(jax.vmap(ev_j))(*(jnp.asarray(x) for x in rows))
    rt = ev_t(*(torch.from_numpy(x) for x in rows))
    np.testing.assert_allclose(rt.final_p.numpy(), np.asarray(rj.final_p),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(rt.metrics.converged.numpy(),
                                  np.asarray(rj.metrics.converged))
    for name in ("steady_state_error", "convergence_time", "control_effort",
                 "min_error"):
        np.testing.assert_allclose(getattr(rt.metrics, name).numpy(),
                                   np.asarray(getattr(rj.metrics, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    assert (rt.metrics.control_effort.numpy() > 0).all()


def test_mppi_evaluator_shares_one_noise_stream():
    """The default draw: a generator seeded at `seed` per episode, one draw
    per control step broadcast over the lanes (JAX's rows all start from
    PRNGKey(seed)). A lane's episode is the same alone and beside another
    row, and two calls are the same; another seed moves it."""
    kw = dict(n_steps=40, dt=SIM_DT, control_every=5, warmup_steps=25, N=6,
              n_samples=32, tol=0.01)
    rows = [torch.from_numpy(x) for x in _rows()]
    both = tev.make_mppi_evaluator(**kw)(*(x[:2] for x in rows))
    alone = tev.make_mppi_evaluator(**kw)(*(x[1:2] for x in rows))
    again = tev.make_mppi_evaluator(**kw)(*(x[1:2] for x in rows))
    other = tev.make_mppi_evaluator(**kw, seed=1)(*(x[1:2] for x in rows))
    torch.testing.assert_close(both.final_p[1:], alone.final_p, rtol=0,
                               atol=0)
    torch.testing.assert_close(again.final_p, alone.final_p, rtol=0, atol=0)
    assert not torch.equal(other.final_p, alone.final_p)


def test_sweep_mppi_runs_on_cpu():
    """`sweep --controller mppi --cpu` at a short runtime (one control step
    after the warm-up) prints the 18 rows, every number finite."""
    with redirect_stdout(io.StringIO()) as buf:
        assert tcli_sweep.main(["--controller", "mppi", "--cpu",
                                "--runtime", "0.51"]) == 0
    out = json.loads(buf.getvalue())
    assert out["summary"]["controller"] == "mppi"
    assert out["summary"]["n"] == 18 and len(out["scenarios"]) == 18
    for r in out["scenarios"]:
        assert np.isfinite(r["sse_mm"]) and np.isfinite(r["effort"])
        assert r["effort"] > 0
