"""Port parity for the slice as a whole: the warm batched PMPC closed loop
(`PMPCBatch.solve` -> apply u -> RK4 plant) against the same loop built in
JAX, plus the state converters and the rule that the port never imports
JAX."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.control import mpc as jmpc
from dart_tpu.models import dynamics as jdyn
from dart_tpu.solver import mppi as jmppi
from dart_tpu.solver import ocp as jocp
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.models import dynamics as tdyn
from dart_tpu_torch.rollout import loop
from dart_tpu_torch.solver import ocp as tocp
from dart_tpu_torch.utils.convert import from_jax, to_numpy

B, N, DT, STEPS = 128, 4, 0.002, 5
REPO = Path(__file__).resolve().parents[1]


def _scenario():
    """Bench distributions (bench.py:160-167) with a small start offset."""
    rng = np.random.default_rng(0)
    tgts = rng.uniform(-0.1, 0.1, size=(B, 6)) * np.array([1, 0, 1, 0, 0, 0])
    mus = rng.uniform(0.05, 0.2, size=(B,))
    x0 = rng.normal(size=(B, 6)) * 0.01
    return tgts, mus, x0


def _jax_closed_loop(tgts, mus, x0):
    """One jitted lax.scan of the JAX kernel-path PMPCBatch (interpret
    mode) and the RK4 plant, applying the u that solve returns."""
    ctlr = jmpc.PMPCBatch(N=N, dt=DT, kernel_interpret=True)
    w = jmpc.PMPCWeights(jnp.asarray(300.0), jnp.asarray(2.0),
                         jnp.asarray(0.2))
    params = jdyn.PMPCParams(mu=jnp.asarray(mus), dt=DT)
    tg = jnp.asarray(tgts)
    plant = jdyn.discretize(jdyn.pmpc_dynamics, DT)
    plant_v = jax.vmap(lambda x, u, mu: plant(x, u, jdyn.PMPCParams(mu=mu,
                                                                    dt=DT)))

    @jax.jit
    def run(x0, V0):
        def f(c, _):
            carry, x = c
            carry, u, _ = ctlr.solve(carry, x, tg, params, w)
            return (carry, plant_v(x, u, params.mu)), u

        (carry, xf), us = jax.lax.scan(f, (jmpc.PMPCCarry(V=V0), x0), None,
                                       length=STEPS)
        return carry.V, xf, us

    return [np.asarray(a) for a in run(jnp.asarray(x0),
                                       jnp.zeros((B, N, 2), jnp.float64))]


def test_closed_loop_matches_jax():
    tgts, mus, x0 = _scenario()
    V_j, xf_j, us_j = _jax_closed_loop(tgts, mus, x0)

    ctlr = tmpc.PMPCBatch(N=N, dt=DT)
    t_mus = torch.from_numpy(mus)
    solve_fn = loop.pmpc_solve_fn(ctlr, torch.from_numpy(tgts),
                                  tdyn.PMPCParams(mu=t_mus, dt=DT),
                                  tmpc.PMPCWeights(300.0, 2.0, 0.2))
    carry, xf, us = loop.run_batch_closed_loop(
        solve_fn, loop.pmpc_plant_step(t_mus, DT),
        ctlr.init_carry(B, torch.float64, "cpu"), torch.from_numpy(x0),
        STEPS)
    # float64, same operations in the same order: a few ulps per step.
    assert us.shape == (STEPS, B, 2)
    np.testing.assert_allclose(us.numpy(), us_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(xf.numpy(), xf_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(carry.V.numpy(), V_j, rtol=0, atol=1e-9)
    # the loop really drives the plant (a 4-stage horizon tilts gently)
    assert float(us.abs().max()) > 0.01


def test_quality_at_1cm_matches_bench_formula():
    rng = np.random.default_rng(4)
    tgts = rng.uniform(-0.1, 0.1, (B, 6))
    xf = tgts + rng.normal(size=(B, 6)) * 0.01
    success, err_mm = loop.quality_at_1cm(torch.from_numpy(xf),
                                          torch.from_numpy(tgts))
    err = np.hypot(xf[:, 0] - tgts[:, 0], xf[:, 2] - tgts[:, 2])
    assert success == pytest.approx(float(np.mean(err < 0.01)), abs=1e-7)
    assert err_mm == pytest.approx(float(np.mean(err)) * 1e3, rel=1e-12)
    assert 0.0 < success < 1.0


def test_from_jax_to_numpy_round_trip():
    rng = np.random.default_rng(5)
    mus = rng.uniform(0.05, 0.2, B)
    jax_trees = [
        jdyn.PMPCParams(mu=mus, dt=DT),
        jocp.PMPCAux(target=rng.normal(size=(B, 6)), Qp=np.full(B, 300.0),
                     Qv=np.full(B, 2.0), R=np.full(B, 0.2)),
        jmpc.PMPC_WEIGHTS["cube"],
        jmpc.PMPCCarry(V=jnp.asarray(rng.normal(size=(B, N, 2)))),
        jmpc.SolveDiag(cost=np.ones(B), viol=np.zeros(B),
                       iters=np.full(B, 4, np.int32), grad_norm=np.ones(B)),
    ]
    for jt in jax_trees:
        tt = from_jax(jt, "cpu")
        assert type(tt).__name__ == type(jt).__name__
        assert type(tt).__module__.startswith("dart_tpu_torch.")
        assert tt._fields == jt._fields
        back = to_numpy(tt)
        for a, b in zip(back, jt):
            if isinstance(b, float):
                assert isinstance(a, float) and a == b
            else:
                np.testing.assert_array_equal(a, np.asarray(b))
                assert a.dtype == np.asarray(b).dtype
    params = from_jax(jdyn.PMPCParams(mu=mus, dt=DT), "cpu", torch.float32)
    assert isinstance(params.g, float) and params.g == jdyn.GRAVITY_Z
    assert params.mu.dtype == torch.float32
    diag = from_jax(jax_trees[-1], "cpu", torch.float32)
    assert diag.iters.dtype == torch.int32       # integers keep their type
    with pytest.raises(TypeError, match="no port counterpart"):
        from_jax(jmppi.MPPICarry(U=np.zeros((N, 2)), key=np.zeros(2)),
                 "cpu")


def test_stage_and_terminal_cost_match_jax():
    rng = np.random.default_rng(6)
    z = rng.normal(size=(B, 6)) * 0.1
    v = rng.uniform(-0.6, 0.6, (B, 2))
    aux_np = jocp.PMPCAux(target=rng.normal(size=(B, 6)) * 0.1,
                          Qp=np.full(B, 300.0), Qv=np.full(B, 2.0),
                          R=np.full(B, 0.2))
    jocp_ = jocp.make_pmpc_ocp(dt=DT)
    aux_j = jax.tree.map(jnp.asarray, aux_np)
    want_s = jax.vmap(lambda zi, vi, a: jocp_.stage_cost(zi, vi, 0, a))(
        jnp.asarray(z), jnp.asarray(v), aux_j)
    want_t = jax.vmap(jocp_.term_cost)(jnp.asarray(z), aux_j)
    tocp_ = tocp.make_pmpc_ocp(dt=DT)
    aux_t = from_jax(aux_np, "cpu")
    got_s = tocp_.stage_cost(torch.from_numpy(z), torch.from_numpy(v), 0,
                             aux_t)
    got_t = tocp_.term_cost(torch.from_numpy(z), aux_t)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-13)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-13)
    assert tocp_.u_lo == jocp_.u_lo and tocp_.u_hi == jocp_.u_hi
    np.testing.assert_array_equal(
        tocp._pmpc_w(aux_t, torch.float64).numpy(),
        np.asarray(jax.vmap(lambda a: jocp._pmpc_w(a, jnp.float64))(aux_j)))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_never_imports_jax():
    """A static scan: importing the port at run time proves nothing, since
    the interpreter may import jax at start-up."""
    files = sorted((REPO / "dart_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax",
                                "orbax"), (f, mod)
            assert root != "dart_tpu", (f, mod)
