"""Port parity: the metrics, the scenario batches, the batch PMPC / RMPC
evaluators on the contact plant, the one-device batch-major sweep and the
`sweep` CLI (`dart_tpu_torch.{rollout,io,parallel,cli}`) against
`dart_tpu`.

The evaluators run on the four rows of tests/test_rmpc_batch_eval.py in
float64 with `use_kernel=False` on both sides: JAX's PMPC batch evaluator
has no interpret knob, so on the CPU it never takes its kernel branch.
The kernel branches are held by the kernel tests and by `chip_smoke.py`.

Script mode prints JAX's own batch-major RMPC sweep on the 18-config grid
(`make_rmpc_batch_evaluator(use_kernel=False)` on the CPU, float32, the
CLI's default target), the reference for `chip_smoke.py`'s sweep gates:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_evaluate.py \
        calibrated 10
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_evaluate.py \
        legacy 10
"""

import io
import json
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.io import scenes as jsc
from dart_tpu.parallel import sweep as jsw
from dart_tpu.physics import tray_object as jto
from dart_tpu.rollout import evaluate as jev
from dart_tpu.rollout import metrics as jme
from dart_tpu_torch.adapt import lmpc_lagplant as tlag
from dart_tpu_torch.adapt import lmpc_trainer as ttr
from dart_tpu_torch.adapt import ppo as tppo
from dart_tpu_torch.cli import sweep as tcli
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.io import scenes as tsc
from dart_tpu_torch.parallel import sweep as tsw
from dart_tpu_torch.physics import tray_object as tto
from dart_tpu_torch.rollout import evaluate as tev
from dart_tpu_torch.rollout import metrics as tme
from dart_tpu_torch.utils.convert import from_jax

DT = 0.002
# float64, the same operations in the same order on both sides: the
# closed loops agree to ~1e-17 in the runs; 1e-9 leaves a margin for
# the plant's friction chatter (tests/test_torch_tray_object.py).
ATOL = 1e-9

# The four rows of tests/test_rmpc_batch_eval.py.
KAPPA = [[0.0, 0.0], [2.0, 0.0], [2.5, 2.5], [0.0, 0.0]]
MASS = [1.0, 2.0, 1.0, 2.0]
MU = [0.1, 0.05, 0.2, 0.1]
TARGET = [[0.05, -0.03], [-0.04, 0.02], [0.03, 0.05], [-0.05, -0.05]]


def _rows(np_dtype=np.float64):
    return [np.asarray(x, np_dtype) for x in (KAPPA, MASS, MU, TARGET)]


def _assert_metrics(t, j, atol=ATOL):
    np.testing.assert_array_equal(t.converged.numpy(), np.asarray(j.converged))
    np.testing.assert_array_equal(t.convergence_time.numpy() == np.inf,
                                  np.asarray(j.convergence_time) == np.inf)
    for name in ("steady_state_error", "convergence_time", "control_effort",
                 "min_error"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=0,
                                   atol=atol, err_msg=name)


def test_compute_metrics_matches_jax():
    """A (T, B, 4) trace with lanes that converge at once, later, after
    leaving the band, and never (inf)."""
    rng = np.random.default_rng(0)
    T, B = 300, 6
    target = rng.uniform(-0.1, 0.1, (B, 2))
    decay = np.exp(-np.linspace(0, 1, T))[:, None, None] * \
        np.asarray([0.0, 0.02, 0.05, 0.2, 0.005, 0.03])[None, :, None]
    xy = target + decay * np.asarray([1.0, -0.7])
    xy[:, 5] += 0.02          # never within 1 cm
    xy[:40, 4] += 0.02        # enters the band late
    X = np.zeros((T, B, 4))
    X[..., 0], X[..., 2] = xy[..., 0], xy[..., 1]
    U = rng.uniform(-0.6, 0.6, (T, B, 2))
    got = tme.compute_metrics(torch.tensor(X), torch.tensor(U),
                              torch.tensor(target), DT)
    want = jax.vmap(lambda x, u, t: jme.compute_metrics(x, u, t, DT),
                    in_axes=(1, 1, 0))(jnp.asarray(X), jnp.asarray(U),
                                       jnp.asarray(target))
    _assert_metrics(got, want, atol=1e-12)
    conv = got.converged.numpy()
    assert conv.any() and not conv.all()
    assert np.isinf(got.convergence_time.numpy()[~conv]).all()
    assert got.convergence_time.numpy()[4] == pytest.approx(40 * DT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scenes_match_jax(dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    targets = ((0.05, -0.04), (0.08, 0.06))
    got = tsc.sweep_grid(targets, dtype=dtype, device="cpu")
    want = jsc.sweep_grid(targets, dtype=jd)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.shape_id.dtype == torch.int32 and got.mass.dtype == dtype
    padded, n = tsc.pad_to_multiple(got, 16)
    jpadded, jn = jsc.pad_to_multiple(want, 16)
    assert (n, padded.size) == (jn, jpadded.size) == (36, 48)
    for a, b in zip(padded, jpadded):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tsc.pad_to_multiple(got, 12)[0] is got
    got = tsc.random_scenarios(np.random.default_rng(0), 37, dtype=dtype,
                               device="cpu")
    want = jsc.random_scenarios(np.random.default_rng(0), 37, dtype=jd)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("lag", ["calibrated", "legacy"])
def test_tray_params_per_lane(lag):
    """`scenario_params` on the 18-config grid, each lane against JAX's
    single-lane params broadcast to the port's (B,) / (B, 2) layout."""
    tray_lag = None if lag == "calibrated" else jto.LEGACY_TRAY_LAG
    g = jsc.sweep_grid(dtype=jnp.float64)
    want = jax.vmap(lambda k, m, f: jev._tray_params(
        k, m, f, jnp.float64, tray_lag))(g.kappa_inv, g.mass, g.mu)
    tg = tsc.sweep_grid(dtype=torch.float64, device="cpu")
    got = tto.scenario_params(tg.kappa_inv, tg.mass, tg.mu, torch.float64,
                              tray_lag)
    for name, a, b in zip(jto.TrayObjectParams._fields, want, got):
        a = np.asarray(a)
        assert b.shape[0] == 18 and b.dtype == torch.float64, name
        if a.ndim < b.ndim:
            a = np.broadcast_to(a[:, None], b.shape)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-15,
                                   err_msg=name)
    # The weights table per lane, as JAX's vmapped `_select_weights`.
    sid = tto.shape_from_kappa(tg.kappa_inv)
    np.testing.assert_array_equal(sid.numpy(), np.asarray(g.shape_id))
    w_t = tev._select_weights(sid, torch.float64)
    w_j = jax.vmap(lambda s: jev._select_weights(s, jnp.float64))(g.shape_id)
    for a, b in zip(w_j, w_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _evaluators(kind, **kw):
    if kind == "pmpc":
        base = dict(n_steps=100, dt=DT, control_every=5, warmup_steps=25,
                    N=8, max_iters=4, tol=0.01, use_kernel=False)
        mk = "make_pmpc_batch_evaluator"
    else:
        # Three solves, 15 steps apart, at 3 iterations per AL round keep
        # the port's host-looped solve_batch to a few seconds; tol 0.05
        # freezes lane 1 (44.7 mm from its target at rest) at the first
        # check after warm-up, so its carried V and RLS state are held
        # across two later solves of the whole batch.
        base = dict(n_steps=70, dt=DT, control_every=15, warmup_steps=25,
                    N=8, max_iters=3, tol=0.05, use_kernel=False)
        mk = "make_rmpc_batch_evaluator"
    base.update(kw)
    return getattr(jev, mk)(**base), getattr(tev, mk)(**base)


@pytest.mark.parametrize("kind", ["pmpc", "rmpc"])
def test_batch_evaluator_matches_jax(kind):
    ev_j, ev_t = _evaluators(kind)
    rows = _rows()
    rj = jax.jit(ev_j)(*(jnp.asarray(x) for x in rows))
    rt = ev_t(*(torch.from_numpy(x) for x in rows))
    np.testing.assert_allclose(rt.final_p.numpy(), np.asarray(rj.final_p),
                               rtol=0, atol=ATOL)
    _assert_metrics(rt.metrics, rj.metrics)
    assert rt.contact_lost is None
    if kind == "rmpc":
        frozen = rt.metrics.converged.numpy()
        assert frozen.any() and not frozen.all()
    # The objects moved under control.
    assert (rt.metrics.control_effort.numpy() > 0).all()


def test_run_sweep_batched_matches_direct_call_and_jax():
    """Four rows padded to 8 (repeating a row that never converges): the
    trimmed rows equal the direct call's, and the aggregate equals JAX's
    `run_sweep_batched` on a one-device mesh; tol 0.06 leaves lanes 0-2
    converged at once and lane 3 never."""
    kw = dict(n_steps=40, tol=0.06)
    ev_j, ev_t = _evaluators("pmpc", **kw)
    k, m, mu, t = _rows()
    sid = tto.shape_from_kappa(torch.from_numpy(k)).to(torch.int32)
    batch = tsc.ScenarioBatch(sid, *(torch.from_numpy(x)
                                     for x in (m, mu, k, t)))
    res, agg = tsw.run_sweep_batched(ev_t, batch, lane_multiple=8)
    padded, _ = tsc.pad_to_multiple(batch, 8)
    direct = ev_t(padded.kappa_inv, padded.mass, padded.mu, padded.target_xy)
    for a, b in zip(res.metrics, direct.metrics):
        assert a.shape[0] == 4
        np.testing.assert_array_equal(a.numpy(), b[:4].numpy())
    np.testing.assert_array_equal(res.final_p.numpy(),
                                  direct.final_p[:4].numpy())
    conv = res.metrics.converged.numpy()
    assert conv.tolist() == [True, True, True, False]
    assert float(agg.n) == 4 and float(agg.n_converged) == 3
    sse = res.metrics.steady_state_error.numpy()
    assert float(agg.mean_sse) == pytest.approx(sse.mean(), abs=1e-15)

    jbatch = jsc.ScenarioBatch(*(jnp.asarray(x.numpy()) for x in batch))
    jres, jagg = jsw.run_sweep_batched(ev_j, jbatch, jsw.make_mesh(1),
                                       lane_multiple=8)
    for a, b in zip(agg, jagg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)
    _assert_metrics(res.metrics, jres.metrics)
    assert from_jax(jagg, "cpu")._fields == agg._fields


def test_cli_sweep_json_keys(capsys):
    """The shortest runtime with a solve (warm-up 250 steps, then one
    control step): the JAX CLI's keys, 18 rows, one device."""
    assert tcli.main(["--controller", "rmpc", "--batch_major", "--cpu",
                      "--runtime", "0.51"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"summary", "scenarios"}
    assert set(out["summary"]) == {
        "controller", "n", "success_rate", "mean_sse_mm", "mean_conv_time_s",
        "mean_effort", "devices", "tray_lag"}
    assert out["summary"]["n"] == 18 and out["summary"]["devices"] == 1
    assert len(out["scenarios"]) == 18
    for row in out["scenarios"]:
        assert set(row) == {"object", "mass", "mu", "target", "converged",
                            "sse_mm", "conv_time_s", "effort"}
    assert [r["object"] for r in out["scenarios"]] == \
        [s for s in jto.SHAPES for _ in range(6)]
    assert all(r["effort"] > 0 for r in out["scenarios"])


def test_entry_points_need_the_card_unless_asked(monkeypatch, tmp_path):
    """Without CUDA the entry points raise, or the CLI exits non-zero,
    unless the CPU is asked for (`sweep --controller mppi` among them);
    `bench`, the one command not ported, exits 2, and `watch`, which needs
    no card, tails a ring."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsc.sweep_grid()
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsc.random_scenarios(rng, 4)
    # Nothing was drawn before the raise.
    assert rng.integers(0, 3) == np.random.default_rng(0).integers(0, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tto.init_state()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tto.make_params()
    # The trainers' constructors and draws, before anything is drawn.
    gen = torch.Generator().manual_seed(0)
    ctlr = tmpc.LMPC(N=4, dt=0.01)
    for make in (lambda: ttr.env_init(ctlr, ttr.EnvConfig(), 2, gen=gen),
                 lambda: tlag.env_init(ctlr, tlag.LagEnvConfig(), 2, gen=gen),
                 lambda: ttr.init_train_state(gen, tppo.PPOConfig()),
                 lambda: ttr.init_replay(2, 2),
                 lambda: ttr.draw_step(gen, 2),
                 lambda: tlag.draw_step(gen, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator().manual_seed(0)))
    for argv, needle in (
            (["--controller", "rmpc", "--batch_major"], "no CUDA device"),
            (["--controller", "pmpc", "--batch_major", "--cpu"],
             "supports --controller rmpc"),
            (["--controller", "lmpc", "--cpu", "--checkpoint_dir",
              "/nonexistent"], "no checkpoint"),
            (["--controller", "mppi"], "no CUDA device")):
        with pytest.raises(SystemExit) as e:
            tcli.main(argv)
        assert e.value.code != 0
    # `bench` is the one command the port refuses; `watch` needs no card.
    from dart_tpu_torch.cli.__main__ import main as dispatch
    from dart_tpu_torch.io.streaming import EPISODE_STREAM_DTYPE, TelemetryTap
    assert dispatch(["bench"]) == 2
    ring = str(tmp_path / "ep.ring")
    tap = TelemetryTap(ring, EPISODE_STREAM_DTYPE)
    for k in range(3):
        tap.emit(k=k, px=0.01 * k, py=0.0, ux=0.0, uy=0.0, err=0.05)
    tap.close()
    with redirect_stdout(io.StringIO()) as out:
        assert dispatch(["watch", ring, "--idle_timeout", "0.2",
                         "--fps", "50"]) == 0
    assert "stream idle after 3 records" in out.getvalue()


def _jax_sweep(lag: str, runtime: float) -> dict:
    """JAX's batch-major RMPC sweep on the 18-config grid, on the CPU."""
    batch = jsc.sweep_grid(targets=((0.05, -0.04),), dtype=jnp.float32)
    ev = jev.make_rmpc_batch_evaluator(
        n_steps=int(runtime / DT), dt=DT, control_every=5, warmup_steps=250,
        tol=0.01, use_kernel=False,
        tray_lag=jto.LEGACY_TRAY_LAG if lag == "legacy" else None)
    r = jax.jit(ev)(batch.kappa_inv, batch.mass, batch.mu, batch.target_xy)
    m = r.metrics
    conv = np.asarray(m.converged)
    return {"lag": lag, "runtime": runtime, "n_converged": int(conv.sum()),
            "converged": conv.tolist(),
            "sse_mm": (np.asarray(m.steady_state_error) * 1e3).tolist(),
            "conv_time_s": np.asarray(m.convergence_time).tolist()}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(_jax_sweep(sys.argv[1], float(sys.argv[2]))))
