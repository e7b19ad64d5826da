"""Port parity: the per-scenario evaluators on the contact plant
(`rollout.evaluate.make_pmpc_evaluator`, `make_rmpc_evaluator`), the
one-device per-scenario sweep (`parallel.sweep.run_sweep`) and the
`pmpc`, `rmpc`, `sweep` and `demo` commands, against `dart_tpu`'s
evaluators vmapped over the rows, in float64.

Script mode prints JAX's own `pmpc` and `rmpc` commands and its
per-scenario sweep on the CPU, float32, at `chip_smoke.py`'s runtimes: the
reference for its pmpc-cli, rmpc-cli and sweep-instance gates.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_scenario_eval.py
"""

import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.rollout import evaluate as jev
from dart_tpu_torch.cli import pmpc as tcli_pmpc
from dart_tpu_torch.cli import rmpc as tcli_rmpc
from dart_tpu_torch.cli import sweep as tcli_sweep
from dart_tpu_torch.cli.__main__ import main as dispatch
from dart_tpu_torch.io import logging as tlog
from dart_tpu_torch.io import scenes as tsc
from dart_tpu_torch.io.config import PRESETS
from dart_tpu_torch.parallel import sweep as tsw
from dart_tpu_torch.physics import tray_object as tto
from dart_tpu_torch.rollout import evaluate as tev
from dart_tpu_torch.utils import timing

# The four rows of tests/test_rmpc_batch_eval.py.
KAPPA = [[0.0, 0.0], [2.0, 0.0], [2.5, 2.5], [0.0, 0.0]]
MASS = [1.0, 2.0, 1.0, 2.0]
MU = [0.1, 0.05, 0.2, 0.1]
TARGET = [[0.05, -0.03], [-0.04, 0.02], [0.03, 0.05], [-0.05, -0.05]]
SIM_DT = 0.002
ATOL = 1e-9


def _rows():
    return [np.asarray(x, np.float64) for x in (KAPPA, MASS, MU, TARGET)]


def _evaluators(kind, **kw):
    """JAX's and the port's per-scenario evaluator: two solves 15 steps
    apart after 25 steps of rest, at N=8 and 3 iterations (a round)."""
    base = dict(n_steps=45, dt=SIM_DT, control_every=15, warmup_steps=25,
                N=8, max_iters=3, tol=0.01)
    base.update(kw)
    mk = f"make_{kind}_evaluator"
    return getattr(jev, mk)(**base), getattr(tev, mk)(**base)


def _assert_metrics(t, j, atol):
    np.testing.assert_array_equal(t.converged.numpy(), np.asarray(j.converged))
    for name in ("steady_state_error", "convergence_time", "control_effort",
                 "min_error"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("kind", ["pmpc", "rmpc"])
def test_scenario_evaluator_matches_vmapped_jax(kind):
    """The per-scenario evaluator on the four rows against `jax.vmap` of
    JAX's, each lane an episode on the contact plant with two solves.
    float64, the same operations in the same order: the episodes agree to
    ~1e-17 in the runs; 1e-9 leaves a margin for the plant's friction
    chatter (tests/test_torch_tray_object.py). RMPC: tol 0.05 freezes lane
    1 at the first check after the warm-up, so its carry and plant state
    are held across the later solve; with `trace` the episode also
    returns its positions, controls and RLS estimates per lane."""
    tol = 0.05 if kind == "rmpc" else 0.01
    trace = kind == "rmpc"
    ev_j, ev_t = _evaluators(kind, tol=tol,
                             **({"trace": True} if trace else {}))
    rows = _rows()
    rj = jax.jit(jax.vmap(ev_j))(*(jnp.asarray(x) for x in rows))
    rt = ev_t(*(torch.from_numpy(x) for x in rows))
    if trace:
        (rj, (ps_j, us_j, th_j)), (rt, (ps_t, us_t, th_t)) = rj, rt
        assert ps_t.shape == (4, 45, 2) and th_t.shape == (4, 45, 14)
        for a, b in ((ps_t, ps_j), (us_t, us_j), (th_t, th_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=ATOL)
        frozen = rt.metrics.converged.numpy()
        assert frozen.any() and not frozen.all()
        # A frozen lane's controls and estimates stay as they were.
        k = int(np.argmax(frozen))
        assert (th_t.numpy()[k, -1] == th_t.numpy()[k, 30]).all()
    np.testing.assert_allclose(rt.final_p.numpy(), np.asarray(rj.final_p),
                               rtol=0, atol=ATOL)
    _assert_metrics(rt.metrics, rj.metrics, atol=ATOL)
    assert (rt.metrics.control_effort.numpy() > 0).all()


def test_rmpc_evaluator_skips_control_steps_when_every_lane_is_frozen(
        monkeypatch):
    """With tol 0.08 every row is within tolerance of its target from rest
    (44.7-70.7 mm), so every lane freezes at the first check after the
    warm-up: the per-scenario evaluator then skips the two later solves
    (JAX's `cond` does), and the episode equals the one that solves them
    and keeps the frozen lanes' carry."""
    kw = dict(n_steps=60, dt=SIM_DT, control_every=15, warmup_steps=25,
              tol=0.08, tray_lag=None)
    ctlr = tev.mpc_mod.RMPC(N=8, dt=SIM_DT, cfg=tev.ilqr.ILQRConfig(
        max_iters=2, al_iters=1))
    calls = []

    def counted(*a):
        calls.append(1)
        return ctlr.solve(*a)

    rows = [torch.from_numpy(x) for x in _rows()]
    runs = [tev._rmpc_episodes(ctlr, counted, skip_frozen=skip, **kw)(*rows)
            for skip in (True, False)]
    assert len(calls) == 1 + 3
    assert bool(runs[0].metrics.converged.all())
    assert torch.equal(runs[0].final_p, runs[1].final_p)
    for a, b in zip(runs[0].metrics, runs[1].metrics):
        assert torch.equal(a, b)


def test_run_sweep_matches_direct_call_and_jax_aggregate():
    """`run_sweep` runs the rows as lanes of one per-scenario evaluator
    call, unpadded: the rows equal the direct call's, and the aggregate is
    JAX's shard_map formula over them."""
    _, ev_t = _evaluators("pmpc", n_steps=40, tol=0.06)
    k, m, mu, t = _rows()
    sid = tto.shape_from_kappa(torch.from_numpy(k)).to(torch.int32)
    batch = tsc.ScenarioBatch(sid, *(torch.from_numpy(x)
                                     for x in (m, mu, k, t)))
    res, agg = tsw.run_sweep(ev_t, batch)
    direct = ev_t(*(torch.from_numpy(x) for x in (k, m, mu, t)))
    for a, b in zip(res.metrics, direct.metrics):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    conv = res.metrics.converged.numpy()
    assert conv.any() and not conv.all()
    sse = res.metrics.steady_state_error.numpy()
    ct = res.metrics.convergence_time.numpy()
    assert float(agg.n) == 4 and float(agg.n_converged) == conv.sum()
    assert float(agg.mean_sse) == pytest.approx(sse.mean(), abs=1e-15)
    assert float(agg.mean_conv_time) == pytest.approx(
        ct[conv].sum() / conv.sum(), abs=1e-15)
    assert float(agg.mean_effort) == pytest.approx(
        res.metrics.control_effort.numpy().mean(), abs=1e-15)


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


PMPC_KEYS = {"steady_state_error", "convergence_time", "control_effort",
             "converged", "compile_s", "run_s"}


def test_timed_call_runs_a_warm_call_then_reps():
    calls = []
    out, first_s, per_s = timing.timed_call(lambda x: calls.append(x) or x,
                                            7, reps=3)
    assert out == 7 and calls == [7] * 4
    assert first_s >= 0 and per_s >= 0


def test_commands_print_their_json(capsys, tmp_path, monkeypatch):
    """`pmpc`, `rmpc --save` and the default `sweep` with --cpu at the
    shortest runtime with a solve (250 steps of rest, then one control
    step): JAX's keys, and the episode JSON the RMPC command writes. Each
    command runs one episode here (`timed_call` without its 3 timed
    repeats, which run the same episode again)."""
    monkeypatch.setattr(timing, "timed_call",
                        lambda fn, *a: (fn(*a), 0.0, 0.0))
    assert dispatch(["pmpc", "--cpu", "--runtime", "0.51"]) == 0
    out = _json(capsys)
    assert set(out) == PMPC_KEYS | {"sim_steps"} and out["sim_steps"] == 255
    assert out["control_effort"] > 0
    assert dispatch(["rmpc", "--cpu", "--runtime", "0.51", "--save",
                     str(tmp_path)]) == 0
    out = _json(capsys)
    assert set(out) == PMPC_KEYS | {"log_path"}
    name = tlog.episode_json_name("cube", 1.0, (0.1, 0.1, 0.001),
                                  (0.05, -0.04))
    assert out["log_path"] == os.path.join(str(tmp_path), name)
    (ep,) = tlog.load_episodes_json(out["log_path"])
    assert set(ep) == {"pos_err", "pos_err_norm", "u_cmd", "timestep",
                       "theta_hat_final"}
    assert len(ep["pos_err"]) == len(ep["u_cmd"]) == 255
    assert len(ep["theta_hat_final"]) == 14
    assert ep["timestep"][1] == pytest.approx(SIM_DT)
    assert tcli_sweep.main(["--cpu", "--runtime", "0.51"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["summary"]["controller"] == "pmpc"
    assert out["summary"]["n"] == 18 and len(out["scenarios"]) == 18
    assert all(r["effort"] > 0 for r in out["scenarios"])


def test_demo_runs_the_three_presets(monkeypatch):
    calls = []
    monkeypatch.setattr(tcli_pmpc, "main",
                        lambda argv: calls.append(argv) or 0)
    with redirect_stdout(io.StringIO()):
        assert dispatch(["demo", "--cpu"]) == 0
    assert len(calls) == 3
    for argv, name in zip(calls, ("cube_precise", "cylinder_fast",
                                  "sphere_gentle")):
        c = PRESETS[name]
        assert argv == ["--target", str(c.target[0]), str(c.target[1]),
                        "--object_name", c.object_name, "--mass",
                        str(c.mass), "--friction", str(c.friction),
                        "--runtime", "5", "--tolerance", str(c.tolerance),
                        "--cpu"]


def test_commands_need_the_card_unless_asked(monkeypatch, capsys):
    """Without CUDA each command exits non-zero and says so, unless the
    CPU is asked for, `pmpc --stream` and `--video` and `sweep --controller
    mppi` among them; `pmpc --video` without --full_stack is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((tcli_pmpc.main, []), (tcli_rmpc.main, []),
                       (tcli_sweep.main, []),
                       (tcli_sweep.main, ["--controller", "rmpc"]),
                       (tcli_pmpc.main, ["--full_stack"])):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--runtime", "0.51"])
        assert e.value.code != 0
        assert "no CUDA device" in capsys.readouterr().err
    # The options ported since run on the card or on --cpu alone
    # (tests/test_torch_telemetry.py and tests/test_torch_video.py run them
    # on --cpu); --video still needs --full_stack, as in JAX.
    for main, argv in ((tcli_pmpc.main, ["--full_stack", "--video", "x.mp4"]),
                       (tcli_pmpc.main, ["--stream", "ring"]),
                       (tcli_sweep.main, ["--controller", "mppi"])):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--runtime", "0.51"])
        assert e.value.code != 0
        assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tcli_pmpc.main(["--video", "x.mp4", "--cpu"])
    assert "requires --full_stack" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        dispatch(["lmpc"])
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def _jax_commands() -> dict:
    """JAX's own pmpc and rmpc commands (with the RMPC command's controls
    from its first solve on) and its per-scenario sweep on the CPU,
    float32, at `chip_smoke.py`'s runtimes."""
    import chip_smoke
    from dart_tpu.cli import pmpc as jp
    from dart_tpu.cli import rmpc as jr
    from dart_tpu.cli import sweep as js

    import tempfile

    from dart_tpu.io.logging import load_episodes_json

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, main, extra in (("pmpc", jp.main, ["--cpu"]),
                                  ("rmpc", jr.main, ["--save", tmp])):
            buf = io.StringIO()
            with redirect_stdout(buf):
                main(extra + ["--runtime",
                              str(chip_smoke.CLI_RUNTIME[name])])
            r = json.loads(buf.getvalue().strip().splitlines()[-1])
            out[name] = {k: r[k] for k in ("converged", "convergence_time",
                                           "steady_state_error",
                                           "control_effort")}
        # The RMPC command's controls from its first solve on.
        (ep,) = load_episodes_json(r["log_path"])
        out["rmpc"]["u_cmd"] = [list(map(float, u))
                                for u in ep["u_cmd"][250:]]
    buf = io.StringIO()
    with redirect_stdout(buf):
        js.main(["--cpu", "--runtime",
                 str(chip_smoke.SWEEP_INSTANCE_RUNTIME)])
    rows = json.loads(buf.getvalue())["scenarios"]
    out["sweep_instance"] = {
        "runtime": chip_smoke.SWEEP_INSTANCE_RUNTIME,
        "n_converged": sum(r["converged"] for r in rows),
        "sse_mm": [r["sse_mm"] for r in rows],
        "effort": [r["effort"] for r in rows]}
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(_jax_commands()))
