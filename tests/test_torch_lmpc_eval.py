"""Port parity: the trained-policy LMPC evaluator on the contact plant
(`rollout.evaluate.make_lmpc_evaluator`) in both protocols against
`jax.vmap` of `dart_tpu`'s, in float64, with the committed `lagplant_r5`
tuner; and the `lmpc` and `sweep --controller lmpc` commands on `--cpu`.

The policy is the converted `artifacts/lmpc/lagplant_r5/best_agent.pt`
(tests/test_torch_ppo.py holds it to the Orbax checkpoint bit for bit),
handed to flax as its parameter tree. The evaluator runs the four rows of
tests/test_rmpc_batch_eval.py with JAX's per-row `init_k` draws, cut to
a short episode at N=6 and two iterations.

Script mode prints JAX's evaluator on the same rows at `chip_smoke.py`'s
LMPC_EVAL settings (its defaults, N=12 and four iterations, float64):
the reference for the lmpc-eval phase's gates.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_lmpc_eval.py
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# float64 before the JAX package builds its constants, in script mode as
# tests/conftest.py sets it under pytest.
jax.config.update("jax_enable_x64", True)

from dart_tpu.adapt import ppo as jppo  # noqa: E402
from dart_tpu.physics import tray_object as jto  # noqa: E402
from dart_tpu.rollout import evaluate as jev  # noqa: E402
from dart_tpu_torch.adapt import lmpc_trainer as ttr  # noqa: E402
from dart_tpu_torch.adapt import ppo as tppo  # noqa: E402
from dart_tpu_torch.cli.__main__ import main as dispatch  # noqa: E402
from dart_tpu_torch.cli import sweep as tcli_sweep  # noqa: E402
from dart_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from dart_tpu_torch.io.logging import EpisodicNpy  # noqa: E402
from dart_tpu_torch.io.results import (  # noqa: E402
    env_name, parse_env_name)
from dart_tpu_torch.physics import tray_object as tto  # noqa: E402
from dart_tpu_torch.rollout import evaluate as tev  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LAGPLANT = REPO / "artifacts" / "lmpc" / "lagplant_r5"
# The four rows of tests/test_rmpc_batch_eval.py.
KAPPA = [[0.0, 0.0], [2.0, 0.0], [2.5, 2.5], [0.0, 0.0]]
MASS = [1.0, 2.0, 1.0, 2.0]
MU = [0.1, 0.05, 0.2, 0.1]
TARGET = [[0.05, -0.03], [-0.04, 0.02], [0.03, 0.05], [-0.05, -0.05]]
ATOL = 1e-9


def _rows():
    return [np.asarray(x, np.float64) for x in (KAPPA, MASS, MU, TARGET)]


def _policies():
    """The lagplant_r5 tuner as the port's ActorCritic and as flax's
    (params, model)."""
    sd = tckpt.load_agent(str(LAGPLANT))["model"]
    tm = tppo.ActorCritic(ttr.N_PARAMS, ttr.OBS_DIM)
    tm.load_state_dict(sd)
    tree = {}
    for k, v in sd.items():
        if k == "log_std":
            tree[k] = jnp.asarray(v.numpy())
        else:
            layer, kind = k.split(".")
            tree.setdefault(layer, {})[
                "kernel" if kind == "weight" else "bias"] = jnp.asarray(
                    v.numpy().T if kind == "weight" else v.numpy())
    return tm, {"params": tree}, jppo.ActorCritic(act_dim=ttr.N_PARAMS)


def _init_k(seed: int = 0, dtype=jnp.float64):
    """JAX's per-row keys and the init_k its evaluator draws from each."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    cfg = jppo.ParamActionConfig()
    return keys, np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (ttr.N_PARAMS,), dtype, minval=cfg.min_k,
        maxval=cfg.k_max / 2))(keys))


def _lost_past_a_micron_in_y(to_mod):
    """contact_lost, also true once the object has moved 1 um in +y: in
    this short episode only row 2 does, at its seventh control period,
    so the whole-lane freeze runs for its last period."""
    off = to_mod.off_tray

    def lost(s):
        return off(s) | s.toppled | (s.p[..., 1] > 1e-6)
    return lost


@pytest.mark.parametrize("protocol", ["reference", "settled"])
def test_lmpc_evaluator_matches_vmapped_jax(protocol, monkeypatch):
    """Eight control periods of 5 plant steps after a 25-step
    warm-up, the policy solving at every one of them, float64: positions
    and applied controls at every period, the final positions, the
    contact-loss flags and the metrics at 1e-9 (the runs agree to
    ~1e-16). tol 0.05 holds row 1 (44.7 mm from its target) from the
    first warm check: the reference protocol freezes it whole, the
    settled one only its adaptation. In the reference run a contact loss
    1 um into +y freezes row 2 for the last period on both sides."""
    hold = protocol == "settled"
    if not hold:
        for mod in (jto, tto):
            monkeypatch.setattr(mod, "contact_lost",
                                _lost_past_a_micron_in_y(mod))
    tm, params, jm = _policies()
    kw = dict(n_steps=40, control_every=5, warmup_steps=25, N=6, max_iters=2,
              tol=0.05, trace=True, hold_after_convergence=hold)
    keys, init_k = _init_k()
    rows = _rows()
    rj, (ps_j, us_j) = jax.jit(jax.vmap(jev.make_lmpc_evaluator(
        params, jm, **kw)))(*rows, keys)
    rt, (ps_t, us_t) = tev.make_lmpc_evaluator(tm, **kw)(
        *(torch.from_numpy(x) for x in rows), torch.from_numpy(init_k))
    assert ps_t.shape == us_t.shape == (4, 8, 2)
    for a, b in ((ps_t, ps_j), (us_t, us_j), (rt.final_p, rj.final_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)
    assert rt.contact_lost.tolist() == np.asarray(rj.contact_lost).tolist() \
        == [False, False, not hold, False]
    np.testing.assert_array_equal(rt.metrics.converged.numpy(),
                                  np.asarray(rj.metrics.converged))
    for name in ("steady_state_error", "convergence_time", "control_effort",
                 "min_error"):
        np.testing.assert_allclose(getattr(rt.metrics, name).numpy(),
                                   np.asarray(getattr(rj.metrics, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    us = us_t.numpy()
    assert (us[:, :5] == 0).all() and (us[[0, 3], 5:] != 0).all()
    if hold:
        assert (us[1, 5:] != 0).all()
    else:
        # Row 1 holds its first control; row 2 is frozen with none.
        assert (us[1, 5:] == us[1, 5]).all()
        assert (us[2, -1] == 0).all()


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_lmpc_command_trains_and_tests_on_the_cpu(capsys, tmp_path):
    """`lmpc --train` (one update of two envs) writes best and latest;
    `--test` runs general episodes and logs them in the reference's .npy
    schema; `--test --env` runs the committed tuner on the contact plant.
    Each at N=4 and a few control steps."""
    ck = str(tmp_path / "ck")
    small = ["--cpu", "--mpc_horizon", "4", "--envs", "2"]
    assert dispatch(["lmpc", "--train", "--updates", "1", "--rollout_len",
                     "2", "--checkpoint_dir", ck, *small]) == 0
    out = _last_json(capsys)
    assert out["done"] and out["updates"] == 1
    assert np.isfinite(out["reward_last"]) and out["timing"]["n"] == 1
    assert sorted(os.listdir(ck)) == ["best_agent.pt", "latest_agent.pt"]
    log = str(tmp_path / "run")
    assert dispatch(["lmpc", "--test", "--checkpoint_dir", ck,
                     "--eval_episode_steps", "2", "--logdir", log,
                     *small]) == 0
    out = _last_json(capsys)
    assert out["episodes"] == 2 and np.isfinite(out["mean_final_pos_error"])
    ep = EpisodicNpy(f"{log}_test/general.npy")
    assert len(ep.load("pos_error")) == 2
    assert ep.load("state")[0].shape == (1, 2, 8)
    assert dispatch(["lmpc", "--test", "--env", "cube_1x0_0x1",
                     "--checkpoint_dir", str(LAGPLANT),
                     "--eval_episode_steps", "2", *small]) == 0
    out = _last_json(capsys)
    assert out["plant"] == "contact" and out["env"] == "cube_1x0_0x1"
    assert np.isfinite(out["steady_state_error_mm"])
    assert dispatch(["lmpc", "--test", "--checkpoint_dir",
                     str(tmp_path / "none"), "--cpu"]) == 1
    assert "no checkpoint" in _last_json(capsys)["error"]
    assert parse_env_name(env_name("sphere", 0.2, 0.1)) == ("sphere", 0.2,
                                                            0.1)


def test_sweep_lmpc_runs_the_grid_on_the_cpu(capsys, monkeypatch):
    """`sweep --controller lmpc` with the default tuner (the converted
    `general`) over the 18 rows, one control period, each row's init_k
    from JAX's per-row seed; without a card and without --cpu it refuses."""
    assert tcli_sweep.main(["--controller", "lmpc", "--cpu", "--runtime",
                            "0.01"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["summary"]["controller"] == "lmpc"
    assert out["summary"]["n"] == 18 and len(out["scenarios"]) == 18
    assert all(np.isfinite(r["sse_mm"]) for r in out["scenarios"])
    with pytest.raises(SystemExit):
        tcli_sweep.main(["--controller", "lmpc", "--cpu", "--checkpoint_dir",
                         "/nonexistent"])
    assert "no checkpoint" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        dispatch(["lmpc", "--test"])
    assert "no CUDA device" in capsys.readouterr().err


def _jax_eval() -> dict:
    """JAX's evaluator on the four rows with the lagplant_r5 tuner at
    chip_smoke.py's LMPC_EVAL settings, float64, vmapped, with each row's
    init_k: the numbers the lmpc-eval phase holds the card to."""
    import chip_smoke

    _, params, jm = _policies()
    keys, init_k = _init_k()
    rj, (ps, us) = jax.jit(jax.vmap(jev.make_lmpc_evaluator(
        params, jm, **chip_smoke.LMPC_EVAL)))(*_rows(), keys)
    m = rj.metrics
    return {"init_k": init_k.tolist(),
            "ps": np.asarray(ps).tolist(), "us": np.asarray(us).tolist(),
            "final_p": np.asarray(rj.final_p).tolist(),
            "contact_lost": np.asarray(rj.contact_lost).tolist(),
            **{k: np.asarray(getattr(m, k)).tolist() for k in (
                "steady_state_error", "convergence_time", "control_effort",
                "min_error", "converged")}}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(_jax_eval()))
