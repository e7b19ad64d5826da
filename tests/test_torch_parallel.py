"""Port parity: the multi-device layer (`dart_tpu_torch.parallel.mesh`, the
sharded `parallel.sweep`, PPO's group-averaged gradients, the trainers'
`group` and `sweep` under `torchrun`) against `dart_tpu`'s `shard_map`
on the conftest's virtual CPU devices.

The ranks are subprocesses on the CPU over gloo (`tests/_parallel_ranks.py`,
torch and the port only), started once for the module: two from
`init_distributed`'s arguments and three from torchrun's environment
variables, beside one `torchrun --nproc_per_node=2` of the `sweep`
command. The JAX references are computed while they run. float64.
"""

import copy
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _parallel_ranks as W
from dart_tpu.adapt import ppo as jppo
from dart_tpu.io import scenes as jsc
from dart_tpu.parallel import sweep as jsw
from dart_tpu.physics import tray_object as jto
from dart_tpu.rollout import evaluate as jev
from dart_tpu_torch.adapt import lmpc_trainer as ttr
from dart_tpu_torch.adapt import ppo as tppo
from dart_tpu_torch.parallel import mesh as tmesh
from dart_tpu_torch.utils.convert import actor_critic_state_dict

REPO = Path(__file__).resolve().parents[1]
# float64, the same operations in the same order as JAX's shard bodies
# (tests/test_torch_evaluate.py's tolerance for the evaluators, and
# tests/test_torch_ppo.py's for a PPO update on float64 parameters).
ATOL = 1e-9
PPO_TOL = 1e-10
TIMEOUT = 240
WORLDS = (2, 3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               **extra)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        if k not in extra:
            env.pop(k, None)
    return env


def _jax_ppo(world: int):
    """JAX's `ppo_update(axis_name="dp")` under shard_map on `world`
    virtual devices, one epoch of one minibatch a shard, float64
    parameters. Returns (float64 policy, its permutation, a function that
    returns the updated policy)."""
    jm = jppo.ActorCritic(act_dim=ttr.N_PARAMS)
    params = jax.tree.map(lambda x: x.astype(jnp.float64),
                          jm.init(jax.random.PRNGKey(0),
                                  jnp.zeros(ttr.OBS_DIM)))
    cfg = jppo.PPOConfig(epochs=1, minibatch_size=W.PPO_SHARD)
    tx = jppo.make_optimizer(cfg)
    key = jax.random.PRNGKey(7)
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("dp",))
    update = jax.jit(jax.shard_map(
        lambda b: jppo.ppo_update(params, tx.init(params), jm, tx, b, cfg,
                                  key, axis_name="dp")[0],
        mesh=mesh, in_specs=(P("dp"),), out_specs=P(), check_vma=False))
    batch = jppo.Batch(*map(jnp.asarray, W.ppo_batch(world)))
    perms = np.stack([np.asarray(jax.random.permutation(k, W.PPO_SHARD))
                      for k in jax.random.split(key, cfg.epochs)])
    return (actor_critic_state_dict(jax.device_get(params)),
            torch.from_numpy(perms),
            lambda: actor_critic_state_dict(jax.device_get(update(batch))))


def _jax_sweeps() -> dict:
    """JAX's sharded sweeps on the four rows: the batch evaluator at every
    world size, the per-scenario one at 2."""
    k, m, mu, t = (jnp.asarray(x) for x in W.rows())
    sid = jnp.asarray(W.scenario_batch().shape_id.numpy())
    batch = jsc.ScenarioBatch(sid, m, mu, k, t)
    ev = jev.make_pmpc_batch_evaluator(**W.batch_evaluator_kw())
    out = {("batched", n): jsw.run_sweep_batched(
        ev, batch, jsw.make_mesh(n), lane_multiple=W.LANE_MULTIPLE)
        for n in WORLDS}
    out[("scenario", 2)] = jsw.run_sweep(
        jev.make_pmpc_evaluator(**W.scenario_evaluator_kw()), batch,
        jsw.make_mesh(2))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks and the torchrun command, compute JAX's references
    meanwhile, and wait for every process (a nonzero exit fails)."""
    out = tmp_path_factory.mktemp("ranks")
    policy, perms, ppo_update = _jax_ppo(2)
    torch.save({"policy": policy, "perms": perms}, out / "ppo_inputs.pt")
    worker = [sys.executable, str(REPO / "tests" / "_parallel_ranks.py"),
              str(out)]
    procs = []
    addr = f"127.0.0.1:{_free_port()}"
    procs += [subprocess.Popen(worker + [addr, "2", str(r)], env=_env(),
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(2)]
    port = str(_free_port())
    procs += [subprocess.Popen(worker, env=_env(
        MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE="3",
        RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(3)]
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "dart_tpu_torch.cli", "sweep", "--cpu",
         "--runtime", "0.51"], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ppo_want = ppo_update()
        jax_out = _jax_sweeps()
    finally:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
        cli_out, cli_err = cli.communicate(timeout=TIMEOUT)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = {n: [torch.load(out / f"w{n}_r{r}.pt", weights_only=True)
                 for r in range(n)] for n in WORLDS}
    return dict(ranks=ranks, jax=jax_out, ppo_want=ppo_want,
                cli=(cli.returncode, cli_out, cli_err))


def _assert_metrics(t: dict, j):
    """tests/test_torch_evaluate.py's comparison of per-row metrics."""
    np.testing.assert_array_equal(t["converged"].numpy(),
                                  np.asarray(j.converged))
    np.testing.assert_array_equal(t["convergence_time"].numpy() == np.inf,
                                  np.asarray(j.convergence_time) == np.inf)
    for name in ("steady_state_error", "convergence_time", "control_effort",
                 "min_error"):
        np.testing.assert_allclose(t[name].numpy(),
                                   np.asarray(getattr(j, name)), rtol=0,
                                   atol=ATOL, err_msg=name)


def _assert_same_on_every_rank(results: list):
    first = results[0]
    for other in results[1:]:
        for name, x in first["metrics"].items():
            assert torch.equal(x, other["metrics"][name]), name
        assert torch.equal(first["final_p"], other["final_p"])
        for name, x in first["agg"].items():
            assert torch.equal(x, other["agg"][name]), name


def _assert_sweep(results: list, want):
    _assert_same_on_every_rank(results)
    jres, jagg = want
    got = results[0]
    assert got["final_p"].shape[0] == 4
    _assert_metrics(got["metrics"], jres.metrics)
    np.testing.assert_allclose(got["final_p"].numpy(),
                               np.asarray(jres.final_p), rtol=0, atol=ATOL)
    for name, x in got["agg"].items():
        np.testing.assert_allclose(x.numpy(), np.asarray(getattr(jagg, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    assert got["metrics"]["converged"].tolist() == [True, True, True, False]


def test_two_and_three_process_start(runs, monkeypatch):
    """Two ranks from `init_distributed`'s arguments, three from torchrun's
    variables: each sees the whole group and a cross-rank all_reduce of
    rank + 1 sums every rank's. Without either, no group starts; with
    some of torchrun's variables but not all, the start names the
    missing ones."""
    for n in WORLDS:
        for r, got in enumerate(runs["ranks"][n]):
            assert got["started"] is True
            assert (got["rank"], got["size"], got["backend"]) == \
                (r, n, "gloo")
            assert got["sum"] == n * (n + 1) / 2
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.init_distributed(device="cpu") is False
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device.type) == \
        (None, 0, 1, "cpu")
    with pytest.raises(ValueError, match="mesh has 1 ranks"):
        tmesh.make_mesh(2, device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="MASTER_PORT, WORLD_SIZE, RANK"):
        tmesh.init_distributed(device="cpu")
    with pytest.raises(ValueError, match="needs RANK as well"):
        tmesh.init_distributed("127.0.0.1:1", 2, device="cpu")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_batched_sweep_matches_jax(runs, world):
    """`run_sweep_batched` over `world` ranks (the four rows padded to
    4 * world, each rank one evaluator call on its block) against JAX's
    on a `world`-device mesh: every rank returns the same rows and
    aggregate, JAX's to 1e-9."""
    _assert_sweep([r["batched"] for r in runs["ranks"][world]],
                  runs["jax"][("batched", world)])


def test_sharded_per_scenario_sweep_matches_jax(runs):
    """`run_sweep` of the per-scenario evaluator over two ranks (two rows
    a rank) against JAX's vmapped episodes on a two-device mesh."""
    _assert_sweep([r["scenario"] for r in runs["ranks"][2]],
                  runs["jax"][("scenario", 2)])


def test_sweep_collectives_census(runs):
    """The census counts one all_reduce (the five sums, float64) and one
    all_gather (the packed rows) at every world size and episode length:
    the episode body has no collective."""
    for n in WORLDS:
        for got in runs["ranks"][n]:
            for steps in W.CENSUS_STEPS:
                census = got["census"][steps]
                assert {k: c["count"] for k, c in census.items()} == \
                    {"all_reduce": 1, "all_gather": 1}, (n, steps)
                assert census["all_reduce"]["bytes"] == 5 * 8


def test_ppo_update_group_matches_jax_pmean(runs):
    """`ppo_update(group=...)` on two ranks of 32 transitions (OBS_DIM
    520, 34 actions, one epoch, one minibatch a shard, JAX's permutation)
    against JAX's `shard_map` `ppo_update(axis_name="dp")` on two virtual
    devices: each shard normalises its own advantages and returns, the
    gradients are averaged. float64 parameters, 1e-10; the ranks' models
    equal bit for bit."""
    got = [r["ppo"] for r in runs["ranks"][2]]
    for name, want in runs["ppo_want"].items():
        assert torch.equal(got[0][name], got[1][name]), name
        np.testing.assert_allclose(got[0][name].numpy(), want.numpy(),
                                   rtol=0, atol=PPO_TOL, err_msg=name)


def _emulate_train_step(case: str):
    """The port's own sequential emulation of one data-parallel train step
    over two ranks: each rank's step run alone on that rank's draws (from
    `rank_generator` and the rank), its local pass's gradient kept, the
    two averaged and one AdamW step taken from the shared start; with the
    replay buffer, then each rank's global pass on its own buffer at that
    shared model, averaged and stepped again. Returns (the averaged
    gradients, one list a step; the parameters reached)."""
    mod, replay = W.TRAIN_CASES[case]
    local, bufs = [], []
    for r in range(2):
        ts, env, step = W.train_setup(r, case)
        gen = ttr.rank_generator(ts.gen, r)
        draws = ttr.TrainDraws(
            rollout=[mod.draw_step(gen, 1, torch.float64, "cpu")
                     for _ in range(W.TRAIN_ROLLOUT)],
            replay_perms=W.REPLAY_PERMS)
        grads = W.record_grads(ts)
        if replay:
            bufs.append(step(ts, env, W.replay_buffer(r, ts.model),
                             draws)[2])
        else:
            step(ts, env, draws)
        local.append(grads[0])
    shared = W.train_setup(0, case)[0]
    means = []

    def shared_step(grads):
        mean = [(a + b) / 2 for a, b in zip(*grads)]
        for p, g in zip(shared.model.parameters(), mean):
            p.grad = g
        shared.opt.step()
        means.append(mean)

    shared_step(local)
    if replay:
        glob = []
        for buf in bufs:
            # The buffer as the global pass found it: full.
            buf = buf._replace(size=torch.tensor(buf.obs.shape[0],
                                                 dtype=torch.int32))
            model = copy.deepcopy(shared.model)
            cfg = W.TRAIN_PPO[case]
            ts = ttr.TrainState(model, tppo.make_optimizer(model, cfg), None)
            grads = W.record_grads(ts)
            assert tppo.replay_maybe_update(model, ts.opt, buf, cfg,
                                            W.REPLAY_PERMS)[1]
            glob.append(grads[0])
        shared_step(glob)
    return means, shared.model.state_dict()


def _assert_train_step_matches_emulation(runs, case: str):
    threads = torch.get_num_threads()
    # The ranks' one thread: the summation order of the policy's matmuls
    # and of the clip's norm follows the thread count, and a 2-sample
    # shard's advantage normalisation magnifies that round-off to ~1e-6 in
    # the gradient, as Adam's first step (g / (|g| + 1e-8)) does for
    # entries near 1e-8.
    torch.set_num_threads(1)
    try:
        means, params = _emulate_train_step(case)
    finally:
        torch.set_num_threads(threads)
    got = [r["train"][case] for r in runs["ranks"][2]]
    assert len(got[0]["grads"]) == len(got[1]["grads"]) == len(means)
    for step, want in zip(got[0]["grads"], means):
        for g, w in zip(step, want):
            assert float(w.abs().max()) > 0
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=PPO_TOL)
    for name, want in params.items():
        assert torch.equal(got[0]["params"][name], got[1]["params"][name])
        np.testing.assert_allclose(got[0]["params"][name].numpy(),
                                   want.numpy(), rtol=0, atol=PPO_TOL,
                                   err_msg=name)
    assert all(np.isfinite(r["mean_reward"]) for r in got)
    return got


def test_train_step_group_matches_sequential_emulation(runs):
    """`lmpc_trainer.make_train_step(group=...)`, one env a rank and a
    2-step rollout, against the port's own sequential emulation
    (`_emulate_train_step`). The averaged gradient and the parameters to
    1e-10; the ranks' parameters equal bit for bit."""
    got = _assert_train_step_matches_emulation(runs, "lmpc")
    assert [r["global_update"] for r in got] == [None, None]


def test_lag_plant_replay_step_group_matches_sequential_emulation(runs):
    """`lmpc_lagplant.make_train_step(replay=True, group=...)` from a
    buffer one take short of full, so that the local pass, the subsample
    and the global pass (`replay_maybe_update(group=...)`) all run,
    against the same emulation: both passes' averaged gradients and the
    parameters to 1e-10, the ranks' parameters equal bit for bit."""
    got = _assert_train_step_matches_emulation(runs, "lagplant_replay")
    assert [r["global_update"] for r in got] == [1.0, 1.0]


def test_cli_sweep_under_torchrun(runs):
    """`torchrun --standalone --nproc_per_node=2 -m dart_tpu_torch.cli
    sweep --cpu --runtime 0.51`: one JSON on stdout, from rank 0, with
    the one-process command's keys, 18 rows and two devices."""
    rc, stdout, stderr = runs["cli"]
    assert rc == 0, stderr[-3000:]
    out = json.loads(stdout)
    assert set(out) == {"summary", "scenarios"}
    assert set(out["summary"]) == {
        "controller", "n", "success_rate", "mean_sse_mm", "mean_conv_time_s",
        "mean_effort", "devices", "tray_lag"}
    assert out["summary"]["n"] == 18 and out["summary"]["devices"] == 2
    assert len(out["scenarios"]) == 18
    for row in out["scenarios"]:
        assert set(row) == {"object", "mass", "mu", "target", "converged",
                            "sse_mm", "conv_time_s", "effort"}
    assert [r["object"] for r in out["scenarios"]] == \
        [s for s in jto.SHAPES for _ in range(6)]
    assert all(r["effort"] > 0 for r in out["scenarios"])
