"""One rank of the gloo groups of tests/test_torch_parallel.py, and the
setups the test shares with it. Imports torch and the port only.

    python tests/_parallel_ranks.py OUT_DIR ADDR WORLD RANK   # from arguments
    python tests/_parallel_ranks.py OUT_DIR                   # from torchrun's
                                                              # environment

Each rank starts the default group on the CPU, runs what its world size
asks for and writes its results to OUT_DIR/w{WORLD}_r{RANK}.pt.
"""

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from dart_tpu_torch.adapt import lmpc_lagplant as tlag
from dart_tpu_torch.adapt import lmpc_trainer as ttr
from dart_tpu_torch.adapt import ppo as tppo
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.io import scenes as tsc
from dart_tpu_torch.parallel import mesh as tmesh
from dart_tpu_torch.parallel import sweep as tsw
from dart_tpu_torch.physics import tray_object as tto
from dart_tpu_torch.rollout import evaluate as tev

# The four rows of tests/test_rmpc_batch_eval.py, padded to 8 rows at
# world size 2 and to 12 at 3 (lane_multiple 4).
KAPPA = [[0.0, 0.0], [2.0, 0.0], [2.5, 2.5], [0.0, 0.0]]
MASS = [1.0, 2.0, 1.0, 2.0]
MU = [0.1, 0.05, 0.2, 0.1]
TARGET = [[0.05, -0.03], [-0.04, 0.02], [0.03, 0.05], [-0.05, -0.05]]
LANE_MULTIPLE = 4
CENSUS_STEPS = (40, 80)
PPO_SHARD = 32           # transitions a rank
TRAIN_ROLLOUT = 2
# The trainers' data-parallel cases: (module, replay). With one env a rank
# and a 2-step rollout, each PPO pass is one minibatch and one step.
TRAIN_CASES = {"lmpc": (ttr, False), "lagplant_replay": (tlag, True)}
TRAIN_PPO = {
    "lmpc": tppo.PPOConfig(epochs=1, minibatch_size=TRAIN_ROLLOUT),
    # A small first step, so that the global pass's ratios stay inside
    # PPO's clip and its actor gradients are not zero.
    "lagplant_replay": tppo.PPOConfig(epochs=1, lr=1e-6,
                                      minibatch_size=TRAIN_ROLLOUT)}
REPLAY_PERMS = torch.tensor([[1, 0]])   # the global pass's, every rank's


def rows() -> list:
    return [np.asarray(x, np.float64) for x in (KAPPA, MASS, MU, TARGET)]


def scenario_batch() -> tsc.ScenarioBatch:
    k, m, mu, t = (torch.from_numpy(x) for x in rows())
    return tsc.ScenarioBatch(tto.shape_from_kappa(k).to(torch.int32),
                             m, mu, k, t)


def batch_evaluator_kw(n_steps: int = 40) -> dict:
    """tests/test_torch_evaluate.py's PMPC batch evaluator at tol 0.06:
    lanes 0-2 converge, lane 3 never."""
    return dict(n_steps=n_steps, dt=0.002, control_every=5, warmup_steps=25,
                N=8, max_iters=4, tol=0.06, use_kernel=False)


def scenario_evaluator_kw() -> dict:
    """tests/test_torch_scenario_eval.py's per-scenario PMPC evaluator."""
    return dict(n_steps=40, dt=0.002, control_every=15, warmup_steps=25,
                N=8, max_iters=3, tol=0.06)


def ppo_batch(world: int) -> list:
    """`world` shards of PPO_SHARD transitions at the trainer's widths."""
    rng = np.random.default_rng(5)
    T = world * PPO_SHARD
    return [rng.normal(size=(T, ttr.OBS_DIM)),
            rng.normal(size=(T, ttr.N_PARAMS)) * 0.1,
            rng.normal(size=T), rng.normal(size=T), rng.normal(size=T)]


def train_setup(rank: int, case: str = "lmpc",
                group: dist.ProcessGroup | None = None):
    """`__graft_entry__.dryrun_multichip`'s controller and env (the lag
    plant's for "lagplant_replay") with one env a rank and a 2-step
    rollout, in float64 with float64 parameters: the model and the train
    generator from seed 0 on every rank, the env from seed 10 + rank.
    Returns (TrainState, env, the case's train step over `group`)."""
    mod, replay = TRAIN_CASES[case]
    if mod is ttr:
        env_cfg = ttr.EnvConfig(dt=0.02, max_episode_steps=32)
        dt = env_cfg.dt
    else:
        env_cfg = tlag.LagEnvConfig(max_episode_steps=32)
        dt = env_cfg.dt * env_cfg.substeps
    ctlr = tmpc.LMPC(N=4, dt=dt, cfg=tmpc.ilqr.ILQRConfig(
        max_iters=2, al_iters=1, n_alphas=4))
    ppo_cfg = TRAIN_PPO[case]
    ts = ttr.init_train_state(torch.Generator().manual_seed(0), ppo_cfg,
                              "cpu")
    model = ts.model.double()
    ts = ts._replace(opt=tppo.make_optimizer(model, ppo_cfg))
    env = mod.env_init(ctlr, env_cfg, 1, torch.float64, "cpu",
                       gen=torch.Generator().manual_seed(10 + rank))
    step = mod.make_train_step(ctlr, env_cfg, ppo_cfg, TRAIN_ROLLOUT,
                               replay=replay, group=group)
    return ts, env, step


def replay_buffer(rank: int, model: tppo.ActorCritic) -> tppo.ReplayBuffer:
    """A rank's replay buffer of one rollout's samples, one take short of
    full: the step's subsample fills it and the global pass runs. The
    log-probabilities are `model`'s."""
    rng = np.random.default_rng(20 + rank)
    C = TRAIN_ROLLOUT

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape))

    obs, actions = normal(C, ttr.OBS_DIM), normal(C, ttr.N_PARAMS) * 0.1
    with torch.no_grad():
        mean, std, _ = model(obs)
    return tppo.ReplayBuffer(
        obs=obs, actions=actions, logps=tppo.normal_logp(actions, mean, std),
        rewards=normal(C), values=normal(C),
        dones=torch.from_numpy((rng.uniform(size=C) < 0.3) * 1.0),
        size=torch.tensor(C - tppo.replay_take(C), dtype=torch.int32))


def record_grads(ts) -> list:
    """Keep a copy of the model's gradients at each of the optimizer's
    steps: a list, one list of tensors a step."""
    steps = []
    ts.opt.register_step_pre_hook(lambda *_: steps.append(
        [p.grad.clone() for p in ts.model.parameters()]))
    return steps


def result_dict(res, agg) -> dict:
    return {"metrics": res.metrics._asdict(), "final_p": res.final_p,
            "agg": agg._asdict()}


def main(argv: list) -> None:
    torch.set_num_threads(1)
    out = Path(argv[0])
    if len(argv) > 1:
        started = tmesh.init_distributed(argv[1], int(argv[2]),
                                         int(argv[3]), device="cpu")
    else:
        started = tmesh.init_distributed(device="cpu")
    mesh = tmesh.make_mesh(device="cpu")
    x = torch.tensor([mesh.rank + 1.0], dtype=torch.float64)
    dist.all_reduce(x, group=mesh.group)
    res = {"started": started, "rank": mesh.rank, "size": mesh.size,
           "backend": dist.get_backend(mesh.group), "sum": float(x)}

    batch = scenario_batch()
    ev = tev.make_pmpc_batch_evaluator(**batch_evaluator_kw())
    res["batched"] = result_dict(*tsw.run_sweep_batched(
        ev, batch, mesh, lane_multiple=LANE_MULTIPLE))
    res["census"] = {n: tsw.sweep_collectives(
        tev.make_pmpc_batch_evaluator(**batch_evaluator_kw(n)), batch, mesh,
        LANE_MULTIPLE) for n in CENSUS_STEPS}
    if mesh.size == 2:
        res["scenario"] = result_dict(*tsw.run_sweep(
            tev.make_pmpc_evaluator(**scenario_evaluator_kw()), batch, mesh))

        inputs = torch.load(out / "ppo_inputs.pt", weights_only=True)
        model = tppo.ActorCritic(ttr.N_PARAMS, ttr.OBS_DIM).double()
        model.load_state_dict(inputs["policy"])
        cfg = tppo.PPOConfig(epochs=1, minibatch_size=PPO_SHARD)
        shard = slice(mesh.rank * PPO_SHARD, (mesh.rank + 1) * PPO_SHARD)
        b = tppo.Batch(*(torch.from_numpy(x[shard])
                         for x in ppo_batch(mesh.size)))
        tppo.ppo_update(model, tppo.make_optimizer(model, cfg), b, cfg,
                        inputs["perms"], group=mesh.group)
        res["ppo"] = model.state_dict()

        res["train"] = {}
        for case, (_, replay) in TRAIN_CASES.items():
            ts, env, step = train_setup(mesh.rank, case, mesh.group)
            grads = record_grads(ts)
            if replay:
                stats = step(ts, env, replay_buffer(mesh.rank, ts.model),
                             ttr.TrainDraws(replay_perms=REPLAY_PERMS))[3]
            else:
                stats = step(ts, env)[2]
            res["train"][case] = {
                "params": ts.model.state_dict(), "grads": grads,
                "mean_reward": float(stats["mean_reward"]),
                "global_update": stats.get("global_update")}
    torch.save(res, out / f"w{mesh.size}_r{mesh.rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
