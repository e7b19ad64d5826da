"""LMPC train/eval command, the `LMPC/src/run.py` equivalent (port of
`dart_tpu.cli.lmpc`).

    python -m dart_tpu_torch.cli lmpc --train --updates 20 --envs 8 \
        --checkpoint_dir checkpoints/general
    python -m dart_tpu_torch.cli lmpc --test --checkpoint_dir \
        artifacts/lmpc/general
    python -m dart_tpu_torch.cli lmpc --test --env cube_1x0_0x1 \
        --checkpoint_dir artifacts/lmpc/lagplant_r5

Training runs MPC-in-the-loop PPO with the envs as the lanes of one
`LMPC.solve` per control step (domain randomisation over the plant's 34
physical parameters replaces the MjSpec recompile of `run.py:204-241`),
and keeps `best_agent.pt` / `latest_agent.pt` in `--checkpoint_dir`.
`--test` loads `best_agent.pt` and runs deterministic episodes on the
analytic plant, or with `--env` one episode on the contact plant. Runs on
the card in float32; `--cpu` runs the same on the CPU.
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--updates", type=int, default=10,
                   help="number of PPO train steps (train mode)")
    p.add_argument("--envs", type=int, default=8)
    p.add_argument("--rollout_len", type=int, default=128)
    p.add_argument("--mpc_horizon", type=int, default=12)
    p.add_argument("--checkpoint_dir", default="checkpoints/general")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_episode_steps", type=int, default=2000)
    p.add_argument("--logdir", default="")
    p.add_argument("--env", default="general",
                   help="eval world: 'general' = randomized analytic-plant "
                        "episodes, or a named 18-grid config like "
                        "'cube_1x0_0x1' (`run.py:30-34` world_{env} "
                        "selection) evaluated on the contact plant")
    p.add_argument("--target", nargs=2, type=float, default=[0.10, 0.05],
                   help="per-env eval target (tray-frame xy)")
    p.add_argument("--tag", default="", help="log path tag (`run.py:21`)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    if args.train and args.test:
        p.error("choose either --train or --test")
    training = args.train or not args.test

    import numpy as np
    import torch

    from dart_tpu_torch.adapt import lmpc_trainer as trainer
    from dart_tpu_torch.adapt import ppo as ppo_mod
    from dart_tpu_torch.control import mpc as mpc_mod
    from dart_tpu_torch.io import checkpoint as ckpt
    from dart_tpu_torch.utils.device import resolve
    from dart_tpu_torch.utils.timing import Stopwatch

    try:
        dev = resolve("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        p.error(str(e))
    dtype = torch.float32
    ctlr = mpc_mod.LMPC(N=args.mpc_horizon, dt=0.01,
                        cfg=mpc_mod.ilqr.ILQRConfig(max_iters=4))
    env_cfg = trainer.EnvConfig(dt=0.01, max_episode_steps=1024)
    ppo_cfg = ppo_mod.PPOConfig(epochs=4, minibatch_size=64)
    ts = trainer.init_train_state(torch.Generator().manual_seed(args.seed),
                                  ppo_cfg, dev)

    if training:
        env_states = trainer.env_init(
            ctlr, env_cfg, args.envs, dtype, dev,
            gen=torch.Generator().manual_seed(args.seed + 1))
        train_step = trainer.make_train_step(ctlr, env_cfg, ppo_cfg,
                                             args.rollout_len)
        mgr = ckpt.CheckpointManager(args.checkpoint_dir)
        watch = Stopwatch()
        history = []
        for step in range(args.updates):
            with watch.measure("train_step"):
                ts, env_states, stats = train_step(ts, env_states)
            rew = float(stats["mean_reward"])
            history.append(rew)
            mgr.on_episode_end(ts.model, ts.opt, step, rew)
            print(json.dumps({
                "update": step, "mean_reward": round(rew, 3),
                "policy_loss": round(float(stats["policy_loss"]), 4),
                "value_loss": round(float(stats["value_loss"]), 4)}))
        print(json.dumps({"done": True, "updates": args.updates,
                          "reward_first": round(history[0], 3),
                          "reward_last": round(history[-1], 3),
                          "timing": watch.summary()["train_step"]}))
        return 0

    # --- eval: load the best policy, run episodes with deterministic actions
    restored = ckpt.load_agent(args.checkpoint_dir, "best_agent")
    if restored is None:
        print(json.dumps({"error": "no checkpoint found; run --train "
                          "first (reference falls back to training, "
                          "rlmpc2.py:574)"}))
        return 1
    model = ts.model
    model.load_state_dict(restored["model"])

    if args.env != "general":
        # Per-env eval on the CONTACT plant, named like the reference's
        # world_{env}.xml selection (`run.py:30-34`): cube_1x0_0x1 etc.
        from dart_tpu_torch.io.results import env_name, parse_env_name
        from dart_tpu_torch.physics.tray_object import _KAPPA_INV
        from dart_tpu_torch.rollout.evaluate import make_lmpc_evaluator

        obj, mass, mu = parse_env_name(args.env)
        # --eval_episode_steps counts CONTROL steps (10 ms), like the
        # general eval path; the contact-plant evaluator's n_steps counts
        # 2 ms plant steps, so convert (control_every = 5).
        evaluate = make_lmpc_evaluator(
            model, n_steps=args.eval_episode_steps * 5, N=args.mpc_horizon,
            control_every=5, trace=True)

        def lane(x):
            return torch.tensor([x], dtype=dtype, device=dev)

        init_k = trainer.sample_init_k(
            torch.Generator().manual_seed(args.seed + 3), 1,
            env_cfg.act_cfg, dtype).to(dev)
        results, (ps, us) = evaluate(lane(_KAPPA_INV[obj]), lane(mass),
                                     lane(mu), lane(args.target), init_k)
        ps, us = ps[0].cpu().numpy(), us[0].cpu().numpy()
        pos_err = np.linalg.norm(ps - np.asarray(args.target), axis=-1)
        if args.logdir:
            from dart_tpu_torch.io.logging import EpisodicNpy
            # reference log path schema: {tag}_test/{env}.npy
            # (`results.py:22`)
            tag = args.tag or args.logdir
            store = EpisodicNpy(f"{tag}_test/{env_name(obj, mass, mu)}.npy")
            store.log("pos_error", pos_err)
            store.log("u_cmd", us)
            store.log("timestep", np.arange(len(pos_err)) * 0.01)
            store.save()
        m = results.metrics
        print(json.dumps({
            "env": args.env, "plant": "contact",
            "target": list(args.target),
            "converged": bool(m.converged[0]),
            "steady_state_error_mm": round(
                float(m.steady_state_error[0]) * 1e3, 3),
            "convergence_time_s": float(m.convergence_time[0]),
            "control_effort": round(float(m.control_effort[0]), 4),
        }))
        return 0

    env_states = trainer.env_init(
        ctlr, env_cfg, args.envs, dtype, dev,
        gen=torch.Generator().manual_seed(args.seed + 2))
    _, logs = trainer.eval_rollout(model, ctlr, env_states, env_cfg,
                                   args.eval_episode_steps)
    logs = {k: v.cpu().numpy() for k, v in logs.items()}
    pos_err = logs["pos_error"]   # (envs, T)
    # Episodic log in the reference's .npy schema (`analyitics.py`).
    if args.logdir:
        from dart_tpu_torch.io.logging import EpisodicNpy
        store = EpisodicNpy(f"{args.logdir}_test/general.npy")
        for e in range(args.envs):
            store.log("pos_error", pos_err[e])
            store.log("u_cmd", logs["u_cmd"][e])
            store.log("timestep", np.arange(pos_err.shape[1]) * env_cfg.dt)
            store.log("state", logs["state"][e])
            store.save()
    print(json.dumps({
        "episodes": args.envs,
        "mean_final_pos_error": round(float(pos_err[:, -1].mean()), 5),
        "min_pos_error": round(float(pos_err.min()), 5),
        "success_rate_1cm": round(float((pos_err[:, -1] < 0.01).mean()), 3),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
