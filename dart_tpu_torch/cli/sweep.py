"""18-config evaluation sweep over the ranks of a mesh (port of
`dart_tpu.cli.sweep`; the batched equivalent of running `PMPC/launch.sh`
over every world_*.xml variant).

    python -m dart_tpu_torch.cli.sweep --targets 0.05,-0.04 0.08,0.06 \
        --runtime 5
    python -m dart_tpu_torch.cli.sweep --controller rmpc --batch_major
    python -m dart_tpu_torch.cli.sweep --controller lmpc \
        --checkpoint_dir artifacts/lmpc/lagplant_r5

Without `--batch_major` every row is a lane of the per-scenario evaluator
(`--controller pmpc|rmpc|mppi|lmpc`; `mppi` the sampling MPC, 256
rollouts x 2 iterations per solve; `lmpc` with the trained policy in
`--checkpoint_dir/best_agent.pt` tuning its 34 parameters); with it
(`rmpc` only) the grid, padded to 128 lanes, goes through one RMPCBatch
solve per control step. Runs on the card; `--cpu` runs the same on the
CPU, where each kernel's plain PyTorch version stands in for it.

Under `torchrun` the rows shard over the ranks, one rank a card (NCCL),
or over gloo on the CPU with `--cpu`; rank 0 prints the JSON, whose
`devices` is the world size:

    torchrun --standalone --nproc_per_node=2 -m dart_tpu_torch.cli sweep
    torchrun --standalone --nproc_per_node=2 -m dart_tpu_torch.cli sweep \
        --cpu --runtime 0.51
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--targets", nargs="+", default=["0.05,-0.04"],
                   help="comma-separated xy pairs")
    p.add_argument("--runtime", type=float, default=5.0)
    p.add_argument("--tolerance", type=float, default=0.01)
    p.add_argument("--controller", default="pmpc",
                   choices=["pmpc", "rmpc", "mppi", "lmpc"])
    p.add_argument("--checkpoint_dir", default="artifacts/lmpc/general",
                   help="lmpc only: trained policy to tune the 34 params")
    p.add_argument("--batch_major", action="store_true",
                   help="rmpc only: run the whole grid through one "
                        "RMPCBatch solve per control step (the whole-solve "
                        "kernel on the card; padded to 128 lanes)")
    p.add_argument("--tray_lag", default="calibrated",
                   choices=["calibrated", "legacy"],
                   help="tray tracking-lag model: 'calibrated' (default) = "
                        "the MuJoCo-measured response; 'legacy' = the r1/r2 "
                        "(40, 1) lag, kept to reproduce historical artifacts")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    if args.batch_major and args.controller != "rmpc":
        p.error("--batch_major currently supports --controller rmpc")

    import torch.distributed as dist

    from dart_tpu_torch.parallel import mesh as mesh_mod
    from dart_tpu_torch.utils.device import resolve

    try:
        dev = resolve("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        p.error(str(e))
    try:
        mesh_mod.init_distributed(device=dev)
    except ValueError as e:       # torchrun's variables, some but not all
        p.error(str(e))
    try:
        _sweep(p, args, mesh_mod.make_mesh(device=dev))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def _sweep(p, args, mesh):
    """The sweep on this rank of `mesh`; rank 0 prints the JSON."""
    import torch

    from dart_tpu_torch.io import scenes
    from dart_tpu_torch.io.logging import to_jsonable
    from dart_tpu_torch.parallel import sweep as sweep_mod
    from dart_tpu_torch.physics import tray_object as to_mod
    from dart_tpu_torch.rollout import evaluate

    dev = mesh.device
    # None = the evaluators' fully calibrated default (lag + per-shape
    # dissipation + backlash).
    tray_lag = to_mod.LEGACY_TRAY_LAG if args.tray_lag == "legacy" else None
    targets = tuple(tuple(float(x) for x in t.split(",")) for t in args.targets)
    dt = 0.002
    n_steps = int(args.runtime / dt)
    dtype = torch.float64 if args.f64 else torch.float32
    batch = scenes.sweep_grid(targets=targets, dtype=dtype, device=dev)
    kw = dict(n_steps=n_steps, dt=dt, control_every=5, warmup_steps=250,
              tol=args.tolerance, tray_lag=tray_lag)
    if args.batch_major:
        ev = evaluate.make_rmpc_batch_evaluator(**kw)
        res, agg = sweep_mod.run_sweep_batched(ev, batch, mesh)
    elif args.controller == "lmpc":
        # Trained-policy LMPC on the contact plant (`run.py:243-311`).
        from dart_tpu_torch.adapt import lmpc_trainer as trainer
        from dart_tpu_torch.adapt import ppo as ppo_mod
        from dart_tpu_torch.io import checkpoint as ckpt

        restored = ckpt.load_agent(args.checkpoint_dir, "best_agent")
        if restored is None:
            p.error(f"no checkpoint in {args.checkpoint_dir}; train with "
                    "`python -m dart_tpu_torch.cli lmpc --train` first")
        model = ppo_mod.ActorCritic(act_dim=trainer.N_PARAMS,
                                    obs_dim=trainer.OBS_DIM)
        model.load_state_dict(restored["model"])
        # Every parameter in the sweep's type, as JAX casts them.
        model = model.to(dev, dtype)
        ev0 = evaluate.make_lmpc_evaluator(model, **kw)
        act_cfg = ppo_mod.ParamActionConfig()

        def ev(k, m, mu, t):
            # A deterministic per-scenario seed for the parameter-vector
            # init, JAX's formula; the draw is the port's generator's.
            rows = zip(t.cpu().tolist(), mu.cpu().tolist(), m.cpu().tolist())
            init_k = torch.cat([trainer.sample_init_k(
                torch.Generator().manual_seed(
                    round(tx * 1e4) * 7919 + round(ty * 1e4) * 104729
                    + round(mu_i * 1e3) * 31 + round(m_i * 10)),
                1, act_cfg, dtype) for (tx, ty), mu_i, m_i in rows])
            return ev0(k, m, mu, t, init_k.to(dev))

        res, agg = sweep_mod.run_sweep(ev, batch, mesh)
    else:
        maker = {"pmpc": evaluate.make_pmpc_evaluator,
                 "rmpc": evaluate.make_rmpc_evaluator,
                 "mppi": evaluate.make_mppi_evaluator}[args.controller]
        res, agg = sweep_mod.run_sweep(maker(**kw), batch, mesh)

    m = res.metrics
    cols = {k: v.cpu().tolist() for k, v in (
        ("shape_id", batch.shape_id), ("mass", batch.mass), ("mu", batch.mu),
        ("target", batch.target_xy), ("converged", m.converged),
        ("sse", m.steady_state_error), ("conv", m.convergence_time),
        ("effort", m.control_effort))}
    rows = []
    for i in range(batch.size):
        rows.append({
            "object": to_mod.SHAPES[cols["shape_id"][i]],
            "mass": cols["mass"][i],
            "mu": cols["mu"][i],
            "target": cols["target"][i],
            "converged": cols["converged"][i],
            "sse_mm": round(cols["sse"][i] * 1e3, 2),
            "conv_time_s": round(cols["conv"][i], 3),
            "effort": round(cols["effort"][i], 4),
        })
    n = float(agg.n)
    summary = {
        "controller": args.controller,
        "n": int(n),
        "success_rate": float(agg.n_converged) / n,
        "mean_sse_mm": round(float(agg.mean_sse) * 1e3, 3),
        "mean_conv_time_s": round(float(agg.mean_conv_time), 3),
        "mean_effort": round(float(agg.mean_effort), 4),
        "devices": mesh.size,
        "tray_lag": args.tray_lag,
    }
    if mesh.rank == 0:
        print(json.dumps(to_jsonable({"summary": summary,
                                      "scenarios": rows}), indent=1))


if __name__ == "__main__":
    raise SystemExit(main())
