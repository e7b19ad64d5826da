"""RMPC adaptive-MPC driver — the `RMPC/dev_dual/rob_ctrl.py` equivalent
(port of `dart_tpu.cli.rmpc`).

    python -m dart_tpu_torch.cli rmpc --object sphere --mass 1 --mu 0.1 \
        --tx 0.05 --ty -0.04 --save logs/rmpc

Runs one episode of the per-scenario RMPC evaluator against the
contact-plant oracle on the card (`--cpu`: on the CPU), a warm call and
then 3 timed ones as the JAX command does, and prints one JSON line of
metrics; `--save` also writes the episode JSON log.
"""

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--object", default="cube",
                   choices=["cube", "cylinder", "sphere"])
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--mu", type=float, default=0.1)
    p.add_argument("--tx", type=float, default=0.05)
    p.add_argument("--ty", type=float, default=-0.04)
    p.add_argument("--runtime", type=float, default=6.0)
    p.add_argument("--save", default=None,
                   help="directory for the episode JSON log")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dart_tpu_torch.io.logging import (episode_json_name,
                                           save_episodes_json, to_jsonable)
    from dart_tpu_torch.physics.tray_object import _KAPPA_INV
    from dart_tpu_torch.rollout.evaluate import make_rmpc_evaluator
    from dart_tpu_torch.utils.device import resolve
    from dart_tpu_torch.utils.timing import timed_call

    try:
        dev = resolve("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        p.error(str(e))
    dtype = torch.float64 if args.f64 else torch.float32
    dt = 0.002
    n_steps = int(args.runtime / dt)
    ev = make_rmpc_evaluator(n_steps=n_steps, dt=dt, control_every=5,
                             warmup_steps=250, trace=args.save is not None)

    def lane(x):
        return torch.tensor([x], dtype=dtype, device=dev)

    out, compile_s, run_s = timed_call(
        ev, lane(_KAPPA_INV[args.object]), lane(args.mass), lane(args.mu),
        lane([args.tx, args.ty]))
    res = out[0] if args.save is not None else out
    m = res.metrics
    result = {
        "steady_state_error": float(m.steady_state_error[0]),
        "convergence_time": float(m.convergence_time[0]),
        "control_effort": float(m.control_effort[0]),
        "converged": bool(m.converged[0]),
        "compile_s": round(compile_s, 2),
        "run_s": round(run_s, 3),
    }
    if args.save is not None:
        ps, us, thetas = (x[0].cpu().numpy() for x in out[1])
        err = np.linalg.norm(ps - np.array([args.tx, args.ty]), axis=1)
        episode = {
            "pos_err": err,
            "pos_err_norm": err / max(np.hypot(args.tx, args.ty), 1e-9),
            "u_cmd": us,
            "timestep": np.arange(len(us)) * dt,
            "theta_hat_final": thetas[-1],
        }
        name = episode_json_name(args.object, args.mass,
                                 (args.mu, args.mu, 0.01 * args.mu),
                                 (args.tx, args.ty))
        path = os.path.join(args.save, name)
        save_episodes_json(path, [episode])
        result["log_path"] = path
    print(json.dumps(to_jsonable(result)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
