"""PMPC experiment driver — the `PMPC/main_parallel_enhanced.py` equivalent
(port of `dart_tpu.cli.pmpc`).

    python -m dart_tpu_torch.cli pmpc --target 0.05 -0.04 \
        --object_name cube --mass 1.0 --friction 0.1 --runtime 6 \
        --tolerance 0.01 [--stream RING_PATH]
        [--full_stack [--no_tune] [--log_dir DIR] [--video MP4_PATH]]

Runs one episode of the per-scenario PMPC evaluator against the
contact-plant oracle, or with --full_stack of `PMPC(N=15)` in the
dual-arm world (impedance QPs, chain dynamics, rigid-grasp tray, contact
object), on the card (`--cpu`: on the CPU), and prints one JSON line of
metrics. Like the JAX command it runs the episode four times (a warm
call, then 3 timed ones); `compile_s` is the first call's seconds.
--stream runs the episode once, each step's record going into the
telemetry ring at RING_PATH (read it live with `watch`), and adds the
ring's counts to the JSON line. With --full_stack, --no_tune takes the
general weights in place of the object's, --log_dir writes the
reference's 17-channel npz log (its t, X and U_cmd channels and the
metrics), and --video renders the episode's arms, tray and object to a
video (the first container the writer chain can write); without
--full_stack the first two are ignored and --video refused, as in the JAX
command.
"""

import argparse
import json
import time


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--target", type=float, nargs=2, default=[0.05, -0.04])
    p.add_argument("--object_name", default="cube",
                   choices=["cube", "cylinder", "sphere"])
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--friction", type=float, default=0.1)
    p.add_argument("--runtime", type=float, default=6.0)
    p.add_argument("--tolerance", type=float, default=0.01)
    p.add_argument("--no_tune", action="store_true",
                   help="with --full_stack: the general weights instead of "
                        "the per-object tuning")
    p.add_argument("--full_stack", action="store_true",
                   help="run the dual-arm physics world instead of the "
                        "tray-lag plant")
    p.add_argument("--log_dir", default=None,
                   help="with --full_stack: write the episode's npz log "
                        "under this directory")
    p.add_argument("--video", default=None, metavar="MP4_PATH",
                   help="with --full_stack: render the episode's arms, tray "
                        "and object to a video")
    p.add_argument("--stream", default=None, metavar="RING_PATH",
                   help="stream each step's record through the native "
                        "telemetry ring (io.streaming.TelemetryTap); read "
                        "it with `watch` or io.ringlog.RingLogger.read")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.video and not args.full_stack:
        p.error("--video requires --full_stack (the plant-only path has no "
                "arms to render)")

    import torch

    from dart_tpu_torch.io.logging import to_jsonable
    from dart_tpu_torch.physics.tray_object import _KAPPA_INV
    from dart_tpu_torch.rollout.evaluate import make_pmpc_evaluator
    from dart_tpu_torch.utils.device import resolve
    from dart_tpu_torch.utils.timing import timed_call

    try:
        dev = resolve("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        p.error(str(e))
    dtype = torch.float64 if args.f64 else torch.float32
    dt = 0.002
    n_steps = int(args.runtime / dt)
    if args.full_stack:
        return _full_stack(args, dev, dtype, dt, n_steps)
    tap = None
    if args.stream:
        from dart_tpu_torch.io.streaming import (EPISODE_STREAM_DTYPE,
                                                 TelemetryTap)
        tap = TelemetryTap(args.stream, EPISODE_STREAM_DTYPE,
                           capacity_records=1 << 16)
    ev = make_pmpc_evaluator(n_steps=n_steps, dt=dt, control_every=5,
                             warmup_steps=250, tol=args.tolerance, tap=tap)

    def lane(x):
        return torch.tensor([x], dtype=dtype, device=dev)

    kinv = lane(_KAPPA_INV[args.object_name])
    inputs = (kinv, lane(args.mass), lane(args.friction), lane(args.target))
    if tap is not None:
        # One episode: timed_call's repeats would stream it four times.
        t0 = time.perf_counter()
        res = ev(*inputs)
        compile_s, run_s = time.perf_counter() - t0, float("nan")
    else:
        res, compile_s, run_s = timed_call(ev, *inputs)
    m = res.metrics
    out = {
        "steady_state_error": float(m.steady_state_error[0]),
        "convergence_time": float(m.convergence_time[0]),
        "control_effort": float(m.control_effort[0]),
        "converged": bool(m.converged[0]),
        "compile_s": round(compile_s, 2),
        "run_s": round(run_s, 3),
        "sim_steps": n_steps,
    }
    if tap is not None:
        st = tap.stats()
        tap.close()
        out["stream"] = {"path": args.stream, "records": st["pushed"],
                         "dropped": st["dropped"], "native": st["native"]}
    print(json.dumps(to_jsonable(out)))
    return 0


def _full_stack(args, dev, dtype, dt: float, n_steps: int) -> int:
    """The --full_stack episode: `PMPC(N=15, dt=dt, u_bound=0.6, 10
    iterations)` every 5 world steps after 250 steps of rest, the arms'
    impedance QPs at 40 ADMM iterations (`dart_tpu/cli/pmpc.py:74-113`)."""
    import numpy as np
    import torch

    from dart_tpu_torch.control import mpc as mpc_mod
    from dart_tpu_torch.io.logging import EpisodeLog, to_jsonable
    from dart_tpu_torch.models import dynamics as dyn
    from dart_tpu_torch.physics import tray_object as to_mod
    from dart_tpu_torch.rollout import full_stack as fs
    from dart_tpu_torch.utils.timing import timed_call

    scene = fs.make_scene(dt=dt, dtype=dtype, device=dev)
    obj_params = to_mod.make_params(args.object_name, args.mass,
                                    args.friction, dtype=dtype, device=dev)
    # The reference's controller discretisation Ts = the sim dt
    # (`main_parallel.py:108`).
    ctlr = mpc_mod.PMPC(N=15, dt=dt, u_bound=0.6,
                        cfg=mpc_mod.ilqr.ILQRConfig(max_iters=10))
    weights = (mpc_mod.PMPC_WEIGHTS["general"] if args.no_tune
               else mpc_mod.PMPC_WEIGHTS[args.object_name])
    # The high-friction schedule for sliding shapes (the sphere is handled
    # by the rolling-aware model).
    weights = mpc_mod.pmpc_schedule_weights(
        weights, torch.tensor(args.friction, dtype=dtype, device=dev),
        args.object_name != "sphere")
    params = dyn.PMPCParams(mu=args.friction, dt=dt)
    target6 = torch.tensor([[args.target[0], 0, args.target[1], 0, 0.43, 0]],
                           dtype=dtype, device=dev)

    def solve_fn(c, obs, t):
        return ctlr.solve(c, obs, t, params, weights)

    def run():
        return fs.run_full_stack(
            scene, solve_fn, ctlr.init_carry(1, dtype, dev),
            fs.init_full_state(dtype, device=dev), target6, obj_params,
            n_steps=n_steps, dt=dt, control_every=5, warmup_steps=250,
            qp_iters=40, record_joints=bool(args.video))

    out_t, compile_s, run_s = timed_call(run)
    ps, thetas, us = out_t[:3]
    video = None
    if args.video:
        from dart_tpu_torch.io.video import encode, render_scene
        qLs, qRs = out_t[3:5]
        w = encode(args.video, render_scene(
            qLs[0], qRs[0], ps[0].cpu().numpy(), thetas[0].cpu().numpy(),
            args.target, scene=scene))
        video = {"path": w.out_path, "frames": w.frames_written,
                 "backend": w.backend}
    ps = ps[0].cpu().numpy()
    us = us[0].cpu().numpy()
    err = np.linalg.norm(ps - np.asarray(args.target), axis=1)
    below = err < args.tolerance
    out = {
        "steady_state_error": float(err[-1]),
        "convergence_time": float(np.argmax(below) * dt) if below.any()
        else float("inf"),
        "control_effort": float(np.sum(np.linalg.norm(us, axis=1)) * dt),
        "converged": bool(below.any()),
        "compile_s": round(compile_s, 2),
        "run_s": round(run_s, 3),
        "sim_steps": n_steps,
    }
    if args.log_dir:
        log = EpisodeLog()
        T = len(us)
        log.log_arrays(
            t=np.arange(T) * dt,
            X=np.stack([ps[:, 0], np.zeros(T), ps[:, 1], np.zeros(T),
                        np.zeros(T), np.zeros(T)], -1),
            U_cmd=us,
        )
        out["log_path"] = log.save_npz(args.log_dir, args.object_name,
                                       args.mass, args.friction, args.target,
                                       args.tolerance)
    if video is not None:
        out["video"] = video
    print(json.dumps(to_jsonable(out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
