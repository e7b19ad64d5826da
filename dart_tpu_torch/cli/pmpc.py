"""PMPC experiment driver — the `PMPC/main_parallel_enhanced.py` equivalent
(port of `dart_tpu.cli.pmpc`, the contact-plant path).

    python -m dart_tpu_torch.cli pmpc --target 0.05 -0.04 \
        --object_name cube --mass 1.0 --friction 0.1 --runtime 6 \
        --tolerance 0.01

Runs one episode of the per-scenario PMPC evaluator against the
contact-plant oracle on the card (`--cpu`: on the CPU) and prints one JSON
line of metrics. Like the JAX command it runs the episode four times (a
warm call, then 3 timed ones); `compile_s` is the first call's seconds.
"""

import argparse
import json
import sys

# Options of `dart_tpu.cli.pmpc` that are not ported yet, and the ROADMAP
# Queue 1 item that ports each.
_NOT_PORTED = {
    "full_stack": "the dual-arm world (ROADMAP Queue 1 item 5)",
    "video": "the dual-arm world's renderer (ROADMAP Queue 1 item 5)",
    "stream": "the telemetry ring (ROADMAP Queue 1 item 6)",
}


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
    p.add_argument("--full_stack", action="store_true",
                   help="not ported: " + _NOT_PORTED["full_stack"])
    p.add_argument("--video", default=None, metavar="MP4_PATH",
                   help="not ported: " + _NOT_PORTED["video"])
    p.add_argument("--stream", default=None, metavar="RING_PATH",
                   help="not ported: " + _NOT_PORTED["stream"])
    p.add_argument("--f64", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    for opt in ("full_stack", "video", "stream"):
        if getattr(args, opt):
            print(f"pmpc: --{opt} needs {_NOT_PORTED[opt]}, not ported yet",
                  file=sys.stderr)
            return 2

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
    ev = make_pmpc_evaluator(n_steps=n_steps, dt=dt, control_every=5,
                             warmup_steps=250, tol=args.tolerance)

    def lane(x):
        return torch.tensor([x], dtype=dtype, device=dev)

    kinv = lane(_KAPPA_INV[args.object_name])
    res, compile_s, run_s = timed_call(
        ev, kinv, lane(args.mass), lane(args.friction), lane(args.target))
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
    print(json.dumps(to_jsonable(out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
