"""Scene preview, the `PMPC/object_sim/preview.py` equivalent (port of
`dart_tpu.cli.preview`).

Renders a short open-loop episode of a chosen scene (the object sliding
under a held tilt on the contact plant) to a video file, for checking a
scene's parameters by eye:

    python -m dart_tpu_torch.cli preview --object sphere --mu 0.1 \
        --tilt 0.15 0.0 --out previews/sphere.mp4

Runs the plant on the card (`--cpu`: on the CPU), a frame every 20 steps,
and prints one JSON line: the requested path, the frames, the file the
writer chain reached and the final position.
"""

import argparse
import json


def main(argv=None):
    from dart_tpu_torch.physics.object_presets import PRESETS

    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--object", default="cube",
                   choices=["cube", "cylinder", "sphere"] + sorted(PRESETS))
    p.add_argument("--mass", type=float, default=None,
                   help="override mass (presets default to their extracted "
                        "mass; primitives to 1.0 kg)")
    p.add_argument("--mu", type=float, default=0.1)
    p.add_argument("--tilt", type=float, nargs=2, default=[0.12, 0.0])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="previews/preview.mp4")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    import torch

    from dart_tpu_torch.io.video import encode, render_topdown
    from dart_tpu_torch.physics import tray_object as to_mod
    from dart_tpu_torch.physics.object_presets import make_preset_params
    from dart_tpu_torch.utils.device import resolve

    try:
        dev = resolve("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        p.error(str(e))
    dt = 0.002
    T = int(args.seconds / dt)
    if args.object in ("cube", "cylinder", "sphere"):
        params = to_mod.make_params(args.object, args.mass or 1.0, args.mu,
                                    device=dev)
    else:
        params = make_preset_params(args.object, mu=args.mu, mass=args.mass,
                                    device=dev)
    u = torch.tensor([args.tilt], dtype=torch.float32, device=dev)
    s = to_mod.init_state(device=dev, batch=1)
    ps = torch.empty((T, 2), dtype=torch.float32, device=dev)
    thetas = torch.empty_like(ps)
    with torch.no_grad():
        for k in range(T):
            s = to_mod.step(s, u, params, dt)
            ps[k], thetas[k] = s.p[0], s.theta[0]
    ps, thetas = ps.cpu().numpy(), thetas.cpu().numpy()
    final = [float(ps[-1, 0]), float(ps[-1, 1])]
    w = encode(args.out, render_topdown(ps, thetas, final, every=20))
    print(json.dumps({"out": args.out, "frames": w.frames_written,
                      "written": w.out_path, "backend": w.backend,
                      "final_p": final}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
