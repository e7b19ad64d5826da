"""Dispatcher of the port's commands (port of `dart_tpu.cli.__main__`).

    python -m dart_tpu_torch.cli {pmpc|rmpc|lmpc|sweep|demo|preview|watch}
        [args...]

`watch` is the live episode viewer (the reference `mujoco.viewer`
stand-in): it tails a telemetry ring written by `pmpc --stream` and draws
the tray map, tilt and error in the terminal. `preview` renders a scene's
open-loop episode to a video. `demo` runs the three canned experiments of
the reference launcher (`launch.sh:34-52`): cube precise, cylinder fast,
sphere gentle. `sweep` shards its rows over the ranks when started by
`torchrun` (`torchrun --standalone --nproc_per_node=k -m dart_tpu_torch.cli
sweep ...`: one rank a card over NCCL, or gloo on the CPU with `--cpu`).
`bench` of `python -m dart_tpu.cli` stops with the ROADMAP Queue 1 item
that ports it.
"""

import sys

_NOT_PORTED = {
    "bench": "ROADMAP Queue 1 item 1 (the port's bench)",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in {"-h", "--help", "help"}:
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "pmpc":
        from dart_tpu_torch.cli.pmpc import main as m
        return m(rest)
    if cmd == "rmpc":
        from dart_tpu_torch.cli.rmpc import main as m
        return m(rest)
    if cmd == "lmpc":
        from dart_tpu_torch.cli.lmpc import main as m
        return m(rest)
    if cmd == "sweep":
        from dart_tpu_torch.cli.sweep import main as m
        return m(rest)
    if cmd == "preview":
        from dart_tpu_torch.cli.preview import main as m
        return m(rest)
    if cmd == "watch":
        from dart_tpu_torch.cli.watch import main as m
        return m(rest)
    if cmd == "demo":
        from dart_tpu_torch.cli.pmpc import main as m
        from dart_tpu_torch.io.config import PRESETS
        for name in ("cube_precise", "cylinder_fast", "sphere_gentle"):
            c = PRESETS[name]
            print(f"== {name} ==")
            rc = m(["--target", str(c.target[0]), str(c.target[1]),
                    "--object_name", c.object_name, "--mass", str(c.mass),
                    "--friction", str(c.friction), "--runtime", "5",
                    "--tolerance", str(c.tolerance), *rest])
            if rc:
                return rc
        return 0
    if cmd in _NOT_PORTED:
        print(f"{cmd}: not ported yet, see {_NOT_PORTED[cmd]}",
              file=sys.stderr)
        return 2
    print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
