"""Dispatcher of the port's commands (port of `dart_tpu.cli.__main__`).

    python -m dart_tpu_torch.cli sweep [args...]

Only `sweep` is ported; the other commands of `python -m dart_tpu.cli`
stop with the ROADMAP Queue 1 item that ports them.
"""

import sys

_NOT_PORTED = {
    "pmpc": "ROADMAP Queue 1 item 3 (single-lane solver and controllers)",
    "rmpc": "ROADMAP Queue 1 item 3 (single-lane solver and controllers)",
    "lmpc": "ROADMAP Queue 1 item 4 (PPO and LMPC training)",
    "bench": "ROADMAP Queue 1 item 1 (the port's bench)",
    "demo": "ROADMAP Queue 1 item 3 (it runs the pmpc command)",
    "preview": "ROADMAP Queue 1 item 6 (with the object presets)",
    "watch": "ROADMAP Queue 1 item 6 (with the telemetry ring)",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in {"-h", "--help", "help"}:
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "sweep":
        from dart_tpu_torch.cli.sweep import main as m
        return m(rest)
    if cmd in _NOT_PORTED:
        print(f"{cmd}: not ported yet, see {_NOT_PORTED[cmd]}",
              file=sys.stderr)
        return 2
    print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
