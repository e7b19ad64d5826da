"""Live terminal episode viewer, the reference's `mujoco.viewer` stand-in
(port of `dart_tpu.cli.watch`).

Every reference driver opens an interactive viewer (`PMPC/main.py:90`);
this environment has no GL, so the live surface here is the telemetry
ring: run an episode with streaming enabled

    python -m dart_tpu_torch.cli pmpc --stream ep.ring --runtime 10 &
    python -m dart_tpu_torch.cli watch ep.ring

and `watch` tails the ring file (the native writer thread drains + flushes
continuously, `native/ringlog.cpp:47-68`), rendering at --fps:

  * a top-down tray map (box = tray extents, `x` = target, `o` = object),
  * live tilt commands, position, error readouts,
  * a unicode sparkline of the recent tracking error.

Works on any running or finished episode; exits when the stream goes
idle (no new records for --idle_timeout seconds; 0 = wait forever).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

TRAY_X, TRAY_Y = 0.2, 0.15           # half-extents (world_general.xml:135)
SPARK = "▁▂▃▄▅▆▇█"


def read_new(path: str, dtype: np.dtype, offset_records: int) -> np.ndarray:
    size = os.path.getsize(path) if os.path.exists(path) else 0
    n = size // dtype.itemsize
    if n <= offset_records:
        return np.empty(0, dtype)
    with open(path, "rb") as f:
        f.seek(offset_records * dtype.itemsize)
        return np.fromfile(f, dtype=dtype, count=n - offset_records)


def sparkline(values, width=48):
    if len(values) == 0:
        return ""
    v = np.asarray(values, np.float64)[-width:]
    hi = float(v.max())
    if hi <= 0:
        return SPARK[0] * len(v)
    idx = np.minimum((v / hi * (len(SPARK) - 1)).astype(int),
                     len(SPARK) - 1)
    return "".join(SPARK[i] for i in idx)


def tray_map(px, py, tx=None, ty=None, cols=41, rows=13):
    """Top-down ASCII map of the tray with the object and target."""
    grid = [[" "] * cols for _ in range(rows)]

    def put(x, y, ch):
        c = int(round((x / TRAY_X + 1) / 2 * (cols - 1)))
        r = int(round((1 - (y / TRAY_Y + 1) / 2) * (rows - 1)))
        if 0 <= r < rows and 0 <= c < cols:
            grid[r][c] = ch

    if tx is not None:
        put(tx, ty, "x")
    put(px, py, "o")
    top = "+" + "-" * cols + "+"
    return "\n".join([top] + ["|" + "".join(r) + "|" for r in grid] + [top])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ring", help="telemetry ring path (cli/pmpc --stream)")
    p.add_argument("--target", nargs=2, type=float, default=None,
                   metavar=("X", "Y"), help="target marker on the map")
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--idle_timeout", type=float, default=5.0,
                   help="exit after this many seconds without new records "
                        "(0 = follow forever)")
    p.add_argument("--dt", type=float, default=0.002,
                   help="sim period per record, for the time readout")
    args = p.parse_args(argv)

    from dart_tpu_torch.io.streaming import EPISODE_STREAM_DTYPE
    dtype = EPISODE_STREAM_DTYPE

    # wait for the ring to appear
    t0 = time.time()
    while not os.path.exists(args.ring):
        if args.idle_timeout and time.time() - t0 > max(args.idle_timeout,
                                                        30.0):
            print(f"watch: {args.ring} never appeared", file=sys.stderr)
            return 1
        time.sleep(0.1)

    seen = 0
    errs: list = []
    last = None
    last_new = time.time()
    try:
        while True:
            recs = read_new(args.ring, dtype, seen)
            if recs.size:
                seen += recs.size
                errs.extend(np.asarray(recs["err"], np.float64).tolist())
                errs = errs[-512:]
                last = recs[-1]
                last_new = time.time()
            elif args.idle_timeout and \
                    time.time() - last_new > args.idle_timeout:
                break
            if last is not None:
                t = float(last["k"]) * args.dt
                lines = [
                    f"dart_tpu_torch live episode  "
                    f"t={t:7.3f}s  records={seen}",
                    tray_map(float(last["px"]), float(last["py"]),
                             *(args.target or (None, None))),
                    f"pos  = ({float(last['px']):+8.4f}, "
                    f"{float(last['py']):+8.4f}) m",
                    f"tilt = ({float(last['ux']):+8.4f}, "
                    f"{float(last['uy']):+8.4f}) rad",
                    f"err  =  {float(last['err']) * 1e3:8.2f} mm",
                    f"err  {sparkline(errs)}",
                ]
                sys.stdout.write("\x1b[H\x1b[2J" + "\n".join(lines) + "\n")
                sys.stdout.flush()
            time.sleep(1.0 / args.fps)
    except KeyboardInterrupt:
        pass
    if last is not None:
        print(f"\nwatch: stream idle after {seen} records "
              f"(final err {float(last['err']) * 1e3:.2f} mm)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
