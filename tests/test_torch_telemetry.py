"""Port parity: the native telemetry ring (`io.ringlog`, built from
`native/ringlog.cpp` with g++ at first use), its Python fallback, the
per-step tap (`io.streaming.TelemetryTap`), the PMPC evaluator's stream
against JAX's io_callback stream, `pmpc --stream` and `watch`.
"""

import io
import json
import shutil
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.cli import watch as jwatch
from dart_tpu.io.ringlog import RingLogger as JRing
from dart_tpu.io.streaming import EPISODE_STREAM_DTYPE as J_DTYPE
from dart_tpu.io.streaming import TelemetryTap as JTap
from dart_tpu.rollout import evaluate as jev
from dart_tpu_torch.cli import pmpc as tcli_pmpc
from dart_tpu_torch.cli import watch as twatch
from dart_tpu_torch.cli.__main__ import main as dispatch
from dart_tpu_torch.io import ringlog as trl
from dart_tpu_torch.io import streaming as tst
from dart_tpu_torch.rollout import evaluate as tev

REC = np.dtype([("t", np.float64), ("x", np.float32, (4,)),
                ("step", np.int64)])
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain to build the ring")


@needs_gxx
def test_native_roundtrip_and_overflow(tmp_path):
    """tests/test_ringlog.py's checks on the port's build of the ring:
    1000 records round-trip in order, counted; a ring of 8 records under a
    burst of 100000 drops and counts, never blocks, and what it wrote is in
    order. The library lands under build/dart_tpu_torch/<hash>/."""
    assert trl.is_native()
    assert "build/dart_tpu_torch" in str(trl._build.build_host(
        trl.SOURCE, "ringlog"))
    path = str(tmp_path / "t.bin")
    log = trl.RingLogger(path, REC, capacity_records=4096)
    assert log.is_native
    recs = np.zeros(1000, REC)
    recs["t"] = np.arange(1000) * 0.002
    recs["x"] = np.arange(1000)[:, None] * [1, 2, 3, 4]
    recs["step"] = np.arange(1000)
    assert log.push(recs[:10])
    for r in recs[10:]:
        log.push(r)
    log.flush()
    st = log.stats()
    assert st == {"pushed": 1000, "dropped": 0, "written": 1000,
                  "native": True}
    log.close()
    np.testing.assert_array_equal(trl.RingLogger.read(path, REC), recs)
    # JAX's reader reads the port's file.
    np.testing.assert_array_equal(JRing.read(path, REC), recs)

    path = str(tmp_path / "o.bin")
    log = trl.RingLogger(path, REC, capacity_records=8)
    rec = np.zeros((), REC)
    for i in range(100000):
        rec["step"] = i
        log.push(rec)
    log.flush()
    st = log.stats()
    assert st["pushed"] + st["dropped"] == 100000
    log.close()
    arr = trl.RingLogger.read(path, REC)
    assert arr.shape[0] == st["pushed"] == st["written"]
    assert np.all(np.diff(arr["step"]) > 0)


def test_fallback_writer(tmp_path, monkeypatch):
    """Where the library cannot be built the Python writer takes its place
    and says so: `is_native()` False, the records still on disk."""
    monkeypatch.setattr(trl, "_load", lambda: None)
    assert not trl.is_native()
    path = str(tmp_path / "fb.bin")
    log = trl.RingLogger(path, REC)
    assert not log.is_native
    rec = np.zeros((), REC)
    rec["t"] = 1.5
    assert log.push(rec)
    assert log.stats()["native"] is False
    log.close()
    arr = trl.RingLogger.read(path, REC)
    assert arr.shape == (1,) and arr["t"][0] == 1.5
    # A build that fails (no compiler) reads as no library.
    monkeypatch.undo()
    trl._load.cache_clear()
    monkeypatch.setattr(trl._build, "build_host",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("x")))
    assert trl._load() is None
    trl._load.cache_clear()


def test_tap_records_tensors_and_numbers(tmp_path):
    """`emit` takes tensors (scalars and arrays, any float type), numpy
    values and python numbers, in the dtype's field order or not."""
    path = str(tmp_path / "tap.bin")
    rec = np.dtype([("t", np.float32), ("x", np.float32, (2,)),
                    ("k", np.int32)])
    tap = tst.TelemetryTap(path, rec, capacity_records=64)
    for k in range(5):
        assert tap.emit(k=k, x=torch.tensor([0.1 * k, -0.2 * k],
                                            dtype=torch.float64),
                        t=torch.tensor(k * 0.002))
    tap.logger.flush()
    tap.close()
    arr = trl.RingLogger.read(path, rec)
    np.testing.assert_array_equal(arr["k"], np.arange(5))
    np.testing.assert_array_equal(arr["t"],
                                  np.float32(np.arange(5, dtype=np.float32)
                                             * np.float32(0.002)))
    np.testing.assert_array_equal(
        arr["x"], np.stack([0.1 * np.arange(5), -0.2 * np.arange(5)],
                           -1).astype(np.float32))


def test_pmpc_evaluator_stream_matches_jax(tmp_path):
    """`make_pmpc_evaluator(tap=...)` on one episode (tests/
    test_torch_scenario_eval.py's shape: 45 steps, two solves, N=8)
    streams one record per step equal to the records JAX's io_callback tap
    streams from its jitted scan (the float32 fields of the same float64
    episode); a batch of two episodes is refused."""
    kw = dict(n_steps=45, dt=0.002, control_every=15, warmup_steps=25, N=8,
              max_iters=3, tol=0.01)
    row = [np.asarray(x, np.float64) for x in
           ([2.0, 0.0], 2.0, 0.05, [-0.04, 0.02])]
    paths = [str(tmp_path / n) for n in ("j.ring", "t.ring")]
    tap_j = JTap(paths[0], tst.EPISODE_STREAM_DTYPE)
    jax.block_until_ready(jax.jit(jev.make_pmpc_evaluator(**kw, tap=tap_j))(
        *(jnp.asarray(x) for x in row)))
    tap_j.close()
    tap_t = tst.TelemetryTap(paths[1], tst.EPISODE_STREAM_DTYPE)
    ev = tev.make_pmpc_evaluator(**kw, tap=tap_t)
    ev(*(torch.from_numpy(np.asarray(x))[None] for x in row))
    assert tap_t.stats()["dropped"] == 0
    tap_t.close()
    got, want = (trl.RingLogger.read(p, tst.EPISODE_STREAM_DTYPE)
                 for p in paths[::-1])
    assert got.shape == want.shape == (45,)
    np.testing.assert_array_equal(got["k"], np.arange(45))
    for f in ("px", "py", "ux", "uy", "err"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-6, atol=1e-9,
                                   err_msg=f)
    assert np.abs(got["ux"]).max() > 0
    with pytest.raises(ValueError, match="one episode"):
        ev(*(torch.from_numpy(np.stack([np.asarray(x)] * 2)) for x in row))


@needs_gxx
def test_pmpc_stream_and_watch_commands(tmp_path):
    """`pmpc --stream --cpu` at runtime 0.52 runs one episode and reports
    the ring's counts: a record per sim step, none dropped, the native
    writer; then `watch` replays the finished ring and exits 0 once it
    goes idle."""
    ring = str(tmp_path / "ep.ring")
    with redirect_stdout(io.StringIO()) as buf:
        assert tcli_pmpc.main(["--cpu", "--runtime", "0.52",
                               "--stream", ring]) == 0
    out = json.loads(buf.getvalue())
    assert out["sim_steps"] == 260 and out["run_s"] is None
    assert out["stream"] == {"path": ring, "records": 260, "dropped": 0,
                             "native": trl.is_native()}
    recs = trl.RingLogger.read(ring, tst.EPISODE_STREAM_DTYPE)
    np.testing.assert_array_equal(recs["k"], np.arange(260))
    np.testing.assert_allclose(recs["err"][-1],
                               out["steady_state_error"], rtol=1e-6)
    with redirect_stdout(io.StringIO()) as buf:
        assert dispatch(["watch", ring, "--idle_timeout", "0.3",
                         "--fps", "50", "--target", "0.05", "-0.04"]) == 0
    text = buf.getvalue()
    assert "stream idle after 260 records" in text
    assert "records=260" in text and "x" in text


def test_watch_helpers_match_jax(tmp_path):
    """`read_new` tails a growing file incrementally; `sparkline` and
    `tray_map` draw what JAX's draw on the same inputs."""
    recs = np.zeros(5, tst.EPISODE_STREAM_DTYPE)
    recs["k"] = np.arange(5)
    recs["err"] = np.linspace(0.1, 0.02, 5)
    path = str(tmp_path / "r.ring")
    recs[:3].tofile(path)
    first = twatch.read_new(path, tst.EPISODE_STREAM_DTYPE, 0)
    assert first["k"].tolist() == [0, 1, 2]
    assert twatch.read_new(path, tst.EPISODE_STREAM_DTYPE, 3).size == 0
    with open(path, "ab") as f:
        recs[3:].tofile(f)
    assert twatch.read_new(path, tst.EPISODE_STREAM_DTYPE, 3)["k"].tolist() \
        == [3, 4]
    assert twatch.read_new(str(tmp_path / "none"), tst.EPISODE_STREAM_DTYPE,
                           0).size == 0
    for vals in ([], [0.0, 0.5, 1.0], [0.0, 0.0], list(np.linspace(0, 3, 70))):
        assert twatch.sparkline(vals) == jwatch.sparkline(vals)
    for args in ((0.0, 0.0, 0.1, 0.05), (-0.19, 0.14), (5.0, -5.0, 0.0, 0.0)):
        assert twatch.tray_map(*args) == jwatch.tray_map(*args)
    assert tst.EPISODE_STREAM_DTYPE == J_DTYPE
