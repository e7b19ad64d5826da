"""Port parity: the video writer and the numpy renderers (`io.video`), the
object presets (`physics.object_presets`), the `preview` command and
`pmpc --full_stack --video`, the results helpers (`io.results`) and
`utils.timing.trace`.

The port draws its frames with numpy alone, JAX's with matplotlib, so the
renderers are held to JAX's on what they draw (the pinhole camera, the
tray's rotation, the arms' joint positions and every projected point),
not on pixels.
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.io import logging as jlog
from dart_tpu.io import results as jres
from dart_tpu.io import video as jvid
from dart_tpu.physics import chain as jchain
from dart_tpu.physics import object_presets as jpre
from dart_tpu.rollout import full_stack as jfs
from dart_tpu_torch.cli import pmpc as tcli_pmpc
from dart_tpu_torch.cli.__main__ import main as dispatch
from dart_tpu_torch.io import logging as tlog
from dart_tpu_torch.io import results as tres
from dart_tpu_torch.io import video as tvid
from dart_tpu_torch.physics import object_presets as tpre
from dart_tpu_torch.rollout import full_stack as tfs
from dart_tpu_torch.utils.timing import trace

OBJECT_GREEN = np.asarray([0x11, 0x77, 0x33], np.uint8)


def _joints(T: int, seed: int = 0):
    """Joint trajectories of both arms near home: a smooth sweep plus
    noise, float64."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0.0, 1.0, T)[:, None]
    qL = np.asarray(tfs.HOME_QL) + 0.4 * s * rng.normal(size=7) \
        + 0.01 * rng.normal(size=(T, 7))
    qR = np.asarray(tfs.HOME_QR) - 0.3 * s * rng.normal(size=7)
    return qL, qR


def _jax_geometry(qL, qR, ps, thetas, target, every):
    """What JAX's `render_scene` hands matplotlib, frame by frame: its
    own camera, tray rotation and jitted FK of both chains with the tool
    point."""
    scene = jfs.make_scene(dtype=jnp.float64)
    off = jnp.asarray([0.0, 0.0, 0.125])

    def pts(params, q):
        f = jchain.fk(params, q)
        return jnp.concatenate([f.p, (f.p[-1] + f.R[-1] @ off)[None]])

    idx = np.arange(0, len(ps), every)
    jL = np.asarray(jax.vmap(lambda q: pts(scene.left, q))(
        jnp.asarray(qL[idx])))
    jR = np.asarray(jax.vmap(lambda q: pts(scene.right, q))(
        jnp.asarray(qR[idx])))
    project = jvid._pinhole((1.1, -1.3, 1.05), at=(0.0, 0.0, 0.4))
    tray = np.asarray([0.0, 0.0, 0.4])
    corners = np.array([[-0.2, -0.15, 0], [0.2, -0.15, 0], [0.2, 0.15, 0],
                        [-0.2, 0.15, 0]])
    out = []
    for fi, k in enumerate(idx):
        R = jvid._tilt_rot(thetas[k])
        geo = {"tray": project(corners @ R.T + tray)[0]}
        geo["target"] = project((R @ np.array([target[0], target[1], 0.03])
                                 + tray)[None])[0][0]
        geo["object"] = project((R @ np.array([ps[k, 0], ps[k, 1], 0.03])
                                 + tray)[None])[0][0]
        for name, base, J in (
                ("left", np.asarray(scene.left.base_pos), jL[fi]),
                ("right", np.asarray(scene.right.base_pos), jR[fi])):
            geo[name] = project(np.concatenate([base[None], J]))[0]
        out.append(geo)
    return out


def test_scene_geometry_matches_jax():
    """The port's scene geometry (its FK on the joints, batched over the
    frames; JAX's pinhole camera and tray rotation) against the points
    JAX's renderer draws, frame by frame, float64, within 1e-12; the
    camera and rotation helpers equal JAX's; the rasterised frames are
    RGB, not blank, and differ as the arms move."""
    T, every = 60, 20
    qL, qR = _joints(T)
    ps = np.stack([np.linspace(0, 0.05, T), np.linspace(0, -0.04, T)], -1)
    thetas = np.stack([0.1 * np.sin(np.linspace(0, 3, T)),
                       np.linspace(0, -0.05, T)], -1)
    target = (0.05, -0.04)
    for th in ([0.0, 0.0], [0.1, -0.05], [-0.3, 0.2]):
        np.testing.assert_array_equal(tvid._tilt_rot(th), jvid._tilt_rot(th))
    P = np.random.default_rng(1).normal(size=(5, 3))
    for a, b in zip(tvid._pinhole((1.0, -1.0, 1.0), (0, 0, 0.4))(P),
                    jvid._pinhole((1.0, -1.0, 1.0), (0, 0, 0.4))(P)):
        np.testing.assert_array_equal(a, b)
    scene = tfs.make_scene(dtype=torch.float64, device="cpu")
    qL_t, qR_t = torch.from_numpy(qL), torch.from_numpy(qR)
    got = tvid.scene_geometry(qL_t, qR_t, ps, thetas, target, scene=scene,
                              every=every)
    want = _jax_geometry(qL, qR, ps, thetas, target, every)
    assert [g["k"] for g in got] == [0, 20, 40]
    for g, w in zip(got, want):
        for name in ("tray", "target", "object", "left", "right"):
            np.testing.assert_allclose(g[name], w[name], rtol=0, atol=1e-12,
                                       err_msg=name)
    frames = tvid.render_scene(qL_t, qR_t, ps, thetas, target, scene=scene,
                               every=every)
    assert len(frames) == 3 and frames[0].shape == (320, 400, 3)
    assert frames[0].dtype == np.uint8
    for f in frames:
        assert len(np.unique(f.reshape(-1, 3), axis=0)) > 3
    assert np.abs(frames[0].astype(int) - frames[-1].astype(int)).mean() > 0.2


def _object_centroid(frame):
    ys, xs = np.nonzero((frame == OBJECT_GREEN).all(-1))
    return np.array([xs.mean(), ys.mean()])


def test_topdown_frames_and_writer_chain(tmp_path, monkeypatch):
    """`render_topdown` draws a frame every `every` steps with the object
    disc where the episode put it (its drawn centre moves with it, the
    y axis pointing up); `save_episode_video` writes them through the
    writer chain, which falls back to a `.npy` of the frames when no
    encoder imports, and stops on its sentinel."""
    T = 100
    ps = np.stack([np.linspace(0, 0.05, T), np.linspace(0, -0.04, T)], -1)
    thetas = np.tile([0.1, -0.05], (T, 1))
    frames = tvid.render_topdown(ps, thetas, (0.05, -0.04), every=25)
    assert len(frames) == 4 and frames[0].shape == (240, 320, 3)
    c0, c3 = _object_centroid(frames[0]), _object_centroid(frames[-1])
    # 600 pixels a metre (the window's 0.4 m over 240 rows), the image's y
    # axis pointing down.
    d = (ps[75] - ps[0]) * [600, -600]
    np.testing.assert_allclose(c3 - c0, d, rtol=0, atol=0.5)
    n = tvid.save_episode_video(str(tmp_path / "ep.mp4"), ps, thetas,
                                (0.05, -0.04), every=25)
    assert n == 4

    for mod in ("cv2", "imageio", "imageio.v2"):
        monkeypatch.setitem(sys.modules, mod, None)
    w = tvid.encode(str(tmp_path / "raw.mp4"), frames)
    assert (w.backend, w.frames_written) == ("npy", 4)
    assert w.out_path == str(tmp_path / "raw.mp4.npy")
    np.testing.assert_array_equal(np.load(w.out_path), np.stack(frames))
    assert not w.thread.is_alive()


@pytest.mark.parametrize("calibrated", [True, False])
def test_preset_params_match_jax(calibrated):
    """`make_preset_params` for every preset row (the pack and the `pan`
    alias), at two frictions and the extracted or an overridden mass,
    against JAX's, float32: every field equal (the port's per-axis fields
    are pairs where JAX leaves a scalar)."""
    assert tpre.PRESETS == jpre.PRESETS and len(tpre.PRESETS) > 50
    for name in sorted(tpre.PRESETS):
        for mu, mass in ((0.3, None), (0.05, 1.5)):
            want = jpre.make_preset_params(name, mu=mu, mass=mass,
                                           calibrated=calibrated)
            got = tpre.make_preset_params(name, mu=mu, mass=mass,
                                          calibrated=calibrated,
                                          device="cpu")
            for f in want._fields:
                g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
                np.testing.assert_array_equal(
                    g, np.broadcast_to(w, g.shape), err_msg=f"{name}.{f}")


def test_preview_command_matches_jax(tmp_path):
    """`preview --cpu` on a pack preset and on a primitive for 0.2 s: the
    JSON line, a frame every 20 steps written to the container the chain
    reached, and the final position against JAX's own command (float32
    plant; 2e-6 m)."""
    from dart_tpu.cli import preview as jprev

    for obj in ("cubemedium", "sphere"):
        out_j, out_t = (str(tmp_path / f"{obj}_{s}.mp4") for s in "jt")
        with redirect_stdout(io.StringIO()) as buf:
            assert jprev.main(["--object", obj, "--seconds", "0.2",
                               "--out", out_j]) == 0
        want = json.loads(buf.getvalue())
        with redirect_stdout(io.StringIO()) as buf:
            assert dispatch(["preview", "--cpu", "--object", obj,
                             "--seconds", "0.2", "--out", out_t]) == 0
        got = json.loads(buf.getvalue())
        assert got["frames"] == want["frames"] == 5
        assert got["out"] == out_t and os.path.getsize(got["written"]) > 0
        np.testing.assert_allclose(got["final_p"], want["final_p"], rtol=0,
                                   atol=2e-6)
        assert abs(got["final_p"][0]) > 1e-4


def test_full_stack_video_command(tmp_path):
    """`pmpc --full_stack --video --cpu` at runtime 0.06 (30 world steps
    at rest, a frame every 20) writes 2 frames and reports them; --video
    without --full_stack is refused as JAX refuses it."""
    path = str(tmp_path / "fs.mp4")
    with redirect_stdout(io.StringIO()) as buf:
        assert tcli_pmpc.main(["--cpu", "--full_stack", "--runtime", "0.06",
                               "--video", path]) == 0
    out = json.loads(buf.getvalue())
    assert out["video"]["frames"] == 2 and out["sim_steps"] == 30
    assert os.path.getsize(out["video"]["path"]) > 0
    with pytest.raises(SystemExit) as e:
        tcli_pmpc.main(["--cpu", "--video", path])
    assert e.value.code == 2


def test_results_helpers_match_jax(tmp_path):
    """`episode_stats` on an `EpisodicNpy` store and `summarize_sweep` on
    sweep rows equal JAX's; `plot_metric` writes its figure; the env names
    round-trip."""
    stores = []
    for mod, name in ((tlog, "t"), (jlog, "j")):
        store = mod.EpisodicNpy(str(tmp_path / name / "cube_1x0_0x1.npy"))
        for ep in range(3):
            for k in range(10):
                store.log("pos_error", 0.1 / (ep + 1) - 0.005 * k)
                store.log("pos", [0.01 * k, -0.02 * ep])
            store.save()
        stores.append(store)
    for metric in ("pos_error", "pos"):
        got = tres.episode_stats(stores[0], metric)
        want = jres.episode_stats(stores[1], metric)
        assert got.keys() == want.keys() and got["episodes"] == 3
        for k in ("lowest", "average", "final"):
            np.testing.assert_array_equal(got[k], want[k])
    out = tres.plot_metric({"cube": stores[0]}, "pos",
                           str(tmp_path / "plots" / "pos.png"))
    assert os.path.getsize(out) > 0
    rows = [{"object": "cube", "converged": True, "sse_mm": 1.0,
             "conv_time_s": 0.5, "effort": 0.2},
            {"object": "cube", "converged": False, "sse_mm": 20.0,
             "conv_time_s": float("inf"), "effort": 0.9},
            {"object": "sphere", "converged": False, "sse_mm": 2.0,
             "conv_time_s": float("inf"), "effort": 0.1}]
    assert tres.summarize_sweep([dict(r) for r in rows]) == \
        jres.summarize_sweep([dict(r) for r in rows])
    n = tres.env_name("sphere", 0.2, 0.1)
    assert n == jres.env_name("sphere", 0.2, 0.1) == "sphere_0x2_0x1"
    assert tres.parse_env_name(n) == ("sphere", 0.2, 0.1)


def test_trace_writes_a_chrome_trace(tmp_path):
    """`trace(logdir)` profiles its block with torch.profiler and writes
    a Chrome trace holding the block's operators."""
    with trace(str(tmp_path / "tr")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
