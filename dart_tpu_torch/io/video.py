"""Asynchronous video writing and headless scene rendering (port of
`dart_tpu.io.video`).

`VideoWriterThread` is the reference's `VideoWriterThread` /
`VideoWriterProcess` (`PMPC/main_parallel_enhanced.py:58-103`): a queue and
a daemon thread in front of the first encoder that opens, as in JAX:
`cv2.VideoWriter` (mp4v), then imageio, then a GIF beside the path, then a
`.npy` of the raw frames.

The renderers draw with numpy alone (no plotting library): every element
is a mask over the pixel grid of an axis-aligned, equal-aspect data window
(the JAX renderers' axis limits), so the frames depend on nothing the
machine may lack. `render_topdown` draws the logged tray/object
trajectory from above (tray outline, tilt arrow, object track and disc,
target cross and tolerance ring); `render_scene` the full-stack scene
through JAX's pinhole camera: both xArm7 chains from the port's
`physics.chain.fk` on the recorded joints (batched over frames on the
joints' device), the tilted tray polygon, the object and the target mark.
`scene_geometry` returns what `render_scene` draws, in image-plane
coordinates, for checks.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

TRAY_HALF = (0.2, 0.15)


class VideoWriterThread:
    """Queue + daemon thread around a video sink; None shuts it down.
    After `close`, `backend` names the sink that took the frames ("cv2",
    "imageio", "npy") and `out_path` the file it wrote."""

    def __init__(self, path: str, fps: int = 30):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.out_path = path
        self.fps = fps
        self.backend = None
        self.q: queue.Queue = queue.Queue(maxsize=256)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.frames_written = 0
        self.thread.start()

    def _run(self):
        writer = None
        frames_for_npy = []
        try:
            while True:
                frame = self.q.get()
                if frame is None:
                    break
                frame = np.ascontiguousarray(frame)
                if self.backend is None:
                    self.backend, writer = self._open(frame.shape)
                if self.backend == "cv2":
                    import cv2
                    writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
                elif self.backend == "imageio":
                    writer.append_data(frame)
                else:
                    frames_for_npy.append(frame)
                self.frames_written += 1
        finally:
            if self.backend == "cv2" and writer is not None:
                writer.release()
            elif self.backend == "imageio" and writer is not None:
                writer.close()
            elif frames_for_npy:
                self.out_path = self.path + ".npy"
                np.save(self.out_path, np.stack(frames_for_npy))

    def _open(self, shape):
        h, w = shape[:2]
        try:
            import cv2
            vw = cv2.VideoWriter(self.path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 self.fps, (w, h))
            if vw.isOpened():
                return "cv2", vw
        except Exception:
            pass
        try:
            import imageio.v2 as imageio
            return "imageio", imageio.get_writer(self.path, fps=self.fps)
        except Exception:
            # No encoder for this container: a GIF beside it, then raw.
            try:
                import imageio.v2 as imageio
                gif = self.path.rsplit(".", 1)[0] + ".gif"
                w = imageio.get_writer(gif, fps=self.fps)
                self.path = self.out_path = gif
                return "imageio", w
            except Exception:
                return "npy", None

    def write(self, frame: np.ndarray):
        self.q.put(np.asarray(frame))

    def close(self):
        self.q.put(None)
        self.thread.join(timeout=30.0)


# ---------------------------------------------------------------------------
# The numpy rasteriser: RGB frames over a data window.
# ---------------------------------------------------------------------------

def _rgb(hex_color: str) -> np.ndarray:
    h = hex_color.lstrip("#")
    return np.asarray([int(h[i:i + 2], 16) for i in (0, 2, 4)], np.uint8)


class _Canvas:
    """An (h, w, 3) white frame showing the data window xlim x ylim at one
    scale on both axes (the window is centred in the frame)."""

    def __init__(self, xlim, ylim, size):
        self.h, self.w = size
        self.img = np.full((self.h, self.w, 3), 255, np.uint8)
        sx = self.w / (xlim[1] - xlim[0])
        sy = self.h / (ylim[1] - ylim[0])
        self.scale = min(sx, sy)
        self.cx, self.cy = (xlim[0] + xlim[1]) / 2, (ylim[0] + ylim[1]) / 2
        ys, xs = np.mgrid[0:self.h, 0:self.w]
        # Data coordinates of each pixel centre.
        self.X = (xs + 0.5 - self.w / 2) / self.scale + self.cx
        self.Y = (self.h / 2 - (ys + 0.5)) / self.scale + self.cy

    def paint(self, mask: np.ndarray, color: str):
        self.img[mask] = _rgb(color)

    def px(self, n_pixels: float) -> float:
        """A length of `n_pixels` in data units."""
        return n_pixels / self.scale

    def polygon(self, pts: np.ndarray, color: str, edge: str | None = None):
        """A convex polygon (n, 2), filled, with an optional outline."""
        pts = np.asarray(pts, float)
        inside = None
        a, b = pts[1] - pts[0], pts[2] - pts[1]
        orient = np.sign(a[0] * b[1] - a[1] * b[0])
        for a, b in zip(pts, np.roll(pts, -1, axis=0)):
            side = orient * ((b[0] - a[0]) * (self.Y - a[1])
                             - (b[1] - a[1]) * (self.X - a[0])) >= 0
            inside = side if inside is None else inside & side
        self.paint(inside, color)
        if edge is not None:
            self.polyline(np.concatenate([pts, pts[:1]]), edge, 1.0)

    def polyline(self, pts: np.ndarray, color: str, width_px: float):
        pts = np.asarray(pts, float)
        r = self.px(width_px / 2 + 0.5)
        mask = np.zeros((self.h, self.w), bool)
        for a, b in zip(pts[:-1], pts[1:]):
            d = b - a
            L2 = float(d @ d)
            t = 0.0 if L2 == 0 else np.clip(
                ((self.X - a[0]) * d[0] + (self.Y - a[1]) * d[1]) / L2, 0, 1)
            mask |= (self.X - a[0] - t * d[0]) ** 2 + \
                (self.Y - a[1] - t * d[1]) ** 2 <= r * r
        self.paint(mask, color)

    def disc(self, c, radius: float, color: str):
        self.paint((self.X - c[0]) ** 2 + (self.Y - c[1]) ** 2
                   <= radius * radius, color)

    def ring(self, c, radius: float, color: str, width_px: float = 1.0):
        d = np.sqrt((self.X - c[0]) ** 2 + (self.Y - c[1]) ** 2)
        self.paint(np.abs(d - radius) <= self.px(width_px / 2 + 0.5), color)

    def cross(self, c, half: float, color: str, width_px: float):
        self.polyline([[c[0] - half, c[1]], [c[0] + half, c[1]]], color,
                      width_px)
        self.polyline([[c[0], c[1] - half], [c[0], c[1] + half]], color,
                      width_px)


def render_topdown(ps, thetas, target_xy, every: int = 20, tol: float = 0.01,
                   size=(240, 320)) -> list[np.ndarray]:
    """Rasterise a logged episode into RGB frames (top-down tray view),
    one every `every` steps: ps (T, 2) tray-frame positions, thetas (T, 2)
    realised tilts. The track is drawn through the positions of the frames
    so far."""
    ps, thetas = np.asarray(ps, float), np.asarray(thetas, float)
    hx, hy = TRAY_HALF
    tx, ty = float(target_xy[0]), float(target_xy[1])
    frames = []
    for k in range(0, len(ps), every):
        cv = _Canvas((-0.25, 0.25), (-0.2, 0.2), size)
        cv.polygon([[-hx, -hy], [hx, -hy], [hx, hy], [-hx, hy]], "#d8d8de",
                   edge="#000000")
        cv.polyline([[0.0, 0.0], [-0.3 * thetas[k, 0], -0.3 * thetas[k, 1]]],
                    "#3366cc", 2.0)
        if k > 0:
            # The track through the drawn frames' positions.
            cv.polyline(np.concatenate([ps[:k:every], ps[k:k + 1]]),
                        "#22aa55", 1.0)
        cv.cross((tx, ty), 0.02, "#ff0000", 1.5)
        cv.ring((tx, ty), tol, "#55aa55")
        cv.disc(ps[k], cv.px(4.0), "#117733")
        frames.append(cv.img)
    return frames


def encode(path: str, frames, fps: int = 25) -> VideoWriterThread:
    """Write `frames` through a `VideoWriterThread` and close it; its
    `frames_written`, `backend` and `out_path` say what was written."""
    w = VideoWriterThread(path, fps=fps)
    for f in frames:
        w.write(f)
    w.close()
    return w


def save_episode_video(path: str, ps, thetas, target_xy, fps: int = 25,
                       every: int = 20) -> int:
    """Render and encode one episode; returns the frames written."""
    return encode(path, render_topdown(ps, thetas, target_xy, every=every),
                  fps).frames_written


def _pinhole(eye, at, up=(0.0, 0.0, 1.0)):
    """JAX's pinhole camera at `eye` looking at `at`: project (..., 3)
    world points to ((..., 2) image-plane points, depth)."""
    eye = np.asarray(eye, float)
    f = np.asarray(at, float) - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, float))
    r /= np.linalg.norm(r)
    u = np.cross(r, f)

    def project(P):
        d = np.asarray(P, float) - eye
        z = d @ f
        return np.stack([d @ r / z, d @ u / z], axis=-1), z

    return project


def _tilt_rot(theta):
    """World rotation of the tray for tilt [tx, ty] (observe_world
    convention: R = Ry(-tx) @ Rx(ty))."""
    tx, ty = float(theta[0]), float(theta[1])
    cx, sx = np.cos(-tx), np.sin(-tx)
    cy, sy = np.cos(ty), np.sin(ty)
    Ry = np.array([[cx, 0, sx], [0, 1, 0], [-sx, 0, cx]])
    Rx = np.array([[1, 0, 0], [0, cy, -sy], [0, sy, cy]])
    return Ry @ Rx


def arm_points(scene, qLs: torch.Tensor, qRs: torch.Tensor):
    """World points of each chain for frames of joints (F, 7): the 8
    bodies of `chain.fk` and the tool point (`full_stack.EE_OFFSET` along
    the last body's z), each (F, 9, 3) as numpy. One batched FK per chain
    on the joints' device."""
    from dart_tpu_torch.physics import chain as chain_mod
    from dart_tpu_torch.rollout.full_stack import EE_OFFSET

    out = []
    with torch.no_grad():
        for params, q in ((scene.left, qLs), (scene.right, qRs)):
            f = chain_mod.fk(params, q.to(params.base_pos.dtype))
            off = torch.tensor(EE_OFFSET, dtype=f.p.dtype, device=f.p.device)
            tool = f.p[..., -1, :] + (f.R[..., -1, :, :] @ off)
            out.append(torch.cat([f.p, tool[..., None, :]], -2).cpu()
                       .double().numpy())
    return out[0], out[1]


def scene_geometry(qLs, qRs, ps, thetas, target_xy, scene=None,
                   every: int = 20, tray_pos=(0.0, 0.0, 0.4),
                   eye=(1.1, -1.3, 1.05)) -> list[dict]:
    """What `render_scene` draws in each frame, one every `every` steps,
    in image-plane coordinates: `tray` (4, 2) corners, `target` (2,),
    `object` (2,), `left`/`right` (10, 2) polylines base -> 8 bodies ->
    tool, and the step `k`. qLs/qRs (T, 7) tensors of joints
    (`run_full_stack(record_joints=True)`), ps/thetas (T, 2). `scene`
    defaults to `rollout.full_stack.make_scene()` on the joints' device."""
    if scene is None:
        from dart_tpu_torch.rollout.full_stack import make_scene
        scene = make_scene(device=qLs.device)
    ps, thetas = np.asarray(ps, float), np.asarray(thetas, float)
    tray_pos = np.asarray(tray_pos, float)
    idx = np.arange(0, len(ps), every)
    sel = torch.as_tensor(idx, device=qLs.device)
    jL, jR = arm_points(scene, qLs[sel], qRs[sel])
    bases = [scene.left.base_pos.cpu().double().numpy(),
             scene.right.base_pos.cpu().double().numpy()]
    project = _pinhole(eye, at=tray_pos)
    hx, hy = TRAY_HALF
    corners = np.array([[-hx, -hy, 0], [hx, -hy, 0], [hx, hy, 0],
                        [-hx, hy, 0]])
    out = []
    for fi, k in enumerate(idx):
        R = _tilt_rot(thetas[k])
        geo = {"k": int(k), "tray": project(corners @ R.T + tray_pos)[0]}
        for name, xy in (("target", target_xy), ("object", ps[k])):
            P = R @ np.array([xy[0], xy[1], 0.03]) + tray_pos
            geo[name] = project(P[None])[0][0]
        for name, base, J in (("left", bases[0], jL[fi]),
                              ("right", bases[1], jR[fi])):
            geo[name] = project(np.concatenate([base[None], J]))[0]
        out.append(geo)
    return out


def render_scene(qLs, qRs, ps, thetas, target_xy, scene=None,
                 every: int = 20, tray_pos=(0.0, 0.0, 0.4),
                 eye=(1.1, -1.3, 1.05), size=(320, 400)) -> list[np.ndarray]:
    """Rasterise a full-stack episode into scene-true RGB frames
    (`scene_geometry` drawn): the tray polygon, the target mark, the
    object, and each arm as a thick polyline with its joints as dots."""
    frames = []
    for geo in scene_geometry(qLs, qRs, ps, thetas, target_xy, scene,
                              every, tray_pos, eye):
        cv = _Canvas((-0.45, 0.45), (-0.32, 0.38), size)
        cv.polygon(geo["tray"], "#d8d8de", edge="#000000")
        for name, color in (("left", "#3366cc"), ("right", "#cc7722")):
            cv.polyline(geo[name], color, 3.0)
            for p in geo[name][1:]:
                cv.disc(p, cv.px(2.5), color)
        cv.cross(geo["target"], cv.px(6.0), "#ff0000", 2.0)
        cv.disc(geo["object"], cv.px(5.0), "#117733")
        frames.append(cv.img)
    return frames


def save_scene_video(path: str, qLs, qRs, ps, thetas, target_xy,
                     fps: int = 25, every: int = 20, **kw) -> int:
    """Scene-true episode video (arms + tray + object); returns the frames
    written."""
    return encode(path, render_scene(qLs, qRs, ps, thetas, target_xy,
                                     every=every, **kw), fps).frames_written
