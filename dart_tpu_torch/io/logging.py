"""JSON output helpers and the episode logs (port of
`dart_tpu.io.logging`): `to_jsonable`, the RMPC JSON episode format with
NaN -> null and its descriptive file names (`RMPC/dev_dual/rob_ctrl.py:
52-86, 222-226`), the 17-channel PMPC npz archive (`EpisodeLog`,
`PMPC/src/logger.py:90-192`) and the LMPC episodic `.npy` store
(`EpisodicNpy`, `analyitics.py:46-77`). Host-side writers, fed with
whole trajectories after the loop ends."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List

import numpy as np

# The 17 channels of the PMPC AsyncLogger (`logger.py:90-111`).
CHANNELS_17 = (
    "t", "X", "X_target", "U_cmd", "quat_tray", "loss", "solve_time",
    "L_torques", "R_torques", "L_qpos", "R_qpos", "L_qvel", "R_qvel",
    "L_ee_pos", "R_ee_pos", "L_ee_vel", "R_ee_vel",
)


def to_jsonable(x):
    """NumPy -> JSON sanitiser, NaN and inf -> null (`rob_ctrl.py:52-68`)."""
    if isinstance(x, dict):
        return {k: to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return to_jsonable(x.tolist())
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (np.floating, float)):
        xf = float(x)
        return None if np.isnan(xf) or np.isinf(xf) else xf
    if isinstance(x, (np.integer, int)):
        return int(x)
    return x


def episode_json_name(object_name: str, mass: float, mu: tuple,
                      target_xy) -> str:
    """`{object}_m{mass}_mu{t}-{tors}-{roll}_tx{..}_ty{..}.json`
    (`rob_ctrl.py:222-226`)."""
    t, tors, roll = mu
    return (f"{object_name}_m{mass}_mu{t}-{tors}-{roll}"
            f"_tx{float(target_xy[0])}_ty{float(target_xy[1])}.json")


def save_episodes_json(path: str, episodes: List[dict]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_jsonable(episodes), f)


def load_episodes_json(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)


class EpisodeLog:
    """Accumulates per-step channel data; saves the reference npz schema."""

    def __init__(self):
        self.data: Dict[str, List[np.ndarray]] = {c: [] for c in CHANNELS_17}

    def log(self, **channels):
        for k, v in channels.items():
            if k not in self.data:
                raise KeyError(f"unknown channel {k}")
            self.data[k].append(np.asarray(v))

    def log_arrays(self, **channels):
        """Bulk-append whole trajectories (a step per leading row)."""
        for k, v in channels.items():
            if k not in self.data:
                raise KeyError(f"unknown channel {k}")
            self.data[k].extend(np.asarray(v))

    def compute_metrics(self, target_xy, tol: float = 0.01):
        """steady-state error / convergence time / control effort
        (`logger.py:154-176`)."""
        X = np.stack(self.data["X"])
        t = np.stack(self.data["t"])
        U = np.stack(self.data["U_cmd"])
        err = np.linalg.norm(X[:, [0, 2]] - np.asarray(target_xy), axis=1)
        below = err < tol
        conv_time = float(t[np.argmax(below)]) if below.any() else float("inf")
        dt = float(np.mean(np.diff(t))) if len(t) > 1 else 0.0
        effort = float(np.sum(np.linalg.norm(U, axis=1)) * dt)
        return {
            "steady_state_error": float(err[-1]),
            "convergence_time": conv_time,
            "control_effort": effort,
        }

    def save_npz(self, root: str, object_name: str, mass: float,
                 friction: float, target_xy, tol: float = 0.01) -> str:
        """`{root}/{object}/mass=..._friction=.../mpc_target_..._{ts}.npz`
        (`logger.py:179-192`)."""
        d = os.path.join(root, object_name,
                         f"mass={mass}_friction={friction}")
        os.makedirs(d, exist_ok=True)
        ts = time.strftime("%Y%m%d_%H%M%S")
        tx, ty = float(target_xy[0]), float(target_xy[1])
        path = os.path.join(d, f"mpc_target_{tx}_{ty}_{ts}.npz")
        arrays = {k: np.stack(v) for k, v in self.data.items() if v}
        arrays.update({k: np.asarray(v) for k, v in
                       self.compute_metrics(target_xy, tol).items()})
        np.savez(path, **arrays)
        return path


class EpisodicNpy:
    """LMPC-style episodic logger: one pickle .npy holding a dict
    {timestamp: {metric: array}} that grows across save() calls
    (`analyitics.py:46-77`)."""

    def __init__(self, fpath: str):
        self.fpath = fpath
        self.buffer: Dict[str, List[Any]] = {}

    def log(self, metric: str, value):
        self.buffer.setdefault(metric, []).append(np.asarray(value))

    def save(self):
        os.makedirs(os.path.dirname(self.fpath) or ".", exist_ok=True)
        store = {}
        if os.path.exists(self.fpath):
            store = np.load(self.fpath, allow_pickle=True).item()
        snap = {k: np.stack(v) if len(v) and np.ndim(v[0]) else np.asarray(v)
                for k, v in self.buffer.items()}
        store[str(time.time())] = snap
        np.save(self.fpath, store, allow_pickle=True)
        self.buffer = {}

    def load(self, metric: str):
        """Per-episode arrays for one metric id (`analyitics.py:62-77`)."""
        store = np.load(self.fpath, allow_pickle=True).item()
        return [ep[metric] for ep in store.values() if metric in ep]
