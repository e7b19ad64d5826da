"""JSON output helpers and the episode logs (the parts of
`dart_tpu.io.logging` the commands use): `to_jsonable`, the RMPC JSON
episode format with NaN -> null and its descriptive file names
(`RMPC/dev_dual/rob_ctrl.py:52-86, 222-226`), and the LMPC episodic
`.npy` store (`EpisodicNpy`, `analyitics.py:46-77`)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List

import numpy as np


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
