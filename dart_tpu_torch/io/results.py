"""Post-hoc results analysis, the `LMPC/src/results.py` equivalent (port of
`dart_tpu.io.results`): per-episode statistics of the `EpisodicNpy` store,
comparison plots, the sweep's per-object summary, and the reference's env
naming convention `<object>_<mass>_<friction>` with `x` as the decimal
separator, e.g. `sphere_0x2_0x1` (`results.py:9-19`)."""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from dart_tpu_torch.io.logging import EpisodicNpy


def env_name(object_name: str, mass: float, friction: float) -> str:
    """`cube_1x0_0x05`-style naming (`results.py:16-19`)."""
    def fmt(v):
        return str(float(v)).replace(".", "x")

    return f"{object_name}_{fmt(mass)}_{fmt(friction)}"


def parse_env_name(name: str):
    obj, mass, fric = name.split("_", 2)

    def back(s):
        return float(s.replace("x", "."))

    return obj, back(mass), back(fric)


def episode_stats(store: EpisodicNpy, metric: str) -> Dict[str, np.ndarray]:
    """Per-episode minima, means and final values of one metric
    (`results.py:24-63`)."""
    eps = store.load(metric)
    return {
        "lowest": np.asarray([np.min(e) for e in eps]),
        "average": np.asarray([np.mean(e) for e in eps]),
        "final": np.asarray([np.asarray(e).reshape(len(e), -1)[-1]
                             for e in eps]),
        "episodes": len(eps),
    }


def plot_metric(stores: Dict[str, EpisodicNpy], metric: str, out_path: str,
                ylabel: str | None = None):
    """Per-episode curves of one metric across several envs in one figure
    (matplotlib, imported here: only this function needs it)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    for env, store in stores.items():
        for i, ep in enumerate(store.load(metric)):
            arr = np.asarray(ep)
            if arr.ndim > 1:
                arr = np.linalg.norm(arr, axis=-1)
            ax.plot(arr, alpha=0.6, label=env if i == 0 else None)
    ax.set_xlabel("step")
    ax.set_ylabel(ylabel or metric)
    ax.legend(fontsize=7)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def summarize_sweep(rows: Sequence[dict]) -> Dict[str, dict]:
    """Group the sweep command's scenario rows by object: the qualitative
    comparison table of the reference README (`README.md:114-125`)."""
    out: Dict[str, dict] = {}
    for r in rows:
        g = out.setdefault(r["object"], {"n": 0, "converged": 0,
                                         "sse_mm": [], "conv_time_s": [],
                                         "effort": []})
        g["n"] += 1
        g["converged"] += int(r["converged"])
        g["sse_mm"].append(r["sse_mm"])
        if np.isfinite(r["conv_time_s"]):
            g["conv_time_s"].append(r["conv_time_s"])
        g["effort"].append(r["effort"])
    for g in out.values():
        g["success_rate"] = g["converged"] / g["n"]
        g["mean_sse_mm"] = float(np.mean(g.pop("sse_mm")))
        ct = g.pop("conv_time_s")
        g["mean_conv_time_s"] = float(np.mean(ct)) if ct else float("inf")
        g["mean_effort"] = float(np.mean(g.pop("effort")))
    return out
