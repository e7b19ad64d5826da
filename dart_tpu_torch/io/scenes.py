"""Scenario batches for the tray-object plant (port of
`dart_tpu.io.scenes`): each row is one scene, its object's shape, mass,
friction and rolling factors and its tray-relative target.

The canonical evaluation grid: {cube, cylinder, sphere} x {1, 2 kg} x
{mu 0.05, 0.1, 0.2} = 18 configs (`README.md:101-105`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dart_tpu_torch.physics.tray_object import _KAPPA_INV, SHAPES
from dart_tpu_torch.utils.device import resolve

SHAPE_IDS = {name: i for i, name in enumerate(SHAPES)}

MASSES_18 = (1.0, 2.0)
FRICTIONS_18 = (0.05, 0.1, 0.2)


class ScenarioBatch(NamedTuple):
    """A batch of tray-object scenarios (all leaves have leading batch dim)."""

    shape_id: torch.Tensor     # (B,) int32: 0 cube, 1 cylinder, 2 sphere
    mass: torch.Tensor         # (B,)
    mu: torch.Tensor           # (B,)
    kappa_inv: torch.Tensor    # (B, 2)
    target_xy: torch.Tensor    # (B, 2) tray-relative target

    @property
    def size(self) -> int:
        return self.shape_id.shape[0]


def _batch(sid, mass, mu, kinv, txy, dtype, device) -> ScenarioBatch:
    dev = resolve(device)

    def f(x):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    return ScenarioBatch(
        shape_id=torch.as_tensor(np.asarray(sid, np.int32), device=dev),
        mass=f(mass), mu=f(mu), kappa_inv=f(kinv), target_xy=f(txy))


def sweep_grid(targets=((0.05, -0.04),), dtype=torch.float32,
               device: torch.device | str = "cuda") -> ScenarioBatch:
    """The full 18-config grid x requested targets."""
    rows = []
    for shape in SHAPES:
        for mass in MASSES_18:
            for mu in FRICTIONS_18:
                for t in targets:
                    rows.append((SHAPE_IDS[shape], mass, mu,
                                 _KAPPA_INV[shape], t))
    sid, mass, mu, kinv, txy = zip(*rows)
    return _batch(sid, mass, mu, kinv, txy, dtype, device)


def pad_to_multiple(batch: ScenarioBatch,
                    multiple: int) -> tuple[ScenarioBatch, int]:
    """Pad a batch (repeating the last row) to a multiple of `multiple`
    rows. Returns (padded batch, original size)."""
    n = batch.size
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    return ScenarioBatch(*(torch.cat([x, x[-1:].expand(rem, *x.shape[1:])])
                           for x in batch)), n


def random_scenarios(rng: np.random.Generator, B: int, dtype=torch.float32,
                     device: torch.device | str = "cuda") -> ScenarioBatch:
    """Uniformly random scenarios over the evaluation envelope, drawn with
    the JAX package's generator calls in its order, so a seed gives the
    same rows."""
    resolve(device)   # before drawing: a refused call leaves rng as it was
    sid = rng.integers(0, 3, size=B)
    kinv = np.asarray([_KAPPA_INV[SHAPES[i]] for i in sid])
    mass = rng.uniform(0.5, 3.0, B)
    mu = rng.uniform(0.05, 0.2, B)
    txy = rng.uniform(-0.1, 0.1, (B, 2))
    return _batch(sid, mass, mu, kinv, txy, dtype, device)
