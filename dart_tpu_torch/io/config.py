"""Single typed configuration — replaces the six duplicated param dicts and
`config_examples.py` of the reference (SURVEY.md sections 2.8, 5.6). The
port's own copy of `dart_tpu.io.config`, pure dataclasses.

Dataclasses (not dicts) so every experiment setting is named, typed, and
defaulted once; presets mirror `PMPC/config_examples.py:9-49`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    max_iters: int = 10
    al_iters: int = 5
    n_alphas: int = 11
    tol_step: float = 1e-7


@dataclasses.dataclass(frozen=True)
class PMPCConfig:
    N: int = 15
    dt: float = 0.01            # control period (solve cadence)
    sim_dt: float = 0.002       # plant cadence (reference 2 ms)
    u_bound: float = 0.6
    Qp: float = 300.0
    Qv: float = 2.0
    R: float = 0.2
    mu: float = 0.1
    solver: SolverConfig = SolverConfig()


@dataclasses.dataclass(frozen=True)
class RMPCConfig:
    N: int = 20
    dt: float = 0.01
    sim_dt: float = 0.002
    u_bound: float = 0.4
    du_bound: float = 0.05
    vmax: float = 0.25
    v_eps: float = 0.1
    Qp: float = 100.0
    Qv: float = 1.0
    Ru: float = 0.05
    Rdu: float = 1.0
    rls_lam: float = 0.995
    rls_P0: float = 1e3
    dr_max: float = 0.01
    rg_alpha: float = 0.5
    step_fraction: float = 0.2
    slew_exact: bool = True
    solver: SolverConfig = SolverConfig()


@dataclasses.dataclass(frozen=True)
class LMPCConfig:
    N: int = 20
    dt: float = 0.01
    sim_dt: float = 0.002
    u_bound: float = 0.4
    Q: Tuple[float, ...] = (200.0, 2.0, 200.0, 2.0, 0, 0, 0, 0)
    Qt: Tuple[float, ...] = (200.0, 2.0, 200.0, 2.0, 0, 0, 0, 0)
    R: Tuple[float, ...] = (0.1, 0.1, 1.0, 1.0)
    max_param_abs: float = 2.0
    max_delta_abs: float = 0.02
    rollout_len: int = 256
    n_envs: int = 8
    lr: float = 3e-4
    epochs: int = 8
    minibatch_size: int = 64
    gamma: float = 0.99
    gae_lambda: float = 0.95
    checkpoint_dir: str = "checkpoints/general"
    solver: SolverConfig = SolverConfig()


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    object_name: str = "cube"
    mass: float = 1.0
    friction: float = 0.1
    target: Tuple[float, float] = (0.05, -0.04)
    runtime: float = 10.0       # seconds of sim time
    tolerance: float = 0.01
    warmup: float = 0.5         # settle phase seconds (reference: 2 s + 3 s)
    log_dir: Optional[str] = None


# Named presets, mirroring `PMPC/config_examples.py` experiment set.
PRESETS = {
    "cube_precise": ExperimentConfig(object_name="cube", mass=1.0,
                                     friction=0.1, target=(0.08, 0.06),
                                     tolerance=0.003),
    "cylinder_fast": ExperimentConfig(object_name="cylinder", mass=1.0,
                                      friction=0.05, target=(0.1, -0.05),
                                      tolerance=0.01),
    "sphere_gentle": ExperimentConfig(object_name="sphere", mass=2.0,
                                      friction=0.2, target=(-0.06, -0.08),
                                      tolerance=0.015),
    "heavy_object": ExperimentConfig(object_name="cube", mass=2.0,
                                     friction=0.2, target=(0.05, 0.05),
                                     tolerance=0.01),
}
