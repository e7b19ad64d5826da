"""Carry state between the JAX package and the port.

The PMPC, RMPC and LMPC batch paths have no trained weights: what crosses
over are the tuning tables, the per-lane params and cost data, the carries
(the RLS estimates, the governor's reference, the stiction integral and
the LMPC plan index included), the solve diagnostics, the contact plant's
params and state (its bool `toppled` stays bool), the scenario batches and
the evaluators' metrics and sweep aggregates, the closed-loop results,
the trainers' Welford statistics, env states, transitions, PPO
batches and replay buffers, and the dual-arm world's chains, controller
gains and carries, dynamics snapshots, scenes and world states, all
NamedTuples with the same names and
fields in both packages; NamedTuples nest (`RMPCCarry` holds two
`RLSState`s). The env states' `rng` key has no counterpart: the port
draws from a `torch.Generator`. Arrays cross as numpy; python floats stay
python floats (so a static gravity stays static), and None stays None.

The trained policy crosses as a flax parameter tree (`actor_critic_state
_dict`) and optax's Adam moments (`adam_state_dict`), each a dict that
the port's `ActorCritic` and `AdamW` load; a learned dynamics network
crosses as its flax `DynamicsMLP` tree through the same converter, which
the port's `DynamicsMLP` loads.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dart_tpu_torch.adapt.lmpc_fullstack import FSEnvState
from dart_tpu_torch.adapt.lmpc_lagplant import LagEnvState
from dart_tpu_torch.adapt.lmpc_trainer import LMPCEnvState, Transition
from dart_tpu_torch.adapt.ppo import Batch, ReplayBuffer, WelfordState
from dart_tpu_torch.adapt.rls import RLSState
from dart_tpu_torch.control.arm import ArmCarry, ArmDynamics, ArmParams
from dart_tpu_torch.control.mpc import (LMPCCarry, LMPCWeights, PMPCCarry,
                                        PMPCWeights, RMPCCarry, RMPCWeights,
                                        SolveDiag)
from dart_tpu_torch.control.opspace import OpspaceCarry, OpspaceParams
from dart_tpu_torch.io.scenes import ScenarioBatch
from dart_tpu_torch.models.dynamics import PMPCParams, RMPCParams
from dart_tpu_torch.parallel.sweep import SweepAggregate
from dart_tpu_torch.physics.chain import ChainParams
from dart_tpu_torch.physics.tray_object import (TrayObjectParams,
                                                TrayObjectState)
from dart_tpu_torch.rollout.evaluate import PMPCScenarioResult
from dart_tpu_torch.rollout.full_stack import DualArmScene, FullState
from dart_tpu_torch.rollout.loop import ClosedLoopResult
from dart_tpu_torch.rollout.metrics import Metrics
from dart_tpu_torch.solver.ilqr import ILQRSolution
from dart_tpu_torch.solver.ocp import LMPCAux, PMPCAux, RMPCAux

_TUPLES = {cls.__name__: cls for cls in
           (PMPCParams, PMPCAux, PMPCWeights, PMPCCarry, SolveDiag,
            RMPCParams, RMPCAux, RMPCWeights, RMPCCarry, RLSState,
            ILQRSolution, LMPCAux, LMPCWeights, LMPCCarry,
            TrayObjectParams, TrayObjectState, Metrics, ScenarioBatch,
            PMPCScenarioResult, SweepAggregate, ClosedLoopResult,
            WelfordState, LMPCEnvState, LagEnvState, Transition, Batch,
            ReplayBuffer, ChainParams, ArmParams, ArmDynamics, ArmCarry,
            DualArmScene, FullState, OpspaceParams, OpspaceCarry,
            FSEnvState)}
# JAX fields the port draws from a generator instead of carrying.
_DROPPED = {"rng"}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def from_jax(tree: Any, device: torch.device | str,
             dtype: torch.dtype | None = None) -> Any:
    """A JAX-side NamedTuple (leaves numpy/JAX arrays or python scalars) ->
    the port's NamedTuple of the same name, with tensors on `device`.
    Floating arrays take `dtype` when given; integer and bool arrays keep
    theirs."""
    if _is_namedtuple(tree):
        name = type(tree).__name__
        if name not in _TUPLES:
            raise TypeError(f"no port counterpart for NamedTuple {name}")
        cls = _TUPLES[name]
        extra = set(tree._fields) - set(cls._fields) - _DROPPED
        if extra:
            raise TypeError(f"{name}: fields {sorted(extra)} have no "
                            "counterpart in the port")
        return cls(**{f: from_jax(getattr(tree, f), device, dtype)
                      for f in cls._fields})
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    t = torch.tensor(np.asarray(tree), device=device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def to_numpy(tree: Any) -> Any:
    """The port's NamedTuple (or a tensor) -> the same with numpy arrays;
    python scalars stay as they are."""
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(leaf) for leaf in tree))
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def actor_critic_state_dict(params: dict) -> dict:
    """A flax parameter tree of Dense layers and plain leaves
    ({"params": {...}} or its inner dict; numpy or JAX leaves) -> the
    state dict of the port's module with the same names: `ActorCritic`,
    or `models.neural.DynamicsMLP` (Dense_0 .. Dense_n). A Dense `kernel`
    (in, out) becomes a Linear `weight` (out, in), bias and `log_std`
    cross as they are, every value keeps its type."""
    tree = params.get("params", params)
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[f"{name}.weight"] = torch.tensor(np.asarray(leaf["kernel"]).T)
            out[f"{name}.bias"] = torch.tensor(np.asarray(leaf["bias"]))
        else:
            out[name] = torch.tensor(np.asarray(leaf))
    return out


def _adam_moments(opt_state):
    """The optax `ScaleByAdamState` (count, mu, nu) inside a chain's
    state."""
    if _is_namedtuple(opt_state) and opt_state._fields == ("count", "mu",
                                                            "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam_moments(s)
            if found is not None:
                return found
    return None


def adam_state_dict(opt_state, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> dict:
    """optax's `chain(clip_by_global_norm, adamw)` state -> a state dict of
    the port's `AdamW` over `model`'s parameters (`optimizer` built on
    `model.parameters()`): count -> `step`, mu -> `exp_avg`, nu ->
    `exp_avg_sq`, the kernels transposed as the weights are."""
    adam = _adam_moments(opt_state)
    if adam is None:
        raise TypeError("no optax ScaleByAdamState in the optimizer state")
    mu = actor_critic_state_dict(adam.mu)
    nu = actor_critic_state_dict(adam.nu)
    sd = optimizer.state_dict()
    names = [n for n, _ in model.named_parameters()]
    if sorted(names) != sorted(mu) or len(sd["param_groups"]) != 1 \
            or len(sd["param_groups"][0]["params"]) != len(names):
        raise ValueError(f"moments {sorted(mu)} do not match the "
                         f"parameters {names}")
    step = torch.tensor(float(np.asarray(adam.count)))
    sd["state"] = {i: {"step": step.clone(), "exp_avg": mu[n],
                       "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    return sd
