"""Carry state between the JAX package and the port.

The PMPC, RMPC and LMPC batch paths have no trained weights: what crosses
over are the tuning tables, the per-lane params and cost data, the carries
(the RLS estimates, the governor's reference, the stiction integral and
the LMPC plan index included), the solve diagnostics, the contact plant's
params and state (its bool `toppled` stays bool), the scenario batches and
the evaluators' metrics and sweep aggregates, all NamedTuples
with the same names and fields in both packages; NamedTuples nest
(`RMPCCarry` holds two `RLSState`s). Arrays cross as numpy; python floats
stay python floats (so a static gravity stays static), and None stays
None.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dart_tpu_torch.adapt.rls import RLSState
from dart_tpu_torch.control.mpc import (LMPCCarry, LMPCWeights, PMPCCarry,
                                        PMPCWeights, RMPCCarry, RMPCWeights,
                                        SolveDiag)
from dart_tpu_torch.io.scenes import ScenarioBatch
from dart_tpu_torch.models.dynamics import PMPCParams, RMPCParams
from dart_tpu_torch.parallel.sweep import SweepAggregate
from dart_tpu_torch.physics.tray_object import (TrayObjectParams,
                                                TrayObjectState)
from dart_tpu_torch.rollout.evaluate import PMPCScenarioResult
from dart_tpu_torch.rollout.metrics import Metrics
from dart_tpu_torch.solver.ilqr import ILQRSolution
from dart_tpu_torch.solver.ocp import LMPCAux, PMPCAux, RMPCAux

_TUPLES = {cls.__name__: cls for cls in
           (PMPCParams, PMPCAux, PMPCWeights, PMPCCarry, SolveDiag,
            RMPCParams, RMPCAux, RMPCWeights, RMPCCarry, RLSState,
            ILQRSolution, LMPCAux, LMPCWeights, LMPCCarry,
            TrayObjectParams, TrayObjectState, Metrics, ScenarioBatch,
            PMPCScenarioResult, SweepAggregate)}


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
        return _TUPLES[name](*(from_jax(leaf, device, dtype)
                               for leaf in tree))
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
