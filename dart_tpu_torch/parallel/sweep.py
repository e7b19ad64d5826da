"""Scenario sweeps on one device (port of `dart_tpu.parallel.sweep`'s
`run_sweep` and `run_sweep_batched` on a one-device mesh).

The batch runs through one evaluator call with the rows as lanes, padded
to a lane multiple where the whole-solve kernels want their grid, and the
aggregate is taken under the `valid` mask as JAX's `shard_map` body takes
it, with a sum where JAX has a `psum` over the mesh.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from dart_tpu_torch.io.scenes import ScenarioBatch, pad_to_multiple


class SweepAggregate(NamedTuple):
    n: torch.Tensor
    n_converged: torch.Tensor
    mean_sse: torch.Tensor          # mean steady-state error
    mean_effort: torch.Tensor
    mean_conv_time: torch.Tensor    # over converged episodes only


def _rows(tree, n: int):
    """The first n rows of every tensor leaf (nested tuples recurse)."""
    if isinstance(tree, tuple):
        return type(tree)(*(_rows(x, n) for x in tree))
    return tree[:n] if isinstance(tree, torch.Tensor) else tree


def run_sweep_batched(evaluate_batch: Callable, batch: ScenarioBatch,
                      lane_multiple: int = 128):
    """Batch-major sweep: the whole batch, padded to `lane_multiple` rows
    (128 keeps the whole-solve kernels' grid), through one call of
    `evaluate_batch(kappa_inv (B,2), mass (B,), mu (B,), target_xy (B,2))
    -> PMPCScenarioResult` (e.g. `make_rmpc_batch_evaluator`). Returns
    (per-scenario result with the padding rows removed, SweepAggregate)."""
    padded, n_real = pad_to_multiple(batch, lane_multiple)
    valid = (torch.arange(padded.size, device=batch.mass.device)
             < n_real).to(batch.mass.dtype)
    res = evaluate_batch(padded.kappa_inv, padded.mass, padded.mu,
                         padded.target_xy)
    m = res.metrics
    conv = m.converged.to(valid.dtype) * valid
    n = torch.sum(valid)
    n_conv = torch.sum(conv)
    agg = SweepAggregate(
        n=n,
        n_converged=n_conv,
        mean_sse=torch.sum(m.steady_state_error * valid) / n,
        mean_effort=torch.sum(m.control_effort * valid) / n,
        mean_conv_time=torch.sum(torch.where(
            conv > 0, m.convergence_time,
            torch.zeros_like(m.convergence_time)))
        / torch.clamp(n_conv, min=1.0),
    )
    return _rows(res, n_real), agg


def run_sweep(evaluate: Callable, batch: ScenarioBatch):
    """Per-scenario sweep: every row a lane of one call of a per-scenario
    evaluator (e.g. `make_pmpc_evaluator`), as JAX vmaps its episodes on
    each device; no padding (JAX pads to the device count, one here).
    Returns (per-scenario result, SweepAggregate)."""
    return run_sweep_batched(evaluate, batch, lane_multiple=1)
