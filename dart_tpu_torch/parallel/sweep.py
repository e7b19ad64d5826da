"""Scenario sweeps over a rank mesh (port of `dart_tpu.parallel.sweep`).

JAX shards the scenario batch over a mesh axis inside one program
(`shard_map`, a `psum` at the aggregate). Here each rank of a `Mesh`
(`parallel/mesh.py`, one process a device under `torchrun`) pads the
batch, takes its contiguous block of rows, runs its one evaluator call
with the rows as lanes, and reduces: one `all_reduce` of the five masked
sums, one `all_gather` of the per-row results, so that every rank returns
the global rows and aggregate. The episode body has no collective. A
controller that escalates while any lane of its call needs help does so
per rank, as JAX's does per device: a k-rank sweep equals k one-rank
calls on the ranks' blocks. `mesh=None` runs the whole batch as one call
on its device, with no collective.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from dart_tpu_torch.io.scenes import ScenarioBatch, pad_to_multiple
from dart_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401


# torch's element types by the profiler's names for them (C++'s, as
# `record_shapes` gives them; "" for an argument that is no tensor).
_PROFILER_DTYPES = {
    "float": torch.float32, "double": torch.float64,
    "c10::Half": torch.float16, "c10::BFloat16": torch.bfloat16,
    "signed char": torch.int8, "unsigned char": torch.uint8,
    "short int": torch.int16, "int": torch.int32, "long int": torch.int64,
    "bool": torch.bool, "c10::complex<float>": torch.complex64,
    "c10::complex<double>": torch.complex128}


class SweepAggregate(NamedTuple):
    n: torch.Tensor
    n_converged: torch.Tensor
    mean_sse: torch.Tensor          # mean steady-state error
    mean_effort: torch.Tensor
    mean_conv_time: torch.Tensor    # over converged episodes only


def _map_rows(fn, tree):
    """`fn` on every tensor leaf (nested NamedTuples recurse)."""
    if isinstance(tree, tuple):
        return type(tree)(*(_map_rows(fn, x) for x in tree))
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _gather_rows(res, mesh: Mesh):
    """Every rank's rows of `res`, in rank order, on every rank: the leaves
    packed as float64 columns of one (rows, width) tensor, which carries
    float32, float64, bool and int32 values exactly, through one
    `all_gather`."""
    leaves = _leaves(res)
    per = leaves[0].shape[0]
    packed = torch.cat([x.reshape(per, -1).to(torch.float64)
                        for x in leaves], 1)
    parts = [torch.empty_like(packed) for _ in range(mesh.size)]
    dist.all_gather(parts, packed, group=mesh.group)
    packed = torch.cat(parts)
    cols = iter(torch.split(packed, [x[0].numel() for x in leaves], 1))
    return _map_rows(lambda x: next(cols).reshape(-1, *x.shape[1:])
                     .to(x.dtype), res)


def _run(eval_shard: Callable, batch: ScenarioBatch, mesh: Mesh | None,
         lane_multiple: int):
    """Pad `batch` to `mesh.size * lane_multiple` rows, evaluate this
    rank's block `[rank*per, (rank+1)*per)` under the `valid` mask, and
    reduce. Returns (the first `batch.size` global rows, SweepAggregate)."""
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    padded, n_real = pad_to_multiple(batch, size * lane_multiple)
    per = padded.size // size
    rows = slice(rank * per, (rank + 1) * per)
    valid = (torch.arange(padded.size, device=batch.mass.device)
             < n_real).to(batch.mass.dtype)[rows]
    res = eval_shard(ScenarioBatch(*(x[rows] for x in padded)))
    m = res.metrics
    conv = m.converged.to(valid.dtype) * valid
    sums = torch.stack([
        torch.sum(valid), torch.sum(conv),
        torch.sum(m.steady_state_error * valid),
        torch.sum(m.control_effort * valid),
        torch.sum(torch.where(conv > 0, m.convergence_time,
                              torch.zeros_like(m.convergence_time)))])
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(sums, group=mesh.group)
        res = _gather_rows(res, mesh)
    n, n_conv, sse, effort, conv_time = sums
    agg = SweepAggregate(n=n, n_converged=n_conv, mean_sse=sse / n,
                         mean_effort=effort / n,
                         mean_conv_time=conv_time
                         / torch.clamp(n_conv, min=1.0))
    return _map_rows(lambda x: x[:n_real], res), agg


def run_sweep_batched(evaluate_batch: Callable, batch: ScenarioBatch,
                      mesh: Mesh | None = None, lane_multiple: int = 128):
    """Batch-major sweep: each rank's block of the batch, padded to
    `mesh.size * lane_multiple` rows (128 keeps the whole-solve kernels'
    grid), through one call of `evaluate_batch(kappa_inv (B,2), mass (B,),
    mu (B,), target_xy (B,2)) -> PMPCScenarioResult` (e.g.
    `make_rmpc_batch_evaluator`). Returns (per-scenario result with the
    padding rows removed, SweepAggregate), the same on every rank."""
    return _run(lambda s: evaluate_batch(s.kappa_inv, s.mass, s.mu,
                                         s.target_xy),
                batch, mesh, lane_multiple)


def run_sweep(evaluate: Callable, batch: ScenarioBatch,
              mesh: Mesh | None = None):
    """Per-scenario sweep: each rank's rows the lanes of one call of a
    per-scenario evaluator (e.g. `make_pmpc_evaluator`), as JAX vmaps its
    episodes on each device; padded to the mesh's size only. Returns
    (per-scenario result, SweepAggregate)."""
    return run_sweep_batched(evaluate, batch, mesh, lane_multiple=1)


def _element_size(profiler_dtype: str) -> int:
    if profiler_dtype not in _PROFILER_DTYPES:
        raise ValueError(f"sweep_collectives: a collective carried elements "
                         f"of {profiler_dtype!r}, a type it cannot size")
    return _PROFILER_DTYPES[profiler_dtype].itemsize


def sweep_collectives(evaluate: Callable, batch: ScenarioBatch, mesh: Mesh,
                      lane_multiple: int = 1) -> dict:
    """The collective census of one sharded sweep (the counterpart of JAX's
    `sweep_hlo`, whose optimized HLO `tools/bench_scaling.py` counts):
    `run_sweep_batched` under torch.profiler, returning every collective
    the process group's backend ran, by kind, as {kind: {"count": n,
    "bytes": b}}, the bytes this rank sent. The scenario axis is pure data
    parallelism, so the census must be the aggregate's one all_reduce and
    the rows' one all_gather at every world size and episode length."""
    from torch.profiler import ProfilerActivity, profile

    prefix = f"{dist.get_backend(mesh.group)}:"
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        run_sweep_batched(evaluate, batch, mesh, lane_multiple)
    # The raw records: `prof.events()` builds a Python object for each of
    # the episode's ~10^5 operations first, which takes ~20x longer.
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError as e:
        raise RuntimeError("sweep_collectives: this torch's profiler keeps "
                           "no raw records (`profiler.kineto_results`)") from e
    census: dict = {}
    for e in events:
        name = e.name()
        if not name.startswith(prefix):
            continue
        nbytes = sum(_element_size(t) * math.prod(dims)
                     for t, dims in zip(e.dtypes(), e.shapes()) if t)
        c = census.setdefault(name[len(prefix):], {"count": 0, "bytes": 0})
        c["count"] += 1
        c["bytes"] += nbytes
    return census
