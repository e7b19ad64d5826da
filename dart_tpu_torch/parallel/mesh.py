"""The rank mesh and multi-process start (port of `dart_tpu.parallel.mesh`).

JAX shards one program over a device mesh inside one process; PyTorch runs
one process per device (`torchrun`) and reduces with explicit
`torch.distributed` collectives. A `Mesh` here is the default process
group seen from one rank: its rank, the world size and the device the rank
computes on. The scenario axis is pure data parallelism, so the same code
runs at any world size:

    from dart_tpu_torch.parallel.mesh import init_distributed, make_mesh
    init_distributed()          # once per process; False without torchrun
    mesh = make_mesh()          # every rank, on cuda:LOCAL_RANK

Under `torchrun --standalone --nproc_per_node=k` every rank takes
`cuda:LOCAL_RANK` and NCCL; with `device="cpu"` the ranks run on the CPU
over gloo. Two ranks may share one card only where the caller names the
device (`make_mesh(device="cuda:0")`) and the backend (`"gloo"`).

The rest of JAX's mesh API has no counterpart: a collective takes the
process group, not an axis name, and a rank's share of a batch is its
block in `parallel.sweep`.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from dart_tpu_torch.utils.device import resolve


class Mesh(NamedTuple):
    """One rank's view of a 1-D mesh over the ranks of `group` (None: one
    rank without a process group)."""

    group: dist.ProcessGroup | None
    rank: int
    size: int
    device: torch.device


def rank_device(device: torch.device | str = "cuda") -> torch.device:
    """`device` as the rank's device: a bare "cuda" is `cuda:LOCAL_RANK`
    (0 without torchrun), which must exist; an indexed device or the CPU is
    taken as given."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} has no card: {torch.cuda.device_count()}"
                " visible; start at most one rank a card or name the device")
        dev = torch.device("cuda", local)
    return dev


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device: torch.device | str = "cuda") -> bool:
    """Initialise the default process group from the arguments or from
    torchrun's environment (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK), the
    arguments winning. The backend is NCCL for a card and gloo for the CPU
    unless named. Returns True when running multi-process; False, with no
    group, when none of them is given (one process, as JAX's single-host
    path). Some but not all of them raise ValueError; a failed start
    raises."""
    env = os.environ
    missing = []
    if coordinator_address is None:
        missing += [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in env]
    if num_processes is None and "WORLD_SIZE" not in env:
        missing.append("WORLD_SIZE")
    if process_id is None and "RANK" not in env:
        missing.append("RANK")
    if len(missing) == 4:
        return False
    if missing:
        raise ValueError(
            f"a multi-process start needs {', '.join(missing)} as well: set "
            "all of MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK (torchrun "
            "does) or pass coordinator_address, num_processes and process_id")
    addr = coordinator_address or f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = (num_processes if num_processes is not None
             else int(env["WORLD_SIZE"]))
    rank = process_id if process_id is not None else int(env["RANK"])
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)   # the kernels launch on the current card
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
        device_id=dev if backend == "nccl" else None)
    return dist.get_world_size() > 1


def make_mesh(n_devices: int | None = None,
              device: torch.device | str = "cuda") -> Mesh:
    """The mesh over every rank of the default process group if one is
    initialised, else one rank without a group; this rank on
    `rank_device(device)`. `n_devices`, where given, must be the mesh's
    size: JAX's cut of the local device list has no counterpart when each
    process drives one device, so a smaller mesh is a smaller world."""
    if dist.is_initialized():
        mesh = Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                    rank_device(device))
    else:
        mesh = Mesh(None, 0, 1, rank_device(device))
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"asked for {n_devices} devices; the mesh has "
                         f"{mesh.size} ranks")
    return mesh
