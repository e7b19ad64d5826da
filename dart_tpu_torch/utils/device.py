"""The device an entry point of the port creates its tensors on."""

from __future__ import annotations

import functools

import torch


def resolve(device: torch.device | str = "cuda") -> torch.device:
    """`device` as a torch.device. The entry points default to the card and
    never fall back to the CPU on their own: without CUDA this raises
    unless the caller asked for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; ask for the CPU "
                           "explicitly (device='cpu', or --cpu on the CLI)")
    return dev


@functools.lru_cache(maxsize=None)
def constant(values, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A read-only tensor of `values` (a number or nested tuples), made
    once per dtype and device: a loop that needs the same small constant
    every step copies it to the card once, not every step (a copy from
    pageable host memory waits for the card)."""
    return torch.tensor(values, dtype=dtype, device=device)
