"""The device an entry point of the port creates its tensors on."""

from __future__ import annotations

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
