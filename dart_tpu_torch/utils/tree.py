"""Helpers over NamedTuples of tensors with a leading lane axis."""

from __future__ import annotations

import torch


def lane_where(mask: torch.Tensor, a, b):
    """Per-lane select over NamedTuples of leading-B leaves (nested
    tuples recurse, None stays None): `a` where `mask` (B,), else `b`."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return type(a)(*(lane_where(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def tree_to(tree, device, dtype):
    """Floating leaves of a tensor or NamedTuple to `device` and `dtype`;
    other leaves only to `device`."""
    if isinstance(tree, tuple):
        return type(tree)(*(tree_to(x, device, dtype) for x in tree))
    if tree is None:
        return None
    return tree.to(device, dtype if tree.is_floating_point() else tree.dtype)
