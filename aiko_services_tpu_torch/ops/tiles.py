"""Shared padding arithmetic for the kernel wrappers."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["pad_to", "round_up"]


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_to(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to the next multiple (returns
    ``x`` itself when already aligned)."""
    size = x.shape[axis]
    pad = (-size) % multiple
    if not pad:
        return x
    axis = axis % x.ndim
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)
