"""Pieces every system of the benchmark shares."""

from __future__ import annotations

import gc
import sys

import torch


def memory_peak(device) -> int:
    """The peak of the card's allocator over the run so far (0 off a
    card)."""
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_precision() -> None:
    """Float32 products in float32: no TF32 in the reference (set once
    the window has closed; the program's bf16 work never reads it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sample(ids: list, count: int, lengths: dict, rng) -> list:
    """``count`` of ``ids`` drawn with ``rng``, the longest among them."""
    if not ids:
        return []
    longest = max(ids, key=lambda rid: (lengths[rid], rid))
    rest = [rid for rid in ids if rid != longest]
    picks = rng.permutation(len(rest))[:max(0, count - 1)]
    return [longest] + [rest[i] for i in sorted(picks)]


def note_captures(made: dict) -> None:
    """Say on standard error what was captured inside the window (the
    set-up should have left nothing to capture)."""
    late = {name: count for name, count in made.items() if count}
    if late:
        print(f"torch_bench: captured inside the window: {late}",
              file=sys.stderr, flush=True)
