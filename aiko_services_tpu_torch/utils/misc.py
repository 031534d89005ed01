"""Small host-side helpers the port needs (its own copies: the port
imports nothing of the JAX package)."""

from __future__ import annotations

__all__ = ["next_power_of_two", "not_ported"]


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (admission bursts pad to one of
    log2(N) buckets, so the batched prefill sees few distinct shapes)."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return bucket


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error an option of the JAX package raises in the port until
    its ROADMAP item lands."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet ({item})")
