"""Paged KV cache predicates.

Counterpart of the predicates in ``aiko_services_tpu/models/paged.py``.
The page pool, ``PageAllocator`` and the gather/scatter helpers wait for
the paged cache (ROADMAP Queue 1).
"""

from __future__ import annotations

from .quant import is_quantized

__all__ = ["is_paged", "pool_page_tokens", "paged_extent"]


def is_paged(cache) -> bool:
    return isinstance(cache, dict) and "page_table" in cache


def _payload(layer):
    return layer["int8"] if is_quantized(layer) else layer


def pool_page_tokens(cache: dict) -> int:
    """Static tokens-per-page of a paged cache's pool."""
    return _payload(cache["k"]).shape[2]


def paged_extent(cache: dict) -> int:
    """Logical per-slot extent (== max_seq) of a paged cache."""
    return cache["page_table"].shape[1] * pool_page_tokens(cache)
