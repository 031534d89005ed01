"""Weight and KV quantization predicates.

Counterpart of the predicate in ``aiko_services_tpu/models/quant.py``.
The quantizers themselves (``quantize_weight``, ``quantize_kv``,
``quantize_params``, ``draft_params``) wait for int8 weights and KV
(ROADMAP Queue 1).
"""

from __future__ import annotations

__all__ = ["is_quantized"]


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "int8" in leaf and "scale" in leaf
