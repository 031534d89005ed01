"""Op-level interfaces: the transformer building blocks (ops.layers) plus
the kernel plane behind capability probes.

Counterpart of ``aiko_services_tpu/ops/__init__.py``.  Where the JAX
package asks whether it runs on a TPU, the port asks whether the tensor
lies on a CUDA device.  The kernel modules build their CUDA library at
first launch, never at import.
"""

from __future__ import annotations

import torch

from .layers import (rms_norm, rope_frequencies, apply_rope, swiglu,
                     repeat_kv, attention_prefill, attention_decode,
                     attention_decode_append)
from .topk import topk
from ..device import resolve_device

__all__ = ["rms_norm", "rope_frequencies", "apply_rope", "swiglu",
           "repeat_kv", "attention_prefill", "attention_decode",
           "attention_decode_append", "decode_backend",
           "matmul_backend", "topk", "DECODE_BACKENDS", "launch_counters"]

#: every value :func:`decode_backend` can return, in preference order.
DECODE_BACKENDS = ("paged-kernel", "dense-flash", "reference")


def decode_backend(requested: str = "auto", *, paged: bool = False,
                   extent: int | None = None, threshold: int = 1024,
                   distributed: bool = False,
                   page_tokens: int | None = None) -> str:
    """Capability probe for decode attention (the same pure function as
    the JAX package's): ``paged-kernel`` (the page-table-walking kernel,
    ``flash_decode_attention_paged``), ``dense-flash`` (the stacked
    split-K kernel; both in ops/flash_decode.py) or ``reference`` (the
    dense path, ops/layers.py, over the gathered pages for a paged
    cache).  Under ``auto`` the kernels engage once
    ``extent`` reaches ``threshold`` and the structure fits."""
    if requested in ("dense", "reference") or distributed:
        return "reference"
    if paged:
        if requested == "flash":
            return "paged-kernel"
        if (extent or 0) >= threshold and page_tokens \
                and page_tokens % 8 == 0:
            return "paged-kernel"
        return "reference"
    if requested == "flash":
        return "dense-flash"
    if (extent or 0) >= threshold and (extent or 0) % 128 == 0:
        return "dense-flash"
    return "reference"


def matmul_backend(requested: str = "auto",
                   device: torch.device | str | None = None) -> str:
    """Capability probe for the int8 dequant-matmul (kernel #5,
    ops/int8_matmul.py): ``cuda-int8`` or ``reference`` (the plain
    widen-then-multiply product).  The config keeps the JAX package's
    value names: ``pallas`` asks for the kernel's route -- here the
    hand-written CUDA kernel, whose wrapper runs its plain version on a
    CPU tensor; ``auto`` takes the kernel on a CUDA device (``None``
    means the card, as for every entry point) and the reference on the
    CPU; ``off`` always takes the reference."""
    if requested == "pallas":
        return "cuda-int8"
    if requested == "auto" and resolve_device(device).type == "cuda":
        return "cuda-int8"
    return "reference"


def launch_counters() -> dict:
    """Every kernel launch counter of the port: name -> (wrapper, the
    wrapper's attribute).  A wrapper adds one where it launches its
    kernel, and nowhere else; the decode and verify wrappers count bf16
    and int8 payloads apart (``[int8]`` names), the int8 matmul its
    decode route (M <= 16) and its admission route (``[M>16]``); the
    combines of the split attention body (``decode_combine`` after a
    decode form, ``verify_combine`` after a verify form) and of the int8
    decode route split over D (``int8_combine``) count apart."""
    from .flash_attention import flash_attention
    from .flash_decode import (decode_combine, flash_decode_attention,
                               flash_decode_attention_paged,
                               flash_decode_attention_stacked,
                               flash_verify_attention_paged,
                               flash_verify_attention_stacked,
                               verify_combine)
    from .int8_matmul import int8_combine, int8_matmul
    counters = {}
    for wrapper in (flash_decode_attention, flash_decode_attention_stacked,
                    flash_decode_attention_paged,
                    flash_verify_attention_stacked,
                    flash_verify_attention_paged):
        counters[wrapper.__name__] = (wrapper, "launches")
        counters[f"{wrapper.__name__}[int8]"] = (wrapper, "int8_launches")
    for wrapper in (int8_matmul, flash_attention, topk, decode_combine,
                    verify_combine, int8_combine):
        counters[wrapper.__name__] = (wrapper, "launches")
    counters["int8_matmul[M>16]"] = (int8_matmul, "wide_launches")
    return counters
