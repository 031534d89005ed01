"""aiko_services_tpu_torch: the PyTorch/CUDA port of aiko_services_tpu.

The JAX package stays the reference; this package grows beside it slice
by slice (ROADMAP.md, Queue 1).  It imports torch, numpy and the
standard library only -- never jax, and nothing of ``aiko_services_tpu``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no such request they raise.

The ported slices serve Llama-3 through
``models.batching.ContinuousBatcher`` -- dense or paged KV, bf16 or
int8 weights and cache -- on hand-written Hopper kernels
(``ops/flash_decode.py``, ``ops/flash_attention.py``, ``ops/topk.py``,
``ops/int8_matmul.py``; sources under ``csrc/``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
