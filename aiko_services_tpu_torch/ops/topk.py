"""Exact top-k over the last axis (the sampling candidate set).

Counterpart of ``aiko_services_tpu/ops/pallas_topk.py``: values
descending, ties to the LOWEST index (``lax.top_k``'s contract, which
``torch.topk`` does not promise), and no duplicate index on a row that
is mostly -inf.  The kernel is ``csrc/topk.cu`` (two passes: per-chunk
candidates, then a per-row merge); on a CPU tensor the wrapper runs the
plain PyTorch version below, on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["topk", "topk_reference", "MAX_K"]

MAX_K = 128
_THREADS = 256
_CHUNK_EPT = (8, 32)      # elements per thread of the chunk pass
_MERGE_CAPACITY = 32 * _THREADS


def _check_k(v: int, k: int) -> None:
    if not 0 < k <= min(v, MAX_K):
        raise ValueError(f"topk: k={k} must be in [1, min(V={v}, {MAX_K})]")


def topk_reference(x: torch.Tensor, k: int):
    """Plain PyTorch version: a stable descending sort keeps equal
    values in index order, which is exactly the tie contract."""
    _check_k(x.shape[-1], k)
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k].to(torch.int32)


def _plan(vocab: int, k: int) -> tuple[int, int]:
    """(elements per thread, chunks) of the chunk pass: the smallest
    chunk whose candidate count fits the merge pass."""
    for ept in _CHUNK_EPT:
        chunks = -(-vocab // (ept * _THREADS))
        if chunks * k <= _MERGE_CAPACITY:
            return ept, chunks
    raise ValueError(f"topk: V={vocab} at k={k} exceeds the kernel's "
                     f"merge capacity ({_MERGE_CAPACITY} candidates)")


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong] \
    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5


def topk(x: torch.Tensor, k: int):
    """Top-k of ``x`` [B, V] float32 -> (values [B, k] float32, indices
    [B, k] int32), descending, ties to the lowest index."""
    k = int(k)
    if x.device.type == "cpu":
        return topk_reference(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk: unsupported device {x.device}")
    if x.ndim != 2 or x.dtype != torch.float32 or x.stride(1) != 1:
        raise ValueError(f"topk: the kernel takes [B, V] float32 rows "
                         f"with unit stride; got {tuple(x.shape)} {x.dtype}")
    b, vocab = x.shape
    _check_k(vocab, k)
    ept, chunks = _plan(vocab, k)
    cand_v = torch.empty((b, chunks, k), device=x.device,
                         dtype=torch.float32)
    cand_i = torch.empty((b, chunks, k), device=x.device, dtype=torch.int32)
    values = torch.empty((b, k), device=x.device, dtype=torch.float32)
    indices = torch.empty((b, k), device=x.device, dtype=torch.int32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _build.entry("aiko_topk", _ARGTYPES)(
        x.data_ptr(), x.stride(0), b, vocab, k, ept, chunks,
        cand_v.data_ptr(), cand_i.data_ptr(), values.data_ptr(),
        indices.data_ptr(), stream)
    _build.check(status, "topk")
    topk.launches += 1
    return values, indices


topk.launches = 0
