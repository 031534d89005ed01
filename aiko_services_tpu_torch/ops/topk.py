"""Exact top-k over the last axis (the sampling candidate set).

Counterpart of ``aiko_services_tpu/ops/pallas_topk.py``: values
descending, ties to the LOWEST index (``lax.top_k``'s contract, which
``torch.topk`` does not promise), and no duplicate index on a row that
is mostly -inf.  The kernel is ``csrc/topk.cu``, a threshold select in
two passes: each chunk of a row selects its own top k by radix
histograms of order-preserving keys, then one block a row selects the
row's top k from the chunks' candidates and sorts them.  On a CPU tensor
the wrapper runs the plain PyTorch version below (a stable sort), on a
CUDA tensor it launches the kernel or raises.

:func:`topk_threshold_reference` is the plain version of the kernel's
own algorithm (the keys, the radix bins, the tie rule, the chunks), so
that the CPU tests can hold the design, not only the result.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .tiles import CARD_SMS, ceil_div

__all__ = ["topk", "topk_reference", "topk_threshold_reference",
           "order_keys", "radix_threshold", "topk_plan", "MAX_K",
           "RADIX_ROUNDS"]

MAX_K = 128
_CHUNK_THREADS = 256
_CHUNK_EPT = (8, 4, 2, 1)     # elements per thread of the chunk pass
_MERGE_CAPACITY = 1024 * 8    # candidates the merge block holds a row
_TARGET_BLOCKS = 2 * CARD_SMS
#: (shift, bits) of each radix digit of the 32-bit key, highest first.
RADIX_ROUNDS = ((20, 12), (10, 10), (0, 10))
_ABSENT = 2 ** 31 - 1         # index of a slot past the row's end


def _check_k(v: int, k: int) -> None:
    if not 0 < k <= min(v, MAX_K):
        raise ValueError(f"topk: k={k} must be in [1, min(V={v}, {MAX_K})]")


def topk_reference(x: torch.Tensor, k: int):
    """Plain PyTorch version: a stable descending sort keeps equal
    values in index order, which is exactly the tie contract."""
    _check_k(x.shape[-1], k)
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k].to(torch.int32)


def topk_plan(batch: int, vocab: int, k: int) -> tuple[int, int]:
    """(elements per thread, chunks a row) of the chunk pass, from the
    shapes only: the largest chunk that still gives 2 x 132 blocks or
    more where the merge can hold the chunks' k candidates each;
    otherwise the smallest chunk it can hold."""
    fits = [(ept, ceil_div(vocab, ept * _CHUNK_THREADS)) for ept in _CHUNK_EPT]
    fits = [(ept, chunks) for ept, chunks in fits
            if chunks * k <= _MERGE_CAPACITY]
    if not fits:
        raise ValueError(f"topk: V={vocab} at k={k} exceeds the kernel's "
                         f"merge capacity ({_MERGE_CAPACITY} candidates)")
    for ept, chunks in fits:
        if batch * chunks >= _TARGET_BLOCKS:
            return ept, chunks
    return fits[-1]


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving 32-bit keys of float32 ``x`` (as int64 in
    [0, 2^32)): every bit of a negative value flipped, the sign bit of
    any other set; -0 counts as +0 and a NaN sorts above +inf, as the
    stable sort orders them."""
    bits = torch.where(x == 0, torch.zeros_like(x), x).view(torch.int32) \
        .to(torch.int64) & 0xFFFFFFFF
    keys = torch.where(bits >= 2 ** 31, bits ^ 0xFFFFFFFF, bits | 2 ** 31)
    return torch.where(torch.isnan(x), torch.full_like(keys, 0xFFFFFFFF),
                       keys)


def radix_threshold(keys: torch.Tensor, k: int):
    """The kernel's radix select on rows of keys [N, M] (k <= M): per
    row, histograms of the top 12 key bits, then of the next 10 and the
    last 10 bits inside the chosen bin, stopping once every key of the
    chosen bin is needed.  Returns (tau, mask, need): the top k are the
    keys whose ``key & mask`` is above ``tau``, then the first ``need``
    equal to it; after all three rounds mask is 2^32 - 1 and tau the
    k-th largest key."""
    n = keys.shape[0]
    zeros = torch.zeros(n, dtype=torch.int64, device=keys.device)
    prefix, mask = zeros, zeros
    remaining = torch.full((n,), k, dtype=torch.int64, device=keys.device)
    done = torch.zeros(n, dtype=torch.bool, device=keys.device)
    for shift, bits in RADIX_ROUNDS:
        bins = 1 << bits
        live = (keys & mask[:, None]) == prefix[:, None]
        digit = (keys >> shift) & (bins - 1)
        hist = torch.zeros((n, bins), dtype=torch.int64, device=keys.device)
        hist.scatter_add_(1, digit, live.to(torch.int64))
        at_or_above = hist.flip(1).cumsum(1).flip(1)
        chosen = bins - 1 - (at_or_above >= remaining[:, None]).flip(1) \
            .to(torch.int8).argmax(1)
        in_bin = hist.gather(1, chosen[:, None])[:, 0]
        above = at_or_above.gather(1, chosen[:, None])[:, 0] - in_bin
        keep = ~done
        prefix = torch.where(keep, prefix | (chosen << shift), prefix)
        mask = torch.where(keep, mask | ((bins - 1) << shift), mask)
        remaining = torch.where(keep, remaining - above, remaining)
        done = done | (keep & (in_bin == remaining))
    return prefix, mask, remaining


def _taken(keys, tau, mask, need):
    """Which keys the top k take: every key whose ``key & mask`` is above
    ``tau``, then the first ``need`` equal to it along the row (index
    order)."""
    masked = keys & mask[:, None]
    equal = masked == tau[:, None]
    before = equal.to(torch.int64).cumsum(1) - equal.to(torch.int64)
    return (masked > tau[:, None]) | (equal & (before < need[:, None]))


def _first_k(taken, k: int):
    """Positions of the k taken entries of each row, in row order."""
    return torch.sort((~taken).to(torch.int8), dim=1, stable=True) \
        .indices[:, :k]


def topk_threshold_reference(x: torch.Tensor, k: int):
    """Plain version of the kernel's algorithm on [B, V] float32: the
    chunk pass (:func:`topk_plan`'s chunks; each selects its top k by
    :func:`radix_threshold` and the tie rule, a short chunk padding with
    key 0), then the merge of the chunks' candidates (in chunk order, so
    index order among equal keys) by the same select, the k winners
    ordered by (key desc, index asc).  Returns (values [B, k], indices
    [B, k] int32), equal to :func:`topk_reference`'s."""
    b, vocab = x.shape
    _check_k(vocab, k)
    ept, chunks = topk_plan(b, vocab, k)
    width = ept * _CHUNK_THREADS
    pad = chunks * width - vocab
    keys = torch.nn.functional.pad(order_keys(x), (0, pad)) \
        .reshape(b * chunks, width)
    index = torch.arange(chunks * width, device=x.device)
    index = torch.where(index < vocab, index,
                        torch.full_like(index, _ABSENT))
    index = index.reshape(chunks, width).repeat(b, 1)
    picked = _first_k(_taken(keys, *radix_threshold(keys, k)), k)
    cand_keys = keys.gather(1, picked).reshape(b, chunks * k)
    cand_index = index.gather(1, picked).reshape(b, chunks * k)
    picked = _first_k(_taken(cand_keys, *radix_threshold(cand_keys, k)), k)
    win_keys = cand_keys.gather(1, picked)
    win_index = cand_index.gather(1, picked)
    order = torch.sort(win_keys, dim=1, descending=True, stable=True).indices
    indices = win_index.gather(1, order)
    return x.gather(1, indices), indices.to(torch.int32)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong] \
    + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5


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
    ept, chunks = topk_plan(b, vocab, k)
    aligned = int(x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0)
    cand_key = torch.empty((b, chunks, k), device=x.device,
                           dtype=torch.int32)
    cand_idx = torch.empty_like(cand_key)
    values = torch.empty((b, k), device=x.device, dtype=torch.float32)
    indices = torch.empty((b, k), device=x.device, dtype=torch.int32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _build.entry("aiko_topk", _ARGTYPES)(
        x.data_ptr(), x.stride(0), b, vocab, k, ept, chunks, aligned,
        cand_key.data_ptr(), cand_idx.data_ptr(), values.data_ptr(),
        indices.data_ptr(), stream)
    _build.check(status, "topk")
    _build.count_launch(topk)
    return values, indices


topk.launches = 0
