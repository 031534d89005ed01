"""Split-K decode attention over the flat, layer-stacked and paged KV
caches.

Counterpart of ``aiko_services_tpu/ops/pallas_decode.py`` (bf16 caches):

- ``flash_decode_attention`` (kernel #1) over a flat ``[B, T, K*hd]``
  cache, with ``flash_decode_append``, the drop-in for
  ``ops.layers.attention_decode_append``;
- ``flash_decode_attention_stacked`` (kernel #2) over one layer of the
  ``[L, B, T, K*hd]`` stacked cache, with ``flash_decode_append_stacked``
  for the layer loop;
- ``flash_decode_attention_paged`` (kernel #3) over one layer of the
  ``[L, P, pt, K*hd]`` page pools, walking a ``[B, pps]`` int32 page
  table, with ``flash_decode_append_paged`` for the layer loop;

and the helpers ``_prep_query``, ``_combine_self``, ``_split_stacked``
and ``_split_paged``.

All three launch one kernel body, ``csrc/flash_decode.cu`` (its header
says what bounds it and how it is laid out), which differs between them
only in the address of cache row t: the paged kernel is bitwise equal
to the flat one on the gathered view.  One difference from the TPU
kernels' interface: queries and accumulator are COMPACT, ``[B, H, hd]``.
The TPU kernels took block-diagonal zero-padded queries ``[B, H, K*hd]``
(a lane alignment trick for the MXU) and returned ``[B, H, K*hd]``, of
which ``_combine_self`` kept each head's own kv block; here only that
block is passed in and computed.

On a CPU tensor each wrapper runs its plain PyTorch version below; on a
CUDA tensor it launches the kernel or raises.  Not ported yet: int8
caches and pools (ROADMAP Queue 2 item 3) and the paged kernel's
``qrow_period`` for the speculative verify rows (Queue 2 item 4).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ..utils.misc import not_ported
from .layers import NEG_INF

__all__ = ["flash_decode_attention", "flash_decode_append",
           "flash_decode_attention_reference",
           "flash_decode_attention_stacked", "flash_decode_append_stacked",
           "flash_decode_attention_stacked_reference",
           "flash_decode_attention_paged", "flash_decode_append_paged",
           "flash_decode_attention_paged_reference"]

_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)


def _require_raw(cache, entry: str) -> None:
    if isinstance(cache, dict):
        raise not_ported(f"{entry} over an int8 KV cache",
                         "ROADMAP Queue 1 item 3: int8 weights and KV")


def _split_stacked(cache):
    """Stacked cache -> ([L, B, T, C] payload, None).  A grouped
    ``[L, B, T, K, hd]`` payload collapses to the flat view (a
    contiguous-minor reshape, no copy).  int8 caches wait for int8 KV."""
    _require_raw(cache, "the stacked decode kernel")
    if cache.ndim == 5:
        n_layers, b, t, kv, d = cache.shape
        cache = cache.reshape(n_layers, b, t, kv * d)
    return cache, None


def _split_paged(side):
    """One paged pool side (models/paged.py layout) -> ([L, P, pt, C]
    payload, None).  Pools are stored flat already; int8 pools wait for
    int8 KV."""
    _require_raw(side, "the paged decode kernel")
    return side, None


def _prep_query(q_flat: torch.Tensor, d: int):
    """(scaled queries [B, H, hd], softmax scale).  The scale folds in
    q's dtype when it is a power of two (d = 64: bf16 queries stay bf16);
    otherwise (d = 128, scale 2^-3.5) the scaled queries are float32.
    The TPU kernel's block-diagonal zero padding over K*hd is not built:
    the kernel reads each head's own kv block only."""
    scale = d ** -0.5
    if math.log2(scale).is_integer():
        return (q_flat.float() * scale).to(q_flat.dtype), scale
    return q_flat.float() * scale, scale


def _combine_self(acc, m, l, q_flat, k_new, v_new, scale):
    """Merge the current token's self term with the kernel's partial
    stats (exact two-part softmax).  ``acc`` is the compact [B, H, hd]
    accumulator.  A row with no cache positions (m = -1e30, l = 0,
    acc = 0) yields the self term alone.  Returns [B, H, hd] f32."""
    b, h, d = q_flat.shape
    kv = k_new.shape[2]
    k_self = k_new[:, 0].float()[:, :, None, :]           # [B, K, 1, hd]
    v_self = v_new[:, 0].float()[:, :, None, :] \
        .expand(b, kv, h // kv, d).reshape(b, h, d)
    self_logits = (q_flat.float().reshape(b, kv, h // kv, d) * k_self) \
        .sum(-1).reshape(b, h) * scale
    m_joint = torch.maximum(m, self_logits)
    correction = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                             torch.exp(m - m_joint))
    self_weight = torch.exp(self_logits - m_joint)
    denominator = l * correction + self_weight
    return (acc * correction[:, :, None]
            + self_weight[:, :, None] * v_self) / denominator[:, :, None]


# -- plain versions -----------------------------------------------------------

def flash_decode_attention_reference(q, k_flat, v_flat, lengths):
    """Plain PyTorch version of the kernel over a flat [B, T, C] cache:
    the same function, one softmax pass.  Returns (acc [B, H, hd] f32,
    m [B, H], l [B, H])."""
    b, h, head_dim = q.shape
    kv = k_flat.shape[2] // head_dim
    t = k_flat.shape[1]
    k = k_flat.reshape(b, t, kv, head_dim).float()
    v = v_flat.reshape(b, t, kv, head_dim).float()
    q_grouped = q.reshape(b, kv, h // kv, head_dim).float()
    scores = torch.einsum("bkgd,btkd->bkgt", q_grouped, k)
    valid = torch.arange(t, device=q.device)[None, None, None, :] \
        < lengths.to(q.device).long()[:, None, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(-1)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(valid, torch.exp(scores - m_safe[..., None]),
                    torch.zeros_like(scores))
    l = p.sum(-1)
    acc = torch.einsum("bkgt,btkd->bkgd", p.to(q.dtype).float(), v)
    return acc.reshape(b, h, head_dim), m.reshape(b, h), l.reshape(b, h)


def flash_decode_attention_stacked_reference(q, k_flat, v_flat,
                                             layer: int, lengths):
    """Plain version of the stacked kernel: the flat one on
    ``cache[layer]``."""
    return flash_decode_attention_reference(q, k_flat[layer],
                                            v_flat[layer], lengths)


def _gathered(pool_layer, page_table):
    """[P, pt, C] pool layer -> the [B, pps*pt, C] logical rows."""
    b, pps = page_table.shape
    return pool_layer[page_table.long()].reshape(
        b, pps * pool_layer.shape[1], pool_layer.shape[2])


def flash_decode_attention_paged_reference(q, k_pool, v_pool, layer: int,
                                           page_table, lengths):
    """Plain version of the paged kernel: gather the table's pages into
    the logical rows, then the flat version."""
    return flash_decode_attention_reference(
        q, _gathered(k_pool[layer], page_table),
        _gathered(v_pool[layer], page_table), lengths)


# -- kernel wrappers ----------------------------------------------------------

def _check_common(entry: str, q, k, v, lengths, head_dim: int, kc: int):
    """The checks the three wrappers share: head layout, dtypes and the
    lengths vector."""
    b, h, _ = q.shape
    kv = kc // head_dim
    if head_dim not in _HEAD_DIMS or kc % head_dim or h % kv \
            or h // kv not in _GROUPS:
        raise ValueError(
            f"{entry}: head_dim {head_dim} (one of {_HEAD_DIMS}) and "
            f"query groups {h}/{kv} (one of {_GROUPS}) not supported")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"{entry}: the kernel reads a bf16 cache")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{entry}: query dtype {q.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{entry}: q, k and v must share one device")
    if lengths.dtype != torch.int32 or lengths.shape != (b,) \
            or lengths.device != q.device:
        raise ValueError(f"{entry}: lengths must be [B] int32 on the "
                         f"query's device")
    return b, h, kv


def _outputs(q):
    b, h, head_dim = q.shape
    acc = torch.empty((b, h, head_dim), device=q.device,
                      dtype=torch.float32)
    m = torch.empty((b, h), device=q.device, dtype=torch.float32)
    return acc, m, torch.empty_like(m)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 \
    + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]

_PAGED_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7 \
    + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]


def _launch_flat(entry: str, q, k_view, v_view, lengths):
    """Launch the flat-addressed kernel on [B, T, C] views (unit-stride
    rows, 16-byte aligned, k and v with one set of strides)."""
    b, h, head_dim = q.shape
    _, t, kc = k_view.shape
    kv = kc // head_dim
    if k_view.stride() != v_view.stride() or k_view.stride(2) != 1 \
            or k_view.stride(0) % 8 or k_view.stride(1) % 8 \
            or k_view.data_ptr() % 16 or v_view.data_ptr() % 16:
        raise ValueError(
            f"{entry}: k/v need unit-stride rows, one set of strides for "
            f"both and 16-byte aligned rows (strides "
            f"{k_view.stride()} / {v_view.stride()})")
    q = q.contiguous()
    lengths = lengths.contiguous()
    acc, m, l = _outputs(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _build.entry("aiko_flash_decode", _ARGTYPES)(
        q.data_ptr(), int(q.dtype == torch.bfloat16),
        k_view.data_ptr(), v_view.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, kv, h // kv,
        head_dim, t, k_view.stride(0), k_view.stride(1), stream)
    _build.check(status, entry)
    return acc, m, l


def flash_decode_attention(q: torch.Tensor, k_flat: torch.Tensor,
                           v_flat: torch.Tensor, lengths: torch.Tensor):
    """Split-K decode attention over a FLAT cache (kernel #1).

    q: [B, H, hd] scaled queries from :func:`_prep_query` (f32 or bf16);
    k_flat/v_flat: [B, T, K*hd] bf16 views with unit-stride rows (any T,
    any row strides shared by k and v); lengths: [B] int32 valid
    positions (0..T).  Returns (acc [B, H, hd] f32 unnormalised,
    m [B, H] f32 running max, l [B, H] f32 denominator)."""
    _require_raw(k_flat, "flash_decode_attention")
    if q.device.type == "cpu":
        return flash_decode_attention_reference(q, k_flat, v_flat, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device "
                         f"{q.device}")
    b, _, head_dim = q.shape
    if k_flat.ndim != 3 or k_flat.shape[0] != b \
            or v_flat.shape != k_flat.shape:
        raise ValueError(
            f"flash_decode_attention: q {tuple(q.shape)} does not match "
            f"the cache {tuple(k_flat.shape)} / {tuple(v_flat.shape)}")
    _check_common("flash_decode_attention", q, k_flat, v_flat, lengths,
                  head_dim, k_flat.shape[2])
    out = _launch_flat("flash_decode_attention", q, k_flat, v_flat, lengths)
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


def flash_decode_attention_stacked(q: torch.Tensor, k_flat: torch.Tensor,
                                   v_flat: torch.Tensor, layer: int,
                                   lengths: torch.Tensor):
    """Split-K decode attention over ONE layer of the stacked cache
    (kernel #2).

    q: [B, H, hd] scaled queries from :func:`_prep_query` (f32 or bf16);
    k_flat/v_flat: [L, B, T, K*hd] bf16 caches, read in place through
    the ``cache[layer]`` view; lengths: [B] int32 valid positions (0..T).
    Returns (acc [B, H, hd] f32 unnormalised, m [B, H] f32 running max,
    l [B, H] f32 denominator)."""
    _require_raw(k_flat, "flash_decode_attention_stacked")
    if q.device.type == "cpu":
        return flash_decode_attention_stacked_reference(
            q, k_flat, v_flat, layer, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    b, _, head_dim = q.shape
    n_layers, kb, _, kc = k_flat.shape
    if kb != b or v_flat.shape != k_flat.shape \
            or not 0 <= layer < n_layers:
        raise ValueError(
            f"flash_decode: q {tuple(q.shape)} does not match the cache "
            f"{tuple(k_flat.shape)} / {tuple(v_flat.shape)} at layer "
            f"{layer}")
    _check_common("flash_decode", q, k_flat, v_flat, lengths, head_dim, kc)
    if not (k_flat.is_contiguous() and v_flat.is_contiguous()):
        raise ValueError("flash_decode: the stacked cache must be "
                         "contiguous")
    out = _launch_flat("flash_decode_attention_stacked", q, k_flat[layer],
                       v_flat[layer], lengths)
    flash_decode_attention_stacked.launches += 1
    return out


flash_decode_attention_stacked.launches = 0


def flash_decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, layer: int,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor):
    """Split-K decode attention over ONE layer of the PAGED pools, the
    page table walked in the kernel (kernel #3).

    q: [B, H, hd] scaled queries from :func:`_prep_query` (f32 or bf16);
    k_pool/v_pool: [L, P, pt, K*hd] contiguous bf16 pools (pt a multiple
    of 8), read in place; page_table: [B, pps] int32 on the device, each
    row covering the logical extent its length claims (entry 0 is the
    trash page); lengths: [B] int32 valid positions (0..pps*pt).  Returns
    the flat kernel's (acc, m, l)."""
    _require_raw(k_pool, "flash_decode_attention_paged")
    page_tokens = k_pool.shape[2]
    if page_tokens % 8:
        raise ValueError(
            f"flash_decode_attention_paged: kv_page_tokens={page_tokens} "
            f"must be a multiple of 8; use an aligned page size or the "
            f"reference gather path")
    if q.device.type == "cpu":
        return flash_decode_attention_paged_reference(
            q, k_pool, v_pool, layer, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention_paged: unsupported "
                         f"device {q.device}")
    entry = "flash_decode_attention_paged"
    b, h, head_dim = q.shape
    n_layers, n_pages, _, kc = k_pool.shape
    if v_pool.shape != k_pool.shape or not 0 <= layer < n_layers \
            or page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(
            f"{entry}: q {tuple(q.shape)}, pools {tuple(k_pool.shape)} / "
            f"{tuple(v_pool.shape)}, table {tuple(page_table.shape)} and "
            f"layer {layer} do not match")
    _, _, kv = _check_common(entry, q, k_pool, v_pool, lengths, head_dim,
                             kc)
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{entry}: the pools must be contiguous")
    if page_table.dtype != torch.int32 or page_table.device != q.device:
        raise ValueError(f"{entry}: the page table must be int32 on the "
                         f"query's device")
    q = q.contiguous()
    page_table = page_table.contiguous()
    lengths = lengths.contiguous()
    k_layer, v_layer = k_pool[layer], v_pool[layer]
    acc, m, l = _outputs(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pps = page_table.shape[1]
    status = _build.entry("aiko_flash_decode_paged", _PAGED_ARGTYPES)(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_layer.data_ptr(),
        v_layer.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, kv, h // kv,
        head_dim, pps, page_tokens, n_pages, k_layer.stride(0),
        k_layer.stride(1), stream)
    _build.check(status, entry)
    flash_decode_attention_paged.launches += 1
    return acc, m, l


flash_decode_attention_paged.launches = 0


# -- layer-loop drop-ins for attention_decode_append --------------------------

def _append(q, k_new, v_new, attend):
    """Shared body of the ``*_append*`` entries: scale the queries, run
    ``attend(q_scaled) -> (acc, m, l)`` and merge the self term.
    Returns [B, 1, H, hd] in q's dtype."""
    d = q.shape[3]
    q_flat = q[:, 0]
    q_scaled, scale = _prep_query(q_flat, d)
    acc, m, l = attend(q_scaled)
    out = _combine_self(acc, m, l, q_flat, k_new, v_new, scale)
    return out.reshape(q.shape).to(q.dtype)


def flash_decode_append(q, k_cache, v_cache, k_new, v_new, lengths):
    """Drop-in for ``ops.layers.attention_decode_append`` (same signature
    and semantics) on kernel #1.  q: [B, 1, H, hd]; k_cache/v_cache:
    [B, T, K, hd] grouped bf16 caches; k_new/v_new: [B, 1, K, hd] the
    current token's k/v (not yet written); lengths: [B] int32 valid
    cache positions.  Returns [B, 1, H, hd]."""
    _require_raw(k_cache, "flash_decode_append")
    _require_raw(v_cache, "flash_decode_append")
    b, t = k_cache.shape[:2]
    return _append(q, k_new, v_new, lambda q_scaled: flash_decode_attention(
        q_scaled, k_cache.reshape(b, t, -1), v_cache.reshape(b, t, -1),
        lengths))


def flash_decode_append_stacked(q, k_view, v_view, layer: int, k_new, v_new,
                                lengths):
    """Layer-loop form of ``attention_decode_append`` on kernel #2: the
    cache stays stacked (``_split_stacked`` views) and ``layer`` picks
    the layer inside the kernel's addressing -- no per-layer copy.
    q/k_new/v_new/lengths as in :func:`flash_decode_append`."""
    k_payload, _ = k_view
    v_payload, _ = v_view
    return _append(q, k_new, v_new,
                   lambda q_scaled: flash_decode_attention_stacked(
                       q_scaled, k_payload, v_payload, layer, lengths))


def flash_decode_append_paged(q, k_view, v_view, layer: int, k_new, v_new,
                              page_table, lengths):
    """Paged twin of :func:`flash_decode_append_stacked` on kernel #3: the
    cache stays its physical page pools (``_split_paged`` views) and the
    kernel resolves each row's pages from the [B, pps] table -- no
    gather, no logical-row copy.  The table must cover the logical
    extent the lengths claim (the allocator's ``ensure`` contract).
    q/k_new/v_new/lengths as in :func:`flash_decode_append`."""
    k_payload, _ = k_view
    v_payload, _ = v_view
    return _append(q, k_new, v_new,
                   lambda q_scaled: flash_decode_attention_paged(
                       q_scaled, k_payload, v_payload, layer, page_table,
                       lengths))
