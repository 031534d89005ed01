"""Split-K decode attention over the flat, layer-stacked and paged KV
caches.

Counterpart of ``aiko_services_tpu/ops/pallas_decode.py``, over bf16
caches and over int8 caches (``kv_dtype="int8"``: int8 codes with one
float32 scale per position and kv head, dequantized inside the kernel):

- ``flash_decode_attention`` (kernel #1) over a flat ``[B, T, K*hd]``
  cache, with ``flash_decode_append``, the drop-in for
  ``ops.layers.attention_decode_append``;
- ``flash_decode_attention_stacked`` (kernel #2) over one layer of the
  ``[L, B, T, K*hd]`` stacked cache, with ``flash_decode_append_stacked``
  for the layer loop;
- ``flash_decode_attention_paged`` (kernel #3) over one layer of the
  ``[L, P, pt, K*hd]`` page pools, walking a ``[B, pps]`` int32 page
  table, with ``flash_decode_append_paged`` for the layer loop;
- ``flash_verify_attention_stacked`` and ``flash_verify_attention_paged``
  (the chunk verify of speculative decoding, which the TPU package ran
  through #2/#3 with ``qrow_period``): S query tokens per row against
  the cache up to ``starts``, with ``flash_verify_append``, which adds
  the chunk's own causal k/v (``_combine_chunk``);

and the helpers ``_prep_query``, ``_combine_self``, ``_split_stacked``,
``_split_paged`` and ``_require_matched_quantization``.

All of them run ONE body, the tensor-core kernel of
``csrc/flash_verify.cu`` (its comments say what bounds it and how it is
laid out), split over T by :func:`verify_splits` (shapes only), then
its combine: a decode form is the S = 1 case (``flash_decode_partials_*``,
then :func:`decode_combine`), a verify form S draft tokens
(``flash_verify_partials_*``, then :func:`verify_combine`).  The flat
and paged forms differ only in the address of cache row t
(``csrc/kv_rows.cuh``): a paged launch is bitwise equal to its flat one
on the gathered view.  One difference from the TPU kernels' interface:
queries and accumulator are COMPACT, ``[B, H, hd]``.  The TPU kernels
took block-diagonal zero-padded queries ``[B, H, K*hd]`` (a lane
alignment trick for the MXU) and returned ``[B, H, K*hd]``, of which
``_combine_self`` kept each head's own kv block; here only that block
is passed in and computed.

int8 caches pass their scales in the layout they are stored in,
``[.., T, K]`` (the trailing unit axis of the cache leaf dropped, a
view): the kernel reads them through the same row address as the
payload.  The TPU kernels took ``[.., K, T]`` scales, which the JAX
package transposed -- a copy -- every step.

On a CPU tensor each wrapper runs its plain PyTorch version below; on a
CUDA tensor it launches the kernel or raises.  ``launches`` counts a
wrapper's bf16-payload launches of the body and ``int8_launches`` its
int8 ones; the two combines count apart (``decode_combine.launches``,
``verify_combine.launches``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .layers import NEG_INF
from .tiles import CARD_SMS, ceil_div

__all__ = ["flash_decode_attention", "flash_decode_append",
           "flash_decode_attention_reference",
           "flash_decode_attention_stacked", "flash_decode_append_stacked",
           "flash_decode_attention_stacked_reference",
           "flash_decode_attention_paged", "flash_decode_append_paged",
           "flash_decode_attention_paged_reference",
           "flash_verify_attention_stacked", "flash_verify_attention_paged",
           "flash_verify_attention_reference",
           "flash_verify_attention_stacked_reference",
           "flash_verify_attention_paged_reference", "flash_verify_append",
           "flash_verify_partials_stacked", "flash_verify_partials_paged",
           "flash_verify_partials_reference", "verify_combine",
           "verify_combine_reference", "verify_splits",
           "flash_decode_partials_stacked", "flash_decode_partials_paged",
           "flash_decode_partials_reference", "decode_combine",
           "decode_combine_reference"]

_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)
# Queries one verify block holds: S * G (csrc/flash_verify.cu kMaxQueries).
_MAX_VERIFY_QUERIES = 72
#: keys a verify tile: split boundaries are multiples of it (csrc kKeys).
VERIFY_TILE = 64


def verify_splits(t_len: int, batch: int, n_kv: int) -> tuple[int, int]:
    """(splits, tiles per split) of the split body's grid (decode and
    verify) over a cache of ``t_len`` positions: splits of ``tiles``
    64-key tiles, as few tiles a split as give about 4 x 132 blocks of
    (row, kv head, split) -- blocks past a row's length exit at once, so
    the live ones still fill the card.  A function of the static shapes
    only: the launch is captured in the device loop's graph, where the
    host cannot read the lengths."""
    tiles = max(1, ceil_div(t_len, VERIFY_TILE))
    per_split = ceil_div(tiles, ceil_div(4 * CARD_SMS, max(1, batch * n_kv)))
    return ceil_div(tiles, per_split), per_split


def is_quantized(leaf) -> bool:
    """An int8 cache leaf (the contract of models/quant.py's predicate,
    repeated here because models imports ops)."""
    return isinstance(leaf, dict) and "int8" in leaf and "scale" in leaf


def _split(leaf):
    """Cache leaf -> (payload, [.., T, K] float32 scales or None): an
    int8 leaf's ``[.., T, K, 1]`` scales lose their unit axis (a view)."""
    if is_quantized(leaf):
        return leaf["int8"], leaf["scale"][..., 0]
    return leaf, None


def _require_matched_quantization(k_quantized: bool, v_quantized: bool,
                                  entry: str) -> None:
    """k and v are quantized together (init_cache, init_paged_cache); a
    mixed pair can only be a caller's error, and the kernel would read a
    raw side as int8 codes."""
    if k_quantized != v_quantized:
        raise ValueError(
            f"{entry}: k and v caches must share one quantization state "
            f"(both int8 layers or both raw arrays); got k quantized="
            f"{k_quantized}, v quantized={v_quantized}")


def _split_stacked(cache):
    """Stacked cache -> ([L, B, T, C] payload, [L, B, T, K] f32 scales or
    None).  A grouped ``[L, B, T, K, hd]`` payload collapses to the flat
    view (a contiguous-minor reshape, no copy); scales stay where they
    are stored."""
    payload, scale = _split(cache)
    if payload.ndim == 5:
        n_layers, b, t, kv, d = payload.shape
        payload = payload.reshape(n_layers, b, t, kv * d)
    return payload, scale


def _split_paged(side):
    """One paged pool side (models/paged.py layout) -> ([L, P, pt, C]
    payload, [L, P, pt, K] f32 scale pool or None), both read in
    place."""
    return _split(side)


def _prep_query(q_flat: torch.Tensor, d: int):
    """(scaled queries, softmax scale) of queries [..., hd] ([B, H, hd]
    for decode, [B, S, H, hd] for verify).  The scale folds in
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

def _plain_stats(q, k_flat, v_flat, lengths, k_scale, v_scale, entry: str,
                 begin: int = 0):
    """The plain version of both kernel bodies: queries q [B, S, H, hd]
    (S = 1 for decode) against positions ``begin <= t < lengths[b]`` of a
    flat [B, T, C] cache, one softmax pass.  An int8 cache passes its
    [B, T, K] scales: the score is ``dot(q, k) * k_scale`` and the value
    scale multiplies the numerator's weights only.  Returns (acc
    [B, S, H, hd] f32, m [B, S, H], l [B, S, H])."""
    _require_matched_quantization(k_scale is not None, v_scale is not None,
                                  entry)
    b, s, h, head_dim = q.shape
    kv = k_flat.shape[2] // head_dim
    t = k_flat.shape[1]
    k = k_flat.reshape(b, t, kv, head_dim).float()
    v = v_flat.reshape(b, t, kv, head_dim).float()
    q_grouped = q.reshape(b, s, kv, h // kv, head_dim).float()
    scores = torch.einsum("bskgd,btkd->bskgt", q_grouped, k)
    if k_scale is not None:
        scores = scores * k_scale.float().permute(0, 2, 1)[:, None, :, None]
    positions = torch.arange(t, device=q.device)[None, None, None, None, :]
    valid = (positions < lengths.to(q.device).long()[:, None, None, None,
                                                     None]) \
        & (positions >= begin)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(-1)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(valid, torch.exp(scores - m_safe[..., None]),
                    torch.zeros_like(scores))
    l = p.sum(-1)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, None, :, None]
    acc = torch.einsum("bskgt,btkd->bskgd", p.to(q.dtype).float(), v)
    return (acc.reshape(b, s, h, head_dim), m.reshape(b, s, h),
            l.reshape(b, s, h))


def flash_decode_attention_reference(q, k_flat, v_flat, lengths,
                                     k_scale=None, v_scale=None):
    """Plain PyTorch version of the decode kernel over a flat [B, T, C]
    cache (see :func:`_plain_stats`).  Returns (acc [B, H, hd] f32,
    m [B, H], l [B, H])."""
    acc, m, l = _plain_stats(q[:, None], k_flat, v_flat, lengths, k_scale,
                             v_scale, "flash_decode_attention")
    return acc[:, 0], m[:, 0], l[:, 0]


def flash_verify_attention_reference(q, k_flat, v_flat, starts,
                                     k_scale=None, v_scale=None):
    """Plain PyTorch version of the verify kernel over a flat [B, T, C]
    cache: every one of the S queries of row b against the positions
    below ``starts[b]`` (see :func:`_plain_stats`).  Returns (acc
    [B, S, H, hd] f32, m [B, S, H], l [B, S, H])."""
    return _plain_stats(q, k_flat, v_flat, starts, k_scale, v_scale,
                        "flash_verify_attention")


def _by_kv_head(x, n_kv: int):
    """[B, S, H, ...] in the queries' [S, H] order -> [B, K, S*G, ...]:
    query j = s * G + g of kv head k, the verify block's order."""
    b, s, h = x.shape[:3]
    g = h // n_kv
    return x.reshape(b, s, n_kv, g, *x.shape[3:]).transpose(1, 2) \
        .reshape(b, n_kv, s * g, *x.shape[3:])


def _by_query_row(x, s: int):
    """Inverse of :func:`_by_kv_head`: [B, K, S*G, ...] -> [B, S, H, ...]."""
    b, kv, nq = x.shape[:3]
    g = nq // s
    return x.reshape(b, kv, s, g, *x.shape[3:]).transpose(1, 2) \
        .reshape(b, s, kv * g, *x.shape[3:])


def flash_verify_partials_reference(q, k_flat, v_flat, starts, k_scale=None,
                                    v_scale=None):
    """Plain version of the verify body split over T: the stats of each
    split of :func:`verify_splits` (positions [z * tiles * 64,
    (z + 1) * tiles * 64), cut at the row's start), in the kernel's
    scratch layout: (acc [B, K, splits, S*G, hd] f32, m and l [B, K,
    splits, S*G]).  A split past a row's start is neutral: acc 0,
    m -1e30, l 0."""
    b, s, h, head_dim = q.shape
    t = k_flat.shape[1]
    kv = k_flat.shape[2] // head_dim
    splits, per_split = verify_splits(t, b, kv)
    span = per_split * VERIFY_TILE
    parts = []
    for split in range(splits):
        ends = torch.clamp(starts.to(q.device).long(),
                           max=(split + 1) * span)
        parts.append(_plain_stats(q, k_flat, v_flat, ends, k_scale, v_scale,
                                  "flash_verify_attention",
                                  begin=split * span))
    return tuple(torch.stack([_by_kv_head(part[i], kv) for part in parts],
                             dim=2) for i in range(3))


def verify_combine_reference(part_acc, part_m, part_l, s: int):
    """Plain version of the verify's combine: merge the splits of
    partials [B, K, splits, S*G, (hd)] -- m = max m_z, acc and l summed
    with weights exp(m_z - m), neutral splits (m_z = -1e30) left out --
    back into the queries' [S, H] order: (acc [B, S, H, hd], m, l
    [B, S, H])."""
    live = part_m > NEG_INF / 2
    m = part_m.amax(2)
    weights = torch.where(live, torch.exp(part_m - m[:, :, None]),
                          torch.zeros_like(part_m))
    acc = (weights[..., None] * torch.where(
        live[..., None], part_acc, torch.zeros_like(part_acc))).sum(2)
    l = (weights * part_l).sum(2)
    return _by_query_row(acc, s), _by_query_row(m, s), _by_query_row(l, s)


def flash_decode_partials_reference(q, k_flat, v_flat, lengths, k_scale=None,
                                    v_scale=None):
    """Plain version of the decode body split over T: the S = 1 case of
    :func:`flash_verify_partials_reference` for queries q [B, H, hd]
    against positions below ``lengths`` of a flat [B, T, C] cache: (acc
    [B, K, splits, G, hd] f32, m and l [B, K, splits, G])."""
    return flash_verify_partials_reference(q[:, None], k_flat, v_flat,
                                           lengths, k_scale, v_scale)


def decode_combine_reference(part_acc, part_m, part_l):
    """Plain version of the decode combine: the verify combine at one
    query token, (acc [B, H, hd], m [B, H], l [B, H])."""
    acc, m, l = verify_combine_reference(part_acc, part_m, part_l, 1)
    return acc[:, 0], m[:, 0], l[:, 0]


def _layer(scale, layer: int):
    return None if scale is None else scale[layer]


def flash_decode_attention_stacked_reference(q, k_flat, v_flat,
                                             layer: int, lengths,
                                             k_scale=None, v_scale=None):
    """Plain version of the stacked kernel: the flat one on
    ``cache[layer]`` (and ``scale[layer]``)."""
    return flash_decode_attention_reference(
        q, k_flat[layer], v_flat[layer], lengths, _layer(k_scale, layer),
        _layer(v_scale, layer))


def _gathered(pool_layer, page_table):
    """[P, pt, ...] pool layer -> the [B, pps*pt, ...] logical rows."""
    b, pps = page_table.shape
    return pool_layer[page_table.long()].reshape(
        b, pps * pool_layer.shape[1], *pool_layer.shape[2:])


def flash_decode_attention_paged_reference(q, k_pool, v_pool, layer: int,
                                           page_table, lengths,
                                           k_scale=None, v_scale=None):
    """Plain version of the paged kernel: gather the table's pages (and
    scale pages) into the logical rows, then the flat version."""
    scales = [None if pool is None else _gathered(pool[layer], page_table)
              for pool in (k_scale, v_scale)]
    return flash_decode_attention_reference(
        q, _gathered(k_pool[layer], page_table),
        _gathered(v_pool[layer], page_table), lengths, *scales)


def flash_verify_attention_stacked_reference(q, k_flat, v_flat,
                                             layer: int, starts,
                                             k_scale=None, v_scale=None):
    """Plain version of the stacked verify kernel: the flat one on
    ``cache[layer]`` (and ``scale[layer]``)."""
    return flash_verify_attention_reference(
        q, k_flat[layer], v_flat[layer], starts, _layer(k_scale, layer),
        _layer(v_scale, layer))


def flash_verify_attention_paged_reference(q, k_pool, v_pool, layer: int,
                                           page_table, starts,
                                           k_scale=None, v_scale=None):
    """Plain version of the paged verify kernel: gather the table's pages
    (and scale pages), then the flat version."""
    scales = [None if pool is None else _gathered(pool[layer], page_table)
              for pool in (k_scale, v_scale)]
    return flash_verify_attention_reference(
        q, _gathered(k_pool[layer], page_table),
        _gathered(v_pool[layer], page_table), starts, *scales)


# -- kernel wrappers ----------------------------------------------------------

def _check_common(entry: str, q, k, v, lengths, head_dim: int, kc: int,
                  k_scale=None, v_scale=None):
    """The checks the three wrappers share: head layout, dtypes, the
    scales of an int8 payload and the lengths vector."""
    b, h, _ = q.shape
    kv = kc // head_dim
    if head_dim not in _HEAD_DIMS or kc % head_dim or h % kv \
            or h // kv not in _GROUPS:
        raise ValueError(
            f"{entry}: head_dim {head_dim} (one of {_HEAD_DIMS}) and "
            f"query groups {h}/{kv} (one of {_GROUPS}) not supported")
    _require_matched_quantization(k_scale is not None, v_scale is not None,
                                  entry)
    payload = torch.int8 if k_scale is not None else torch.bfloat16
    if k.dtype != payload or v.dtype != payload:
        raise TypeError(f"{entry}: the kernel reads a bf16 cache or int8 "
                        f"codes with scales; got {k.dtype}/{v.dtype} with"
                        f"{'' if k_scale is not None else 'out'} scales")
    if k_scale is not None and (
            k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
            or k_scale.shape != v_scale.shape
            or k_scale.stride() != v_scale.stride()
            or k_scale.shape[-1] != kc // head_dim or k_scale.stride(-1) != 1
            or k_scale.shape[:-1] != k.shape[:-1]
            or k_scale.device != q.device or v_scale.device != q.device):
        raise ValueError(
            f"{entry}: int8 scales must be float32 [.., T, K] views on the "
            f"query's device, one per cache row and kv head, k and v with "
            f"one set of strides and unit stride along K; got "
            f"{tuple(k_scale.shape)} / {tuple(v_scale.shape)} for a "
            f"{tuple(k.shape)} cache")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{entry}: query dtype {q.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{entry}: q, k and v must share one device")
    if lengths.dtype != torch.int32 or lengths.shape != (b,) \
            or lengths.device != q.device:
        raise ValueError(f"{entry}: lengths must be [B] int32 on the "
                         f"query's device")
    return b, h, kv


def _ptr(tensor) -> int | None:
    return None if tensor is None else tensor.data_ptr()


def _ptrs(tensors) -> list:
    """Pointers of tensors the caller still holds: a temporary (a
    ``.contiguous()`` copy) must outlive the launch that reads it, or
    the allocator may hand its memory to the launch's outputs."""
    return [_ptr(tensor) for tensor in tensors]


_BODY_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_longlong] * 4 \
    + [ctypes.c_void_p]

_BODY_PAGED_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 \
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]

_COMBINE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p]


def _count(wrapper, k_scale) -> None:
    """One more launch on the wrapper's bf16 or int8 counter."""
    if k_scale is None:
        _build.count_launch(wrapper)
    else:
        _build.count_launch(wrapper, "int8_launches")


def _check_rows(entry: str, k_view, v_view) -> None:
    """k/v rows must be unit-stride, share one set of strides and start
    on 16-byte boundaries (whole 16-byte loads of bf16 or int8)."""
    per_16 = 16 // k_view.element_size()
    if k_view.stride() != v_view.stride() or k_view.stride(-1) != 1 \
            or any(stride % per_16 for stride in k_view.stride()[:-1]) \
            or k_view.data_ptr() % 16 or v_view.data_ptr() % 16:
        raise ValueError(
            f"{entry}: k/v need unit-stride rows, one set of strides for "
            f"both and 16-byte aligned rows (strides "
            f"{k_view.stride()} / {v_view.stride()})")


def _scratch(q, kv: int, splits: int):
    """The body's partials: acc [B, K, splits, S*G, hd], m and l [B, K,
    splits, S*G] (f32, from the caching allocator: capture-safe)."""
    b, s, h, head_dim = q.shape
    nq = s * (h // kv)
    acc = torch.empty((b, kv, splits, nq, head_dim), device=q.device,
                      dtype=torch.float32)
    m = torch.empty((b, kv, splits, nq), device=q.device,
                    dtype=torch.float32)
    return acc, m, torch.empty_like(m)


def _body_query(q):
    """Contiguous queries on a 16-byte boundary (the body's vector loads)."""
    q = q.contiguous()
    return q if q.data_ptr() % 16 == 0 else q.clone()


def _partials_flat(entry: str, wrapper, q, k_view, v_view, starts,
                   k_scale=None, v_scale=None):
    """Launch the split body (``aiko_flash_verify``) for queries
    q [B, S, H, hd] (S = 1: decode) on [B, T, C] views (unit-stride rows,
    16-byte aligned, k and v with one set of strides), with the [B, T, K]
    scales of an int8 payload; the launch counts on ``wrapper``.
    Returns the partials of :func:`flash_verify_partials_reference`."""
    b, s, h, head_dim = q.shape
    _, t, kc = k_view.shape
    kv = kc // head_dim
    _verify_shape(entry, q, kv)
    _check_rows(entry, k_view, v_view)
    sstrides = k_scale.stride()[:2] if k_scale is not None else (0, 0)
    q = _body_query(q)
    starts = starts.contiguous()
    splits, per_split = verify_splits(t, b, kv)
    parts = _scratch(q, kv, splits)
    status = _build.entry("aiko_flash_verify", _BODY_ARGTYPES)(
        q.data_ptr(), int(q.dtype == torch.bfloat16),
        int(k_scale is not None), k_view.data_ptr(), v_view.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), starts.data_ptr(),
        *(part.data_ptr() for part in parts), b, kv, h // kv, head_dim,
        s * (h // kv), h, s * h, t, splits, per_split, k_view.stride(0),
        k_view.stride(1), *sstrides,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, entry)
    _count(wrapper, k_scale)
    return parts


def _partials_paged(entry: str, wrapper, q, k_pool, v_pool, layer: int,
                    page_table, starts, k_scale=None, v_scale=None):
    """Paged twin of :func:`_partials_flat` over one layer of the pools
    (``aiko_flash_verify_paged``), the split over the logical extent
    pps * pt: bitwise equal to it on the gathered view."""
    kv, pool = _check_paged(entry, q[:, 0], k_pool, v_pool, layer,
                            page_table, starts, k_scale, v_scale)
    _verify_shape(entry, q, kv)
    b, s, h, head_dim = q.shape
    q = _body_query(q)
    splits, per_split = verify_splits(pool[6] * pool[7], b, kv)
    parts = _scratch(q, kv, splits)
    status = _build.entry("aiko_flash_verify_paged", _BODY_PAGED_ARGTYPES)(
        q.data_ptr(), int(q.dtype == torch.bfloat16),
        int(k_scale is not None), *_ptrs(pool[:6]),
        *(part.data_ptr() for part in parts), b, kv, h // kv, head_dim,
        s * (h // kv), h, s * h, splits, per_split, *pool[6:])
    _build.check(status, entry)
    _count(wrapper, k_scale)
    return parts


def _combine(entry: str, part_acc, part_m, part_l, s: int):
    """Launch the combine kernel on partials [B, K, splits, S*G, (hd)]:
    (acc [B, S, H, hd], m [B, S, H], l [B, S, H]) f32."""
    if part_acc.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {part_acc.device}")
    b, kv, splits, nq, head_dim = part_acc.shape
    if nq % s or part_m.shape != part_acc.shape[:4] \
            or part_l.shape != part_m.shape or not all(
                part.dtype == torch.float32 and part.is_contiguous()
                for part in (part_acc, part_m, part_l)):
        raise ValueError(f"{entry}: partials {tuple(part_acc.shape)} / "
                         f"{tuple(part_m.shape)} / {tuple(part_l.shape)} "
                         f"are not contiguous f32 [B, K, splits, S*G(, hd)] "
                         f"of {s} query tokens")
    g = nq // s
    acc = torch.empty((b, s, kv * g, head_dim), device=part_acc.device,
                      dtype=torch.float32)
    m = torch.empty((b, s, kv * g), device=part_acc.device,
                    dtype=torch.float32)
    l = torch.empty_like(m)
    status = _build.entry("aiko_verify_combine", _COMBINE_ARGTYPES)(
        part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, kv, g, head_dim, nq,
        kv * g, s * kv * g, splits,
        torch.cuda.current_stream(part_acc.device).cuda_stream)
    _build.check(status, entry)
    return acc, m, l


def decode_combine(part_acc: torch.Tensor, part_m: torch.Tensor,
                   part_l: torch.Tensor):
    """Merge the decode body's split partials [B, K, splits, G, (hd)] in
    split order (the combine kernel of ``csrc/flash_verify.cu`` at one
    query token; its plain version :func:`decode_combine_reference` on a
    CPU tensor).  Returns (acc [B, H, hd] f32, m [B, H], l [B, H])."""
    if part_acc.device.type == "cpu":
        return decode_combine_reference(part_acc, part_m, part_l)
    acc, m, l = _combine("decode_combine", part_acc, part_m, part_l, 1)
    _build.count_launch(decode_combine)
    return acc[:, 0], m[:, 0], l[:, 0]


decode_combine.launches = 0


def flash_decode_partials_stacked(q: torch.Tensor, k_flat: torch.Tensor,
                                  v_flat: torch.Tensor, layer: int,
                                  lengths: torch.Tensor,
                                  k_scale: torch.Tensor | None = None,
                                  v_scale: torch.Tensor | None = None):
    """Kernel #2's body alone: the split partials of ONE layer of the
    stacked cache (:func:`flash_decode_partials_reference`'s, which a
    CPU tensor gets), before :func:`decode_combine`.  Arguments as in
    :func:`flash_decode_attention_stacked`; a launch counts on it."""
    if q.device.type == "cpu":
        return flash_decode_partials_reference(
            q, k_flat[layer], v_flat[layer], lengths, _layer(k_scale, layer),
            _layer(v_scale, layer))
    entry = "flash_decode_attention_stacked"
    if q.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {q.device}")
    b, _, head_dim = q.shape
    n_layers, kb, _, kc = k_flat.shape
    if kb != b or v_flat.shape != k_flat.shape \
            or not 0 <= layer < n_layers:
        raise ValueError(
            f"{entry}: q {tuple(q.shape)} does not match the cache "
            f"{tuple(k_flat.shape)} / {tuple(v_flat.shape)} at layer "
            f"{layer}")
    _check_common(entry, q, k_flat, v_flat, lengths, head_dim, kc, k_scale,
                  v_scale)
    if not (k_flat.is_contiguous() and v_flat.is_contiguous()):
        raise ValueError(f"{entry}: the stacked cache must be contiguous")
    return _partials_flat(entry, flash_decode_attention_stacked, q[:, None],
                          k_flat[layer], v_flat[layer], lengths,
                          _layer(k_scale, layer), _layer(v_scale, layer))


def flash_decode_partials_paged(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, layer: int,
                                page_table: torch.Tensor,
                                lengths: torch.Tensor,
                                k_scale: torch.Tensor | None = None,
                                v_scale: torch.Tensor | None = None):
    """Kernel #3's body alone: paged twin of
    :func:`flash_decode_partials_stacked` (arguments as in
    :func:`flash_decode_attention_paged`; a launch counts on it),
    bitwise equal to it on the gathered view."""
    _require_page_tokens("flash_decode_attention_paged", k_pool)
    if q.device.type == "cpu":
        scales = [None if pool is None else _gathered(pool[layer], page_table)
                  for pool in (k_scale, v_scale)]
        return flash_decode_partials_reference(
            q, _gathered(k_pool[layer], page_table),
            _gathered(v_pool[layer], page_table), lengths, *scales)
    return _partials_paged("flash_decode_attention_paged",
                           flash_decode_attention_paged, q[:, None], k_pool,
                           v_pool, layer, page_table, lengths, k_scale,
                           v_scale)


def flash_decode_attention(q: torch.Tensor, k_flat: torch.Tensor,
                           v_flat: torch.Tensor, lengths: torch.Tensor,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None):
    """Split-K decode attention over a FLAT cache (kernel #1): the body
    split over T, then :func:`decode_combine`.

    q: [B, H, hd] scaled queries from :func:`_prep_query` (f32 or bf16);
    k_flat/v_flat: [B, T, K*hd] bf16 views, or int8 codes with their
    k_scale/v_scale [B, T, K] float32 views, with unit-stride rows (any
    T, any row strides shared by k and v); lengths: [B] int32 valid
    positions (0..T).  Returns (acc [B, H, hd] f32 unnormalised,
    m [B, H] f32 running max, l [B, H] f32 denominator)."""
    if q.device.type == "cpu":
        return flash_decode_attention_reference(q, k_flat, v_flat, lengths,
                                                k_scale, v_scale)
    entry = "flash_decode_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {q.device}")
    b, _, head_dim = q.shape
    if k_flat.ndim != 3 or k_flat.shape[0] != b \
            or v_flat.shape != k_flat.shape:
        raise ValueError(
            f"{entry}: q {tuple(q.shape)} does not match the cache "
            f"{tuple(k_flat.shape)} / {tuple(v_flat.shape)}")
    _check_common(entry, q, k_flat, v_flat, lengths, head_dim,
                  k_flat.shape[2], k_scale, v_scale)
    return decode_combine(*_partials_flat(
        entry, flash_decode_attention, q[:, None], k_flat, v_flat, lengths,
        k_scale, v_scale))


flash_decode_attention.launches = 0
flash_decode_attention.int8_launches = 0


def flash_decode_attention_stacked(q: torch.Tensor, k_flat: torch.Tensor,
                                   v_flat: torch.Tensor, layer: int,
                                   lengths: torch.Tensor,
                                   k_scale: torch.Tensor | None = None,
                                   v_scale: torch.Tensor | None = None):
    """Split-K decode attention over ONE layer of the stacked cache
    (kernel #2): :func:`flash_decode_partials_stacked`, then
    :func:`decode_combine`.

    q: [B, H, hd] scaled queries from :func:`_prep_query` (f32 or bf16);
    k_flat/v_flat: [L, B, T, K*hd] bf16 caches, or int8 codes with their
    k_scale/v_scale [L, B, T, K] float32 scales, read in place through
    the ``cache[layer]`` views; lengths: [B] int32 valid positions
    (0..T).  Returns (acc [B, H, hd] f32 unnormalised, m [B, H] f32
    running max, l [B, H] f32 denominator)."""
    if q.device.type == "cpu":
        return flash_decode_attention_stacked_reference(
            q, k_flat, v_flat, layer, lengths, k_scale, v_scale)
    return decode_combine(*flash_decode_partials_stacked(
        q, k_flat, v_flat, layer, lengths, k_scale, v_scale))


flash_decode_attention_stacked.launches = 0
flash_decode_attention_stacked.int8_launches = 0


def flash_decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, layer: int,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None):
    """Split-K decode attention over ONE layer of the PAGED pools, the
    page table walked in the kernel (kernel #3):
    :func:`flash_decode_partials_paged`, then :func:`decode_combine`.

    q: [B, H, hd] scaled queries from :func:`_prep_query` (f32 or bf16);
    k_pool/v_pool: [L, P, pt, K*hd] contiguous bf16 pools, or int8 code
    pools with their k_scale/v_scale [L, P, pt, K] float32 scale pools
    (pt a multiple of 8), read in place; page_table: [B, pps] int32 on
    the device, each row covering the logical extent its length claims
    (entry 0 is the trash page); lengths: [B] int32 valid positions
    (0..pps*pt).  Returns the flat kernel's (acc, m, l)."""
    _require_page_tokens("flash_decode_attention_paged", k_pool)
    if q.device.type == "cpu":
        return flash_decode_attention_paged_reference(
            q, k_pool, v_pool, layer, page_table, lengths, k_scale, v_scale)
    return decode_combine(*flash_decode_partials_paged(
        q, k_pool, v_pool, layer, page_table, lengths, k_scale, v_scale))


flash_decode_attention_paged.launches = 0
flash_decode_attention_paged.int8_launches = 0


def _require_page_tokens(entry: str, k_pool) -> int:
    """The pools' page size, which the kernels need a multiple of 8 (on
    every device, so a configuration fails the same way here as on the
    card)."""
    page_tokens = k_pool.shape[2]
    if page_tokens % 8:
        raise ValueError(
            f"{entry}: kv_page_tokens={page_tokens} must be a multiple of "
            f"8; use an aligned page size or the reference gather path")
    return page_tokens


def _check_paged(entry: str, q, k_pool, v_pool, layer: int, page_table,
                 lengths, k_scale, v_scale):
    """The checks of the paged launches (q is one [B, H, hd] query row
    set).  Returns (K, pool arguments): the C entries' (k, v, k_scale,
    v_scale, table, lengths) tensors -- kept alive until the launch, see
    :func:`_ptrs` -- then (pps, pt, P, strides..., stream)."""
    if q.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {q.device}")
    b, h, head_dim = q.shape
    n_layers, n_pages, page_tokens, kc = k_pool.shape
    if v_pool.shape != k_pool.shape or not 0 <= layer < n_layers \
            or page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(
            f"{entry}: q {tuple(q.shape)}, pools {tuple(k_pool.shape)} / "
            f"{tuple(v_pool.shape)}, table {tuple(page_table.shape)} and "
            f"layer {layer} do not match")
    _, _, kv = _check_common(entry, q, k_pool, v_pool, lengths, head_dim,
                             kc, k_scale, v_scale)
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{entry}: the pools must be contiguous")
    if page_table.dtype != torch.int32 or page_table.device != q.device:
        raise ValueError(f"{entry}: the page table must be int32 on the "
                         f"query's device")
    k_layer, v_layer = k_pool[layer], v_pool[layer]
    _check_rows(entry, k_layer, v_layer)
    k_scales, v_scales = _layer(k_scale, layer), _layer(v_scale, layer)
    sstrides = k_scales.stride()[:2] if k_scales is not None else (0, 0)
    page_table = page_table.contiguous()
    lengths = lengths.contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return kv, (
        k_layer, v_layer, k_scales, v_scales, page_table, lengths,
        page_table.shape[1], page_tokens, n_pages, k_layer.stride(0),
        k_layer.stride(1), *sstrides, stream)


def _verify_shape(entry: str, q, kv: int) -> None:
    """The kernel holds at most _MAX_VERIFY_QUERIES queries (S * G) a
    block of [B, S, H, hd] verify queries."""
    _, s, h, _ = q.shape
    if s * (h // kv) > _MAX_VERIFY_QUERIES:
        raise ValueError(f"{entry}: {s} verify tokens x {h // kv} query "
                         f"groups = {s * (h // kv)} queries per kv head; "
                         f"the kernel holds at most {_MAX_VERIFY_QUERIES}")


def flash_verify_partials_stacked(q: torch.Tensor, k_flat: torch.Tensor,
                                  v_flat: torch.Tensor, layer: int,
                                  starts: torch.Tensor,
                                  k_scale: torch.Tensor | None = None,
                                  v_scale: torch.Tensor | None = None):
    """The verify body over ONE layer of the stacked cache, split over T
    (:func:`verify_splits`): the partials of
    :func:`flash_verify_partials_reference`, which a CPU tensor gets.
    Arguments as in :func:`flash_verify_attention_stacked`; a launch
    counts on that wrapper."""
    if q.device.type == "cpu":
        return flash_verify_partials_reference(
            q, k_flat[layer], v_flat[layer], starts, _layer(k_scale, layer),
            _layer(v_scale, layer))
    entry = "flash_verify_attention_stacked"
    if q.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {q.device}")
    b, _, _, head_dim = q.shape
    n_layers, kb, _, kc = k_flat.shape
    if q.ndim != 4 or kb != b or v_flat.shape != k_flat.shape \
            or not 0 <= layer < n_layers:
        raise ValueError(
            f"{entry}: q {tuple(q.shape)} does not match the cache "
            f"{tuple(k_flat.shape)} / {tuple(v_flat.shape)} at layer "
            f"{layer}")
    _check_common(entry, q[:, 0], k_flat, v_flat, starts, head_dim, kc,
                  k_scale, v_scale)
    if not (k_flat.is_contiguous() and v_flat.is_contiguous()):
        raise ValueError(f"{entry}: the stacked cache must be contiguous")
    return _partials_flat(entry, flash_verify_attention_stacked, q,
                          k_flat[layer], v_flat[layer], starts,
                          _layer(k_scale, layer), _layer(v_scale, layer))


def flash_verify_partials_paged(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, layer: int,
                                page_table: torch.Tensor,
                                starts: torch.Tensor,
                                k_scale: torch.Tensor | None = None,
                                v_scale: torch.Tensor | None = None):
    """Paged twin of :func:`flash_verify_partials_stacked` (arguments as
    in :func:`flash_verify_attention_paged`; a launch counts on that
    wrapper): bitwise equal to it on the gathered view, the split over
    the logical extent pps * pt."""
    _require_page_tokens("flash_verify_attention_paged", k_pool)
    if q.device.type == "cpu":
        scales = [None if pool is None else _gathered(pool[layer], page_table)
                  for pool in (k_scale, v_scale)]
        return flash_verify_partials_reference(
            q, _gathered(k_pool[layer], page_table),
            _gathered(v_pool[layer], page_table), starts, *scales)
    entry = "flash_verify_attention_paged"
    if q.ndim != 4:
        raise ValueError(f"{entry}: q must be [B, S, H, hd], got "
                         f"{tuple(q.shape)}")
    return _partials_paged(entry, flash_verify_attention_paged, q, k_pool,
                           v_pool, layer, page_table, starts, k_scale,
                           v_scale)


def verify_combine(part_acc: torch.Tensor, part_m: torch.Tensor,
                   part_l: torch.Tensor, s: int):
    """Merge the verify body's split partials [B, K, splits, S*G, (hd)]
    in split order (the combine kernel of ``csrc/flash_verify.cu``; its
    plain version :func:`verify_combine_reference` on a CPU tensor).
    Returns (acc [B, S, H, hd] f32, m [B, S, H], l [B, S, H])."""
    if part_acc.device.type == "cpu":
        return verify_combine_reference(part_acc, part_m, part_l, s)
    out = _combine("verify_combine", part_acc, part_m, part_l, s)
    _build.count_launch(verify_combine)
    return out


verify_combine.launches = 0


def flash_verify_attention_stacked(q: torch.Tensor, k_flat: torch.Tensor,
                                   v_flat: torch.Tensor, layer: int,
                                   starts: torch.Tensor,
                                   k_scale: torch.Tensor | None = None,
                                   v_scale: torch.Tensor | None = None):
    """Chunk-verify attention over ONE layer of the stacked cache: the
    cache part of the speculative verify step, for all S verify tokens
    at once -- the body split over T, then the combine.

    q: [B, S, H, hd] scaled queries from :func:`_prep_query` (f32 or
    bf16), the reference's [S, H] row order; k_flat/v_flat (and the
    scales of an int8 cache) as in
    :func:`flash_decode_attention_stacked`; starts: [B] int32, the
    cache frontier every query of row b sees (``t < starts[b]``).
    Returns (acc [B, S, H, hd] f32 unnormalised, m [B, S, H] f32,
    l [B, S, H] f32)."""
    if q.device.type == "cpu":
        return flash_verify_attention_stacked_reference(
            q, k_flat, v_flat, layer, starts, k_scale, v_scale)
    return verify_combine(*flash_verify_partials_stacked(
        q, k_flat, v_flat, layer, starts, k_scale, v_scale), q.shape[1])


flash_verify_attention_stacked.launches = 0
flash_verify_attention_stacked.int8_launches = 0


def flash_verify_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, layer: int,
                                 page_table: torch.Tensor,
                                 starts: torch.Tensor,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None):
    """Paged twin of :func:`flash_verify_attention_stacked`: the pools,
    scale pools and page table of :func:`flash_decode_attention_paged`
    (pt a multiple of 8), read in place, the table walked in the
    kernel.  Bitwise equal to the stacked kernel on the gathered view."""
    _require_page_tokens("flash_verify_attention_paged", k_pool)
    if q.device.type == "cpu":
        return flash_verify_attention_paged_reference(
            q, k_pool, v_pool, layer, page_table, starts, k_scale, v_scale)
    return verify_combine(*flash_verify_partials_paged(
        q, k_pool, v_pool, layer, page_table, starts, k_scale, v_scale),
        q.shape[1])


flash_verify_attention_paged.launches = 0
flash_verify_attention_paged.int8_launches = 0


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
    [B, T, K, hd] grouped bf16 caches or int8 cache layers
    (``{"int8", "scale"}``, dequantized in the kernel); k_new/v_new:
    [B, 1, K, hd] the current token's k/v (not yet written); lengths:
    [B] int32 valid cache positions.  Returns [B, 1, H, hd]."""
    _require_matched_quantization(is_quantized(k_cache),
                                  is_quantized(v_cache),
                                  "flash_decode_append")
    k_payload, k_scale = _split(k_cache)
    v_payload, v_scale = _split(v_cache)
    b, t = k_payload.shape[:2]
    return _append(q, k_new, v_new, lambda q_scaled: flash_decode_attention(
        q_scaled, k_payload.reshape(b, t, -1), v_payload.reshape(b, t, -1),
        lengths, k_scale, v_scale))


def flash_decode_append_stacked(q, k_view, v_view, layer: int, k_new, v_new,
                                lengths):
    """Layer-loop form of ``attention_decode_append`` on kernel #2: the
    cache stays stacked (``_split_stacked`` views, scales included) and
    ``layer`` picks the layer inside the kernel's addressing -- no
    per-layer copy.  q/k_new/v_new/lengths as in
    :func:`flash_decode_append`."""
    k_payload, k_scale = k_view
    v_payload, v_scale = v_view
    _require_matched_quantization(k_scale is not None, v_scale is not None,
                                  "flash_decode_append_stacked")
    return _append(q, k_new, v_new,
                   lambda q_scaled: flash_decode_attention_stacked(
                       q_scaled, k_payload, v_payload, layer, lengths,
                       k_scale, v_scale))


def flash_decode_append_paged(q, k_view, v_view, layer: int, k_new, v_new,
                              page_table, lengths):
    """Paged twin of :func:`flash_decode_append_stacked` on kernel #3: the
    cache stays its physical page pools (``_split_paged`` views, scale
    pools included) and the kernel resolves each row's pages from the
    [B, pps] table -- no gather, no logical-row copy.  The table must
    cover the logical extent the lengths claim (the allocator's
    ``ensure`` contract).  q/k_new/v_new/lengths as in
    :func:`flash_decode_append`."""
    k_payload, k_scale = k_view
    v_payload, v_scale = v_view
    _require_matched_quantization(k_scale is not None, v_scale is not None,
                                  "flash_decode_append_paged")
    return _append(q, k_new, v_new,
                   lambda q_scaled: flash_decode_attention_paged(
                       q_scaled, k_payload, v_payload, layer, page_table,
                       lengths, k_scale, v_scale))


# -- speculative chunk verify ------------------------------------------------

def _combine_chunk(acc, m, l, q, k_new, v_new, positions, scale):
    """Merge the verify chunk's own keys/values (the causal self part)
    with the kernel's cache-part stats -- the S-query form of
    :func:`_combine_self`.  acc [B, S, H, hd] (compact), m/l [B, S, H];
    q [B, S, H, hd] rope'd unscaled queries; k_new/v_new [B, S, K, hd];
    positions [B, S] trash-clamped absolute positions (chunk key j is
    seen by query i where ``positions[j] <= positions[i]``, the dense
    concat path's mask).  Returns [B, S, H, hd] f32."""
    b, s, h, d = q.shape
    kv = k_new.shape[2]
    q_grouped = q.float().reshape(b, s, kv, h // kv, d)
    chunk_logits = torch.einsum("bskgd,btkd->bskgt", q_grouped,
                                k_new.float()) * scale    # [B, S, K, G, S]
    causal = positions[:, None, None, None, :] \
        <= positions[:, :, None, None, None]
    chunk_logits = torch.where(causal, chunk_logits,
                               torch.full_like(chunk_logits, NEG_INF))
    m_k = m.reshape(b, s, kv, h // kv)
    l_k = l.reshape(b, s, kv, h // kv)
    m_joint = torch.maximum(m_k, chunk_logits.amax(-1))
    correction = torch.where(m_k <= NEG_INF / 2, torch.zeros_like(m_k),
                             torch.exp(m_k - m_joint))
    weights = torch.where(causal, torch.exp(chunk_logits - m_joint[..., None]),
                          torch.zeros_like(chunk_logits))
    denominator = l_k * correction + weights.sum(-1)
    chunk_part = torch.einsum("bskgt,btkd->bskgd", weights, v_new.float())
    out = (acc.reshape(b, s, kv, h // kv, d) * correction[..., None]
           + chunk_part) / denominator[..., None]
    return out.reshape(b, s, h, d)


def flash_verify_append(q, k_view, v_view, layer: int, k_new, v_new, starts,
                        positions, page_table=None):
    """Batched chunk-verify attention: the speculative verify step's
    concat attention with the cache read ONCE for all S draft positions.
    Counterpart of ``aiko_services_tpu/ops/pallas_decode.py``
    ``flash_verify_append``.

    All S queries of a row share one cache frontier (``t < starts[b]``;
    chunk causality over cache rows follows from ``starts <=
    positions``), so the cache part is one verify launch per layer, and
    the chunk's own k/v merge in outside with causal masking by the
    trash-clamped ``positions`` -- the semantics of the dense concat
    route of ``models/llama.py`` ``_chunk_verify``.

    q: [B, S, H, hd] rope'd queries; k_view/v_view: stacked cache views
    (:func:`_split_stacked`) or, with ``page_table`` [B, pps], paged
    pool views (:func:`_split_paged`); k_new/v_new: [B, S, K, hd] the
    chunk's rope'd k/v (not yet written); starts: [B] int32; positions:
    [B, S].  Returns [B, S, H, hd] in q's dtype."""
    k_payload, k_scale = k_view
    v_payload, v_scale = v_view
    _require_matched_quantization(k_scale is not None, v_scale is not None,
                                  "flash_verify_append")
    q_scaled, scale = _prep_query(q, q.shape[3])
    if page_table is not None:
        acc, m, l = flash_verify_attention_paged(
            q_scaled, k_payload, v_payload, layer, page_table, starts,
            k_scale, v_scale)
    else:
        acc, m, l = flash_verify_attention_stacked(
            q_scaled, k_payload, v_payload, layer, starts, k_scale, v_scale)
    out = _combine_chunk(acc, m, l, q, k_new, v_new, positions, scale)
    return out.to(q.dtype)
