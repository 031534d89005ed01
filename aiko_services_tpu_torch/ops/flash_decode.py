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
  the cache up to ``starts``, one launch per layer, with
  ``flash_verify_append``, which adds the chunk's own causal k/v
  (``_combine_chunk``);

and the helpers ``_prep_query``, ``_combine_self``, ``_split_stacked``,
``_split_paged`` and ``_require_matched_quantization``.

The decode wrappers launch one kernel body, the verify wrappers another,
both in ``csrc/flash_decode.cu`` (its comments say what bounds them and
how they are laid out); each differs between its flat and paged forms
only in the address of cache row t: a paged kernel is bitwise equal to
its flat one on the gathered view.  One difference from the TPU
kernels' interface: queries and accumulator are COMPACT, ``[B, H, hd]``.
The TPU kernels took block-diagonal zero-padded queries ``[B, H, K*hd]``
(a lane alignment trick for the MXU) and returned ``[B, H, K*hd]``, of
which ``_combine_self`` kept each head's own kv block; here only that
block is passed in and computed.

int8 caches pass their scales in the layout they are stored in,
``[.., T, K]`` (the trailing unit axis of the cache leaf dropped, a
view): the kernel reads them through the same row address as the
payload.  The TPU kernels took ``[.., K, T]`` scales, which the JAX
package transposed -- a copy -- every step.

On a CPU tensor each wrapper runs its plain PyTorch version below; on a
CUDA tensor it launches the kernel or raises.  ``launches`` counts a
wrapper's bf16-payload launches and ``int8_launches`` its int8 ones.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .layers import NEG_INF

__all__ = ["flash_decode_attention", "flash_decode_append",
           "flash_decode_attention_reference",
           "flash_decode_attention_stacked", "flash_decode_append_stacked",
           "flash_decode_attention_stacked_reference",
           "flash_decode_attention_paged", "flash_decode_append_paged",
           "flash_decode_attention_paged_reference",
           "flash_verify_attention_stacked", "flash_verify_attention_paged",
           "flash_verify_attention_reference",
           "flash_verify_attention_stacked_reference",
           "flash_verify_attention_paged_reference", "flash_verify_append"]

_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)
# Queries one verify block holds: S * G (csrc kMaxVerifyQueries).
_MAX_VERIFY_QUERIES = 72


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

def _plain_stats(q, k_flat, v_flat, lengths, k_scale, v_scale, entry: str):
    """The plain version of both kernel bodies: queries q [B, S, H, hd]
    (S = 1 for decode) against the first ``lengths[b]`` positions of a
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
    valid = torch.arange(t, device=q.device)[None, None, None, None, :] \
        < lengths.to(q.device).long()[:, None, None, None, None]
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


def _outputs(q):
    b, h, head_dim = q.shape
    acc = torch.empty((b, h, head_dim), device=q.device,
                      dtype=torch.float32)
    m = torch.empty((b, h), device=q.device, dtype=torch.float32)
    return acc, m, torch.empty_like(m)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 \
    + [ctypes.c_void_p]

_PAGED_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 4 \
    + [ctypes.c_void_p]


def _ptr(tensor) -> int | None:
    return None if tensor is None else tensor.data_ptr()


def _ptrs(tensors) -> list:
    """Pointers of tensors the caller still holds: a temporary (a
    ``.contiguous()`` copy) must outlive the launch that reads it, or
    the allocator may hand its memory to the launch's outputs."""
    return [_ptr(tensor) for tensor in tensors]


_VERIFY_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 4 \
    + [ctypes.c_void_p]

_VERIFY_PAGED_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 \
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]


def _count(wrapper, k_scale) -> None:
    """One more launch on the wrapper's bf16 or int8 counter."""
    if k_scale is None:
        wrapper.launches += 1
    else:
        wrapper.int8_launches += 1


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


def _launch_flat(entry: str, q, k_view, v_view, lengths, k_scale=None,
                 v_scale=None):
    """Launch the flat-addressed kernel on [B, T, C] views (unit-stride
    rows, 16-byte aligned, k and v with one set of strides), with the
    [B, T, K] scales of an int8 payload."""
    b, h, head_dim = q.shape
    _, t, kc = k_view.shape
    kv = kc // head_dim
    _check_rows(entry, k_view, v_view)
    sstrides = k_scale.stride()[:2] if k_scale is not None else (0, 0)
    q = q.contiguous()
    lengths = lengths.contiguous()
    acc, m, l = _outputs(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _build.entry("aiko_flash_decode", _ARGTYPES)(
        q.data_ptr(), int(q.dtype == torch.bfloat16),
        int(k_scale is not None), k_view.data_ptr(), v_view.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), lengths.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, kv, h // kv, head_dim, t,
        k_view.stride(0), k_view.stride(1), *sstrides, stream)
    _build.check(status, entry)
    return acc, m, l


def flash_decode_attention(q: torch.Tensor, k_flat: torch.Tensor,
                           v_flat: torch.Tensor, lengths: torch.Tensor,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None):
    """Split-K decode attention over a FLAT cache (kernel #1).

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
    out = _launch_flat(entry, q, k_flat, v_flat, lengths, k_scale, v_scale)
    _count(flash_decode_attention, k_scale)
    return out


flash_decode_attention.launches = 0
flash_decode_attention.int8_launches = 0


def flash_decode_attention_stacked(q: torch.Tensor, k_flat: torch.Tensor,
                                   v_flat: torch.Tensor, layer: int,
                                   lengths: torch.Tensor,
                                   k_scale: torch.Tensor | None = None,
                                   v_scale: torch.Tensor | None = None):
    """Split-K decode attention over ONE layer of the stacked cache
    (kernel #2).

    q: [B, H, hd] scaled queries from :func:`_prep_query` (f32 or bf16);
    k_flat/v_flat: [L, B, T, K*hd] bf16 caches, or int8 codes with their
    k_scale/v_scale [L, B, T, K] float32 scales, read in place through
    the ``cache[layer]`` views; lengths: [B] int32 valid positions
    (0..T).  Returns (acc [B, H, hd] f32 unnormalised, m [B, H] f32
    running max, l [B, H] f32 denominator)."""
    if q.device.type == "cpu":
        return flash_decode_attention_stacked_reference(
            q, k_flat, v_flat, layer, lengths, k_scale, v_scale)
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
    out = _launch_flat(entry, q, k_flat[layer], v_flat[layer], lengths,
                       _layer(k_scale, layer), _layer(v_scale, layer))
    _count(flash_decode_attention_stacked, k_scale)
    return out


flash_decode_attention_stacked.launches = 0
flash_decode_attention_stacked.int8_launches = 0


def flash_decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, layer: int,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None):
    """Split-K decode attention over ONE layer of the PAGED pools, the
    page table walked in the kernel (kernel #3).

    q: [B, H, hd] scaled queries from :func:`_prep_query` (f32 or bf16);
    k_pool/v_pool: [L, P, pt, K*hd] contiguous bf16 pools, or int8 code
    pools with their k_scale/v_scale [L, P, pt, K] float32 scale pools
    (pt a multiple of 8), read in place; page_table: [B, pps] int32 on
    the device, each row covering the logical extent its length claims
    (entry 0 is the trash page); lengths: [B] int32 valid positions
    (0..pps*pt).  Returns the flat kernel's (acc, m, l)."""
    page_tokens = k_pool.shape[2]
    if page_tokens % 8:
        raise ValueError(
            f"flash_decode_attention_paged: kv_page_tokens={page_tokens} "
            f"must be a multiple of 8; use an aligned page size or the "
            f"reference gather path")
    if q.device.type == "cpu":
        return flash_decode_attention_paged_reference(
            q, k_pool, v_pool, layer, page_table, lengths, k_scale, v_scale)
    entry = "flash_decode_attention_paged"
    b, h, kv, pool = _check_paged(entry, q, k_pool, v_pool, layer,
                                  page_table, lengths, k_scale, v_scale)
    q = q.contiguous()
    acc, m, l = _outputs(q)
    status = _build.entry("aiko_flash_decode_paged", _PAGED_ARGTYPES)(
        q.data_ptr(), int(q.dtype == torch.bfloat16),
        int(k_scale is not None), *_ptrs(pool[:6]), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, kv, h // kv, q.shape[2], *pool[6:])
    _build.check(status, entry)
    _count(flash_decode_attention_paged, k_scale)
    return acc, m, l


flash_decode_attention_paged.launches = 0
flash_decode_attention_paged.int8_launches = 0


def _check_paged(entry: str, q, k_pool, v_pool, layer: int, page_table,
                 lengths, k_scale, v_scale):
    """The checks of both paged wrappers (q is one [B, H, hd] query row
    set).  Returns (B, H, K, pool arguments): the C entries' (k, v,
    k_scale, v_scale, table, lengths) tensors -- kept alive until the
    launch, see :func:`_ptrs` -- then (pps, pt, P, strides..., stream)."""
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
    return b, h, kv, (
        k_layer, v_layer, k_scales, v_scales, page_table, lengths,
        page_table.shape[1], page_tokens, n_pages, k_layer.stride(0),
        k_layer.stride(1), *sstrides, stream)


def _verify_shape(entry: str, q, kv: int):
    """(S, H, queries per block) of [B, S, H, hd] verify queries; the
    kernel holds at most _MAX_VERIFY_QUERIES queries a block."""
    _, s, h, _ = q.shape
    n_queries = s * (h // kv)
    if n_queries > _MAX_VERIFY_QUERIES:
        raise ValueError(f"{entry}: {s} verify tokens x {h // kv} query "
                         f"groups = {n_queries} queries per kv head; the "
                         f"kernel holds at most {_MAX_VERIFY_QUERIES}")
    return s, h, n_queries


def _verify_outputs(q):
    acc = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    m = torch.empty(q.shape[:3], device=q.device, dtype=torch.float32)
    return acc, m, torch.empty_like(m)


def flash_verify_attention_stacked(q: torch.Tensor, k_flat: torch.Tensor,
                                   v_flat: torch.Tensor, layer: int,
                                   starts: torch.Tensor,
                                   k_scale: torch.Tensor | None = None,
                                   v_scale: torch.Tensor | None = None):
    """Chunk-verify attention over ONE layer of the stacked cache: the
    cache part of the speculative verify step, one launch for all S
    verify tokens.

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
    entry = "flash_verify_attention_stacked"
    if q.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {q.device}")
    b, _, _, head_dim = q.shape
    n_layers, kb, t, kc = k_flat.shape
    if q.ndim != 4 or kb != b or v_flat.shape != k_flat.shape \
            or not 0 <= layer < n_layers:
        raise ValueError(
            f"{entry}: q {tuple(q.shape)} does not match the cache "
            f"{tuple(k_flat.shape)} / {tuple(v_flat.shape)} at layer "
            f"{layer}")
    _, _, kv = _check_common(entry, q[:, 0], k_flat, v_flat, starts,
                             head_dim, kc, k_scale, v_scale)
    s, h, n_queries = _verify_shape(entry, q, kv)
    if not (k_flat.is_contiguous() and v_flat.is_contiguous()):
        raise ValueError(f"{entry}: the stacked cache must be contiguous")
    k_view, v_view = k_flat[layer], v_flat[layer]
    _check_rows(entry, k_view, v_view)
    k_scales, v_scales = _layer(k_scale, layer), _layer(v_scale, layer)
    sstrides = k_scales.stride()[:2] if k_scales is not None else (0, 0)
    q = q.contiguous()
    starts = starts.contiguous()
    acc, m, l = _verify_outputs(q)
    status = _build.entry("aiko_flash_verify", _VERIFY_ARGTYPES)(
        q.data_ptr(), int(q.dtype == torch.bfloat16),
        int(k_scale is not None), k_view.data_ptr(), v_view.data_ptr(),
        _ptr(k_scales), _ptr(v_scales), starts.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, kv, h // kv, head_dim, n_queries, h,
        s * h, t, k_view.stride(0), k_view.stride(1), *sstrides,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, entry)
    _count(flash_verify_attention_stacked, k_scale)
    return acc, m, l


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
    page_tokens = k_pool.shape[2]
    if page_tokens % 8:
        raise ValueError(
            f"flash_verify_attention_paged: kv_page_tokens={page_tokens} "
            f"must be a multiple of 8; use an aligned page size or the "
            f"reference gather path")
    if q.device.type == "cpu":
        return flash_verify_attention_paged_reference(
            q, k_pool, v_pool, layer, page_table, starts, k_scale, v_scale)
    entry = "flash_verify_attention_paged"
    if q.ndim != 4:
        raise ValueError(f"{entry}: q must be [B, S, H, hd], got "
                         f"{tuple(q.shape)}")
    b, _, kv, pool = _check_paged(entry, q[:, 0], k_pool, v_pool, layer,
                                  page_table, starts, k_scale, v_scale)
    s, h, n_queries = _verify_shape(entry, q, kv)
    q = q.contiguous()
    acc, m, l = _verify_outputs(q)
    status = _build.entry("aiko_flash_verify_paged", _VERIFY_PAGED_ARGTYPES)(
        q.data_ptr(), int(q.dtype == torch.bfloat16),
        int(k_scale is not None), *_ptrs(pool[:6]), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, kv, h // kv, q.shape[3], n_queries,
        h, s * h, *pool[6:])
    _build.check(status, entry)
    _count(flash_verify_attention_paged, k_scale)
    return acc, m, l


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
