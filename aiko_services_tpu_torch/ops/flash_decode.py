"""Split-K decode attention over the layer-stacked KV cache.

Counterpart of ``aiko_services_tpu/ops/pallas_decode.py`` (the stacked,
bf16-cache form): ``flash_decode_attention_stacked`` is the kernel entry,
``flash_decode_append_stacked`` the drop-in for
``ops.layers.attention_decode_append`` inside the layer loop, with the
helpers ``_prep_query``, ``_combine_self`` and ``_split_stacked``.

The kernel is ``csrc/flash_decode.cu`` (its header says what bounds it
and how it is laid out).  One difference from the TPU kernel's
interface: queries and accumulator are COMPACT, ``[B, H, hd]``.  The TPU
kernel took block-diagonal zero-padded queries ``[B, H, K*hd]`` (a lane
alignment trick for the MXU) and returned ``[B, H, K*hd]``, of which
``_combine_self`` kept each head's own kv block; here only that block is
passed in and computed.

On a CPU tensor the wrapper runs the plain PyTorch version below; on a
CUDA tensor it launches the kernel or raises.  The int8-cache branch,
the flat and paged forms and the speculative verify wait for later
slices (ROADMAP Queue 2).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ..utils.misc import not_ported
from .layers import NEG_INF

__all__ = ["flash_decode_attention_stacked", "flash_decode_append_stacked",
           "flash_decode_attention_stacked_reference"]

_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)


def _split_stacked(cache):
    """Stacked cache -> ([L, B, T, C] payload, None).  A grouped
    ``[L, B, T, K, hd]`` payload collapses to the flat view (a
    contiguous-minor reshape, no copy).  int8 caches wait for int8 KV."""
    if isinstance(cache, dict):
        raise not_ported("the int8 KV cache", "ROADMAP Queue 1 item 3: "
                         "int8 weights and KV")
    if cache.ndim == 5:
        n_layers, b, t, kv, d = cache.shape
        cache = cache.reshape(n_layers, b, t, kv * d)
    return cache, None


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


def flash_decode_attention_stacked_reference(q, k_flat, v_flat,
                                             layer: int, lengths):
    """Plain PyTorch version of the kernel: the same function, one
    softmax pass.  Returns (acc [B, H, hd] f32, m [B, H], l [B, H])."""
    b, h, head_dim = q.shape
    kv = k_flat.shape[3] // head_dim
    t = k_flat.shape[2]
    k = k_flat[layer].reshape(b, t, kv, head_dim).float()
    v = v_flat[layer].reshape(b, t, kv, head_dim).float()
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


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 \
    + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]


def flash_decode_attention_stacked(q: torch.Tensor, k_flat: torch.Tensor,
                                   v_flat: torch.Tensor, layer: int,
                                   lengths: torch.Tensor):
    """Split-K decode attention over ONE layer of the stacked cache.

    q: [B, H, hd] scaled queries from :func:`_prep_query` (f32 or bf16);
    k_flat/v_flat: [L, B, T, K*hd] bf16 caches, read in place through
    the ``cache[layer]`` view; lengths: [B] int32 valid positions (0..T).
    Returns (acc [B, H, hd] f32 unnormalised, m [B, H] f32 running max,
    l [B, H] f32 denominator)."""
    if q.device.type == "cpu":
        return flash_decode_attention_stacked_reference(
            q, k_flat, v_flat, layer, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    b, h, head_dim = q.shape
    n_layers, kb, t, kc = k_flat.shape
    kv = kc // head_dim
    if head_dim not in _HEAD_DIMS or kc % head_dim or h % kv \
            or h // kv not in _GROUPS:
        raise ValueError(
            f"flash_decode: head_dim {head_dim} (one of {_HEAD_DIMS}) and "
            f"query groups {h}/{kv} (one of {_GROUPS}) not supported")
    if kb != b or v_flat.shape != k_flat.shape \
            or not 0 <= layer < n_layers:
        raise ValueError(
            f"flash_decode: q {tuple(q.shape)} does not match the cache "
            f"{tuple(k_flat.shape)} / {tuple(v_flat.shape)} at layer "
            f"{layer}")
    if k_flat.dtype != torch.bfloat16 or v_flat.dtype != torch.bfloat16:
        raise TypeError("flash_decode: the kernel reads a bf16 cache")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_decode: query dtype {q.dtype}")
    if not (k_flat.is_contiguous() and v_flat.is_contiguous()):
        raise ValueError("flash_decode: the stacked cache must be "
                         "contiguous")
    if lengths.dtype != torch.int32 or lengths.shape != (b,) \
            or lengths.device != q.device:
        raise ValueError("flash_decode: lengths must be [B] int32 on the "
                         "query's device")
    q = q.contiguous()
    lengths = lengths.contiguous()
    k_layer, v_layer = k_flat[layer], v_flat[layer]
    acc = torch.empty((b, h, head_dim), device=q.device,
                      dtype=torch.float32)
    m = torch.empty((b, h), device=q.device, dtype=torch.float32)
    l = torch.empty_like(m)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _build.entry("aiko_flash_decode", _ARGTYPES)(
        q.data_ptr(), int(q.dtype == torch.bfloat16),
        k_layer.data_ptr(), v_layer.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, kv, h // kv,
        head_dim, t, k_layer.stride(0), k_layer.stride(1), stream)
    _build.check(status, "flash_decode_attention_stacked")
    flash_decode_attention_stacked.launches += 1
    return acc, m, l


flash_decode_attention_stacked.launches = 0


def flash_decode_append_stacked(q, k_view, v_view, layer: int, k_new, v_new,
                                lengths):
    """Layer-loop form of ``attention_decode_append`` on the kernel: the
    cache stays stacked (``_split_stacked`` views) and ``layer`` picks
    the layer inside the kernel's addressing -- no per-layer copy.
    q: [B, 1, H, hd]; k_new/v_new: [B, 1, K, hd] the current token's
    k/v (not yet written); lengths: [B] int32.  Returns [B, 1, H, hd] in
    q's dtype."""
    b, _, h, d = q.shape
    k_payload, _ = k_view
    v_payload, _ = v_view
    kv = k_payload.shape[3] // d
    q_flat = q[:, 0]
    q_scaled, scale = _prep_query(q_flat, d)
    acc, m, l = flash_decode_attention_stacked(
        q_scaled, k_payload, v_payload, layer, lengths)
    out = _combine_self(acc, m, l, q_flat, k_new, v_new, scale)
    return out.reshape(q.shape).to(q.dtype)
