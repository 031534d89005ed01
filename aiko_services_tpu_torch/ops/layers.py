"""Transformer building blocks: RMSNorm, RoPE, attention, SwiGLU.

Counterpart of ``aiko_services_tpu/ops/layers.py``: plain functions on
tensors, the same layouts and the same numerics.  Products whose JAX
form asks for ``preferred_element_type=float32`` are taken on operands
upcast to float32 (every bf16 product is exact in f32, so the sum
matches XLA's f32 accumulation up to order); normalisation statistics
and softmax run in float32.  These are the reference path every kernel
is held against and what ``decode_attention="dense"`` runs.

The attention functions also take int8 cache layers (``{"int8",
"scale"}``, ``models/quant.py``), as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

__all__ = ["rms_norm", "rope_frequencies", "apply_rope", "swiglu",
           "repeat_kv", "attention_prefill", "attention_decode",
           "attention_decode_append"]

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + epsilon)
    return (x32 * scale).to(x.dtype) * weight


def rope_frequencies(head_dim: int, max_positions: int,
                     theta: float = 500_000.0,
                     device: str | torch.device | None = None) \
        -> torch.Tensor:
    """[2, max_positions, head_dim//2] cos/sin table (float32), computed
    in numpy exactly as the JAX package computes it, on ``device`` (the
    card unless "cpu" is asked for, as every entry point of the port)."""
    device = resolve_device(device)
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2,
                                          dtype=np.float32) / head_dim))
    positions = np.arange(max_positions, dtype=np.float32)
    angles = np.outer(positions, inv_freq)
    table = np.stack([np.cos(angles), np.sin(angles)]).astype(np.float32)
    return torch.from_numpy(table).to(device)


def apply_rope(x: torch.Tensor, rope_table: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] absolute positions."""
    positions = positions.long()
    cos = rope_table[0][positions][:, :, None, :]        # [B, S, 1, hd/2]
    sin = rope_table[1][positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def repeat_kv(kv: torch.Tensor, repeats: int) -> torch.Tensor:
    """[B, S, K, hd] -> [B, S, K*repeats, hd] for grouped-query attention."""
    if repeats == 1:
        return kv
    b, s, k, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, k, repeats, d) \
        .reshape(b, s, k * repeats, d)


def _split_kv(layer):
    """(payload [B, T, K, hd], per-position scale [B, T, K] float32 or
    None).  An int8 layer (``{"int8", "scale"}``) comes apart into its
    codes and its scales, which apply outside the attention products
    (to the score logits for keys, to the softmax weights for values):
    exact, since each scale is constant along the contracted head_dim."""
    if isinstance(layer, dict) and "int8" in layer and "scale" in layer:
        return layer["int8"], layer["scale"][..., 0].float()
    return layer, None


def _exact_int8_dot(pattern: str, a: torch.Tensor, b: torch.Tensor,
                    terms: int) -> torch.Tensor:
    """``einsum(pattern, a, b)`` of two operands holding int8 codes,
    computed exactly (the JAX package's int8 x int8 -> int32 dot).
    torch's einsum on int8 tensors accumulates IN int8 and wraps, and
    CUDA has no general int32 matmul, so the product runs in float: a
    sum of ``terms`` products of codes of magnitude <= 127 stays below
    ``terms * 127**2``, and every partial sum is an exact float32
    integer while that is below 2**24 (terms <= 1040).  Longer
    contractions run in float64.  The score dot contracts head_dim
    (128 at Llama-3: 2.1e6) and stays float32; the weighted sum
    contracts the cache extent T and needs float64 beyond 1040
    positions, where the decode path takes the flash kernel by default
    anyway."""
    dtype = torch.float32 if terms * 127 * 127 < 2 ** 24 \
        else torch.float64
    return torch.einsum(pattern, a.to(dtype), b.to(dtype))


def attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_positions: torch.Tensor,
                      kv_length_mask: torch.Tensor | None = None,
                      kv_positions: torch.Tensor | None = None) \
        -> torch.Tensor:
    """Causal attention for a prompt chunk.

    q: [B, S, H, hd]; k/v: [B, T, K, hd] with K dividing H (queries are
    grouped onto their kv head, the repeated cache is never built);
    q_positions: [B, S] absolute query positions; kv_length_mask:
    [B, T] bool of valid cache slots; kv_positions: [B, T] absolute key
    positions (default ``arange(T)``).  float32 softmax; returns
    [B, S, H, hd] in v's dtype (q's for an int8 cache).

    k/v may be int8 cache layers: the codes widen to q's dtype, key
    scales multiply the logits and value scales fold into the softmax
    weights -- exact dequantization."""
    k, k_scale = _split_kv(k)
    v, v_scale = _split_kv(v)
    if k_scale is not None:
        k = k.to(q.dtype)
    if v_scale is not None:
        v = v.to(q.dtype)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = d ** -0.5
    grouped = q.reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", grouped.float(),
                          k.float()) * scale
    if k_scale is not None:                        # [B,T,K] -> [B,K,1,1,T]
        logits = logits * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    if kv_positions is None:
        key_pos = torch.arange(t, device=q.device)[None, None, None,
                                                   None, :]
    else:
        key_pos = kv_positions[:, None, None, None, :]
    causal = key_pos <= q_positions[:, None, None, :, None]
    if kv_length_mask is not None:
        causal = causal & kv_length_mask[:, None, None, None, :]
    logits = torch.where(causal, logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        weights = weights * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkgst,btkd->bskgd",
                       weights.to(v.dtype).float(), v.float())
    return out.reshape(b, s, h, d).to(v.dtype)


def attention_decode_append(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over the cache PLUS the current token's k/v,
    which is not yet written to the cache (the softmax is split into a
    cache part and a self part, as in the JAX package).

    GQA is written as block-diagonal products over the fused K*hd axis:
    each query head is zero-padded to the full K*hd width with its
    values in its own kv head's block.  q: [B, 1, H, hd]; k_cache /
    v_cache: [B, T, K, hd] bf16 or f32, or int8 cache layers;
    k_new/v_new: [B, 1, K, hd]; lengths: [B] valid cache positions (not
    counting the current token).  Returns [B, 1, H, hd] in q's dtype.

    Over int8 layers both cache products run on int8 codes, as the JAX
    package's native int8 dots do (``_exact_int8_dot`` computes them
    exactly): the query quantizes per (batch, head) for the score dot,
    and the softmax weights, value scales folded in, quantize per
    (batch, head) for the weighted sum, while the denominator stays the
    exact float sum.  That is bounded-approximate at the int8 step size,
    and a diffuse tail of weights each under half a step drops out of
    the numerator altogether (the documented worst case of the JAX
    package's docstring), which is why long caches decode on the flash
    kernel (exact in-kernel dequantization) by default."""
    k_cache, k_scale = _split_kv(k_cache)                    # [B, T, K]
    v_cache, v_scale = _split_kv(v_cache)
    b, _, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    scale = d ** -0.5
    blocks = torch.arange(h, device=q.device) // (h // kv)
    onehot = F.one_hot(blocks, kv).to(q.dtype)                # [H, K]
    q_flat = q[:, 0]                                          # [B, H, hd]
    q_pad = torch.einsum("bhd,hk->bhkd", q_flat, onehot) \
        .reshape(b, h, kv * d)
    k_flat = k_cache.reshape(b, t, kv * d)
    v_flat = v_cache.reshape(b, t, kv * d)
    if k_scale is not None:
        q_step = torch.clamp(q_pad.float().abs().amax(-1, keepdim=True),
                             min=1e-8) / 127.0
        q_codes = torch.clamp(torch.round(q_pad.float() / q_step),
                              -127, 127)
        dots = _exact_int8_dot("bhc,btc->bht", q_codes, k_flat, terms=d)
        cache_logits = (dots.float() * q_step * scale
                        * k_scale.permute(0, 2, 1)[:, blocks, :])
    else:
        cache_logits = torch.einsum("bhc,btc->bht", q_pad.float(),
                                    k_flat.float()) * scale
    valid = torch.arange(t, device=q.device)[None, None, :] \
        < lengths.to(q.device)[:, None, None]
    cache_logits = torch.where(valid, cache_logits,
                               torch.full_like(cache_logits, NEG_INF))
    k_new_h = k_new[:, 0][:, blocks, :]
    v_new_h = v_new[:, 0][:, blocks, :]
    self_logits = (q_flat.float() * k_new_h.float()).sum(-1) * scale
    peak = torch.maximum(cache_logits.amax(-1), self_logits)
    cache_weights = torch.exp(cache_logits - peak[:, :, None])
    self_weights = torch.exp(self_logits - peak)
    denominator = cache_weights.sum(-1) + self_weights
    if v_scale is not None:
        folded = cache_weights * v_scale.permute(0, 2, 1)[:, blocks, :]
        w_step = torch.clamp(folded.amax(-1, keepdim=True),
                             min=1e-30) / 127.0
        w_codes = torch.clamp(torch.round(folded / w_step), 0, 127)
        fused = _exact_int8_dot("bht,btc->bhc", w_codes, v_flat,
                                terms=t).float() * w_step
    else:
        fused = torch.einsum("bht,btc->bhc",
                             cache_weights.to(v_cache.dtype).float(),
                             v_flat.float())
    cache_part = torch.einsum("bhkd,hk->bhd", fused.reshape(b, h, kv, d),
                              onehot.float())
    out = (cache_part + self_weights[:, :, None] * v_new_h.float()) \
        / denominator[:, :, None]
    return out.reshape(q.shape).to(q.dtype)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-token decode against the cache.  q: [B, 1, H, hd];
    k_cache/v_cache: [B, T, K, hd]; lengths: [B] valid positions
    (including the token just written).  Returns [B, 1, H, hd]."""
    b, s, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    scale = d ** -0.5
    grouped = q.reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", grouped.float(),
                          k_cache.float()) * scale
    valid = torch.arange(t, device=q.device)[None, None, None, None, :] \
        < lengths.to(q.device)[:, None, None, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd",
                       weights.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(q.shape).to(v_cache.dtype)
