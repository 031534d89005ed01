"""Causal blockwise prefill attention (chunked admission).

Counterpart of ``aiko_services_tpu/ops/pallas_attention.py``
(``flash_attention``): q [B, S, H, d] attends k/v [B, T, K, d] with GQA,
causal from the absolute offset ``q_offset`` of query row 0.  The kernel
is ``csrc/flash_attention.cu`` (its header says what bounds it and how
it is laid out): bf16 inputs take its tensor-core body, f32 inputs its
FMA body.  On a CPU tensor the wrapper runs the plain PyTorch version
below, on a CUDA tensor it launches the kernel or raises.

The TPU kernel's ``pack_heads`` option is not ported: it paired two
kv heads per grid row to fill the 128-wide MXU at head_dim 64, a trick
of the TPU's matrix unit with no counterpart on Hopper.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .layers import NEG_INF

__all__ = ["flash_attention", "flash_attention_reference"]

_HEAD_DIMS = (64, 128)
# Query rows per kernel block (G heads x rows/G positions): the bf16
# tensor-core body's and the f32 FMA body's.
_ROWS = {torch.bfloat16: 128, torch.float32: 64}


def _fold_scale(q: torch.Tensor, d: int):
    """(q, score scale): the softmax scale folds into q in q's dtype when
    that is lossless (d**-0.5 a power of two); otherwise the f32 scores
    are scaled (the TPU kernel's rule)."""
    scale = d ** -0.5
    if math.log2(scale).is_integer():
        return (q.float() * scale).to(q.dtype), 1.0
    return q, scale


def flash_attention_reference(q, k, v, q_offset: int = 0, *,
                              causal: bool = True, at=None):
    """Plain PyTorch version of the kernel (one softmax pass): f32
    scores, weights exponentiated in the value dtype, f32 sums.
    ``q_offset`` may be a 0-d tensor; ``at`` as :func:`flash_attention`
    takes it."""
    if at is not None:
        k, v = (side.index_select(0, at[:1].long()) for side in (k, v))
        q_offset = at[1]
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    q, scale = _fold_scale(q, d)
    grouped = q.reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", grouped.float(),
                          k.float()) * scale
    key_pos = torch.arange(t, device=q.device)
    mask = key_pos[None, :] < t
    if causal:
        q_pos = q_offset + torch.arange(s, device=q.device)
        mask = key_pos[None, :] <= q_pos[:, None]              # [S, T]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp((scores - m_safe).to(v.dtype))
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.float().sum(-1, keepdim=True)
    acc = torch.einsum("bkgst,btkd->bkgsd", p.float(), v.float())
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
    + [ctypes.c_float] + [ctypes.c_longlong] * 6 + [ctypes.c_void_p] * 2


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, *, causal: bool = True,
                    at: torch.Tensor | None = None) -> torch.Tensor:
    """Causal flash attention.  q: [B, S, H, d]; k/v: [B, T, K, d] with
    K dividing H (bf16 or f32, all one dtype; k/v may be strided views
    of the cache with a unit-stride last dim).  ``q_offset`` is the
    absolute position of q row 0.  Returns [B, S, H, d] in q's dtype.

    ``at``: an int32 [2] tensor on q's device, (k/v batch row, offset of
    q row 0), read by the kernel on the card in place of ``q_offset``:
    q is then one row and k/v may hold any number (a whole cache
    layer), so one captured launch serves every slot and offset.  The
    caller keeps the offset within [0, T]."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, q_offset, causal=causal,
                                         at=at)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    rows = _ROWS.get(q.dtype, 64)
    if d not in _HEAD_DIMS or h % kv or rows % (h // kv):
        raise ValueError(
            f"flash_attention: head_dim {d} (one of {_HEAD_DIMS}) or "
            f"query groups {h}/{kv} (must divide {rows}) not supported")
    kv_rows = b if at is None else k.shape[0]
    if at is not None and (b != 1 or at.dtype != torch.int32
                           or at.shape != (2,) or at.device != q.device):
        raise ValueError(
            f"flash_attention: at must be an int32 [2] tensor on "
            f"{q.device} for a one-row q; got {at.dtype} "
            f"{tuple(at.shape)} on {at.device}, q batch {b}")
    if k.shape != (kv_rows, t, kv, d) or v.shape != k.shape \
            or v.stride() != k.stride():
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
            f"do not match q {tuple(q.shape)} (or differ in strides)")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; one of bf16 or f32 for all three")
    if k.stride(3) != 1:
        raise ValueError("flash_attention: k/v need a unit-stride last dim")
    if q.dtype == torch.bfloat16 and (
            k.data_ptr() % 16 or v.data_ptr() % 16
            or any(stride % 8 for stride in k.stride()[:3])):
        raise ValueError("flash_attention: bf16 k/v rows are copied in "
                         "16-byte pieces; they need 16-byte aligned "
                         "pointers and strides")
    if at is None and not 0 <= int(q_offset) <= t:
        raise ValueError(f"flash_attention: q_offset {q_offset} outside "
                         f"[0, {t}]")
    q, scale = _fold_scale(q, d)
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _build.entry("aiko_flash_attention", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), d, b, s, h, kv, t, int(q_offset),
        int(causal), scale, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        None if at is None else at.data_ptr(), stream)
    _build.check(status, "flash_attention")
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
