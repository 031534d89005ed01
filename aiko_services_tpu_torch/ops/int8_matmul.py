"""Weight-only int8 matmul ``(x @ w_int8) * scale`` in one kernel.

Counterpart of ``aiko_services_tpu/ops/pallas_matmul.py`` (kernel #5):
x [M, D] activations, w_int8 [D, F] int8 weights, scale [1, F] (or [F])
float32 per-output-channel scales (``models/quant.py`` layout); the
result is [M, F] in x's dtype, accumulated in float32 with the scale
applied once, at the store.  The kernel is ``csrc/int8_matmul.cu`` (its
header says what bounds it and how it is laid out): the weight streams
as int8 bytes and is converted to bf16 in shared memory, so no
dequantized weight and no unscaled product reach device memory.  Two
routes, picked by M: the decode route (M <= 16, counted in
``int8_matmul.launches``), a streaming product split over D
(:func:`decode_splits`) whose f32 partials :func:`int8_combine` adds in
split order, and the tensor-core admission route (M > 16: prompt chunks
and the verify forward, counted in ``int8_matmul.wide_launches``).

On a CPU tensor the wrapper runs the plain version below; on a CUDA
tensor it launches the kernel or raises (bf16 x, D a multiple of 8 and
F of 16, contiguous operands).  Selected through
``ops.matmul_backend``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .tiles import CARD_SMS, ceil_div

__all__ = ["int8_matmul", "int8_matmul_reference", "kernel_tiles",
           "decode_splits", "int8_combine", "int8_combine_reference",
           "int8_matmul_partials_reference"]

#: the largest M the decode route takes; larger M takes the admission route.
DECODE_ROWS = 16
#: output columns and contraction depth of one decode-route block step
#: (csrc/int8_matmul.cu gemv::kBN, gemv::kBK).
DECODE_TILE_N = 64
DECODE_TILE_K = 128


def decode_splits(d: int, f: int) -> tuple[int, int]:
    """(splits, 128-deep steps a split) of the decode route for a [D, F]
    weight: split D until the grid holds about 4 x 132 blocks (F / 64
    column tiles x splits; five fit on an SM), in as few splits as do
    that -- one for the 128,256-column unembed.  A function of the
    shapes only: the route runs inside the captured draft loop."""
    steps = max(1, ceil_div(d, DECODE_TILE_K))
    wanted = ceil_div(4 * CARD_SMS, max(1, ceil_div(f, DECODE_TILE_N)))
    per_split = max(1, steps // wanted)
    return ceil_div(steps, per_split), per_split


def int8_matmul_reference(x: torch.Tensor, w_int8: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the float32 product of the widened
    operands, scaled per column, cast to x's dtype."""
    return ((x.float() @ w_int8.float())
            * scale.reshape(1, -1).float()).to(x.dtype)


def int8_matmul_partials_reference(x: torch.Tensor, w_int8: torch.Tensor
                                   ) -> torch.Tensor:
    """Plain version of the decode route's partials: the float32 product
    of each split of D (:func:`decode_splits`), unscaled, [splits, M,
    F]."""
    d, f = w_int8.shape
    splits, per_split = decode_splits(d, f)
    span = per_split * DECODE_TILE_K
    return torch.stack([x[:, z * span:(z + 1) * span].float()
                        @ w_int8[z * span:(z + 1) * span].float()
                        for z in range(splits)])


def int8_combine_reference(partial: torch.Tensor, scale: torch.Tensor,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the decode route's combine: the splits of
    ``partial`` [splits, M, F] added in split order, scaled per column,
    cast to ``dtype``."""
    total = partial[0]
    for part in partial[1:]:
        total = total + part
    return (total * scale.reshape(1, -1).float()).to(dtype)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_COMBINE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]


def _check(x: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor):
    if x.ndim != 2 or w_int8.ndim != 2 or x.shape[1] != w_int8.shape[0]:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w_int8.shape)} are not [M, D] @ [D, F]")
    if w_int8.dtype != torch.int8 or scale.numel() != w_int8.shape[1]:
        raise ValueError(f"int8_matmul: w must be int8 and scale hold one "
                         f"value per column; got {w_int8.dtype}, scale "
                         f"{tuple(scale.shape)}")


def int8_matmul(x: torch.Tensor, w_int8: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``(x @ w_int8) * scale`` -> [M, F] in x's dtype (kernel #5)."""
    _check(x, w_int8, scale)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_int8, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    m, d = x.shape
    f = w_int8.shape[1]
    if x.dtype != torch.bfloat16 or scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul: the kernel takes bf16 x and f32 "
                        f"scales; got {x.dtype} and {scale.dtype}")
    if w_int8.device != x.device or scale.device != x.device:
        raise ValueError("int8_matmul: x, w and scale must share one device")
    if d % 8 or f % 16:
        raise ValueError(f"int8_matmul: D={d} must be a multiple of 8 and "
                         f"F={f} of 16")
    if not (w_int8.is_contiguous() and scale.is_contiguous()) \
            or w_int8.data_ptr() % 16:
        raise ValueError("int8_matmul: w and scale must be contiguous, w "
                         "16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty((m, f), device=x.device, dtype=x.dtype)
    splits, per_split = decode_splits(d, f) if m <= DECODE_ROWS else (1, 1)
    partial = torch.empty((splits, m, f), device=x.device,
                          dtype=torch.float32) if splits > 1 else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _build.entry("aiko_int8_matmul", _ARGTYPES)(
        x.data_ptr(), w_int8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), m, d, f, per_split,
        stream)
    _build.check(status, "int8_matmul")
    if m > DECODE_ROWS:
        int8_matmul.wide_launches += 1
        return out
    int8_matmul.launches += 1
    if partial is None:
        return out
    return int8_combine(partial, scale, out)


int8_matmul.launches = 0
int8_matmul.wide_launches = 0


def int8_combine(partial: torch.Tensor, scale: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The decode route's combine (kernel in ``csrc/int8_matmul.cu``):
    ``partial`` [splits, M, F] f32 added in split order, scaled per
    column, rounded to bf16 into ``out`` [M, F] (new when None).  Its
    plain version :func:`int8_combine_reference` on a CPU tensor."""
    if partial.device.type == "cpu":
        return int8_combine_reference(partial, scale)
    if partial.device.type != "cuda":
        raise ValueError(f"int8_combine: unsupported device "
                         f"{partial.device}")
    splits, m, f = partial.shape
    if partial.dtype != torch.float32 or not partial.is_contiguous() \
            or scale.dtype != torch.float32 or scale.numel() != f \
            or not scale.is_contiguous() or f % 16:
        raise ValueError(f"int8_combine: partial {tuple(partial.shape)} "
                         f"{partial.dtype} and scale {tuple(scale.shape)} "
                         f"{scale.dtype}: contiguous f32, F % 16 == 0")
    if out is None:
        out = torch.empty((m, f), device=partial.device,
                          dtype=torch.bfloat16)
    status = _build.entry("aiko_int8_combine", _COMBINE_ARGTYPES)(
        partial.data_ptr(), scale.data_ptr(), out.data_ptr(), m, f, splits,
        torch.cuda.current_stream(partial.device).cuda_stream)
    _build.check(status, "int8_combine")
    int8_combine.launches += 1
    return out


int8_combine.launches = 0


def kernel_tiles(m: int, d: int, f: int) -> tuple[int, int, int]:
    """(tile rows, tile columns, blocks) of the kernel's launch for an
    [m, d] @ [d, f] product, the decode route's splits included (builds
    the kernel library)."""
    values = [ctypes.c_int() for _ in range(3)]
    _build.entry("aiko_int8_matmul_tiles",
                 [ctypes.c_int, ctypes.c_int]
                 + [ctypes.POINTER(ctypes.c_int)] * 3,
                 None)(m, f, *(ctypes.byref(v) for v in values))
    tile_m, tile_n, blocks = (v.value for v in values)
    if m <= DECODE_ROWS:
        blocks *= decode_splits(d, f)[0]
    return tile_m, tile_n, blocks
