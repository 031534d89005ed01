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
``int8_matmul.launches``) and the tensor-core admission route (M > 16:
prompt chunks and the verify forward, counted in
``int8_matmul.wide_launches``).

On a CPU tensor the wrapper runs the plain version below; on a CUDA
tensor it launches the kernel or raises (bf16 x, D a multiple of 8 and
F of 16, contiguous operands).  Selected through
``ops.matmul_backend``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_reference", "kernel_tiles"]

#: the largest M the decode route takes; larger M takes the admission route.
DECODE_ROWS = 16


def int8_matmul_reference(x: torch.Tensor, w_int8: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the float32 product of the widened
    operands, scaled per column, cast to x's dtype."""
    return ((x.float() @ w_int8.float())
            * scale.reshape(1, -1).float()).to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _build.entry("aiko_int8_matmul", _ARGTYPES)(
        x.data_ptr(), w_int8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, d, f, stream)
    _build.check(status, "int8_matmul")
    if m <= DECODE_ROWS:
        int8_matmul.launches += 1
    else:
        int8_matmul.wide_launches += 1
    return out


int8_matmul.launches = 0
int8_matmul.wide_launches = 0


def kernel_tiles(m: int, f: int) -> tuple[int, int, int]:
    """(tile rows, tile columns, blocks) of the kernel's launch for an
    [m, *] @ [*, f] product (builds the kernel library)."""
    values = [ctypes.c_int() for _ in range(3)]
    _build.entry("aiko_int8_matmul_tiles",
                 [ctypes.c_int, ctypes.c_int]
                 + [ctypes.POINTER(ctypes.c_int)] * 3,
                 None)(m, f, *(ctypes.byref(v) for v in values))
    return tuple(v.value for v in values)
