"""Parameters from numpy: the JAX package's pytree into the port's
tensors.

numpy has no bfloat16, and the port does not depend on ``ml_dtypes``, so
a bf16 leaf travels either as float32 values (widened, exact) or as its
raw bits: a ``(uint16 array, "bfloat16")`` pair -- the integer view plus
dtype tag that ``pipeline/codec.py`` uses on the wire.  Raw bits are
re-viewed, so the round trip is bit-exact.

A quantized tree (``models/quant.py`` ``quantize_params`` on either
side) bridges too: its ``{"int8", "scale"}`` leaves keep their own
dtypes, int8 codes and float32 scales.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .llama import LlamaConfig, _dtype, param_shapes

__all__ = ["params_from_numpy", "leaf_to_tensor"]

_TAGGED = {"bfloat16": torch.bfloat16}


def leaf_to_tensor(leaf, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """One leaf -> a tensor of ``dtype`` on ``device``.  A tagged
    ``(uint16 array, "bfloat16")`` pair is re-viewed bit for bit; a plain
    array is converted (float32 holding bf16 values narrows exactly)."""
    if isinstance(leaf, tuple):
        bits, tag = leaf
        bits = np.array(bits, order="C")
        if tag not in _TAGGED or bits.dtype != np.uint16:
            raise ValueError(f"params_from_numpy: a tagged leaf must be a "
                             f"uint16 view tagged one of {sorted(_TAGGED)}; "
                             f"got {bits.dtype} tagged {tag!r}")
        tensor = torch.from_numpy(bits.view(np.int16)).view(_TAGGED[tag])
    else:
        tensor = torch.from_numpy(np.array(leaf, order="C"))
    return tensor.to(device=device, dtype=dtype)


def params_from_numpy(tree: dict, config: LlamaConfig,
                      device: str | torch.device | None = None) -> dict:
    """The JAX package's layer-stacked parameter dict, leaves as numpy
    arrays or tagged bf16 views, -> the port's parameter dict on
    ``device`` (the card unless "cpu" is asked for), in the config's
    dtype.  Every leaf must be present with the layout's shape; a
    weight-only int8 leaf ``{"int8": [..., D, F], "scale": [..., 1, F]}``
    keeps int8 codes and float32 scales."""
    device = resolve_device(device)
    dtype = _dtype(config)

    def checked(leaf, leaf_dtype, shape, path: str) -> torch.Tensor:
        tensor = leaf_to_tensor(leaf, leaf_dtype, device)
        if tuple(tensor.shape) != shape:
            raise ValueError(f"params_from_numpy: {path} has shape "
                             f"{tuple(tensor.shape)}, expected {shape}")
        return tensor

    def quantized(leaf: dict, shape: tuple, path: str) -> dict:
        if set(leaf) != {"int8", "scale"} \
                or np.asarray(leaf["int8"]).dtype != np.int8:
            raise ValueError(f"params_from_numpy: {path} must be an int8 "
                             f"leaf {{'int8': int8, 'scale': float32}}")
        return {"int8": checked(leaf["int8"], torch.int8, shape,
                                f"{path}/int8"),
                "scale": checked(leaf["scale"], torch.float32,
                                 shape[:-2] + (1, shape[-1]),
                                 f"{path}/scale")}

    def convert(layout: dict, subtree: dict, path: str) -> dict:
        if set(layout) != set(subtree):
            raise ValueError(f"params_from_numpy: {path or 'tree'} has "
                             f"leaves {sorted(subtree)}, expected "
                             f"{sorted(layout)}")
        out = {}
        for name, spec in layout.items():
            if isinstance(spec, dict):
                out[name] = convert(spec, subtree[name], f"{path}{name}/")
                continue
            if isinstance(subtree[name], dict):
                out[name] = quantized(subtree[name], spec[0],
                                      f"{path}{name}")
            else:
                out[name] = checked(subtree[name], dtype, spec[0],
                                    f"{path}{name}")
        return out

    return convert(param_shapes(config), tree, "")
