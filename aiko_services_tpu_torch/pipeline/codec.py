"""Frame wire codec: swag values <-> S-expression-safe strings.

Local (in-process) frames never touch this -- swag values including
tensors pass by reference, and with the device-resident swag
contract (pipeline/overlap.py) they stay on the card between elements.
Only frames crossing a process boundary on the *control* fabric are
encoded, and the boundary is EXPLICIT: the engine fetches every device
leaf with one counted ``TransferLedger.fetch`` before calling
:func:`encode_frame_data`, so this codec only ever sees host values.
Scalars/lists/dicts encode as S-expression terms, host arrays as base64
.npy blobs (the equivalent of the reference's PE_DataEncode/Decode
elements, reference examples/pipeline/elements.py:214-246).  Tensors
of dtypes numpy cannot hold (bfloat16, float8_*) ride a tagged integer
view instead: the torch dtype's name and the raw bytes, restored as a
CPU tensor of that dtype.  Bulk tensor traffic should use the tensor
transport; this codec is the correctness fallback, not the fast path.
"""

from __future__ import annotations

import base64
import io

import numpy as np
import torch

__all__ = ["encode_value", "decode_value", "encode_frame_data",
           "decode_frame_data", "tag_view", "untag_view"]

_NPY_PREFIX = "npy64:"
# Tensors of dtypes numpy cannot hold (torch.bfloat16, float8_*...):
# ``npyt:<torch dtype name>:<base64 npy of the same-itemsize integer
# view>``.  The integer view preserves shape (0-d included) and byte
# layout; the tag restores the dtype on decode.
_NPYT_PREFIX = "npyt:"
_VIEW_BY_ITEMSIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _extension_dtype(value) -> bool:
    """True only for host tensors whose dtype numpy cannot hold and the
    tagged view can restore; everything else takes the npy path."""
    return isinstance(value, torch.Tensor) \
        and value.dtype.itemsize in _VIEW_BY_ITEMSIZE \
        and not value.dtype.is_complex \
        and value.dtype not in (torch.uint8, torch.int8, torch.int16,
                                torch.int32, torch.float16,
                                torch.float32, torch.bool)


def _torch_dtype(tag: str) -> torch.dtype:
    dtype = getattr(torch, tag, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"codec: unknown extension dtype {tag!r}")
    return dtype


def _save_npy(array: np.ndarray) -> str:
    buffer = io.BytesIO()
    np.save(buffer, array, allow_pickle=False)
    return base64.b64encode(buffer.getvalue()).decode()


def encode_value(value):
    if hasattr(value, "__array__") and not isinstance(
            value, (str, bytes, list, tuple, dict)):
        if _extension_dtype(value):
            # bf16 and friends: npy cannot hold them.  Encode the
            # integer view + a dtype tag.
            view = _VIEW_BY_ITEMSIZE[value.dtype.itemsize]
            tag = str(value.dtype).removeprefix("torch.")
            return (f"{_NPYT_PREFIX}{tag}:"
                    f"{_save_npy(value.view(view).numpy())}")
        return _NPY_PREFIX + _save_npy(np.asarray(value))
    if isinstance(value, (list, tuple)):
        return [encode_value(v) for v in value]
    if isinstance(value, dict):
        return {k: encode_value(v) for k, v in value.items()}
    return value


def _load_npy(data: str) -> np.ndarray:
    raw = base64.b64decode(data)
    return np.load(io.BytesIO(raw), allow_pickle=False)


def decode_value(value):
    if isinstance(value, str) and value.startswith(_NPY_PREFIX):
        return _load_npy(value[len(_NPY_PREFIX):])
    if isinstance(value, str) and value.startswith(_NPYT_PREFIX):
        dtype_name, _, payload = value[len(_NPYT_PREFIX):].partition(":")
        dtype = _torch_dtype(dtype_name)
        return torch.from_numpy(_load_npy(payload)).view(dtype)
    if isinstance(value, list):
        return [decode_value(v) for v in value]
    if isinstance(value, dict):
        return {k: decode_value(v) for k, v in value.items()}
    return value


def tag_view(array) -> tuple[np.ndarray, str | None]:
    """(wire array, dtype tag): extension dtypes (bfloat16, float8_*)
    cross binary transports as same-itemsize integer VIEWS plus a name
    tag -- the exact tagging the ``npyt:`` string path above uses, so
    the tensor-pipe data plane and the MQTT codec can never disagree on
    how bf16 round-trips.  Plain dtypes pass through untagged."""
    if _extension_dtype(array):
        view = _VIEW_BY_ITEMSIZE[array.dtype.itemsize]
        return array.view(view).numpy(), \
            str(array.dtype).removeprefix("torch.")
    return np.asarray(array), None


def untag_view(array: np.ndarray, tag: str | None):
    """Restore a :func:`tag_view` integer view to its tagged dtype."""
    if not tag:
        return array
    return torch.from_numpy(np.ascontiguousarray(array)).view(
        _torch_dtype(tag))


def encode_frame_data(frame_data: dict) -> dict:
    return {name: encode_value(value) for name, value in frame_data.items()}


def decode_frame_data(frame_data: dict) -> dict:
    return {name: decode_value(value) for name, value in frame_data.items()}
