"""The safetensors file format, read and written by the port itself.

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of
JSON header, then the tensors' raw little-endian bytes.  The header maps
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets into the byte buffer after the header) and may hold a
``"__metadata__"`` map of strings.  The writer pads the header with
spaces to a multiple of 8 bytes and lays the tensors out back to back in
the order given, as the ``safetensors`` package accepts.

The reader maps the file and returns each tensor as a view of the
mapping (copy-on-write: a caller may write to it, the file never
changes), so a reader never holds a whole shard in host memory: a page
is read when a tensor's bytes are touched.  bf16 stays
``torch.bfloat16``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

__all__ = ["DTYPES", "read_header", "SafetensorsFile", "write_file"]

#: safetensors dtype name -> (torch dtype, numpy dtype of the same width
#: that maps the bytes; bf16 maps as int16 and is re-viewed).
DTYPES = {"BF16": (torch.bfloat16, np.int16),
          "F16": (torch.float16, np.float16),
          "F32": (torch.float32, np.float32),
          "F64": (torch.float64, np.float64),
          "I8": (torch.int8, np.int8),
          "U8": (torch.uint8, np.uint8),
          "I16": (torch.int16, np.int16),
          "I32": (torch.int32, np.int32),
          "I64": (torch.int64, np.int64),
          "BOOL": (torch.bool, np.bool_)}
_NAMES = {torch_dtype: name for name, (torch_dtype, _) in DTYPES.items()}
_HEADER_LIMIT = 100 * 2 ** 20

if sys.byteorder != "little":                   # pragma: no cover
    raise ImportError("the safetensors reader assumes a little-endian host")


def read_header(path) -> tuple[dict, int]:
    """(header dict, the byte offset where the tensor data starts)."""
    with open(path, "rb") as fh:
        prefix = fh.read(8)
        if len(prefix) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header "
                             f"length)")
        length = int.from_bytes(prefix, "little")
        if length > _HEADER_LIMIT:
            raise ValueError(f"{path}: header of {length} bytes")
        header = json.loads(fh.read(length))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    return header, 8 + length


class SafetensorsFile:
    """One file's tensors, read one at a time from a mapping of the
    file."""

    def __init__(self, path):
        self.path = os.fspath(path)
        header, self._start = read_header(self.path)
        self._metadata = header.pop("__metadata__", None) or {}
        self._entries = header
        size = os.path.getsize(self.path) - self._start
        for name, entry in header.items():
            if entry.get("dtype") not in DTYPES:
                raise ValueError(f"{self.path}: {name}: dtype "
                                 f"{entry.get('dtype')!r} is not one of "
                                 f"{sorted(DTYPES)}")
            begin, end = entry["data_offsets"]
            width = np.dtype(DTYPES[entry["dtype"]][1]).itemsize
            if end - begin != int(np.prod(entry["shape"])) * width \
                    or not 0 <= begin <= end <= size:
                raise ValueError(f"{self.path}: {name}: data_offsets "
                                 f"{[begin, end]} do not hold shape "
                                 f"{entry['shape']} of {entry['dtype']}")

    def keys(self) -> list[str]:
        return list(self._entries)

    def metadata(self) -> dict:
        return dict(self._metadata)

    def shape(self, name: str) -> tuple:
        return tuple(self._entries[name]["shape"])

    def dtype(self, name: str) -> torch.dtype:
        return DTYPES[self._entries[name]["dtype"]][0]

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor as a CPU view of the file's mapping."""
        entry = self._entries[name]
        torch_dtype, np_dtype = DTYPES[entry["dtype"]]
        shape = tuple(entry["shape"])
        count = int(np.prod(shape))
        begin = entry["data_offsets"][0]
        if count == 0:
            array = np.empty(shape, dtype=np_dtype)
        else:
            array = np.memmap(self.path, dtype=np_dtype, mode="c",
                              offset=self._start + begin,
                              shape=(count,)).reshape(shape)
        tensor = torch.from_numpy(array)
        return tensor.view(torch_dtype) if tensor.dtype != torch_dtype \
            else tensor


def _as_bytes(tensor: torch.Tensor) -> memoryview:
    flat = tensor.detach().reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.view(torch.uint8)
    elif flat.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    return memoryview(flat.numpy()).cast("B")


def write_file(path, tensors: dict, metadata: dict | None = None) -> None:
    """Write ``{name: tensor}`` (CPU tensors of the format's dtypes, or
    numpy arrays) to ``path``; ``metadata`` is a map of strings."""
    prepared, entries, offset = [], {}, 0
    for name, value in tensors.items():
        tensor = torch.from_numpy(np.ascontiguousarray(value)) \
            if isinstance(value, np.ndarray) else value
        if tensor.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {tensor.dtype} has no "
                             f"safetensors name")
        if tensor.device.type != "cpu":
            raise ValueError(f"{name}: write_file takes host tensors, got "
                             f"one on {tensor.device}")
        tensor = tensor.contiguous()
        size = tensor.numel() * tensor.element_size()
        entries[name] = {"dtype": _NAMES[tensor.dtype],
                         "shape": list(tensor.shape),
                         "data_offsets": [offset, offset + size]}
        prepared.append(tensor)
        offset += size
    if metadata:
        if not all(isinstance(key, str) and isinstance(value, str)
                   for key, value in metadata.items()):
            raise ValueError("safetensors metadata maps strings to strings")
        entries = {"__metadata__": dict(metadata), **entries}
    header = json.dumps(entries, separators=(",", ":")).encode()
    header += b" " * (-len(header) % 8)
    with open(path, "wb") as fh:
        fh.write(len(header).to_bytes(8, "little"))
        fh.write(header)
        for tensor in prepared:
            if tensor.numel():
                fh.write(_as_bytes(tensor))
