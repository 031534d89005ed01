"""The unplaced data plane of the port: tensor frames, shape bucketing,
the multi-host mesh request.

Counterpart of ``aiko_services_tpu/pipeline/tensor.py``, cut to what a
pipeline WITHOUT ``placement`` blocks reaches:

- swag values are ``torch.Tensor``\\ s resident on the card between
  elements;
- :class:`ShapeBucketer` rounds ragged sizes up to a few buckets, so a
  captured graph or a kernel's launch plan sees few distinct shapes;
- only when a frame must leave the process is it encoded host-side
  (:func:`encode_array` / :func:`decode_array`);
- :func:`distributed_mesh_spec` parses the ``mesh`` request exactly as
  the JAX package does; :func:`ensure_distributed` refuses a multi-host
  mesh (``torch.distributed`` bring-up is ROADMAP Queue 1 item 7).

Stage placement (``StagePlacement``), the per-element compiled-function
cache (``JitCache``), the placed element base (``TPUElement``) and
``tree_device_put`` come with the detector (ROADMAP Queue 1 item 6);
``Pipeline`` refuses a ``placement`` block until then.
"""

from __future__ import annotations

import io
import json
import os
from typing import Sequence

import numpy as np
import torch

from ..utils import not_ported

__all__ = ["ShapeBucketer", "encode_array", "decode_array",
           "distributed_mesh_spec", "ensure_distributed"]


# ---------------------------------------------------------------------------
# Multi-host mesh request (parsed as in the JAX package; bring-up waits).

MESH_ENV_HOSTS = "AIKO_MESH_HOSTS"
MESH_ENV_COORDINATOR = "AIKO_MESH_COORDINATOR"
MESH_ENV_PROCESS_ID = "AIKO_MESH_PROCESS_ID"

def distributed_mesh_spec(parameters) -> dict | None:
    """The pipeline's multi-host mesh request, or None.

    Sources, in precedence order: the ``mesh`` pipeline parameter
    (``{"hosts": N, "coordinator": "host:port", "process_id": k}`` --
    a dict or its JSON string), then the ``AIKO_MESH_*`` environment
    (hosts / coordinator / process id), so a launcher can mesh-enable
    an unmodified definition per process.  Raises ValueError on a
    malformed spec -- the same validation the ``bad-parameter`` lint
    rule applies at create time."""
    spec = (parameters or {}).get("mesh")
    if isinstance(spec, str):
        try:
            spec = json.loads(spec)
        except json.JSONDecodeError as error:
            raise ValueError(f"mesh: unparseable JSON ({error})")
    if spec is None:
        hosts_env = os.environ.get(MESH_ENV_HOSTS)
        if not hosts_env:
            return None
        spec = {"hosts": hosts_env,
                "coordinator": os.environ.get(MESH_ENV_COORDINATOR),
                "process_id": os.environ.get(MESH_ENV_PROCESS_ID, 0)}
    if not isinstance(spec, dict) or "hosts" not in spec:
        raise ValueError(
            f"mesh: expected {{'hosts': N, ...}}, got {spec!r}")
    try:
        hosts = int(spec["hosts"])
    except (TypeError, ValueError):
        raise ValueError(f"mesh: hosts={spec['hosts']!r} is not an "
                         f"integer")
    if hosts < 1:
        raise ValueError(f"mesh: hosts must be >= 1, got {hosts}")
    try:
        process_id = int(spec.get("process_id") or 0)
    except (TypeError, ValueError):
        raise ValueError(f"mesh: process_id="
                         f"{spec.get('process_id')!r} is not an "
                         f"integer")
    return {"hosts": hosts,
            "coordinator": spec.get("coordinator") or None,
            "process_id": process_id}


def ensure_distributed(spec: dict | None) -> tuple[int, int]:
    """(process index, process count) of this process.  A real
    multi-host mesh (more than one host declared) raises: the port has
    no ``torch.distributed`` bring-up yet."""
    if spec and spec["hosts"] > 1:
        raise not_ported(f"a multi-host mesh ({spec['hosts']} hosts)",
                         "ROADMAP Queue 1 item 7")
    return 0, 1


# ---------------------------------------------------------------------------
# Shape bucketing: dynamic sizes -> small set of compiled shapes.

class ShapeBucketer:
    """Round ragged dimensions up to a bucket so XLA compiles once per
    bucket instead of once per length (SURVEY.md section 7 "shape
    polymorphism" hard part).

    Default buckets are powers of two from ``minimum``; an explicit
    bucket list wins.  ``pad(array, axis)`` returns (padded, true_size).
    """

    def __init__(self, buckets: Sequence[int] | None = None,
                 minimum: int = 16, maximum: int = 1 << 20):
        self._buckets = sorted(buckets) if buckets else None
        self._minimum = minimum
        self._maximum = maximum

    def bucket(self, size: int) -> int:
        if self._buckets:
            for b in self._buckets:
                if size <= b:
                    return b
            raise ValueError(f"size {size} exceeds largest bucket "
                             f"{self._buckets[-1]}")
        b = self._minimum
        while b < size:
            b <<= 1
            if b > self._maximum:
                raise ValueError(f"size {size} exceeds maximum bucket")
        return b

    def pad(self, array, axis: int = 0, fill=0):
        size = array.shape[axis]
        target = self.bucket(size)
        if target == size:
            return array, size
        widths = [0, 0] * array.dim()
        widths[2 * (array.dim() - 1 - axis) + 1] = target - size
        return torch.nn.functional.pad(array, widths, value=fill), size


# ---------------------------------------------------------------------------
# Host-side array codec (only for frames leaving the process).

def encode_array(array) -> bytes:
    """numpy array or tensor (fetched to the host) -> self-describing
    bytes (npy format)."""
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().numpy()
    buffer = io.BytesIO()
    np.save(buffer, np.asarray(array), allow_pickle=False)
    return buffer.getvalue()


def decode_array(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.load(io.BytesIO(data), allow_pickle=False))
