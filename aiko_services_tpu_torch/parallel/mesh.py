"""Named-axis device meshes: the bookkeeping half of the JAX package's
``parallel/mesh.py`` (``make_mesh`` and ``MeshPlan``).

A :class:`Mesh` names the axes of a grid of ``torch.device``\\ s:
``mesh.shape`` is a dict of axis sizes and ``mesh.devices`` a numpy
object array, so ``.flat`` and ``.size`` read as in the JAX code.  A
:class:`MeshPlan` resolves every sharding request to ONE device,
``plan.device`` (the mesh's first): the port places a stage's tensors
whole on one card.  A plan over more than one CUDA card raises when a
tensor is put on it -- sharding over cards on ``torch.distributed`` is
ROADMAP Queue 1 item 7 -- so it never computes on one card in silence.
CPU descriptors (``torch.device("cpu", i)``) stand for cards in the
tests; a tensor put on any of them lies on the CPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import device as device_rule
from ..utils import not_ported

__all__ = ["AXIS_ORDER", "Mesh", "MeshPlan", "make_mesh"]

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


class Mesh:
    """Devices laid out on named axes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def make_mesh(axes: dict[str, int] | None = None,
              devices: Sequence | None = None) -> Mesh:
    """Build a named-axis Mesh.

    ``axes`` maps axis name -> size, in AXIS_ORDER; sizes of -1 are
    inferred (at most one).  With no axes, returns a 1-axis ``dp`` mesh
    over all devices.  Axis sizes must multiply to the device count.
    """
    devices = list(devices if devices is not None
                   else device_rule.local_devices())
    count = len(devices)
    if not axes:
        axes = {"dp": count}
    names = [a for a in AXIS_ORDER if a in axes]
    names += [a for a in axes if a not in AXIS_ORDER]
    sizes = [axes[a] for a in names]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if count % known:
            raise ValueError(f"cannot infer axis: {count} % {known} != 0")
        sizes[sizes.index(-1)] = count // known
    if int(np.prod(sizes)) != count:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs "
            f"{int(np.prod(sizes))} devices, have {count}")
    array = np.empty(count, dtype=object)
    for index, device in enumerate(devices):
        array[index] = device
    return Mesh(array.reshape(sizes), names)


class MeshPlan:
    """A mesh and where its tensors go.  ``shard(*spec)`` and
    ``replicated()`` both name ``plan.device``: the spec is accepted
    for the JAX package's call sites and places nothing apart."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    @classmethod
    def build(cls, axes: dict[str, int] | None = None, devices=None) \
            -> "MeshPlan":
        return cls(make_mesh(axes, devices))

    @property
    def device(self) -> torch.device:
        return self.mesh.devices.flat[0]

    def axis_size(self, name: str) -> int:
        return self.mesh.shape.get(name, 1)

    def replicated(self) -> torch.device:
        cards = {device.index or 0 for device in self.mesh.devices.flat
                 if device.type == "cuda"}
        if len(cards) > 1:
            raise not_ported(
                f"a stage over {len(cards)} CUDA cards "
                f"({self.mesh.shape})", "ROADMAP Queue 1 item 7")
        return self.device

    def shard(self, *spec) -> torch.device:
        return self.replicated()
