"""Named-axis device meshes and the SPMD runner of the port: the JAX
package's ``parallel/mesh.py`` (``make_mesh``, ``MeshPlan``, ``P``,
``shard_map``) with ``jax.lax``'s collectives.

A :class:`Mesh` names the axes of a grid of ``torch.device``\\ s:
``mesh.shape`` is a dict of axis sizes and ``mesh.devices`` a numpy
object array, so ``.flat`` and ``.size`` read as in the JAX code.  A
mesh may list one device at several positions: ``{"sp": 4}`` over
``[cuda:0] * 4`` stands four positions on one card, each with its own
shard, and runs every hop, mask and reduction a four-card mesh runs
(the copies between positions on one card cost nothing).  CPU
descriptors (``torch.device("cpu", i)``) stand for cards in the tests;
a tensor put on any of them lies on the CPU.

:func:`shard_map` is how a value is sharded: it splits global tensors
by :class:`P` specs onto the mesh's positions, runs the function once a
position -- one thread each, from ONE process, as the JAX package
drives every local chip from one process -- and reassembles the
outputs.  Inside, :func:`ppermute`, :func:`all_to_all`,
:func:`all_gather`, :func:`psum` and :func:`axis_index` exchange
tensors between the positions by device copies (peer to peer between
cards), through the :class:`Collectives` of the calling position;
every one is a differentiable tensor expression of the other
positions' tensors, so gradients flow back through it.  A
``torch.distributed`` backend for meshes across hosts implements the
same interface (ROADMAP).

A :class:`MeshPlan` still resolves its stage-placement requests to ONE
device, ``plan.device`` (the mesh's first): ``shard(*spec)`` and
``replicated()`` place a stage's tensors whole on one card, and a plan
over more than one CUDA card raises when a tensor is put on it
(placing stages over cards is ROADMAP Queue 1 item 7), so it never
computes on one card in silence.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Sequence

import numpy as np
import torch

from .. import device as device_rule
from ..utils import not_ported

__all__ = ["AXIS_ORDER", "Mesh", "MeshPlan", "make_mesh", "P",
           "filter_spec", "shard_map", "Collectives", "MeshAborted",
           "ppermute", "all_to_all", "all_gather", "psum", "axis_index"]

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

    def _filter_spec(self, spec: "P") -> "P":
        return filter_spec(self.mesh, spec)

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


class P(tuple):
    """The port's ``PartitionSpec``: one entry a dimension, each
    ``None`` (whole), an axis name, or a tuple of axis names (the
    dimension split over their product, the first axis major).
    Dimensions past the last entry are whole.  A tuple of one name is
    that name and a list is a tuple, as ``PartitionSpec`` stores them."""

    def __new__(cls, *entries):
        def canonical(entry):
            if isinstance(entry, (tuple, list)):
                return entry[0] if len(entry) == 1 else tuple(entry)
            return entry
        return super().__new__(cls, (canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def filter_spec(mesh: Mesh, spec: P) -> P:
    """``spec`` with the axis names ``mesh`` lacks dropped (an entry left
    with none becomes ``None``), so one model's specs serve every mesh:
    the JAX package's ``MeshPlan._filter_spec``."""
    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in mesh.axis_names)
            return kept if kept else None
        return entry if entry in mesh.axis_names else None
    return P(*[keep(entry) for entry in spec])


def _axes(entry) -> tuple:
    """A spec entry or collective's axis name(s) as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class MeshAborted(RuntimeError):
    """Raised at a position waiting in a collective when another
    position of the same call failed."""


class Collectives:
    """The collectives a position calls, keyed by mesh axis name (or a
    tuple of names: the positions that differ only on those axes, in
    row-major order of their coordinates).  Every position of a group
    calls the same collectives in the same order.  :func:`shard_map`
    runs each position under an instance of :class:`_LocalCollectives`
    (positions as threads of this process); a backend over processes
    implements the same five methods."""

    def axis_index(self, axis_name) -> int:
        raise NotImplementedError

    def ppermute(self, x, axis_name, perm):
        raise NotImplementedError

    def all_to_all(self, x, axis_name, split_axis: int, concat_axis: int):
        raise NotImplementedError

    def all_gather(self, x, axis_name, axis: int = 0):
        raise NotImplementedError

    def psum(self, x, axis_name):
        raise NotImplementedError


class _Exchange:
    """The meeting point of one :func:`shard_map` call's positions.

    ``gather`` hands each member of a group every member's value (the
    objects, no copy), in group order.  A failure at any position
    (``abort``) wakes every waiter with :class:`MeshAborted`, and a
    position that returned (``finish``) while a member of its group
    waits for it fails that wait, so no call hangs."""

    def __init__(self, count: int):
        self._cond = threading.Condition()
        self._calls = [0] * count
        self._slots: dict = {}
        self._finished: set = set()
        self._failed: int | None = None

    def gather(self, position: int, members: tuple, index: int, value):
        with self._cond:
            key = (self._calls[position], members)
            self._calls[position] += 1
            slot = self._slots.setdefault(key, {"values": {}, "read": 0})
            slot["values"][index] = value
            self._cond.notify_all()
            while len(slot["values"]) < len(members):
                if self._failed is not None:
                    raise MeshAborted(
                        f"position {position}: position {self._failed} of "
                        f"the mesh failed")
                gone = [member for rank, member in enumerate(members)
                        if member in self._finished
                        and rank not in slot["values"]]
                if gone:
                    raise RuntimeError(
                        f"position {position} waits in a collective that "
                        f"position {gone[0]} returned without joining")
                self._cond.wait()
            slot["read"] += 1
            if slot["read"] == len(members):
                del self._slots[key]
            return [slot["values"][rank] for rank in range(len(members))]

    def abort(self, position: int) -> None:
        with self._cond:
            if self._failed is None:
                self._failed = position
            self._cond.notify_all()

    def finish(self, position: int) -> None:
        with self._cond:
            self._finished.add(position)
            self._cond.notify_all()


class _LocalCollectives(Collectives):
    """One position of a mesh run by threads of this process.  A value
    from another position comes over by ``.to(device)`` (nothing is
    copied between positions on one device); reductions sum in position
    order, so every member of a group gets the same bits whatever order
    the threads arrive in."""

    def __init__(self, exchange: _Exchange, mesh: Mesh, position: int):
        self._exchange = exchange
        self._mesh = mesh
        self._position = position
        self._coords = np.unravel_index(position, mesh.devices.shape)
        self.device = _placed(mesh.devices.flat[position])

    def _group(self, axis_name) -> tuple[tuple, int]:
        """(the group's positions in order, this position's rank)."""
        axes = _axes(axis_name)
        unknown = [a for a in axes if a not in self._mesh.axis_names]
        if unknown or not axes:
            raise ValueError(f"collective over {axis_name!r}: the mesh "
                             f"has axes {self._mesh.axis_names}")
        dims = [self._mesh.axis_names.index(a) for a in axes]
        sizes = [self._mesh.devices.shape[d] for d in dims]
        members = []
        for offsets in np.ndindex(*sizes):
            coords = list(self._coords)
            for dim, offset in zip(dims, offsets):
                coords[dim] = offset
            members.append(int(np.ravel_multi_index(
                coords, self._mesh.devices.shape)))
        return tuple(members), members.index(self._position)

    def _gather(self, axis_name, value) -> tuple[list, int]:
        members, rank = self._group(axis_name)
        return self._exchange.gather(self._position, members, rank,
                                     value), rank

    def _here(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor.to(self.device)

    def axis_index(self, axis_name) -> int:
        return self._group(axis_name)[1]

    def ppermute(self, x, axis_name, perm):
        values, rank = self._gather(axis_name, x)
        sources = [src for src, dst in perm if dst == rank]
        if not sources:                     # jax.lax.ppermute: zeros
            return _map_values(torch.zeros_like, x)
        return _map_values(self._here, values[sources[0]])

    def all_to_all(self, x, axis_name, split_axis: int, concat_axis: int):
        values, rank = self._gather(axis_name, x)
        n = len(values)
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dimension {split_axis} of "
                             f"{tuple(x.shape)} does not split {n} ways")
        return torch.cat([self._here(value.chunk(n, split_axis)[rank])
                          for value in values], concat_axis)

    def all_gather(self, x, axis_name, axis: int = 0):
        values, _ = self._gather(axis_name, x)
        return torch.cat([self._here(value) for value in values], axis)

    def psum(self, x, axis_name):
        values, _ = self._gather(axis_name, x)
        total = self._here(values[0])
        for value in values[1:]:
            total = total + self._here(value)
        return total


def _placed(device: torch.device) -> torch.device:
    """Where a tensor of position ``device`` lives (a CPU descriptor's
    tensors lie on the CPU)."""
    return torch.device("cpu") if device.type == "cpu" else device


def _map_values(fn, value):
    """``fn`` over a tensor or a tuple/list of tensors."""
    if isinstance(value, (tuple, list)):
        return type(value)(fn(item) for item in value)
    return fn(value)


_current = threading.local()


def _collectives() -> Collectives:
    found = getattr(_current, "collectives", None)
    if found is None:
        raise RuntimeError("a collective is called outside shard_map")
    return found


def axis_index(axis_name) -> int:
    """This position's index along ``axis_name`` (``jax.lax.axis_index``;
    a Python int, since the port runs eagerly)."""
    return _collectives().axis_index(axis_name)


def ppermute(x, axis_name, perm):
    """``jax.lax.ppermute``: ``perm`` lists (source, destination) index
    pairs along ``axis_name``; a position no pair sends to gets zeros.
    ``x`` may be a tuple or list of tensors, exchanged together."""
    return _collectives().ppermute(x, axis_name, perm)


def all_to_all(x, axis_name, split_axis: int, concat_axis: int):
    """``jax.lax.all_to_all(..., tiled=True)``: ``x`` splits into n
    chunks along ``split_axis``; chunk j goes to position j, which
    concatenates what it receives along ``concat_axis`` in source
    order."""
    return _collectives().all_to_all(x, axis_name, split_axis, concat_axis)


def all_gather(x, axis_name, axis: int = 0):
    """``jax.lax.all_gather(..., tiled=True)``: every position's ``x``
    concatenated along ``axis`` in position order."""
    return _collectives().all_gather(x, axis_name, axis)


def psum(x, axis_name):
    """``jax.lax.psum``: the sum over ``axis_name``, in position order."""
    return _collectives().psum(x, axis_name)


def _map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over a tree of dicts, tuples and lists whose
    leaves are tensors, against a tree of :class:`P` of the same
    structure."""
    if isinstance(specs, P):
        return fn(specs, tree)
    if isinstance(specs, dict):
        return {key: _map_specs(fn, specs[key], tree[key]) for key in specs}
    return type(specs)(_map_specs(fn, spec, leaf)
                       for spec, leaf in zip(specs, tree, strict=True))


def _layout(mesh: Mesh, spec: P, ndim: int) -> list[tuple]:
    """``spec``'s split dimensions: (dim, axes, shard count)."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{ndim} dimensions of its tensor")
    layout = []
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        unknown = [a for a in axes if a not in mesh.axis_names]
        if unknown:
            raise ValueError(f"spec {spec} names {unknown}, not axes of "
                             f"the mesh {mesh.shape}")
        if axes:
            layout.append((dim, axes, int(np.prod([mesh.shape[a]
                                                   for a in axes]))))
    return layout


def _shard_index(mesh: Mesh, coords, axes) -> int:
    """The shard a position holds of a dimension split over ``axes``."""
    index = 0
    for axis in axes:
        index = index * mesh.shape[axis] \
            + coords[mesh.axis_names.index(axis)]
    return index


def _split(mesh: Mesh, position: int, device, spec: P, tensor):
    """``position``'s shard of a global tensor under ``spec``, on its
    device (a view where the device is the tensor's own)."""
    coords = np.unravel_index(position, mesh.devices.shape)
    for dim, axes, count in _layout(mesh, spec, tensor.ndim):
        if tensor.shape[dim] % count:
            raise ValueError(f"dimension {dim} of {tuple(tensor.shape)} "
                             f"does not split {count} ways ({spec})")
        size = tensor.shape[dim] // count
        tensor = tensor.narrow(dim, _shard_index(mesh, coords, axes) * size,
                               size)
    return tensor.to(device)


def _assemble(mesh: Mesh, spec: P, outputs: list, device):
    """The global tensor from every position's output under ``spec``:
    the shards of split dimensions concatenated in order, a replicated
    shard taken from the position with coordinate 0 on each axis the
    spec does not name."""
    layout = _layout(mesh, spec, outputs[0].ndim)

    def block(shard: tuple) -> torch.Tensor:
        coords = [0] * len(mesh.axis_names)
        for (_, axes, _), index in zip(layout, shard):
            sizes = [mesh.shape[a] for a in axes]
            for axis, coord in zip(axes, np.unravel_index(index, sizes)):
                coords[mesh.axis_names.index(axis)] = int(coord)
        position = int(np.ravel_multi_index(coords, mesh.devices.shape))
        return outputs[position].to(device)

    def build(prefix: tuple) -> torch.Tensor:
        if len(prefix) == len(layout):
            return block(prefix)
        dim, _, count = layout[len(prefix)]
        return torch.cat([build(prefix + (index,))
                          for index in range(count)], dim)
    return build(())


def _run_position(fn, args, exchange, mesh, position, errors, results,
                  modes, stream):
    """One position's thread: ``fn`` under the caller's grad and
    inference modes and CUDA stream.  Any failure is kept for the
    caller to raise and aborts the other positions' waits."""
    _current.collectives = _LocalCollectives(exchange, mesh, position)
    inference, grad = modes
    try:
        with torch.inference_mode(inference), torch.set_grad_enabled(grad), \
                (torch.cuda.stream(stream) if stream is not None
                 else contextlib.nullcontext()):
            results[position] = fn(*args)
    except BaseException as error:     # re-raised by shard_map's caller
        errors[position] = error
        exchange.abort(position)
    finally:
        exchange.finish(position)
        _current.collectives = None


def shard_map(fn: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``jax.shard_map``: the returned function splits its positional
    arguments (trees of tensors) by ``in_specs`` onto ``mesh``'s
    positions, runs ``fn`` on each position's shards -- one thread a
    position, each on its position's device, under the caller's grad
    mode and current CUDA stream -- and reassembles the outputs by
    ``out_specs`` on the mesh's first device.  The outputs stay attached
    to the inputs' autograd graph.

    A position that raises aborts the call: the positions waiting in a
    collective raise :class:`MeshAborted`, and the call re-raises the
    first failure in position order that is not an abort."""
    def run(*args):
        count = mesh.size
        devices = [_placed(device) for device in mesh.devices.flat]
        exchange = _Exchange(count)
        results, errors = [None] * count, [None] * count
        modes = (torch.is_inference_mode_enabled(), torch.is_grad_enabled())
        threads = []
        for position, device in enumerate(devices):
            local = _map_specs(
                lambda spec, leaf: _split(mesh, position, device, spec,
                                          leaf), tuple(in_specs), args)
            stream = (torch.cuda.current_stream(device)
                      if device.type == "cuda" else None)
            threads.append(threading.Thread(
                target=_run_position, name=f"shard_map-{position}",
                args=(fn, local, exchange, mesh, position, errors,
                      results, modes, stream), daemon=True))
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        failures = [error for error in errors if error is not None]
        if failures:
            first = next((error for error in failures
                          if not isinstance(error, MeshAborted)),
                         failures[0])
            raise first
        return _gather_outputs(mesh, out_specs, results, devices[0])
    return run


def _gather_outputs(mesh: Mesh, out_specs, results: list, device):
    """Every position's output tree -> one tree of global tensors."""
    if isinstance(out_specs, P):
        return _assemble(mesh, out_specs, results, device)
    if isinstance(out_specs, dict):
        return {key: _gather_outputs(mesh, spec,
                                     [result[key] for result in results],
                                     device)
                for key, spec in out_specs.items()}
    return type(out_specs)(
        _gather_outputs(mesh, spec, [result[index] for result in results],
                        device)
        for index, spec in enumerate(out_specs))
