"""Named-axis device meshes, placed trees and the SPMD runner of the
port: the JAX package's ``parallel/mesh.py`` (``make_mesh``,
``MeshPlan``, ``P``, ``shard_map``) with ``jax.lax``'s collectives.

A :class:`Mesh` names the axes of a grid of ``torch.device``\\ s:
``mesh.shape`` is a dict of axis sizes and ``mesh.devices`` a numpy
object array, so ``.flat`` and ``.size`` read as in the JAX code.  A
mesh may list one device at several positions: ``{"sp": 4}`` over
``[cuda:0] * 4`` stands four positions on one card, each with its own
shard, and runs every hop, mask and reduction a four-card mesh runs
(the copies between positions on one card cost nothing).  CPU
descriptors (``torch.device("cpu", i)``) stand for cards in the tests;
a tensor put on any of them lies on the CPU.

``MeshPlan.put(tree, specs)`` places a tree, the counterpart of
``jax.device_put`` with ``NamedSharding``\\ s: it returns a
:class:`Placed` tree (no JAX counterpart: the port's sharded array), in
which every position holds its own shard of every leaf, laid out by the
filtered spec, and which lives across calls.  Positions that list the
SAME device descriptor and hold the same shard share one tensor: a
replica is stored once a device and updated once (one card standing for
eight positions holds a replicated leaf once, as the JAX package's
sharded array holds it once a chip); positions on distinct descriptors
each hold their own copy.  ``MeshPlan.gather(placed)`` (no JAX
counterpart) returns the whole tree on ``plan.device``.
``MeshPlan.shard(*spec)`` returns a :class:`NamedSharding` whose
``.spec`` is the filtered spec; ``.put(value)`` places a tree by it (a
:class:`Placed`, what a stage hop with a spec returns), and ``.device``
is the stage's LEAD card, ``plan.device`` (the first of its
topology-sorted chunk), where a stage's unsharded tensors go.  Under
GSPMD the JAX package's replicated array makes every chip of a stage
compute the same value, so one computation on the lead card gives the
same numbers; only elements that shard (a ``Detector`` over dp, a
placed tree over tp) use the other cards.  :meth:`Placed.reshard`
moves a placed tree onto another mesh and spec (gathered onto the
target's lead card, then split), and :func:`submesh` carves one slice
of a mesh, as the JAX package's does.

:func:`shard_map` runs a function once a position -- one thread each,
from ONE process, as the JAX package drives every local chip from one
process.  It splits global tensor arguments by :class:`P` specs, takes
:class:`Placed` arguments as they stand (each position its own shard),
and reassembles the outputs by their specs, or keeps them placed where
an out spec is :class:`Keep` (as ``out_shardings`` keeps parameters and
caches sharded).  Inside, :func:`ppermute`, :func:`all_to_all`,
:func:`all_gather`, :func:`psum` and :func:`axis_index` exchange
tensors between the positions by device copies (peer to peer between
cards), through the :class:`Collectives` of the calling position;
every one is a differentiable tensor expression of the other
positions' tensors, so the positions' work forms ONE autograd graph and
gradients flow back through it.  :func:`remat` is ``jax.checkpoint``
inside a mapped function: a function's activations dropped and
recomputed in the backward pass by every position together, its
collectives included.

A mesh over the GLOBAL pool of a multi-host bring-up
(``parallel/distributed.py``; :func:`make_mesh`'s default, as
``jax.devices()`` is the JAX package's) may span processes.  Every
process runs the same program: each runs its own positions of a
:func:`shard_map` call, a collective whose group spans processes swaps
the processes' values over the group's process group (the second
backend behind :class:`Collectives`), and the outputs come out whole in
every process (the shards another process computed are fetched; their
gradients stay with the process that computed them, since every process
computes the same loss of the whole).  A :class:`Placed` tree holds
tensors at this process's positions only (None at another's);
``gather`` fetches the rest.  :attr:`MeshPlan.device` is the mesh's
first device of THIS process (a descriptor of another process for a
mesh wholly there, on which nothing is placed).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Sequence

import numpy as np
import torch

from .. import device as device_rule
from . import distributed

__all__ = ["AXIS_ORDER", "Mesh", "MeshPlan", "NamedSharding", "Placed",
           "Keep", "Each", "assemble", "make_mesh", "submesh", "P",
           "filter_spec", "filter_specs", "shard_map", "Collectives",
           "MeshAborted", "ppermute", "all_to_all", "all_gather", "psum",
           "axis_index", "remat", "donate_argnums_supported",
           "device_inventory", "inventory_tags", "virtual_cpu_devices"]

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


def donate_argnums_supported(argnums: tuple) -> tuple:
    """The JAX contract: the argument numbers a backend may donate.  The
    port donates nothing -- a training step updates its parameters and
    moments in place instead (``models/train.py``) -- so this is ``()``
    on every device."""
    del argnums
    return ()


def device_inventory() -> dict:
    """The global pool for tags and placement, as the JAX package reads
    ``jax.devices()``: platform (``gpu`` or ``cpu``), the device kind,
    every process's device count, the process count and this process's
    device count."""
    pool = device_rule.devices()
    local = [device for device in pool if device_rule.is_local(device)]
    cards = [device for device in local if device.type == "cuda"]
    kind = torch.cuda.get_device_name(cards[0]) if cards \
        else ("cpu" if local else "none")
    platform = "gpu" if cards else (pool[0].type if pool else "none")
    return {"platform": platform, "device_kind": kind,
            "device_count": len(pool),
            "process_count": device_rule._process["count"],
            "local_device_count": len(local)}


def inventory_tags() -> list[str]:
    info = device_inventory()
    return [f"platform={info['platform']}",
            f"accelerator={info['device_kind'].replace(' ', '_')}",
            f"chips={info['device_count']}"]


def virtual_cpu_devices(count: int = 8) -> list[torch.device]:
    """``count`` CPU descriptors (``torch.device("cpu", i)``), the tests'
    stand-ins for cards: the JAX package's forced host devices, which
    the port needs no flag for."""
    return [torch.device("cpu", index) for index in range(count)]


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
                   else device_rule.devices())
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


def submesh(mesh: Mesh, axis: str, index: int) -> Mesh:
    """Carve the slice ``axis == index`` out of a mesh -- stage placement
    onto disjoint device groups (e.g. stage A on tp block 0, stage B on
    block 1).  A slice of one device becomes a one-position ``dp``
    mesh."""
    axis_pos = mesh.axis_names.index(axis)
    devices = np.asarray(np.take(mesh.devices, index, axis=axis_pos),
                         dtype=object)
    names = tuple(n for n in mesh.axis_names if n != axis)
    if devices.ndim == 0:
        devices = devices.reshape(1)
        names = ("dp",)
    return Mesh(devices, names)


class MeshPlan:
    """A mesh plus the sharding vocabulary models use: ``shard(*spec)``
    (a :class:`NamedSharding`, axis names absent from the mesh dropped),
    ``put`` and ``gather`` (placed trees), and ``replicated()``, the
    lead card a pipeline stage's unsharded tensors go to."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    @classmethod
    def build(cls, axes: dict[str, int] | None = None, devices=None) \
            -> "MeshPlan":
        return cls(make_mesh(axes, devices))

    @property
    def device(self) -> torch.device:
        """The lead card: the mesh's first device of this process (the
        first device, another process's descriptor, for a mesh wholly in
        another process)."""
        return _home(self.mesh)

    def axis_size(self, name: str) -> int:
        return self.mesh.shape.get(name, 1)

    def _filter_spec(self, spec: "P") -> "P":
        return filter_spec(self.mesh, spec)

    def replicated(self) -> torch.device:
        """The device a stage's unsharded tensors go to: the lead card,
        ``plan.device``, for a plan over one card or several (the JAX
        package's replicated array computes the same value on every
        chip; the port computes it once, on the lead card)."""
        return self.device

    def shard(self, *spec) -> "NamedSharding":
        if len(spec) == 1 and isinstance(spec[0], P):
            spec = spec[0]
        else:
            spec = P(*spec)
        return NamedSharding(self, self._filter_spec(spec))

    def put(self, tree, specs) -> "Placed":
        """``tree`` (a tensor, or dicts / lists / tuples of tensors)
        placed on the mesh by ``specs`` (a matching tree of :class:`P`;
        a single spec broadcasts to every leaf): each position's shard
        of each leaf, copied onto its device, one tensor a device
        descriptor and shard."""
        if isinstance(specs, P):
            specs = _broadcast(specs, tree)
        specs = filter_specs(self.mesh, specs)
        descriptors = list(self.mesh.devices.flat)

        def place(spec, leaf):
            leaf = torch.as_tensor(leaf)
            made, shards = {}, []
            for position, descriptor in enumerate(descriptors):
                if not device_rule.is_local(descriptor):
                    shards.append(None)
                    continue
                key = (descriptor, _shard_key(self.mesh, position, spec,
                                              leaf.ndim))
                if key not in made:
                    made[key] = _split(self.mesh, position,
                                       _placed(descriptor), spec,
                                       leaf.detach(), copy=True)
                shards.append(made[key])
            return shards
        with torch.no_grad():
            per_leaf = _map_specs(place, specs, tree)
        return Placed(self.mesh, specs, [
            _map_specs(lambda spec, shards: shards[position], specs,
                       per_leaf)
            if device_rule.is_local(descriptors[position]) else None
            for position in range(self.mesh.size)])

    def gather(self, placed: "Placed"):
        """The whole tree of ``placed`` on ``plan.device``: new tensors,
        detached (for tests, checkpoints and comparisons)."""
        return placed.gather(self.device)

    def __repr__(self) -> str:
        return f"MeshPlan({dict(self.mesh.shape)})"


class NamedSharding:
    """``plan.shard(*spec)``: the mesh and the filtered spec (``.spec``),
    as the JAX ``NamedSharding`` carries them.  ``put(value)`` places a
    tree by the spec over every position of the mesh (a
    :class:`Placed`); ``.device`` is the lead card
    (``plan.replicated()``).  Two shardings are equal when their meshes
    list the same devices on the same axes and their specs match."""

    def __init__(self, plan: MeshPlan, spec):
        self.plan = plan
        self.mesh = plan.mesh
        self.spec = spec

    @property
    def device(self) -> torch.device:
        return self.plan.replicated()

    @property
    def device_set(self) -> set:
        return set(self.mesh.devices.flat)

    def put(self, value) -> "Placed":
        return self.plan.put(value, self.spec)

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedSharding) \
            and _same_mesh(self.mesh, other.mesh) and self.spec == other.spec

    def __hash__(self) -> int:
        return hash((self.mesh.axis_names, self.mesh.devices.shape,
                     tuple(self.mesh.devices.flat)))

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec})"


class Placed:
    """A tree placed on a mesh (``MeshPlan.put``, or a :class:`Keep`
    output of :func:`shard_map`): ``shards[position]`` is that position's
    tree of local tensors, laid out by ``specs`` (filtered), None at a
    position of another process.  Positions that list one device
    descriptor and hold the same shard of a leaf hold the same tensor.
    No JAX counterpart: the port's sharded array."""

    def __init__(self, mesh: Mesh, specs, shards: list):
        self.mesh = mesh
        self.specs = specs
        self.shards = shards

    def tensors(self) -> list[torch.Tensor]:
        """Every distinct tensor this process holds, in position order,
        each once."""
        return [tensor for mine in self.owned() for tensor in mine]

    def first_shard(self):
        """The shard of this process's first position (every position's
        tree has the same structure)."""
        return next(shard for shard in self.shards if shard is not None)

    def owned(self) -> list[list[torch.Tensor]]:
        """Per position, the distinct tensors it holds first (a tensor
        shared by several positions belongs to the first; none at
        another process's position)."""
        seen, out = set(), []
        for shard in self.shards:
            mine = []
            if shard is None:
                out.append(mine)
                continue
            for tensor in _leaf_list(self.specs, shard):
                if id(tensor) not in seen:
                    seen.add(id(tensor))
                    mine.append(tensor)
            out.append(mine)
        return out

    def replicas(self) -> list[list[torch.Tensor]]:
        """Groups of two or more distinct tensors that hold the same
        shard of one leaf (on distinct device descriptors), each group in
        position order: what must stay equal."""
        groups: dict = {}
        columns = [None if shard is None else _leaf_list(self.specs, shard)
                   for shard in self.shards]
        for index, spec in enumerate(_leaf_list(self.specs, self.specs)):
            for position, column in enumerate(columns):
                if column is None:
                    continue
                tensor = column[index]
                key = (index, _shard_key(self.mesh, position, spec,
                                         tensor.ndim))
                group = groups.setdefault(key, [])
                if all(member is not tensor for member in group):
                    group.append(tensor)
        return [group for group in groups.values() if len(group) > 1]

    def map(self, fn) -> "Placed":
        """A placed tree of the same layout with ``fn`` applied to every
        distinct tensor (shared tensors stay shared)."""
        made: dict = {}

        def apply(_, tensor):
            if id(tensor) not in made:
                made[id(tensor)] = fn(tensor)
            return made[id(tensor)]
        return Placed(self.mesh, self.specs,
                      [None if shard is None
                       else _map_specs(apply, self.specs, shard)
                       for shard in self.shards])

    @property
    def sharding(self) -> NamedSharding:
        """The mesh and specs this tree is laid out by."""
        return NamedSharding(MeshPlan(self.mesh), self.specs)

    def reshard(self, sharding: NamedSharding) -> "Placed":
        """This tree laid out on ``sharding``'s mesh by its spec: the
        whole tree gathered onto the target's lead card (copies between
        cards), then split by ``MeshPlan.put``."""
        return sharding.put(self.gather(sharding.device))

    def gather(self, device):
        """The whole tree on ``device``: new tensors, detached.  Over a
        mesh that spans processes every process calls it and gets the
        whole tree (the shards it lacks fetched from their processes)."""
        device = _placed(device)
        columns = [None if shard is None else _leaf_list(self.specs, shard)
                   for shard in self.shards]
        if distributed.spans_processes(self.mesh):
            columns = _fetch_columns(self.mesh, self.specs, columns, device)
        with torch.no_grad():
            wholes = iter([
                _assemble(self.mesh, spec, [column[index]
                                            for column in columns],
                          device).detach().clone()
                for index, spec in enumerate(_leaf_list(self.specs,
                                                        self.specs))])
        return _map_specs(lambda spec, _: next(wholes), self.specs,
                          self.specs)

    def __repr__(self) -> str:
        return f"Placed({dict(self.mesh.shape)}, {self.specs})"


class Keep:
    """An out spec of :func:`shard_map` that keeps the positions' outputs
    placed: a :class:`Placed` tree laid out by ``specs``."""

    def __init__(self, specs):
        self.specs = specs


class Each:
    """An out spec of :func:`shard_map` that returns every position's
    output as it stands, a list in position order (for outputs that only
    some positions compute: :func:`assemble` then reads the group that
    did)."""


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
    implements the same six methods."""

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

    def remat(self, fn, args):
        raise NotImplementedError


class _Exchange:
    """The meeting point of one :func:`shard_map` call's positions.

    ``gather`` hands each member of a group every member's value (the
    objects, no copy), in group order.  Each meeting has its own
    condition, notified once, by the member that completes it, so a
    collective wakes its own members only.  A failure at any position
    (``abort``) wakes every waiter with :class:`MeshAborted`, and a
    position that returned (``finish``) while a member of its group
    waits for it fails that wait, so no call hangs."""

    def __init__(self, count: int):
        self._lock = threading.Lock()
        self._calls = [0] * count
        self._slots: dict = {}
        self._finished: set = set()
        self._failed: int | None = None

    def gather(self, position: int, members: tuple, index: int, value):
        with self._lock:
            key = (self._calls[position], members)
            self._calls[position] += 1
            slot = self._slots.get(key)
            if slot is None:
                slot = self._slots[key] = {
                    "values": {}, "read": 0,
                    "cond": threading.Condition(self._lock)}
            slot["values"][index] = value
            if len(slot["values"]) == len(members):
                slot["cond"].notify_all()
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
                slot["cond"].wait()
            slot["read"] += 1
            if slot["read"] == len(members):
                del self._slots[key]
            return [slot["values"][rank] for rank in range(len(members))]

    def _wake_all(self) -> None:
        for slot in self._slots.values():
            slot["cond"].notify_all()

    def abort(self, position: int) -> None:
        with self._lock:
            if self._failed is None:
                self._failed = position
            self._wake_all()

    def finish(self, position: int) -> None:
        with self._lock:
            self._finished.add(position)
            self._wake_all()


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
        self._local = set(_local_positions(mesh))
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

    def _spans(self, axis_name) -> bool:
        return any(member not in self._local
                   for member in self._group(axis_name)[0])

    def _gather(self, axis_name, value) -> tuple[list, int]:
        members, rank = self._group(axis_name)
        local = [member for member in members if member in self._local]
        if len(local) == len(members):
            return self._exchange.gather(self._position, members, rank,
                                         value), rank
        # The group spans processes: the local members meet, the first
        # swaps their values with the other processes', all read it.
        mine = local.index(self._position)
        values = self._exchange.gather(self._position, tuple(local), mine,
                                       value)
        everyone = None
        if mine == 0:
            devices = [_placed(self._mesh.devices.flat[m]) for m in local]
            everyone = distributed.gather_across(
                self._mesh, members, values, _flat(value)[1], devices)
        shared = self._exchange.gather(self._position, tuple(local), mine,
                                       everyone)
        return shared[0], rank

    def _here(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor.to(self.device)

    def axis_index(self, axis_name) -> int:
        return self._group(axis_name)[1]

    def ppermute(self, x, axis_name, perm):
        values, rank = self._gather(axis_name, x)
        sources = [src for src, dst in perm if dst == rank]
        if not sources:                     # jax.lax.ppermute: zeros
            if self._spans(axis_name):
                # Tied to the exchange, so its backward runs here too.
                return _map_values(_zeros_tied, values[rank])
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

    def remat(self, fn, args):
        with torch.no_grad():
            out = fn(*args)
        if not torch.is_grad_enabled():
            return out
        everyone = tuple(sorted(self._local))
        mine = everyone.index(self._position)
        tensors, rebuild = _flat(args)
        entries = self._exchange.gather(self._position, everyone, mine,
                                        (fn, tensors, rebuild, out))
        built = None
        if mine == 0:
            outputs = [_flat(entry[3]) for entry in entries]
            node = {"mesh": self._mesh, "positions": everyone,
                    "fns": [entry[0] for entry in entries],
                    "arguments": [(entry[2], len(entry[1]))
                                  for entry in entries],
                    "outputs": [t for flat, _ in outputs for t in flat],
                    "streams": _streams(self._mesh)}
            produced = iter(_MeshRemat.apply(
                node, *[t for entry in entries for t in entry[1]]))
            built = [remake([next(produced) for _ in flat])
                     for flat, remake in outputs]
        shared = self._exchange.gather(self._position, everyone, mine,
                                       built)
        return shared[0][mine]


def _placed(device: torch.device) -> torch.device:
    """Where a tensor of position ``device`` lives (a CPU descriptor's
    tensors lie on the CPU).  Another process's device holds none."""
    if not device_rule.is_local(device):
        raise ValueError(f"{device} belongs to another process: no tensor "
                         f"of this one is placed there")
    return torch.device("cpu") if device.type == "cpu" else device


def _local_positions(mesh: Mesh) -> list[int]:
    """The positions of ``mesh`` this process runs, in order."""
    return [position for position, device in enumerate(mesh.devices.flat)
            if device_rule.is_local(device)]


def _home(mesh: Mesh):
    """The mesh's first device of this process (its first device when it
    has none here)."""
    return next((device for device in mesh.devices.flat
                 if device_rule.is_local(device)), mesh.devices.flat[0])


class _Tie(torch.autograd.Function):
    """``zeros`` with a zero gradient edge to ``source``: a value that
    depends on a collective's exchange in the autograd graph, so the
    exchange's backward runs in every process that ran its forward."""

    @staticmethod
    def forward(ctx, source):
        return torch.zeros_like(source)

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad)


def _zeros_tied(source: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and source.requires_grad:
        return _Tie.apply(source)
    return torch.zeros_like(source)


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


def remat(fn: Callable, *args):
    """``jax.checkpoint`` inside a mapped function: ``fn(*args)`` with its
    activations dropped and recomputed in the backward pass.  Every
    position of the mesh calls it at the same point.  ``args`` may hold
    dicts, lists and tuples of tensors; gradients reach every tensor of
    them that requires grad (pass the parameters ``fn`` reads, so their
    fsdp gathers are redone in the backward pass too).

    The forward runs ``fn`` without grad at each position, then the
    positions meet and ONE autograd node stands for all of them; its
    backward runs every position's ``fn`` again, one thread each with
    fresh collectives, and differentiates them together.  Outside a
    grad-enabled call it is ``fn(*args)``."""
    return _collectives().remat(fn, args)


def _flat(tree) -> tuple[list, Callable]:
    """(the tensors of ``tree`` -- dicts, lists and tuples -- in order,
    a function that rebuilds the tree from such a list)."""
    tensors = []

    def walk(node):
        if isinstance(node, dict):
            keys = list(node)
            parts = [walk(node[key]) for key in keys]
            return lambda take: {key: part(take)
                                 for key, part in zip(keys, parts)}
        if isinstance(node, (list, tuple)):
            parts = [walk(item) for item in node]
            kind = type(node)
            return lambda take: kind(part(take) for part in parts)
        if torch.is_tensor(node):
            tensors.append(node)
            return lambda take: next(take)
        return lambda take: node
    build = walk(tree)
    return tensors, lambda values: build(iter(values))


class _MeshRemat(torch.autograd.Function):
    """One autograd node for a :func:`remat` call at every position:
    its inputs are every position's argument tensors, its outputs every
    position's (precomputed) result tensors."""

    @staticmethod
    def forward(ctx, plan, *inputs):
        # The outputs leave the plan: held by ctx they would form a
        # cycle through the node's outputs that the collector cannot see,
        # and every remat call's arguments would outlive the step.
        outputs = tuple(plan.pop("outputs"))
        ctx.plan = plan
        ctx.save_for_backward(*inputs)
        return outputs

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        inputs = [x.detach().requires_grad_(x.requires_grad)
                  for x in ctx.saved_tensors]
        args, begin = [], 0
        for rebuild, count in plan["arguments"]:
            args.append(rebuild(inputs[begin:begin + count]))
            begin += count
        mesh, fns = plan["mesh"], plan["fns"]
        calls = [None] * mesh.size
        for position, fn, a in zip(plan["positions"], fns, args):
            calls[position] = lambda fn=fn, a=a: fn(*a)
        with torch.enable_grad():
            results = _run_positions(mesh, calls, (False, True),
                                     plan["streams"])
        outputs = [tensor for position in plan["positions"]
                   for tensor in _flat(results[position])[0]]
        pairs = [(out, grad) for out, grad in zip(outputs, grads)
                 if grad is not None and out.requires_grad]
        wanted = [x for x in inputs if x.requires_grad]
        found = torch.autograd.grad([out for out, _ in pairs],
                                    wanted, [grad for _, grad in pairs],
                                    allow_unused=True) if pairs else \
            [None] * len(wanted)
        found = iter(found)
        return (None, *[next(found) if x.requires_grad else None
                        for x in inputs])


def _map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over a tree of dicts, tuples and lists whose
    leaves are tensors, against a tree of :class:`P` of the same
    structure (dict keys must match)."""
    if isinstance(specs, P):
        return fn(specs, tree)
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            found = sorted(tree) if isinstance(tree, dict) else tree
            raise ValueError(f"a tree of {found} where its specs have "
                             f"the keys {sorted(specs)}")
        return {key: _map_specs(fn, specs[key], tree[key]) for key in specs}
    return type(specs)(_map_specs(fn, spec, leaf)
                       for spec, leaf in zip(specs, tree, strict=True))


def _leaf_list(specs, tree) -> list:
    """``tree``'s leaves in the order ``specs`` walks them."""
    out = []
    _map_specs(lambda spec, leaf: out.append(leaf), specs, tree)
    return out


def _broadcast(spec: P, tree):
    """One spec for every tensor of ``tree``."""
    if isinstance(tree, dict):
        return {key: _broadcast(spec, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_broadcast(spec, value) for value in tree)
    return spec


def filter_specs(mesh: Mesh, specs):
    """Every spec of a tree filtered to ``mesh``'s axes
    (:func:`filter_spec` over a tree of :class:`P`)."""
    if isinstance(specs, P):
        return filter_spec(mesh, specs)
    if isinstance(specs, dict):
        return {key: filter_specs(mesh, value) for key, value in specs.items()}
    return type(specs)(filter_specs(mesh, value) for value in specs)


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


def _shard_key(mesh: Mesh, position: int, spec: P, ndim: int) -> tuple:
    """Which shard of a leaf under ``spec`` ``position`` holds: one
    index a split dimension (positions with equal keys hold replicas)."""
    coords = np.unravel_index(position, mesh.devices.shape)
    return tuple(_shard_index(mesh, coords, axes)
                 for _, axes, _ in _layout(mesh, spec, ndim))


def _split(mesh: Mesh, position: int, device, spec: P, tensor,
           copy: bool = False):
    """``position``'s shard of a global tensor under ``spec``, on its
    device (a view where the device is the tensor's own, unless
    ``copy``: then a contiguous tensor of its own)."""
    coords = np.unravel_index(position, mesh.devices.shape)
    for dim, axes, count in _layout(mesh, spec, tensor.ndim):
        if tensor.shape[dim] % count:
            raise ValueError(f"dimension {dim} of {tuple(tensor.shape)} "
                             f"does not split {count} ways ({spec})")
        size = tensor.shape[dim] // count
        tensor = tensor.narrow(dim, _shard_index(mesh, coords, axes) * size,
                               size)
    if copy:
        return tensor.to(device, copy=True,
                         non_blocking=device.type == "cuda",
                         memory_format=torch.contiguous_format)
    return tensor.to(device)


def assemble(mesh: Mesh, spec: P, outputs: list, device,
             at: dict | None = None):
    """The global tensor from the positions' outputs (a list in position
    order, as :class:`Each` returns it) under ``spec``, read from the
    positions at coordinate ``at[axis]`` on each axis ``at`` names and 0
    on every other axis the spec does not split, on ``device`` (None:
    the mesh's first device)."""
    if device is None:
        device = _placed(_home(mesh))
    return _assemble(mesh, filter_spec(mesh, spec), outputs, device, at)


def _assemble(mesh: Mesh, spec: P, outputs: list, device,
              at: dict | None = None):
    """The global tensor from every position's output under ``spec``:
    the shards of split dimensions concatenated in order, a replicated
    shard taken from the position with coordinate 0 (or ``at[axis]``)
    on each axis the spec does not name."""
    at = at or {}
    layout = _layout(mesh, spec,
                     next(out for out in outputs if out is not None).ndim)

    def block(shard: tuple) -> torch.Tensor:
        coords = [at.get(axis, 0) for axis in mesh.axis_names]
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


def _run_position(fn, exchange, mesh, position, errors, results,
                  modes, streams):
    """One position's thread: ``fn()`` under the caller's grad and
    inference modes and CUDA streams (``streams``: the caller's current
    stream on each card of the mesh, the position's own card last, so a
    copy between two cards runs on the caller's streams of both).  Any
    failure is kept for the caller to raise and aborts the other
    positions' waits."""
    _current.collectives = _LocalCollectives(exchange, mesh, position)
    inference, grad = modes
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode(inference))
            stack.enter_context(torch.set_grad_enabled(grad))
            for stream in streams:
                stack.enter_context(torch.cuda.stream(stream))
            results[position] = fn()
    except BaseException as error:     # re-raised by the caller
        errors[position] = error
        exchange.abort(position)
    finally:
        exchange.finish(position)
        _current.collectives = None


def _streams(mesh: Mesh) -> list:
    """Each position's CUDA streams: the calling thread's current stream
    on every card of the mesh, the position's own card last (none for a
    CPU position)."""
    devices = [_placed(device) if device_rule.is_local(device) else None
               for device in mesh.devices.flat]
    current = {device: torch.cuda.current_stream(device)
               for device in devices
               if device is not None and device.type == "cuda"}
    return [(*(stream for card, stream in current.items()
               if card != device), current[device])
            if device is not None and device.type == "cuda" else ()
            for device in devices]


def _run_positions(mesh: Mesh, calls: list, modes: tuple,
                   streams: list) -> list:
    """``calls[position]()`` at every position with a call (this
    process's), one thread each with the position's collectives -> the
    results in position order (None where there is no call).  A
    position that raises aborts the call: the positions waiting in a
    collective raise :class:`MeshAborted`, and the first failure in
    position order that is not an abort is re-raised."""
    count = mesh.size
    exchange = _Exchange(count)
    results, errors = [None] * count, [None] * count
    threads = [threading.Thread(
        target=_run_position, name=f"shard_map-{position}",
        args=(call, exchange, mesh, position, errors, results, modes,
              stream), daemon=True)
        for position, (call, stream) in enumerate(zip(calls, streams))
        if call is not None]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    failures = [error for error in errors if error is not None]
    if failures:
        raise next((error for error in failures
                    if not isinstance(error, MeshAborted)), failures[0])
    return results


def _same_mesh(a: Mesh, b: Mesh) -> bool:
    return a is b or (a.axis_names == b.axis_names
                      and a.devices.shape == b.devices.shape
                      and list(a.devices.flat) == list(b.devices.flat))


def _local_args(mesh: Mesh, in_specs, args, position: int, device) -> list:
    """``position``'s arguments: a :class:`Placed` argument's own shard,
    a global tree's split by its spec."""
    local = []
    for spec, arg in zip(in_specs, args, strict=True):
        if arg is None or device is None:
            local.append(None)
        elif isinstance(arg, Placed):
            if not _same_mesh(arg.mesh, mesh):
                raise ValueError(f"a tree placed on {arg.mesh} passed to "
                                 f"a function mapped over {mesh}")
            if spec is not None \
                    and filter_specs(mesh, spec) != arg.specs:
                raise ValueError(f"a tree placed by {arg.specs} passed "
                                 f"where {spec} is expected")
            local.append(arg.shards[position])
        elif spec is None:
            raise ValueError("a global argument of a mapped function needs "
                             "its spec (None is for placed trees)")
        else:
            local.append(_map_specs(
                lambda leaf_spec, leaf: _split(mesh, position, device,
                                               leaf_spec, leaf),
                spec, arg))
    return local


def shard_map(fn: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``jax.shard_map``: the returned function hands each position its
    arguments -- global trees of tensors split by ``in_specs``,
    :class:`Placed` trees as they stand (their spec may be given as
    None), None as None -- runs ``fn`` on them, one thread a position, each on its
    position's device, under the caller's grad mode and current CUDA
    stream, and reassembles the outputs by ``out_specs`` on the mesh's
    first device, or keeps them placed where an out spec is
    :class:`Keep`.  The outputs stay attached to the inputs' autograd
    graph.

    A position that raises aborts the call: the positions waiting in a
    collective raise :class:`MeshAborted`, and the call re-raises the
    first failure in position order that is not an abort.

    Over a mesh that spans processes, every process calls the function
    with the same arguments, in the same order as its other calls over
    the mesh, and runs its own positions; the outputs come out whole in
    every process (:class:`Keep` outputs hold this process's shards).
    The first call prepares the mesh's process groups."""
    def run(*args):
        spans = distributed.spans_processes(mesh)
        if spans:
            group = _mesh_wide(mesh)
            args = [arg if arg is None or isinstance(arg, Placed)
                    or spec is None else _map_specs(
                        lambda _, leaf: distributed.shared_input(group, leaf)
                        if torch.is_tensor(leaf) else leaf, spec, arg)
                    for spec, arg in zip(in_specs, args, strict=True)]
        calls = []
        for position, device in enumerate(mesh.devices.flat):
            if not device_rule.is_local(device):
                calls.append(None)
                continue
            local = _local_args(mesh, tuple(in_specs), args, position,
                                _placed(device))
            calls.append(lambda local=local: fn(*local))
        modes = (torch.is_inference_mode_enabled(), torch.is_grad_enabled())
        results = _run_positions(mesh, calls, modes, _streams(mesh))
        home = _placed(_home(mesh))
        if spans:
            results = _fetch_outputs(mesh, out_specs, results, home)
        return _gather_outputs(mesh, out_specs, results, home)
    return run


def _mesh_wide(mesh: Mesh):
    """The process group of every position of a mesh that spans
    processes (prepared first: every process calls this)."""
    distributed.prepare(mesh)
    return distributed.mesh_group(mesh, tuple(range(mesh.size)))


def _strip_kept(out_specs, result):
    """``result`` with every :class:`Keep` (and None-spec) part None:
    what another process must fetch of a position's output."""
    if result is None or out_specs is None or isinstance(out_specs, Keep):
        return None
    if isinstance(out_specs, (P, Each)):
        return result
    if isinstance(out_specs, dict):
        return {key: _strip_kept(spec, result[key])
                for key, spec in out_specs.items()}
    return type(out_specs)(_strip_kept(spec, result[index])
                           for index, spec in enumerate(out_specs))


def _fill_kept(out_specs, fetched):
    """A fetched output of another process's position, None where the
    spec keeps it placed (that position holds no tensor here)."""
    if fetched is None or out_specs is None \
            or isinstance(out_specs, Keep):
        return None
    if isinstance(out_specs, (P, Each)):
        return fetched
    if isinstance(out_specs, dict):
        return {key: _fill_kept(spec, fetched[key])
                for key, spec in out_specs.items()}
    return type(out_specs)(_fill_kept(spec, fetched[index])
                           for index, spec in enumerate(out_specs))


def _fetch_outputs(mesh: Mesh, out_specs, results: list, device) -> list:
    """Every position's output in every process: another process's
    outputs (their :class:`Keep` parts apart) fetched as new tensors,
    detached -- every process computes the same loss of the whole, so a
    position's output takes its gradient in its own process only."""
    mine = {position: _strip_kept(out_specs, results[position])
            for position in _local_positions(mesh)}
    merged = dict(mine)
    for theirs in distributed.exchange_trees(_mesh_wide(mesh), mine,
                                             device):
        for position, value in theirs.items():
            merged.setdefault(position, value)
    return [results[position] if position in mine
            else _fill_kept(out_specs, merged[position])
            for position in range(mesh.size)]


def _fetch_columns(mesh: Mesh, specs, columns: list, device) -> list:
    """``columns`` (each position's leaf list, None at another
    process's) with every shard :func:`_assemble` reads filled in, from
    the processes that hold them."""
    leaf_specs = _leaf_list(specs, specs)
    local = [column for column in columns if column is not None]
    mine = {}
    needed = []
    for index, spec in enumerate(leaf_specs):
        split = {axis for _, axes, _ in _layout(mesh, spec,
                                                local[0][index].ndim)
                 for axis in axes}
        reads = [position for position in range(mesh.size)
                 if all(coord == 0 for axis, coord in zip(
                     mesh.axis_names,
                     np.unravel_index(position, mesh.devices.shape))
                     if axis not in split)]
        needed.append(reads)
        for position in reads:
            if columns[position] is not None:
                mine[index, position] = columns[position][index]
    found = dict(mine)
    for theirs in distributed.exchange_trees(_mesh_wide(mesh), mine,
                                             device):
        for key, tensor in theirs.items():
            found.setdefault(key, tensor)
    filled = [list(column) if column is not None
              else [None] * len(leaf_specs) for column in columns]
    for index, reads in enumerate(needed):
        for position in reads:
            filled[position][index] = found[index, position]
    return filled


def _gather_outputs(mesh: Mesh, out_specs, results: list, device):
    """Every position's output tree -> one tree of global tensors (a
    :class:`Placed` tree under a :class:`Keep` spec, None at another
    process's positions; None where the spec is None)."""
    if out_specs is None:
        return None
    if isinstance(out_specs, Keep):
        return Placed(mesh, filter_specs(mesh, out_specs.specs), results)
    if isinstance(out_specs, Each):
        return list(results)
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
