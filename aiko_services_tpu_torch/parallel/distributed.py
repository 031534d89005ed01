"""The multi-host backend of the port: the ``torch.distributed`` bring-up
(the counterpart of ``jax.distributed.initialize``), the global device
pool, and the exchanges that carry :func:`~.mesh.shard_map`'s
collectives, placed trees and pipeline hops across processes.

Multi-controller, as JAX is: every process runs the same program.  A
launcher starts one process a host, each with its own cards (or CPU
descriptors, ``AIKO_CPU_DEVICES``), and :func:`ensure` brings them up
once a process over ``tcp://<coordinator>``:

- the default process group is gloo (the control plane: the device
  listing at bring-up);
- every process's devices are gathered in process order, so each holds
  the same global pool (``device.devices()``): its own devices as plain
  ``torch.device``\\ s, another's as ``device.RemoteDevice``\\ s;
- the **transport** of the data groups is chosen from that topology,
  once, and printed: **NCCL** when every process's devices are cards and
  no card is listed by two processes (the card UUIDs are exchanged to
  tell), else **gloo** -- CPU descriptors (the tests), or processes that
  share a card (NCCL refuses two ranks on one card).  Gloo moves card
  tensors through pinned host buffers, explicitly: each exchange copies
  them to pinned memory, waits for those copies, then hands gloo host
  tensors, and copies what it receives back up asynchronously.

A mesh over the global pool may span processes.  Each process runs its
own positions only (threads, as in one process); a collective whose
group spans processes meets its local members first (``_Exchange``),
then the group's first local member swaps the process's values with the
other processes' over the group's own process group
(:func:`mesh_group`, one a group of positions, all created in the same
order in every process when the mesh's first ``shard_map`` starts) and
hands every member every value.  The values keep their meaning: every
member of a group sees the same values in position order, so the sums
run as in one process.  Every exchange is a ``torch.autograd.Function``
whose backward hands each member the sum, in process order, of the
gradients the other processes' positions took from its value.

Every exchange on a group carries a sequence number; members that
disagree raise instead of mixing values.  A peer that is gone fails the
exchange within :data:`BRINGUP_TIMEOUT_S` (gloo raises at once on a
closed connection; NCCL's watchdog ends the process at the timeout), and
the group stays failed: no exchange goes on with one process's values.
"""

from __future__ import annotations

import atexit
import datetime
import pickle
import sys
import threading
import zlib

import numpy as np
import torch

from .. import device as device_rule

__all__ = ["BRINGUP_TIMEOUT_S", "ensure", "initialized", "transport",
           "spans_processes", "prepare", "mesh_group", "pair_groups",
           "gather_across", "shared_input", "exchange_trees", "send_tree",
           "recv_tree",
           "flush_sends", "shutdown", "hop_tag", "PeerLost"]

#: The bound on the bring-up and on every exchange across processes: a
#: peer that never shows up or is gone fails a call after this long.
BRINGUP_TIMEOUT_S = 60.0

_ALIGN = 16
_HEADER = 32                     # int64 [sequence, direction, size, count]

_lock = threading.Lock()
_state: dict = {"initialized": False, "transport": None, "pairs": {},
                "groups": {}, "layouts": set()}


class PeerLost(RuntimeError):
    """An exchange across processes failed: a peer is gone, timed out, or
    issued another exchange on the same group."""


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=BRINGUP_TIMEOUT_S)


def initialized() -> bool:
    return _state["initialized"]


def transport() -> str | None:
    """``"nccl"`` or ``"gloo"`` after a bring-up, else None."""
    return _state["transport"]


def _uuid(device: torch.device) -> str | None:
    if device.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(device.index or 0).uuid)


def _choose_transport(listings: list) -> str:
    """NCCL when every device of every process is a card and no card is
    listed by two processes, else gloo."""
    owners: dict = {}
    for rank, listing in enumerate(listings):
        for kind, _, uuid in listing:
            if kind != "cuda":
                return "gloo"
            owners.setdefault(uuid, set()).add(rank)
    return "nccl" if all(len(ranks) == 1 for ranks in owners.values()) \
        else "gloo"


def ensure(hosts: int, coordinator: str, process_id: int) -> tuple[int, int]:
    """Bring this process up as ``process_id`` of ``hosts`` over
    ``tcp://coordinator``, once a process; a second call returns what
    the first did.  Returns (process index, process count).  Raises if a
    peer does not show up within :data:`BRINGUP_TIMEOUT_S`, or if
    ``torch.distributed`` was brought up otherwise."""
    import torch.distributed as dist
    with _lock:
        if _state["initialized"]:
            return device_rule._process["index"], \
                device_rule._process["count"]
        if not 0 <= process_id < hosts:
            raise ValueError(f"process_id {process_id} outside "
                             f"{hosts} hosts")
        local = device_rule.local_devices()
        if dist.is_initialized():
            raise RuntimeError("torch.distributed is already initialized "
                               "by another caller")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=hosts, rank=process_id,
                                timeout=_timeout())
        listing = [(d.type, d.index, _uuid(d)) for d in local]
        listings: list = [None] * hosts
        dist.all_gather_object(listings, listing)
        pool = []
        for rank, entries in enumerate(listings):
            for kind, index, _ in entries:
                pool.append(torch.device(kind, index) if rank == process_id
                            else device_rule.RemoteDevice(rank, kind, index))
        chosen = _choose_transport(listings)
        # Point-to-point groups for stage hops, in one order everywhere.
        for a in range(hosts):
            for b in range(a + 1, hosts):
                control = dist.new_group([a, b], backend="gloo",
                                         timeout=_timeout())
                data = control if chosen == "gloo" else dist.new_group(
                    [a, b], backend=chosen, timeout=_timeout())
                _state["pairs"][a, b] = (control, data)
        device_rule._process.update(index=process_id, count=hosts, pool=pool)
        _state.update(initialized=True, transport=chosen)
        atexit.register(shutdown)
        print(f"aiko_services_tpu_torch: torch.distributed up, process "
              f"{process_id} of {hosts} at {coordinator}, transport "
              f"{chosen}, {len(pool)} devices", file=sys.stderr, flush=True)
        return process_id, hosts


def pair_groups(a: int, b: int) -> tuple:
    """(control group, data group) of processes ``a`` and ``b``: the
    control group is gloo, the data group the transport's."""
    return _state["pairs"][min(a, b), max(a, b)]


def _ident(device) -> tuple:
    """A device's identity in every process: (process, type, index)."""
    return (device_rule.process_index(device), device.type, device.index)


def spans_processes(mesh) -> bool:
    """True when ``mesh`` lists devices of more than one process (only
    after a bring-up)."""
    if not _state["initialized"]:
        return False
    return len({device_rule.process_index(d) for d in mesh.devices.flat}) > 1


# ---------------------------------------------------------------------------
# Process groups of a mesh.

class _Group:
    """One process group a group of mesh positions exchanges over: its
    processes in order, the transport's group, a sequence number and a
    failure that sticks."""

    def __init__(self, ranks: tuple):
        import torch.distributed as dist
        self.ranks = ranks
        self.pg = dist.new_group(list(ranks), backend=_state["transport"],
                                 timeout=_timeout())
        self.sequence = 0
        self.failed: str | None = None
        self.lock = threading.Lock()

    @property
    def nccl(self) -> bool:
        return _state["transport"] == "nccl"


def _position_groups(mesh) -> list[tuple]:
    """Every group of positions a collective over some of ``mesh``'s axes
    can name, each once, in a fixed order."""
    names = mesh.axis_names
    shape = mesh.devices.shape
    seen, out = set(), []
    for mask in range(1, 2 ** len(names)):
        dims = [d for d in range(len(names)) if mask >> d & 1]
        for position in range(mesh.size):
            coords = np.unravel_index(position, shape)
            members = []
            for offsets in np.ndindex(*[shape[d] for d in dims]):
                point = list(coords)
                for dim, offset in zip(dims, offsets):
                    point[dim] = offset
                members.append(int(np.ravel_multi_index(point, shape)))
            key = tuple(sorted(members))
            if key not in seen:
                seen.add(key)
                out.append(key)
    return out


def _layout_key(mesh) -> tuple:
    return (mesh.axis_names, mesh.devices.shape,
            tuple(_ident(d) for d in mesh.devices.flat))


def prepare(mesh) -> None:
    """Create every process group ``mesh``'s collectives can need, once a
    layout, in the same order in every process (``new_group`` is
    collective: every process must call it).  :func:`~.mesh.shard_map`
    calls this when a mesh that spans processes starts."""
    key = _layout_key(mesh)
    with _lock:
        if key in _state["layouts"]:
            return
        for members in _position_groups(mesh):
            idents = tuple(_ident(mesh.devices.flat[p]) for p in members)
            ranks = tuple(sorted({ident[0] for ident in idents}))
            if len(ranks) > 1 and idents not in _state["groups"]:
                _state["groups"][idents] = _Group(ranks)
        _state["layouts"].add(key)


def mesh_group(mesh, members) -> _Group:
    """The process group of the positions ``members`` of ``mesh``."""
    idents = tuple(_ident(mesh.devices.flat[p]) for p in sorted(members))
    try:
        return _state["groups"][idents]
    except KeyError:
        raise RuntimeError(f"no process group for positions {members} of "
                           f"{mesh}: shard_map prepares them") from None


# ---------------------------------------------------------------------------
# Bytes across a group.

def _aligned(count: int) -> int:
    return -(-count // _ALIGN) * _ALIGN


def _bytes_of(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.detach().contiguous().reshape(-1).view(torch.uint8)


def _stage_device(group: _Group, devices) -> torch.device:
    """Where a buffer of ``group`` lives: the first card for NCCL, the
    host for gloo."""
    if group.nccl:
        return next(d for d in devices if d.type == "cuda")
    return torch.device("cpu")


def _fill(buffer: torch.Tensor, offset: int, tensors) -> int:
    """Copy ``tensors``' bytes into ``buffer`` from ``offset``, each at an
    aligned offset; returns the end."""
    for tensor in tensors:
        raw = _bytes_of(tensor)
        buffer.narrow(0, offset, raw.numel()).copy_(
            raw, non_blocking=raw.device.type != buffer.device.type)
        offset += _aligned(raw.numel())
    return offset


def _wait_staged(tensors) -> None:
    """A staging copy from a card must finish before gloo reads it."""
    cards = {t.device for t in tensors if t.device.type == "cuda"}
    if cards:
        with device_rule.sync_allowed():
            for card in cards:
                torch.cuda.current_stream(card).synchronize()


def _header(group: _Group, direction: int, size: int, count: int):
    group.sequence += 1
    return torch.tensor([group.sequence, direction, size, count],
                        dtype=torch.int64)


def _gather_buffers(group: _Group, buffer: torch.Tensor) -> list:
    """Every process's ``buffer`` (equal sizes) in the group's process
    order; raises :class:`PeerLost` on any failure, and for good."""
    import torch.distributed as dist
    if group.failed:
        raise PeerLost(f"processes {group.ranks}: an earlier exchange "
                       f"failed ({group.failed})")
    try:
        if group.nccl:
            out = torch.empty(len(group.ranks) * buffer.numel(),
                              dtype=torch.uint8, device=buffer.device)
            dist.all_gather_into_tensor(out, buffer, group=group.pg)
            return list(out.chunk(len(group.ranks)))
        pinned = buffer.is_pinned()
        outs = [torch.empty(buffer.numel(), dtype=torch.uint8,
                            pin_memory=pinned) for _ in group.ranks]
        dist.all_gather(outs, buffer, group=group.pg)
        return outs
    except Exception as error:
        group.failed = f"{type(error).__name__}: {error}"
        raise PeerLost(f"an exchange among processes {group.ranks} "
                       f"failed: {group.failed}") from error


def _check_headers(group: _Group, buffers: list, mine) -> list:
    """The headers of every process's buffer; the sequence and direction
    must be this process's."""
    heads = [buffer[:_HEADER].view(torch.int64).cpu() for buffer in buffers]
    for rank, head in zip(group.ranks, heads):
        if int(head[0]) != int(mine[0]) or int(head[1]) != int(mine[1]):
            group.failed = (f"process {rank} sent exchange "
                            f"{head.tolist()[:2]}, this one "
                            f"{mine.tolist()[:2]}")
            raise PeerLost(f"processes {group.ranks} issued their "
                           f"exchanges in another order: {group.failed}")
    return heads


def _exchange_blocks(group: _Group, blocks: list, block_bytes: int,
                     width: int, direction: int, devices) -> list:
    """Each process's ``blocks`` (lists of tensors of ``block_bytes``
    aligned bytes each; at most ``width`` blocks in any process) ->
    every process's buffer, in the group's process order: block ``j``
    at ``_HEADER + j * block_bytes``."""
    with group.lock:
        where = _stage_device(group, devices)
        tensors = [t for block in blocks for t in block]
        head = _header(group, direction, block_bytes, len(blocks))
        pinned = where.type == "cpu" and any(t.device.type == "cuda"
                                             for t in tensors)
        buffer = torch.zeros(_HEADER + width * block_bytes,
                             dtype=torch.uint8, device=where,
                             pin_memory=pinned)
        buffer[:_HEADER].view(torch.int64)[:4].copy_(head)
        for index, block in enumerate(blocks):
            _fill(buffer, _HEADER + index * block_bytes, block)
        if where.type == "cpu":
            _wait_staged(tensors)
        buffers = _gather_buffers(group, buffer)
        heads = _check_headers(group, buffers, head)
        for rank, head_q in zip(group.ranks, heads):
            if int(head_q[2]) != block_bytes:
                group.failed = (f"process {rank} holds values of "
                                f"{int(head_q[2])} bytes, this one "
                                f"{block_bytes}")
                raise PeerLost(f"a collective's members differ in shape "
                               f"across processes: {group.failed}")
        return buffers


def _slots(template: list) -> tuple[list, int]:
    """(each tensor's (offset, shape, dtype, bytes) in a block, the
    block's aligned bytes)."""
    slots, offset = [], 0
    for shape, dtype in template:
        count = int(np.prod(shape)) * torch.empty((), dtype=dtype) \
            .element_size()
        slots.append((offset, shape, dtype, count))
        offset += _aligned(count)
    return slots, max(offset, _ALIGN)


def _read(buffer: torch.Tensor, base: int, slots: list,
          device: torch.device) -> list:
    """The tensors of the block at ``base`` of ``buffer``, new on
    ``device``."""
    out = []
    for offset, shape, dtype, count in slots:
        raw = buffer.narrow(0, base + offset, count)
        tensor = raw.view(dtype).reshape(shape)
        if tensor.device == device:
            out.append(tensor.clone())
        else:
            out.append(tensor.to(device, non_blocking=True))
    return out


class _Plan:
    """One collective's exchange across processes: the group's members
    (positions, in group order), the process owning each, this
    process's members, and the layout of one member's value."""

    def __init__(self, mesh, members: tuple, template: list, devices):
        self.group = mesh_group(mesh, members)
        self.members = members
        self.owners = [device_rule.process_index(mesh.devices.flat[p])
                       for p in members]
        me = device_rule.process_index()
        self.local = [i for i, owner in enumerate(self.owners) if owner == me]
        self.template = template
        self.slots, self.block = _slots(template)
        self.devices = devices              # each local member's device
        self.lead = devices[0]
        counts = [self.owners.count(rank) for rank in self.group.ranks]
        self.width = max(counts)
        self.back_width = max(len(members) - count for count in counts)

    def forward(self, local_values: list) -> list:
        """Every member's value (a flat list of tensors), in member
        order: this process's as given, the others' received onto the
        lead member's device."""
        buffers = _exchange_blocks(self.group, local_values, self.block,
                                   self.width, 0, self.devices)
        by_rank = dict(zip(self.group.ranks, buffers))
        seen = {rank: 0 for rank in self.group.ranks}
        out, mine = [], iter(local_values)
        for owner in self.owners:
            index = seen[owner]
            seen[owner] += 1
            if owner == device_rule.process_index():
                out.append(next(mine))
            else:
                out.append(_read(by_rank[owner],
                                 _HEADER + index * self.block, self.slots,
                                 self.lead))
        return out

    def backward(self, remote_grads: list) -> list:
        """``remote_grads``: this process's gradient of every other
        process's member value (member order) -> for each local member,
        the sum over the other processes, in process order, of the
        gradients they took from its value."""
        buffers = _exchange_blocks(self.group, remote_grads, self.block,
                                   self.back_width, 1, self.devices)
        me = device_rule.process_index()
        sums: list = [None] * len(self.local)
        for rank, buffer in zip(self.group.ranks, buffers):
            if rank == me:
                continue
            others = [i for i, owner in enumerate(self.owners)
                      if owner != rank]
            for slot, member in enumerate(self.local):
                got = _read(buffer, _HEADER + others.index(member)
                            * self.block, self.slots, self.devices[slot])
                sums[slot] = got if sums[slot] is None else [
                    a + b for a, b in zip(sums[slot], got)]
        return sums


class _CrossGather(torch.autograd.Function):
    """The exchange of one collective as an autograd node: the inputs
    are this process's members' tensors, the outputs every member's
    (this process's passed through).  Its backward sends each other
    process the gradients its members' values took here and adds what
    the others took from this process's values."""

    @staticmethod
    def forward(ctx, plan: _Plan, *flat):
        ctx.plan = plan
        per = len(plan.template)
        local = [list(flat[i * per:(i + 1) * per])
                 for i in range(len(plan.local))]
        values = plan.forward(local)
        ctx.local_members = set(plan.local)
        out = []
        for member, value in enumerate(values):
            if member in ctx.local_members:
                value = [t.view_as(t) for t in value]
            out.extend(value)
        ctx.mark_non_differentiable(*[t for t in out
                                      if not t.is_floating_point()])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        per = len(plan.template)
        me = device_rule.process_index()
        remote, through = [], []
        for member, owner in enumerate(plan.owners):
            chunk = grads[member * per:(member + 1) * per]
            if owner == me:
                through.append(chunk)
                continue
            remote.append([
                torch.zeros(shape, dtype=dtype, device=plan.lead)
                if grad is None else grad
                for grad, (shape, dtype) in zip(chunk, plan.template)])
        sums = plan.backward(remote)
        out = []
        for slot, chunk in enumerate(through):
            for k, grad in enumerate(chunk):
                shape, dtype = plan.template[k]
                if not dtype.is_floating_point:
                    out.append(None)
                    continue
                extra = sums[slot][k]
                out.append(extra if grad is None else grad + extra)
        return (None, *out)


def gather_across(mesh, members: tuple, local_values: list,
                  rebuild, devices) -> list:
    """The values of every member of a collective's group, in member
    order, from this process's members' values (trees of tensors, each
    flattened with ``mesh._flat``; ``rebuild`` makes a value of a flat
    list).  Differentiable when grad is enabled."""
    from .mesh import _flat
    flats = [_flat(value)[0] for value in local_values]
    template = [(tuple(t.shape), t.dtype) for t in flats[0]]
    plan = _Plan(mesh, members, template, devices)
    if torch.is_grad_enabled():
        out = _CrossGather.apply(plan, *[t for flat in flats for t in flat])
        per = len(template)
        values = [list(out[i * per:(i + 1) * per])
                  for i in range(len(members))]
    else:
        values = plan.forward(flats)
    return [rebuild(value) for value in values]


# ---------------------------------------------------------------------------
# Trees across processes (outputs, placed shards, replicas, hops).

class _Slot:
    """A tensor's place in a packed tree."""

    __slots__ = ("index", "shape", "dtype")

    def __init__(self, index: int, shape: tuple, dtype: torch.dtype):
        self.index, self.shape, self.dtype = index, shape, dtype


def _pack(tree) -> tuple:
    """(the tree with each tensor replaced by a :class:`_Slot`, the
    tensors in order)."""
    tensors: list = []

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(value) for value in node)
        if torch.is_tensor(node):
            tensors.append(node)
            return _Slot(len(tensors) - 1, tuple(node.shape), node.dtype)
        return node
    return walk(tree), tensors


def _unpack(skeleton, tensors: list):
    def walk(node):
        if isinstance(node, dict):
            return {key: walk(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(value) for value in node)
        if isinstance(node, _Slot):
            return tensors[node.index]
        return node
    return walk(skeleton)


def _encode(tree, where: torch.device) -> tuple:
    """(the packed tree as one byte buffer on ``where``: skeleton then
    tensors, the tensors staged from)."""
    skeleton, tensors = _pack(tree)
    head = pickle.dumps(skeleton)
    slots, block = _slots([(tuple(t.shape), t.dtype) for t in tensors])
    start = _aligned(len(head))
    pinned = where.type == "cpu" and any(t.device.type == "cuda"
                                         for t in tensors)
    buffer = torch.empty(start + (block if tensors else 0),
                         dtype=torch.uint8, device=where, pin_memory=pinned)
    buffer[:len(head)].copy_(torch.frombuffer(bytearray(head),
                                              dtype=torch.uint8))
    _fill(buffer, start, tensors)
    return buffer, len(head), tensors


def _decode(buffer: torch.Tensor, head_bytes: int, device) -> object:
    """The tree :func:`_encode` packed into ``buffer``, its tensors new
    on ``device``."""
    skeleton = pickle.loads(buffer[:head_bytes].cpu().numpy().tobytes())
    flat: list = []
    _pack_slots(skeleton, flat)
    flat.sort(key=lambda slot: slot.index)
    slots, _ = _slots([(slot.shape, slot.dtype) for slot in flat])
    tensors = _read(buffer, _aligned(head_bytes), slots, device) \
        if flat else []
    return _unpack(skeleton, tensors)


def exchange_trees(group: _Group, tree, device: torch.device) -> list:
    """Every process's ``tree`` (dicts, lists and tuples of tensors and
    picklable values) in the group's process order, this process's as
    given, the others' new tensors on ``device``."""
    with group.lock:
        where = _stage_device(group, [device])
        buffer, head_bytes, tensors = _encode(tree, where)
        sizes = torch.zeros(_HEADER, dtype=torch.uint8, device=where)
        head = _header(group, 2, buffer.numel(), head_bytes)
        sizes.view(torch.int64)[:4].copy_(head)
        found = _check_headers(group, _gather_buffers(group, sizes), head)
        width = max(int(h[2]) for h in found)
        padded = torch.zeros(width, dtype=torch.uint8, device=where,
                             pin_memory=buffer.is_pinned())
        padded[:buffer.numel()].copy_(buffer)
        if where.type == "cpu":
            _wait_staged(tensors)
        buffers = _gather_buffers(group, padded)
    me = device_rule.process_index()
    return [tree if rank == me else _decode(got, int(h[3]), device)
            for rank, got, h in zip(group.ranks, buffers, found)]


# ---------------------------------------------------------------------------
# Point to point (stage hops).

def hop_tag(*parts) -> int:
    """A gloo tag for one hop (stream, frame, stage): the receiver takes
    the message the sender meant for that frame."""
    return zlib.crc32(repr(parts).encode()) & 0x3FFFFFFF


_sends: list = []                # (work, buffers held until it is done)


def _reap_sends(wait: bool = False) -> None:
    """Drop the finished sends (all of them, waiting, when ``wait``); a
    send that failed raises :class:`PeerLost`."""
    keep = []
    for work, held in _sends:
        if wait or work.is_completed():
            try:
                work.wait()
            except Exception as error:
                _sends.clear()
                raise PeerLost(f"a hop's send failed: "
                               f"{type(error).__name__}: {error}") from error
        else:
            keep.append((work, held))
    _sends[:] = keep


def flush_sends() -> None:
    """Wait for every hop this process sent (at the latest after
    :data:`BRINGUP_TIMEOUT_S`: a lost peer raises)."""
    _reap_sends(wait=True)


def shutdown() -> None:
    """The launcher's last call in each process: wait for the hops this
    process sent (a hop's send does not wait for its receiver, so a
    process that exits first would cut it), then leave the process
    group.  Also run at a normal interpreter exit."""
    import torch.distributed as dist
    with _lock:
        if not _state["initialized"]:
            return
        try:
            flush_sends()
        finally:
            dist.destroy_process_group()
            _state.update(initialized=False, transport=None, pairs={},
                          groups={}, layouts=set())
            device_rule._process.update(index=0, count=1, pool=None)


def send_tree(tree, destination: int, tag: int) -> None:
    """Send ``tree`` to process ``destination`` without waiting: its
    sizes and skeleton over the control group first, then its tensors'
    bytes over the data group (pinned host staging under gloo, the card
    under NCCL).  A failed earlier send raises here."""
    import torch.distributed as dist
    _reap_sends()
    me = device_rule.process_index()
    control, data = pair_groups(me, destination)
    nccl = _state["transport"] == "nccl"
    skeleton, tensors = _pack(tree)
    cards = [t.device for t in tensors if t.device.type == "cuda"]
    where = cards[0] if nccl and cards else torch.device("cpu")
    head = torch.frombuffer(bytearray(pickle.dumps(skeleton)),
                            dtype=torch.uint8)
    slots, block = _slots([(tuple(t.shape), t.dtype) for t in tensors])
    payload = torch.empty(block if tensors else 0, dtype=torch.uint8,
                          device=where,
                          pin_memory=where.type == "cpu" and bool(cards))
    _fill(payload, 0, tensors)
    if where.type == "cpu":
        _wait_staged(tensors)
    sizes = torch.tensor([head.numel(), payload.numel(),
                          int(where.type == "cuda")], dtype=torch.int64)
    try:
        for buffer, group, buffer_tag in (
                (sizes, control, 2 * tag), (head, control, 2 * tag),
                (payload, data, 0 if nccl else 2 * tag + 1)):
            if buffer.numel():
                _sends.append((dist.isend(buffer, destination, group=group,
                                          tag=buffer_tag), buffer))
    except Exception as error:
        raise PeerLost(f"a hop to process {destination} failed: "
                       f"{type(error).__name__}: {error}") from error


def recv_tree(source: int, tag: int, device: torch.device):
    """Receive what :func:`send_tree` sent from ``source``: a tree of new
    tensors on ``device``."""
    import torch.distributed as dist
    me = device_rule.process_index()
    control, data = pair_groups(me, source)
    try:
        sizes = torch.empty(3, dtype=torch.int64)
        dist.recv(sizes, source, group=control, tag=2 * tag)
        head = torch.empty(int(sizes[0]), dtype=torch.uint8)
        dist.recv(head, source, group=control, tag=2 * tag)
        skeleton = pickle.loads(head.numpy().tobytes())
        flat: list = []
        _pack_slots(skeleton, flat)
        count = int(sizes[1])
        on_card = bool(sizes[2])
        where = device if on_card else torch.device("cpu")
        payload = torch.empty(count, dtype=torch.uint8, device=where,
                              pin_memory=where.type == "cpu"
                              and device.type == "cuda")
        if count:
            dist.recv(payload, source, group=data,
                      tag=0 if on_card else 2 * tag + 1)
    except Exception as error:
        raise PeerLost(f"a hop from process {source} failed: "
                       f"{type(error).__name__}: {error}") from error
    flat.sort(key=lambda slot: slot.index)
    slots, _ = _slots([(slot.shape, slot.dtype) for slot in flat])
    tensors = _read(payload, 0, slots, device) if flat else []
    return _unpack(skeleton, tensors)


def _pack_slots(node, out: list) -> None:
    if isinstance(node, dict):
        for value in node.values():
            _pack_slots(value, out)
    elif isinstance(node, (list, tuple)):
        for value in node:
            _pack_slots(value, out)
    elif isinstance(node, _Slot):
        out.append(node)


class _SharedInput(torch.autograd.Function):
    """A global tensor argument of a mapped function over processes: the
    identity forward, and a backward that sums, in process order, the
    gradients every process's positions took from it (each process
    splits the same global tensor and runs only its own positions)."""

    @staticmethod
    def forward(ctx, group: _Group, tensor):
        ctx.group = group
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        template = [(tuple(grad.shape), grad.dtype)]
        slots, block = _slots(template)
        buffers = _exchange_blocks(group, [[grad]], block, 1, 1,
                                   [grad.device])
        total = None
        for buffer in buffers:
            part = _read(buffer, _HEADER, slots, grad.device)[0]
            total = part if total is None else total + part
        return None, total


def shared_input(group: _Group, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` whose gradient is summed over the processes of
    ``group`` (see :class:`_SharedInput`); as it is outside grad."""
    if torch.is_grad_enabled() and tensor.requires_grad:
        return _SharedInput.apply(group, tensor)
    return tensor
