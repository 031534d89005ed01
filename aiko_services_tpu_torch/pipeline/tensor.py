"""The data plane of the port: tensor frames, shape bucketing, compiled
caches, stage placement.

Counterpart of ``aiko_services_tpu/pipeline/tensor.py``:

- swag values are ``torch.Tensor``\\ s resident on the card between
  elements;
- a stage is *placed* on a group of the pool's devices
  (:class:`StagePlacement`; the pool is ``device.devices()``, this
  process's cards, or every process's after a multi-host bring-up),
  one card or several.  A hop with no spec lands a frame's tensors
  whole on the stage's LEAD card (``plan.device``, the first of its
  topology-sorted chunk) by ``Tensor.to(plan.device,
  non_blocking=True)``: the JAX package's replicated array computes the
  same value on every chip, so one computation on the lead card gives
  the same numbers.  A hop with a spec returns a
  :class:`~..parallel.mesh.Placed` over the stage's mesh, each card
  holding its shard (the JAX array sharded by ``NamedSharding``).  Only
  elements that shard use the other cards: the ``Detector`` splits a
  micro-batch over its stage's dp cards.  A hop moves tensor leaves
  only: host values (numpy arrays, text, lists) stay on the host until
  the element uploads them itself -- the ``Detector`` stacks a host
  burst and uploads each card's rows once, through pinned memory;
- :class:`JitCache` keys a function per (tree structure, shape, dtype
  and device of each leaf, context) -- the counterpart of ``jax.jit``'s
  compile once per shape: on the card a miss captures the call as a
  CUDA graph and every hit replays it; on the CPU it runs eagerly;
- :class:`ShapeBucketer` rounds ragged sizes up to a few buckets, so a
  captured graph or a kernel's launch plan sees few distinct shapes;
- only when a frame must leave the process is it encoded host-side
  (:func:`encode_array` / :func:`decode_array`);
- :func:`distributed_mesh_spec` parses the ``mesh`` request exactly as
  the JAX package does; :func:`ensure_distributed` skips the bring-up
  of a mesh with no coordinator, as the JAX package does, so
  :class:`StagePlacement` carves virtual host groups in this process,
  and brings up ``torch.distributed`` for a real multi-host mesh (a
  coordinator set, ``parallel/distributed.py``): the pool is then every
  process's devices and the carve groups it by process.  Every process
  builds the same pipeline and posts the same frames in the same order
  (multi-controller, as under ``jax.distributed``); a stage runs in the
  process that holds its cards, the others create its element but do
  not call it and hold :class:`RemoteValue` handles for its outputs.  A
  hop to a stage of another process sends the frame's tensors from the
  process that holds them over the process group
  (:meth:`StagePlacement.transfer_across`), never the broker.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import device as device_rule
from ..parallel import distributed
from ..parallel.mesh import MeshPlan, NamedSharding, Placed, make_mesh
from .element import PipelineElement

__all__ = ["ShapeBucketer", "JitCache", "LeafSignature", "StagePlacement",
           "TPUElement", "encode_array", "decode_array", "tree_device_put",
           "device_sort_key", "distributed_mesh_spec",
           "ensure_distributed", "RemoteValue", "HostValueAcrossHosts"]


# ---------------------------------------------------------------------------
# Multi-host mesh request (parsed as in the JAX package) and bring-up.

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
    """Bring up ``torch.distributed`` for a REAL multi-host mesh (a
    coordinator is configured and more than one host declared), once a
    process (``parallel.distributed.ensure``); afterwards
    ``device.devices()`` is the GLOBAL pool and :class:`StagePlacement`
    groups it by process.  Single-process/virtual meshes (no
    coordinator -- the CI shape) skip the bring-up and carve virtual
    host groups instead.  Returns (process_index, process_count).  A
    bring-up that fails raises (a peer missing after
    ``distributed.BRINGUP_TIMEOUT_S``)."""
    if spec and spec.get("coordinator") and spec["hosts"] > 1:
        return distributed.ensure(spec["hosts"], spec["coordinator"],
                                  spec["process_id"])
    return device_rule.process_index(), device_rule._process["count"]


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
# Per-element compiled-function cache.

def _is_array(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, np.ndarray, LeafSignature))


class LeafSignature:
    """The cache signature of a tensor that does not exist yet: what a
    host array keys as once it is uploaded to ``device``
    (``FusedSegment.would_compile`` probes the call it is about to make
    without making the upload)."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device


class _Captured:
    """One signature's CUDA graph: the static inputs it reads, the
    outputs it writes, the kernel launches it holds, and an event after
    the last replay's output copies (a replay from another stream waits
    for it before it overwrites the static inputs)."""

    __slots__ = ("device", "graph", "inputs", "outputs", "launches", "done")

    def __init__(self, device, graph, inputs, outputs, launches):
        self.device, self.graph = device, graph
        self.inputs, self.outputs = inputs, outputs
        self.launches = launches
        self.done = None


class JitCache:
    """Cache a function per input signature: the counterpart of the JAX
    package's ``jax.jit`` cache keyed on avals.

    ``cache(fn)(*args)`` keys each call on the arguments' tree
    structure, each leaf's shape, dtype and device (other leaves by
    ``repr``) and the caller's context.  On a CUDA device a miss warms
    the function up on a side stream, captures it as a CUDA graph on
    static copies of its inputs and replays it; a hit copies the inputs
    into the static buffers and replays.  The outputs are cloned after
    each replay: two batches of one signature may be in flight, and the
    next replay overwrites the graph's own outputs.  The capture runs
    in ``thread_local`` mode with the synchronisation guard lifted
    (``device.sync_allowed``: ``torch.cuda.graph`` waits for the card
    first), as ``models/loop_graph.py`` does; a capture that fails
    raises -- there is no eager fallback on the card.  On the CPU the
    function runs eagerly.  Kernel launches recorded by a capture are
    taken back from the launch counters and added again at each replay,
    so the counters count launches that ran.

    ``capture_s`` sums the warm-ups and captures.  ``stats`` exposes
    hit/miss/entry counters for the Metrics element,
    the dashboard share dict (``Pipeline.jit_stats``) and the bench's
    ``jit_cache_*`` keys.
    """

    def __init__(self):
        self._compiled: dict = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.capture_s = 0.0            # warm-up and capture, on the card

    @staticmethod
    def _key(fn, args, kwargs, context=None):
        leaves, treedef = pytree.tree_flatten((args, kwargs))
        sig = tuple(
            (tuple(leaf.shape), str(leaf.dtype),
             "host" if isinstance(leaf, np.ndarray)
             else str(leaf.device)) if _is_array(leaf)
            else repr(leaf) for leaf in leaves)
        return (id(fn), str(treedef), sig, context)

    def probe(self, fn, args: tuple, kwargs: dict | None = None,
              context=None) -> bool:
        """True when a call with these arguments would MISS (capture
        on the card) -- lets callers time/annotate first-use captures
        without racing the counters.  ``context`` partitions the key
        space (a replicated stage's replicas share signatures but not
        graphs)."""
        return self._key(fn, args, kwargs or {}, context) \
            not in self._compiled

    def __call__(self, fn: Callable) -> Callable:
        def wrapper(*args, _cache_context=None, **kwargs):
            key = self._key(fn, args, kwargs, _cache_context)
            leaves = pytree.tree_leaves((args, kwargs))
            on_card = any(isinstance(leaf, torch.Tensor)
                          and leaf.device.type == "cuda" for leaf in leaves)
            if not on_card:
                with self._lock:
                    if key in self._compiled:
                        self.hits += 1
                    else:
                        self.misses += 1
                        self._compiled[key] = True
                return fn(*args, **kwargs)
            with self._lock:
                entry = self._compiled.get(key)
                if entry is not None:
                    self.hits += 1
                else:
                    self.misses += 1
                    begin = time.perf_counter()
                    entry = self._compiled[key] = self._capture(fn, args,
                                                                kwargs)
                    self.capture_s += time.perf_counter() - begin
                return self._replay(entry, leaves)

        wrapper.fn = fn
        return wrapper

    @staticmethod
    def _capture(fn, args, kwargs) -> _Captured:
        from ..ops import launch_counters
        leaves, treedef = pytree.tree_flatten((args, kwargs))
        for leaf in leaves:
            if isinstance(leaf, np.ndarray):
                raise TypeError(
                    "JitCache: a host array cannot enter a CUDA graph; "
                    "upload it first")
        tensors = [leaf for leaf in leaves if isinstance(leaf, torch.Tensor)]
        device = next(leaf.device for leaf in tensors
                      if leaf.device.type == "cuda")
        # The capture runs on a stream of the leaves' own card: the
        # graph's default capture stream lives on whichever card made it
        # first, and a capture there would miss this card's launches.
        with device_rule.sync_allowed(), torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                fn(*args, **kwargs)         # warm-up: handles, workspaces
            stream.wait_stream(side)
            static = [leaf.clone() if isinstance(leaf, torch.Tensor)
                      else leaf for leaf in leaves]
            static_args, static_kwargs = pytree.tree_unflatten(static,
                                                               treedef)
            counters = list(launch_counters().values())
            before = [getattr(wrapper, attr) for wrapper, attr in counters]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                                  capture_error_mode="thread_local"):
                outputs = fn(*static_args, **static_kwargs)
            launches = {}
            for (wrapper, attr), start in zip(counters, before):
                captured = getattr(wrapper, attr) - start
                setattr(wrapper, attr, start)
                if captured:
                    launches[wrapper, attr] = captured
        return _Captured(device, graph, static, outputs, launches)

    @staticmethod
    def _replay(entry: _Captured, leaves: list):
        stream = torch.cuda.current_stream(entry.device)
        if entry.done is not None:
            stream.wait_event(entry.done)
        for target, leaf in zip(entry.inputs, leaves):
            if isinstance(target, torch.Tensor):
                target.copy_(leaf)
        entry.graph.replay()
        for (wrapper, attr), count in entry.launches.items():
            setattr(wrapper, attr, getattr(wrapper, attr) + count)
        outputs = pytree.tree_map(
            lambda leaf: leaf.clone() if isinstance(leaf, torch.Tensor)
            else leaf, entry.outputs)
        entry.done = torch.cuda.Event()
        entry.done.record(stream)
        return outputs

    @property
    def entries(self) -> int:
        return len(self._compiled)

    @property
    def devices(self) -> set:
        """The cards the captured graphs live on (empty on the CPU)."""
        return {entry.device for entry in self._compiled.values()
                if isinstance(entry, _Captured)}

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._compiled),
                "signatures": len(self._compiled)}


# ---------------------------------------------------------------------------
# Stage placement: pipeline stages onto disjoint device groups.

def device_sort_key(device):
    """ICI-topology order for carving contiguous stage chunks: TPU chip
    ``coords`` (x, y, z) then core, so consecutive devices in the sorted
    pool are ICI neighbours and adjacent stages' chunks touch.  Devices
    without coords fall back to (process, id) order -- a
    ``torch.device``'s id is its index (a card's ordinal, a CPU
    descriptor's number), the order ``device.local_devices()``
    enumerates, and its process this one (another's for a
    ``device.RemoteDevice``)."""
    coords = getattr(device, "coords", None)
    if coords is not None:
        try:
            return (0, tuple(int(c) for c in coords),
                    int(getattr(device, "core_on_chip", 0) or 0))
        except (TypeError, ValueError):
            pass
    if isinstance(device, (torch.device, device_rule.RemoteDevice)):
        return (1, (device_rule.process_index(device),), device.index or 0)
    return (1, (), int(getattr(device, "id", 0)))


class StagePlacement:
    """Carve the local device set into per-stage submeshes.

    The JAX package's carving, replicas, failover and accounting on
    ``torch.device`` lists (the pool defaults to ``device.devices()``,
    every process's after a multi-host bring-up).  A stage may span
    several cards.
    ``transfer`` with no spec moves tensor leaves to the stage's lead
    card (``MeshPlan.device``) with ``Tensor.to(device,
    non_blocking=True)``, asynchronous on the card; with a spec it
    places each tensor leaf over the stage's mesh (a ``Placed``, each
    card its shard).  A leaf already resident is skipped (a CPU tensor
    is resident on every CPU descriptor: its device carries no index),
    and so is a ``Placed`` already laid out on the target mesh by the
    same spec; another ``Placed`` is resharded (gathered onto the
    target's lead card, then split), or gathered whole onto the lead
    card by a hop with no spec.  A host value (numpy, text) is left as
    it is, so a frame of host values hops without a call to any card.
    The rest of this docstring is the JAX package's.

    The reference deploys stages into other OS processes found by
    ServiceFilter (reference pipeline.py:246-258); on TPU a stage lands
    on a group of local chips instead.  ``assign`` partitions the
    topology-sorted device pool contiguously (``device_sort_key``: chip
    coords, so "contiguous" means ICI neighbours and adjacent stages are
    ICI-adjacent) and returns a ``MeshPlan`` per stage; ``transfer``
    reshards a frame's tensors onto the next stage's mesh -- on TPU a
    pure ICI copy, dispatched asynchronously (``jax.device_put`` does
    not block) with the ``NamedSharding`` memoized per
    (stage, generation, spec) and already-resident leaves passed through
    untouched.

    A stage may request ``"auto"`` devices: after fixed requests are
    carved, the remaining pool splits across the auto stages
    proportionally to their measured per-element cost
    (``record_cost``, fed from profiled element spans; equal split
    until profiles exist).  ``replace()`` re-resolves auto splits
    against the survivors, so the balance tracks both the profile and
    the shrinking pool.

    Replicated stages (ISSUE 7): ``assign(..., replicas={stage: N})``
    splits a stage's allocation into N data-parallel **replica
    submeshes** -- contiguous slices of the topology-sorted chunk, each
    its own MeshPlan, so ICI locality holds within a replica.  Fixed
    requests describe ONE replica (total = prod(axes) * N, so
    power-of-two per-replica shapes stay power-of-two); ``auto``
    requests split the stage's cost-proportional share near-equally
    across the replicas.  ``drop_replica`` retires ONE replica's chips
    without touching any peer's submesh (the peer-shedding failover
    path: generation does NOT bump); ``reassign()`` re-fits the
    original requests to the surviving pool (shedding replicas down to
    ``replica_min`` before halving fixed axes) -- the background
    rebuild after a failover, and the autoscaler's re-split.
    """

    def __init__(self, devices: Sequence | None = None):
        self.devices = sorted(devices if devices is not None
                              else device_rule.devices(),
                              key=device_sort_key)
        self.plans: dict[str, MeshPlan] = {}
        self._requests: dict = {}
        # Multi-host mesh mode (ISSUE 9): the pool partitions into
        # per-host device groups -- by the process index under a real
        # torch.distributed mesh, or N contiguous virtual groups of
        # the topology-sorted pool in a single process (the CI shape,
        # same carving code).  Stages land wholly inside ONE host's
        # group (``stage_hosts``), so a stage hop between same-host
        # stages is ICI and a cross-host hop is DCN through the shared
        # global mesh -- never the broker.
        self.hosts: int | None = None
        self.host_groups: list[list] = []
        self.stage_hosts: dict[str, int] = {}
        self._stage_host_pins: dict[str, int] = {}
        self.generation = 0             # bumped by every replace()
        self.costs: dict[str, float] = {}    # stage -> EMA seconds/frame
        self._shardings: dict = {}      # (stage, replica, gen, spec) memo
        self.transfer_puts = 0          # leaves actually moved
        self.transfer_skipped = 0       # leaves already resident
        # Replicated stages: stage -> [MeshPlan | None per slot] (None =
        # dead, retired by drop_replica), the DESIRED counts (what
        # reassign restores toward), and the floor replica counts the
        # fit loop respects when shedding.  ``replica_epoch`` bumps on
        # every drop/reassign so per-replica plan caches (TPUElement)
        # invalidate without a full-generation bump.
        self.replica_plans: dict[str, list] = {}
        self._replica_desired: dict[str, int] = {}
        self._replica_min: dict[str, int] = {}
        self.replica_epoch = 0

    # -- carving -----------------------------------------------------------

    @staticmethod
    def _normalize(stages: dict) -> dict:
        requests = {}
        for name, want in stages.items():
            if isinstance(want, str):
                if want.strip().lower() != "auto":
                    raise ValueError(
                        f"stage {name!r}: device request must be a chip "
                        f"count, a mesh dict, or 'auto', got {want!r}")
                requests[name] = "auto"
            else:
                requests[name] = {"dp": want} if isinstance(want, int) \
                    else dict(want)
        return requests

    def _resolve(self, requests: dict, pool: int,
                 replicas: dict | None = None) -> dict[str, int]:
        """Resolve every stage to a TOTAL device count against a pool of
        ``pool`` devices.  Fixed requests describe one replica, so a
        replicated fixed stage takes prod(axes) * N; ``auto`` stages
        split the free chips proportionally to recorded per-stage cost,
        floored at one chip per replica."""
        replicas = replicas or {}

        def floor_of(name):
            return max(1, replicas.get(name, 1))

        fixed = {name: int(np.prod(list(axes.values())))
                 * replicas.get(name, 1)
                 for name, axes in requests.items() if axes != "auto"}
        auto = [name for name, axes in requests.items() if axes == "auto"]
        fixed_total = sum(fixed.values())
        auto_floor = sum(floor_of(name) for name in auto)
        if fixed_total + auto_floor > pool:
            raise ValueError(
                f"stages want {fixed_total + auto_floor} devices, "
                f"have {pool}")
        shares: dict[str, int] = {}
        if auto:
            free = pool - fixed_total
            weights = {name: max(float(self.costs.get(name, 0.0)), 0.0)
                       for name in auto}
            if not any(weights.values()):
                weights = {name: 1.0 for name in auto}   # unprofiled
            else:
                # A stage with no profile yet gets the smallest known
                # weight rather than zero chips.
                floor = min(w for w in weights.values() if w > 0)
                weights = {name: (w if w > 0 else floor)
                           for name, w in weights.items()}
            total_w = sum(weights.values())
            shares = {name: max(floor_of(name),
                                int(free * weights[name] / total_w))
                      for name in auto}
            # Largest-remainder fit to exactly ``free`` chips.
            while sum(shares.values()) > free:
                name = max((n for n in auto
                            if shares[n] > floor_of(n)),
                           key=lambda n: shares[n])
                shares[name] -= 1
            while sum(shares.values()) < free:
                name = max(auto, key=lambda n: (
                    free * weights[n] / total_w - shares[n]))
                shares[name] += 1
        return {name: (shares[name] if axes == "auto" else fixed[name])
                for name, axes in requests.items()}

    def assign(self, stages: dict, costs: dict | None = None,
               replicas: dict | None = None,
               replica_min: dict | None = None,
               hosts: int | None = None,
               stage_hosts: dict | None = None) -> dict[str, MeshPlan]:
        """stages: name -> chip count, {axis: size} mesh request, or
        ``"auto"``.  ``costs`` (stage -> seconds) seeds the profile the
        auto split balances on.  ``replicas`` (stage -> N >= 1) splits
        those stages' allocations into N replica submeshes (a fixed
        request then describes ONE replica); ``replica_min`` floors the
        counts the fit loop may shed to under device loss.  ``hosts``
        > 1 enables mesh mode: the pool partitions into per-host
        groups and every stage carves wholly inside one group --
        pinned by ``stage_hosts`` (stage -> host index, the placement
        block's ``host`` key) or filled greedily in declaration
        order."""
        if costs:
            for name, seconds in costs.items():
                self.record_cost(name, float(seconds))
        requests = self._normalize(stages)
        replicas = {name: max(1, int(count))
                    for name, count in (replicas or {}).items()
                    if name in requests}
        self._requests = requests
        self._replica_desired = dict(replicas)
        if replica_min is not None:
            self._replica_min = {name: max(1, int(count))
                                 for name, count in replica_min.items()}
        self.hosts = int(hosts) if hosts and int(hosts) > 1 else None
        self._stage_host_pins = {name: int(index) for name, index
                                 in (stage_hosts or {}).items()}
        self._carve(requests, replicas)
        return self.plans

    # -- mesh mode: per-host device groups ---------------------------------

    def _host_groups_for(self, devices: list) -> list[list]:
        """Partition ``devices`` into per-host groups: by the process
        index when a torch.distributed mesh spans processes, else
        ``self.hosts`` contiguous chunks of the topology-sorted pool
        (virtual hosts -- single-process reproduction of the multi-host
        carve, same code path)."""
        by_process: dict[int, list] = {}
        for device in devices:
            by_process.setdefault(device_rule.process_index(device),
                                  []).append(device)
        if len(by_process) > 1:
            return [by_process[key] for key in sorted(by_process)]
        count = self.hosts or 1
        base, rem = divmod(len(devices), count)
        groups, pos = [], 0
        for index in range(count):
            size = base + (1 if index < rem else 0)
            groups.append(devices[pos:pos + size])
            pos += size
        return groups

    def stage_host(self, stage: str) -> int | None:
        """Which host group a stage is placed on (None outside mesh
        mode)."""
        return self.stage_hosts.get(stage) if self.hosts else None

    def same_host(self, stage_a: str, stage_b: str) -> bool:
        """True when a hop between the stages stays inside one host's
        ICI domain (always true outside mesh mode: one host)."""
        if not self.hosts:
            return True
        return self.stage_hosts.get(stage_a) \
            == self.stage_hosts.get(stage_b)

    def _carve(self, requests: dict, replicas: dict) -> None:
        """Cut the topology-sorted pool into per-stage chunks (and
        per-replica sub-chunks) for already-fitted requests; in mesh
        mode every chunk comes wholly from one host group."""
        resolved = self._resolve(requests, len(self.devices), replicas)
        self.plans = {}
        self.replica_plans = {}
        if self.hosts:
            self._carve_hosted(requests, replicas, resolved)
            return
        cursor = 0
        for name, axes in requests.items():
            total = resolved[name]
            chunk = self.devices[cursor:cursor + total]
            cursor += total
            self._place_chunk(name, axes, chunk, replicas)

    def _carve_hosted(self, requests: dict, replicas: dict,
                      resolved: dict) -> None:
        groups = self._host_groups_for(self.devices)
        self.host_groups = groups
        self.stage_hosts = {}
        cursors = [0] * len(groups)
        fill = 0
        for name, axes in requests.items():
            total = resolved[name]
            pin = self._stage_host_pins.get(name)
            if pin is not None:
                if not 0 <= pin < len(groups):
                    raise ValueError(
                        f"stage {name!r}: host {pin} out of range "
                        f"(mesh has {len(groups)} hosts)")
                if len(groups[pin]) - cursors[pin] < total:
                    raise ValueError(
                        f"stage {name!r} wants {total} chips on host "
                        f"{pin}, which has "
                        f"{len(groups[pin]) - cursors[pin]} free")
                host = pin
            else:
                host = None
                for offset in range(len(groups)):
                    candidate = (fill + offset) % len(groups)
                    if len(groups[candidate]) - cursors[candidate] \
                            >= total:
                        host = candidate
                        break
                if host is None:
                    raise ValueError(
                        f"stage {name!r} wants {total} chips but no "
                        f"host group has that many free (a stage "
                        f"never spans hosts -- its submesh must fit "
                        f"one ICI domain)")
                fill = host
            chunk = groups[host][cursors[host]:cursors[host] + total]
            cursors[host] += total
            self.stage_hosts[name] = host
            self._place_chunk(name, axes, chunk, replicas)

    def _place_chunk(self, name: str, axes, chunk: list,
                     replicas: dict) -> None:
        """Build a stage's MeshPlan (and replica sub-plans) from its
        carved device chunk -- shared by the flat and hosted carves."""
        total = len(chunk)
        if name in replicas:
            count = replicas[name]
            subs, pos = [], 0
            base, rem = divmod(total, count)
            for index in range(count):
                size = base + (1 if index < rem else 0)
                sub = chunk[pos:pos + size]
                pos += size
                sub_axes = dict(axes) if axes != "auto" \
                    else {"dp": size}
                subs.append(MeshPlan(make_mesh(sub_axes, sub)))
            self.replica_plans[name] = subs
            # The whole-stage plan (stage_devices, default hops,
            # stats) spans every replica's chips as one dp pool.
            self.plans[name] = MeshPlan(
                make_mesh({"dp": total}, chunk))
        else:
            plan_axes = dict(axes) if axes != "auto" \
                else {"dp": total}
            self.plans[name] = MeshPlan(make_mesh(plan_axes, chunk))

    def record_cost(self, stage: str, seconds: float) -> None:
        """EMA of the measured per-frame cost of a stage (fed from the
        engine's element spans); ``devices: auto`` splits re-balance on
        it at the next assign()/replace()."""
        prior = self.costs.get(stage)
        self.costs[stage] = float(seconds) if prior is None \
            else 0.75 * prior + 0.25 * float(seconds)

    def _fit(self, pool_size: int) -> tuple[dict, dict]:
        """Shrink the ORIGINAL requests (and desired replica counts)
        until they fit ``pool_size`` devices: replicated stages shed
        replicas first (graceful N-1 degradation, floored at
        ``replica_min``), then fixed stages halve their largest axis
        (power-of-two steps keep dp/tp/fsdp shardings valid)."""
        requests = {name: (axes if axes == "auto" else dict(axes))
                    for name, axes in self._requests.items()}
        replicas = dict(self._replica_desired)

        def need():
            total = 0
            for name, axes in requests.items():
                count = replicas.get(name, 1)
                if axes == "auto":
                    total += max(1, count)
                else:
                    total += int(np.prod(list(axes.values()))) * count
            return total

        def stage_need(name):
            axes = requests[name]
            count = replicas.get(name, 1)
            return count if axes == "auto" \
                else int(np.prod(list(axes.values()))) * count

        while need() > pool_size:
            sheddable = [name for name, count in replicas.items()
                         if count > self._replica_min.get(name, 1)]
            if sheddable:
                name = max(sheddable, key=stage_need)
                replicas[name] -= 1
                continue
            shrinkable = [name for name, axes in requests.items()
                          if axes != "auto"
                          and int(np.prod(list(axes.values()))) > 1]
            if not shrinkable:
                raise RuntimeError(
                    f"cannot shrink stages below one device "
                    f"({pool_size} survivors for "
                    f"{len(requests)} stages)")
            name = max(shrinkable,
                       key=lambda n: int(np.prod(
                           list(requests[n].values()))))
            axes = requests[name]
            axis = max(axes, key=axes.get)
            axes[axis] = max(1, axes[axis] // 2)
        return requests, replicas

    def replace(self, failed_devices: Sequence) -> dict[str, MeshPlan]:
        """Re-place every stage onto the surviving devices (SURVEY.md
        §5.3 TPU-equiv: re-shard onto surviving chips).

        Failed devices leave the pool permanently (survivors keep their
        topology-sorted order, so chunks stay ICI-contiguous);
        replicated stages shed replicas first (down to ``replica_min``),
        then fixed stage requests shrink by halving their largest axis
        (power-of-two steps keep dp/tp/fsdp shardings valid) until the
        total fits, and ``auto`` stages re-split the remaining pool by
        recorded cost.  Plans are rebuilt in place -- elements must drop
        cached plans and re-put weights
        (``TPUElement.on_replacement``)."""
        failed = set(failed_devices)
        survivors = [d for d in self.devices if d not in failed]
        if len(survivors) == len(self.devices):
            return self.plans
        if not survivors:
            raise RuntimeError("no surviving devices to re-place onto")
        requests, replicas = self._fit(len(survivors))
        self.devices = survivors
        self._shardings.clear()
        self.generation += 1
        self.replica_epoch += 1
        self._carve(requests, replicas)
        return self.plans

    def reassign(self) -> dict[str, MeshPlan]:
        """Re-fit the ORIGINAL requests (desired replica counts
        included) onto the current pool and re-carve every stage: the
        background rebuild of a dropped replica, and the autoscaler's
        re-split after ``set_replicas``.  Bumps the generation --
        callers must invalidate plans/frames exactly as after
        ``replace()``."""
        requests, replicas = self._fit(len(self.devices))
        self._shardings.clear()
        self.generation += 1
        self.replica_epoch += 1
        self._carve(requests, replicas)
        return self.plans

    def plan(self, stage: str) -> MeshPlan:
        return self.plans[stage]

    # -- replicated stages -------------------------------------------------

    @property
    def has_replicas(self) -> bool:
        return bool(self.replica_plans)

    def replica_total(self, stage: str) -> int:
        """Slots (live or dead) of a replicated stage; 0 when the stage
        is not replicated."""
        return len(self.replica_plans.get(stage, ()))

    def live_replicas(self, stage: str) -> list[int]:
        return [index for index, plan
                in enumerate(self.replica_plans.get(stage, ()))
                if plan is not None]

    def replica_plan(self, stage: str, index: int) -> MeshPlan:
        plan = self.replica_plans[stage][index]
        if plan is None:
            raise KeyError(f"stage {stage!r} replica {index} is dead")
        return plan

    def replica_devices(self, stage: str, index: int) -> set:
        plans = self.replica_plans.get(stage, ())
        if index >= len(plans) or plans[index] is None:
            return set()
        return set(plans[index].mesh.devices.flat)

    def replica_of(self, stage: str, device) -> int | None:
        """Which live replica of ``stage`` owns ``device`` (None when
        the stage is not replicated or the device is not placed
        there)."""
        for index, plan in enumerate(self.replica_plans.get(stage, ())):
            if plan is not None and device in set(plan.mesh.devices.flat):
                return index
        return None

    def set_replicas(self, stage: str, count: int) -> None:
        """Update a replicated stage's DESIRED count (the autoscaler's
        knob); takes effect at the next ``reassign()``."""
        if stage not in self._replica_desired:
            raise KeyError(f"stage {stage!r} is not replicated")
        self._replica_desired[stage] = max(
            self._replica_min.get(stage, 1), int(count))

    def drop_replica(self, stage: str, index: int) -> set:
        """Retire ONE replica's chips (peer-shedding failover): the
        devices leave the pool permanently, the slot reads dead, and --
        the point -- no other submesh is touched: peers keep serving on
        their exact meshes, so ``generation`` does NOT bump (only
        ``replica_epoch``, which invalidates per-replica plan caches
        and this stage's memoized shardings).  Returns the retired
        device set (empty when the slot is unknown/already dead)."""
        subs = self.replica_plans.get(stage)
        if not subs or index >= len(subs) or subs[index] is None:
            return set()
        dead = set(subs[index].mesh.devices.flat)
        subs[index] = None
        self.devices = [d for d in self.devices if d not in dead]
        alive = [d for plan in subs if plan is not None
                 for d in plan.mesh.devices.flat]
        if alive:
            self.plans[stage] = MeshPlan(
                make_mesh({"dp": len(alive)}, alive))
        else:
            self.plans.pop(stage, None)
        self.replica_epoch += 1
        self._shardings = {key: value
                           for key, value in self._shardings.items()
                           if key[0] != stage}
        return dead

    def stage_devices(self, stage: str) -> set:
        """The devices a stage's submesh currently occupies (empty for
        an unknown stage) -- the chaos harness's ``device_kill`` target
        resolution and the replay path's blast-radius checks."""
        plan = self.plans.get(stage)
        if plan is None:
            return set()
        return set(plan.mesh.devices.flat)

    # -- stage hops --------------------------------------------------------

    def stage_sharding(self, stage: str, spec: tuple = (),
                       replica: int | None = None):
        """The memoized target of a hop to ``stage`` (or one replica's
        submesh of it): the stage's lead card with no spec, a
        ``NamedSharding`` over its mesh with one -- resolved once per
        (stage, replica, generation, spec), not per frame, and without
        a call to any card."""
        key = (stage, replica, self.generation,
               tuple(spec) if spec else None)
        sharding = self._shardings.get(key)
        if sharding is None:
            plan = self.plans[stage] if replica is None \
                else self.replica_plan(stage, replica)
            sharding = plan.shard(*spec) if spec else plan.replicated()
            self._shardings[key] = sharding
        return sharding

    def transfer(self, value, to_stage: str, *spec,
                 replica: int | None = None):
        """Move ``value`` (tensor or pytree) onto a stage (a single
        replica's submesh when ``replica`` is given): with no spec each
        tensor leaf onto the stage's lead card, with a spec each onto
        its mesh as a ``Placed``.

        Non-blocking: the copies are enqueued and the call returns, so
        the hop overlaps the upstream stage's next-frame compute.
        Leaves already where the hop would put them pass through
        untouched (counted in ``transfer_skipped``); host leaves stay
        on the host."""
        target = self.stage_sharding(to_stage, spec, replica=replica)

        def hop(leaf):
            if not isinstance(leaf, (torch.Tensor, Placed)):
                return leaf
            if _arrived(leaf, target):
                self.transfer_skipped += 1
                return leaf
            self.transfer_puts += 1
            return _place(leaf, target)

        return pytree.tree_map(hop, value)

    # -- stages of other processes (a real multi-host mesh) ----------------

    def stage_process(self, stage: str) -> int:
        """The process whose devices hold ``stage`` (a stage never spans
        hosts)."""
        return device_rule.process_index(
            self.plans[stage].mesh.devices.flat[0])

    @property
    def across_hosts(self) -> bool:
        """True in mesh mode over a real multi-host bring-up: stages then
        lie in several processes."""
        return bool(self.hosts) and distributed.initialized()

    def hop_across(self, node, frame, inputs: dict, host_typed: list,
                   stream_id) -> tuple[dict, dict | None]:
        """The engine's stage hop in a multi-host mesh: (the inputs as
        :meth:`transfer_across` moves them, the stage's outputs as
        :class:`RemoteValue` handles when the stage runs in another
        process, else None).  An input produced by a stage of another
        process is the producer's to send; a host-typed one fails the
        frame (``ValueError`` naming the stage and host), as fetching
        an array of another host raises under ``jax.distributed``."""
        stage = node.name
        target = self.stage_process(stage)
        mapping = node.properties or {}
        sources = {}
        for name in inputs:
            key = mapping.get(name, name)
            producer = frame.produced.get(key) or key.partition(".")[0]
            sources[name] = (self.stage_process(producer), producer) \
                if producer in self.plans else None
        for name in host_typed:
            if sources.get(name) and sources[name][0] != target:
                raise HostValueAcrossHosts(
                    f"host input {name!r} was produced by stage "
                    f"{sources[name][1]!r} on host {sources[name][0]}, "
                    f"and stage {stage!r} runs on host {target}")
        moved = {name: value for name, value in inputs.items()
                 if name not in host_typed}
        moved = self.transfer_across(
            moved, stage, sources, distributed.hop_tag(
                stream_id, frame.frame_id, stage),
            replica=frame.stage_replica if frame.stage == stage else None)
        if target != device_rule.process_index():
            outputs = node.element.definition.output \
                if node.element.definition else []
            return moved, {io["name"]: RemoteValue(target, stage, io["name"])
                           for io in outputs}
        held = [leaf for value in moved.values()
                for leaf in pytree.tree_leaves(value)
                if isinstance(leaf, RemoteValue)]
        if held:
            raise HostValueAcrossHosts(
                f"stage {stage!r} on host {target} was handed {held[0]}, "
                f"which no stage hop brought here")
        return moved, None

    def transfer_across(self, inputs: dict, to_stage: str, sources: dict,
                        tag: int, *spec, replica: int | None = None) -> dict:
        """A hop to ``to_stage`` in a multi-host mesh.  ``sources`` names,
        for each input, the (process, stage) of the stage that produced
        it, or None when every process holds it (a frame's own data).
        In the stage's process, each input another process holds is
        received from it (:func:`~..parallel.distributed.recv_tree`),
        then every input is placed as :meth:`transfer` places it; a host
        value produced there raises :class:`HostValueAcrossHosts`.  In
        another process, the inputs this one holds are sent to the
        stage's process, and every input becomes a :class:`RemoteValue`
        naming it; a process that holds none moves nothing."""
        me = device_rule.process_index()
        target = self.stage_process(to_stage)
        if me != target:
            mine = {name: _sendable(value)
                    for name, value in sorted(inputs.items())
                    if sources.get(name) and sources[name][0] == me}
            if mine:
                distributed.send_tree(mine, target, tag)
            for name, value in mine.items():
                for leaf in pytree.tree_leaves(value):
                    if isinstance(leaf, _HostLeaf):  # its receiver fails too
                        raise HostValueAcrossHosts(
                            f"{name}: a host value ({leaf.kind}) produced "
                            f"by stage {sources[name][1]!r} on host {me} "
                            f"cannot cross to host {target}")
            return {name: RemoteValue(target, to_stage, name)
                    for name in inputs}
        lead = self.plans[to_stage].device
        arrived = dict(inputs)
        by_process: dict = {}
        for name, source in sorted(sources.items()):
            if source and source[0] != me:
                by_process.setdefault(source[0], []).append(name)
        for process, names in sorted(by_process.items()):
            got = distributed.recv_tree(process, tag, lead)
            for name in names:
                for leaf in pytree.tree_leaves(got[name]):
                    if isinstance(leaf, _HostLeaf):
                        raise HostValueAcrossHosts(
                            f"{name}: a host value ({leaf.kind}) produced "
                            f"by stage {sources[name][1]!r} on host "
                            f"{process} cannot cross to host {me}")
                arrived[name] = got[name]
        return self.transfer(arrived, to_stage, *spec, replica=replica)

    @property
    def stats(self) -> dict:
        result = {"generation": self.generation,
                  "stages": {name: int(plan.mesh.devices.size)
                             for name, plan in self.plans.items()},
                  "costs_ms": {name: round(cost * 1000.0, 3)
                               for name, cost in self.costs.items()},
                  "transfer_puts": self.transfer_puts,
                  "transfer_skipped": self.transfer_skipped,
                  "shardings_cached": len(self._shardings)}
        if self.replica_plans:
            result["replica_epoch"] = self.replica_epoch
            result["replicas"] = {
                name: [None if plan is None
                       else int(plan.mesh.devices.size)
                       for plan in plans]
                for name, plans in self.replica_plans.items()}
        if self.hosts:
            result["hosts"] = self.hosts
            result["host_groups"] = [len(group)
                                     for group in self.host_groups]
            result["stage_hosts"] = dict(self.stage_hosts)
        return result


class RemoteValue:
    """A handle to an output that a stage computed in another process of
    a multi-host mesh: the counterpart of a JAX array this process cannot
    address.  It names the process, the stage and the output."""

    __slots__ = ("process_index", "stage", "name")

    def __init__(self, process_index: int, stage: str, name: str):
        self.process_index, self.stage, self.name = \
            int(process_index), stage, name

    def __repr__(self) -> str:
        return (f"RemoteValue(process {self.process_index}, "
                f"{self.stage}.{self.name})")


class HostValueAcrossHosts(ValueError):
    """A host value (text, a list, a numpy array) produced by a stage in
    another process: only tensors cross hosts."""


class _HostLeaf:
    """What a hop sends in place of a host value: its type's name."""

    def __init__(self, kind: str):
        self.kind = kind


def _sendable(value):
    """``value`` as a hop sends it: tensors as they are, a placed tree
    gathered whole onto its lead card, a host value as its type."""
    if isinstance(value, Placed):
        return value.gather(MeshPlan(value.mesh).device)
    if isinstance(value, dict):
        return {key: _sendable(item) for key, item in value.items()}
    if isinstance(value, (list, tuple)) and not isinstance(value, str):
        return type(value)(_sendable(item) for item in value)
    if isinstance(value, torch.Tensor):
        return value
    return _HostLeaf(type(value).__name__)


def resident(tensor: torch.Tensor, device: torch.device) -> bool:
    """True when ``tensor`` already lies on ``device``.  A CPU tensor's
    device carries no index, so it is resident on every CPU descriptor
    (the tests' stand-ins for cards)."""
    if tensor.device.type != device.type:
        return False
    return device.type == "cpu" or device.index is None \
        or tensor.device.index == device.index


def _upload(leaf, device: torch.device):
    """One leaf onto ``device``: a tensor by an asynchronous copy, a
    host array through pinned memory on the card; anything else (text,
    numbers) as it is."""
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        if device.type == "cuda":
            leaf = leaf.pin_memory()
    if not isinstance(leaf, torch.Tensor) or resident(leaf, device):
        return leaf
    return leaf.to(device, non_blocking=True)


def _arrived(leaf, target) -> bool:
    """True when ``leaf`` already lies where ``target`` (a device, or a
    ``NamedSharding``) would put it."""
    if isinstance(target, NamedSharding):
        return isinstance(leaf, Placed) and leaf.sharding == target
    return isinstance(leaf, torch.Tensor) and resident(leaf, target)


def _place(leaf, target):
    """One leaf where a hop or put sends it: ``target`` a device (the
    lead card: a tensor or host array uploaded, a ``Placed`` gathered
    whole) or a ``NamedSharding`` (a tensor or host array placed over
    its mesh, a ``Placed`` resharded); a leaf already there, or text
    and numbers, as it is."""
    if not isinstance(target, NamedSharding) \
            and not device_rule.is_local(target):
        raise ValueError(f"{target} belongs to another process: a value "
                         f"is placed there by that process")
    if _arrived(leaf, target):
        return leaf
    if isinstance(leaf, Placed):
        return leaf.reshard(target) if isinstance(target, NamedSharding) \
            else leaf.gather(target)
    if not isinstance(target, NamedSharding):
        return _upload(leaf, target)
    if isinstance(leaf, (torch.Tensor, np.ndarray)):
        return target.put(leaf)
    return leaf


def tree_device_put(tree, plan: MeshPlan, spec=None):
    """Put every array leaf of a swag/pytree on ``plan``: on its lead
    card, or with ``spec`` over its mesh (each leaf a ``Placed``)."""
    target = plan.shard(spec) if spec is not None else plan.replicated()
    return pytree.tree_map(lambda leaf: _place(leaf, target), tree)


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


# ---------------------------------------------------------------------------
# TPU element base class.

# Sentinel for TPUElement's not-yet-computed placement-stage cache
# (None is a valid resolved value: "unplaced").
_UNRESOLVED = object()


class TPUElement(PipelineElement):
    """PipelineElement hosting compiled computation on a device mesh
    (the name is the JAX package's: the engine and the residency lint
    rule key off it).

    Placement resolves from the ``placement`` parameter: ``"local"``
    (all local devices, default), a mesh request like
    ``{"dp": 2, "tp": 4}``, or a stage name previously assigned on the
    pipeline's StagePlacement.  Subclasses use ``self.jit`` for
    shape-keyed compiled caches (captured CUDA graphs on the card),
    ``self.put`` to place values and ``self.plan.device`` for the device
    their tensors live on.

    TPU elements are ``device_resident``: outputs may stay un-synced
    tensors (the engine only syncs at sinks / the bounded dispatch
    window), and event-loop execution runs under the pipeline's
    transfer guard (pipeline/overlap.py).
    """

    device_resident = True

    def __init__(self, context):
        super().__init__(context)
        self._plan: MeshPlan | None = None
        self._replica_plan_cache: dict = {}
        self._stage_name_cache = _UNRESOLVED
        self.jit_cache = JitCache()
        self.bucketer = ShapeBucketer()

    @property
    def plan(self) -> MeshPlan:
        # Replicated stages (ISSUE 7): while a stage worker executes
        # this element for a specific replica, ``self.plan`` IS that
        # replica's submesh -- an element-side put/shard lands on the
        # replica's chips, never on a peer's (or a dead slot's).  The
        # cache keys on the placement's replica_epoch so a
        # drop/reassign invalidates it without a full on_replacement.
        pipeline = self.pipeline
        placements = getattr(pipeline, "stage_placement", None)
        current = getattr(pipeline, "current_replica", None)
        context = current() if callable(current) else None
        if context is not None and placements is not None:
            stage, index = context
            if stage in placements.replica_plans \
                    and self._placement_stage() == stage:
                key = (stage, index, placements.generation,
                       placements.replica_epoch)
                plan = self._replica_plan_cache.get(key)
                if plan is None:
                    plan = placements.replica_plan(stage, index)
                    self._replica_plan_cache = {key: plan}
                return plan
        if self._plan is None:
            self._plan = self._resolve_placement()
        return self._plan

    def _placement_stage(self) -> str | None:
        """The placed-stage name this element's placement resolves to
        (None when unplaced) -- same lookup order as
        ``_resolve_placement``.  Cached: ``self.plan`` consults it on
        every access in the replica worker hot path, and the binding is
        structural (definition placement block / parameter), not
        per-frame.  Cleared by ``on_replacement``."""
        if self._stage_name_cache is not _UNRESOLVED:
            return self._stage_name_cache
        placements = getattr(self.pipeline, "stage_placement", None)
        if placements is None:
            return None                 # no placement yet: don't cache
        placement, _ = self.get_parameter("placement", "local")
        name = None
        for key in (placement, self.name):
            if isinstance(key, str) and (
                    key in placements.plans
                    or key in placements.replica_plans):
                name = key
                break
        self._stage_name_cache = name
        return name

    def _resolve_placement(self) -> MeshPlan:
        placement, _ = self.get_parameter("placement", "local")
        placements = getattr(self.pipeline, "stage_placement", None)
        if placements is not None:
            # A definition ``placement`` block registers the stage under
            # the element's own node name; the ``placement`` parameter
            # may also name another stage explicitly (shared submesh).
            for key in (placement, self.name):
                if isinstance(key, str) and key in placements.plans:
                    return placements.plan(key)
        # Device pool: the StagePlacement's (which excludes chips removed
        # by replace()) when one exists, else all local devices -- a
        # default-placed element must never re-resolve onto a dead chip.
        pool = list(placements.devices) if placements is not None \
            else device_rule.local_devices()
        if isinstance(placement, dict):
            axes = dict(placement)
            sizes = list(axes.values())
            if -1 not in sizes and int(np.prod(sizes)) <= len(pool):
                return MeshPlan(make_mesh(axes,
                                          pool[:int(np.prod(sizes))]))
            return MeshPlan(make_mesh(axes, pool))
        return MeshPlan(make_mesh({"dp": len(pool)}, pool))

    def jit(self, fn: Callable) -> Callable:
        """Shape-keyed compiled cache for this element."""
        return self.jit_cache(fn)

    def on_replacement(self):
        """Devices were re-placed under this element (device failure ->
        ``StagePlacement.replace``): drop the cached plan and captured
        graphs so the next frame resolves the new submesh and captures
        there.  Model-hosting subclasses also drop their resident
        weights, which rebuild lazily."""
        self._plan = None
        self._replica_plan_cache = {}
        self._stage_name_cache = _UNRESOLVED
        self.jit_cache = JitCache()

    def put(self, value, *spec):
        """Place a tensor, host array (or pytree of them) on this
        element's lead card, or with ``spec`` over its mesh (each leaf
        a ``Placed``: ``put(params, P())`` holds the weights once on
        every card of the stage); a host array goes through pinned
        memory on the card."""
        target = self.plan.shard(*spec) if spec else self.plan.replicated()
        return pytree.tree_map(lambda leaf: _place(leaf, target), value)

    def metrics(self) -> dict:
        return {"jit": self.jit_cache.stats,
                "mesh": dict(self.plan.mesh.shape)}
