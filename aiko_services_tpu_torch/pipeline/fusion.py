"""Fused device-segment execution: one captured CUDA graph per pipeline
segment.

Counterpart of ``aiko_services_tpu/pipeline/fusion.py``, which traces a
maximal chain of device-pure elements (each declaring a
:class:`DeviceFn`) into ONE jitted XLA computation per frame.  The port
keeps the partitioner and the element contract exactly
(:data:`FUSE_MODES`, :class:`FusionError`, :class:`DeviceFn`,
:func:`fusable`, :func:`qualified_reads`, :func:`partition`).  Its
:class:`FusedSegment` runs every member's ``device_fn`` in ONE function
cached per input signature by :class:`~.tensor.JitCache`: on the card
the first frame of a signature captures the whole chain as one CUDA
graph and every later frame replays it -- one launch per frame -- and
on the CPU the chain runs eagerly.  The differences:

- a segment runs on ONE device: its stage plan's when the chain lies in
  a placed stage, else the one device its members resolve to (a
  ``TPUElement``'s plan, any other element's ``device`` parameter under
  the port's device rule); members on different devices raise
  :class:`FusionError` at build;
- a host read (the frame's numpy image) is uploaded to that device
  through pinned memory before the call, as ``jax.jit`` moves its
  arguments; ``would_compile`` keys the call as it will be made, after
  the upload;
- nothing is donated (``donation`` is False on every device): a replay
  copies its inputs into the graph's own static buffers, so no input
  buffer is ever handed to the segment's outputs.  ``donate_keys``
  keeps the JAX package's planning for a segment that sets it.

:func:`setup_compilation_cache` keeps the JAX package's gate
(``AIKO_COMPILE_CACHE_DIR``, else the ``compile_cache_dir`` pipeline
parameter): a directory given there becomes the directory of the
port's kernel builds (``ops/_build.py``), the port's counterpart of a
persistent compile cache.

The ``fuse`` pipeline/stream parameter gates the whole path:
``auto`` (default) fuses where legal, ``off`` always walks per-element.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .element import PipelineElement, PipelineElementLoop
from .tensor import JitCache, LeafSignature, TPUElement, _upload, resident
from ..device import resolve_device
from ..observability import LogHistogram
from ..utils import get_logger

__all__ = ["DeviceFn", "FusedSegment", "FusionError", "partition",
           "fusable", "qualified_reads", "setup_compilation_cache",
           "FUSE_MODES"]

_logger = get_logger("aiko.fusion")

FUSE_MODES = ("auto", "off")


class FusionError(RuntimeError):
    """Segment build/trace failure -- the engine falls back to unfused
    per-element execution and poisons the segment."""


@dataclasses.dataclass(frozen=True)
class DeviceFn:
    """Element-author contract for a fusable pure device computation.

    ``fn(**inputs, **captures) -> dict`` must be traceable under
    ``jax.jit`` with NO host side effects: no ``device_get``/``float()``
    syncs, no IO, no control-flow StreamEvents -- fused execution always
    maps the returned values out as OKAY.  ``inputs`` are the element
    definition input names the trace consumes (anything else the
    definition declares is routed around the trace); ``captures`` are
    extra device-resident values (weights) fed to the trace as real
    arguments -- never closed over, so they are not baked into the
    executable as constants and never donated.

    ``outputs`` are the returned keys written to the swag as
    device-resident element outputs.  Declared element outputs that are
    neither in ``outputs`` nor ``finalize_outputs`` must name an
    identically-named input: the engine passes the (possibly host-side)
    value through OUTSIDE the trace, preserving its type -- e.g.
    ``sample_rate`` riding through AudioFFT as a plain int.

    ``finalize(fetched) -> dict`` is an optional host step at segment
    map-out: the engine fetches ``finalize_inputs`` (returned trace
    values) with ONE counted ``TransferLedger.fetch`` and the callback
    builds the element's host-side outputs (``finalize_outputs``), e.g.
    the Detector's overlay/detections from its device slate.

    The purity half of this contract is statically enforced: the
    ``device-fn-host-call`` lint rule (analysis/residency.py) AST-scans
    every ``device_fn`` trace body at ``pipeline create``, so a host
    sync that would poison the fused segment on first trace is rejected
    before any frame is dispatched.
    """

    fn: Callable
    inputs: tuple = ()
    outputs: tuple = ()
    captures: dict = dataclasses.field(default_factory=dict)
    finalize: Callable | None = None
    finalize_inputs: tuple = ()
    finalize_outputs: tuple = ()


class _Step:
    """One element's slot inside a fused segment (planning product)."""

    __slots__ = ("node", "dfn", "in_keys", "pass_map")

    def __init__(self, node, dfn: DeviceFn):
        self.node = node
        self.dfn = dfn
        self.in_keys: dict[str, str] = {}     # fn input -> values key
        self.pass_map: dict[str, tuple] = {}  # out -> ("trace"|"ext", key)


def fusable(pipeline, node, stream) -> DeviceFn | None:
    """The partitioner's membership test; returns the element's
    DeviceFn when ``node`` may join a fused segment for ``stream``."""
    element = node.element
    if not isinstance(element, PipelineElement) \
            or not element.device_resident:
        return None
    if isinstance(element, PipelineElementLoop):
        return None                   # control flow re-enters the path
    if element.host_inputs:
        return None                   # wire sink: host materialization
    definition = element.definition
    if definition is None:
        return None
    declared_in = {io["name"]: io for io in definition.input}
    for io in definition.input:
        if str(io.get("type", "")).rstrip("?") == "host":
            return None               # host-typed input: sink boundary
    if element.frame_is_async(stream):
        return None                   # MicroBatcher / async park boundary
    placement = getattr(pipeline, "stage_placement", None)
    if placement is not None and node.name in placement.plans:
        return None                   # stage hop (ICI reshard) boundary
    try:
        dfn = element.device_fn(stream)
    except Exception:
        _logger.exception("%s: device_fn raised; not fusing", node.name)
        return None
    if dfn is None:
        return None
    if not set(dfn.inputs) <= set(declared_in):
        _logger.warning("%s: device_fn inputs %s not all declared; "
                        "not fusing", node.name, dfn.inputs)
        return None
    declared_out = [io["name"] for io in definition.output]
    for name in declared_out:
        if name in dfn.outputs or name in dfn.finalize_outputs:
            continue
        if name not in declared_in:   # passthrough needs a same-named in
            _logger.warning("%s: output %r neither computed nor "
                            "passthrough; not fusing", node.name, name)
            return None
    if set(dfn.captures) & set(dfn.inputs):
        _logger.warning("%s: capture names collide with inputs; "
                        "not fusing", node.name)
        return None
    return dfn


def qualified_reads(graph) -> frozenset:
    """Every producer-qualified (``El.name``-dotted) swag key any node's
    input mapping can read.  Donating a buffer whose qualified alias
    appears here would hand a later consumer a dead buffer, so such
    keys are never donated."""
    reads = set()
    for node in graph.nodes():
        for value in (node.properties or {}).values():
            if isinstance(value, str) and "." in value:
                reads.add(value)
    return frozenset(reads)


def partition(pipeline, nodes, stream) -> list:
    """Group maximal chains of fusable nodes (length >= 2) into
    FusedSegments; everything else stays a plain Node.  A node consuming
    a host value a finalize produced earlier in the chain starts a new
    chain -- device traces cannot read host-step products.

    Placed stage heads are partition boundaries (``fusable`` rejects
    them: the ICI hop + stage admission happen per-node), so segments
    are always STAGE-LOCAL; each segment records the placed stage it
    executes inside (``FusedSegment.stage_context`` -- the most recent
    placed head on the walk), which is what lets the engine run it on
    that stage's worker thread and attribute its dispatches to the
    stage.

    Segments are memoized per stream by their member-name tuple
    (``stream.fusion_segments``), so the full-path plan and the
    post-async resume suffix plans share one compiled segment instead
    of re-tracing the same chain per plan."""
    entries: list = []
    chain: list[tuple] = []
    chain_stage: list = [None]      # stage context when the chain began
    host_names: set[str] = set()
    cache = stream.fusion_segments
    placement = getattr(pipeline, "stage_placement", None)
    placed = set(placement.plans) if placement is not None else set()
    stage_context = None

    def flush():
        if len(chain) >= 2:
            key = tuple(node.name for node, _ in chain)
            segment = cache.get(key)
            if segment is None:
                segment = FusedSegment(pipeline,
                                       [n for n, _ in chain],
                                       [d for _, d in chain],
                                       stream_id=stream.stream_id,
                                       stage=chain_stage[0])
                cache[key] = segment
                pipeline.fused_segments.append(segment)
            entries.append(segment)
        else:
            entries.extend(n for n, _ in chain)
        chain.clear()
        host_names.clear()

    for node in nodes:
        if node.name in placed:
            stage_context = node.name
        dfn = fusable(pipeline, node, stream)
        if dfn is None:
            flush()
            entries.append(node)
            continue
        mapping = node.properties or {}
        consumed = {mapping.get(name, name) for name in dfn.inputs}
        if consumed & host_names:
            flush()
        if not chain:
            chain_stage[0] = stage_context
        chain.append((node, dfn))
        for out in dfn.finalize_outputs:
            host_names.add(out)
            host_names.add(f"{node.name}.{out}")
    flush()
    return entries


@functools.lru_cache(maxsize=None)
def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _normal(device: torch.device) -> torch.device:
    """One spelling per device: a CPU descriptor's index is dropped (a
    CPU tensor carries none) and a card gets its index."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.device("cpu")
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _member_device(node) -> torch.device:
    """Where a member's ``device_fn`` computes: a placed element's plan,
    else its ``device`` parameter under the port's device rule."""
    element = node.element
    if isinstance(element, TPUElement):
        return _normal(element.plan.device)
    device, _ = element.get_parameter("device", None)
    return _normal(resolve_device(device))


class FusedSegment:
    """A maximal chain of device-pure elements run as ONE captured CUDA
    graph per frame (eagerly on the CPU)."""

    def __init__(self, pipeline, nodes, device_fns, stream_id=None,
                 stage=None):
        self.nodes = list(nodes)
        self.name = "+".join(node.name for node in nodes)
        # Segments resolve element parameters per stream (shapes,
        # width/height, synchronous) so they are stream-owned; the
        # pipeline registry prunes them when the stream dies.
        self.stream_id = stream_id
        # The placed stage whose submesh this segment's chain executes
        # on (None when the chain precedes any placed head): segments
        # are always stage-local, and a stage-tagged segment may run on
        # that stage's worker thread under stage-parallel execution.
        self.stage_context = stage
        self._placement = getattr(pipeline, "stage_placement", None) \
            if stage is not None else None
        self.device = self._resolve_device()
        self.steps: list[_Step] = []
        self.broken = False           # build/capture failed: run unfused
        self.calls = 0
        # No donation on any device: a replay copies its inputs into the
        # graph's static buffers, so there is no input buffer to hand to
        # an output (the reference donates off-CPU to save HBM).
        self.donation = False
        self.jit_cache = JitCache()
        # Qualified aliases any graph node's mapping may read: their
        # referents must never be donated (the consumer would see a
        # dead buffer after the stale-alias pop).
        self._qualified_reads = qualified_reads(pipeline.graph)
        self._reads: dict[str, dict] = {}     # swag key -> io spec
        self._traced_keys: set[str] = set()   # reads fed into the trace
        self._captures: dict[str, object] = {}
        self.overwritten: set[str] = set()    # bare swag keys we rewrite
        self._plan(device_fns)
        # One pinned binding: the JitCache keys on id(fn), and a fresh
        # bound-method object per access would never probe as a hit.
        self._traced_fn = self._traced
        self._call = self.jit_cache(self._traced_fn)
        # Per-dispatch wall time (telemetry plane): dispatch-cost
        # percentiles per segment.  LogHistogram itself is not
        # thread-safe (it normally sits behind MetricsRegistry's
        # lock); calls may come from the event loop OR a stage worker
        # while jit_stats() reads from the loop, so guard it here.
        self.dispatch_ms = LogHistogram()
        self._dispatch_lock = threading.Lock()

    def _resolve_device(self) -> torch.device:
        if self._placement is not None \
                and self.stage_context in self._placement.plans:
            return _normal(self._placement.plan(self.stage_context).device)
        devices = {node.name: _member_device(node) for node in self.nodes}
        if len(set(devices.values())) > 1:
            named = ", ".join(f"{name} on {device}"
                              for name, device in devices.items())
            raise FusionError(f"segment {self.name}: members on different "
                              f"devices ({named}); a segment runs on one "
                              f"device")
        return next(iter(devices.values()))

    def _device_for(self, replica: int | None) -> torch.device:
        """A replicated stage's replica runs on its own submesh."""
        if replica is None or self._placement is None:
            return self.device
        return _normal(self._placement.replica_plan(
            self.stage_context, replica).device)

    # -- planning ----------------------------------------------------------

    def _plan(self, device_fns):
        # name -> ("trace", key) | ("ext", swag key) | ("host",) for
        # every value a later in-segment consumer could resolve.
        internal: dict[str, tuple] = {}
        for node, dfn in zip(self.nodes, device_fns):
            step = _Step(node, dfn)
            mapping = node.properties or {}
            declared_in = {io["name"]: io for io in
                           node.element.definition.input}
            for name in dfn.inputs:
                key = mapping.get(name, name)
                known = internal.get(key)
                if known is None:
                    step.in_keys[name] = key
                    self._reads.setdefault(key, declared_in[name])
                    self._traced_keys.add(key)
                elif known[0] == "trace":
                    step.in_keys[name] = known[1]
                elif known[0] == "ext":
                    step.in_keys[name] = known[1]
                    self._traced_keys.add(known[1])
                else:                 # host: partition() prevents this
                    raise FusionError(
                        f"{node.name}: input {name!r} is a host "
                        f"finalize product")
            for cap_name, value in dfn.captures.items():
                self._captures[f"{node.name}.__{cap_name}"] = value
            for name in dfn.outputs:
                trace_key = f"{node.name}.{name}"
                internal[name] = ("trace", trace_key)
                internal[trace_key] = ("trace", trace_key)
                self.overwritten.add(name)
            for name in dfn.finalize_outputs:
                internal[name] = ("host",)
                internal[f"{node.name}.{name}"] = ("host",)
                self.overwritten.add(name)
            for io in node.element.definition.output:
                name = io["name"]
                if name in dfn.outputs or name in dfn.finalize_outputs:
                    continue
                key = mapping.get(name, name)   # passthrough source
                known = internal.get(key)
                if known is not None and known[0] == "trace":
                    step.pass_map[name] = ("trace", known[1])
                    internal[name] = known
                else:
                    step.pass_map[name] = ("ext", key)
                    self._reads.setdefault(key, declared_in.get(
                        name, {"name": name, "type": "any?"}))
                    internal[name] = ("ext", key)
                self.overwritten.add(name)
            self.steps.append(step)

    # -- the fused computation ---------------------------------------------

    def _traced(self, keep, donate, captures):
        values = dict(keep)
        values.update(donate)
        values.update(captures)
        out = {}
        for step in self.steps:
            inputs = {name: values[key]
                      for name, key in step.in_keys.items()}
            inputs.update({name: values[f"{step.node.name}.__{name}"]
                           for name in step.dfn.captures})
            result = step.dfn.fn(**inputs)
            for name in step.dfn.outputs:
                value = result[name]
                trace_key = f"{step.node.name}.{name}"
                values[name] = value
                values[trace_key] = value
                out[trace_key] = value
            for name in step.dfn.finalize_inputs:
                out[f"{step.node.name}.{name}"] = result[name]
        return out

    # -- per-frame execution -----------------------------------------------

    def resolve(self, swag: dict) -> tuple[dict, list]:
        """(resolved external reads, missing non-optional keys)."""
        resolved, missing = {}, []
        for key, io in self._reads.items():
            if key in swag:
                resolved[key] = swag[key]
            elif str(io.get("type", "")).endswith("?") or "default" in io:
                resolved[key] = io.get("default")
            else:
                missing.append(key)
        return resolved, missing

    def donate_keys(self, resolved: dict, swag: dict,
                    produced: dict) -> set:
        """Traced inputs safe to donate: produced by an earlier element
        of THIS frame (never user/ingest data), overwritten by this
        segment (the swag key points at a fresh buffer afterwards), not
        aliased by any other swag entry, and whose producer-qualified
        alias no graph mapping can read after the segment.  Empty
        unless ``donation`` is set (never by the port itself)."""
        if not self.donation:
            return set()
        keys = set()
        for key in self._traced_keys:
            if key not in resolved or key not in produced \
                    or key not in self.overwritten:
                continue
            value = resolved[key]
            if not isinstance(value, torch.Tensor):
                continue
            alias = f"{produced[key]}.{key}"
            if alias in self._qualified_reads:
                continue            # a downstream mapping reads it
            if any(entry is value for name, entry in swag.items()
                   if name not in (key, alias)):
                continue
            keys.add(key)
        return keys

    def _split(self, resolved: dict, donated: set) -> tuple[dict, dict]:
        keep = {key: resolved[key] for key in self._traced_keys
                if key not in donated}
        donate = {key: resolved[key] for key in donated}
        return keep, donate

    @staticmethod
    def _staged(tree, device: torch.device, probe: bool = False):
        """Every array leaf as the call sees it: a host array uploaded
        to ``device`` (through pinned memory on the card), a tensor
        elsewhere moved there.  ``probe`` gives the leaves' signatures
        instead and moves nothing."""
        def leaf(value):
            if isinstance(value, np.ndarray):
                if probe:
                    return LeafSignature(value.shape,
                                         _torch_dtype(value.dtype), device)
                return _upload(value, device)
            if isinstance(value, torch.Tensor) \
                    and not resident(value, device):
                if probe:
                    return LeafSignature(value.shape, value.dtype, device)
                return value.to(device, non_blocking=True)
            return value
        return pytree.tree_map(leaf, tree)

    def would_compile(self, resolved: dict, donated: set,
                      replica: int | None = None) -> bool:
        device = self._device_for(replica)
        keep, donate = self._split(resolved, donated)
        return self.jit_cache.probe(
            self._traced_fn, (self._staged(keep, device, probe=True),
                              self._staged(donate, device, probe=True),
                              self._captures),
            context=replica)

    def poison(self, reason: str) -> None:
        """Mark this segment broken: the cached plan splices its members
        back in on the next walk and every later frame runs per-element
        (capture failure, injected segment fault)."""
        self.broken = True
        _logger.warning("segment %s poisoned: %s", self.name, reason)

    def call(self, resolved: dict, donated: set,
             replica: int | None = None) -> dict:
        """ONE device dispatch for the whole segment (one graph replay
        on the card, after the upload of its host reads).  Returns the
        trace outputs dict keyed ``element.name``.

        ``replica`` keys the segment's JitCache per replica submesh of
        a replicated stage: each replica's graph reads its own
        device's buffers, so replica A's warm signature is still a
        cold capture on replica B -- the cache context keeps hit/miss
        and the compile probe honest per replica."""
        device = self._device_for(replica)
        keep, donate = self._split(resolved, donated)
        self.calls += 1
        start = time.perf_counter()
        try:
            return self._call(self._staged(keep, device),
                              self._staged(donate, device),
                              self._captures, _cache_context=replica)
        finally:
            elapsed_ms = (time.perf_counter() - start) * 1000.0
            with self._dispatch_lock:
                self.dispatch_ms.observe(elapsed_ms)

    @property
    def stats(self) -> dict:
        with self._dispatch_lock:
            dispatch_p50 = self.dispatch_ms.quantile(0.5,
                                                     windowed=False)
            dispatch_p99 = self.dispatch_ms.quantile(0.99,
                                                     windowed=False)
        return {"elements": [node.name for node in self.nodes],
                "calls": self.calls, "broken": self.broken,
                "donation": self.donation, "stage": self.stage_context,
                "dispatch_p50_ms": dispatch_p50,
                "dispatch_p99_ms": dispatch_p99,
                "jit": self.jit_cache.stats}

    def __repr__(self):
        return f"<FusedSegment {self.name}>"


# ---------------------------------------------------------------------------
# Kernel build directory (env-gated, wired at Pipeline startup).

_CACHE_DIR_CONFIGURED: str | None = None


def setup_compilation_cache(parameters: dict | None = None) -> str | None:
    """Point the port's kernel builds (``ops/_build.py`` ``BUILD_DIR``)
    at a directory that outlives the process, so a restart loads the
    built kernels instead of running ``nvcc`` again.

    Gated: the ``AIKO_COMPILE_CACHE_DIR`` environment variable wins,
    else the ``compile_cache_dir`` pipeline parameter; absent both,
    nothing is configured.  Returns the directory in effect (idempotent
    across Pipelines -- the first configured directory stays; the build
    directory is process-global)."""
    global _CACHE_DIR_CONFIGURED
    path = os.environ.get("AIKO_COMPILE_CACHE_DIR") \
        or (parameters or {}).get("compile_cache_dir")
    if not path:
        return _CACHE_DIR_CONFIGURED
    path = str(path)
    if _CACHE_DIR_CONFIGURED is not None:
        if path != _CACHE_DIR_CONFIGURED:
            _logger.warning(
                "kernel build directory already at %s; ignoring %s "
                "(it is process-global)", _CACHE_DIR_CONFIGURED, path)
        return _CACHE_DIR_CONFIGURED
    os.makedirs(path, exist_ok=True)
    from ..ops import _build
    _build.BUILD_DIR = Path(path)
    _CACHE_DIR_CONFIGURED = path
    _logger.info("kernel build directory -> %s", path)
    return path
