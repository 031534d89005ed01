"""Fused device segments: the planning half.

Counterpart of ``aiko_services_tpu/pipeline/fusion.py``.  The JAX
package traces a maximal chain of device-pure elements (each declaring
a :class:`DeviceFn`) into ONE jitted XLA computation per frame.  The
port keeps the partitioner and the element contract exactly
(:data:`FUSE_MODES`, :class:`FusionError`, :class:`DeviceFn`,
:func:`fusable`, :func:`qualified_reads`, :func:`partition`); its
:class:`FusedSegment` -- one captured CUDA graph per segment -- is
ROADMAP Queue 1 item 8.  Until then forming a segment raises
:class:`FusionError`, so a fusable chain is never run some other way in
silence.  The ``Detector`` is the one element of the port that declares
a ``device_fn`` (with ``synchronous: true``), and a segment needs two
fusable elements in a row, so no port pipeline forms one yet.

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
import os
from pathlib import Path
from typing import Callable

from .element import PipelineElement, PipelineElementLoop
from ..utils import get_logger, not_ported

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


class FusedSegment:
    """A maximal chain of device-pure elements run as ONE captured CUDA
    graph per frame -- not ported yet: constructing one raises
    :class:`FusionError` (see the module docstring)."""

    def __init__(self, pipeline, nodes, device_fns, stream_id=None,
                 stage=None):
        raise FusionError(str(not_ported(
            "fused segment " + "+".join(node.name for node in nodes),
            "ROADMAP Queue 1 item 8")))


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
