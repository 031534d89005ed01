"""PipelineElement: the unit of dataflow computation (reference:
src/aiko_services/main/pipeline.py:376-673).

An element implements ``process_frame(stream, **inputs) -> (StreamEvent,
outputs_dict)`` plus optional ``start_stream``/``stop_stream`` lifecycle.
Elements do not subclass Actor -- they are plain objects owned by a
Pipeline (which IS an actor); this keeps per-element overhead at a method
call, not a mailbox hop.

Hierarchical parameter resolution (reference pipeline.py:557-595):
stream parameters (``Element.param`` qualified, then bare) -> element
definition parameters -> pipeline share/definition parameters.

Source elements create frames either one-shot (``create_frame``) or from a
generator pumped on a background thread with mailbox-depth backpressure
(``create_frames``, reference pipeline.py:471-551).

TPU extension: ``compile_element(stream)`` is called at start_stream time
so jitted computations warm their caches keyed on the stream's shapes.
"""

from __future__ import annotations

from typing import Any, Callable

from .stream import Stream, StreamEvent
from ..utils import get_logger, parse_bool

__all__ = ["PipelineElement", "PipelineElementLoop", "ElementContext"]

_NOT_FOUND = object()


class ElementContext:
    """Everything an element needs from its host pipeline."""

    __slots__ = ("name", "definition", "pipeline", "parameters")

    def __init__(self, name: str, definition, pipeline, parameters: dict):
        self.name = name
        self.definition = definition
        self.pipeline = pipeline
        self.parameters = parameters


class PipelineElement:
    #: Async-capable elements set this True and implement
    #: ``process_frame_start``; the engine then parks the frame at this
    #: stage and resumes it on completion, so multiple frames are in
    #: flight across stages (detect(k+1) overlaps decode(k)).
    is_async = False

    #: Device-resident swag contract (pipeline/overlap.py): elements
    #: hosting device computation set this True.  Their outputs may (and
    #: should) stay ``jax.Array`` -- un-synced, still computing -- and
    #: the engine runs their event-loop execution under the pipeline's
    #: transfer guard, so an implicit device->host sync inside one is
    #: recorded (policy ``log``) or fails the frame fast (policy
    #: ``disallow``) instead of silently halving throughput.
    device_resident = False

    #: Input names this element always needs materialized on host.  The
    #: engine fetches them all together (ONE counted ``jax.device_get``
    #: per element per frame) before ``process_frame`` -- the
    #: class-level complement of a definition input's
    #: ``"type": "host"``.  Everything else arrives as-is: device
    #: values stay device-resident between device stages.  The
    #: ``undeclared-host-input`` lint rule (analysis/residency.py)
    #: AST-checks ``process_frame`` bodies against this declaration at
    #: ``pipeline create``, so a quiet ``np.asarray(input)`` sync is a
    #: create-time finding instead of a frame-N transfer-guard error.
    host_inputs: tuple = ()

    def __init__(self, context: ElementContext):
        self.context = context
        self.name = context.name
        self.definition = context.definition
        self.pipeline = context.pipeline
        self.logger = get_logger(f"element.{self.name}")

    # -- core API (override) ----------------------------------------------

    def start_stream(self, stream: Stream, stream_id) \
            -> tuple[StreamEvent, dict]:
        return StreamEvent.OKAY, {}

    def process_frame(self, stream: Stream, **inputs) \
            -> tuple[StreamEvent, dict]:
        raise NotImplementedError

    def process_frame_start(self, stream: Stream, complete: Callable,
                            **inputs) -> None:
        """Non-blocking contract for ``is_async`` elements: submit the
        frame's work and return immediately; call
        ``complete(event, outputs)`` exactly once when it finishes (from
        any thread -- the call hops through the pipeline's mailbox).
        The engine parks the frame at this stage and resumes downstream
        elements on completion -- the local analogue of the remote
        park/forward/resume dance, so an accelerator-backed stage never
        serializes the event loop and frames overlap stages."""
        raise NotImplementedError

    def frame_is_async(self, stream: Stream) -> bool:
        """Whether this frame takes the parked/async path.  The
        ``synchronous`` parameter (stream/element/pipeline resolution)
        forces the blocking ``process_frame`` path on async-capable
        elements."""
        if not self.is_async:
            return False
        synchronous, found = self.get_parameter("synchronous", False)
        return not (found and parse_bool(synchronous))

    def stop_stream(self, stream: Stream, stream_id):
        return StreamEvent.OKAY, {}

    def compile_element(self, stream: Stream):
        """Optional: warm jit caches for this stream's shapes."""

    def device_fn(self, stream: Stream):
        """Fused-segment contract (pipeline/fusion.py): return a
        :class:`~.fusion.DeviceFn` describing this element's pure device
        computation, or None (default) when the element cannot fuse.

        Declaring one promises that, for this stream's parameters, the
        element's work is equivalent to ``fn(**inputs, **captures) ->
        outputs dict`` traced under ``jax.jit``: no host syncs, no IO,
        no StreamEvent control flow (fused execution always maps the
        results out as OKAY), and any host-side postprocessing expressed
        as the DeviceFn's ``finalize`` step.  The engine may then splice
        this element into a fused segment -- one XLA dispatch for the
        whole chain -- whenever it sits in a run of device-pure
        elements (no ``host_inputs``, no async/micro-batch park, no
        placement stage hop)."""
        return None

    # -- parameters --------------------------------------------------------

    def get_parameter(self, name: str, default=None,
                      use_pipeline: bool = True):
        """Returns (value, found).  Resolution order: per-replica
        override (the fleet controller's canary-gated version swap,
        ISSUE 20 -- only while a stage worker runs a specific replica)
        -> stream parameters (qualified ``Element.name`` first, then
        bare) -> element definition -> pipeline parameters."""
        replica = self.pipeline.current_replica() \
            if hasattr(self.pipeline, "current_replica") else None
        if replica is not None and replica[0] == self.name:
            value, found = self.pipeline.replica_override(
                self.name, replica[1], name)
            if found:
                return value, True
        stream = self.pipeline.current_stream()
        if stream is not None:
            qualified = f"{self.name}.{name}"
            if qualified in stream.parameters:
                return stream.parameters[qualified], True
            if name in stream.parameters:
                return stream.parameters[name], True
        if name in self.context.parameters:
            return self.context.parameters[name], True
        if use_pipeline:
            value = self.pipeline.get_pipeline_parameter(name, _NOT_FOUND)
            if value is not _NOT_FOUND:
                return value, True
        return default, False

    def set_parameter(self, name: str, value):
        self.context.parameters[name] = value

    # -- frame creation (source elements) ---------------------------------

    def create_frame(self, stream: Stream, frame_data: dict):
        self.pipeline.create_frame_local(stream, frame_data)

    def create_frames(self, stream: Stream,
                      frame_generator: Callable, rate: float | None = None):
        """Pump ``frame_generator(stream, frame_id) -> (StreamEvent,
        frame_data)`` on a background thread with backpressure."""
        self.pipeline.create_frame_generator(stream, self, frame_generator,
                                             rate)

    # -- misc --------------------------------------------------------------

    @property
    def input_names(self) -> list[str]:
        return self.definition.input_names if self.definition else []

    @property
    def output_names(self) -> list[str]:
        return self.definition.output_names if self.definition else []

    def my_id(self) -> str:
        return f"{self.pipeline.name}.{self.name}"

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


class PipelineElementLoop(PipelineElement):
    """Control-flow marker: when its process_frame returns OKAY the
    pipeline jumps back to the ``loop_start`` element and re-runs the loop
    body; returning LOOP_END falls through to the successors (reference
    pipeline.py:1294-1304, elements/control/elements.py:20-57)."""
