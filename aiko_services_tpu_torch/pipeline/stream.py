"""Streams and Frames (reference: src/aiko_services/main/stream.py).

A Stream is a long-lived flow of Frames through a pipeline graph path; a
Frame is one unit of work: its ``swag`` accumulates every element's outputs
as the frame walks the graph (reference stream.py:71-126).  ``swag`` values
are arbitrary Python objects -- in the TPU data plane they are
``jax.Array``s that stay resident in HBM between elements.

Unlike the reference (which shares one mutable swag across threads and has
documented frame-id races, reference pipeline.py:1239-1260), frames here
are owned by exactly one event-loop task at a time: generators hand frames
over by message, never by shared mutation.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any

from .overlap import DEVICE_INFLIGHT_DEFAULT, DeviceWindow

__all__ = ["StreamEvent", "StreamState", "Frame", "Stream",
           "DEFAULT_STREAM_ID", "FIRST_FRAME_ID"]

DEFAULT_STREAM_ID = "0"
FIRST_FRAME_ID = 0


class StreamEvent(enum.Enum):
    """Returned by every element's process_frame (reference
    stream.py:35-52)."""
    OKAY = "okay"              # continue through the graph
    DROP_FRAME = "drop_frame"  # silently stop processing this frame
    ERROR = "error"            # abort frame, stream enters ERROR
    NO_FRAME = "no_frame"      # source has nothing yet (generators only)
    STOP = "stop"              # graceful stream stop after this frame
    LOOP_END = "loop_end"      # Loop element: exit the loop body


class StreamState(enum.Enum):
    START = "start"
    RUN = "run"
    STOP = "stop"
    ERROR = "error"


@dataclass
class Frame:
    frame_id: int
    swag: dict = field(default_factory=dict)
    # LOOP-CONFINED (audited, PR 4): every write happens on the
    # pipeline's event loop -- stage workers and async elements hand
    # timings back through mailbox continuations, never by mutating
    # this dict from their own threads.  The telemetry plane reads it
    # at frame completion on the loop, and responses carry a SNAPSHOT
    # (Pipeline._respond) so queue consumers on other threads never
    # share the live mapping.
    metrics: dict = field(default_factory=dict)
    paused_pe_name: str | None = None    # set while parked at a remote stage
    response_topic: str | None = None    # where process_frame_response goes
    created: float = field(default_factory=time.monotonic)
    # Stage-parallel execution (pipeline/stages.py): the placed stage
    # this frame currently holds an admission credit for, and the
    # StagePlacement generation it was admitted under (a replace() bump
    # between admissions means the frame re-enters on fresh submeshes).
    stage: str | None = None
    stage_generation: int = 0
    # Replicated stages (ISSUE 7): which replica submesh of ``stage``
    # this frame's admission landed on (None for unreplicated stages).
    # The hop transfer, the worker pick and the element's ``self.plan``
    # all key off it; a replica failover replays exactly the frames
    # whose (stage, stage_replica) matches the dead slot.
    stage_replica: int | None = None
    # The stage this frame is QUEUED for (admission denied, waiting for
    # a credit).  Popped waiter tokens are validated against it: a
    # stale token from a destroyed stream must never admit a recreated
    # stream's same-id frame mid-pipeline.
    stage_waiting: str | None = None
    # Undiscovered-remote-stage retries (exponential backoff): how many
    # times this frame has re-posted waiting for discovery.
    remote_retries: int = 0
    # In-order per-stream delivery: ingest-order sequence assigned when
    # stage-parallel execution is active (None -> respond immediately).
    delivery_seq: int | None = None
    # Provenance: bare swag key -> producer element name, for every
    # value an element of THIS frame wrote.  Fused segments consult it
    # before donating a buffer -- ingest/user data is never donatable
    # (the caller may still hold the array, e.g. a device-resident
    # image ring).
    produced: dict = field(default_factory=dict)
    # Distributed frame tracing (observability/): trace_id + root span
    # minted at ingest (or adopted from the forwarding process when the
    # frame arrived over a RemoteStage hop -- trace_remote marks that
    # this process must return its spans in the response).  ``spans``
    # collects completed span dicts; like ``metrics`` it is
    # LOOP-CONFINED: only the pipeline's event loop writes it (stage
    # workers post continuations; hooks fire on the resumed turn).
    trace_id: str | None = None
    trace_parent: str | None = None
    trace_root: str | None = None
    trace_remote: bool = False
    trace_start: float = 0.0
    trace_done: bool = False
    spans: list = field(default_factory=list)
    # Perf stamp set when the frame starts waiting for a placed stage's
    # admission credit; cleared into ``metrics["stage_<s>_wait_ms"]``
    # when the admission lands.
    stage_wait_start: float | None = None
    # Open remote-hop span while parked at a RemoteStage:
    # (node_name, span_id, wall start).
    remote_span: tuple | None = None
    # Failure recovery (ISSUE 5): the frame's absolute deadline
    # (monotonic seconds, None = no deadline), how many times it has
    # been replayed across a device replacement, and the replay epoch
    # -- bumped on every replay so in-flight stage-worker/async
    # completions from the PREVIOUS attempt read as stale when their
    # continuation posts land.
    deadline: float | None = None
    replays: int = 0
    replay_epoch: int = 0
    # Binary data plane (ISSUE 9): the FORWARDING process's tensor-pipe
    # endpoint ("host:port"), carried in the process_frame header so
    # this process can ship the response's tensors back over the pipe
    # instead of base64'ing them onto the control fabric.  None = the
    # origin advertises no pipe; the response rides MQTT whole.
    pipe_reply: str | None = None
    # Elements whose outputs this frame has accepted (map-out ran):
    # the replay frontier.  A replayed frame resumes at the first path
    # node NOT in here -- everything before it is host-visible in the
    # swag and must not re-execute.
    completed: set = field(default_factory=set)
    # Unified QoS admission (ISSUE 12, gateway/qos.py): tenant + class
    # resolved from the stream at ingest, the global ingest sequence
    # (the rank tiebreak that preserves arrival order within a class),
    # when the frame last started WAITING at an admission seam (aging
    # input), whether the near-deadline promotion already fired (it is
    # counted once), and whether the QosScheduler's in-flight
    # accounting is open for this frame (closed exactly once on any
    # completion path).
    tenant: str | None = None
    qos_class: str | None = None
    qos_seq: int = 0
    qos_wait_start: float | None = None
    qos_promoted: bool = False
    qos_open: bool = False


@dataclass
class Stream:
    stream_id: str
    graph_path: str | None = None
    parameters: dict = field(default_factory=dict)
    variables: dict = field(default_factory=dict)
    state: StreamState = StreamState.START
    frames: dict = field(default_factory=dict)      # frame_id -> Frame
    frame_count: int = 0                            # next frame id
    topic_response: str | None = None
    queue_response: Any = None                      # local queue.Queue
    lease: Any = None
    generator_handles: list = field(default_factory=list)
    last_frame_time: float = field(default_factory=time.monotonic)
    # Bounded async-dispatch window: completed frames whose device work
    # may still be computing (jitted elements return un-synced arrays).
    # Paced at ingest so dispatch stays at most ``device_inflight``
    # frames ahead of compute (pipeline/overlap.py).
    device_window: DeviceWindow = field(default_factory=DeviceWindow)
    device_inflight: int = DEVICE_INFLIGHT_DEFAULT
    # Fused device-segment compilation (pipeline/fusion.py): ``fuse``
    # is the resolved ``auto|off`` mode; ``fusion_plans`` memoizes the
    # partition of each execution path (keyed by its node-name tuple)
    # so the fuse decision is made once per stream, not per frame, and
    # ``fusion_segments`` dedupes the segments themselves across plans
    # (the full path and post-async resume suffixes share one compiled
    # segment per member chain).
    fuse: str = "auto"
    fusion_plans: dict = field(default_factory=dict)
    fusion_segments: dict = field(default_factory=dict)
    # In-order per-stream delivery under stage-parallel execution
    # (pipeline/stages.py): frames respond in ingest order even though
    # they complete stage-pipelined.  ``delivery_count`` hands out
    # sequence numbers at ingest; ``delivery_next``/``delivery_pending``
    # form the reorder buffer drained by ``Pipeline._deliver``.
    delivery_count: int = 0
    delivery_next: int = 0
    delivery_pending: dict = field(default_factory=dict)
    # Failure recovery (ISSUE 5), resolved once at stream creation:
    # ``frame_deadline_ms`` (0 = none) stamps every ingested frame's
    # deadline; ``overload_policy``/``overload_limit`` bound the
    # stream's in-flight queue depth for live streams --
    # ``shed_oldest`` cancels the oldest admission-queued frame,
    # ``shed_newest`` refuses the incoming one, ``block`` (default)
    # keeps the pre-existing backpressure-only behavior.
    deadline_ms: float = 0.0
    overload_policy: str = "block"
    overload_limit: int = 0
    # Unified QoS admission (ISSUE 12): the stream's tenant identity
    # and priority class, resolved once at creation (gateway sessions
    # set them via stream parameters; CLI/local streams default to
    # the default tenant's class).  Every frame of a stream inherits
    # them, which is what makes priority reorder across streams but
    # never within one.
    tenant: str = "default"
    qos_class: str = "standard"
    # Durable stream journal (ISSUE 13): whether this stream's
    # recoverable state is journaled (resolved once at creation from
    # the pipeline's ``journal`` parameter; a stream-level
    # ``journal: off`` opts out -- e.g. the gateway's one-shot HTTP
    # streams, which have no session to adopt).
    journal: bool = False

    def next_frame_id(self) -> int:
        frame_id = self.frame_count
        self.frame_count += 1
        return frame_id

    @property
    def in_flight(self) -> int:
        return len(self.frames)
