"""Pipeline: the dataflow engine (reference: src/aiko_services/main/
pipeline.py -- 2036 LoC; this is the TPU-first redesign, not a port).

A Pipeline is an Actor hosting a DAG of PipelineElements.  Frames enter via
``process_frame`` (wire or local), walk the graph path in deterministic DFS
order accumulating outputs into the frame's ``swag`` (reference
pipeline.py:1267-1360), and responses route to a local queue or a response
topic.  Remote stages -- elements deployed in another pipeline process --
park the frame (``paused_pe_name``), forward the mapped inputs over the
fabric, and resume via ``process_frame_response`` +
``Graph.iterate_after`` (reference pipeline.py:1328-1347,1452-1455).

Differences from the reference, by design:
- single-owner frames on one event loop: no stream lock, no thread-local
  stream context (the reference's documented race area,
  pipeline.py:769-795,1239-1260);
- elements are plain objects in-process (method call, not mailbox hop);
- ``compile_element`` warm-up at stream start for jitted TPU elements;
- frame generators remain background threads (blocking IO) but hand frames
  over by message with mailbox-depth backpressure (reference
  pipeline.py:495-502).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

from .codec import decode_frame_data, encode_frame_data
from .data_plane import (DATA_PLANE_MODES, PIPE_CLAIM_TIMEOUT_MS_DEFAULT,
                         PIPE_TAG, PIPE_TOKEN_CAPACITY_DEFAULT,
                         PipeSender, TensorPipeEndpoint, split_arrays)
from .definition import (PipelineDefinition, parse_pipeline_definition,
                         load_pipeline_definition, DefinitionError,
                         placement_error)
from .element import ElementContext, PipelineElement, PipelineElementLoop
from .fusion import (FUSE_MODES, FusedSegment, partition,
                     setup_compilation_cache)
from .journal import (ADOPT_LIMIT_DEFAULT, DRAIN_TIMEOUT_MS_DEFAULT,
                      JOURNAL_FSYNC_MS_DEFAULT, StreamJournal,
                      claim_adoption, decode_payload, load_journal)
from .overlap import (DEVICE_INFLIGHT_DEFAULT, TransferLedger,
                      touches_devices)
from .stages import (STAGE_INFLIGHT_DEFAULT, STAGE_PIPELINE_MODES,
                     StageScheduler)
from .stream import (Stream, Frame, StreamEvent, StreamState,
                     DEFAULT_STREAM_ID)
from ..observability import (BLACKBOX_LIMIT_DEFAULT,
                             HISTOGRAM_WINDOW_DEFAULT,
                             RECORDER_CAPACITY_DEFAULT,
                             TELEMETRY_INTERVAL_DEFAULT,
                             TRACE_CAPACITY_DEFAULT, FlightRecorder,
                             PipelineTelemetry, aggregate_traces,
                             attribute_events, decode_spans,
                             encode_spans, events_as_dicts, make_span,
                             mint_id, write_blackbox)
from ..analysis.lint import preflight as preflight_check
from ..faults import (CircuitBreaker, FaultInjected, FaultPlan,
                      wire_fault_filter)
from ..gateway.qos import QosScheduler
from ..runtime import Lease
from ..services import (Actor, ServiceFilter, ServiceTags,
                        get_service_proxy, do_discovery)
from ..services.service import SERVICE_PROTOCOL_PREFIX
from ..utils import (Graph, GraphError, get_logger, generate, load_module,
                     parse_number, process_memory_rss)

__all__ = ["Pipeline", "PROTOCOL_PIPELINE", "RemoteStage"]

_logger = get_logger("aiko.pipeline")

PROTOCOL_PIPELINE = f"{SERVICE_PROTOCOL_PREFIX}/pipeline:0"
_BACKPRESSURE_DEPTH = 32          # frames queued before a source waits
_BACKPRESSURE_SLEEP = 0.005
_GRACE_TIME_DEFAULT = 120.0
# A parked frame older than this many grace periods stops counting as
# in-flight work when the stream's grace lease fires -- the backstop
# against stages that never complete (see _stream_lease_expired).
_STALL_REAP_FACTOR = 10
_METRICS_MEMORY = False           # RSS deltas per element when True
# Undiscovered remote stages: retry with exponential backoff from the
# base up to the cap (a fixed 0.25 s forever was a silent hot loop),
# bounded by the ``remote_retry_limit`` pipeline/stream parameter
# (0 = retry forever, the pre-ISSUE-5 behavior).
_REMOTE_RETRY_BASE = 0.25
_REMOTE_RETRY_CAP = 2.0
REMOTE_RETRY_LIMIT_DEFAULT = 8
# Failure recovery (ISSUE 5): how many times one frame may be replayed
# across device replacements before it errors (``replay_limit``
# parameter, 0 = unbounded), the per-remote-stage circuit breaker
# defaults (``breaker_threshold`` consecutive failures open it,
# 0 disables; ``breaker_cooldown_ms`` before a half-open probe), and
# the live-stream overload bound (``overload_policy`` block|shed_oldest
# |shed_newest with ``overload_limit`` in-flight frames).
REPLAY_LIMIT_DEFAULT = 2
BREAKER_THRESHOLD_DEFAULT = 3
BREAKER_COOLDOWN_MS_DEFAULT = 1000.0
OVERLOAD_POLICIES = ("block", "shed_oldest", "shed_newest")
OVERLOAD_LIMIT_DEFAULT = 8
# Replicated stages (ISSUE 7): delay before the background rebuild of
# a dropped replica (``replica_rebuild_ms`` parameter, 0 = no automatic
# rebuild -- operator/autoscaler drives it), and the occupancy
# thresholds the ``replicas: auto`` control loop scales on (scale up
# the stage whose admission queue grows while its live replicas are
# busy; scale down the stage that idles).
REPLICA_REBUILD_MS_DEFAULT = 200.0
REPLICA_SCALE_UP_OCCUPANCY = 0.75
REPLICA_SCALE_DOWN_OCCUPANCY = 0.25
# Black-box dumps (ISSUE 10) are debounced per reason: a sustained
# failure episode (every frame missing its deadline) writes one dump
# per window, not one per frame on the event loop.
_BLACKBOX_COOLDOWN_S = 5.0
# Drained pipelines keep accepting (journal + hold) this long after
# announcing death, so frames in flight toward them land in the
# journal before the adopter's settle-delayed read -- then stop.
_DRAIN_RETIRE_GRACE_S = 1.0

# Stage-worker threads (pipeline/stages.py) run elements off the event
# loop; ``get_parameter`` resolution reaches the owning stream through
# this thread-local instead of the loop's _current_stream_ref.
_THREAD_STREAM = threading.local()


class RemoteStage(PipelineElement):
    """Placeholder element for a stage deployed in another pipeline
    process (reference PipelineElementDeployRemote, pipeline.py:246-258,
    858-891).  Holds the discovered service topic; the engine does the
    park/forward/resume dance."""

    def __init__(self, context, service_filter: ServiceFilter):
        super().__init__(context)
        self.service_filter = service_filter
        self.remote_topic_path: str | None = None
        # Data-plane negotiation (ISSUE 9): the peer's advertised
        # tensor-pipe endpoint ("host:port") from its registrar-record
        # ``tensor_pipe=`` tag; None = the peer speaks MQTT only and
        # forwards ride the control fabric (counted, never silent).
        self.remote_pipe: str | None = None
        self._discovery = None

    def start_discovery(self):
        self._discovery = do_discovery(
            self.pipeline.runtime, self.service_filter,
            add_handler=self._on_found, remove_handler=self._on_lost)

    def _on_found(self, record, proxy):
        self.remote_topic_path = record.topic_path
        self.remote_pipe = ServiceTags.get(record.tags, PIPE_TAG)
        self.logger.info("remote stage %s found: %s (data plane: %s)",
                         self.name, record.topic_path,
                         self.remote_pipe or "mqtt")

    def _on_lost(self, record, proxy):
        if record.topic_path == self.remote_topic_path:
            self.remote_topic_path = None
            self.remote_pipe = None
            self.logger.warning("remote stage %s lost", self.name)

    def process_frame(self, stream, **inputs):
        raise RuntimeError("RemoteStage frames are forwarded, not invoked")


class Pipeline(Actor):
    def __init__(self, definition: PipelineDefinition | dict | str,
                 name: str | None = None, runtime=None, tags=None,
                 frame_codec=None, preflight: str | None = None):
        if not isinstance(definition, PipelineDefinition):
            definition = parse_pipeline_definition(definition)
        self.definition = definition
        # Static pre-flight (ISSUE 6, analysis/): dataflow + residency
        # analysis over the definition and its element sources, BEFORE
        # the actor registers and before any device work.  A structural
        # error (unbound input, dead mapping, malformed placement,
        # impure DeviceFn, ...) raises a graph-path-qualified
        # DefinitionError here instead of failing at frame N.
        # ``preflight: strict`` makes warnings fatal too; ``off`` skips.
        # The keyword (``pipeline create --check`` -> "strict") beats
        # the definition's ``preflight`` parameter.
        preflight_report = preflight_check(definition, mode=preflight)
        # Binary data plane (ISSUE 9): unless ``data_plane: mqtt``, the
        # pipeline binds a per-process tensor-pipe endpoint BEFORE the
        # actor registers, so the registrar record advertises it as a
        # ``tensor_pipe=host:port`` tag alongside the MQTT topic.
        # Remote-stage frames then ship tensors over the pipe (raw
        # bytes, zero base64) while the control envelope stays on MQTT;
        # peers advertising no pipe negotiate down to the MQTT payload
        # path (counted).  A bind failure degrades the same way --
        # frames are never lost to the data plane being unavailable.
        mode = str(definition.parameters.get(
            "data_plane", "auto")).strip().lower()
        if mode not in DATA_PLANE_MODES:
            _logger.warning("data_plane=%r not one of %s; using auto",
                            mode, DATA_PLANE_MODES)
            mode = "auto"
        self._data_plane_mode = mode
        self._data_endpoint: TensorPipeEndpoint | None = None
        if mode != "mqtt":
            try:
                self._data_endpoint = TensorPipeEndpoint(
                    host=str(definition.parameters.get(
                        "tensor_pipe_host", "127.0.0.1")),
                    port=int(parse_number(
                        definition.parameters.get("tensor_pipe_port"),
                        0)),
                    claim_timeout_s=float(parse_number(
                        definition.parameters.get(
                            "pipe_claim_timeout_ms"),
                        PIPE_CLAIM_TIMEOUT_MS_DEFAULT)) / 1000.0,
                    capacity=int(parse_number(
                        definition.parameters.get(
                            "pipe_token_capacity"),
                        PIPE_TOKEN_CAPACITY_DEFAULT)))
            except Exception as error:
                _logger.warning("tensor-pipe data plane unavailable "
                                "(%s); frames ride MQTT", error)
        tags = list(tags or [])
        if self._data_endpoint is not None:
            tags.append(f"{PIPE_TAG}={self._data_endpoint.location}")
        # Gateway front door (ISSUE 12, gateway/server.py): ``gateway:
        # on`` binds the HTTP + WebSocket service that funnels client
        # connections into pipeline streams with per-tenant admission.
        # Bound BEFORE the actor registers -- like the tensor pipe --
        # so the registrar record advertises ``gateway=host:port``
        # and the front door is a discoverable capability of the
        # Service, per the source architecture.  Port 0 = kernel-
        # assigned, echoed on ``share["gateway_port"]``.
        self.gateway = None
        gateway_mode = str(definition.parameters.get(
            "gateway", "off")).strip().lower()
        if gateway_mode in ("on", "true", "1"):
            from ..gateway.server import GatewayServer
            self.gateway = GatewayServer(
                self,
                host=str(definition.parameters.get(
                    "gateway_host", "127.0.0.1")),
                port=int(parse_number(
                    definition.parameters.get("gateway_port"), 0)),
                session_idle_ms=float(parse_number(
                    definition.parameters.get("session_idle_ms"),
                    0.0)))
            tags.append(f"gateway={self.gateway.host}:"
                        f"{self.gateway.port}")
        # Fleet observability (ISSUE 19): ``metrics_port`` binds the
        # telemetry HTTP endpoint BEFORE the actor registers -- like
        # the gateway and the tensor pipe -- so the registrar record
        # advertises ``metrics=host:port`` and a fleet aggregator can
        # discover every member's scrape endpoint with no static
        # config.  Port 0 = kernel-assigned, echoed on
        # ``share["metrics_port"]``.
        self.metrics_server = None
        metrics_port = definition.parameters.get("metrics_port")
        if metrics_port is not None:
            telemetry_off = str(definition.parameters.get(
                "telemetry", "on")).strip().lower() in \
                ("off", "false", "0")
            if telemetry_off:
                # Binding an endpoint that can only 404 would turn
                # every fleet scrape into an error: say so at create.
                _logger.warning("metrics_port is set but telemetry=off:"
                                " endpoint not bound")
            else:
                from ..observability.exporter import MetricsServer
                metrics_host = str(definition.parameters.get(
                    "metrics_host", "127.0.0.1"))
                try:
                    self.metrics_server = MetricsServer(
                        self,
                        port=int(parse_number(metrics_port, 0)),
                        host=metrics_host)
                except OSError as error:
                    self._construction_failed()
                    raise DefinitionError(
                        f"pipeline {definition.name!r}: metrics_port="
                        f"{metrics_port!r} bind failed ({error})")
                tags.append(f"metrics={metrics_host}:"
                            f"{self.metrics_server.port}")
        # Durable stream journal + process fault domain (ISSUE 13):
        # ``journal: on`` appends each stream's recoverable state
        # (parameters, per-frame ingest payloads, delivery commits,
        # LLM committed token prefixes) to an fsync-batched journal
        # under ``journal_dir``, so a peer can ADOPT this pipeline's
        # live streams after an unclean process death -- and ``drain``
        # makes the same handoff cooperative (zero frame drop) for
        # rolling restarts.  Validated BEFORE actor registration: dead
        # config fails at create, not at the process death it was
        # configured to survive.
        self.journal: StreamJournal | None = None
        self._journal_resume: dict[tuple, list] = {}
        self._journal_lag_noted = 0.0
        self._draining = False
        self._drained = False
        self._drain_deadline = 0.0
        self._streams_adopted = 0
        self._frames_journal_replayed = 0
        self._adopt_limit = int(parse_number(
            definition.parameters.get("adopt_limit"),
            ADOPT_LIMIT_DEFAULT))
        self._drain_timeout_ms = float(parse_number(
            definition.parameters.get("drain_timeout_ms"),
            DRAIN_TIMEOUT_MS_DEFAULT))
        journal_mode = str(definition.parameters.get(
            "journal", "off")).strip().lower()
        self._journal_dir = definition.parameters.get("journal_dir")
        self._journal_dir = str(self._journal_dir) \
            if self._journal_dir else None
        if journal_mode in ("on", "true", "1"):
            if not self._journal_dir:
                self._construction_failed()
                raise DefinitionError(
                    f"pipeline {definition.name!r}: journal: on needs "
                    f"a writable journal_dir")
            try:
                os.makedirs(self._journal_dir, exist_ok=True)
                self.journal = StreamJournal(
                    os.path.join(self._journal_dir,
                                 f"{name or definition.name}.journal"),
                    fsync_ms=float(parse_number(
                        definition.parameters.get("journal_fsync_ms"),
                        JOURNAL_FSYNC_MS_DEFAULT)))
            except OSError as error:
                self._construction_failed()
                raise DefinitionError(
                    f"pipeline {definition.name!r}: journal_dir="
                    f"{self._journal_dir!r} is not writable ({error})")
        self._pipe_senders: dict[str, PipeSender] = {}
        self._pipe_token_seq = 0
        self._pipe_fallback_logged: set = set()
        # Per-stream ingest-order hold queue: a pipe frame whose
        # tensors are still in TCP flight when its envelope lands must
        # not let a LATER complete frame overtake it (see
        # _claim_for_ingest).
        self._pipe_ingest_wait: dict[str, list] = {}
        # Claim-dropped frames awaiting their MQTT re-forward: stream
        # key -> frame_id.  The ingest hold persists until the
        # re-forward arrives (or its deadline passes) so frames held
        # behind the dropped one cannot overtake its re-execution.
        self._pipe_retry_wait: dict[str, object] = {}
        self._plane_counts = {"pipe_frames": 0, "pipe_bytes": 0,
                              "mqtt_frames": 0, "mqtt_bytes": 0,
                              "fallbacks": 0, "claims_dropped": 0}
        # Everything past the gateway bind can raise a create-time
        # DefinitionError (qos parse, placement carve, graph build,
        # element load): the bound socket and its accept thread must
        # not outlive a failed construction, serving a
        # half-constructed pipeline forever.
        try:
            super().__init__(name or definition.name, PROTOCOL_PIPELINE,
                             tags=tags, runtime=runtime)
            if preflight_report is not None:
                for finding in preflight_report.findings:
                    self.logger.warning("pre-flight: %s", finding.render())
            if self.gateway is not None:
                # Failover plane (ISSUE 13): the gateway joins the
                # fabric AFTER actor registration -- it needs the
                # runtime for peer discovery and its wire-response
                # topic, neither of which exists when its socket binds.
                self.gateway.attach_runtime(self.runtime)
            self.streams: dict[str, Stream] = {}
            self._current_stream_ref: Stream | None = None
            self._current_frame_ref: Frame | None = None
            self._pipeline_parameters = dict(definition.parameters)
            # Device-resident swag accounting (pipeline/overlap.py): the
            # ``transfer_guard`` parameter sets the policy for every
            # device-resident element's event-loop execution.
            self.transfer_ledger = TransferLedger(
                definition.parameters.get("transfer_guard", "allow"))
            # Fused device-segment compilation (pipeline/fusion.py): every
            # FusedSegment built for this pipeline's streams registers here
            # (jit_stats / bench counters); the persistent XLA compile
            # cache is wired once per process, env-gated.
            self.fused_segments: list[FusedSegment] = []
            setup_compilation_cache(definition.parameters)
            # Unified QoS admission (ISSUE 12, gateway/qos.py): the ONE
            # authority the four former admission planes consult --
            # DeviceWindow pacing, StageScheduler credits, ReplicaGroup
            # slot pick, batcher admission.  Absent ``qos`` parameter =
            # None = every seam behaves exactly as before (FIFO,
            # round-robin, per-stream overload only).
            try:
                self.qos: QosScheduler | None = QosScheduler.parse(
                    definition.parameters.get("qos"))
            except (ValueError, TypeError) as error:
                # Pre-flight validates the block too (bad-parameter), but
                # ``preflight: off`` must not smuggle a malformed QoS
                # policy past create.
                raise DefinitionError(
                    f"pipeline {definition.name!r}: {error}")
            # Per-tenant SLO error budgets (ISSUE 19): objectives
            # usually live inside the qos block (``qos: {slo: ...}``);
            # a top-level ``slo`` parameter attaches the same burn
            # engine without any admission policy.  Validated here so a
            # bad block is a create-time DefinitionError even under
            # ``preflight: off``.
            slo_spec = definition.parameters.get("slo")
            if slo_spec is not None:
                from ..gateway.qos import SloTracker, slo_spec_error
                slo_problem = slo_spec_error(slo_spec)
                if slo_problem:
                    raise DefinitionError(
                        f"pipeline {definition.name!r}: {slo_problem}")
                if isinstance(slo_spec, str):
                    import json as json_module
                    slo_spec = json_module.loads(slo_spec)
                if self.qos is None:
                    self.qos = QosScheduler()
                self.qos.slo = SloTracker(slo_spec)
            self.share["slo_burn"] = {}
            self._qos_promotions = 0
            self._qos_sheds = 0
            self.share["qos_promotions"] = 0
            self.share["qos_sheds"] = 0
            # Guarded elastic fleet controller (ISSUE 20): the spec is
            # validated here -- same jax-free twin pre-flight's
            # bad-parameter rule runs -- so ``preflight: off`` cannot
            # smuggle a malformed block past create (the qos/slo/mesh
            # discipline).  Construction happens after the timers
            # below; parsing first keeps the failure create-time.
            from ..orchestration.controller import ControllerSpec
            try:
                self._controller_spec = ControllerSpec.parse(
                    definition.parameters.get("controller"),
                    definition.parameters)
            except (ValueError, TypeError) as error:
                raise DefinitionError(
                    f"pipeline {definition.name!r}: {error}")
            self.controller = None
            self._controller_timer = None
            self.share["controller_actions"] = 0
            self.share["controller_refusals"] = 0
            self.share["canary_rollbacks"] = 0
            self.share["fleet_size"] = 1
            # Per-replica element-parameter overrides (the controller's
            # canary-gated version swap): stage -> replica -> {name:
            # value}, consulted by ``PipelineElement.get_parameter``
            # through ``replica_override`` while a stage worker runs.
            self._replica_overrides: dict[str, dict[int, dict]] = {}
            # Replicated stages (ISSUE 7): stage -> (min, max) autoscale
            # bounds resolved from the placement blocks' ``replicas`` specs
            # (int N -> (N, N); "auto" -> (1, pool); {min, max} as given).
            self._replica_bounds: dict[str, tuple[int, int]] = {}
            self.stage_placement = self._build_placement()
            self.stage_scheduler = self._build_stage_scheduler()
            self._replica_failovers = 0
            self._replica_rebuilds = 0
            self.share["replica_failovers"] = 0
            self.share["replica_rebuilds"] = 0
            self.graph = self._build_graph()
            self.share["element_count"] = len(self.graph)
            self.share["streams"] = 0
            self.share["frames_processed"] = 0
            self._frames_processed = 0
            self._remote_retries = 0
            self.share["remote_stage_retries"] = 0
            self.share["data_plane_frames"] = 0
            self.share["data_plane_fallbacks"] = 0
            self.share["tensor_pipe_dropped_frames"] = 0
            # Failure recovery (ISSUE 5): fault-injection plan (None =
            # unarmed, zero hot-path work), per-remote-stage circuit
            # breakers, lazily built fallback elements, and the recovery
            # counters the chaos suite asserts on.
            self._faults: FaultPlan | None = None
            self._wire_faults_installed = False
            self.breakers: dict[str, CircuitBreaker] = {}
            self._fallback_elements: dict[str, PipelineElement] = {}
            self._frames_replayed = 0
            self._frames_shed = 0
            self._deadline_misses = 0
            self.share["frames_replayed"] = 0
            self.share["frames_shed"] = 0
            self.share["deadline_misses"] = 0
            self.share["faults_armed"] = False

            self.add_hook("pipeline.process_frame:0")
            self.add_hook("pipeline.process_element:0")
            self.add_hook("pipeline.process_element_post:0")
            self.add_hook("pipeline.process_segment:0")
            self.add_hook("pipeline.process_segment_post:0")
            self.add_hook("pipeline.process_stage:0")
            self.add_hook("pipeline.process_stage_post:0")
            self.add_hook("pipeline.stage_hop:0")
            self.add_hook("pipeline.replacement:0")
            self.add_hook("pipeline.replica_failover:0")

            # Telemetry plane (observability/): latency histograms, frame
            # traces and the export surface, fed by the hooks above.
            # ``telemetry: off`` disables it wholesale (hot-path cost drops
            # back to a no-handler hook probe per event).
            telemetry_mode = str(definition.parameters.get(
                "telemetry", "on")).strip().lower()
            if telemetry_mode in ("off", "false", "0"):
                self.telemetry = None
            else:
                self.telemetry = PipelineTelemetry(
                    self,
                    window_s=float(parse_number(
                        definition.parameters.get("telemetry_window"),
                        HISTOGRAM_WINDOW_DEFAULT)),
                    trace_capacity=int(parse_number(
                        definition.parameters.get("trace_capacity"),
                        TRACE_CAPACITY_DEFAULT)),
                    publish_interval=float(parse_number(
                        definition.parameters.get("telemetry_interval"),
                        TELEMETRY_INTERVAL_DEFAULT)))

            # Flight recorder + black-box (ISSUE 10): an always-on bounded
            # ring of typed engine events behind every seam below
            # (``recorder: off`` -> None, and every emission site is an
            # ``is not None`` no-op -- the unarmed-FaultPlan discipline).
            # ``blackbox_dir`` arms crash-dump snapshots: deadline miss,
            # replay, breaker open, replica failover and stream errors
            # write the ring tail + in-flight frame states (redacted --
            # ids/names/numbers only) to bounded JSON files that
            # ``python -m aiko_services_tpu_torch explain <dump>`` renders.
            recorder_mode = str(definition.parameters.get(
                "recorder", "on")).strip().lower()
            if recorder_mode in ("off", "false", "0"):
                self.recorder = None
            else:
                self.recorder = FlightRecorder(int(parse_number(
                    definition.parameters.get("recorder_capacity"),
                    RECORDER_CAPACITY_DEFAULT)))
            self._blackbox_dir = definition.parameters.get(
                "blackbox_dir") or None
            if self._blackbox_dir is not None and self.recorder is None:
                # Dumps ARE ring snapshots: without the recorder the
                # configuration is dead -- say so at create, not at the
                # crash the operator configured dumps to explain.
                _logger.warning("blackbox_dir is set but recorder=off: "
                                "no black-box dumps will be written")
            self._blackbox_limit = int(parse_number(
                definition.parameters.get("blackbox_limit"),
                BLACKBOX_LIMIT_DEFAULT))
            self.share["blackbox_dumps"] = 0
            self._blackbox_dumps = 0
            self._blackbox_last: dict[str, float] = {}

            self.share["streams_adopted"] = 0
            self.share["frames_journal_replayed"] = 0
            self.share["drained"] = False

            if self.gateway is not None:
                self.share["gateway_port"] = self.gateway.port
            if self.metrics_server is not None:
                self.share["metrics_port"] = self.metrics_server.port

            # Fleet aggregator (ISSUE 19): ``fleet: on`` runs the
            # registrar-discovered collector in this process --
            # scraping every member advertising a ``metrics=`` or
            # ``gateway=`` tag -- and mounts it on the gateway's
            # ``/fleet*`` routes when the door is open.
            self.fleet_collector = None
            fleet_mode = str(definition.parameters.get(
                "fleet", "off")).strip().lower()
            if fleet_mode in ("on", "true", "1"):
                from ..observability.fleet import (
                    FLEET_SCRAPE_MS_DEFAULT, FleetCollector)
                self.fleet_collector = FleetCollector(
                    runtime=self.runtime,
                    scrape_ms=float(parse_number(
                        definition.parameters.get("fleet_scrape_ms"),
                        FLEET_SCRAPE_MS_DEFAULT)),
                    local=self)
                self.fleet_collector.start()
                if self.gateway is not None:
                    self.gateway.fleet = self.fleet_collector

            self._health_timer = None
            interval = self.definition.parameters.get("health_check_interval")
            if interval and self.stage_placement is not None:
                self._health_timer = self.runtime.engine.add_timer_handler(
                    self.check_device_health, float(interval))
            # Replica autoscale control loop (ISSUE 7): re-splits replica
            # counts from queue depth + per-replica occupancy, bounded by
            # the declared {min, max}; 0/absent = no periodic loop (the
            # ``autoscale_replicas`` method stays callable).
            self._autoscale_timer = None
            autoscale = parse_number(self.definition.parameters.get(
                "replica_autoscale_interval"), 0.0)
            if autoscale and self._has_elastic_replicas():
                self._autoscale_timer = self.runtime.engine.add_timer_handler(
                    self.autoscale_replicas, float(autoscale))

            # Fleet controller construction (ISSUE 20; spec parsed and
            # validated above).  The tick rides a GUARDED engine timer:
            # a controller bug pauses the controller, never the
            # pipeline -- and with the timer gone the fleet keeps
            # serving exactly as last tuned (do-no-harm).
            if self._controller_spec.mode != "off":
                from ..orchestration.controller import (
                    FleetController, FleetSupervisor, default_spawner)
                supervisor = None
                if self._controller_spec.fleet_max > 1 \
                        and self._controller_spec.mode == "act":
                    # Peers load fleet_definition when given, else a
                    # stripped copy of THIS definition (controller/
                    # gateway off, same journal_dir = adoptable).
                    spawn_definition = definition
                    if self._controller_spec.fleet_definition:
                        spawn_definition = load_pipeline_definition(
                            self._controller_spec.fleet_definition)
                    supervisor = FleetSupervisor(
                        default_spawner(
                            spawn_definition,
                            str(definition.parameters.get(
                                "journal_dir") or "")),
                        engine=self.runtime.engine)
                self.controller = FleetController(
                    self, self._controller_spec,
                    supervisor=supervisor)
                if supervisor is not None and self.gateway is not None:
                    # Spawned peers must TAKE load: new sessions
                    # spread least-loaded across home + peers.
                    self.gateway.balance = True
                self._controller_timer = \
                    self.runtime.engine.add_timer_handler(
                        self._controller_tick,
                        self._controller_spec.interval_ms / 1000.0)

            fault_plan = definition.parameters.get("fault_plan")
            if fault_plan:
                self.arm_faults(fault_plan)
        except BaseException:
            # The actor registered at the top of this try block: a
            # create-time failure (bad qos/slo spec, graph error) must
            # not leave a half-constructed pipeline discoverable.
            service_id = getattr(self, "service_id", None)
            if service_id is not None and self.runtime is not None:
                self.runtime.remove_service(service_id)
            fleet = getattr(self, "fleet_collector", None)
            if fleet is not None:
                fleet.stop()
                self.fleet_collector = None
            controller = getattr(self, "controller", None)
            if controller is not None \
                    and controller.supervisor is not None:
                controller.supervisor.stop_all()
            if self.metrics_server is not None:
                self.metrics_server.stop()
                self.metrics_server = None
            if self.gateway is not None:
                self.gateway.stop()
                self.gateway = None
            if self._data_endpoint is not None:
                # Same class of leak, pre-existing: the tensor-pipe
                # endpoint binds before registration too.
                self._data_endpoint.close()
                self._data_endpoint = None
            journal = getattr(self, "journal", None)
            if journal is not None:
                journal.close()
            raise

    # -- graph construction ------------------------------------------------

    def _construction_failed(self) -> None:
        """Release the pre-registration binds (gateway socket, tensor
        pipe) when ``__init__`` aborts BEFORE its guarded try block --
        a create-time DefinitionError must not leak an accepting
        socket."""
        if getattr(self, "metrics_server", None) is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        if self.gateway is not None:
            self.gateway.stop()
            self.gateway = None
        if self._data_endpoint is not None:
            self._data_endpoint.close()
            self._data_endpoint = None

    def _build_placement(self):
        """Collect per-element ``placement`` blocks from the definition
        into one :class:`StagePlacement` over the local devices, so a
        definition file can express a multi-stage sharded pipeline
        (BASELINE config 4).  Block forms: ``{"devices": N}`` (an N-chip
        dp submesh) or ``{"mesh": {"tp": 4, ...}}``.  Elements without a
        block share all local devices (the TPUElement default).

        Frames hop between placed stages by ``StagePlacement.transfer``
        in the frame loop -- a pure ICI reshard, no host round-trip
        (the TPU analogue of the reference's remote-process deploy,
        reference pipeline.py:246-258)."""
        from .tensor import distributed_mesh_spec, ensure_distributed

        # Multi-host mesh mode (ISSUE 9): ``mesh: {hosts: N}`` (or the
        # AIKO_MESH_* env) spans one logical pipeline across hosts --
        # torch.distributed bring-up when a coordinator is configured,
        # then per-host submesh carving so same-mesh stage hops ride
        # ICI/DCN and only genuinely foreign processes pay the pipe.
        try:
            mesh_spec = distributed_mesh_spec(self.definition.parameters)
        except ValueError as error:
            raise DefinitionError(
                f"pipeline {self.definition.name!r}: {error}")
        if mesh_spec is not None:
            try:
                ensure_distributed(mesh_spec)
            except Exception as error:
                raise DefinitionError(
                    f"pipeline {self.definition.name!r}: "
                    f"torch.distributed bring-up at coordinator "
                    f"{mesh_spec['coordinator']} failed: {error}")
        stages = {}
        replica_specs = {}
        stage_hosts = {}
        for element_def in self.definition.elements:
            block = element_def.placement
            if not block:
                continue
            # Same authority as the lint rule (definition.py), so a
            # 'preflight: off' definition cannot smuggle a malformed
            # block past create into the runtime placement paths.
            problem = placement_error(block)
            if problem is not None:
                raise DefinitionError(
                    f"pipeline {self.definition.name!r}: "
                    f"{element_def.name}.placement: {problem}")
            if "mesh" in block:
                stages[element_def.name] = dict(block["mesh"])
            elif "devices" in block:
                want = block["devices"]
                # ``devices: auto`` splits the pool proportionally to
                # measured per-stage cost (StagePlacement._resolve);
                # equal split until profiles exist.
                stages[element_def.name] = "auto" \
                    if isinstance(want, str) else int(want)
            else:
                # ``{"replicas": N}`` alone places nothing -- the
                # ``replicas-on-unplaced`` lint rule warns at create.
                continue
            if "replicas" in block:
                replica_specs[element_def.name] = block["replicas"]
            if "host" in block:
                stage_hosts[element_def.name] = int(block["host"])
        if not stages:
            return None
        from .tensor import StagePlacement
        placement = StagePlacement()
        replicas, replica_min = {}, {}
        pool = len(placement.devices)
        for name, spec in replica_specs.items():
            low, high = self._replica_spec_bounds(spec, pool)
            self._replica_bounds[name] = (low, high)
            replica_min[name] = low
            # Start at the floor; the control loop (and reassign after
            # recovery) grows toward the max as load demands.
            replicas[name] = low if low < high else high
        try:
            placement.assign(
                stages, replicas=replicas or None,
                replica_min=replica_min or None,
                hosts=mesh_spec["hosts"] if mesh_spec else None,
                stage_hosts=stage_hosts or None)
        except ValueError as error:
            if mesh_spec is None:
                raise               # pre-existing over-request surface
            raise DefinitionError(
                f"pipeline {self.definition.name!r}: mesh placement: "
                f"{error}")
        return placement

    @staticmethod
    def _replica_spec_bounds(spec, pool: int) -> tuple[int, int]:
        """A placement ``replicas`` spec -> (min, max) counts: int N is
        fixed at N, ``auto`` scales 1..pool, {min, max} as declared."""
        if isinstance(spec, str):
            return 1, max(1, pool)
        if isinstance(spec, dict):
            low = max(1, int(spec.get("min", 1)))
            high = int(spec.get("max", pool))
            return low, max(low, high)
        count = max(1, int(spec))
        return count, count

    def _build_stage_scheduler(self):
        """Stage-parallel execution (pipeline/stages.py): on for
        multi-stage placed pipelines unless ``stage_pipeline: off``.
        Single-stage placements have nothing to overlap with, so the
        per-element path stays exactly as before -- UNLESS the stage is
        replicated, whose frame-level data parallelism needs the
        per-replica workers and admission windows."""
        if self.stage_placement is None \
                or (len(self.stage_placement.plans) < 2
                    and not self.stage_placement.has_replicas):
            return None
        mode = str(self.definition.parameters.get(
            "stage_pipeline", "auto")).strip().lower()
        if mode not in STAGE_PIPELINE_MODES:
            self.logger.warning("stage_pipeline=%r not one of %s; "
                                "using auto", mode, STAGE_PIPELINE_MODES)
            mode = "auto"
        if mode == "off":
            return None
        depth = int(parse_number(
            self.definition.parameters.get("stage_inflight"),
            STAGE_INFLIGHT_DEFAULT))
        placement = self.stage_placement
        replicas = {stage: len(plans) for stage, plans
                    in placement.replica_plans.items()}
        return StageScheduler(list(placement.plans), depth,
                              replicas=replicas or None, qos=self.qos,
                              on_promote=self._note_promotion)

    def _cancel_health_timer(self):
        if self._health_timer is not None:
            self.runtime.engine.remove_timer_handler(self._health_timer)
            self._health_timer = None
        if self._autoscale_timer is not None:
            self.runtime.engine.remove_timer_handler(
                self._autoscale_timer)
            self._autoscale_timer = None
        if getattr(self, "_controller_timer", None) is not None:
            self.runtime.engine.remove_timer_handler(
                self._controller_timer)
            self._controller_timer = None

    def check_device_health(self, prober=None, timeout=None,
                            devices=None) -> list:
        """Probe the placement's devices (or just ``devices`` -- the
        replica-scoped probe a replicated stage's dispatch error runs,
        so one replica's probe timeout can never mark a healthy peer's
        chips suspect); on failure, recover (SURVEY.md §5.3 TPU-equiv:
        chip health checks + stage re-placement).  Failures confined to
        replicas of replicated stages take the cheap path --
        ``fail_replica`` sheds the dead replica's frames to its peers
        and the group keeps serving at N-1 -- anything wider pays for
        the full ``replace_failed_devices`` rebuild.  Returns the
        failed devices (empty when all healthy or no placement).
        Schedule periodically via the ``health_check_interval``
        pipeline parameter (seconds); probe deadline from ``timeout``
        or the ``health_probe_timeout`` pipeline parameter (seconds,
        default tpu/health.PROBE_TIMEOUT).

        An armed FaultPlan's ``device_kill``/``device_hang`` rules wrap
        the prober here -- the swappable-prober injection point, so
        chaos exercises the genuine probe -> recover -> replay path."""
        if self.stage_placement is None:
            return []
        from ..tpu.health import probe_devices
        if timeout is None:
            timeout = parse_number(
                self.get_pipeline_parameter("health_probe_timeout"), None)
        if self._faults is not None:
            prober = self._fault_prober(prober)
        pool = self.stage_placement.devices if devices is None \
            else list(devices)
        failed = probe_devices(pool, prober, timeout=timeout)
        if failed:
            # One victim at a time, RE-RESOLVED between kills: a
            # failover can escalate (all-dead rebuild reassigns, the
            # scheduler-less path full-replaces), which re-carves the
            # pool and invalidates every other victim's slot index --
            # an index resolved before the escalation would retire
            # healthy chips and leave the real dead ones placed.
            remaining = set(failed)
            while remaining:
                victims = self._replica_victims(remaining)
                if victims is None:
                    self.replace_failed_devices(remaining)
                    break
                stage, index = victims[0]
                dead = self.stage_placement.replica_devices(stage,
                                                            index)
                self.fail_replica(stage, index)
                if not dead or not (remaining - dead):
                    break
                remaining -= dead
        return failed

    def _replica_victims(self, failed) -> list[tuple] | None:
        """(stage, replica) slots covering EVERY failed device, or None
        when any failure falls outside a live replica of a replicated
        stage (the full-replace path must handle it) -- including when
        there is no stage scheduler (``stage_pipeline: off``): without
        replica admission there is no peer-shed path, so the full
        rebuild is the only recovery.  A failure spanning several
        replicas fails each -- still cheaper than stopping the world."""
        placement = self.stage_placement
        if placement is None or not placement.has_replicas \
                or self.stage_scheduler is None:
            return None
        victims = []
        covered = set()
        for stage in placement.replica_plans:
            for index in placement.live_replicas(stage):
                devices = placement.replica_devices(stage, index)
                hit = devices & set(failed)
                if hit:
                    victims.append((stage, index))
                    covered |= devices
        if not victims or set(failed) - covered:
            return None
        return victims

    def replace_failed_devices(self, failed_devices) -> None:
        """Shrink/re-place every placed stage onto surviving devices and
        tell the elements to drop plans + re-resolve weights
        (``TPUElement.on_replacement``).

        Unrecoverable failures (not enough survivors for one chip per
        stage) are terminal: the health timer stops, the condition is
        shared as ``placement_failed``, and every live stream errors --
        an operator signal, not an every-interval retry of the
        impossible."""
        from .tensor import TPUElement

        placement = self.stage_placement
        self.logger.warning("re-placing stages: %d device(s) failed",
                            len(failed_devices))
        try:
            placement.replace(failed_devices)
        except (RuntimeError, ValueError) as error:
            # ValueError: the mesh-mode hosted carve (a pinned stage's
            # host group lost too many chips) -- terminal exactly like
            # the pool running out, not an escape past the health path.
            self.logger.error("stage re-placement impossible: %s", error)
            self._cancel_health_timer()
            self.ec_producer.update("placement_failed", str(error))
            for stream_id in list(self.streams):
                stream = self.streams[stream_id]
                for frame in list(stream.frames.values()):
                    self._frame_error(stream, frame,
                                      f"placement failed: {error}")
                self._destroy_stream_now(stream_id)
            return
        for node in self.graph.nodes():
            element = node.element
            if isinstance(element, TPUElement):
                element.on_replacement()
        # Fused segments captured the old weights/devices at build time:
        # drop every stream's partition so the next frame re-plans (and
        # re-captures) against the replacement submeshes.
        for stream in self.streams.values():
            stream.fusion_plans.clear()
            stream.fusion_segments.clear()
        self.fused_segments.clear()
        # In-flight recovery (ISSUE 5): frames alive right now were
        # dispatched against the dead submeshes.  Their outstanding
        # dispatch-window leaves must never be block_until_ready'd, and
        # the frames themselves replay from their last host-visible
        # boundary instead of erroring the stream.
        failed_set = set(failed_devices)
        replay_limit = int(parse_number(
            self.get_pipeline_parameter("replay_limit"),
            REPLAY_LIMIT_DEFAULT))
        replayed = 0
        for stream in list(self.streams.values()):
            stream.device_window.invalidate(failed_set)
            for frame in list(stream.frames.values()):
                if self._replay_frame(stream, frame, failed_set,
                                      replay_limit):
                    replayed += 1
        # Replica groups track the re-placed counts (a shrunk pool may
        # have shed replicas); everything is freshly carved, so every
        # surviving slot re-admits live -- the canary discipline is for
        # the targeted rebuild path, not the stop-the-world one.
        self._reset_replica_groups()
        self._rec("replace", ms=None,
                  info={"failed": len(failed_set),
                        "generation": placement.generation,
                        "replayed": replayed})
        self.run_hook("pipeline.replacement:0",
                      lambda: {"failed": [str(d) for d in failed_devices],
                               "generation": placement.generation,
                               "replayed": replayed,
                               "stages": {name: dict(plan.mesh.shape)
                                          for name, plan
                                          in placement.plans.items()}})
        self.ec_producer.update("replacements", placement.generation)

    # -- replicated stages: failover / rebuild / autoscale (ISSUE 7) -------

    def _reset_replica_groups(self, half_open: dict | None = None) -> None:
        """Sync the scheduler's ReplicaGroups to the placement's
        current replica counts (after replace/reassign); ``half_open``
        maps stage -> iterable of slot indices that must re-admit
        behind a canary frame."""
        scheduler = self.stage_scheduler
        placement = self.stage_placement
        if scheduler is None or placement is None:
            return
        for stage, group in scheduler.groups.items():
            count = placement.replica_total(stage)
            if count:
                group.rebuild(count, (half_open or {}).get(stage, ()))

    def current_replica(self) -> tuple | None:
        """(stage, replica index) while a stage worker executes an
        element/segment for a specific replica submesh (thread-local,
        like ``current_stream``); None on the event loop and on
        unreplicated stages.  ``TPUElement.plan`` keys off it."""
        return getattr(_THREAD_STREAM, "replica", None)

    def fail_replica(self, stage: str, index: int) -> None:
        """Peer-shedding failover: retire ONE dead replica and keep the
        stage serving at N-1.  The dead slot's chips leave the pool, its
        in-flight frames drain to the surviving peers via the replay
        path (last host-visible boundary, ``replay_epoch`` voiding
        stale posts, undiscovered-remote backoff reset -- a frame
        punished for a dead replica's failures starts clean on a
        healthy one), and NOTHING else is touched: no other submesh
        rebuilds, no peer frame replays, generation unchanged.
        ``replace()``-style rebuild runs in the background after
        ``replica_rebuild_ms`` (0 disables)."""
        placement = self.stage_placement
        scheduler = self.stage_scheduler
        if placement is None:
            return
        if scheduler is None:
            # ``stage_pipeline: off`` with replicas declared: there is
            # no replica admission to shed through, but the chips are
            # still dead -- pay for the full rebuild rather than
            # silently leaving a dead submesh in the pool.
            dead = placement.replica_devices(stage, index)
            if dead:
                self.replace_failed_devices(dead)
            return
        start = time.perf_counter()
        dead = placement.drop_replica(stage, index)
        if not dead:
            return                      # unknown/already-dead slot
        # Elements whose CACHED whole-pool/shared-submesh plan spans the
        # retired chips must re-resolve (default-placed elements span
        # every local device; the replicated stage's own whole-stage
        # plan shrank) -- peers placed on their own submeshes keep
        # their plans and compiled functions untouched.
        from .tensor import TPUElement
        for node in self.graph.nodes():
            element = node.element
            if isinstance(element, TPUElement) \
                    and element._plan is not None \
                    and dead & set(element._plan.mesh.devices.flat):
                element.on_replacement()
        group = scheduler.groups.get(stage)
        if group is not None:
            group.fail(index)
        self.logger.warning(
            "stage %s replica %d failed: shedding to %d peer(s), "
            "%d chip(s) retired", stage, index,
            group.live() if group is not None else 0, len(dead))
        replay_limit = int(parse_number(
            self.get_pipeline_parameter("replay_limit"),
            REPLAY_LIMIT_DEFAULT))
        replayed = 0
        invalidated = 0
        for stream in list(self.streams.values()):
            invalidated += stream.device_window.invalidate(dead)
            for frame in list(stream.frames.values()):
                mine = frame.stage == stage and frame.stage_replica == index
                if not mine and not touches_devices(frame.swag, dead):
                    continue
                frame.remote_retries = 0    # fresh backoff on the peer
                frame.metrics.pop("remote_retries", None)
                if self._replay_frame(stream, frame, dead, replay_limit):
                    replayed += 1
        self._replica_failovers += 1
        self.share["replica_failovers"] = self._replica_failovers
        failover_ms = (time.perf_counter() - start) * 1000.0
        self.share["replica_failover_ms"] = round(failover_ms, 3)
        if self.telemetry is not None:
            self.telemetry.registry.count("replica_failovers",
                                          stage=stage)
        self._rec("failover", name=stage, ms=failover_ms,
                  info={"replica": index, "chips": len(dead),
                        "replayed": replayed})
        self._blackbox("replica_failover", detail=f"{stage}#{index}: "
                       f"{len(dead)} chip(s), {replayed} replayed")
        self.run_hook("pipeline.replica_failover:0",
                      lambda: {"stage": stage, "replica": index,
                               "failed": [str(d) for d in dead],
                               "live": group.live()
                               if group is not None else 0,
                               "replayed": replayed,
                               "window_invalidated": invalidated,
                               "ms": failover_ms})
        if group is not None and group.all_dead():
            # No peers left to shed to: the stage cannot serve at all.
            # Escalate to the full rebuild immediately (it re-fits the
            # ORIGINAL requests to the surviving pool).
            self.rebuild_replica(stage)
            return
        rebuild_ms = float(parse_number(
            self.get_pipeline_parameter("replica_rebuild_ms"),
            REPLICA_REBUILD_MS_DEFAULT))
        if rebuild_ms > 0:
            self.post_self("rebuild_replica", [stage],
                           delay=rebuild_ms / 1000.0)

    def rebuild_replica(self, stage: str) -> None:
        """Background rebuild after a failover: re-fit the ORIGINAL
        stage requests (desired replica counts included) onto the
        surviving pool and re-carve.  Every in-flight frame on rebuilt
        submeshes replays (same invalidation as ``replace()``); the
        restored slots of ``stage`` re-admit HALF-OPEN -- one canary
        frame each, breaker-style, before full re-admission
        (``replica_canary: off`` skips the canary)."""
        placement = self.stage_placement
        if placement is None or stage not in placement.replica_plans:
            return
        dead_slots = [idx for idx, plan
                      in enumerate(placement.replica_plans[stage])
                      if plan is None]
        if not dead_slots:
            # Nothing left to restore (an earlier rebuild/reassign beat
            # this post here): a reassign now would bump the generation
            # and replay every in-flight frame for nothing.
            return
        try:
            placement.reassign()
        except (RuntimeError, ValueError) as error:
            self.logger.error("replica rebuild for %s impossible: %s",
                              stage, error)
            return
        canary = str(self.get_pipeline_parameter(
            "replica_canary", "on")).strip().lower() \
            not in ("off", "false", "0")
        restored = [idx for idx in dead_slots
                    if idx < placement.replica_total(stage)]
        self._invalidate_after_reassign()
        self._reset_replica_groups(
            half_open={stage: restored} if canary else None)
        self._replica_rebuilds += 1
        self.share["replica_rebuilds"] = self._replica_rebuilds
        if self.telemetry is not None:
            self.telemetry.registry.count("replica_rebuilds",
                                          stage=stage)
        self.logger.warning(
            "stage %s rebuilt: %d replica slot(s) restored%s "
            "(generation %d)", stage, len(restored),
            " half-open behind a canary" if canary and restored else "",
            placement.generation)
        self.ec_producer.update("replacements", placement.generation)

    def _invalidate_after_reassign(self) -> None:
        """Post-reassign invalidation, shared by rebuild and autoscale:
        every stage was re-carved, so plans, fused segments and
        in-flight frames are all stale -- exactly the
        ``replace_failed_devices`` discipline minus the dead-device
        scrubbing (no chips died here) -- and minus the replay-budget
        charge: an administrative re-carve must not consume the frames'
        failure-recovery allowance (``count=False``)."""
        from .tensor import TPUElement

        for node in self.graph.nodes():
            element = node.element
            if isinstance(element, TPUElement):
                element.on_replacement()
        for stream in self.streams.values():
            stream.fusion_plans.clear()
            stream.fusion_segments.clear()
        self.fused_segments.clear()
        for stream in list(self.streams.values()):
            for frame in list(stream.frames.values()):
                self._replay_frame(stream, frame, set(), 0, count=False)

    def _has_elastic_replicas(self) -> bool:
        return any(low < high
                   for low, high in self._replica_bounds.values())

    def autoscale_replicas(self) -> dict:
        """One control-loop tick: scale UP the replicated stage whose
        admission queue grows while its live replicas run hot
        (occupancy >= REPLICA_SCALE_UP_OCCUPANCY), scale DOWN the one
        idling (every replica under REPLICA_SCALE_DOWN_OCCUPANCY, no
        queue), one step per tick, bounded by the declared {min, max}.
        Applies via ``set_replicas`` + ``reassign`` and returns the
        {stage: new count} decisions (empty = no change).  Runs
        periodically under ``replica_autoscale_interval``; callable
        directly (bench, operators)."""
        placement = self.stage_placement
        scheduler = self.stage_scheduler
        if placement is None or scheduler is None:
            return {}
        decisions: dict[str, int] = {}
        for stage, (low, high) in self._replica_bounds.items():
            if low >= high:
                continue
            group = scheduler.groups.get(stage)
            if group is None:
                continue
            live = group.live()
            occupancies = [group.occupancy(idx)
                           for idx, state in enumerate(group.states)
                           if state == "live"]
            busiest = max(occupancies, default=0.0)
            # The signal consumed, start the next tick's window fresh:
            # occupancy must describe THIS interval's load, not dilute
            # under the idle time since creation (construction +
            # first-compile alone would hold it under threshold for
            # many multiples of the tick).
            group.reset_window()
            if scheduler.waiting(stage) > 0 and live < high \
                    and busiest >= REPLICA_SCALE_UP_OCCUPANCY:
                decisions[stage] = live + 1
            elif live > low and scheduler.waiting(stage) == 0 \
                    and busiest <= REPLICA_SCALE_DOWN_OCCUPANCY:
                decisions[stage] = live - 1
        # Capacity gate for fixed-request scale-ups: without free chips
        # (or a simultaneous scale-down freeing some) the reassign
        # would shed the increment straight back -- a no-op that still
        # bumps the generation and replays every in-flight frame, every
        # tick, for as long as the load lasts.  ``auto``-request stages
        # re-split their existing allocation, so they pass freely.
        ups = {stage: count for stage, count in decisions.items()
               if count > scheduler.groups[stage].live()}
        if ups:
            allocated = sum(int(plan.mesh.devices.size)
                            for plan in placement.plans.values())
            free = len(placement.devices) - allocated
            freed = 0
            for stage, count in decisions.items():
                if count < scheduler.groups[stage].live():
                    sizes = [int(plan.mesh.devices.size) for plan
                             in placement.replica_plans.get(stage, ())
                             if plan is not None]
                    freed += min(sizes, default=0)
            for stage in ups:
                if placement._requests.get(stage) == "auto":
                    continue
                sizes = [int(plan.mesh.devices.size) for plan
                         in placement.replica_plans.get(stage, ())
                         if plan is not None]
                need = min(sizes, default=1)
                if free + freed < need:
                    del decisions[stage]
        if not decisions:
            return {}
        rollback = {stage: placement._replica_desired[stage]
                    for stage in decisions}
        for stage, count in decisions.items():
            placement.set_replicas(stage, count)
        try:
            placement.reassign()
        except (RuntimeError, ValueError) as error:
            # Restore the desired counts: leaving the phantom increment
            # behind would let the NEXT replace/rebuild re-fit carve a
            # replica this loop never reported deciding.
            for stage, count in rollback.items():
                placement.set_replicas(stage, count)
            self.logger.error("replica autoscale reassign failed: %s",
                              error)
            return {}
        self._invalidate_after_reassign()
        self._reset_replica_groups()
        for group in scheduler.groups.values():
            group.reset_window()
        self.logger.info("replica autoscale: %s (generation %d)",
                         decisions, placement.generation)
        if self.telemetry is not None:
            for stage in decisions:
                self.telemetry.registry.count("replica_autoscales",
                                              stage=stage)
        return decisions

    # -- fleet-controller actuator seams (ISSUE 20) ------------------------

    def _controller_tick(self) -> None:
        """Guarded controller tick: a controller bug pauses the
        controller and cancels its timer -- the pipeline, its streams
        and every supervised peer keep serving as last tuned
        (controller-death-safe by construction)."""
        controller = self.controller
        if controller is None:
            return
        try:
            controller.tick()
        except Exception:
            self.logger.exception(
                "fleet controller tick raised; controller paused, "
                "fleet keeps serving as tuned")
            controller.paused = True
            if self._controller_timer is not None:
                self.runtime.engine.remove_timer_handler(
                    self._controller_timer)
                self._controller_timer = None

    def set_stage_inflight(self, depth) -> bool:
        """Live re-tune of the per-stage admission window (controller
        actuator; callable by operators via ``set_parameter``-style
        wire commands too).  Deepening wakes queued waiters into the
        new credits immediately; shrinking drains naturally.  Returns
        whether anything changed."""
        scheduler = self.stage_scheduler
        depth = max(1, int(parse_number(depth, 0)))
        if scheduler is None or depth == scheduler.depth:
            return False
        previous = scheduler.depth
        scheduler.set_depth(depth)
        self._pipeline_parameters["stage_inflight"] = depth
        if depth > previous:
            for stage in scheduler.stages:
                self._pump_stage(stage)
        self.logger.info("stage_inflight: %d -> %d", previous, depth)
        return True

    def set_device_inflight(self, depth) -> bool:
        """Live re-tune of the async-dispatch overlap window.  Applies
        to the pipeline default AND every live stream that did not
        pin its own ``device_inflight`` stream parameter (a stream's
        explicit choice outlives the controller's)."""
        depth = max(0, int(parse_number(depth, 0)))
        current = int(parse_number(
            self.get_pipeline_parameter("device_inflight"),
            DEVICE_INFLIGHT_DEFAULT))
        if depth == current:
            return False
        self._pipeline_parameters["device_inflight"] = depth
        for stream in self.streams.values():
            if "device_inflight" not in stream.parameters:
                stream.device_inflight = depth
        self.logger.info("device_inflight: %d -> %d", current, depth)
        return True

    def swap_replica_version(self, stage, index, name, value,
                             canary: bool = True):
        """Set (or with ``value=None`` clear) a per-replica override
        of one element parameter -- the controller's canary-gated
        "model version" swap unit.  With ``canary`` the replica is
        demoted to half-open so its next admission is a single canary
        frame (ISSUE 7 lifecycle decides live-or-dead from that
        frame); rollback passes ``canary=False`` to restore known-good
        capacity immediately.  Returns the PREVIOUS override (None =
        none -- round-trips through rollback naturally)."""
        stage, index = str(stage), int(index)
        overrides = self._replica_overrides.setdefault(
            stage, {}).setdefault(index, {})
        old = overrides.get(name)
        if value is None:
            overrides.pop(name, None)
        else:
            overrides[name] = value
        scheduler = self.stage_scheduler
        group = None if scheduler is None \
            else scheduler.groups.get(stage)
        if canary and group is not None:
            group.reopen(index)
        self._rec("version_swap", None, None, stage, None,
                  {"replica": index, "parameter": str(name),
                   "canary": bool(canary),
                   "cleared": value is None})
        return old

    def fleetctl(self, response_topic, command, *arguments):
        """Wire-invocable fleet-controller control surface (``python
        -m aiko_services_tpu_torch fleetctl`` publishes ``(fleetctl
        <response_topic> <command> ...)`` to our in-topic): replies on
        ``response_topic`` with the do_request pattern -- one
        ``(item_count 1)`` then one ``(fleetctl <json report>)``.
        Commands: ``status`` / ``pause`` / ``resume`` / ``force KIND
        [detail-json]`` / ``swap STAGE PARAMETER VALUE-JSON``."""
        import json

        from ..utils import generate
        command = str(command)
        controller = self.controller
        if controller is None:
            report = {"error": "no fleet controller on this pipeline "
                               "(controller: off)"}
        elif command == "status":
            report = controller.status()
        elif command == "pause":
            controller.pause()
            report = {"paused": True, "status": controller.status()}
        elif command == "resume":
            controller.resume()
            report = {"paused": False, "status": controller.status()}
        elif command == "force":
            kind = str(arguments[0]) if arguments else ""
            detail = {}
            if len(arguments) > 1:
                try:
                    detail = dict(json.loads(str(arguments[1])))
                except (ValueError, TypeError) as error:
                    detail = None
                    report = {"error": f"bad detail JSON: {error}"}
            if detail is not None:
                problem = controller.force_action(kind, **detail)
                report = {"forced": kind, "refused": problem,
                          "status": controller.status()}
        elif command == "swap":
            if len(arguments) < 3:
                report = {"error": "swap needs STAGE PARAMETER VALUE"}
            else:
                try:
                    value = json.loads(str(arguments[2]))
                except ValueError:
                    value = str(arguments[2])
                problem = controller.begin_swap(
                    str(arguments[0]), str(arguments[1]), value)
                report = {"swap": str(arguments[0]),
                          "refused": problem,
                          "status": controller.status()}
        else:
            report = {"error": f"unknown fleetctl command "
                               f"{command!r} (status|pause|resume|"
                               f"force|swap)"}
        publish = self.runtime.message.publish
        publish(str(response_topic), generate("item_count", [1]))
        publish(str(response_topic),
                generate("fleetctl", [json.dumps(report,
                                                 default=str)]))

    def replica_override(self, stage, index, name):
        """(value, found) for a per-replica parameter override --
        consulted by ``PipelineElement.get_parameter`` ahead of every
        other source while a stage worker runs replica ``index``."""
        overrides = self._replica_overrides.get(str(stage))
        if not overrides:
            return None, False
        values = overrides.get(int(index))
        if not values or name not in values:
            return None, False
        return values[name], True

    def replica_stats(self) -> dict:
        """Per-replicated-stage view the dashboard/bench read: slot
        states, per-replica in-flight + occupancy, live count, bounds,
        failover/rebuild counters."""
        placement = self.stage_placement
        scheduler = self.stage_scheduler
        if placement is None or not placement.has_replicas:
            return {}
        result: dict = {"failovers": self._replica_failovers,
                        "rebuilds": self._replica_rebuilds,
                        "stages": {}}
        failover_ms = self.share.get("replica_failover_ms")
        if failover_ms is not None:
            result["failover_ms"] = failover_ms
        for stage, plans in placement.replica_plans.items():
            entry = {"slots": [None if plan is None
                               else int(plan.mesh.devices.size)
                               for plan in plans],
                     "bounds": list(self._replica_bounds.get(
                         stage, (len(plans), len(plans))))}
            if scheduler is not None:
                group = scheduler.groups.get(stage)
                if group is not None:
                    entry.update(group.stats)
            result["stages"][stage] = entry
        return result

    def _build_graph(self) -> Graph:
        graph = Graph.traverse(self.definition.graph)
        graph.validate_acyclic()
        for node in graph.nodes():
            element_def = self.definition.element(node.name)
            context = ElementContext(node.name, element_def, self,
                                     dict(element_def.parameters))
            if element_def.deploy_local is not None:
                cls = self._load_element_class(element_def.deploy_local,
                                               node.name)
                node.element = cls(context)
            else:
                service_filter = ServiceFilter(
                    **{k: v for k, v in element_def.deploy_remote.items()
                       if k in ("name", "protocol", "transport", "owner",
                                "tags")})
                stage = RemoteStage(context, service_filter)
                stage.start_discovery()
                node.element = stage
        return graph

    def _load_element_class(self, deploy_local: dict,
                            element_name: str = "?"):
        context = (f"pipeline {self.definition.name!r}: "
                   f"{element_name}.deploy.local")
        module = load_module(deploy_local["module"])
        class_name = deploy_local.get("class_name")
        if class_name is None:
            raise DefinitionError(
                f"{context}: needs class_name (module "
                f"{deploy_local['module']!r})")
        try:
            return getattr(module, class_name)
        except AttributeError:
            raise DefinitionError(
                f"{context}: module {deploy_local['module']!r} has no "
                f"class {class_name!r}")

    # -- parameters --------------------------------------------------------

    def get_pipeline_parameter(self, name: str, default=None):
        if name in self.share:
            return self.share[name]
        return self._pipeline_parameters.get(name, default)

    def set_pipeline_parameter(self, name: str, value):
        self._pipeline_parameters[name] = value

    def set_parameter(self, name=None, value=None):
        """Wire command ``(set_parameter name value)`` -- live parameter
        update (reference pipeline.py:1585-1603).  Qualified
        ``Element.param`` targets that element's own parameters (the
        first thing ``get_parameter`` consults after stream params);
        bare names become pipeline-level parameters visible to every
        element."""
        if name is None:
            return
        name = str(name)
        if name == "fault_plan":
            # Live chaos trigger: ``-p fault_plan <json>`` from the CLI
            # / dashboard arms (or, with an empty value, disarms) the
            # fault harness on a running pipeline.
            if value in (None, "", "off", "disarm"):
                self.disarm_faults()
            else:
                self.arm_faults(value)
            return
        element_name, _, bare = name.partition(".")
        if bare and element_name in self.graph:
            self.graph.get_node(element_name).element.set_parameter(
                bare, value)
        else:
            self.set_pipeline_parameter(name, value)

    def current_stream(self) -> Stream | None:
        # Stage-worker threads pin their stream thread-locally; the
        # event loop's reference would be another frame's stream (or
        # None) while a worker is mid-element.
        stream = getattr(_THREAD_STREAM, "stream", None)
        if stream is not None:
            return stream
        return self._current_stream_ref

    def transfer_stats(self) -> dict:
        """Device-resident swag accounting: the TransferLedger counters
        plus the live streams' dispatch-window stats (bench.py reports
        ``implicit`` as ``swag_host_transfers``)."""
        stats = dict(self.transfer_ledger.stats)
        stats["window"] = {stream_id: stream.device_window.stats
                           for stream_id, stream in self.streams.items()}
        return stats

    def jit_stats(self) -> dict:
        """Compiled-function cache accounting, transfer_stats()-style:
        hit/miss/entry totals over every element JitCache and every
        fused segment's call cache, with per-element / per-segment
        breakdowns (the dashboard and bench read the totals off the
        share dict as ``jit_cache_{hits,misses,entries}``)."""
        totals = {"hits": 0, "misses": 0, "entries": 0}
        elements, segments = {}, {}
        for node in self.graph.nodes():
            cache = getattr(node.element, "jit_cache", None)
            if cache is None:
                continue
            stats = cache.stats
            elements[node.name] = stats
            for key in totals:
                totals[key] += stats[key]
        for segment in self.fused_segments:
            stats = segment.jit_cache.stats
            # Segments are stream-owned; two streams running the same
            # path each have one, so the breakdown keys by both.
            label = segment.name if segment.stream_id is None \
                else f"{segment.stream_id}:{segment.name}"
            segments[label] = segment.stats
            for key in totals:
                totals[key] += stats[key]
        totals["elements"] = elements
        totals["segments"] = segments
        return totals

    def stage_stats(self) -> dict:
        """Stage-parallel accounting: per-stage admission window state,
        occupancy over the scheduler's window, placed chip counts and
        the measured cost profile (the bench's ``stage_occupancy_*``
        keys read the occupancy values)."""
        if self.stage_scheduler is None:
            return {}
        stats = self.stage_scheduler.stats
        if self.stage_placement is not None:
            for name, plan in self.stage_placement.plans.items():
                entry = stats.setdefault(name, {})
                entry["devices"] = int(plan.mesh.devices.size)
                cost = self.stage_placement.costs.get(name)
                if cost:
                    entry["cost_ms"] = round(cost * 1000.0, 3)
        return stats

    def fusion_stats(self) -> dict:
        """Fused-segment accounting: segment/dispatch totals the bench
        reports as ``fused_segments`` / ``fused_dispatches_per_frame``."""
        return {"segments": len(self.fused_segments),
                "fused_elements": sum(len(s.nodes)
                                      for s in self.fused_segments),
                "dispatches": sum(s.calls for s in self.fused_segments),
                "broken": sum(1 for s in self.fused_segments if s.broken)}

    # -- binary data plane (ISSUE 9) ---------------------------------------

    def data_plane_stats(self) -> dict:
        """The control/data-split accounting the bench and tests read:
        frames/bytes per path, negotiated fallbacks, endpoint drops and
        expired claims, per-peer sender state."""
        stats = dict(self._plane_counts)
        stats["mode"] = self._data_plane_mode
        endpoint = self._data_endpoint
        if endpoint is not None:
            stats.update(endpoint.stats)
            self.share["tensor_pipe_dropped_frames"] = endpoint.dropped
        stats["senders"] = {location: sender.stats
                            for location, sender
                            in self._pipe_senders.items()}
        return stats

    def _pipe_sender(self, location: str) -> PipeSender:
        sender = self._pipe_senders.get(location)
        if sender is None:
            sender = self._pipe_senders[location] = PipeSender(location)
        return sender

    def _next_pipe_token(self) -> str:
        # Unique across processes: the service topic path is unique per
        # (host, pid, service), the counter per forward attempt.
        self._pipe_token_seq += 1
        return f"{self.topic_path}#{self._pipe_token_seq}"

    def _count_plane(self, pipe_bytes, envelope_len: int) -> None:
        counts = self._plane_counts
        if pipe_bytes is None:
            counts["mqtt_frames"] += 1
            counts["mqtt_bytes"] += int(envelope_len)
        else:
            counts["pipe_frames"] += 1
            counts["pipe_bytes"] += int(pipe_bytes) + int(envelope_len)
            self.share["data_plane_frames"] = counts["pipe_frames"]

    def _count_pipe_fallback(self, where: str, reason: str) -> None:
        """A frame whose tensors were pipe-eligible rode MQTT instead
        (peer advertises no pipe, send failed, breaker open): counted
        on the share dict and the telemetry plane, logged once per
        (site, reason) so a degraded data plane is VISIBLE without
        spamming every frame."""
        self._plane_counts["fallbacks"] += 1
        self.share["data_plane_fallbacks"] = \
            self._plane_counts["fallbacks"]
        # Exposition rides the metrics_text gauge refresh (like
        # data_plane_frames) -- registering the same name as a counter
        # TOO would emit duplicate samples and invalidate the scrape.
        self._rec("pipe_fallback", name=where,
                  info={"reason": reason})
        mark = (where, reason)
        if mark not in self._pipe_fallback_logged:
            self._pipe_fallback_logged.add(mark)
            self.logger.warning("data plane: %s: %s -- tensors ride "
                                "MQTT (counted, see "
                                "data_plane_fallbacks)", where, reason)

    def _pipe_ship(self, pipe_location, frame_data: dict, header: dict,
                   where: str):
        """Try to ship ``frame_data``'s arrays over the tensor pipe to
        ``pipe_location``; on success the header grows the claim token
        + key list and the returned body holds only the residue for
        the MQTT envelope.  Any failure returns the FULL frame_data --
        the MQTT path is the always-correct fallback, so a data-plane
        problem costs bytes, never frames.  Returns (body, pipe_bytes
        or None)."""
        arrays = split_arrays(frame_data)
        if not arrays:
            return frame_data, None
        if not pipe_location:
            self._count_pipe_fallback(
                where, "peer advertises no tensor pipe")
            return frame_data, None
        sender = self._pipe_sender(str(pipe_location))
        token = self._next_pipe_token()
        sent = sender.send(token, arrays)
        if sent is None:
            self._count_pipe_fallback(
                where, f"pipe send to {pipe_location} failed or "
                       f"breaker open")
            return frame_data, None
        header["pipe_token"] = token
        header["pipe_keys"] = sorted(arrays)
        body = {key: value for key, value in frame_data.items()
                if key not in arrays}
        return body, sent

    def _count_claim_dropped(self, token, command: str) -> None:
        self._plane_counts["claims_dropped"] += 1
        self._rec("claim_drop", name=str(token),
                  info={"command": command})
        self.logger.warning(
            "data plane: %s token %s expired with tensors missing -- "
            "dropping the envelope (sender recovers via deadline/"
            "breaker, exactly as for a dropped wire frame)",
            command, token)

    def _claim_for_ingest(self, stream_dict: dict,
                          frame_data: dict) -> dict | None:
        """Pair an inbound ``process_frame`` envelope with its pipe
        tensors.  Returns the claimed arrays ({} when the frame has no
        pipe token) or None when the envelope was handled elsewhere --
        deferred behind the endpoint watch, queued behind an earlier
        still-waiting frame of the same stream (ingest order is a
        per-stream contract: the pipe and the envelope race, and a
        complete frame must not overtake an incomplete predecessor),
        or dropped after the claim timeout."""
        stream_key = str(stream_dict.get("stream_id",
                                         DEFAULT_STREAM_ID))
        waiting = self._pipe_ingest_wait.get(stream_key)
        token = stream_dict.get("pipe_token")
        if waiting is not None:
            retry_id = self._pipe_retry_wait.get(stream_key)
            if retry_id is not None and not token \
                    and str(stream_dict.get("frame_id")) == str(retry_id):
                # The awaited MQTT re-forward of the claim-dropped
                # head: ingest it NOW, then release the envelopes held
                # behind it in arrival order (posted, so they ingest
                # after this frame).
                del self._pipe_retry_wait[stream_key]
                for held_dict, held_data in \
                        self._pipe_ingest_wait.pop(stream_key, None) \
                        or []:
                    self.post_self("process_frame",
                                   [held_dict, held_data])
                return {}
            # An earlier frame of this stream is still waiting for its
            # tensors: hold THIS envelope (tokened or not) behind it.
            waiting.append((stream_dict, frame_data))
            return None
        if not token:
            return {}
        keys = [str(key) for key in
                (stream_dict.get("pipe_keys") or [])]
        endpoint = self._data_endpoint
        if endpoint is None:
            # The sender saw our advertised tag but the endpoint is
            # gone (mode flipped live): the tensors are unreachable.
            self._count_claim_dropped(token, "process_frame")
            return None
        claimed = endpoint.claim(token, keys)
        if claimed is not None:
            return claimed
        if stream_dict.get("pipe_deferred"):
            # Second pass (watch fired at the timeout, tensors still
            # missing -- the pipe died with them in a kernel buffer).
            # Tell the origin so it RE-FORWARDS this frame over MQTT:
            # a data-plane loss must cost latency, never the frame.
            self._count_claim_dropped(token, "process_frame")
            response_topic = stream_dict.get("response_topic")
            if response_topic:
                header = {"stream_id": stream_dict.get(
                              "stream_id", DEFAULT_STREAM_ID),
                          "frame_id": stream_dict.get("frame_id"),
                          "okay": False, "pipe_retry": True,
                          "diagnostic": "tensor pipe payload missing "
                                        "(claim timeout)"}
                self.runtime.message.publish(
                    response_topic,
                    generate("process_frame_response", [header, {}]))
                # The origin will re-forward this frame over MQTT:
                # keep the stream's ingest hold until it lands, else
                # complete frames held behind this one would overtake
                # the re-execution.  Deadline-bounded -- an origin
                # that never re-forwards (died, retry budget spent)
                # must not wedge the stream.
                frame_id = stream_dict.get("frame_id")
                self._pipe_ingest_wait.setdefault(stream_key, [])
                self._pipe_retry_wait[stream_key] = frame_id
                self.runtime.engine.add_oneshot_timer(
                    lambda: self._pipe_retry_expired(stream_key,
                                                     frame_id),
                    max(1.0, endpoint.claim_timeout_s))
            return None
        stream_dict["pipe_deferred"] = True
        self._pipe_ingest_wait[stream_key] = []
        endpoint.watch(
            token, keys,
            lambda: self.post_self("ingest_pipe_ready",
                                   [stream_key, stream_dict,
                                    frame_data]))
        return None

    def _pipe_retry_expired(self, stream_key, frame_id) -> None:
        """Deadline for a requested MQTT re-forward that never arrived
        (origin died, retry budget spent): release the ingest hold so
        the stream keeps serving -- the dropped frame belongs to the
        origin's deadline/breaker machinery now."""
        if self._pipe_retry_wait.get(str(stream_key)) != frame_id:
            return
        del self._pipe_retry_wait[str(stream_key)]
        held = self._pipe_ingest_wait.pop(str(stream_key), None) or []
        for held_dict, held_data in held:
            self.process_frame(held_dict, held_data)

    def ingest_pipe_ready(self, stream_key, stream_dict, frame_data):
        """Continuation: the head waiting frame's pipe tensors arrived
        (or its claim timed out).  Ingest it first, then replay the
        envelopes held behind it in arrival order -- an entry that is
        itself incomplete re-establishes the hold and the remainder
        queues behind it again."""
        held = self._pipe_ingest_wait.pop(str(stream_key), None) or []
        self.process_frame(stream_dict, frame_data)
        for held_dict, held_data in held:
            self.process_frame(held_dict, held_data)

    def _claim_pipe_response(self, stream_dict: dict,
                             frame_data: dict) -> dict | None:
        """The response twin of ``_claim_for_ingest``.  Responses need
        no ordering hold: a parked frame resumes by id whenever ITS
        response completes."""
        token = stream_dict.get("pipe_token")
        if not token:
            return {}
        keys = [str(key) for key in
                (stream_dict.get("pipe_keys") or [])]
        endpoint = self._data_endpoint
        if endpoint is None:
            self._count_claim_dropped(token, "process_frame_response")
            return None
        claimed = endpoint.claim(token, keys)
        if claimed is not None:
            return claimed
        if stream_dict.get("pipe_deferred"):
            # The RESPONSE's tensors died with the pipe: re-forward the
            # still-parked frame over MQTT (the remote re-executes --
            # the same idempotency the wire-retry paths already
            # assume); past the retry bound, the deadline/breaker
            # machinery recovers it like any dropped response.
            self._count_claim_dropped(token, "process_frame_response")
            self._retry_parked_over_mqtt(stream_dict)
            return None
        stream_dict["pipe_deferred"] = True
        endpoint.watch(
            token, keys,
            lambda: self.post_self("process_frame_response",
                                   [stream_dict, frame_data]))
        return None

    def _retry_parked_over_mqtt(self, stream_dict: dict) -> None:
        """A pipe-shipped payload for a parked frame never arrived:
        re-forward the frame over the MQTT payload path, once per
        frame (``pipe_retries``) -- past that, the deadline/breaker
        machinery owns recovery."""
        stream = self.streams.get(str(stream_dict.get(
            "stream_id", DEFAULT_STREAM_ID)))
        frame = stream.frames.get(int(parse_number(
            stream_dict.get("frame_id"), -1))) \
            if stream is not None else None
        if frame is None or frame.paused_pe_name is None \
                or frame.paused_pe_name not in self.graph:
            return
        node = self.graph.get_node(frame.paused_pe_name)
        if not isinstance(node.element, RemoteStage):
            return
        if frame.metrics.get("pipe_retries", 0) >= 1:
            return
        frame.metrics["pipe_retries"] = \
            frame.metrics.get("pipe_retries", 0) + 1
        self._count_pipe_fallback(
            f"re-forward to {node.name}",
            "pipe payload missing; resending over MQTT")
        self._forward_frame(stream, frame, node, force_mqtt=True)

    def _upload_claimed(self, stream_id, claimed: dict) -> dict:
        """Claimed pipe tensors land host-side zero-copy; when the
        stream's head is a PLACED stage, ``device_put`` them straight
        onto its submesh here -- the upload overlaps the walk dispatch
        instead of serializing at the first stage hop (which skips
        leaves already resident)."""
        placement = self.stage_placement
        if placement is None:
            return claimed
        stream = self.streams.get(str(stream_id))
        head = stream.graph_path if stream is not None \
            and stream.graph_path else \
            (self.graph.heads[0].name if self.graph.heads else None)
        if head not in placement.plans:
            return claimed
        try:
            return placement.transfer(claimed, head)
        except Exception:
            self.logger.exception("data plane: device_put of claimed "
                                  "tensors onto stage %r failed; "
                                  "leaving them host-side", head)
            return claimed

    # -- fault harness + failure recovery (ISSUE 5) ------------------------

    def arm_faults(self, spec=None) -> None:
        """Arm a FaultPlan: ``spec`` is a rules list / {"seed", "rules"}
        dict / JSON string (see faults/plan.py for the points).  Wire-
        callable -- ``(arm_faults <json>)`` -- so the dashboard or CLI
        triggers chaos against a LIVE pipeline.  Re-arming replaces the
        previous plan; wire rules install a filter on the loopback
        broker (the only transport that supports them)."""
        try:
            plan = FaultPlan.parse(spec)
        except (ValueError, TypeError) as error:
            self.logger.error("arm_faults: bad plan: %s", error)
            return
        self._remove_wire_faults()
        self._faults = plan
        self.logger.warning("fault plan ARMED: %d rule(s), seed=%d",
                            len(plan.rules), plan.seed)
        if plan.has_wire_rules:
            broker = self._loopback_broker()
            if broker is None:
                self.logger.warning(
                    "fault plan has wire rules but the transport is not "
                    "loopback; wire faults will not fire")
            else:
                broker.set_fault_filter(
                    wire_fault_filter(plan, broker.publish_direct))
                self._wire_faults_installed = True
        self.ec_producer.update("faults_armed", True)

    def disarm_faults(self) -> None:
        """Disarm the plan: every injection point returns to its
        unarmed (zero-work) path."""
        self._remove_wire_faults()
        if self._faults is not None:
            self.logger.warning("fault plan disarmed")
        self._faults = None
        self.ec_producer.update("faults_armed", False)

    def _loopback_broker(self):
        message = getattr(self.runtime, "message", None)
        return getattr(message, "_broker", None)

    def _remove_wire_faults(self) -> None:
        if not self._wire_faults_installed:
            return
        broker = self._loopback_broker()
        if broker is not None:
            broker.set_fault_filter(None)
        self._wire_faults_installed = False

    def fault_stats(self) -> dict:
        """The chaos/recovery surface tests and the dashboard read:
        plan counters + trace (blast radius), breaker states, and the
        recovery counters."""
        stats = {"armed": self._faults is not None,
                 "frames_replayed": self._frames_replayed,
                 "frames_shed": self._frames_shed,
                 "deadline_misses": self._deadline_misses,
                 "breakers": {name: breaker.stats
                              for name, breaker in self.breakers.items()}}
        if self._faults is not None:
            stats["plan"] = self._faults.stats
        return stats

    def _fault_target_devices(self, target) -> set:
        """Resolve a device-fault rule's target: a placed stage name
        (its current submesh), ``stage#<replica>`` for ONE replica's
        submesh of a replicated stage, ``device:<index>`` into the
        placement pool, or None for every placed device."""
        placement = self.stage_placement
        if placement is None:
            return set()
        if target is None:
            return set(placement.devices)
        target = str(target)
        if target in placement.plans:
            return placement.stage_devices(target)
        if "#" in target:
            stage, _, index = target.partition("#")
            if stage in placement.replica_plans:
                try:
                    return placement.replica_devices(stage, int(index))
                except (ValueError, IndexError):
                    return set()
        if target.startswith("device:"):
            try:
                return {placement.devices[int(target[7:])]}
            except (ValueError, IndexError):
                return set()
        return set()

    def _fault_prober(self, prober):
        """Wrap the health prober per the armed plan: ``device_kill``
        targets report dead, ``device_hang`` targets sleep through the
        probe deadline.  Rules fire ONCE per health check (count
        semantics: one rule firing = one failure event)."""
        plan = self._faults
        dead: set = set()
        hung: list = []
        for rule in plan.fire_point("device_kill"):
            dead |= self._fault_target_devices(rule.target)
        for rule in plan.fire_point("device_hang"):
            hung.append((self._fault_target_devices(rule.target),
                         rule.delay_ms))
        if not dead and not hung:
            return prober
        from ..tpu.health import default_prober
        base = prober or default_prober
        self.logger.warning("injected device fault: %d dead, %d hung",
                            len(dead), len(hung))

        def wrapped(device):
            if device in dead:
                return False
            for devices, delay_ms in hung:
                if device in devices:
                    time.sleep(delay_ms / 1000.0)
            return base(device)

        return wrapped

    def _inject_element_fault(self, node_name: str, stream_id) -> None:
        """Armed-plan probe at an element dispatch site (sync walk,
        stage worker, async submit).  ``element_hang`` sleeps in place
        -- a chip gone quiet; ``element_raise`` raises FaultInjected --
        the XLA dead-chip dispatch error surface.  Callers' existing
        exception paths (and the dispatch-error recovery probe) handle
        the rest, which is the point: chaos runs the REAL paths."""
        faults = self._faults
        if faults is None:          # disarmed between check and call
            return
        rule = faults.should("element_hang", target=node_name,
                             stream=stream_id)
        if rule is not None:
            time.sleep(rule.delay_ms / 1000.0)
        rule = faults.should("element_raise", target=node_name,
                             stream=stream_id)
        if rule is not None:
            raise FaultInjected(
                f"injected device failure at {node_name}")

    def _inject_segment_fault(self, segment_name: str, stream_id) -> None:
        """Armed-plan probe at a fused-segment dispatch site (event
        loop and stage-worker paths share it)."""
        faults = self._faults
        if faults is not None \
                and faults.should("segment_fail", target=segment_name,
                                  stream=stream_id) is not None:
            raise FaultInjected(
                f"injected segment failure at {segment_name}")

    def _recover_after_dispatch_error(self, stream: Stream,
                                      frame: Frame) -> bool:
        """A dispatch raised on a placed pipeline: before declaring the
        frame dead, probe the chips -- on real hardware XLA raising at
        dispatch IS how chip loss presents.  When the probe finds
        failures, ``replace_failed_devices`` has already re-placed the
        stages and replayed (or error-bounded) every in-flight frame,
        THIS one included; the caller must then skip its own
        _frame_error.  Healthy probe -> False -> normal error path (a
        code bug is not a chip loss).

        On a replicated stage the probe is SCOPED to the frame's own
        replica submesh (ISSUE 7): the dispatch raised there, so that
        is where the evidence points -- and a hung chip's probe
        timeout must never mark a healthy peer's chips suspect (the
        periodic ``health_check_interval`` probe still walks the full
        pool, so failures elsewhere are found on their own clock, not
        blamed on this frame)."""
        if self.stage_placement is None:
            return False
        scoped = None
        if frame.stage is not None and frame.stage_replica is not None:
            devices = self.stage_placement.replica_devices(
                frame.stage, frame.stage_replica)
            if devices:
                scoped = list(devices)
        try:
            failed = self.check_device_health(devices=scoped)
        except Exception:
            self.logger.exception("post-dispatch-error health check "
                                  "failed")
            return False
        return bool(failed)

    def _replay_frame(self, stream: Stream, frame: Frame, failed: set,
                      replay_limit: int, count: bool = True) -> bool:
        """Re-admit one in-flight frame after a device replacement.

        The replay frontier is the frame's last host-visible boundary:
        elements whose outputs the frame already accepted
        (``frame.completed``) never re-execute; swag device leaves on
        dead chips are fetched to host when still reachable (re-uploaded
        to the replacement submeshes by the replayed walk's normal
        hops/puts) or dropped.  Bounded by ``replay_limit`` per frame;
        over it, the frame errors instead of looping.  ``count=False``
        is the ADMINISTRATIVE replay (autoscale re-split, background
        replica rebuild): no chips failed, so the engine's own re-carve
        must not consume the frame's failure-recovery budget -- under
        sustained load consecutive scale-up ticks would otherwise error
        the very backlog they exist to absorb.  Returns True when the
        frame was scheduled for replay."""
        node = self.graph.get_node(frame.paused_pe_name) \
            if frame.paused_pe_name is not None \
            and frame.paused_pe_name in self.graph else None
        if node is not None and isinstance(node.element, RemoteStage):
            # The remote round trip is unaffected by LOCAL chip death;
            # just scrub stranded swag so the resume survives.
            self._scrub_swag(frame, failed)
            return False
        if count:
            frame.replays += 1
            if replay_limit and frame.replays > replay_limit:
                # Per-frame failure: the over-budget FRAME errors;
                # sibling frames still within budget keep their replays
                # (and the stream) alive.
                self._frame_fail(
                    stream, frame,
                    f"replay limit ({replay_limit}) exceeded after "
                    f"device replacement")
                return False
        # Critical-path ``replay`` bucket: time since the frame last
        # made progress (the end of its most recently FINISHED element
        # run, or the start of the one still in flight) -- the work
        # this replay voids.  Completed runs stay billed to
        # ``compute``; the wall time covers both attempts, so buckets
        # still sum to e2e, not above it.
        progress = []
        for key, value in frame.metrics.items():
            if key.endswith("_time_start"):
                elapsed = frame.metrics.get(f"{key[:-11]}_time")
                progress.append(float(value)
                                + float(elapsed or 0.0))
        if progress:
            lost_ms = (time.perf_counter() - max(progress)) * 1000.0
            if lost_ms > 0.0:
                frame.metrics["replay_lost_ms"] = \
                    frame.metrics.get("replay_lost_ms", 0.0) + lost_ms
        # Stale-ify every in-flight continuation of the PREVIOUS
        # attempt: worker/async completion posts carry the epoch they
        # were submitted under and are discarded on mismatch.
        frame.replay_epoch += 1
        frame.paused_pe_name = None
        # ok=None: a replayed frame is yanked, not judged -- a
        # half-open slot whose canary it was keeps waiting for a REAL
        # verdict (unless this stage already completed, which
        # _release_stage upgrades to success).
        self._release_stage(stream, frame, ok=None)
        self._scrub_swag(frame, failed)
        resume_at = None
        for path_node in self._stream_path(stream):
            if path_node.name not in frame.completed:
                resume_at = path_node.name
                break
        self._count_replay(stream)
        frame.metrics["replays"] = frame.replays
        self._rec("replay", stream.stream_id, frame.frame_id,
                  resume_at, info={"attempt": frame.replays,
                                   "counted": count})
        if count:
            # Administrative replays (autoscale re-split, background
            # rebuild) touch every in-flight frame -- only genuine
            # failure replays are worth a dump each.
            self._blackbox("replay", stream.stream_id, frame.frame_id,
                           detail=f"resume at {resume_at} "
                                  f"(attempt {frame.replays})")
        self.logger.warning(
            "stream %s frame %s: replaying at %s (attempt %d) after "
            "device replacement", stream.stream_id, frame.frame_id,
            resume_at, frame.replays)
        if resume_at is None:
            self._frame_done(stream, frame, None)
            return True
        self.post_self("retry_frame_at",
                       [stream.stream_id, frame, resume_at])
        return True

    def _scrub_swag(self, frame: Frame, failed: set) -> None:
        """Invalidate swag device leaves stranded on dead chips: values
        still fetchable come back as host copies (ONE counted ledger
        fetch each -- the engine-initiated sanctioned transfer), values
        whose buffers died with the chip are dropped so the replayed
        walk fails cleanly on missing inputs rather than dispatching a
        dead buffer."""
        dropped = 0
        for key in list(frame.swag):
            value = frame.swag[key]
            if not touches_devices(value, failed):
                continue
            try:
                frame.swag[key] = self.transfer_ledger.fetch(value)
            except Exception:
                frame.swag.pop(key, None)
                dropped += 1
        if dropped:
            frame.metrics["replay_dropped_keys"] = \
                frame.metrics.get("replay_dropped_keys", 0) + dropped

    # -- deadlines + overload shedding -------------------------------------

    def _count_replay(self, stream: Stream) -> None:
        self._frames_replayed += 1
        self.share["frames_replayed"] = self._frames_replayed
        if self.telemetry is not None:
            self.telemetry.registry.count("frames_replayed")

    def _count_shed(self, stream: Stream) -> None:
        self._frames_shed += 1
        self.share["frames_shed"] = self._frames_shed
        if self.telemetry is not None:
            self.telemetry.registry.count("frames_shed")

    def _deadline_fail(self, stream: Stream, frame: Frame) -> None:
        """A frame blew its ``frame_deadline_ms``: cancel remaining
        work (the frame leaves stream.frames, so any in-flight
        continuation post goes stale) and deliver a deadline error in
        its reorder slot.  The STREAM stays alive -- an SLO miss on one
        frame is not a stream failure.  A frame parked at a remote
        stage counts the miss against that stage's circuit breaker:
        the remote never answered in time."""
        self._deadline_misses += 1
        self.share["deadline_misses"] = self._deadline_misses
        if self.telemetry is not None:
            self.telemetry.registry.count("deadline_misses")
        parked_at = frame.paused_pe_name
        if parked_at is not None and parked_at in self.graph:
            node = self.graph.get_node(parked_at)
            if isinstance(node.element, RemoteStage):
                breaker = self._stage_breaker(parked_at)
                if breaker is not None:
                    self._breaker_failure(parked_at, breaker,
                                          stream.stream_id,
                                          frame.frame_id)
        self._rec("deadline", stream.stream_id, frame.frame_id,
                  parked_at)
        self._blackbox("deadline_miss", stream.stream_id,
                       frame.frame_id,
                       detail=f"parked at {parked_at}"
                       if parked_at else "")
        frame.metrics["deadline_missed"] = True
        frame.replay_epoch += 1         # stale-ify late worker posts
        self._frame_fail(stream, frame,
                         f"deadline exceeded "
                         f"({stream.deadline_ms:.0f} ms)")

    def expire_frame(self, stream_id, frame_id, frame_ref=None):
        """Continuation posted at ingest for deadline-bearing frames:
        fires once at the deadline and fails the frame wherever it is
        -- walking, queued for admission, or parked at an async/worker/
        remote stage that will never answer.  This is what guarantees
        'completes or errors within its deadline' even for parks."""
        stream = self.streams.get(str(stream_id))
        frame = stream.frames.get(int(frame_id)) \
            if stream is not None else None
        if frame is None or frame is not frame_ref \
                or frame.deadline is None:
            return
        remaining = frame.deadline - time.monotonic()
        if remaining > 0:               # timer fired marginally early
            self.post_self("expire_frame",
                           [stream_id, frame_id, frame],
                           delay=remaining + 0.005)
            return
        if self._draining:
            # Deadline errors are deliveries; a draining pipeline
            # parks the frame for adoption instead (see
            # ``_past_deadline``).
            return
        self._deadline_fail(stream, frame)

    def _shed_for_overload(self, stream: Stream) -> bool:
        """Queue-depth shedding at ingest for live streams.  Returns
        True when the INCOMING frame should be refused (shed_newest, or
        shed_oldest with no cancellable victim); shed_oldest cancels
        the oldest frame still waiting for stage admission -- the only
        frames whose work can be cancelled without abandoning running
        compute -- which also frees its credit-window pressure."""
        if stream.overload_policy == "block" or not stream.overload_limit \
                or stream.in_flight < stream.overload_limit:
            return False
        if stream.overload_policy == "shed_oldest":
            victim = min(
                (f for f in stream.frames.values()
                 if f.stage_waiting is not None),
                key=lambda f: f.frame_id, default=None)
            if victim is not None:
                self._count_shed(stream)
                victim.metrics["shed"] = True
                self._rec("shed", stream.stream_id, victim.frame_id,
                          info={"policy": stream.overload_policy})
                self._frame_fail(
                    stream, victim,
                    f"shed: overload ({stream.overload_policy}, "
                    f"{stream.in_flight} in flight)")
                return False
        return True

    def _shed_incoming(self, stream: Stream, frame: Frame) -> None:
        """Refuse an incoming frame under overload: it still takes its
        delivery slot (in-order contract) and responds with a shed
        error immediately."""
        self._count_shed(stream)
        frame.metrics["shed"] = True
        self._rec("shed", stream.stream_id, frame.frame_id,
                  info={"policy": stream.overload_policy,
                        "incoming": True})
        self._frame_fail(stream, frame,
                         f"shed: overload ({stream.overload_policy}, "
                         f"{stream.in_flight} in flight)")

    # -- unified QoS admission (ISSUE 12, gateway/qos.py) ------------------

    def _stamp_qos(self, stream: Stream, frame: Frame) -> None:
        """Resolve the frame's tenant/class from its stream and open
        the scheduler's in-flight accounting (closed exactly once by
        ``_qos_done`` on any completion path).  The ingest sequence is
        the rank tiebreak that keeps same-class (and per-stream)
        arrival order."""
        frame.tenant = stream.tenant
        frame.qos_class = stream.qos_class
        frame.qos_wait_start = time.monotonic()
        if self.qos is None:
            return
        frame.qos_seq = self.qos.next_seq()
        frame.qos_open = True
        self.qos.frame_started(frame.tenant)

    def _qos_done(self, frame: Frame) -> None:
        """Close the scheduler's in-flight accounting for a frame
        (idempotent -- the flag flips once)."""
        if frame.qos_open:
            frame.qos_open = False
            if self.qos is not None:
                self.qos.frame_finished(frame.tenant)

    def _device_limit(self, stream: Stream) -> int:
        """The stream's effective dispatch-window depth: per-class caps
        from the QoS policy tighten the resolved ``device_inflight``
        (plane 1 of the unified scheduler)."""
        if self.qos is None:
            return stream.device_inflight
        return self.qos.device_limit(stream.qos_class,
                                     stream.device_inflight)

    def _qos_shed_for_overload(self, stream: Stream,
                               frame: Frame) -> bool:
        """Pipeline-wide QoS shedding at ingest (``max_inflight`` in
        the qos block): when the engine is over budget, shed the WORST
        victim across ALL streams -- over-budget tenants first, then
        the lowest class, then the oldest -- which may be the incoming
        frame itself (returns True: refuse it) or a queued frame of
        another stream (failed in ITS reorder slot; the incoming frame
        proceeds).  Only admission-queued frames are cancellable
        victims, exactly like ``shed_oldest``."""
        if self.qos is None or not self.qos.overloaded():
            return False
        # Severity is the (over_budget, class_rank) prefix; the seq
        # component of shed_key only picks WHICH victim among the
        # worst group (oldest first).  Only a victim STRICTLY worse
        # than the incoming frame sheds -- an in-budget tenant must
        # never shed its own frames just because the engine is busy
        # (the stage credits bound its memory; blocking is the right
        # backpressure there).  With no worse victim, the incoming
        # frame itself sheds only when ITS tenant is over budget.
        budgets = self.qos.budget_snapshot()
        incoming_key = self.qos.shed_key(frame, budgets)
        victim, victim_stream, victim_key = None, stream, None
        for other in self.streams.values():
            for candidate in other.frames.values():
                if candidate.stage_waiting is None:
                    continue
                key = self.qos.shed_key(candidate, budgets)
                if key[:2] <= incoming_key[:2]:
                    continue                # not strictly worse
                if victim_key is None or key > victim_key:
                    victim, victim_stream, victim_key = \
                        candidate, other, key
        if victim is None:
            if not incoming_key[0]:         # in budget: admit
                return False
            victim, victim_stream = frame, stream
        self.qos.count_shed(victim.tenant)
        if self.telemetry is not None:
            # Resolved entry name, not the raw string: label
            # cardinality stays bounded by LAZY_TENANT_CAP.
            self.telemetry.registry.count(
                "qos_sheds", tenant=self.qos.tenant(victim.tenant).name,
                cls=str(victim.qos_class))
        self._qos_sheds += 1
        self.share["qos_sheds"] = self._qos_sheds
        if victim is frame:
            return True
        self._count_shed(victim_stream)
        victim.metrics["shed"] = True
        self._rec("shed", victim_stream.stream_id, victim.frame_id,
                  info={"policy": "qos", "tenant": victim.tenant,
                        "cls": victim.qos_class})
        self._frame_fail(
            victim_stream, victim,
            f"shed: qos overload ({self.qos.inflight_total} in "
            f"flight, tenant {victim.tenant})")
        return False

    def _note_promotion(self, stream_id, frame: Frame) -> None:
        """A frame's near-deadline promotion decided a waiter pop
        (StageScheduler ``on_promote``, fired once per frame): count
        it and put it on the ring next to the admit it caused."""
        self._qos_promotions += 1
        self.share["qos_promotions"] = self._qos_promotions
        if self.telemetry is not None:
            self.telemetry.registry.count(
                "qos_promotions", cls=str(frame.qos_class))
        self._rec("gw_promote", stream_id, frame.frame_id,
                  frame.qos_class,
                  info={"tenant": frame.tenant})

    def qos_stats(self) -> dict:
        """The QoS plane's live view: per-tenant budgets/in-flight/
        shed counters plus the promotion total (None-safe)."""
        if self.qos is None:
            return {"enabled": False}
        stats = self.qos.stats()
        stats["enabled"] = True
        stats["promotions_recorded"] = self._qos_promotions
        stats["sheds_recorded"] = self._qos_sheds
        return stats

    def note_slo_burn(self, fired=None, burns=None) -> None:
        """SLO burn telemetry handed over from the gateway's result
        pump (event-loop method via ``post_self``: share, ring and
        black-box are not pump-thread-safe).  ``burns`` refreshes the
        ``slo_burn`` share key; each ``fired`` entry is a fast burn --
        ring event plus debounced black-box dump, because the error
        budget is burning NOW and the ring tail holds the frames that
        burned it."""
        if burns is not None:
            self.share["slo_burn"] = {
                str(tenant): {str(cls): entry.get("burn")
                              for cls, entry in classes.items()}
                for tenant, classes in burns.items()}
        for entry in fired or ():
            tenant, qos_class, burn = entry[0], entry[1], entry[2]
            self._rec("slo_burn", None, None, str(tenant), None,
                      {"cls": str(qos_class),
                       "burn": round(float(burn), 3)})
            self._blackbox(
                "slo_burn",
                detail=f"tenant {tenant} class {qos_class} "
                       f"burn {float(burn):.2f}x")
        if fired and self.controller is not None:
            # The controller's spawn tier keys urgency off fast burns
            # (burn_rates alone lags by the SLO window).
            self.controller.note_burns(fired)

    def _stamp_deadline(self, stream: Stream, frame: Frame) -> None:
        if not stream.deadline_ms:
            return
        frame.deadline = time.monotonic() + stream.deadline_ms / 1000.0
        self.post_self("expire_frame",
                       [stream.stream_id, frame.frame_id, frame],
                       delay=stream.deadline_ms / 1000.0 + 0.002)

    def _past_deadline(self, frame: Frame) -> bool:
        if self._draining:
            # A drain window suspends SLO enforcement: a deadline
            # error is a DELIVERY, and everything delivered here
            # would be excluded from the adopter's replay -- the
            # zero-drop handoff beats a late-frame error.
            return False
        return frame.deadline is not None \
            and time.monotonic() > frame.deadline

    # -- remote-stage circuit breaker --------------------------------------

    def _stage_breaker(self, node_name: str) -> CircuitBreaker | None:
        """The per-remote-stage breaker (None when disabled via
        ``breaker_threshold: 0``)."""
        threshold = int(parse_number(
            self.get_pipeline_parameter("breaker_threshold"),
            BREAKER_THRESHOLD_DEFAULT))
        if threshold <= 0:
            return None
        breaker = self.breakers.get(node_name)
        if breaker is None:
            cooldown = float(parse_number(
                self.get_pipeline_parameter("breaker_cooldown_ms"),
                BREAKER_COOLDOWN_MS_DEFAULT)) / 1000.0
            breaker = self.breakers[node_name] = CircuitBreaker(
                threshold, cooldown)
        return breaker

    def _run_fallback(self, stream: Stream, frame: Frame, node):
        """Run a remote stage's declared ``fallback:`` element locally
        while the breaker is open (degraded mode).  Outputs map out
        under the REMOTE node's name so downstream mappings hold.
        Returns True (ran, keep walking), False (no fallback declared),
        None (frame errored)."""
        definition = node.element.definition
        fallback_name = definition.fallback if definition else None
        if not fallback_name:
            return False
        element = self._fallback_elements.get(node.name)
        if element is None:
            element_def = self.definition.element(fallback_name)
            cls = self._load_element_class(element_def.deploy_local,
                                           fallback_name)
            context = ElementContext(fallback_name, element_def, self,
                                     dict(element_def.parameters))
            element = self._fallback_elements[node.name] = cls(context)
        inputs, missing, _ = self._map_in_for(element,
                                              node.properties or {},
                                              frame.swag, frame=frame,
                                              stream=stream)
        if missing:
            self._frame_error(stream, frame,
                              f"{fallback_name} (fallback for "
                              f"{node.name}): missing inputs {missing}")
            return None
        try:
            result = element.process_frame(stream, **inputs)
        except Exception as error:
            self.logger.exception("fallback %s raised", fallback_name)
            self._frame_error(stream, frame,
                              f"{fallback_name} (fallback for "
                              f"{node.name}): {error}")
            return None
        event, outputs = result if isinstance(result, tuple) \
            else (result, {})
        if event != StreamEvent.OKAY:
            diagnostic = (outputs or {}).get("diagnostic", "") \
                if isinstance(outputs, dict) else ""
            self._frame_error(stream, frame,
                              f"{fallback_name} (fallback for "
                              f"{node.name}): {diagnostic or event}")
            return None
        self._map_out(node, frame, outputs or {})
        frame.metrics["breaker_fallbacks"] = \
            frame.metrics.get("breaker_fallbacks", 0) + 1
        if self.telemetry is not None:
            self.telemetry.registry.count("breaker_fallbacks",
                                          stage=node.name)
        self.logger.warning("stream %s frame %s: breaker open, ran "
                            "fallback %s for %s", stream.stream_id,
                            frame.frame_id, fallback_name, node.name)
        return True

    def metrics_text(self) -> str:
        """Prometheus-style text exposition of the telemetry plane
        (histogram quantiles, counters, engine gauges).  Empty when
        ``telemetry: off``.  Safe to call from any thread -- this is
        what the ``--metrics-port`` HTTP endpoint serves."""
        if self.telemetry is None:
            return ""
        return self.telemetry.metrics_text()

    def get_trace(self, trace_id: str) -> dict | None:
        """One reconstructed trace (all spans, both processes for
        remote hops) from the TraceBuffer, or None."""
        if self.telemetry is None:
            return None
        return self.telemetry.traces.get(str(trace_id))

    # -- flight recorder + critical path (ISSUE 10) ------------------------

    def _rec(self, etype: str, stream=None, frame=None, name=None,
             ms=None, info=None) -> None:
        """One guarded flight-recorder append (no-op under
        ``recorder: off``).  Sites may only pass ids/names/numbers --
        the black-box dump's redaction rests on it."""
        recorder = self.recorder
        if recorder is not None:
            recorder.record(etype, stream, frame, name, ms, info)

    def explain(self, top_k: int = 5) -> dict:
        """Aggregate critical-path report over the trace buffer: bucket
        totals (compute / queue / hop / fetch / pipe / replay /
        pacing), per-stage/replica splits, and the top-k (stage,
        bucket) contributors -- the "where did the time go" answer for
        recent traffic.  Thread-safe (trace buffer snapshots under its
        lock); empty when ``telemetry: off``."""
        if self.telemetry is None:
            return {}
        report = aggregate_traces(self.telemetry.traces.snapshot(),
                                  top_k=top_k)
        report["pipeline"] = self.name
        if self.recorder is not None:
            report["recorder"] = self.recorder.stats
        return report

    def explain_frame(self, frame_id, stream_id=None) -> dict | None:
        """One frame's causal story: the flight-recorder timeline (what
        happened, in order, with every interval attributed to a
        bucket) plus its trace spans and completion attribution.  Works
        for in-flight frames too (partial timeline); None when neither
        the ring nor the trace buffer knows the frame.  Thread-safe.

        Frame ids restart per stream (and per stream INCARNATION):
        with ``stream_id`` omitted the NEWEST stream holding that
        frame id wins, and within a stream only the newest incarnation
        segment is used (``FlightRecorder.frame_events``) -- never a
        merge of same-id frames, which would attribute one frame's
        waits to another's compute and terminate the timeline at the
        wrong ``done``."""
        trace = None
        if isinstance(frame_id, str):
            # A gateway-minted trace id names the request end to end:
            # resolve it to the frame/stream its spans carry, then
            # explain that frame as usual (one id, door to decode).
            # Trace-id lookup first: an (unlikely) all-digit trace id
            # must not silently degrade to a frame-id lookup.
            if self.telemetry is not None:
                trace = self.telemetry.traces.get(frame_id)
            if trace is None:
                if frame_id.lstrip("-").isdigit():
                    frame_id = int(frame_id)
                else:
                    return None
        if trace is not None:
            frame_id, span_stream = None, None
            for span in trace.get("spans", []):
                if span.get("frame") is not None:
                    frame_id = span["frame"]
                    span_stream = span.get("stream") or span_stream
            if frame_id is None:
                return None
            if stream_id is None:
                stream_id = span_stream
        events = []
        if self.recorder is not None:
            if stream_id is None:
                candidates = self.recorder.snapshot(frame=frame_id)
                if candidates:
                    stream_id = candidates[-1][2]
            if stream_id is not None:
                events = self.recorder.frame_events(stream_id,
                                                    frame_id)
        if trace is None:
            trace = None if self.telemetry is None else \
                self.telemetry.traces.by_frame(frame_id,
                                               stream=stream_id)
        if not events and trace is None:
            return None
        result: dict = {"frame": int(frame_id),
                        "stream": None if stream_id is None
                        else str(stream_id)}
        if events:
            result.update(attribute_events(events))
        if trace is not None:
            result["trace_id"] = trace["trace_id"]
            result["okay"] = trace["okay"]
            result["spans"] = trace["spans"]
            if not events:
                # Ring already wrapped past this frame: fall back to
                # the completion-time attribution on the trace entry.
                for key in ("buckets", "stages", "e2e_ms",
                            "unattributed_ms", "coverage"):
                    if trace.get(key) is not None:
                        result[key] = trace[key]
        return result

    def _frame_states(self) -> list[dict]:
        """Redacted in-flight frame states for the black-box dump:
        position + numeric metrics + swag KEY names -- never values."""
        states = []
        for stream in self.streams.values():
            for frame in stream.frames.values():
                states.append({
                    "stream": stream.stream_id,
                    "frame": frame.frame_id,
                    "paused": frame.paused_pe_name,
                    "stage": frame.stage,
                    "replica": frame.stage_replica,
                    "waiting": frame.stage_waiting,
                    "replays": frame.replays,
                    "age_s": round(time.monotonic() - frame.created, 3),
                    "swag_keys": sorted(str(key) for key in frame.swag),
                    "metrics": {key: value for key, value
                                in frame.metrics.items()
                                if isinstance(value,
                                              (int, float, bool, str))}})
        return states

    def _blackbox(self, reason: str, stream=None, frame=None,
                  detail: str = "") -> None:
        """Snapshot the flight-recorder tail + in-flight frame states
        to a bounded JSON dump under ``blackbox_dir`` (off when the
        parameter is unset or the recorder is off).  Runs on the event
        loop at failure-transition sites, debounced per reason
        (``_BLACKBOX_COOLDOWN_S``): a sustained episode -- every frame
        of an overloaded stream missing its deadline -- must cost ONE
        dump per window, not a serialize+glob on the latency-critical
        loop per failure (the first dump's ring tail already holds the
        episode; later near-identical snapshots would only evict it)."""
        directory = self._blackbox_dir
        if directory is None or self.recorder is None:
            return
        now = time.monotonic()
        last = self._blackbox_last.get(reason)
        if last is not None and now - last < _BLACKBOX_COOLDOWN_S:
            return
        try:
            payload = {"reason": reason,
                       "pipeline": self.name,
                       "wall_time": time.time(),
                       "stream": None if stream is None else str(stream),
                       "frame": frame,
                       "detail": str(detail)[:500],
                       "generation": self.stage_placement.generation
                       if self.stage_placement is not None else 0,
                       "recorder": self.recorder.stats,
                       "frames": self._frame_states(),
                       "events": events_as_dicts(
                           self.recorder.snapshot(tail=1024))}
            path = write_blackbox(directory, payload,
                                  limit=self._blackbox_limit)
            # Charge the cooldown only on a SUCCESSFUL write: a full
            # disk must not silently eat the whole episode's window.
            self._blackbox_last[reason] = now
            self._blackbox_dumps += 1
            self.share["blackbox_dumps"] = self._blackbox_dumps
            self.logger.warning("black-box dump (%s): %s", reason, path)
        except Exception:
            self.logger.exception("black-box dump failed (%s)", reason)

    def _breaker_failure(self, name: str, breaker,
                         stream=None, frame=None) -> None:
        """Charge a remote stage's breaker, recording the transition --
        an OPEN transition is a black-box trigger (the stage just went
        dark; the ring tail holds the round trips that killed it)."""
        was = breaker.state
        breaker.record_failure()
        now = breaker.state
        if now != was:
            self._rec("breaker", stream, frame, name,
                      info={"state": now})
            if now == "open":
                self._blackbox("breaker_open", stream, frame,
                               detail=f"stage {name}")

    def _breaker_success(self, name: str, breaker,
                         stream=None, frame=None) -> None:
        was = breaker.state
        breaker.record_success()
        if breaker.state != was:
            self._rec("breaker", stream, frame, name,
                      info={"state": breaker.state})

    # -- stream lifecycle --------------------------------------------------

    def create_stream(self, stream_id=None, *parameters):
        """Wire command: ``(create_stream id (params...) grace_time)``.
        A ``graph_path`` entry in the params dict selects which named
        graph path (head element) this stream runs (reference
        pipeline.py:641 create_stream(graph_path=...); example:
        examples/pipeline/pipeline_paths.json)."""
        params = dict(parameters[0]) if parameters and isinstance(
            parameters[0], dict) else {}
        grace_time = parse_number(parameters[1], _GRACE_TIME_DEFAULT) \
            if len(parameters) > 1 else _GRACE_TIME_DEFAULT
        graph_path = params.pop("graph_path", None)
        self.create_stream_local(stream_id or DEFAULT_STREAM_ID,
                                 parameters=params, graph_path=graph_path,
                                 grace_time=grace_time)

    def create_stream_local(self, stream_id, parameters=None,
                            graph_path=None, grace_time=_GRACE_TIME_DEFAULT,
                            queue_response=None, topic_response=None) \
            -> Stream | None:
        stream_id = str(stream_id)
        if stream_id in self.streams:
            self.logger.warning("stream %s already exists", stream_id)
            return self.streams[stream_id]
        heads = [node.name for node in self.graph.heads]
        if graph_path is not None and str(graph_path) not in heads:
            # Heads only: starting mid-graph would skip the head
            # element's outputs and run a partial path.
            self.logger.error("stream %s: graph_path %r is not a graph "
                              "head (heads: %s)", stream_id, graph_path,
                              heads)
            return None
        stream = Stream(stream_id=stream_id, graph_path=graph_path,
                        parameters=dict(parameters or {}),
                        queue_response=queue_response,
                        topic_response=topic_response)
        stream.device_inflight = int(parse_number(
            stream.parameters.get(
                "device_inflight",
                self._pipeline_parameters.get("device_inflight")),
            DEVICE_INFLIGHT_DEFAULT))
        fuse = str(stream.parameters.get(
            "fuse", self._pipeline_parameters.get("fuse", "auto"))) \
            .strip().lower()
        if fuse not in FUSE_MODES:
            self.logger.warning("stream %s: fuse=%r not one of %s; "
                                "using auto", stream_id, fuse, FUSE_MODES)
            fuse = "auto"
        stream.fuse = fuse
        # Per-frame deadline + overload shedding (ISSUE 5), resolved
        # once per stream: stream parameters win over pipeline
        # parameters, like device_inflight above.
        stream.deadline_ms = float(parse_number(
            stream.parameters.get(
                "frame_deadline_ms",
                self._pipeline_parameters.get("frame_deadline_ms")),
            0.0))
        policy = str(stream.parameters.get(
            "overload_policy",
            self._pipeline_parameters.get("overload_policy",
                                          "block"))).strip().lower()
        if policy not in OVERLOAD_POLICIES:
            self.logger.warning("stream %s: overload_policy=%r not one "
                                "of %s; using block", stream_id, policy,
                                OVERLOAD_POLICIES)
            policy = "block"
        stream.overload_policy = policy
        stream.overload_limit = int(parse_number(
            stream.parameters.get(
                "overload_limit",
                self._pipeline_parameters.get("overload_limit")),
            OVERLOAD_LIMIT_DEFAULT))
        # Unified QoS admission (ISSUE 12): tenant identity + priority
        # class resolve once per stream (gateway sessions set them;
        # anything else lands on the default tenant's class).  An
        # unknown class falls back rather than erroring -- the gateway
        # validates client input at ITS boundary; a local caller's
        # typo must not kill the stream.
        stream.tenant = str(stream.parameters.get("tenant", "default"))
        requested_class = stream.parameters.get("qos_class")
        if self.qos is not None:
            resolved = self.qos.resolve_class(requested_class,
                                              stream.tenant)
            if requested_class is not None \
                    and str(requested_class) != resolved:
                self.logger.warning(
                    "stream %s: qos_class=%r unknown; using %s",
                    stream_id, requested_class, resolved)
            stream.qos_class = resolved
        elif requested_class is not None:
            stream.qos_class = str(requested_class)
        # Durable journal (ISSUE 13): resolved once per stream; a
        # stream-level ``journal: off`` opts out (one-shot HTTP
        # streams, sub-streams nothing will ever adopt).
        if self.journal is not None:
            stream.journal = str(stream.parameters.get(
                "journal", "on")).strip().lower() \
                not in ("off", "false", "0")
        if self.journal is not None and stream.journal:
            self.journal.stream_open(stream_id, stream.parameters,
                                     graph_path=graph_path,
                                     topic_response=topic_response)
        if grace_time:
            stream.lease = Lease(
                self.runtime.engine, float(grace_time), stream_id,
                expired_handler=self._stream_lease_expired)
        self.streams[stream_id] = stream
        self.ec_producer.update("streams", len(self.streams))

        self._current_stream_ref = stream
        try:
            for node in self._stream_path(stream):
                element = node.element
                if isinstance(element, RemoteStage):
                    self._forward_stream_op(element, "create_stream",
                                            stream, grace_time)
                    continue
                element.compile_element(stream)
                event, diagnostic = element.start_stream(stream, stream_id) \
                    or (StreamEvent.OKAY, {})
                if event == StreamEvent.ERROR:
                    self.logger.error("start_stream %s failed: %s",
                                      node.name, diagnostic)
                    self._destroy_stream_now(stream_id)
                    return None
        finally:
            self._current_stream_ref = None
        stream.state = StreamState.RUN
        return stream

    def _stream_lease_expired(self, lease):
        """A stream's grace lease reaps IDLE streams only.  The
        reference extends its stream lease on every processed frame
        (reference main/pipeline.py:1425 ``stream_lease.extend()``);
        here frames can sit PARKED at async/remote stages for minutes
        with no per-frame tick (a first-frame jit compile of a 1B model
        takes >120 s through a congested link), so the expiry itself
        re-checks: frames in flight, or activity within the last grace
        period, revives the lease instead of destroying mid-work.  A
        frame parked longer than ``_STALL_REAP_FACTOR`` grace periods
        no longer counts as alive -- a remote stage that died without
        replying, or an async element that never calls complete(),
        must not pin the stream (and its swag tensors) forever."""
        stream = self.streams.get(str(lease.lease_uuid))
        if stream is not None:
            now = time.monotonic()
            stall_cap = lease.lease_time * _STALL_REAP_FACTOR
            live_frames = any(now - frame.created < stall_cap
                              for frame in stream.frames.values())
            if live_frames or now - stream.last_frame_time \
                    < lease.lease_time:
                lease.revive()
                return
            if stream.frames:
                self.logger.error(
                    "stream %s: reaping with %d frame(s) parked beyond "
                    "%.0f s (stage never completed)", stream.stream_id,
                    len(stream.frames), stall_cap)
        self.destroy_stream(lease.lease_uuid)

    def _stream_path(self, stream: Stream):
        return self.graph.get_path(stream.graph_path)

    def _forward_stream_op(self, stage: RemoteStage, op: str,
                           stream: Stream, *args):
        if stage.remote_topic_path is None:
            return
        proxy = get_service_proxy(self.runtime, stage.remote_topic_path)
        getattr(proxy, op)(stream.stream_id, *args)

    def destroy_stream(self, stream_id=None, graceful=False):
        graceful = graceful in (True, "True", "true", "1")
        stream_id = str(stream_id or DEFAULT_STREAM_ID)
        stream = self.streams.get(stream_id)
        if stream is None:
            return
        if graceful and stream.in_flight:
            # retry shortly; frames still pending
            self.post_self("destroy_stream", [stream_id, True], delay=0.1)
            return
        self._destroy_stream_now(stream_id)

    def _destroy_stream_now(self, stream_id: str):
        stream = self.streams.pop(stream_id, None)
        if stream is None:
            return
        if stream.state != StreamState.ERROR:
            stream.state = StreamState.STOP
        if stream.lease is not None:
            stream.lease.terminate()
        stream.device_window.clear()    # drop refs without blocking
        # Stage credits held by this stream's in-flight frames go back
        # to the window (and wake other streams' queued frames); queued
        # tokens for dead frames are skipped lazily when popped.
        for frame in list(stream.frames.values()):
            self._qos_done(frame)
            self._release_stage(stream, frame)
        # Completed frames' responses still buffered behind an
        # in-flight predecessor: deliver them (best-effort seq order)
        # rather than dropping finished work -- pre-reorder-buffer
        # behavior responded at completion, and callers count replies.
        for seq in sorted(stream.delivery_pending):
            item = stream.delivery_pending.pop(seq)
            if item is not None:
                done_frame, okay, diagnostic = item
                self._respond(stream, done_frame, okay, diagnostic)
        # Fused segments are stream-owned (their captures/parameters
        # resolved against this stream): release them with it, or the
        # registry pins stale compiled calls (and captured weights)
        # forever under churning streams.
        self.fused_segments = [segment for segment in self.fused_segments
                               if segment.stream_id != stream_id]
        self.share["swag_host_transfers"] = self.transfer_ledger.implicit
        self._current_stream_ref = stream
        try:
            for node in self._stream_path(stream):
                element = node.element
                try:
                    if isinstance(element, RemoteStage):
                        self._forward_stream_op(element, "destroy_stream",
                                                stream)
                    else:
                        element.stop_stream(stream, stream_id)
                except Exception:
                    self.logger.exception("stop_stream %s failed", node.name)
        finally:
            self._current_stream_ref = None
        if self.telemetry is not None:
            # After the release loop above: the spans it buffered for
            # this dead incarnation must not leak onto a recreated
            # same-id stream's frames (ids restart per stream).
            self.telemetry.stream_destroyed(stream_id)
        # Incarnation boundary on the flight-recorder ring: a recreated
        # same-id stream's frame timelines must not merge with this
        # dead incarnation's same-id frames (recorder.frame_events
        # splits at this marker -- the ring itself is append-only).
        self._rec("stream_end", stream_id)
        if self.journal is not None and stream.journal \
                and not self._draining:
            # Graceful destroy leaves nothing to adopt.  A DRAINING
            # pipeline's streams stay OPEN in the journal: their
            # undelivered frames are the handoff.
            self.journal.stream_close(stream_id)
        self.ec_producer.update("streams", len(self.streams))

    # -- process-level fault domain (ISSUE 13) -----------------------------

    def kill(self):
        """Simulate unclean process death for THIS pipeline service
        (the in-process twin of SIGKILL, for chaos tests and the
        ``process_kill`` fault point): publish the retained
        ``(absent)`` the per-service LWT would have sent (the
        registrar reaps the service, peers' discovery fires), stop
        serving every topic and mailbox, and drop all streams with NO
        responses.  The journal is left exactly as the crash left it
        -- that is the artifact a peer adopts."""
        if getattr(self, "_killed", False):
            return
        self._killed = True
        self.logger.warning("pipeline %s: unclean death (kill)",
                            self.name)
        try:
            self.publish_state("(absent)")
        except Exception:
            pass
        engine = self.runtime.engine
        engine.remove_mailbox_handler(self._mailbox_control)
        engine.remove_mailbox_handler(self._mailbox_in)
        self.runtime.remove_message_handler(self._topic_control_handler,
                                            self.topic_control)
        self.runtime.remove_message_handler(self._topic_in_handler,
                                            self.topic_in)
        self._cancel_health_timer()     # autoscale timer included
        if self.gateway is not None:
            self.gateway.stop()
            self.gateway = None
        if self._data_endpoint is not None:
            self._data_endpoint.close()
            self._data_endpoint = None
        for stream in list(self.streams.values()):
            if stream.lease is not None:
                stream.lease.terminate()
            for handle in stream.generator_handles:
                handle.set()
            stream.device_window.clear()
        self.streams.clear()
        if self.stage_scheduler is not None:
            self.stage_scheduler.stop()

    def adopt(self, source=None, response_topic=None,
              adopt_limit=None):
        """Wire/local command: ``(adopt <pipeline-or-journal-path>
        [response_topic])`` -- reconstruct a dead peer's live streams
        from its journal and replay every undelivered frame, in
        order, deduped by the delivered-set (nothing the peer already
        answered is re-sent).  LLM streams resume at their journaled
        committed token prefix.  Exactly one adopter wins the
        journal's claim file; a stream id that already exists locally
        is refused individually.  Bounded by ``adopt_limit`` the way
        replay is by ``replay_limit``.  Returns the number of streams
        adopted."""
        if self.journal is None and not self._journal_dir:
            self.logger.error("adopt: no journal_dir configured")
            return 0
        if self._draining:
            self.logger.warning("adopt: refusing while draining")
            return 0
        source = str(source or "")
        if source.endswith(".journal") or os.sep in source:
            path = source
        else:
            path = os.path.join(self._journal_dir,
                                f"{source}.journal")
        name = os.path.basename(path).rsplit(".journal", 1)[0]
        if self.journal is not None \
                and os.path.abspath(path) == \
                os.path.abspath(self.journal.path):
            self.logger.error("adopt: refusing to adopt my own journal")
            return 0
        if not os.path.exists(path):
            self.logger.warning("adopt: journal %s does not exist",
                                path)
            return 0
        # Read BEFORE claiming: a journal with nothing live to adopt
        # (typically the dead pipeline's supervisor respawned it
        # first, truncating to a fresh incarnation and orphaning the
        # crash state) must not be claimed -- a stale claim on a LIVE
        # pipeline's journal would fence its NEXT death's adoption.
        state = load_journal(path)
        if not state.live_streams():
            self.logger.warning(
                "adopt: journal %s has no live streams (respawned "
                "fresh, drained clean, or empty); nothing to adopt",
                path)
            return 0
        if not claim_adoption(path, self.name):
            # Double adoption would double-replay undelivered frames.
            self.logger.warning(
                "adopt: journal %s already claimed; refusing", path)
            return 0
        state = load_journal(path)
        limit = int(parse_number(adopt_limit, self._adopt_limit))
        adopted = replayed = skipped = 0
        for entry in state.live_streams():
            if entry.stream_id in self.streams:
                self.logger.warning(
                    "adopt: stream %s already live here; refusing it",
                    entry.stream_id)
                continue
            if adopted >= limit:
                skipped += 1
                continue
            # The stream's OWN journaled response topic wins: a direct
            # wire client's replayed results must go back to it, not
            # to the gateway that happened to command the adoption
            # (whose topic is the fallback for queue-based sessions
            # that had no topic to journal).
            topic = entry.topic_response or response_topic
            stream = self.create_stream_local(
                entry.stream_id, parameters=dict(entry.parameters),
                graph_path=entry.graph_path, topic_response=topic)
            if stream is None:
                continue
            adopted += 1
            stream.frame_count = max(
                entry.done_upto + 1,
                (max(entry.frames) + 1) if entry.frames else 0)
            undelivered = entry.undelivered
            self._rec("adopt", entry.stream_id, None, name,
                      info={"frames": len(undelivered)})
            for frame_id, tokens in sorted(entry.llm.items()):
                if not tokens:
                    continue
                self._journal_resume[(entry.stream_id,
                                      int(frame_id))] = list(tokens)
                if self.journal is not None and stream.journal:
                    # The inherited prefix becomes durable HERE, so a
                    # second failover resumes from the same place.
                    self.journal.llm_tokens(entry.stream_id, frame_id,
                                            tokens)
            for frame_id in undelivered:
                record = entry.frames[frame_id]
                try:
                    data = decode_payload(record.get("data"))
                except Exception as error:
                    self.logger.warning(
                        "adopt: stream %s frame %s payload "
                        "undecodable (%s); dropped", entry.stream_id,
                        frame_id, error)
                    continue
                replayed += 1
                # The journaled trace_id rides the replay: the frame's
                # spans on THIS pipeline continue the original door-to-
                # decode trace across the process kill.
                self._ingest({"stream_id": entry.stream_id,
                              "frame_id": frame_id,
                              "response_topic": topic,
                              "trace_id": record.get("tid")}, data)
        self._streams_adopted += adopted
        self._frames_journal_replayed += replayed
        self.share["streams_adopted"] = self._streams_adopted
        self.share["frames_journal_replayed"] = \
            self._frames_journal_replayed
        if self.telemetry is not None and adopted:
            self.telemetry.registry.count("streams_adopted", adopted)
            self.telemetry.registry.count("frames_journal_replayed",
                                          replayed)
        self.logger.info(
            "adopted %d stream(s) / %d frame(s) from %s%s", adopted,
            replayed, name,
            f" ({skipped} past adopt_limit)" if skipped else "")
        return adopted

    def drain(self, *_args):
        """Wire/CLI command: cooperative shutdown with zero frame
        drop.  Admission stops (frames arriving from now on are
        journaled and PARKED for the adopter, never run), in-flight
        LLM requests are migrated at their committed prefix (their
        tokens are already journaled; the element cancels them and
        drops the parked frames without responding), in-flight plain
        frames get ``drain_timeout_ms`` to finish normally, then the
        journal is marked cleanly drained and the service announces
        its death -- the same LWT path an unclean kill takes, so the
        gateway's failover machinery hands the sessions to a peer
        that adopts the journal.  Rolling restarts are this, per
        pipeline, in sequence."""
        if self._draining:
            return
        self._draining = True
        self._rec("drain", None, info={"phase": "start"})
        self.logger.info("pipeline %s: draining (timeout %.0f ms)",
                         self.name, self._drain_timeout_ms)
        for node in self.graph.nodes():
            drainer = getattr(node.element, "drain_requests", None)
            if callable(drainer):
                try:
                    drainer()
                except Exception:
                    self.logger.exception("drain_requests failed for "
                                          "%s", node.name)
        self._drain_deadline = time.monotonic() \
            + self._drain_timeout_ms / 1000.0
        self.post_self("drain_tick", [])

    def drain_tick(self):
        """Drain progress check (self-posted): in-flight frames get
        until the deadline; whatever is still parked then is handed
        to the adopter through the journal."""
        if not self._draining or self._drained:
            return
        busy = sum(len(stream.frames)
                   for stream in self.streams.values())
        if busy and time.monotonic() < self._drain_deadline:
            self.post_self("drain_tick", [], delay=0.02)
            return
        self._drain_finish(busy)

    def _drain_finish(self, leftover: int) -> None:
        for stream in list(self.streams.values()):
            for frame in list(stream.frames.values()):
                # Parked past the deadline: parked for adoption.  No
                # response -- the adopter's replay is the response.
                stream.frames.pop(frame.frame_id, None)
                self._qos_done(frame)
                self._release_stage(stream, frame)
        if self.journal is not None:
            self.journal.mark_drained()
        self._drained = True
        self._rec("drain", None, info={"phase": "done",
                                       "leftover": leftover})
        self.logger.info("pipeline %s: drained (%d frame(s) parked "
                         "for adoption)", self.name, leftover)
        try:
            self.publish_state("(absent)")
        except Exception:
            pass
        # Retirement GRACE, not immediate stop: until the gateway's
        # settle window elapses and its sessions re-bind, frames
        # already in flight toward this pipeline keep arriving -- each
        # must still ingest (journal + hold, the ``_draining`` path)
        # so the adopter's journal read includes it.  Retiring the
        # mailbox inside that window would drop exactly the frames the
        # zero-drop contract promises to keep.
        self.runtime.engine.add_oneshot_timer(self._retire_after_drain,
                                              _DRAIN_RETIRE_GRACE_S)

    def _retire_after_drain(self):
        # The share marker is the process-exit signal (``pipeline
        # create`` runs until it): set AFTER the grace, so a
        # supervisor cannot reap the process while stragglers are
        # still being journaled.
        self.share["drained"] = True
        try:
            self.ec_producer.update("drained", True)
        except Exception:
            pass
        try:
            self.stop()
        except Exception:
            self.logger.exception("post-drain stop failed")

    def take_journal_resume(self, stream_id, frame_id) -> list | None:
        """Adopted LLM committed prefix for (stream, frame), consumed
        exactly once by the serving element."""
        return self._journal_resume.pop(
            (str(stream_id), int(frame_id)), None)

    def current_frame(self) -> Frame | None:
        """The frame whose element dispatch is running on the event
        loop right now (async submit seam) -- lets an element key
        per-frame engine state (journal resume) without a signature
        change."""
        return self._current_frame_ref

    def failover_stats(self) -> dict:
        return {
            "journal": None if self.journal is None
            else self.journal.stats(),
            "draining": self._draining, "drained": self._drained,
            "streams_adopted": self._streams_adopted,
            "frames_journal_replayed": self._frames_journal_replayed,
            "resume_pending": len(self._journal_resume)}

    # -- frame ingestion ---------------------------------------------------

    def process_frame(self, stream_dict=None, frame_data=None):
        """Wire command: ``(process_frame (stream_id: X ...) (k: v ...))``.
        Values arrive as strings/encoded blobs; decode and run.  A
        ``pipe_token`` header means the frame's tensors rode the
        binary data plane: claim them from the endpoint (deferring the
        envelope when they are still in TCP flight) and merge them in
        -- zero base64, zero host copy beyond the socket read."""
        stream_dict = dict(stream_dict or {})
        frame_data = dict(frame_data or {})
        claimed = self._claim_for_ingest(stream_dict, frame_data)
        if claimed is None:
            return              # deferred / held / dropped
        frame_data = decode_frame_data(frame_data)
        if claimed:
            frame_data.update(self._upload_claimed(
                stream_dict.get("stream_id", DEFAULT_STREAM_ID),
                claimed))
        self._ingest(stream_dict, frame_data)

    def process_frame_local(self, frame_data: dict,
                            stream_id=DEFAULT_STREAM_ID,
                            queue_response=None,
                            frame_id=None, trace_id=None,
                            trace_parent=None) -> None:
        """In-process API: no encoding, swag values pass by reference.
        Thread-safe (hops through the actor mailbox).  An explicit
        ``frame_id`` lets a session-owning caller (the gateway) keep
        one frame-id space across pipeline failovers, so delivery
        dedupe works no matter which peer answers.  ``trace_id`` /
        ``trace_parent`` let a door-owning caller (the gateway) root
        this frame's spans under ITS trace instead of minting a new
        one -- the in-process twin of the wire header's trace fields."""
        self.post_self("ingest_local",
                       [str(stream_id), frame_data, queue_response,
                        frame_id, trace_id, trace_parent])

    def ingest_local(self, stream_id, frame_data, queue_response=None,
                     frame_id=None, trace_id=None, trace_parent=None):
        stream = self.streams.get(str(stream_id))
        if stream is None:
            stream = self.create_stream_local(stream_id,
                                              queue_response=queue_response)
            if stream is None:
                return
        elif queue_response is not None:
            stream.queue_response = queue_response
        if frame_id is None:
            frame_id = stream.next_frame_id()
        else:
            frame_id = int(frame_id)
            stream.frame_count = max(stream.frame_count, frame_id + 1)
        frame = Frame(frame_id=frame_id, swag=dict(frame_data))
        if self.telemetry is not None:
            self.telemetry.frame_started(frame, trace_id=trace_id,
                                         parent_id=trace_parent)
        self._rec("ingest", stream.stream_id, frame.frame_id)
        self._stamp_qos(stream, frame)
        shed = self._shed_for_overload(stream) \
            or self._qos_shed_for_overload(stream, frame)
        self._assign_delivery_seq(stream, frame)
        stream.frames[frame.frame_id] = frame
        self._journal_ingest(stream, frame)
        if self._draining:
            self._hold_for_drain(stream, frame)
            return
        if self._faults is not None \
                and self._process_fault_probe(stream, frame):
            return
        if shed:
            self._shed_incoming(stream, frame)
            return
        self._stamp_deadline(stream, frame)
        # Bounded dispatch window: before this frame's device work
        # enqueues, sync the oldest completed-but-unsynced frame(s) so
        # dispatch stays at most device_inflight frames ahead
        # (per-class caps apply -- QoS plane 1).
        paced = stream.device_window.pace(self._device_limit(stream))
        if paced:
            self._note_pace(stream, frame, paced)
        self._process_frame_common(stream, frame)

    def _ingest(self, stream_dict: dict, frame_data: dict):
        stream_id = str(stream_dict.get("stream_id", DEFAULT_STREAM_ID))
        stream = self.streams.get(stream_id)
        if stream is None:
            stream = self.create_stream_local(stream_id)
            if stream is None:
                return
        frame_id = parse_number(stream_dict.get("frame_id"), None)
        if frame_id is None:
            frame_id = stream.next_frame_id()
        frame = Frame(frame_id=int(frame_id), swag=dict(frame_data))
        frame.response_topic = stream_dict.get("response_topic")
        # The origin's tensor-pipe endpoint, when it advertises one:
        # this process ships the response's tensors back over it.
        frame.pipe_reply = stream_dict.get("pipe_reply")
        if self.telemetry is not None:
            # A forwarded frame carries its origin's trace context: the
            # spans stamped here join THAT trace (and ride back in the
            # response) instead of starting a new one.
            self.telemetry.frame_started(
                frame, trace_id=stream_dict.get("trace_id"),
                parent_id=stream_dict.get("trace_parent"))
        stale = stream.frames.get(frame.frame_id)
        if stale is not None:
            # A wire caller re-ingested a live frame id: the replaced
            # frame's delivery slot (and stage credit) must not wedge
            # the stream's reorder buffer / admission window.
            self._qos_done(stale)
            self._release_stage(stream, stale)
            self._deliver(stream, stale, okay=False, skip=True)
        self._rec("ingest", stream.stream_id, frame.frame_id)
        self._stamp_qos(stream, frame)
        shed = self._shed_for_overload(stream) \
            or self._qos_shed_for_overload(stream, frame)
        self._assign_delivery_seq(stream, frame)
        stream.frames[frame.frame_id] = frame
        self._journal_ingest(stream, frame)
        if self._draining:
            self._hold_for_drain(stream, frame)
            return
        if self._faults is not None \
                and self._process_fault_probe(stream, frame):
            return
        if shed:
            self._shed_incoming(stream, frame)
            return
        self._stamp_deadline(stream, frame)
        paced = stream.device_window.pace(self._device_limit(stream))
        if paced:
            self._note_pace(stream, frame, paced)
        self._process_frame_common(stream, frame)

    # -- process fault domain (ISSUE 13) -----------------------------------

    def _journal_ingest(self, stream: Stream, frame: Frame) -> None:
        """Journal commit point: the frame's host-visible inputs, so a
        peer can replay it if this process dies before delivery."""
        if self.journal is None or not stream.journal:
            return
        lag = self.journal.frame_ingested(stream.stream_id,
                                          frame.frame_id, frame.swag,
                                          trace_id=frame.trace_id)
        if lag >= 256:
            # The fsync backlog grew a whole batch window deep --
            # frames in it are past the durability horizon if the host
            # (not just the process) dies.  Ring-logged, throttled.
            now = time.monotonic()
            if now - self._journal_lag_noted > 1.0:
                self._journal_lag_noted = now
                self._rec("journal_lag", stream.stream_id,
                          frame.frame_id, info={"pending": lag})

    def _hold_for_drain(self, stream: Stream, frame: Frame) -> None:
        """A frame ingested while draining is journaled but never run:
        it is parked for the adopter, which replays it -- zero drop,
        no duplicate (nothing was delivered from here).  A frame with
        NO journal behind it (journal off, or a journal-off stream
        like the gateway's one-shots) has no adopter to park for:
        failing it loudly beats swallowing it into a client timeout."""
        if self.journal is None or not stream.journal:
            self._frame_fail(stream, frame,
                             "draining: no journal to hand off")
            return
        stream.frames.pop(frame.frame_id, None)
        self._qos_done(frame)
        # Consume the delivery slot silently so any in-flight
        # predecessors still flush their real responses in order.
        self._deliver(stream, frame, okay=False, skip=True)

    def _process_fault_probe(self, stream: Stream,
                             frame: Frame) -> bool:
        """Armed-chaos seam for the process-level fault points
        (tier-1's in-process realization; the multi-process driver
        uses real signals).  Returns True when the frame must not be
        processed (the process "died" -- the journaled frame replays
        on the adopter)."""
        rule = self._faults.should("process_kill", target=self.name,
                                   stream=stream.stream_id)
        if rule is not None:
            self.logger.warning("chaos: process_kill fired at %s; "
                                "dying uncleanly", self.name)
            self.kill()
            return True
        rule = self._faults.should("process_hang", target=self.name,
                                   stream=stream.stream_id)
        if rule is not None and rule.delay_ms:
            # The whole event loop stalls: parked frames age, peers'
            # deadlines fire -- exactly what a wedged process does.
            time.sleep(rule.delay_ms / 1000.0)
        return False

    def _note_pace(self, stream: Stream, frame: Frame,
                   paced: float) -> None:
        """Ingest blocked on the dispatch window: stamp the frame (the
        ``pacing`` critical-path bucket), the histogram and the ring."""
        paced_ms = paced * 1000.0
        frame.metrics["ingest_pace_ms"] = paced_ms
        if self.telemetry is not None:
            self.telemetry.registry.observe("ingest_pace_ms", paced_ms)
        self._rec("pace", stream.stream_id, frame.frame_id,
                  ms=paced_ms)

    def _note_fetch(self, stream: Stream, frame: Frame, name: str,
                    fetch_ms: float) -> None:
        """An engine-initiated counted ledger fetch ran for ``frame``
        on behalf of element ``name``: accumulate the ``fetch``
        critical-path bucket (``<name>_fetch_ms``) and the ring event.
        Loop-confined (every engine fetch site runs on the loop)."""
        if fetch_ms <= 0.0:
            return
        key = f"{name}_fetch_ms"
        frame.metrics[key] = frame.metrics.get(key, 0.0) + fetch_ms
        self._rec("fetch", stream.stream_id, frame.frame_id, name,
                  fetch_ms)

    def _assign_delivery_seq(self, stream: Stream, frame: Frame) -> None:
        """Under stage-parallel execution frames complete out of walk
        order; responses are re-ordered to ingest order (_deliver)."""
        if self.stage_scheduler is not None:
            frame.delivery_seq = stream.delivery_count
            stream.delivery_count += 1

    # -- the hot loop ------------------------------------------------------

    def _process_frame_common(self, stream: Stream, frame: Frame,
                              nodes=None, fuse=False):
        if stream.state not in (StreamState.START, StreamState.RUN):
            # The stream died while this frame was parked/queued: give
            # its stage credit back (the scheduler window is
            # pipeline-global -- leaking here would wedge EVERY stream
            # at that stage) and consume its delivery slot.
            stream.frames.pop(frame.frame_id, None)
            self._qos_done(frame)
            self._release_stage(stream, frame)
            self._deliver(stream, frame, okay=False, skip=True)
            return
        if self._past_deadline(frame):
            # Every walk entry and resume continuation passes through
            # here, so this one check enforces the deadline at ingest,
            # stage-hop and park-resume boundaries alike.
            self._deadline_fail(stream, frame)
            return
        stream.last_frame_time = time.monotonic()   # grace lease clock
        self.run_hook("pipeline.process_frame:0",
                      lambda: {"stream": stream.stream_id,
                               "frame": frame.frame_id})
        # Fusion applies to full-path walks and to resume continuations
        # that re-enter at a segment BOUNDARY (async/remote parks --
        # those elements never join a segment, so the suffix partitions
        # cleanly).  The retry paths pass fuse=False and execute
        # per-element: a frame must never resume into the middle of a
        # fused segment with half its outputs already mapped.
        fuse = fuse or nodes is None
        if nodes is None:
            nodes = self._stream_path(stream)
        frame.metrics.setdefault("time_pipeline_start", time.perf_counter())
        self._current_stream_ref = stream
        swag = frame.swag
        try:
            entries = self._fusion_entries(stream, nodes) if fuse \
                else list(nodes)
            index = 0
            while index < len(entries):
                entry = entries[index]
                if isinstance(entry, FusedSegment):
                    if entry.broken:
                        # Poisoned (build/trace failed earlier): splice
                        # the members back in permanently -- ``entries``
                        # IS the cached plan, so later frames skip the
                        # segment without re-failing.
                        entries[index:index + 1] = entry.nodes
                        continue
                    if self.stage_scheduler is not None \
                            and entry.stage_context is not None:
                        # Stage-local segment under stage-parallel
                        # execution: ONE dispatch on the stage's worker
                        # thread; the frame parks and the loop is free
                        # to walk other frames' stages meanwhile.
                        # ALWAYS via the worker (even when the frame no
                        # longer holds the stage credit, e.g. resumed
                        # past an in-stage async park): the single
                        # worker is what serializes the segment's
                        # unsynchronized JitCache across frames.
                        # Returns None (frame errored at resolve) or
                        # True (parked); either way this walk is done.
                        self._submit_stage_segment(stream, frame, entry)
                        return
                    outcome = self._run_fused_segment(stream, frame,
                                                      entry)
                    if outcome is None:
                        return        # frame errored (and responded)
                    if outcome is False:
                        entries[index:index + 1] = entry.nodes
                        continue      # fall back to per-element
                    index += 1
                    continue
                node = entry
                if self.stage_scheduler is not None \
                        and frame.stage != node.name \
                        and node.name in self.stage_placement.plans:
                    # Placed stage boundary: admission (credit window)
                    # and the rest of the walk happen on a fresh
                    # mailbox turn, so frame k+1's upstream stage work
                    # interleaves with frame k's downstream stage.
                    # ``stage_waiting`` marks the one in-flight
                    # admission post and the post carries the Frame
                    # object; enter_stage_frame discards any post that
                    # doesn't match both (duplicates, stale posts and
                    # queued tokens from a destroyed same-id stream).
                    frame.stage_waiting = node.name
                    frame.stage_wait_start = time.perf_counter()
                    # Aging clock for the QoS rank: how long THIS wait
                    # has lasted, not time since ingest -- a frame that
                    # just crossed a stage hasn't been starving.
                    frame.qos_wait_start = time.monotonic()
                    self._rec("stage_wait", stream.stream_id,
                              frame.frame_id, node.name)
                    self.post_self("enter_stage_frame",
                                   [stream.stream_id, frame.frame_id,
                                    node.name, False, frame])
                    return
                element = node.element
                if isinstance(element, RemoteStage):
                    # Leaving placed-stage-land: a frame parked at (or
                    # retrying discovery of) a remote stage must not
                    # pin its last placed stage's admission credit for
                    # the whole round trip -- a slow remote would wedge
                    # the window for every stream.
                    self._release_stage(stream, frame)
                    breaker = self._stage_breaker(node.name)
                    if breaker is not None and not breaker.allow():
                        # Open breaker: don't touch the wire.  Run the
                        # declared fallback element (degraded mode) or
                        # fail the FRAME fast -- the stream stays
                        # alive, and a later frame probes half-open.
                        ran = self._run_fallback(stream, frame, node)
                        if ran is None:
                            return        # frame errored in fallback
                        if ran:
                            index += 1
                            continue
                        if self.telemetry is not None:
                            self.telemetry.registry.count(
                                "breaker_rejects", stage=node.name)
                        self._rec("breaker_reject", stream.stream_id,
                                  frame.frame_id, node.name)
                        self._frame_fail(
                            stream, frame,
                            f"remote stage {node.name}: circuit "
                            f"breaker open")
                        return
                    if self._forward_frame(stream, frame, node):
                        frame.remote_retries = 0
                        return            # frame parked at remote stage
                    # Remote undiscovered yet: retry FROM THIS NODE --
                    # elements before it already ran and must not run
                    # again (their effects are in the swag).  The frame
                    # STAYS in stream.frames so graceful destroy_stream
                    # counts it as in-flight.  Exponential backoff with
                    # a cap (a fixed short retry forever is a silent
                    # hot loop), BOUNDED by ``remote_retry_limit``
                    # (0 = forever) so a permanently missing remote
                    # errors with a clear message instead of parking
                    # the frame for eternity, and a counted share
                    # metric so a missing remote stage is VISIBLE.
                    retry_limit = int(parse_number(
                        stream.parameters.get(
                            "remote_retry_limit",
                            self._pipeline_parameters.get(
                                "remote_retry_limit")),
                        REMOTE_RETRY_LIMIT_DEFAULT))
                    if retry_limit and frame.remote_retries \
                            >= retry_limit:
                        self._frame_error(
                            stream, frame,
                            f"remote stage {node.name} undiscovered "
                            f"after {frame.remote_retries} retries "
                            f"(remote_retry_limit={retry_limit}); "
                            f"is the remote pipeline running?")
                        return
                    delay = min(
                        _REMOTE_RETRY_BASE * (2 ** frame.remote_retries),
                        _REMOTE_RETRY_CAP)
                    frame.remote_retries += 1
                    frame.metrics["remote_retries"] = frame.remote_retries
                    self._remote_retries += 1
                    self.share["remote_stage_retries"] = \
                        self._remote_retries
                    if frame.remote_retries in (4, 8) \
                            or frame.remote_retries % 16 == 0:
                        self.logger.warning(
                            "stream %s frame %s: remote stage %s still "
                            "undiscovered after %d retries (next in "
                            "%.2f s)", stream.stream_id, frame.frame_id,
                            node.name, frame.remote_retries, delay)
                    self.post_self("retry_frame_at",
                                   [stream.stream_id, frame, node.name],
                                   delay=delay)
                    return
                inputs, missing, host_typed = self._map_in(node, swag,
                                                           frame=frame,
                                                           stream=stream)
                if missing:
                    self._frame_error(
                        stream, frame,
                        f"{node.name}: missing inputs {missing}")
                    return
                remote_outputs = None
                if self.stage_placement is not None \
                        and node.name in self.stage_placement.plans:
                    # Stage hop: reshard this stage's inputs onto its
                    # submesh (device-to-device over ICI; skipped per
                    # leaf when already resident there).  device_put is
                    # async -- the copy overlaps the upstream stage's
                    # next-frame compute; only the dispatch cost lands
                    # on the loop.  Host-typed inputs stay host-side --
                    # re-uploading what _map_in just fetched would undo
                    # the contract.
                    hop_start = time.perf_counter()
                    if self.stage_placement.across_hosts:
                        # A real multi-host mesh: the hop runs over the
                        # process group, and a stage of another process
                        # yields handles to its outputs here.
                        try:
                            moved, remote_outputs = \
                                self.stage_placement.hop_across(
                                    node, frame, inputs, host_typed,
                                    stream.stream_id)
                        except (ValueError, RuntimeError) as error:
                            self._frame_error(stream, frame,
                                              f"{node.name}: {error}")
                            return
                        inputs.update(moved)
                    else:
                        inputs.update(self.stage_placement.transfer(
                            {name: value for name, value in inputs.items()
                             if name not in host_typed}, node.name,
                            replica=frame.stage_replica
                            if frame.stage == node.name else None))
                    hop_ms = (time.perf_counter() - hop_start) * 1000.0
                    frame.metrics[f"{node.name}_hop_ms"] = hop_ms
                    self._rec("hop", stream.stream_id, frame.frame_id,
                              node.name, hop_ms)
                    self.run_hook("pipeline.stage_hop:0",
                                  lambda: {"stage": node.name,
                                           "stream": stream.stream_id,
                                           "frame": frame.frame_id,
                                           "ms": hop_ms})
                if remote_outputs is not None:
                    self._map_out(node, frame, remote_outputs)
                    index += 1
                    continue
                self.run_hook("pipeline.process_element:0",
                              lambda: {"element": node.name,
                                       "stream": stream.stream_id,
                                       "frame": frame.frame_id})
                if element.frame_is_async(stream):
                    self._submit_frame_async(stream, frame, node, inputs)
                    return        # frame parked at local async stage
                if self.stage_scheduler is not None \
                        and frame.stage == node.name:
                    # Synchronous placed-stage head under stage-parallel
                    # execution: run it on the stage's worker thread so
                    # the event loop keeps walking other frames while
                    # this stage's chips work -- cross-stage pipelining
                    # of plain synchronous elements.
                    self._submit_stage_frame(stream, frame, node, inputs)
                    return        # frame parked on the stage worker
                start = time.perf_counter()
                # Absolute start stamp: with overlapped frames, element
                # spans interleave across frames -- durations alone
                # cannot show (or test) that k+1's first element began
                # before k's last completed.
                frame.metrics[f"{node.name}_time_start"] = start
                self._rec("dispatch", stream.stream_id, frame.frame_id,
                          node.name)
                if _METRICS_MEMORY:
                    rss_before = process_memory_rss()
                ledger = self.transfer_ledger
                try:
                    if self._faults is not None:
                        self._inject_element_fault(node.name,
                                                   stream.stream_id)
                    if element.device_resident and ledger.active:
                        # Device elements run under the transfer guard:
                        # an implicit device->host sync inside one is a
                        # contract violation, not business as usual.
                        with ledger.guard():
                            result = element.process_frame(stream,
                                                           **inputs)
                    else:
                        result = element.process_frame(stream, **inputs)
                except Exception as error:
                    if ledger.is_guard_error(error):
                        ledger.record_implicit()
                    self.logger.exception("element %s raised", node.name)
                    self._rec("dispatch_done", stream.stream_id,
                              frame.frame_id, node.name,
                              (time.perf_counter() - start) * 1000.0,
                              {"status": "error"})
                    self._element_post_error(stream, frame, node.name,
                                             start)
                    if self._recover_after_dispatch_error(stream, frame):
                        return      # chips died: frame replayed/bounded
                    self._frame_error(stream, frame,
                                      f"{node.name}: {error}")
                    return
                frame.metrics[f"{node.name}_time"] = \
                    time.perf_counter() - start
                self._rec("dispatch_done", stream.stream_id,
                          frame.frame_id, node.name,
                          frame.metrics[f"{node.name}_time"] * 1000.0)
                if element.device_resident:
                    frame.metrics["device_dispatches"] = \
                        frame.metrics.get("device_dispatches", 0) + 1
                if _METRICS_MEMORY:
                    frame.metrics[f"{node.name}_memory"] = \
                        process_memory_rss() - rss_before
                event, outputs = result if isinstance(result, tuple) \
                    else (result, {})
                outputs = outputs or {}
                if ledger.active and outputs and not \
                        self._check_residency(stream, frame, node,
                                              element, outputs):
                    self._element_post_error(stream, frame, node.name,
                                             start)
                    return
                self.run_hook("pipeline.process_element_post:0",
                              lambda: {"element": node.name,
                                       "stream": stream.stream_id,
                                       "frame": frame.frame_id,
                                       "event": event,
                                       "time":
                                       frame.metrics[f"{node.name}_time"]})

                if event == StreamEvent.OKAY and isinstance(
                        element, PipelineElementLoop):
                    self._map_out(node, frame, outputs)
                    loop_start, found = element.get_parameter("loop_start")
                    if not found or loop_start not in self.graph:
                        self._frame_error(
                            stream, frame,
                            f"{node.name}: bad loop_start {loop_start!r}")
                        return
                    nodes = self.graph.get_path(loop_start)
                    entries = self._fusion_entries(stream, nodes) \
                        if fuse else list(nodes)
                    index = 0
                    continue
                if event in (StreamEvent.OKAY, StreamEvent.LOOP_END):
                    self._map_out(node, frame, outputs)
                    index += 1
                    continue
                if event == StreamEvent.DROP_FRAME:
                    frame.metrics["dropped"] = True
                    break
                if event == StreamEvent.STOP:
                    self._map_out(node, frame, outputs)
                    stream.state = StreamState.STOP
                    break
                if event == StreamEvent.ERROR:
                    diagnostic = outputs.get("diagnostic", "") \
                        if isinstance(outputs, dict) else ""
                    self._frame_error(stream, frame,
                                      f"{node.name}: {diagnostic}")
                    return
                self._frame_error(stream, frame,
                                  f"{node.name}: bad event {event!r}")
                return
            self._frame_done(stream, frame, nodes)
        finally:
            self._current_stream_ref = None

    # -- fused device segments (pipeline/fusion.py) ------------------------

    def _fusion_entries(self, stream: Stream, nodes) -> list:
        """The stream's fused execution plan for ``nodes``: Nodes and
        FusedSegments, partitioned once per path and memoized on the
        stream (``fuse: off`` short-circuits to the plain node list)."""
        if stream.fuse == "off":
            return list(nodes)
        key = tuple(node.name for node in nodes)
        plan = stream.fusion_plans.get(key)
        if plan is None:
            plan = partition(self, nodes, stream)
            stream.fusion_plans[key] = plan
            fused = [e for e in plan if isinstance(e, FusedSegment)]
            if fused:
                self.logger.info(
                    "stream %s: fused %d segment(s): %s",
                    stream.stream_id, len(fused),
                    ", ".join(s.name for s in fused))
        return plan

    def _segment_begin(self, stream: Stream, frame: Frame,
                       segment: FusedSegment):
        """Shared dispatch preamble for the inline and stage-worker
        segment paths: resolve inputs, pick donations, probe the
        compile, stamp spans, fire the enter hook.  Returns
        (resolved, donated, compiling, start), or None when the frame
        was errored on missing inputs."""
        resolved, missing = segment.resolve(frame.swag)
        if missing:
            self._frame_error(stream, frame,
                              f"{segment.name}: missing inputs {missing}")
            return None
        donated = segment.donate_keys(resolved, frame.swag,
                                      frame.produced)
        compiling = segment.would_compile(
            resolved, donated,
            replica=self._frame_replica_for(frame, segment))
        start = time.perf_counter()
        for node in segment.nodes:
            frame.metrics[f"{node.name}_time_start"] = start
        self.run_hook("pipeline.process_segment:0",
                      lambda: {"segment": segment.name,
                               "elements": [n.name for n in segment.nodes],
                               "stream": stream.stream_id,
                               "frame": frame.frame_id,
                               "compile": compiling})
        return resolved, donated, compiling, start

    @staticmethod
    def _frame_replica_for(frame: Frame, segment) -> int | None:
        """The replica submesh a stage-local segment dispatch belongs
        to: the frame's admitted replica when it holds the segment's
        stage credit, else None.  Keys the segment's JitCache per
        replica -- jax re-specializes executables per sharding, so
        replica A's warm signature is still a cold compile on replica
        B and the probe/poison logic must see it that way."""
        if segment.stage_context is not None \
                and frame.stage == segment.stage_context:
            return frame.stage_replica
        return None

    def _run_fused_segment(self, stream: Stream, frame: Frame,
                           segment: FusedSegment):
        """Execute a whole segment as ONE device dispatch.  Returns True
        on success, None when the frame was errored, False to fall back
        to per-element execution (first-call build/trace failure -- the
        segment is poisoned so later frames skip it outright)."""
        begun = self._segment_begin(stream, frame, segment)
        if begun is None:
            return None
        resolved, donated, compiling, start = begun
        ledger = self.transfer_ledger

        def post_hook(event):
            self.run_hook("pipeline.process_segment_post:0",
                          lambda: {"segment": segment.name,
                                   "stream": stream.stream_id,
                                   "frame": frame.frame_id,
                                   "event": event,
                                   "compile": compiling,
                                   "time": time.perf_counter() - start})

        self._rec("dispatch", stream.stream_id, frame.frame_id,
                  segment.name, info={"kind": "segment",
                                      "compile": compiling})
        try:
            if self._faults is not None:
                self._inject_segment_fault(segment.name,
                                           stream.stream_id)
            replica = self._frame_replica_for(frame, segment)
            if ledger.active:
                # The whole segment is device-element event-loop work:
                # one guard scope around the single dispatch.
                with ledger.guard():
                    out = segment.call(resolved, donated,
                                       replica=replica)
            else:
                out = segment.call(resolved, donated, replica=replica)
        except Exception as error:
            if ledger.is_guard_error(error):
                ledger.record_implicit()
            self._rec("dispatch_done", stream.stream_id,
                      frame.frame_id, segment.name,
                      (time.perf_counter() - start) * 1000.0,
                      {"status": "error"})
            post_hook(StreamEvent.ERROR)
            if compiling:
                # Build/trace failure on a fresh signature: the fused
                # path is an optimization, per-element execution is
                # ground truth -- poison and fall back (a genuine data
                # error will resurface there with a per-element
                # diagnostic).
                self.logger.exception(
                    "segment %s: trace/compile failed; falling back to "
                    "per-element execution", segment.name)
                segment.poison(f"trace/compile failed: {error}")
                return False
            self.logger.exception("segment %s raised", segment.name)
            if self._recover_after_dispatch_error(stream, frame):
                return None     # chips died: frame replayed/bounded
            self._frame_error(stream, frame, f"{segment.name}: {error}")
            return None
        elapsed = time.perf_counter() - start
        self._rec("dispatch_done", stream.stream_id, frame.frame_id,
                  segment.name, elapsed * 1000.0)
        return self._segment_finish(stream, frame, segment, out,
                                    resolved, donated, post_hook,
                                    elapsed)

    def _segment_finish(self, stream: Stream, frame: Frame,
                        segment: FusedSegment, out: dict, resolved: dict,
                        donated: set, post_hook, elapsed: float):
        """Map a completed segment dispatch out into the swag (shared by
        the inline path and the stage-worker continuation).  Returns
        True, or None when the frame was errored."""
        swag = frame.swag
        ledger = self.transfer_ledger
        # Donated buffers are dead: drop the stale qualified aliases
        # before map-out rewrites the bare keys, so nothing in the swag
        # can reach an invalidated buffer (DeviceWindow syncs swag
        # leaves at completion).
        for key in donated:
            swag.pop(f"{frame.produced[key]}.{key}", None)
        try:
            for step in segment.steps:
                outputs = {}
                for name in step.dfn.outputs:
                    outputs[name] = out[f"{step.node.name}.{name}"]
                for name, (kind, key) in step.pass_map.items():
                    outputs[name] = out[key] if kind == "trace" \
                        else resolved.get(key)
                if step.dfn.finalize is not None:
                    # The element's host postprocess: ONE counted fetch
                    # of its device slate at the segment boundary.
                    fetch_start = time.perf_counter()
                    fetched = ledger.fetch(
                        {name: out[f"{step.node.name}.{name}"]
                         for name in step.dfn.finalize_inputs})
                    self._note_fetch(
                        stream, frame, step.node.name,
                        (time.perf_counter() - fetch_start) * 1000.0)
                    outputs.update(step.dfn.finalize(fetched))
                self._map_out(step.node, frame, outputs)
                frame.metrics[f"{step.node.name}_time"] = 0.0
        except Exception as error:
            post_hook(StreamEvent.ERROR)
            self.logger.exception("segment %s map-out failed",
                                  segment.name)
            self._frame_error(stream, frame, f"{segment.name}: {error}")
            return None
        # The single dispatch's wall time lands on the tail element (so
        # per-element p50 keys stay populated); the members carry 0.0.
        frame.metrics[f"{segment.nodes[-1].name}_time"] = elapsed
        frame.metrics["fused_segments"] = \
            frame.metrics.get("fused_segments", 0) + 1
        frame.metrics["fused_elements"] = \
            frame.metrics.get("fused_elements", 0) + len(segment.nodes)
        frame.metrics["device_dispatches"] = \
            frame.metrics.get("device_dispatches", 0) + 1
        post_hook(StreamEvent.OKAY)
        return True

    # -- stage-parallel execution (pipeline/stages.py) ---------------------

    def enter_stage_frame(self, stream_id, frame_id, node_name,
                          from_queue=False, frame_ref=None):
        """Continuation: admit a frame into a placed stage's credit
        window and resume its walk at the stage head.  When the window
        is full the frame queues FIFO (still holding its PREVIOUS
        stage's credit, so backpressure propagates upstream) and is
        re-posted by the releasing frame; a popped waiter whose credit
        was stolen by an interleaving admission requeues at the FRONT,
        preserving queue (and per-stream frame) order."""
        stream = self.streams.get(str(stream_id))
        frame = stream.frames.get(int(frame_id)) \
            if stream is not None else None
        if frame is None or frame.paused_pe_name is not None \
                or frame.stage_waiting != node_name \
                or (frame_ref is not None and frame is not frame_ref):
            # Dead/stale/duplicate post: the frame vanished while
            # queued, was already admitted by an earlier post, or a
            # destroyed stream's post/token matched a RECREATED
            # stream's same-id frame (the Frame identity check catches
            # that even when the new frame waits for the same stage).
            # Acting on it would re-run elements or admit a frame out
            # of order; hand the slot (and any reservation the popped
            # token carried) to the next waiter so the queue never
            # starves.
            if from_queue and self.stage_scheduler is not None:
                self.stage_scheduler.cancel_reservation(node_name)
            self._pump_stage(node_name)
            return
        if self._past_deadline(frame):
            # Deadline enforcement at the admission boundary: an
            # expired frame must not take a stage credit.  Its own
            # reservation (when popped from the queue) goes back, and
            # the next waiter gets a chance at the freed capacity.
            if from_queue and self.stage_scheduler is not None:
                self.stage_scheduler.cancel_reservation(node_name)
            self._deadline_fail(stream, frame)
            self._pump_stage(node_name)
            return
        scheduler = self.stage_scheduler
        if scheduler is not None and frame.stage != node_name:
            group = scheduler.groups.get(node_name)
            if group is not None and group.all_dead():
                # Every replica dead and no rebuild yet: failing the
                # frame beats queueing it forever behind a stage that
                # cannot admit.
                if from_queue:
                    scheduler.cancel_reservation(node_name)
                self._frame_fail(stream, frame,
                                 f"stage {node_name}: all replicas "
                                 f"dead (awaiting rebuild)")
                return
            if group is not None:
                # QoS plane 3: latency-sensitive classes take the
                # least-loaded live replica instead of the cursor's
                # round-robin next.
                replica = scheduler.admit_replica(
                    node_name, reserved=bool(from_queue),
                    least_loaded=self.qos is not None
                    and self.qos.latency_sensitive(frame.qos_class))
                admitted = replica is not None
            else:
                replica = None
                admitted = scheduler.try_admit(node_name,
                                               reserved=bool(from_queue))
            if not admitted:
                scheduler.enqueue(node_name,
                                  [str(stream_id), int(frame_id),
                                   node_name, True, frame],
                                  front=bool(from_queue))
                return
            frame.stage_waiting = None
            self._release_stage(stream, frame)
            frame.stage = node_name
            frame.stage_replica = replica
            self._rec("admit", stream.stream_id, frame.frame_id,
                      node_name, info=None if replica is None
                      else {"replica": replica})
            if replica is not None:
                frame.metrics[f"stage_{node_name}_replica"] = replica
            frame.stage_generation = \
                self.stage_placement.generation \
                if self.stage_placement is not None else 0
            frame.metrics[f"stage_{node_name}_admit"] = \
                time.perf_counter()
            if frame.stage_wait_start is not None:
                # Admission wait: how long the frame sat behind the
                # stage's credit window (the telemetry plane rolls
                # these into the stage_admission_wait_ms histogram).
                frame.metrics[f"stage_{node_name}_wait_ms"] = \
                    (time.perf_counter() - frame.stage_wait_start) \
                    * 1000.0
                frame.stage_wait_start = None
            # Which placement generation this admission ran under --
            # the replace() test (and post-mortems) read it to prove a
            # frame re-entered on fresh submeshes, not a stale mesh.
            frame.metrics[f"stage_{node_name}_generation"] = \
                frame.stage_generation
            self.run_hook("pipeline.process_stage:0",
                          lambda: {"stage": node_name,
                                   "stream": stream.stream_id,
                                   "frame": frame.frame_id,
                                   "generation": frame.stage_generation})
            if self._faults is not None:
                rule = self._faults.should("stage_stall",
                                           target=node_name,
                                           stream=stream.stream_id)
                if rule is not None:
                    scheduler.executor(node_name, frame.stage_replica) \
                        .stall(rule.delay_ms / 1000.0)
        if not self._resume_walk_at(stream, frame, node_name, fuse=True):
            self._frame_error(
                stream, frame,
                f"enter_stage_frame: unknown node {node_name}")

    def _resume_walk_at(self, stream: Stream, frame: Frame,
                        node_name: str, fuse: bool) -> bool:
        """Resume a frame's walk at ``node_name`` on its stream path
        (stage admission, segment fallback, remote retry all land
        here).  Returns False when the node is not on the path -- the
        caller decides whether that errors the frame."""
        path = self._stream_path(stream)
        for index, node in enumerate(path):
            if node.name == node_name:
                self._process_frame_common(stream, frame,
                                           nodes=path[index:], fuse=fuse)
                return True
        return False

    def _release_stage(self, stream: Stream, frame: Frame,
                       ok: bool | None = True) -> None:
        """Return the frame's stage credit (next-stage admission, async
        park, completion, error, stream teardown) and wake the next
        queued frame.  For a replicated stage the credit goes back to
        the replica that admitted the frame, and ``ok`` carries the
        canary verdict: a half-open slot's canary frame succeeding
        closes the slot live, failing re-kills it, ``None`` (an
        administrative replay) leaves it half-open awaiting a real
        canary."""
        stage, frame.stage = frame.stage, None
        replica, frame.stage_replica = frame.stage_replica, None
        if ok is not True and stage is not None \
                and stage in frame.completed:
            # The frame failed AFTER this stage's head completed
            # (deadline while queued downstream, a later stage's
            # error): that is not this replica's verdict -- a half-open
            # slot whose canary ran the stage successfully closes live
            # even if the frame dies elsewhere.
            ok = True
        # A released frame is no longer waiting anywhere: its queued
        # token (if any) must read as stale when popped.
        frame.stage_waiting = None
        if stage is None or self.stage_scheduler is None:
            return
        admit = frame.metrics.get(f"stage_{stage}_admit")
        if admit is not None:
            frame.metrics[f"stage_{stage}_ms"] = \
                (time.perf_counter() - admit) * 1000.0
        self._rec("release", stream.stream_id, frame.frame_id, stage,
                  info=None if replica is None
                  else {"replica": replica})
        self.run_hook("pipeline.process_stage_post:0",
                      lambda: {"stage": stage,
                               "stream": stream.stream_id,
                               "frame": frame.frame_id,
                               "ms": frame.metrics.get(
                                   f"stage_{stage}_ms", 0.0)})
        waiter = self.stage_scheduler.release(stage, replica=replica,
                                              ok=ok)
        if waiter is not None:
            self.post_self("enter_stage_frame", list(waiter))

    def _pump_stage(self, stage: str) -> None:
        scheduler = self.stage_scheduler
        if scheduler is None:
            return
        waiter = scheduler.next_waiter(stage)
        if waiter is not None:
            self.post_self("enter_stage_frame", list(waiter))

    def _submit_stage_frame(self, stream: Stream, frame: Frame, node,
                            inputs: dict) -> None:
        """Run a synchronous placed-stage head element on the stage's
        worker thread: the frame parks exactly like an async stage and
        resumes through the mailbox, so while this stage's chips work
        on frame k the event loop walks frame k+1 into the upstream
        stage.  The single worker per stage keeps per-stream order."""
        element = node.element
        frame.paused_pe_name = node.name
        stream_id, frame_id = stream.stream_id, frame.frame_id
        node_name = node.name
        replica = frame.stage_replica   # replicated-stage submesh pick
        epoch = frame.replay_epoch      # stale after a replay
        submitted = time.perf_counter()
        frame.metrics[f"{node_name}_time_start"] = submitted
        self._rec("submit", stream_id, frame_id, node_name)
        if element.device_resident:
            frame.metrics["device_dispatches"] = \
                frame.metrics.get("device_dispatches", 0) + 1
        ledger = self.transfer_ledger

        def job():
            start = time.perf_counter()
            self._rec("dispatch", stream_id, frame_id, node_name,
                      info=None if replica is None
                      else {"replica": replica})
            _THREAD_STREAM.stream = stream
            # While this worker runs, ``self.plan`` on the stage's
            # elements IS the replica's submesh (tensor.TPUElement).
            _THREAD_STREAM.replica = None if replica is None \
                else (node_name, replica)
            try:
                if self._faults is not None:
                    self._inject_element_fault(node_name, stream_id)
                if element.device_resident and ledger.active:
                    with ledger.guard():
                        result = element.process_frame(stream, **inputs)
                else:
                    result = element.process_frame(stream, **inputs)
                event, outputs = result if isinstance(result, tuple) \
                    else (result, {})
                outputs = outputs or {}
            except Exception as error:
                if ledger.is_guard_error(error):
                    ledger.record_implicit()
                self.logger.exception(
                    "element %s raised (stage worker)", node_name)
                event, outputs = StreamEvent.ERROR, \
                    {"diagnostic": str(error)}
            finally:
                _THREAD_STREAM.stream = None
                _THREAD_STREAM.replica = None
            elapsed = time.perf_counter() - start
            self._rec("dispatch_done", stream_id, frame_id, node_name,
                      elapsed * 1000.0,
                      None if event != StreamEvent.ERROR
                      else {"status": "error"})
            self.post_self("resume_stage_frame",
                           [stream_id, frame_id, node_name, event,
                            outputs, start, elapsed, submitted,
                            frame, epoch])

        self.stage_scheduler.executor(node_name, replica).submit(job)

    def resume_stage_frame(self, stream_id, frame_id, node_name, event,
                           outputs, exec_start, elapsed, submitted,
                           frame_ref, epoch=None):
        """Continuation: a stage worker finished a synchronous placed
        element.  The post carries the Frame OBJECT it executed for: a
        stale post from a destroyed stream must never resume a
        recreated same-id stream's same-id frame (ids restart at 0).
        Re-stamps the span to the ACTUAL execution window (overlap
        assertions read ``*_time_start``) and records the queue window
        -- the time the frame's hop rode along behind the previous
        frame's stage compute."""
        stream = self.streams.get(str(stream_id))
        if stream is None:
            return
        frame = stream.frames.get(int(frame_id))
        if frame is not frame_ref:
            return              # stale post from a prior incarnation
        if frame is not None \
                and epoch is not None and epoch != frame.replay_epoch:
            return              # pre-replay attempt: results are void
        if frame is not None and frame.paused_pe_name == node_name:
            frame.metrics[f"{node_name}_time_start"] = exec_start
            frame.metrics[f"{node_name}_queue_ms"] = \
                (exec_start - submitted) * 1000.0
        self.resume_frame_local(stream_id, frame_id, node_name, event,
                                outputs, elapsed, frame_ref)

    def _submit_stage_segment(self, stream: Stream, frame: Frame,
                              segment: FusedSegment):
        """Dispatch a stage-local fused segment on its stage's worker
        thread.  Returns True (parked), or None (frame errored at
        resolve)."""
        begun = self._segment_begin(stream, frame, segment)
        if begun is None:
            return None
        resolved, donated, _compiling, _submitted = begun
        frame.paused_pe_name = segment.name
        stream_id, frame_id = stream.stream_id, frame.frame_id
        self._rec("submit", stream_id, frame_id, segment.name)
        replica = self._frame_replica_for(frame, segment)
        epoch = frame.replay_epoch      # stale after a replay
        ledger = self.transfer_ledger

        def job():
            start = time.perf_counter()
            self._rec("dispatch", stream_id, frame_id, segment.name,
                      info={"kind": "segment"} if replica is None
                      else {"kind": "segment", "replica": replica})
            _THREAD_STREAM.stream = stream
            _THREAD_STREAM.replica = None if replica is None \
                else (segment.stage_context, replica)
            out, diagnostic = None, ""
            # Re-probe on the worker, where this segment's dispatches
            # are serialized: the loop-side probe goes stale when an
            # earlier frame's job is still compiling this signature
            # (window depth >= 2), and a stale True would let a
            # transient data error permanently poison the segment.
            compile_now = segment.would_compile(resolved, donated,
                                                replica=replica)
            try:
                if self._faults is not None:
                    self._inject_segment_fault(segment.name, stream_id)
                if ledger.active:
                    with ledger.guard():
                        out = segment.call(resolved, donated,
                                           replica=replica)
                else:
                    out = segment.call(resolved, donated,
                                       replica=replica)
            except Exception as error:
                if ledger.is_guard_error(error):
                    ledger.record_implicit()
                self.logger.exception(
                    "segment %s raised (stage worker)", segment.name)
                diagnostic = str(error)
            finally:
                _THREAD_STREAM.stream = None
                _THREAD_STREAM.replica = None
            elapsed = time.perf_counter() - start
            self._rec("dispatch_done", stream_id, frame_id,
                      segment.name, elapsed * 1000.0,
                      None if out is not None else {"status": "error"})
            self.post_self("resume_stage_segment",
                           [stream_id, frame_id, segment, out,
                            diagnostic, resolved, donated, compile_now,
                            start, elapsed, frame, epoch])

        self.stage_scheduler.executor(segment.stage_context,
                                      replica).submit(job)
        return True

    def resume_stage_segment(self, stream_id, frame_id, segment, out,
                             diagnostic, resolved, donated, compiling,
                             exec_start, elapsed, frame_ref,
                             epoch=None):
        """Continuation: a stage worker finished (or failed) a fused
        segment dispatch; map out and keep walking after the segment.
        Frame identity is validated (like resume_stage_frame) so stale
        posts from a destroyed same-id stream are discarded."""
        stream = self.streams.get(str(stream_id))
        frame = stream.frames.get(int(frame_id)) \
            if stream is not None else None
        if frame is None or frame is not frame_ref \
                or frame.paused_pe_name != segment.name:
            return
        if epoch is not None and epoch != frame.replay_epoch:
            return              # pre-replay attempt: results are void
        frame.paused_pe_name = None
        for node in segment.nodes:
            frame.metrics[f"{node.name}_time_start"] = exec_start

        def post_hook(event):
            self.run_hook("pipeline.process_segment_post:0",
                          lambda: {"segment": segment.name,
                                   "stream": stream.stream_id,
                                   "frame": frame.frame_id,
                                   "event": event,
                                   "compile": compiling,
                                   "time":
                                   time.perf_counter() - exec_start})

        if out is None:
            post_hook(StreamEvent.ERROR)
            if compiling:
                # First-signature trace/compile failure: poison the
                # segment and replay per-element -- the cached plan
                # splices broken segments on the next walk.
                self.logger.error(
                    "segment %s: stage-worker trace/compile failed; "
                    "falling back to per-element execution",
                    segment.name)
                segment.poison(f"stage-worker trace/compile failed: "
                               f"{diagnostic}")
                if self._resume_walk_at(stream, frame,
                                        segment.nodes[0].name,
                                        fuse=True):
                    return
            if self._recover_after_dispatch_error(stream, frame):
                return          # chips died: frame replayed/bounded
            self._frame_error(stream, frame,
                              f"{segment.name}: {diagnostic}")
            return
        if self._segment_finish(stream, frame, segment, out, resolved,
                                donated, post_hook, elapsed) is None:
            return
        nodes = self.graph.iterate_after(segment.nodes[-1].name,
                                         stream.graph_path)
        self._process_frame_common(stream, frame, nodes=nodes, fuse=True)

    # -- local async stage park / submit / resume --------------------------

    def _submit_frame_async(self, stream: Stream, frame: Frame, node,
                            inputs: dict) -> None:
        """Park the frame at a local async stage and hand it the inputs.
        The element calls ``complete(event, outputs)`` exactly once
        (from any thread); the frame resumes downstream via the actor
        mailbox -- the in-process twin of ``_forward_frame`` for remote
        stages, realizing dataflow over an async accelerator: detect of
        frame k+1 runs while the LLM decodes frame k, and a batching
        element sees requests from many frames/streams at once."""
        frame.paused_pe_name = node.name
        stream_id, frame_id = stream.stream_id, frame.frame_id
        node_name = node.name
        epoch = frame.replay_epoch      # stale after a replay
        start = time.perf_counter()
        frame.metrics[f"{node_name}_time_start"] = start
        self._rec("park", stream_id, frame_id, node_name,
                  info={"kind": "async"})
        if node.element.device_resident:
            frame.metrics["device_dispatches"] = \
                frame.metrics.get("device_dispatches", 0) + 1
        state = {"done": False}
        state_lock = threading.Lock()   # complete() may race itself
                                        # across threads; the resume
                                        # post must fire exactly once

        def complete(event, outputs=None):
            with state_lock:
                if state["done"]:
                    return              # double completion: ignore
                state["done"] = True
            self.post_self("resume_frame_local",
                           [stream_id, frame_id, node_name, event,
                            outputs or {},
                            time.perf_counter() - start, frame, epoch])

        ledger = self.transfer_ledger
        self._current_frame_ref = frame     # current_frame() for the
        try:                                # submit's element code
            if self._faults is not None:
                self._inject_element_fault(node_name, stream_id)
            if node.element.device_resident and ledger.active:
                # The submit path is device-element event-loop work
                # too: an implicit host sync here blocks every stream.
                with ledger.guard():
                    node.element.process_frame_start(stream, complete,
                                                     **inputs)
            else:
                node.element.process_frame_start(stream, complete,
                                                 **inputs)
            if frame.stage is not None:
                # Async elements own their admission discipline
                # (MicroBatcher max_batch, batcher slots) -- whether
                # the park is the stage head itself or an unplaced
                # async element deeper in the stage: holding the credit
                # through the park would cap cross-frame batching at
                # the window depth.
                self._release_stage(stream, frame)
        except Exception as error:
            if ledger.is_guard_error(error):
                ledger.record_implicit()
            self.logger.exception("element %s submit raised", node_name)
            with state_lock:
                state["done"] = True    # a late complete() must not win
            frame.paused_pe_name = None
            self._element_post_error(stream, frame, node_name, start)
            if self._recover_after_dispatch_error(stream, frame):
                return          # chips died: frame replayed/bounded
            self._frame_error(stream, frame, f"{node_name}: {error}")
        finally:
            self._current_frame_ref = None

    def resume_frame_local(self, stream_id, frame_id, node_name,
                           event, outputs, elapsed, frame_ref=None,
                           epoch=None):
        """Continuation: a parked async LOCAL stage completed (the local
        analogue of ``process_frame_response``).  ``frame_ref`` (when
        the poster holds the Frame object) guards against a stale
        completion resuming a REPLACEMENT frame parked at the same
        (stream_id, frame_id, node) -- e.g. after a wire re-ingest of a
        live frame id."""
        stream = self.streams.get(str(stream_id))
        if stream is None:
            return                      # stream destroyed while parked
        frame = stream.frames.get(int(frame_id))
        if frame is None or frame.paused_pe_name != node_name:
            return
        if frame_ref is not None and frame is not frame_ref:
            return                      # stale post: frame was replaced
        if epoch is not None and epoch != frame.replay_epoch:
            return                      # pre-replay attempt: void
        frame.paused_pe_name = None
        frame.metrics[f"{node_name}_time"] = elapsed
        started = frame.metrics.get(f"{node_name}_time_start")
        if started is not None:
            # Resume lag: the element finished at started + elapsed;
            # the continuation then waited for the event loop.  That is
            # queue time (critical-path bucket) -- without it the
            # attribution misses exactly the loop-contention the
            # recorder's event timeline shows.  Accumulates with the
            # worker-queue stamp (same key) on the stage-worker path.
            lag_ms = (time.perf_counter() - started - elapsed) * 1000.0
            if lag_ms > 0.0:
                key = f"{node_name}_queue_ms"
                frame.metrics[key] = frame.metrics.get(key, 0.0) \
                    + lag_ms
        self._rec("resume", stream.stream_id, frame.frame_id,
                  node_name, elapsed * 1000.0)
        self.run_hook("pipeline.process_element_post:0",
                      lambda: {"element": node_name,
                               "stream": stream.stream_id,
                               "frame": frame.frame_id,
                               "event": event, "time": elapsed})
        outputs = outputs if isinstance(outputs, dict) else {}
        node = self.graph.get_node(node_name)
        if self.transfer_ledger.active and outputs and not \
                self._check_residency(stream, frame, node, node.element,
                                      outputs):
            return
        if event in (StreamEvent.OKAY, StreamEvent.LOOP_END):
            self._map_out(node, frame, outputs)
            nodes = self.graph.iterate_after(node_name, stream.graph_path)
            # The async park site is a partition boundary, so the
            # suffix re-enters the fused plan: device chains AFTER an
            # async stage still run as single dispatches.
            self._process_frame_common(stream, frame, nodes=nodes,
                                       fuse=True)
            return
        if event == StreamEvent.DROP_FRAME:
            frame.metrics["dropped"] = True
            self._frame_done(stream, frame, None)
            return
        if event == StreamEvent.STOP:
            self._map_out(node, frame, outputs)
            stream.state = StreamState.STOP
            self._frame_done(stream, frame, None)
            return
        diagnostic = outputs.get("diagnostic", "") \
            if event == StreamEvent.ERROR else f"bad event {event!r}"
        if event == StreamEvent.ERROR \
                and self._recover_after_dispatch_error(stream, frame):
            return              # chips died: frame replayed/bounded
        self._frame_error(stream, frame, f"{node_name}: {diagnostic}")

    def _readmit_frame(self, stream: Stream, frame: Frame) -> bool:
        """Re-register a retried/replayed frame with the stream.  A
        DIFFERENT live frame under the same id means this retry is
        stale (the stream was destroyed and recreated while the
        delayed post was pending) -- acting on it would corrupt the new
        incarnation.  A frame the stream no longer tracks re-enters
        with a FRESH delivery sequence: its old slot belongs to a dead
        incarnation's reorder buffer."""
        existing = stream.frames.get(frame.frame_id)
        if existing is not None:
            return existing is frame
        frame.delivery_seq = None
        self._assign_delivery_seq(stream, frame)
        stream.frames[frame.frame_id] = frame
        return True

    def retry_frame(self, stream_id, frame: Frame):
        stream = self.streams.get(str(stream_id))
        if stream is None:
            return
        if not self._readmit_frame(stream, frame):
            return
        # Replays run per-element (explicit node list): a prior attempt
        # may have fused -- and donated -- its way through this swag, so
        # the retry must not assume segment inputs still exist as the
        # partitioner saw them.
        self._process_frame_common(stream, frame,
                                   nodes=self._stream_path(stream))

    def retry_frame_at(self, stream_id, frame: Frame, node_name: str):
        """Resume a frame at ``node_name`` (used when a remote stage was
        not yet discovered): earlier elements are not re-executed."""
        stream = self.streams.get(str(stream_id))
        if stream is None:
            return
        if not self._readmit_frame(stream, frame):
            return
        # fuse=False: replays walk per-element (see retry_frame).
        if not self._resume_walk_at(stream, frame, node_name,
                                    fuse=False):
            self._frame_error(
                stream, frame,
                f"retry_frame_at: unknown node {node_name}")

    # -- name mapping ------------------------------------------------------

    def _map_in(self, node, swag: dict, frame: Frame | None = None,
                stream: Stream | None = None) -> tuple[dict, list, list]:
        """Returns (inputs, missing, host_typed): the host-typed names
        were materialized host-side and must stay there -- a placement
        transfer re-uploading them would undo the contract."""
        return self._map_in_for(node.element, node.properties or {},
                                swag, frame=frame, stream=stream)

    def _map_in_for(self, element, mapping: dict, swag: dict,
                    frame: Frame | None = None,
                    stream: Stream | None = None) \
            -> tuple[dict, list, list]:
        """`_map_in` against an explicit (element, mapping) pair -- the
        graph path shares it with breaker fallbacks, whose element is
        off-graph but resolves inputs through the remote node's
        mapping.  ``frame`` (when given) takes the host-typed fetch's
        cost as a ``fetch`` critical-path stamp."""
        inputs, missing, host_typed = {}, [], []
        host_inputs = element.host_inputs
        for io in (element.definition.input if element.definition else []):
            name = io["name"]
            key = mapping.get(name, name)
            if key in swag:
                inputs[name] = swag[key]
                if name in host_inputs or \
                        str(io.get("type", "")).rstrip("?") == "host":
                    host_typed.append(name)
            elif io.get("type", "").endswith("?") or "default" in io:
                inputs[name] = io.get("default")
            else:
                missing.append(name)
        if host_typed:
            # Explicitly host-typed inputs: THE sanctioned spot where
            # device-resident swag values reach the host mid-graph --
            # ONE counted fetch for all of them together, not an
            # implicit sync inside the element.
            fetch_start = time.perf_counter()
            inputs.update(self.transfer_ledger.fetch(
                {name: inputs[name] for name in host_typed}))
            if frame is not None and stream is not None:
                self._note_fetch(
                    stream, frame, element.name,
                    (time.perf_counter() - fetch_start) * 1000.0)
        return inputs, missing, host_typed

    def _element_post_error(self, stream: Stream, frame: Frame,
                            node_name: str, start: float):
        """Pair the enter hook on element-failure paths, so hook
        consumers (the profiler's open spans, recorders) never see an
        unmatched enter -- a dangling TraceAnnotation would nest the
        whole remaining trace under the dead element."""
        self.run_hook("pipeline.process_element_post:0",
                      lambda: {"element": node_name,
                               "stream": stream.stream_id,
                               "frame": frame.frame_id,
                               "event": StreamEvent.ERROR,
                               "time": time.perf_counter() - start})

    def _check_residency(self, stream: Stream, frame: Frame, node,
                         element, outputs: dict) -> bool:
        """Software half of the transfer guard (effective on backends
        where device->host is zero-copy and the jax guard cannot fire):
        declared-``tensor`` outputs must still be device-resident.
        Returns False when the frame was errored (policy disallow)."""
        if not element.device_resident:
            return True
        violations = self.transfer_ledger.residency_violations(element,
                                                               outputs)
        if not violations:
            return True
        self.transfer_ledger.record_implicit(len(violations))
        if self.transfer_ledger.policy == "disallow":
            self._frame_error(
                stream, frame,
                f"{node.name}: device outputs fetched to host: "
                f"{violations} (transfer_guard=disallow)")
            return False
        self.logger.warning("%s: device outputs fetched to host: %s",
                            node.name, violations)
        return True

    @staticmethod
    def _map_out(node, frame: Frame, outputs: dict):
        swag = frame.swag
        for name, value in outputs.items():
            swag[name] = value
            swag[f"{node.name}.{name}"] = value
            # Provenance for fused-segment donation: only values an
            # element of THIS frame produced are ever donatable.
            frame.produced[name] = node.name
        # Replay frontier (ISSUE 5): outputs accepted -> this element
        # never re-executes when the frame replays across a device
        # replacement.
        frame.completed.add(node.name)

    # -- completion / errors / responses ----------------------------------

    def _frame_done(self, stream: Stream, frame: Frame, nodes):
        if self._past_deadline(frame):
            # Deadline enforcement at delivery: the work finished, but
            # late IS wrong under an SLO -- the slot carries a deadline
            # error, not a stale result.
            self._deadline_fail(stream, frame)
            return
        frame.metrics["time_pipeline"] = (
            time.perf_counter() - frame.metrics["time_pipeline_start"])
        stream.last_frame_time = time.monotonic()   # grace lease clock
        stream.frames.pop(frame.frame_id, None)
        self._qos_done(frame)
        self._rec("done", stream.stream_id, frame.frame_id,
                  ms=frame.metrics["time_pipeline"] * 1000.0,
                  info={"ok": True})
        self._release_stage(stream, frame)
        self._record_stage_costs(frame)
        # The frame COMPLETES without a host sync: its device leaves may
        # still be computing (async dispatch).  Note them so ingest
        # pacing bounds how far dispatch runs ahead of compute.
        stream.device_window.note(frame.frame_id, frame.swag)
        self._frames_processed += 1
        self.share["frames_processed"] = self._frames_processed
        # Compiled-call + fusion accounting on the share dict (the
        # transfer_stats()-style surface the dashboard and bench read).
        # Totals only -- plain attribute sums, no per-element breakdown
        # dicts on the per-frame completion path (jit_stats() builds
        # those on demand).
        hits = misses = entries = dispatches = 0
        for node in self.graph.nodes():
            cache = getattr(node.element, "jit_cache", None)
            if cache is not None:
                hits += cache.hits
                misses += cache.misses
                entries += cache.entries
        for segment in self.fused_segments:
            cache = segment.jit_cache
            hits += cache.hits
            misses += cache.misses
            entries += cache.entries
            dispatches += segment.calls
        self.share["jit_cache_hits"] = hits
        self.share["jit_cache_misses"] = misses
        self.share["jit_cache_entries"] = entries
        self.share["fused_segments"] = len(self.fused_segments)
        self.share["fused_dispatches"] = dispatches
        if self.telemetry is not None:
            # BEFORE delivery: the root span (and any remote spans)
            # must be on frame.spans when _respond encodes them back
            # to a forwarding origin.
            self.telemetry.frame_finished(stream, frame, okay=True)
        dropped = bool(frame.metrics.get("dropped"))
        if dropped and not self._draining \
                and self.journal is not None and stream.journal:
            # A dropped frame is CONSUMED: prune it, or it stays
            # 'undelivered' forever -- wedging the done_upto
            # watermark, growing the journal unboundedly, and
            # replaying every historically dropped frame on adoption.
            # EXCEPT while draining: the LLM drain migration drops
            # its parked frames precisely so the adopter replays them.
            self.journal.frame_done(stream.stream_id, frame.frame_id,
                                    ok=True)
        self._deliver(stream, frame, okay=True, skip=dropped)
        if stream.state == StreamState.STOP:
            self.post_self("destroy_stream", [stream.stream_id, True])

    def _record_stage_costs(self, frame: Frame) -> None:
        """Feed the placement's cost profile from the frame's measured
        stage-head element spans, so ``devices: auto`` splits track the
        workload (and re-balance at the next replace())."""
        placement = self.stage_placement
        if placement is None:
            return
        for stage in placement.plans:
            if stage not in self.graph:
                continue
            if self.graph.get_node(stage).element.is_async:
                # An async head's span is completion-minus-submit --
                # batch/queue wait included, which GROWS under load and
                # would steer the auto split toward the waiting stage.
                continue
            elapsed = frame.metrics.get(f"{stage}_time")
            if elapsed:
                placement.record_cost(stage, float(elapsed))

    def _deliver(self, stream: Stream, frame: Frame, okay: bool,
                 diagnostic: str = "", skip: bool = False) -> None:
        """In-order per-stream delivery: under stage-parallel execution
        frames complete out of ingest order (per-stage workers, async
        stages), so responses buffer until every predecessor responded.
        ``skip`` consumes the sequence slot without responding (dropped
        frames)."""
        seq = frame.delivery_seq
        if seq is None:
            if not skip:
                self._respond(stream, frame, okay, diagnostic)
            return
        stream.delivery_pending[seq] = \
            None if skip else (frame, okay, diagnostic)
        self._flush_delivery(stream)

    def _flush_delivery(self, stream: Stream) -> None:
        while stream.delivery_next in stream.delivery_pending:
            item = stream.delivery_pending.pop(stream.delivery_next)
            stream.delivery_next += 1
            if item is not None:
                pending_frame, okay, diagnostic = item
                self._respond(stream, pending_frame, okay, diagnostic)

    def _frame_error(self, stream: Stream, frame: Frame, diagnostic: str):
        """Fatal frame failure: the stream enters ERROR and tears down
        (reference semantics -- an element error poisons the stream)."""
        self.logger.error("stream %s frame %s: %s",
                          stream.stream_id, frame.frame_id, diagnostic)
        self._blackbox("stream_error", stream.stream_id,
                       frame.frame_id, detail=diagnostic)
        self._finish_failed_frame(stream, frame, diagnostic)
        stream.state = StreamState.ERROR
        self.post_self("destroy_stream", [stream.stream_id])

    def _frame_fail(self, stream: Stream, frame: Frame, diagnostic: str):
        """Per-frame failure on a HEALTHY stream (deadline miss,
        overload shed, open circuit breaker): the frame delivers an
        error in its reorder slot, the stream keeps running.  This is
        the load-shedding contract -- an SLO miss must not amplify into
        a stream teardown."""
        self.logger.warning("stream %s frame %s: %s",
                            stream.stream_id, frame.frame_id, diagnostic)
        self._finish_failed_frame(stream, frame, diagnostic)

    def _finish_failed_frame(self, stream: Stream, frame: Frame,
                             diagnostic: str):
        stream.frames.pop(frame.frame_id, None)
        self._qos_done(frame)
        self._rec("done", stream.stream_id, frame.frame_id,
                  info={"ok": False, "error": str(diagnostic)[:200]})
        # ok=False: when the failed frame was a half-open replica's
        # canary, its failure is the verdict -- the slot re-kills
        # instead of re-admitting a replica that still cannot serve.
        self._release_stage(stream, frame, ok=False)
        if self.telemetry is not None:
            self.telemetry.frame_finished(stream, frame, okay=False)
        if frame.delivery_seq is not None:
            # Deliver the error IN its slot so already-completed
            # successors' buffered okay-responses flush behind it
            # instead of being dropped; whatever stays gapped (a
            # predecessor still in flight) drains at destroy.
            stream.delivery_pending[frame.delivery_seq] = \
                (frame, False, diagnostic)
            self._flush_delivery(stream)
        else:
            self._respond(stream, frame, okay=False,
                          diagnostic=diagnostic)

    def _respond(self, stream: Stream, frame: Frame, okay: bool,
                 diagnostic: str = ""):
        if frame.response_topic:
            bare_swag = {k: v for k, v in frame.swag.items()
                         if "." not in k}
            # Process boundary: THE sink where device-resident swag
            # values are fetched -- one explicit counted device_get for
            # the whole response, then the host-side codec.
            bare_swag = self.transfer_ledger.fetch(bare_swag)
            header = {"stream_id": stream.stream_id,
                      "frame_id": frame.frame_id,
                      "okay": okay, "diagnostic": diagnostic}
            if frame.trace_remote and frame.spans:
                # Forwarded frame: return this process's spans so the
                # ORIGIN reconstructs the whole distributed trace.
                header["spans"] = encode_spans(frame.spans)
            # Response tensors ride the origin's pipe when it
            # advertised one (pipe_reply header); failures re-inline
            # them into the MQTT payload, counted.
            # Site key is the PEER endpoint, not the stream id: the
            # once-per-site fallback log (and its dedup set) must stay
            # bounded under thousands of short streams.
            body, pipe_bytes = (bare_swag, None) \
                if self._data_plane_mode == "mqtt" or not okay \
                else self._pipe_ship(frame.pipe_reply, bare_swag,
                                     header,
                                     f"response to "
                                     f"{frame.pipe_reply or 'origin'}")
            payload = generate("process_frame_response",
                               [header, encode_frame_data(body)])
            self.runtime.message.publish(frame.response_topic, payload)
            self._count_plane(pipe_bytes, len(payload))
        if stream.queue_response is not None:
            # Snapshot: queue consumers read from other threads, and
            # the live dict must stay loop-confined (see Frame.metrics).
            stream.queue_response.put(
                (stream.stream_id, frame.frame_id,
                 dict(frame.swag), dict(frame.metrics), okay,
                 diagnostic))
        if self.journal is not None and stream.journal:
            # Delivery is the journal's prune point -- appended AFTER
            # the send, deliberately: a crash between the two turns
            # into a duplicate replay the gateway's seq dedupe drops,
            # where the reverse order would be a silent loss (marked
            # delivered, never sent, excluded from replay).
            self.journal.frame_done(stream.stream_id, frame.frame_id,
                                    ok=okay)

    # -- remote stage park / forward / resume ------------------------------

    def _forward_frame(self, stream: Stream, frame: Frame, node,
                       force_mqtt: bool = False) -> bool:
        stage: RemoteStage = node.element
        if stage.remote_topic_path is None:
            return False
        frame.paused_pe_name = node.name
        inputs, _, _ = self._map_in(node, frame.swag, frame=frame,
                                    stream=stream)
        # Forward ALL mapped inputs; the remote pipeline maps what it needs.
        # Process boundary: explicit single fetch before the host codec.
        fetch_start = time.perf_counter()
        forwarded = self.transfer_ledger.fetch(
            inputs if inputs else {
                k: v for k, v in frame.swag.items() if "." not in k})
        self._note_fetch(stream, frame, node.name,
                         (time.perf_counter() - fetch_start) * 1000.0)
        header = {"stream_id": stream.stream_id,
                  "frame_id": frame.frame_id,
                  "response_topic": self.topic_in}
        if self._data_endpoint is not None:
            # Advertise our endpoint so the response's tensors come
            # back over the pipe too (the peer negotiates down to MQTT
            # when it cannot, or when this send's twin fails there).
            header["pipe_reply"] = self._data_endpoint.location
        if self.telemetry is not None and frame.trace_id is not None:
            # Trace context rides the hop: the remote pipeline stamps
            # its spans under this hop span's id and returns them in
            # the response, so one trace_id covers both processes.  A
            # RE-forward (remote lost mid-park, frame replayed) reuses
            # the still-open hop span rather than leaking it.
            if frame.remote_span is None \
                    or frame.remote_span[0] != node.name:
                frame.remote_span = (node.name, mint_id(), time.time())
            header["trace_id"] = frame.trace_id
            header["trace_parent"] = frame.remote_span[1]
        # Data plane (ISSUE 9): tensors over the peer's advertised
        # pipe, control envelope (+ token) on MQTT; any pipe problem
        # re-inlines the tensors into the MQTT payload -- the frame
        # always goes out exactly once.
        body, pipe_bytes = (forwarded, None) \
            if force_mqtt or self._data_plane_mode == "mqtt" \
            else self._pipe_ship(stage.remote_pipe, forwarded, header,
                                 f"forward to {node.name}")
        payload = generate("process_frame",
                           [header, encode_frame_data(body)])
        self.runtime.message.publish(f"{stage.remote_topic_path}/in",
                                     payload)
        self._count_plane(pipe_bytes, len(payload))
        self._rec("forward", stream.stream_id, frame.frame_id,
                  node.name,
                  info={"path": "mqtt" if pipe_bytes is None
                        else "pipe"})
        return True

    def process_frame_response(self, stream_dict=None, frame_data=None):
        """Continuation: a parked frame's remote outputs arrived
        (reference pipeline.py:1218-1221,1452-1455).  A ``pipe_token``
        header means the output tensors rode the binary data plane:
        claim them (deferring until they land, dropping after the
        claim timeout -- the parked frame then recovers through its
        deadline/breaker exactly as for a dropped response)."""
        stream_dict = dict(stream_dict or {})
        stream_id = str(stream_dict.get("stream_id", DEFAULT_STREAM_ID))
        stream = self.streams.get(stream_id)
        if stream is None:
            return
        pipe_claimed = self._claim_pipe_response(stream_dict,
                                                 dict(frame_data or {}))
        if pipe_claimed is None:
            return              # deferred behind the watch, or dropped
        frame_id = int(parse_number(stream_dict.get("frame_id"), -1))
        frame = stream.frames.get(frame_id)
        if frame is None or frame.paused_pe_name is None:
            return
        if frame.paused_pe_name not in self.graph or not isinstance(
                self.graph.get_node(frame.paused_pe_name).element,
                RemoteStage):
            # Duplicate or late response (wire_dup fault, MQTT QoS1
            # redelivery): the frame has moved on and is parked at a
            # LOCAL element/segment now -- mapping remote outputs under
            # that node would silently replace its real result.
            return
        okay = str(stream_dict.get("okay", "true")).lower() != "false"
        round_ms = None
        if self.telemetry is not None:
            # Close the hop span and merge the remote pipeline's spans
            # BEFORE the okay branch: an errored remote round trip
            # still belongs on the trace.
            if frame.remote_span is not None:
                node_name, span_id, started = frame.remote_span
                frame.remote_span = None
                round_ms = (time.time() - started) * 1000.0
                # Critical-path ``pipe`` bucket: the whole remote round
                # trip (wire both ways + the remote's own compute --
                # its internal split is in the returned spans).
                key = f"remote_{node_name}_ms"
                frame.metrics[key] = \
                    frame.metrics.get(key, 0.0) + round_ms
                frame.spans.append(make_span(
                    frame.trace_id or "", span_id, frame.trace_root,
                    f"remote:{node_name}", "remote", self.name,
                    stream.stream_id, frame.frame_id, started,
                    round_ms, status="ok" if okay else "error"))
            remote_spans = stream_dict.get("spans")
            if remote_spans:
                frame.spans.extend(decode_spans(remote_spans))
        self._rec("response", stream.stream_id, frame.frame_id,
                  frame.paused_pe_name, round_ms,
                  None if okay else {"status": "error"})
        breaker = self._stage_breaker(frame.paused_pe_name) \
            if frame.paused_pe_name in self.graph else None
        if not okay:
            if str(stream_dict.get("pipe_retry", "")).strip().lower() \
                    in ("true", "1") \
                    and frame.metrics.get("pipe_retries", 0) < 1:
                # The REMOTE never got our pipe tensors (its claim
                # timed out): not a remote failure -- a data-plane
                # loss.  Re-forward this frame with the tensors inlined
                # into the MQTT payload, once; the breaker is not
                # charged (the remote answered, the pipe died).
                node = self.graph.get_node(frame.paused_pe_name)
                frame.metrics["pipe_retries"] = \
                    frame.metrics.get("pipe_retries", 0) + 1
                self._count_pipe_fallback(
                    f"re-forward to {node.name}",
                    "peer claim timed out; resending over MQTT")
                if self._forward_frame(stream, frame, node,
                                       force_mqtt=True):
                    return
            if breaker is not None:
                self._breaker_failure(frame.paused_pe_name, breaker,
                                      stream.stream_id, frame.frame_id)
            self._frame_error(stream, frame,
                              f"remote {frame.paused_pe_name}: "
                              f"{stream_dict.get('diagnostic', '')}")
            return
        try:
            outputs = decode_frame_data(dict(frame_data or {}))
            outputs.update(pipe_claimed)
        except Exception as error:
            # A corrupt-but-parseable response payload: counts against
            # the stage's breaker like any other remote failure.
            if breaker is not None:
                self._breaker_failure(frame.paused_pe_name, breaker,
                                      stream.stream_id, frame.frame_id)
            self._frame_error(stream, frame,
                              f"remote {frame.paused_pe_name}: "
                              f"undecodable response ({error})")
            return
        if breaker is not None:
            self._breaker_success(frame.paused_pe_name, breaker,
                                  stream.stream_id, frame.frame_id)
        node = self.graph.get_node(frame.paused_pe_name)
        self._map_out(node, frame, outputs)
        resume_after = frame.paused_pe_name
        frame.paused_pe_name = None
        nodes = self.graph.iterate_after(resume_after, stream.graph_path)
        # RemoteStage parks are partition boundaries too: the suffix
        # after a remote hop fuses like any full-path walk.
        self._process_frame_common(stream, frame, nodes=nodes, fuse=True)

    # -- frame generators (source elements) --------------------------------

    def create_frame_local(self, stream: Stream, frame_data: dict):
        self.post_self("ingest_local", [stream.stream_id, frame_data, None])

    def create_frame_generator(self, stream: Stream, element,
                               frame_generator, rate: float | None):
        stop_event = threading.Event()
        stream.generator_handles.append(stop_event)
        interval = (1.0 / rate) if rate else 0.0
        engine = self.runtime.engine
        mailbox = self._mailbox_in

        def pump():
            next_due = time.monotonic()
            while not stop_event.is_set() and stream.state in (
                    StreamState.START, StreamState.RUN):
                # Backpressure counts queued AND parked frames: async
                # stages hold frames out of the mailbox while in flight,
                # and a source must not outrun them unboundedly.
                if engine.mailbox_size(mailbox) + stream.in_flight \
                        >= _BACKPRESSURE_DEPTH:
                    time.sleep(_BACKPRESSURE_SLEEP)
                    continue
                try:
                    event, frame_data = frame_generator(stream)
                except Exception:
                    self.logger.exception("frame generator %s raised",
                                          element.name)
                    break
                if event == StreamEvent.OKAY:
                    self.post_self("ingest_local",
                                   [stream.stream_id, frame_data, None])
                elif event == StreamEvent.NO_FRAME:
                    time.sleep(0.02)
                    continue
                else:
                    self.post_self("destroy_stream",
                                   [stream.stream_id, True])
                    break
                if interval:
                    next_due += interval
                    delay = next_due - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
            try:
                stream.generator_handles.remove(stop_event)
            except ValueError:
                pass

        thread = threading.Thread(
            target=pump, daemon=True,
            name=f"frame-gen-{self.name}-{element.name}")
        thread.start()

    def stop(self):
        self._cancel_health_timer()     # controller timer included
        self.disarm_faults()
        controller = getattr(self, "controller", None)
        if controller is not None:
            if controller.supervisor is not None:
                controller.supervisor.stop_all()
            self.controller = None
        fleet = getattr(self, "fleet_collector", None)
        if fleet is not None:
            fleet.stop()
            self.fleet_collector = None
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        if self.gateway is not None:
            # Before streams: a live WebSocket session must stop
            # feeding frames before its stream tears down under it.
            self.gateway.stop()
            self.gateway = None
        for stream_id in list(self.streams):
            self._destroy_stream_now(stream_id)
        if self.stage_scheduler is not None:
            self.stage_scheduler.stop()
        if self._data_endpoint is not None:
            self._data_endpoint.close()
            self._data_endpoint = None
        for sender in self._pipe_senders.values():
            sender.close()
        if self.journal is not None:
            self.journal.close()
        super().stop()


def create_pipeline(definition_pathname: str, name=None, runtime=None,
                    preflight: str | None = None) -> Pipeline:
    definition = load_pipeline_definition(definition_pathname)
    return Pipeline(definition, name=name, runtime=runtime,
                    preflight=preflight)
