"""The gateway service: HTTP + WebSocket front door (ISSUE 12).

One listening socket multiplexes thousands of client connections into
pipeline streams:

- **WebSocket** (``/v1/stream``) carries streaming sessions: a client
  opens a session (tenant + priority class + optional per-frame
  deadline), sends frames, and receives results **in ingest order** --
  the session maps 1:1 onto a pipeline stream, so the engine's
  reorder-buffer delivery contract IS the session's ordering
  guarantee.  Sessions survive reconnects (``open`` with an existing
  session id ATTACHES: the new connection takes over, results follow
  it); a dangling disconnect destroys the session's stream so parked
  frames and swag tensors never leak.
- **HTTP** carries request/response (``POST /v1/frames``: one frame in,
  one result out, a one-shot session under the hood) plus ``/healthz``
  and ``/stats``.

Admission happens HERE, at the door, against the pipeline's
:class:`~aiko_services_tpu_torch.gateway.qos.QosScheduler`: the tenant's
token bucket rejects over-rate frames before they touch the engine
(counted + ring-logged), the per-session window bounds in-flight
frames per client (backpressure: the client sees ``busy`` instead of
unbounded queueing), and everything admitted carries tenant/class into
the engine where the SAME scheduler orders every internal seam.

Transport notes: stdlib sockets only (tier-1 runs the whole path over
loopback, no external broker); one daemon thread per connection plus
one result pump per session -- the pump pays the ONE counted ledger
fetch per result (the gateway is a wire sink under the device-resident
swag contract, like ``_respond``'s process boundary).

Process-level fault domain (ISSUE 13): sessions are DECOUPLED from any
one pipeline.  Each session binds to a *target* -- the owning pipeline
in-process (fast path) or any pipeline discovered via registrar
records (wire path: ``create_stream``/``process_frame`` commands with
the gateway's own response topic).  When a bound pipeline's LWT fires
(registrar ``remove`` -> discovery ``_on_lost``), the gateway re-binds
the affected sessions to a surviving peer and commands it to ``adopt``
the dead pipeline's stream journal: the peer reconstructs the
sessions' streams, replays undelivered frames, and results resume on
the same WebSocket -- in order, deduped by the session-owned frame-id
sequence (the gateway assigns every frame's id, so 'already delivered'
means the same thing on every peer).  A standalone gateway
(``pipeline=None`` + a runtime) is the same machinery with no local
fast path: the production shape, where the front door's process is a
separate fault domain from every serving pipeline.

Idle-session reaping (``session_idle_ms``): a client that vanished
without a FIN -- its host died, its NAT forgot the mapping -- must not
pin a stream, its window slots and its tenant's in-flight budget until
process exit.  The reaper pings idle sessions (RFC 6455 ping; any
client speaking the shared codec pongs automatically) and frees the
session when a full idle window passes with no frames and no pongs.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import uuid

from . import ws
from .qos import QosScheduler
from ..observability.metrics import MetricsRegistry
from ..observability.tracing import (TraceBuffer, decode_spans,
                                     make_span, mint_id)
from ..utils import get_logger, generate, parse, parse_number

__all__ = ["GatewayServer", "json_safe", "decode_data"]

_logger = get_logger("aiko.gateway")

_HTTP_TIMEOUT_S = 30.0          # one-shot HTTP frame round trip
_ACCEPT_BACKLOG = 128
# Death -> adoption settle window: lets a DRAINING pipeline finish
# journaling frames that were in flight toward it when it announced
# its death, before the survivor reads the journal (see
# _on_peer_lost).
_FAILOVER_SETTLE_S = 0.08


def decode_data(data: dict) -> dict:
    """Client frame payload -> engine swag: JSON lists of numbers
    become numpy arrays (float32 when any member is fractional,
    int32 otherwise -- the accelerator-native dtypes), scalars and
    strings pass through.  A ``{"__tensor__": [...], "dtype": "..."}``
    wrapper forces an explicit dtype."""
    import numpy as np

    def convert(value):
        if isinstance(value, dict):
            if "__tensor__" in value:
                return np.asarray(value["__tensor__"],
                                  dtype=np.dtype(
                                      value.get("dtype", "float32")))
            return {key: convert(entry)
                    for key, entry in value.items()}
        if isinstance(value, list):
            flat = value
            while isinstance(flat, list) and flat \
                    and isinstance(flat[0], list):
                # A mixed nested/scalar level ([[1,2], 3]) is ragged:
                # fall through to the per-entry path, never crash.
                if not all(isinstance(sub, list) for sub in flat):
                    flat = []
                    break
                flat = [entry for sub in flat for entry in sub]
            if flat and all(isinstance(entry, (int, float))
                            and not isinstance(entry, bool)
                            for entry in flat):
                dtype = np.float32 if any(
                    isinstance(entry, float) for entry in flat) \
                    else np.int32
                try:
                    return np.asarray(value, dtype=dtype)
                except ValueError:      # ragged: pass through as-is
                    return value
            return [convert(entry) for entry in value]
        return value

    return {str(key): convert(value) for key, value in
            (data or {}).items()}


def json_safe(value):
    """Swag values -> JSON-encodable (arrays become nested lists,
    scalars become numbers, anything opaque becomes its type name --
    the recorder's redaction fallback, applied at the wire)."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, bytes):
        return value.decode("latin-1")
    if isinstance(value, dict):
        return {str(key): json_safe(entry)
                for key, entry in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_safe(entry) for entry in value]
    tolist = getattr(value, "tolist", None)
    if tolist is not None:
        try:
            return tolist()
        except Exception:
            pass
    item = getattr(value, "item", None)
    if item is not None:
        try:
            return item()
        except Exception:
            pass
    return f"<{type(value).__name__}>"


class _Session:
    """One gateway session <-> one pipeline stream."""

    def __init__(self, session_id: str, tenant: str, qos_class: str,
                 deadline_ms: float, window: int):
        import queue as queue_module
        self.session_id = session_id
        # Attach credential: minted on first open, returned in the
        # ``opened`` ack, REQUIRED to attach -- a client that merely
        # guesses a session id cannot hijack another tenant's stream.
        self.token = uuid.uuid4().hex
        self.stream_id = f"gw/{session_id}"
        self.tenant = tenant
        self.qos_class = qos_class
        self.deadline_ms = deadline_ms
        self.window = window
        self.queue = queue_module.Queue()   # engine queue_response
        self.conn: socket.socket | None = None
        self.send_lock = threading.Lock()
        self.state_lock = threading.Lock()
        self.inflight = 0
        self.sent = 0
        self.results = 0
        self.sent_times: list[float] = []   # FIFO; results are in-order
        self.closing = False
        self.pump: threading.Thread | None = None
        # Process fault domain (ISSUE 13): which pipeline this session
        # is bound to (None = the gateway's own pipeline, in-process;
        # a topic path = the wire binding), the SESSION-owned frame-id
        # sequence every target shares, and the last frame id actually
        # delivered to the client -- the failover dedupe line (a
        # replayed frame at or below it was already answered).
        self.target: str | None = None
        self.frame_seq = 0
        self.last_delivered = -1
        self.last_activity = time.monotonic()
        # Door-to-decode tracing: frame_id -> (trace_id, root span id,
        # wall start, monotonic start, admission-wait ms).  Bounded by
        # the session window (only admitted frames enter); the pump
        # pops each entry when its result is delivered (or deduped).
        self.trace_pending: dict[int, tuple] = {}
        # Retransmit line: frame_id -> (data, trace) for every frame
        # dispatched but not yet answered.  Journal adoption replays
        # what the dead pipeline INGESTED; a frame still in wire
        # transit at the kill was never journaled anywhere, so the
        # gateway -- the only party that still holds it -- re-fires
        # its copy after re-bind.  Bounded by the session window.
        self.unanswered: dict[int, tuple] = {}

    def next_frame_id(self) -> int:
        with self.state_lock:
            frame_id = self.frame_seq
            self.frame_seq += 1
            return frame_id

    def touch(self) -> None:
        self.last_activity = time.monotonic()

    def take_slot(self) -> "float | None":
        """Reserve one window slot; returns the stamp to pass to
        ``untake_slot`` if the frame is later refused (rate), or None
        when the window is full."""
        with self.state_lock:
            if self.closing or self.inflight >= self.window:
                return None
            self.inflight += 1
            self.sent += 1
            stamp = time.monotonic()
            self.sent_times.append(stamp)
            return stamp

    def untake_slot(self, stamp: float) -> None:
        """Undo a reservation for a frame that never entered the
        engine (token-bucket reject after the slot was taken): no
        result will arrive, so its stamp must not pair with one."""
        with self.state_lock:
            self.inflight = max(0, self.inflight - 1)
            self.sent = max(0, self.sent - 1)
            try:
                self.sent_times.remove(stamp)
            except ValueError:
                pass

    def finish_slot(self) -> float:
        """-> e2e seconds for the (in-order) completed frame."""
        with self.state_lock:
            self.inflight = max(0, self.inflight - 1)
            self.results += 1
            started = self.sent_times.pop(0) if self.sent_times else None
        return 0.0 if started is None else time.monotonic() - started


class GatewayServer:
    """Serve a front door on ``host:port`` (0 = kernel-assigned,
    echoed on ``.port``) -- for one pipeline (``gateway: on``,
    in-process fast path + failover to discovered peers) or standalone
    (``pipeline=None`` with a ``runtime``: every session binds to a
    discovered pipeline over the wire, so the gateway survives any
    serving process's death)."""

    def __init__(self, pipeline=None, host: str = "127.0.0.1",
                 port: int = 0, runtime=None,
                 session_idle_ms: float = 0.0, name: str = "gateway"):
        self.pipeline = pipeline
        self.name = name
        # Lazy default policy: the server may bind BEFORE the pipeline
        # finishes constructing (the endpoint is advertised as a
        # registrar tag, so it binds pre-registration like the tensor
        # pipe); the ``qos`` property below always reads the
        # pipeline's live scheduler first.
        self._default_qos: QosScheduler | None = None
        self.sessions: dict[str, _Session] = {}
        self._sessions_lock = threading.Lock()
        self._http_seq = 0
        self._stopped = False
        # Failover plane (ISSUE 13): discovered peer pipelines
        # (topic_path -> service name), the wire-response plumbing,
        # and the counters the failover tests assert on.
        self.runtime = None
        self._response_topic: str | None = None
        self._discovery = None
        self._peers: dict[str, str] = {}
        self._peers_lock = threading.Lock()
        self._http_waits: dict[str, object] = {}
        # Failovers that found NO survivor wait here; the next
        # _on_peer_found replays them, so sessions genuinely "stall
        # until one appears" instead of stalling forever.
        self._pending_failovers: list[tuple] = []
        self.failovers = 0
        self.sessions_reaped = 0
        # Fleet-controller routing (ISSUE 20): when the controller
        # scales the process pool, new sessions spread least-loaded
        # across home + peers instead of always binding home -- this
        # is how a freshly spawned peer takes load.
        self.balance = False
        # Observability plane (ISSUE 19): a standalone gateway owns its
        # registry + trace buffer; with a pipeline in-process both
        # delegate to its telemetry so gateway spans and pipeline spans
        # land in ONE buffer (TraceBuffer.add merges by trace_id).
        self._own_registry: MetricsRegistry | None = None
        self._own_traces: TraceBuffer | None = None
        #: fleet aggregator serving /fleet* when attached (the owning
        #: pipeline wires one under ``fleet: on``, or the operator sets
        #: it on a standalone gateway).
        self.fleet = None
        self._slo_gauge_stamp = 0.0
        # Idle-session reaping (``session_idle_ms``; 0 = off).
        self.session_idle_ms = max(0.0, float(session_idle_ms or 0.0))
        self._reaper: threading.Thread | None = None
        self._sock = socket.create_server((host, int(port)),
                                          backlog=_ACCEPT_BACKLOG)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"gateway-accept-{self.port}")
        self._accept_thread.start()
        if self.session_idle_ms:
            self._reaper = threading.Thread(
                target=self._reap_loop, daemon=True,
                name=f"gateway-reaper-{self.port}")
            self._reaper.start()
        if runtime is not None:
            self.attach_runtime(runtime)
        _logger.info("gateway front door on %s:%d (/v1/stream ws, "
                     "/v1/frames http)", host, self.port)

    def attach_runtime(self, runtime) -> None:
        """Join the service fabric: a private response topic for wire
        frame results, plus discovery of every pipeline service --
        the peer pool sessions fail over to (and bind to directly, in
        standalone mode).  Called by the owning Pipeline AFTER its
        actor registration (the gateway binds its socket before the
        runtime exists), or at construction when standalone."""
        if self.runtime is not None or runtime is None:
            return
        self.runtime = runtime
        self._response_topic = \
            f"{runtime.topic_path_process}/gateway/{self.port}"
        runtime.add_message_handler(self._on_wire_response,
                                    self._response_topic)
        # Deferred import (cycle: pipeline -> gateway at bind time),
        # but the ONE protocol authority -- a hand-copied literal here
        # would silently match nothing if the version ever bumps.
        from ..pipeline.pipeline import PROTOCOL_PIPELINE
        from ..services import ServiceFilter, do_discovery
        self._discovery = do_discovery(
            runtime, ServiceFilter(protocol=PROTOCOL_PIPELINE),
            add_handler=self._on_peer_found,
            remove_handler=self._on_peer_lost)

    # -- peer pool + failover ----------------------------------------------

    def _home_topic(self) -> str | None:
        pipeline = self.pipeline
        return None if pipeline is None \
            else getattr(pipeline, "topic_path", None)

    def _home_alive(self) -> bool:
        return self.pipeline is not None \
            and not getattr(self.pipeline, "_killed", False) \
            and not getattr(self.pipeline, "_draining", False) \
            and not getattr(self.pipeline, "_drained", False)

    def _on_peer_found(self, record, proxy) -> None:
        if record.topic_path == self._home_topic():
            return                      # the in-process fast path
        with self._peers_lock:
            self._peers[record.topic_path] = record.name
        _logger.info("gateway: pipeline peer %s (%s)", record.name,
                     record.topic_path)
        if self._pending_failovers:
            # Sessions stalled on an earlier no-survivor death: this
            # peer is their survivor.  Re-run the completion (it
            # re-computes the affected set; sessions that closed
            # meanwhile drop out).
            pending, self._pending_failovers = \
                self._pending_failovers, []
            for dead_topic, dead_name, home_died in pending:
                self._complete_failover(dead_topic, dead_name,
                                        home_died)

    def _pick_target(self) -> "str | None":
        """Binding for a NEW session: the in-process pipeline when it
        is alive, else any discovered peer, else the empty sentinel
        (no backend -- the open is refused).  Under ``balance`` (the
        fleet controller runs a process pool) the session goes to the
        least-loaded target across home + peers, home winning ties."""
        home = self._home_alive()
        with self._peers_lock:
            peers = list(self._peers)
        if self.balance and peers:
            counts: dict = {peer: 0 for peer in peers}
            if home:
                counts[None] = 0
            for session in list(self.sessions.values()):
                if session.target in counts:
                    counts[session.target] += 1
            if counts:
                return min(counts, key=lambda target:
                           (counts[target], target is not None,
                            target or ""))
        if home:
            return None
        for topic in peers:
            return topic
        return ""

    def _on_peer_lost(self, record, proxy=None) -> None:
        """A bound pipeline died (LWT -> registrar remove -> here) or
        drained away: after a short settle window, re-bind its
        sessions to a survivor and command the adoption of its
        journal."""
        topic = record.topic_path
        home_died = topic == self._home_topic()
        with self._peers_lock:
            self._peers.pop(topic, None)
        affected = [session for session in list(self.sessions.values())
                    if (session.target == topic
                        or (session.target is None and home_died))]
        if not affected:
            return
        # Settle before adopting: a DRAINING pipeline is still
        # journaling frames that were already in flight toward it
        # when it announced its death (they are held for the adopter,
        # not run).  Reading the journal immediately would race those
        # stragglers -- the one frame the zero-drop contract would
        # lose.  A killed pipeline journals nothing in the window, so
        # the delay only costs MTTR.  Registrar CHURN also lands here
        # (the mirror purges and fires a remove per record, pipelines
        # not dead): give the re-share a full extra second, and let
        # the completion's peer-is-back check turn it into a no-op --
        # returning early instead used to skip a genuine death
        # forever when the removal raced a cache refresh.
        cache = getattr(self._discovery, "cache", None)
        settle = _FAILOVER_SETTLE_S
        if cache is not None and cache.state != "ready":
            settle += 1.0
        self.runtime.engine.add_oneshot_timer(
            lambda: self._complete_failover(topic, record.name,
                                            home_died), settle)

    def _complete_failover(self, topic: str, dead_name: str,
                           home_died: bool) -> None:
        with self._peers_lock:
            if topic in self._peers:
                return              # churn, not death: peer re-added
        affected = [session for session in list(self.sessions.values())
                    if (session.target == topic
                        or (session.target is None and home_died))]
        if not affected:
            return
        survivor = None
        with self._peers_lock:
            for peer in self._peers:
                survivor = peer
                break
        if survivor is None and not home_died and self._home_alive():
            survivor = ""               # fail back to the local path
        if survivor is None:
            self._pending_failovers.append((topic, dead_name,
                                            home_died))
            _logger.error(
                "gateway: pipeline %s died with %d bound session(s) "
                "and no surviving peer; sessions stall until one "
                "appears", dead_name, len(affected))
            return
        self.failovers += 1
        telemetry = getattr(self.pipeline, "telemetry", None)
        if telemetry is not None:
            telemetry.registry.count("pipeline_failovers")
        # Adoption FIRST, then re-bind: the peer's mailbox is FIFO, so
        # the journal replay lands before any new frame the re-bound
        # sessions send it.
        self._send_adopt(survivor, dead_name)
        refired = 0
        for session in affected:
            session.target = None if survivor == "" else survivor
            # Re-fire the session's unanswered frames at the new
            # target.  Adoption only replays frames the dead pipeline
            # journaled; one still in wire transit at the kill never
            # reached any journal, and without this re-send it is
            # simply gone -- the client stalls a window slot forever.
            # Frames the adopter DOES replay arrive first (same FIFO
            # mailbox), so our duplicate re-ingests into a silently
            # skipped slot and delivery dedupe keeps the client's
            # exactly-once, in-order contract.
            with session.state_lock:
                unanswered = sorted(session.unanswered.items())
            for frame_id, (data, trace) in unanswered:
                self._dispatch_frame(session, data, frame_id,
                                     trace=trace)
                refired += 1
        if refired:
            registry = self._registry()
            if registry is not None:
                registry.count("gateway_refired_frames", refired)
        _logger.warning(
            "gateway: pipeline %s died; %d session(s) re-bound to %s "
            "(journal adoption requested, %d in-flight frame(s) "
            "re-fired)", dead_name, len(affected), "local pipeline"
            if survivor == "" else survivor, refired)

    def _send_adopt(self, survivor: str, dead_name: str) -> None:
        if survivor == "" and self.pipeline is not None:
            self.pipeline.post_self(
                "adopt", [dead_name, self._response_topic])
        elif self.runtime is not None:
            self.runtime.message.publish(
                f"{survivor}/in",
                generate("adopt", [dead_name,
                                   self._response_topic or ""]))

    # -- wire binding ------------------------------------------------------

    def _create_wire_stream(self, target: str, stream_id: str,
                            parameters: dict) -> None:
        self.runtime.message.publish(
            f"{target}/in",
            generate("create_stream", [stream_id, dict(parameters)]))

    def _send_wire_frame(self, target: str, stream_id: str,
                         frame_id: int, data: dict,
                         trace_id: str | None = None,
                         trace_parent: str | None = None) -> None:
        from ..pipeline.codec import encode_frame_data
        header = {"stream_id": stream_id, "frame_id": int(frame_id),
                  "response_topic": self._response_topic}
        if trace_id:
            # Door-to-decode: the remote pipeline stamps its spans
            # under the gateway's root and returns them in the
            # response header (the PR 4 remote-hop machinery).
            header["trace_id"] = trace_id
            header["trace_parent"] = trace_parent
        self.runtime.message.publish(
            f"{target}/in",
            generate("process_frame",
                     [header, encode_frame_data(data)]))

    def _dispatch_frame(self, session: _Session, data: dict,
                        frame_id: int, trace: tuple | None = None) -> None:
        """Route one admitted frame to the session's current target.
        Every frame carries the session-owned id, so delivery dedupe
        holds across failovers regardless of which pipeline answers."""
        trace_id = trace[0] if trace else None
        trace_parent = trace[1] if trace else None
        with session.state_lock:
            session.unanswered[frame_id] = (data, trace)
        if session.target is None and self.pipeline is not None:
            self.pipeline.process_frame_local(
                data, stream_id=session.stream_id,
                queue_response=session.queue, frame_id=frame_id,
                trace_id=trace_id, trace_parent=trace_parent)
        elif session.target:
            self._send_wire_frame(session.target, session.stream_id,
                                  frame_id, data, trace_id=trace_id,
                                  trace_parent=trace_parent)
        else:
            _logger.warning("gateway: session %s has no live target; "
                            "frame %d dropped at the door",
                            session.session_id, frame_id)

    def _on_wire_response(self, topic: str, payload) -> None:
        """A wire-bound pipeline answered: route the result onto the
        owning session's queue (the same path local results take)."""
        try:
            command, parameters = parse(payload)
        except Exception:
            return
        if command != "process_frame_response" or len(parameters) < 1:
            return
        header = dict(parameters[0] or {})
        body = dict(parameters[1] or {}) if len(parameters) > 1 else {}
        stream_id = str(header.get("stream_id", ""))
        okay = str(header.get("okay", "true")).lower() != "false"
        frame_id = parse_number(header.get("frame_id"), None)
        from ..pipeline.codec import decode_frame_data
        try:
            decoded = decode_frame_data(body)
        except Exception as error:
            decoded, okay = {}, False
            header.setdefault("diagnostic",
                              f"undecodable result ({error})")
        spans_text = header.get("spans")
        if spans_text:
            # The wire-bound pipeline's spans for this frame (it saw
            # our trace_id, so it returned them instead of keeping a
            # private trace): merge them under the gateway's trace.
            spans = decode_spans(spans_text)
            if spans:
                traces = self._traces()
                if traces is not None:
                    traces.add(spans[0].get("trace_id"), spans, okay)
        entry = (stream_id,
                 None if frame_id is None else int(frame_id),
                 decoded, {}, okay,
                 str(header.get("diagnostic", "")))
        if stream_id.startswith("gw/"):
            with self._sessions_lock:
                session = self.sessions.get(stream_id[3:])
            if session is not None:
                session.queue.put(entry)
        elif stream_id in self._http_waits:
            waiter = self._http_waits.get(stream_id)
            if waiter is not None:
                waiter.put(entry)

    # -- idle-session reaping ----------------------------------------------

    def _reap_loop(self) -> None:
        idle_s = self.session_idle_ms / 1000.0
        interval = max(0.02, idle_s / 4.0)
        while not self._stopped:
            time.sleep(interval)
            now = time.monotonic()
            for session in list(self.sessions.values()):
                idle = now - session.last_activity
                if idle >= idle_s:
                    self._reap_session(session, idle)
                elif idle >= idle_s / 2.0:
                    # Half the window gone quiet: ping.  A live client
                    # pongs (the shared codec answers in recv) and the
                    # on_frame stamp resets the clock; a vanished one
                    # stays silent into the reap above.
                    self._ws_ping(session)

    def _reap_session(self, session: _Session, idle: float) -> None:
        self.sessions_reaped += 1
        _logger.warning(
            "gateway: reaping session %s (idle %.0f ms >= "
            "session_idle_ms %.0f): stream, window slots and QoS "
            "budget freed", session.session_id, idle * 1000.0,
            self.session_idle_ms)
        telemetry = getattr(self.pipeline, "telemetry", None)
        if telemetry is not None:
            telemetry.registry.count("gateway_sessions_reaped")
        self._destroy_session(session)
        self._close_conn(session)

    @staticmethod
    def _ws_ping(session: _Session) -> None:
        with session.send_lock:
            conn = session.conn
            if conn is None:
                return
            try:
                ws.send_frame(conn, b"", ws.OP_PING)
            except OSError:
                session.conn = None

    @property
    def qos(self) -> QosScheduler:
        """The pipeline's scheduler when it has one; otherwise a
        default-policy instance so the door still resolves classes and
        session windows (no rate limits, no budgets)."""
        scheduler = getattr(self.pipeline, "qos", None)
        if scheduler is not None:
            return scheduler
        if self._default_qos is None:
            self._default_qos = QosScheduler()
        return self._default_qos

    # -- observability plane (ISSUE 19) ------------------------------------

    def _registry(self) -> "MetricsRegistry | None":
        """The metrics registry gateway series land in: the pipeline's
        (one process, one registry) or the gateway's own when
        standalone.  None when the pipeline disabled telemetry -- the
        door honors ``telemetry: off`` like every other plane."""
        if self.pipeline is not None:
            telemetry = getattr(self.pipeline, "telemetry", None)
            return None if telemetry is None else telemetry.registry
        if self._own_registry is None:
            self._own_registry = MetricsRegistry()
        return self._own_registry

    def _traces(self) -> "TraceBuffer | None":
        """Trace buffer, same ownership rule as :meth:`_registry`."""
        if self.pipeline is not None:
            telemetry = getattr(self.pipeline, "telemetry", None)
            return None if telemetry is None else telemetry.traces
        if self._own_traces is None:
            self._own_traces = TraceBuffer()
        return self._own_traces

    def _mint_trace(self, session: "_Session | None", frame_id: int,
                    admit_ms: float) -> "tuple | None":
        """Root a new door-to-decode trace for one admitted frame:
        (trace_id, root span id, wall start, monotonic start,
        admission-wait ms).  The dispatched frame carries trace_id +
        the root as its parent, so every downstream span -- origin
        pipeline, remote hops, LLM decode blocks -- joins THIS trace."""
        if self._traces() is None:
            return None
        entry = (mint_id(), mint_id(), time.time(), time.monotonic(),
                 admit_ms)
        if session is not None:
            session.trace_pending[frame_id] = entry
        return entry

    def _finish_trace(self, session: "_Session | None", entry: tuple,
                      frame_id, stream_id: str, okay: bool,
                      pump_start: float, extra_spans=None) -> str:
        """Close the gateway's spans (root session span = door-to-door
        e2e, admission wait, result pump) and merge them into the
        buffer under the frame's trace_id."""
        trace_id, root, wall_start, mono_start, admit_ms = entry
        now = time.monotonic()
        spans = [make_span(trace_id, root, None,
                           f"gateway:{self.name}", "gateway",
                           process=self.name, stream=stream_id,
                           frame=frame_id, start=wall_start,
                           duration_ms=(now - mono_start) * 1000.0,
                           status="ok" if okay else "error"),
                 make_span(trace_id, mint_id(), root, "gateway:admit",
                           "gateway", process=self.name,
                           stream=stream_id, frame=frame_id,
                           start=wall_start, duration_ms=admit_ms),
                 make_span(trace_id, mint_id(), root, "gateway:pump",
                           "gateway", process=self.name,
                           stream=stream_id, frame=frame_id,
                           start=wall_start
                           + (pump_start - mono_start),
                           duration_ms=(now - pump_start) * 1000.0)]
        if extra_spans:
            spans.extend(extra_spans)
        traces = self._traces()
        if traces is not None:
            traces.add(trace_id, spans, okay)
        return trace_id

    def _note_slo(self, tenant: str, qos_class: str,
                  e2e_ms: "float | None", okay: bool) -> None:
        """One SLO observation (delivered result or latency-less bad
        event), plus the fast-burn check: a burn > 1 fires the
        remediation pair (ring event + debounced black-box dump, via
        the pipeline's event loop) and is counted.  Burn gauges
        refresh at most once a second."""
        slo = self.qos.slo
        if slo is None:
            return
        label = self.qos.tenant(tenant).name
        slo.observe(label, qos_class, e2e_ms, okay)
        registry = self._registry()
        fired = slo.fast_burns()
        for burn_tenant, burn_class, burn in fired:
            if registry is not None:
                registry.count("slo_fast_burns", tenant=burn_tenant,
                               cls=burn_class)
            _logger.warning(
                "gateway: SLO fast burn %.2fx (tenant %s, class %s)",
                burn, burn_tenant, burn_class)
        now = time.monotonic()
        burns = None
        if fired or now - self._slo_gauge_stamp >= 1.0:
            self._slo_gauge_stamp = now
            burns = slo.burn_rates(now)
            if registry is not None:
                for tenant_name, classes in burns.items():
                    for class_name, entry in classes.items():
                        registry.gauge("slo_burn", entry["burn"],
                                       tenant=tenant_name,
                                       cls=class_name)
        if self.pipeline is not None and (fired or burns is not None):
            self.pipeline.post_self("note_slo_burn",
                                    [list(fired), burns])

    # -- plumbing ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                      # closed
            threading.Thread(target=self._serve_connection,
                             args=(conn,), daemon=True,
                             name="gateway-conn").start()

    def stop(self) -> None:
        self._stopped = True
        if self._discovery is not None:
            self._discovery.terminate()
            self._discovery = None
        if self.runtime is not None and self._response_topic:
            self.runtime.remove_message_handler(self._on_wire_response,
                                                self._response_topic)
        try:
            # shutdown BEFORE close: close() alone does not wake a
            # thread blocked in accept(), and the kernel socket kept
            # accepting connections for process lifetime (found by
            # the create-failure leak test).
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._sessions_lock:
            sessions, self.sessions = dict(self.sessions), {}
        for session in sessions.values():
            session.closing = True
            self._close_conn(session)
            session.queue.put(None)     # retire the pump thread

    @staticmethod
    def _close_conn(session: _Session) -> None:
        conn, session.conn = session.conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def session_count(self) -> int:
        with self._sessions_lock:
            return len(self.sessions)

    # -- connection handling -----------------------------------------------

    def _serve_connection(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(_HTTP_TIMEOUT_S)
            head, body_start = self._read_head(conn)
            if head is None:
                return
            request_line, headers = head
            method, _, rest = request_line.partition(" ")
            path = rest.split(" ", 1)[0]
            upgrade = ws.server_handshake(headers)
            if upgrade is not None:
                conn.sendall(upgrade)
                conn.settimeout(None)
                self._serve_ws(conn)
                return
            self._serve_http(conn, method.upper(), path, headers,
                             body_start)
        except (OSError, ws.WsClosed, ConnectionError):
            pass
        except Exception:
            _logger.exception("gateway connection failed")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _read_head(conn: socket.socket):
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = conn.recv(8192)
            if not chunk:
                return None, b""
            data += chunk
            if len(data) > 1 << 20:
                raise ConnectionError("oversized request head")
        head, _, remainder = data.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        headers = {}
        for line in lines[1:]:
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        return (lines[0], headers), remainder

    # -- HTTP --------------------------------------------------------------

    def _serve_http(self, conn, method: str, path: str, headers: dict,
                    body_start: bytes) -> None:
        if method == "GET" and path == "/healthz":
            with self._peers_lock:
                peers = len(self._peers)
            self._http_reply(conn, 200, {
                "ok": True, "sessions": self.session_count(),
                "streams": None if self.pipeline is None
                else len(self.pipeline.streams),
                "peers": peers})
            return
        if method == "GET" and path == "/stats":
            self._http_reply(conn, 200, {
                "sessions": self.session_count(),
                "qos": {} if self.pipeline is None
                else self.pipeline.qos_stats(),
                "failovers": self.failovers,
                "sessions_reaped": self.sessions_reaped})
            return
        if method == "GET" and (path in ("/metrics", "/metrics/raw",
                                         "/slo")
                                or path.startswith("/traces")
                                or path.startswith("/fleet")):
            self._serve_observability(conn, path.rstrip("/") or "/")
            return
        if method == "POST" and path == "/v1/frames":
            length = int(headers.get("content-length", "0"))
            body = body_start
            while len(body) < length:
                chunk = conn.recv(length - len(body))
                if not chunk:
                    raise ConnectionError("truncated request body")
                body += chunk
            try:
                request = json.loads(body.decode() or "{}")
            except json.JSONDecodeError as error:
                self._http_reply(conn, 400, {"error": f"bad JSON: "
                                                      f"{error}"})
                return
            self._serve_http_frame(conn, request)
            return
        self._http_reply(conn, 404,
                         {"error": "try /healthz, /stats, "
                                   "/v1/frames or ws /v1/stream"})

    def _serve_http_frame(self, conn, request: dict) -> None:
        """One-shot request/response: a private session/stream per
        request rides the same admission + delivery path as streaming
        sessions, then tears down."""
        tenant = str(request.get("tenant", "default"))
        qos_class = self.qos.resolve_class(request.get("class"), tenant)
        try:
            # Decode BEFORE admission or stream creation: a malformed
            # payload must cost a 400, not a burned rate token or a
            # leaked stream.
            data = decode_data(request.get("data"))
        except Exception as error:
            self._http_reply(conn, 400, {"error": "bad data",
                                         "detail": str(error)[:200]})
            return
        admit_start = time.monotonic()
        admitted, reason = self._admit(tenant, qos_class, None)
        admit_ms = (time.monotonic() - admit_start) * 1000.0
        if not admitted:
            self._note_slo(tenant, qos_class, None, False)
            self._http_reply(conn, 429, {"error": "rejected",
                                         "reason": reason})
            return
        registry = self._registry()
        if registry is not None:
            registry.observe("gateway_admit_wait_ms", admit_ms)
        with self._sessions_lock:
            self._http_seq += 1
            stream_id = f"gwhttp/{self.port}/{self._http_seq}"
        import queue as queue_module
        responses = queue_module.Queue()
        # One-shot streams opt out of the journal: there is no session
        # to adopt, and replaying them to a 504'd-and-gone client
        # would be wasted work on the survivor.
        parameters = {"tenant": tenant, "qos_class": qos_class,
                      "journal": "off"}
        deadline_ms = request.get("deadline_ms")
        if deadline_ms is not None:
            parameters["frame_deadline_ms"] = float(deadline_ms)
        pipeline = self.pipeline
        target = self._pick_target()
        if target == "":
            self._http_reply(conn, 503, {"error": "no backend"})
            return
        trace = self._mint_trace(None, 0, admit_ms)
        trace_id = None if trace is None else trace[0]
        trace_parent = None if trace is None else trace[1]
        if target is None:
            # Mailbox FIFO: the create lands before the ingest, so the
            # frame sees the session's tenant/class/deadline parameters.
            pipeline.post_self("create_stream_local",
                               [stream_id, parameters, None, 0,
                                responses])
            pipeline.process_frame_local(data, stream_id=stream_id,
                                         queue_response=responses,
                                         trace_id=trace_id,
                                         trace_parent=trace_parent)
        else:
            self._http_waits[stream_id] = responses
            self._create_wire_stream(target, stream_id, parameters)
            self._send_wire_frame(target, stream_id, 0, data,
                                  trace_id=trace_id,
                                  trace_parent=trace_parent)
        try:
            (_, frame_id, swag, metrics, okay, diagnostic) = \
                responses.get(timeout=_HTTP_TIMEOUT_S)
        except Exception:
            self._note_slo(tenant, qos_class, None, False)
            self._http_reply(conn, 504, {"error": "timed out"})
            return
        finally:
            self._http_waits.pop(stream_id, None)
            if target is None:
                pipeline.post_self("destroy_stream", [stream_id, True])
            else:
                self.runtime.message.publish(
                    f"{target}/in",
                    generate("destroy_stream", [stream_id, True]))
        pump_start = time.monotonic()
        bare = {key: value for key, value in swag.items()
                if "." not in key}
        if pipeline is not None:
            bare = pipeline.transfer_ledger.fetch(bare)
        e2e_ms = (time.monotonic() - trace[3]) * 1000.0 \
            if trace is not None \
            else float(metrics.get("time_pipeline", 0.0)) * 1000.0
        self._note_slo(tenant, qos_class, e2e_ms, okay)
        status = 200 if okay else 503
        reply = {
            "ok": bool(okay), "frame": frame_id,
            "data": json_safe(bare), "diagnostic": diagnostic,
            "e2e_ms": round(float(metrics.get("time_pipeline", 0.0))
                            * 1000.0, 3)}
        if trace is not None:
            reply["trace"] = self._finish_trace(
                None, trace, frame_id, stream_id, okay, pump_start)
        self._http_reply(conn, status, reply)

    def _serve_observability(self, conn, path: str) -> None:
        """The door's observability surface (ISSUE 19): the same
        /metrics, /metrics/raw and /traces shapes as the pipeline's
        MetricsServer (scraping a gateway and scraping a pipeline are
        the same act), /slo for the live burn snapshot, and /fleet*
        when a fleet aggregator is attached."""
        if path.startswith("/fleet"):
            fleet = self.fleet
            if fleet is None:
                self._http_reply(conn, 404, {
                    "error": "no fleet collector attached "
                             "(fleet: on)"})
            elif path == "/fleet":
                self._http_text_reply(conn, fleet.render_fleet_text())
            elif path == "/fleet/slo":
                self._http_reply(conn, 200, fleet.fleet_slo())
            elif path.startswith("/fleet/traces/"):
                trace = fleet.fleet_trace(
                    path[len("/fleet/traces/"):])
                if trace is None:
                    self._http_reply(conn, 404,
                                     {"error": "unknown trace"})
                else:
                    self._http_reply(conn, 200, trace)
            else:
                self._http_reply(conn, 404, {
                    "error": "try /fleet, /fleet/slo or "
                             "/fleet/traces/<id>"})
            return
        if path == "/slo":
            slo = self.qos.slo
            self._http_reply(conn, 200, {} if slo is None
                             else slo.snapshot())
            return
        registry = self._registry()
        if registry is None:
            self._http_reply(conn, 404, {"error": "telemetry disabled"})
            return
        if path == "/metrics":
            if self.pipeline is not None:
                text = self.pipeline.telemetry.metrics_text()
            else:
                text = registry.render_text()
            self._http_text_reply(conn, text)
        elif path == "/metrics/raw":
            if self.pipeline is not None:
                self.pipeline.telemetry.metrics_text()   # gauge refresh
            payload = registry.state()
            payload["pipeline"] = self.name \
                if self.pipeline is None else self.pipeline.name
            self._http_reply(conn, 200, payload)
        elif path == "/traces":
            traces = self._traces()
            self._http_reply(conn, 200, {"traces": traces.recent(50)})
        elif path.startswith("/traces/"):
            trace = self._traces().get(path[len("/traces/"):])
            if trace is None:
                self._http_reply(conn, 404, {"error": "unknown trace"})
            else:
                self._http_reply(conn, 200, trace)
        else:
            self._http_reply(conn, 404, {
                "error": "try /metrics, /metrics/raw, /traces or /slo"})

    @staticmethod
    def _http_reply(conn, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests", 503: "Unavailable",
                  504: "Gateway Timeout"}.get(status, "OK")
        conn.sendall((f"HTTP/1.1 {status} {reason}\r\n"
                      "Content-Type: application/json\r\n"
                      f"Content-Length: {len(body)}\r\n"
                      "Connection: close\r\n\r\n").encode() + body)

    @staticmethod
    def _http_text_reply(conn, text: str) -> None:
        body = text.encode()
        conn.sendall(("HTTP/1.1 200 OK\r\n"
                      "Content-Type: text/plain; version=0.0.4; "
                      "charset=utf-8\r\n"
                      f"Content-Length: {len(body)}\r\n"
                      "Connection: close\r\n\r\n").encode() + body)

    # -- admission ---------------------------------------------------------

    def _admit(self, tenant: str, qos_class: str,
               session: "_Session | None") -> tuple[bool, str]:
        """Front-door admission for one frame: token bucket first,
        then the session window (backpressure).  Counted + ring-logged
        both ways."""
        pipeline = self.pipeline
        # Slot FIRST (atomically, under the session lock), bucket
        # second: a backpressured frame must not burn one of the
        # tenant's rate tokens on the way to its ``busy``, and two
        # connections racing one session must not over-admit.
        stamp = None
        if session is not None:
            stamp = session.take_slot()
            if stamp is None:
                admitted, reason = False, "window"
            else:
                admitted, reason = self.qos.admit(tenant, qos_class)
                if not admitted:
                    session.untake_slot(stamp)
        else:
            admitted, reason = self.qos.admit(tenant, qos_class)
        telemetry = getattr(pipeline, "telemetry", None)
        recorder = getattr(pipeline, "recorder", None)
        # Metric labels carry the RESOLVED tenant entry's name, never
        # the raw client string: past LAZY_TENANT_CAP unknown names
        # share the default entry, so an attacker cycling tenant names
        # cannot grow the metrics registry without bound (the registry
        # never evicts label sets).
        label = self.qos.tenant(tenant).name
        if admitted:
            if telemetry is not None:
                telemetry.registry.count("gateway_admits",
                                         tenant=label, cls=qos_class)
            if recorder is not None:
                recorder.record(
                    "gw_admit",
                    None if session is None else session.stream_id,
                    None, label, None, {"cls": qos_class})
        else:
            if telemetry is not None:
                telemetry.registry.count("gateway_rejects",
                                         tenant=label, reason=reason)
            if recorder is not None:
                recorder.record(
                    "gw_reject",
                    None if session is None else session.stream_id,
                    None, label, None,
                    {"cls": qos_class, "reason": reason})
        return admitted, reason

    # -- WebSocket sessions ------------------------------------------------

    def _serve_ws(self, conn: socket.socket) -> None:
        session: _Session | None = None
        holder: dict = {"session": None}

        def on_frame(_opcode):
            # Liveness for the idle reaper: ANY wire frame from the
            # client -- data or the pong answering our ping.
            live = holder["session"]
            if live is not None:
                live.touch()

        try:
            while True:
                opcode, payload = ws.recv_message(conn,
                                                  on_frame=on_frame)
                try:
                    message = json.loads(payload.decode())
                except json.JSONDecodeError as error:
                    self._ws_send_raw(conn, {"op": "error",
                                             "error": f"bad JSON: "
                                                      f"{error}"})
                    continue
                op = str(message.get("op", ""))
                if op == "open":
                    opened = self._ws_open(conn, message)
                    if opened is not None:
                        session = opened
                        holder["session"] = session
                        session.touch()
                elif op == "frame":
                    self._ws_frame(conn, session, message)
                elif op == "close":
                    self._ws_close(conn, session)
                    session = None
                else:
                    self._ws_send_raw(conn, {"op": "error",
                                             "error": f"unknown op "
                                                      f"{op!r}"})
        except (ws.WsClosed, OSError, ConnectionError):
            pass
        finally:
            # Dangling disconnect: clean up the pipeline stream --
            # UNLESS another connection already attached (takeover),
            # in which case this socket no longer owns the session.
            if session is not None and session.conn is conn:
                self._destroy_session(session)

    def _ws_open(self, conn, message: dict) -> "_Session | None":
        session_id = str(message.get("session") or uuid.uuid4().hex[:12])
        tenant = str(message.get("tenant", "default"))
        qos_class = self.qos.resolve_class(message.get("class"), tenant)
        deadline_ms = float(message.get("deadline_ms") or 0.0)
        # The client may request a SMALLER window (tighter client-side
        # pipelining); the policy's session_window is the ceiling --
        # a huge requested window must not defeat backpressure.
        ceiling = max(1, int(self.qos.session_window))
        window = max(1, min(int(message.get("window") or ceiling),
                            ceiling))
        with self._sessions_lock:
            session = self.sessions.get(session_id)
            attached = session is not None
            if session is None:
                session = _Session(session_id, tenant, qos_class,
                                   deadline_ms, window)
                self.sessions[session_id] = session
        if attached:
            if str(message.get("token") or "") != session.token:
                # Attach is a takeover of a live stream: it requires
                # the credential minted at open, not just the id.
                self._ws_send_raw(conn, {"op": "error",
                                         "error": "bad session token"})
                return None
            # Takeover: results follow the new connection.
            with session.send_lock:
                session.conn = conn
            session.touch()
        else:
            target = self._pick_target()
            if target == "":
                with self._sessions_lock:
                    self.sessions.pop(session_id, None)
                self._ws_send_raw(conn, {"op": "error",
                                         "error": "no backend"})
                return None
            session.conn = conn
            session.target = target
            parameters = {"tenant": tenant, "qos_class": qos_class}
            if deadline_ms:
                parameters["frame_deadline_ms"] = deadline_ms
            if target is None:
                self.pipeline.post_self(
                    "create_stream_local",
                    [session.stream_id, parameters, None, 0,
                     session.queue])
            else:
                self._create_wire_stream(target, session.stream_id,
                                         parameters)
            session.pump = threading.Thread(
                target=self._pump_results, args=(session,),
                daemon=True, name=f"gateway-pump-{session_id}")
            session.pump.start()
        self._ws_send(session, {"op": "opened",
                                "session": session_id,
                                "token": session.token,
                                "attached": attached,
                                "class": session.qos_class,
                                "window": session.window})
        return session

    def _ws_frame(self, conn, session: _Session | None,
                  message: dict) -> None:
        if session is None or session.closing \
                or session.conn is not conn:
            # No session, a closed one, or a connection another attach
            # superseded: its frames must not auto-recreate the stream
            # under default tenancy (ingest_local would) or bill the
            # session's window.
            self._ws_send_raw(conn, {"op": "rejected",
                                     "reason": "no-session"})
            return
        try:
            # BEFORE admission: a malformed payload must cost a
            # ``rejected`` reply, never a taken window slot or (worse)
            # the whole connection.
            data = decode_data(message.get("data"))
        except Exception as error:
            self._ws_send(session, {"op": "rejected",
                                    "reason": "bad-data",
                                    "error": str(error)[:200]})
            return
        admit_start = time.monotonic()
        admitted, reason = self._admit(session.tenant,
                                       session.qos_class, session)
        admit_ms = (time.monotonic() - admit_start) * 1000.0
        if not admitted:
            if reason != "window":
                # A rate reject is an availability event against the
                # tenant's error budget; window backpressure is the
                # client's own pipelining, not a served failure.
                self._note_slo(session.tenant, session.qos_class,
                               None, False)
            payload = {"op": "busy" if reason == "window"
                       else "rejected",
                       "reason": reason, "inflight": session.inflight}
            tag = message.get("tag")
            if tag is not None:
                payload["tag"] = tag
            self._ws_send(session, payload)
            return
        registry = self._registry()
        if registry is not None:
            registry.observe("gateway_admit_wait_ms", admit_ms)
        frame_id = session.next_frame_id()
        trace = self._mint_trace(session, frame_id, admit_ms)
        self._dispatch_frame(session, data, frame_id, trace=trace)

    def _ws_close(self, conn, session: _Session | None) -> None:
        # Only the session's CURRENT connection may destroy it: a
        # superseded connection's buffered close must not tear down a
        # session another client just took over.
        if session is not None and session.conn is conn:
            self._destroy_session(session)
        self._ws_send_raw(conn, {"op": "closed"})

    def _destroy_session(self, session: _Session) -> None:
        with self._sessions_lock:
            self.sessions.pop(session.session_id, None)
        session.closing = True
        if session.target is None and self.pipeline is not None:
            self.pipeline.post_self("destroy_stream",
                                    [session.stream_id, True])
        elif session.target and self.runtime is not None:
            self.runtime.message.publish(
                f"{session.target}/in",
                generate("destroy_stream", [session.stream_id, True]))
        session.queue.put(None)             # wake + retire the pump

    def _pump_results(self, session: _Session) -> None:
        """Per-session result pump: engine responses (already in
        ingest order -- the stream's reorder buffer) go out on
        whatever connection currently owns the session.  Pays the one
        counted ledger fetch per result: the wire-sink contract."""
        pipeline = self.pipeline
        while True:
            entry = session.queue.get()
            if entry is None:
                return
            (_, frame_id, swag, metrics, okay, diagnostic) = entry
            try:
                frame_seq = int(frame_id)
            except (TypeError, ValueError):
                frame_seq = None
            if frame_seq is not None:
                with session.state_lock:
                    session.unanswered.pop(frame_seq, None)
                    if frame_seq <= session.last_delivered:
                        # Failover dedupe: the dead pipeline answered
                        # this frame before dying (or the journal's
                        # done record raced the crash) and the
                        # adopter replayed it anyway -- the client
                        # must see each id exactly once, in order.
                        session.trace_pending.pop(frame_seq, None)
                        continue
                    session.last_delivered = frame_seq
            e2e_s = session.finish_slot()
            pump_start = time.monotonic()
            bare = {key: value for key, value in swag.items()
                    if "." not in key}
            if pipeline is not None:
                try:
                    bare = pipeline.transfer_ledger.fetch(bare)
                except Exception as error:
                    okay, diagnostic = False, f"result fetch: {error}"
                    bare = {}
            registry = self._registry()
            if registry is not None:
                registry.observe("gateway_e2e_ms", e2e_s * 1000.0,
                                 cls=session.qos_class,
                                 tenant=self.qos.tenant(
                                     session.tenant).name)
            self._note_slo(session.tenant, session.qos_class,
                           e2e_s * 1000.0, okay)
            pending = None if frame_seq is None else \
                session.trace_pending.pop(frame_seq, None)
            payload = {
                "op": "result", "frame": frame_id, "ok": bool(okay),
                "data": json_safe(bare), "diagnostic": diagnostic,
                "e2e_ms": round(e2e_s * 1000.0, 3)}
            if pending is not None:
                payload["trace"] = pending[0]
                # Finish BEFORE the send: once the client holds a
                # result naming this trace id, /traces/<id> must
                # resolve it (the pump span ends at hand-off to the
                # socket, not after the write).
                self._finish_trace(session, pending, frame_seq,
                                   session.stream_id, okay, pump_start)
            self._ws_send(session, payload)

    def _ws_send(self, session: _Session, payload: dict) -> None:
        with session.send_lock:
            conn = session.conn
            if conn is None:
                return
            try:
                ws.send_frame(conn, json.dumps(payload))
            except OSError:
                # The pump outlives a dropped connection; results are
                # simply not deliverable until a client re-attaches.
                session.conn = None

    @staticmethod
    def _ws_send_raw(conn, payload: dict) -> None:
        try:
            ws.send_frame(conn, json.dumps(payload))
        except OSError:
            pass
