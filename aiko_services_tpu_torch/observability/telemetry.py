"""PipelineTelemetry: the glue between the Pipeline's hooks and the
metrics/tracing primitives.

One instance per Pipeline (``pipeline.telemetry``, unless the
``telemetry: off`` pipeline parameter disables it).  It attaches
handlers to the existing instrumentation hooks -- the same hooks the
profiler uses -- and from them feeds:

- per-element / per-segment / per-stage / per-hop latency histograms
  (:class:`~.metrics.MetricsRegistry`, windowed p50/p90/p99);
- per-frame spans collected onto ``frame.spans`` and published to the
  :class:`~.tracing.TraceBuffer` at frame completion -- including spans
  returned from a remote pipeline, so the origin holds the whole trace;
- windowed rollups published under ``share["telemetry"]`` (throttled to
  ``telemetry_interval`` seconds) so ECConsumer/Dashboard see
  percentiles for free;
- the Prometheus-style text exposition behind
  ``Pipeline.metrics_text()`` / the ``--metrics-port`` HTTP endpoint.

Threading contract: hook handlers and ``frame_started``/
``frame_finished`` run ONLY on the pipeline's event loop (stage workers
post continuations; the hooks fire when those continuations resume on
the loop), so ``frame.metrics``/``frame.spans`` stay loop-confined.
The registry and trace buffer are internally locked -- they are the
ONLY telemetry state other threads (metrics HTTP server, dashboards)
may read.
"""

from __future__ import annotations

import time

from .critical_path import attribute_metrics
from .metrics import HISTOGRAM_WINDOW_DEFAULT, MetricsRegistry
from .tracing import TRACE_CAPACITY_DEFAULT, TraceBuffer, make_span, \
    mint_id

__all__ = ["PipelineTelemetry", "TELEMETRY_INTERVAL_DEFAULT"]

TELEMETRY_INTERVAL_DEFAULT = 1.0     # seconds between share publishes


def _is_error(event) -> bool:
    return getattr(event, "name", str(event)) == "ERROR"


class PipelineTelemetry:
    def __init__(self, pipeline,
                 window_s: float = HISTOGRAM_WINDOW_DEFAULT,
                 trace_capacity: int = TRACE_CAPACITY_DEFAULT,
                 publish_interval: float = TELEMETRY_INTERVAL_DEFAULT):
        self.pipeline = pipeline
        self.registry = MetricsRegistry(window_s)
        self.traces = TraceBuffer(trace_capacity)
        self.publish_interval = float(publish_interval)
        self._last_publish = 0.0
        # Open spans keyed (kind, name, stream, frame) -> (span_id,
        # wall start).  Loop-confined, like frame.metrics.  Bounded:
        # frames that never reach frame_finished (stream destroyed
        # with frames in flight, stale wire re-ingest replacements)
        # would otherwise leak their open keys forever.
        self._open: dict[tuple, tuple[str, float]] = {}
        # Spans completed after their frame left stream.frames (the
        # final stage's post hook fires from _release_stage AFTER
        # _frame_done pops the frame): buffered here keyed
        # (stream, frame_id) and drained by frame_finished.  Bounded:
        # entries for frames that never finish are evicted oldest-first.
        self._pending: dict[tuple, list] = {}
        for hook_name, handler in (
                ("pipeline.process_element:0", self._on_element),
                ("pipeline.process_element_post:0",
                 self._on_element_post),
                ("pipeline.process_segment:0", self._on_segment),
                ("pipeline.process_segment_post:0",
                 self._on_segment_post),
                ("pipeline.process_stage:0", self._on_stage),
                ("pipeline.process_stage_post:0", self._on_stage_post),
                ("pipeline.stage_hop:0", self._on_stage_hop)):
            pipeline.add_hook_handler(hook_name, handler)

    # -- frame lifecycle (called by the engine, on the loop) ---------------

    def frame_started(self, frame, trace_id=None, parent_id=None) -> None:
        """Mint (or adopt, for frames forwarded from another process)
        the frame's trace context.  Idempotent: retries re-enter with
        the context already set."""
        if frame.trace_id is not None:
            return
        if trace_id:
            frame.trace_id = str(trace_id)
            frame.trace_parent = str(parent_id) if parent_id else None
            frame.trace_remote = True
        else:
            frame.trace_id = mint_id()
        frame.trace_root = mint_id()
        frame.trace_start = time.time()

    def frame_finished(self, stream, frame, okay: bool) -> None:
        """Close the frame's trace (root span + any dangling opens),
        feed the e2e histograms and counters, publish the trace, and
        maybe refresh the share rollup."""
        if frame.trace_done:
            return
        frame.trace_done = True
        registry = self.registry
        now = time.time()
        stream_id = stream.stream_id
        # Dangling opens for this frame (element raised without a post
        # hook reaching us, stream destroyed mid-walk): close them so
        # the trace never loses a started event.
        for key in [key for key in self._open
                    if key[2] == stream_id and key[3] == frame.frame_id]:
            span_id, start = self._open.pop(key)
            kind, name = key[0], key[1]
            frame.spans.append(self._span(
                frame, span_id, f"{kind}:{name}", kind, start,
                (now - start) * 1000.0, status="unclosed"))
        # Spans that completed after the frame left stream.frames (the
        # final stage's post hook): adopt them into this trace.
        for span in self._pending.pop((stream_id, frame.frame_id), []):
            span["trace_id"] = frame.trace_id or ""
            span["parent_id"] = frame.trace_root
            frame.spans.append(span)
        elapsed = frame.metrics.get("time_pipeline")
        if elapsed is None:
            # Error frames never reach _frame_done's stamp: measure
            # from the walk-start perf stamp (or the trace mint) so a
            # failing stream cannot drag the latency p50 toward zero.
            start = frame.metrics.get("time_pipeline_start")
            elapsed = time.perf_counter() - start \
                if start is not None else now - frame.trace_start
        elapsed_ms = elapsed * 1000.0
        registry.observe("frame_latency_ms", elapsed_ms)
        registry.count("frames_total",
                       status="ok" if okay else "error")
        # Critical-path attribution (ISSUE 10): split the frame's e2e
        # latency into named buckets from the engine's own metric
        # stamps -- fed to the frame_<bucket>_ms histograms here and
        # attached to the trace entry below so ``Pipeline.explain()``
        # aggregates without re-deriving.  Frames forwarded FROM
        # another process carry no walk-start stamp of their own e2e;
        # attribute against the measured elapsed either way.
        attribution = attribute_metrics(frame.metrics, elapsed_ms)
        for bucket, bucket_ms in attribution["buckets"].items():
            if bucket_ms > 0.0:
                registry.observe(f"frame_{bucket}_ms", bucket_ms)
        if frame.metrics.get("remote_retries"):
            registry.count("remote_stage_retries",
                           frame.metrics["remote_retries"])
        # Stage admission / worker-queue waits stamped by the engine.
        for key, value in frame.metrics.items():
            if key.endswith("_wait_ms"):
                registry.observe("stage_admission_wait_ms", value,
                                 stage=key[6:-8])     # stage_<s>_wait_ms
            elif key.endswith("_queue_ms"):
                registry.observe("stage_queue_wait_ms", value,
                                 stage=key[:-9])
        if frame.trace_id is not None:
            frame.spans.append(make_span(
                frame.trace_id, frame.trace_root, frame.trace_parent,
                f"frame:{frame.frame_id}", "frame", self.pipeline.name,
                stream_id, frame.frame_id, frame.trace_start,
                elapsed_ms or (now - frame.trace_start) * 1000.0,
                status="ok" if okay else "error"))
            self.traces.add(frame.trace_id, frame.spans, okay,
                            attribution=attribution)
        self.publish()

    # -- hook handlers (always on the loop) --------------------------------

    def _span(self, frame, span_id: str, name: str, kind: str,
              start: float, duration_ms: float,
              status: str = "ok") -> dict:
        return make_span(frame.trace_id or "", span_id,
                         frame.trace_root, name, kind,
                         self.pipeline.name, "", frame.frame_id,
                         start, duration_ms, status)

    def _frame_of(self, variables):
        stream = self.pipeline.streams.get(str(variables.get("stream")))
        if stream is None:
            return None
        return stream.frames.get(variables.get("frame"))

    def _exit(self, kind: str, name, variables, elapsed_ms: float,
              **labels) -> None:
        """Close an open span (the caller already observed the series
        -- emission names stay DIRECT literals at .observe sites so the
        ``metric-registry`` selfcheck can collect them statically)."""
        key = (kind, name, str(variables.get("stream")),
               variables.get("frame"))
        opened = self._open.pop(key, None)
        event = variables.get("event")
        if _is_error(event):
            self.registry.count("element_errors_total", **labels)
        if opened is None:
            return
        span_id, start = opened
        frame = self._frame_of(variables)
        status = "error" if _is_error(event) else "ok"
        if frame is not None:
            frame.spans.append(self._span(
                frame, span_id, f"{kind}:{name}", kind, start,
                elapsed_ms, status))
            frame.spans[-1]["stream"] = str(variables.get("stream"))
            return
        # Frame already completed its walk (final-stage release):
        # buffer; frame_finished will attach trace/root ids and drain.
        self._buffer_pending(
            (str(variables.get("stream")), variables.get("frame")),
            make_span("", span_id, None, f"{kind}:{name}", kind,
                      self.pipeline.name, variables.get("stream"),
                      variables.get("frame"), start, elapsed_ms,
                      status))

    def _buffer_pending(self, key: tuple, span: dict) -> None:
        self._pending.setdefault(key, []).append(span)
        while len(self._pending) > 512:       # never-finished frames
            self._pending.pop(next(iter(self._pending)))

    def _note_open(self, key: tuple) -> None:
        self._open[key] = (mint_id(), time.time())
        while len(self._open) > 2048:         # never-finished frames
            self._open.pop(next(iter(self._open)))

    def stream_destroyed(self, stream_id: str) -> None:
        """Purge span state for a destroyed stream's frames.  Frame ids
        restart per stream, so a recreated same-id stream's frames
        would otherwise collide with the dead incarnation's keys and
        graft its stale spans onto fresh traces -- the same
        stale-same-id-stream class PR 3 hardened the engine against."""
        stream_id = str(stream_id)
        for key in [key for key in self._open if key[2] == stream_id]:
            self._open.pop(key)
        for key in [key for key in self._pending
                    if key[0] == stream_id]:
            self._pending.pop(key)

    def _on_element(self, component, hook, variables):
        self._note_open(("element", variables.get("element"),
                         str(variables.get("stream")),
                         variables.get("frame")))

    def _on_element_post(self, component, hook, variables):
        name = variables.get("element")
        elapsed_ms = float(variables.get("time", 0.0)) * 1000.0
        self.registry.observe("element_latency_ms", elapsed_ms,
                              element=name)
        self._exit("element", name, variables, elapsed_ms,
                   element=name)

    def _on_segment(self, component, hook, variables):
        self._note_open(("segment", variables.get("segment"),
                         str(variables.get("stream")),
                         variables.get("frame")))
        if variables.get("compile"):
            self.registry.count("segment_compiles_total",
                                segment=variables.get("segment"))

    def _on_segment_post(self, component, hook, variables):
        name = variables.get("segment")
        elapsed_ms = float(variables.get("time", 0.0)) * 1000.0
        self.registry.observe("segment_latency_ms", elapsed_ms,
                              segment=name)
        self._exit("segment", name, variables, elapsed_ms,
                   segment=name)

    def _on_stage(self, component, hook, variables):
        self._note_open(("stage", variables.get("stage"),
                         str(variables.get("stream")),
                         variables.get("frame")))

    def _on_stage_post(self, component, hook, variables):
        # The engine passes the measured residency (admit -> release).
        name = variables.get("stage")
        elapsed_ms = float(variables.get(
            "time", float(variables.get("ms", 0.0)) / 1000.0)) * 1000.0
        self.registry.observe("stage_latency_ms", elapsed_ms,
                              stage=name)
        self._exit("stage", name, variables, elapsed_ms, stage=name)

    def _on_stage_hop(self, component, hook, variables):
        hop_ms = float(variables.get("ms", 0.0))
        self.registry.observe("stage_hop_ms", hop_ms,
                              stage=variables.get("stage"))
        frame = self._frame_of(variables)
        if frame is None:
            return
        # The hook fires after the hop dispatched: back-date the span's
        # start so it renders where the hop actually began.
        frame.spans.append(self._span(
            frame, mint_id(), f"hop:{variables.get('stage')}", "hop",
            time.time() - hop_ms / 1000.0, hop_ms))

    # -- rollup / share / exposition ---------------------------------------

    def rollup(self, windowed: bool = True) -> dict:
        """The share-shaped view: nested dicts the dashboard flattens
        into ``telemetry.*`` keys."""
        result: dict = {"frame": {}, "element": {}, "segment": {},
                        "stage": {}, "hop": {}, "queue": {}}
        for name, labels, summary in self.registry.summaries(windowed):
            brief = {"count": summary["count"],
                     "p50_ms": summary["p50_ms"],
                     "p90_ms": summary["p90_ms"],
                     "p99_ms": summary["p99_ms"]}
            if name in ("llm_ttft_ms", "llm_tpot_ms"):
                # LLM serving latency (ISSUE 8): per-request time to
                # first token and per-output-token rate, fed by the
                # serving element's batcher; rides share as
                # telemetry.llm.* next to the llm_accepted_tokens /
                # llm_draft_tokens counters below.  Tenant/class labels
                # (ISSUE 19) key as ttft.<tenant>.<cls> so two labeled
                # series never overwrite one dict slot.
                key = name[4:]
                if labels:
                    key += "." + ".".join(
                        str(labels[label])
                        for label in sorted(labels))
                result.setdefault("llm", {})[key] = brief
                continue
            if name.startswith("frame_") and name.endswith("_ms") \
                    and name != "frame_latency_ms":
                # Critical-path buckets (ISSUE 10): telemetry.buckets.*
                # on the dashboard -- the live "where is time going".
                result.setdefault("buckets", {})[name[6:-3]] = brief
                continue
            if name == "gateway_e2e_ms":
                # Gateway front door (ISSUE 12): per-class session
                # latency -- telemetry.gateway.* on the dashboard,
                # the live per-class SLO view.  With the tenant label
                # (ISSUE 19) the per-class key keeps the LAST tenant's
                # brief (dashboard headline); the exact per-tenant
                # split rides gateway_tenants.<tenant>.<cls>.
                result.setdefault("gateway", {})[
                    labels.get("cls", "?")] = brief
                if labels.get("tenant"):
                    result.setdefault("gateway_tenants", {}) \
                        .setdefault(labels["tenant"], {})[
                        labels.get("cls", "?")] = brief
                continue
            if name == "frame_latency_ms":
                result["frame"] = brief
            elif name == "element_latency_ms":
                result["element"][labels.get("element", "?")] = brief
            elif name == "segment_latency_ms":
                result["segment"][labels.get("segment", "?")] = brief
            elif name == "stage_latency_ms":
                result["stage"][labels.get("stage", "?")] = brief
            elif name == "stage_hop_ms":
                result["hop"][labels.get("stage", "?")] = brief
            elif name in ("stage_admission_wait_ms",
                          "stage_queue_wait_ms", "ingest_pace_ms"):
                result["queue"][labels.get("stage", name)] = brief
        result["counters"] = {
            name + ("" if not labels else
                    "." + ".".join(str(v) for v in labels.values())):
            value for name, labels, value in self.registry.counters()}
        result["traces"] = {"buffered": len(self.traces),
                            "completed": self.traces.completed}
        # Replicated stages (ISSUE 7): slot states + per-replica
        # in-flight/occupancy, flattened as telemetry.replicas.* on
        # the dashboard next to the failover/rebuild share counters.
        try:
            replicas = self.pipeline.replica_stats()
        except Exception:
            replicas = {}
        if replicas:
            result["replicas"] = {
                stage: {"states": entry.get("states", []),
                        "active": entry.get("active", []),
                        "occupancy": entry.get("occupancy", [])}
                for stage, entry in replicas.get("stages", {}).items()}
        # Unified QoS (ISSUE 12): per-tenant budget/in-flight/shed rows
        # -- telemetry.tenants.* on the dashboard, next to the
        # telemetry.gateway.* per-class latency above.
        qos = getattr(self.pipeline, "qos", None)
        if qos is not None:
            result["tenants"] = qos.stats()["tenants"]
        return result

    def publish(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_publish < self.publish_interval:
            return
        self._last_publish = now
        try:
            self.pipeline.ec_producer.update("telemetry", self.rollup())
        except Exception:
            self.pipeline.logger.exception("telemetry publish failed")

    def metrics_text(self) -> str:
        """Prometheus-style exposition.  Refreshes the gauges that live
        elsewhere in the engine (transfer ledger, jit caches, stage
        occupancy) so a scrape always sees current values.  Safe from
        any thread (registry + sources are locked or GIL-atomic)."""
        pipeline = self.pipeline
        registry = self.registry
        registry.gauge("frames_processed",
                       pipeline.share.get("frames_processed", 0))
        registry.gauge("streams_active", len(pipeline.streams))
        ledger = pipeline.transfer_ledger
        registry.gauge("swag_host_transfers", ledger.implicit)
        registry.gauge("swag_explicit_fetches", ledger.explicit)
        # Failure-recovery plane (ISSUE 5): per-remote-stage breaker
        # state (0 closed, 0.5 half-open, 1 open).  The replay/shed/
        # deadline totals are COUNTERS fed at the transition sites --
        # refreshing them as gauges too would emit the same sample
        # name twice and invalidate the whole scrape (the PR 9
        # data_plane_fallbacks lesson).
        for stage, breaker in getattr(pipeline, "breakers", {}).items():
            registry.gauge("breaker_state", breaker.state_value,
                           stage=stage)
        try:
            jit = pipeline.jit_stats()
            for key in ("hits", "misses", "entries"):
                registry.gauge(f"jit_cache_{key}", jit[key])
        except Exception:
            pass
        fusion = pipeline.fusion_stats()
        registry.gauge("fused_segments", fusion["segments"])
        registry.gauge("fused_dispatches", fusion["dispatches"])
        if pipeline.stage_scheduler is not None:
            for stage, entry in pipeline.stage_scheduler.stats.items():
                registry.gauge("stage_occupancy", entry["occupancy"],
                               stage=stage)
                registry.gauge("stage_queue_depth", entry["waiting"],
                               stage=stage)
            # Replicated stages (ISSUE 7): per-slot state (1 live /
            # 0.5 half-open / 0 dead), in-flight depth and occupancy
            # -- the scrape-side view of peer-shedding failover and
            # the signals the autoscale control loop acts on.
            for stage, group in pipeline.stage_scheduler.groups.items():
                for index, state in enumerate(group.states):
                    value = {"live": 1.0, "half_open": 0.5}.get(state,
                                                                0.0)
                    labels = {"stage": stage, "replica": str(index)}
                    registry.gauge("replica_state", value, **labels)
                    registry.gauge("replica_inflight",
                                   group.active[index], **labels)
                    registry.gauge("replica_occupancy",
                                   round(group.occupancy(index), 4),
                                   **labels)
        # Binary data plane (ISSUE 9): path split, negotiated
        # fallbacks and endpoint drops -- the scrape-side proof that
        # remote tensors ride the pipe (and that drops are never
        # silent, the satellite contract on tensor_pipe's queue).
        plane = getattr(pipeline, "data_plane_stats", None)
        if callable(plane):
            try:
                stats = plane()
            except Exception:
                stats = {}
            if stats:
                registry.gauge("data_plane_frames",
                               stats.get("pipe_frames", 0))
                registry.gauge("data_plane_fallbacks",
                               stats.get("fallbacks", 0))
                registry.gauge("tensor_pipe_dropped_frames",
                               stats.get("dropped_frames", 0))
        # Gateway + unified QoS (ISSUE 12): live sessions, per-tenant
        # in-flight vs budget, and token-bucket headroom -- the
        # scrape-side view of who is over budget (and therefore who
        # sheds first under overload).  The admit/reject/shed TOTALS
        # are counters fed at the admission sites; only the
        # instantaneous state refreshes here (the counter-vs-gauge
        # discipline from PR 10).
        gateway = getattr(pipeline, "gateway", None)
        if gateway is not None:
            registry.gauge("gateway_sessions", gateway.session_count())
        qos = getattr(pipeline, "qos", None)
        if qos is not None:
            for tenant, entry in qos.stats()["tenants"].items():
                registry.gauge("qos_inflight", entry["inflight"],
                               tenant=tenant)
                registry.gauge("qos_over_budget",
                               1.0 if entry["over_budget"] else 0.0,
                               tenant=tenant)
        # Flight recorder (ISSUE 10): ring depth + lifetime event count
        # -- a scrape-side signal the always-on recorder is recording
        # (and how far back a black-box dump's tail can reach).
        recorder = getattr(pipeline, "recorder", None)
        if recorder is not None:
            registry.gauge("recorder_events", recorder.recorded)
            registry.gauge("recorder_buffered", len(recorder))
        registry.gauge("traces_buffered", len(self.traces))
        registry.gauge("traces_completed", self.traces.completed)
        return registry.render_text()
