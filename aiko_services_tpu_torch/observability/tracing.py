"""Distributed frame tracing: trace ids, spans, and the TraceBuffer.

Every frame is minted a ``trace_id`` + root span id at ingest.  As the
frame walks the graph, the telemetry plane (observability/telemetry.py)
records one span per element / fused-segment dispatch / stage residency
/ ICI hop, each parented under the frame's root span.  When a frame
crosses a :class:`~aiko_services_tpu_torch.pipeline.pipeline.RemoteStage` hop
the trace context (trace_id + the hop span's id) rides the
``process_frame`` payload over the control fabric; the remote pipeline
stamps its own spans under that parent and returns them in the
``process_frame_response`` payload, so the ORIGIN process reconstructs
the frame's whole path across processes as ONE trace.

Spans are plain dicts (JSON- and wire-friendly)::

    {"trace_id": ..., "span_id": ..., "parent_id": ...,
     "name": "element:DET", "kind": "element" | "segment" | "stage" |
     "hop" | "remote" | "frame", "process": <pipeline name>,
     "stream": ..., "frame": ..., "start": <epoch s>,
     "duration_ms": ..., "status": "ok" | "error" | "unclosed"}

The :class:`TraceBuffer` is a bounded ring of recently completed traces
-- queryable locally (``pipeline.telemetry.traces``), over HTTP
(``/traces`` on ``--metrics-port``), and summarized on the share dict
(``telemetry.traces``) for ECConsumer/Dashboard.

Relation to xprof: the profiler's ``element:``/``segment:``/``stage:``/
``hop:`` TraceAnnotations (tpu/profiling.py) are the SAME events on the
XLA timeline -- spans here carry ids and cross process boundaries;
xprof spans carry device-op alignment.  Same names, two renderings.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import uuid
from collections import OrderedDict

__all__ = ["mint_id", "make_span", "encode_spans", "decode_spans",
           "TraceBuffer", "TRACE_CAPACITY_DEFAULT"]

TRACE_CAPACITY_DEFAULT = 256


def mint_id() -> str:
    """A 16-hex-char id (64 bits): unique enough per namespace, short
    enough to ride every control-plane payload."""
    return uuid.uuid4().hex[:16]


def make_span(trace_id: str, span_id: str, parent_id: str | None,
              name: str, kind: str, process: str, stream, frame,
              start: float, duration_ms: float,
              status: str = "ok") -> dict:
    return {"trace_id": trace_id, "span_id": span_id,
            "parent_id": parent_id, "name": name, "kind": kind,
            "process": process, "stream": str(stream),
            "frame": frame, "start": round(start, 6),
            "duration_ms": round(float(duration_ms), 4),
            "status": status}


def encode_spans(spans: list[dict]) -> str:
    """Base64(JSON) -- S-expression-symbol-safe, so a span list can ride
    a ``process_frame_response`` stream_dict value untouched."""
    return base64.b64encode(
        json.dumps(spans, separators=(",", ":")).encode()).decode()


def decode_spans(text: str) -> list[dict]:
    try:
        spans = json.loads(base64.b64decode(str(text)).decode())
    except (ValueError, TypeError):
        return []
    return spans if isinstance(spans, list) else []


class TraceBuffer:
    """Bounded ring of completed traces, newest last.

    ``add`` merges: the origin process adds its local spans at frame
    completion and a trace_id seen again (unusual -- e.g. a test
    completing the same logical trace through two pipelines sharing a
    buffer) extends rather than replaces.  Thread-safe: completion runs
    on the event loop while the metrics HTTP thread reads.
    """

    def __init__(self, capacity: int = TRACE_CAPACITY_DEFAULT):
        self.capacity = max(1, int(capacity))
        self._traces: OrderedDict[str, dict] = OrderedDict()
        self._lock = threading.Lock()
        self.completed = 0

    def add(self, trace_id: str, spans: list[dict], okay: bool = True,
            attribution: dict | None = None) -> None:
        """``attribution`` (ISSUE 10) is the frame's critical-path
        bucket split from ``critical_path.attribute_metrics``: its
        buckets/stages/e2e land on the trace entry so ``explain()``
        and the ``/explain`` route aggregate without re-deriving."""
        if not trace_id:
            return
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                entry = self._traces[trace_id] = {
                    "trace_id": trace_id, "okay": bool(okay),
                    "finished": time.time(), "spans": []}
                self.completed += 1
            entry["spans"].extend(spans)
            entry["okay"] = entry["okay"] and bool(okay)
            entry["finished"] = time.time()
            if attribution:
                for key in ("buckets", "stages", "e2e_ms",
                            "unattributed_ms", "coverage"):
                    if attribution.get(key) is not None:
                        entry[key] = attribution[key]
            self._traces.move_to_end(trace_id)
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            entry = self._traces.get(trace_id)
            return None if entry is None else _copy_trace(entry)

    def recent(self, n: int = 20) -> list[dict]:
        with self._lock:
            entries = list(self._traces.values())[-n:]
            return [_copy_trace(entry) for entry in entries]

    def snapshot(self) -> list[dict]:
        """Every buffered trace, copied under the lock (oldest first)
        -- the iteration surface ``explain()``/scrapes use; iterating
        the live OrderedDict from another thread would race adds."""
        with self._lock:
            return [_copy_trace(entry)
                    for entry in self._traces.values()]

    def by_frame(self, frame_id, stream=None) -> dict | None:
        """The NEWEST trace containing a span for ``frame_id`` (and
        ``stream`` when given) -- the explain_frame lookup."""
        frame_id = int(frame_id)
        stream = None if stream is None else str(stream)
        with self._lock:
            for entry in reversed(self._traces.values()):
                for span in entry["spans"]:
                    try:
                        match = int(span.get("frame")) == frame_id
                    except (TypeError, ValueError):
                        continue
                    if match and (stream is None
                                  or str(span.get("stream")) == stream):
                        return _copy_trace(entry)
        return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


def _copy_trace(entry: dict) -> dict:
    copied = dict(entry)
    copied["spans"] = list(entry["spans"])
    return copied
