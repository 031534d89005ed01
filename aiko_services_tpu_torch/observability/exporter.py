"""HTTP export surface for the telemetry plane.

A tiny stdlib HTTP server (daemon thread) serving:

- ``GET /metrics`` -- the Prometheus-style text exposition
  (``Pipeline.metrics_text()``);
- ``GET /traces`` -- recent completed traces from the
  :class:`~.tracing.TraceBuffer` as JSON (``?limit=`` bounds the
  count, default 50, max 1000; ``?n=`` is the legacy alias);
- ``GET /traces/<trace_id>`` -- one reconstructed trace;
- ``GET /explain`` -- the aggregate critical-path report
  (``Pipeline.explain()``; ``?top=`` bounds the contributor list,
  ``?frame=<id>[&stream=<id>]`` returns one frame's
  ``explain_frame`` timeline instead).

Wired from the CLI via ``--metrics-port`` (0 picks a free port; the
bound port is echoed).  The handlers read only lock-protected telemetry
state, so serving from a non-engine thread is safe by construction.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..utils import get_logger

__all__ = ["MetricsServer"]

_logger = get_logger("aiko.observability")


class MetricsServer:
    """Serve one pipeline's telemetry over HTTP on ``port``.

    Binds loopback by default: /metrics and /traces expose element
    names, timings and topology, so reaching them from other hosts is
    an explicit operator choice (``--metrics-host 0.0.0.0``)."""

    def __init__(self, pipeline, port: int = 0,
                 host: str = "127.0.0.1"):
        self.pipeline = pipeline
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, format, *args):      # quiet by default
                _logger.debug("metrics http: " + format, *args)

            def do_GET(self):
                try:
                    server._route(self)
                except BrokenPipeError:                # client went away
                    pass
                except Exception:
                    _logger.exception("metrics http handler failed")
                    try:
                        self.send_error(500)
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"metrics-http-{self.port}")
        self._thread.start()
        _logger.info("metrics endpoint on :%d (/metrics, /traces)",
                     self.port)

    def _route(self, handler: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(handler.path)
        path = parsed.path.rstrip("/") or "/"
        telemetry = getattr(self.pipeline, "telemetry", None)
        if path == "/metrics":
            if telemetry is None:
                handler.send_error(404, "telemetry disabled")
                return
            body = telemetry.metrics_text().encode()
            self._reply(handler, body,
                        "text/plain; version=0.0.4; charset=utf-8")
            return
        if path == "/metrics/raw":
            # The fleet aggregator's scrape format: exact histogram
            # bucket counts (the text exposition only carries
            # quantiles, which cannot be merged across processes).
            if telemetry is None:
                handler.send_error(404, "telemetry disabled")
                return
            telemetry.metrics_text()      # refresh the gauge snapshot
            payload = telemetry.registry.state()
            payload["pipeline"] = getattr(self.pipeline, "name", "?")
            self._reply(handler, json.dumps(payload).encode(),
                        "application/json")
            return
        if path == "/traces" or path.startswith("/traces/"):
            if telemetry is None:
                handler.send_error(404, "telemetry disabled")
                return
            if path.startswith("/traces/"):
                trace = telemetry.traces.get(path[len("/traces/"):])
                if trace is None:
                    handler.send_error(404, "unknown trace")
                    return
                payload = trace
            else:
                query = parse_qs(parsed.query)
                raw = query.get("limit", query.get("n", ["50"]))[0]
                try:
                    n = int(raw)
                except ValueError:
                    handler.send_error(400, "limit must be an integer")
                    return
                if n <= 0:        # list[-0:] would be EVERYTHING
                    handler.send_error(400, "limit must be positive")
                    return
                # Bounded body + snapshot-under-lock iteration: a
                # scrape during heavy ingest never races the buffer
                # and never returns an unbounded payload.
                payload = {"traces": telemetry.traces.recent(
                    min(n, 1000))}
            self._reply(handler, json.dumps(payload).encode(),
                        "application/json")
            return
        if path == "/explain":
            if telemetry is None:
                handler.send_error(404, "telemetry disabled")
                return
            query = parse_qs(parsed.query)
            try:
                frame = query.get("frame")
                trace = query.get("trace")
                if trace is not None:
                    # A gateway-minted trace id names the request end
                    # to end; explain_frame resolves it to the frame
                    # its spans carry.
                    payload = self.pipeline.explain_frame(
                        str(trace[0]),
                        stream_id=query.get("stream", [None])[0])
                    if payload is None:
                        handler.send_error(404, "unknown trace")
                        return
                elif frame is not None:
                    payload = self.pipeline.explain_frame(
                        int(frame[0]),
                        stream_id=query.get("stream", [None])[0])
                    if payload is None:
                        handler.send_error(404, "unknown frame")
                        return
                else:
                    payload = self.pipeline.explain(
                        top_k=min(int(query.get("top", ["5"])[0]), 50))
            except ValueError:
                handler.send_error(400, "frame/top must be integers")
                return
            self._reply(handler, json.dumps(payload).encode(),
                        "application/json")
            return
        handler.send_error(404, "try /metrics, /traces or /explain")

    @staticmethod
    def _reply(handler, body: bytes, content_type: str) -> None:
        handler.send_response(200)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
