"""Observability plane: distributed frame tracing, streaming latency
histograms, the flight recorder + critical-path attribution, and the
metrics export surface (ISSUE 4 tentpole; ISSUE 10 recorder/explain).

The reference framework's core value was its live shared-state
observability (ECProducer share + Dashboard); the perf PRs added deep
per-frame instrumentation but no aggregation.  This package closes the
loop: hooks -> histograms/spans -> share + Prometheus text + traces,
and (ISSUE 10) engine events -> per-frame causal timelines + latency
bucket attribution + black-box dumps.

Import surface is jax-free: dashboards and exporters can use it without
pulling in the TPU stack.
"""

from .metrics import (HISTOGRAM_WINDOW_DEFAULT, LogHistogram,
                      MetricsRegistry)
from .tracing import (TRACE_CAPACITY_DEFAULT, TraceBuffer, decode_spans,
                      encode_spans, make_span, mint_id)
from .recorder import (BLACKBOX_LIMIT_DEFAULT, RECORDER_CAPACITY_DEFAULT,
                       FlightRecorder, events_as_dicts,
                       select_frame_events, write_blackbox)
from .critical_path import (BUCKETS, aggregate_traces, attribute_events,
                            attribute_metrics, render_buckets,
                            render_timeline)
from .telemetry import TELEMETRY_INTERVAL_DEFAULT, PipelineTelemetry
from .exporter import MetricsServer
from .fleet import FLEET_SCRAPE_MS_DEFAULT, FleetCollector

__all__ = ["LogHistogram", "MetricsRegistry", "TraceBuffer",
           "PipelineTelemetry", "MetricsServer", "FleetCollector",
           "FLEET_SCRAPE_MS_DEFAULT",
           "make_span", "mint_id",
           "encode_spans", "decode_spans", "HISTOGRAM_WINDOW_DEFAULT",
           "TRACE_CAPACITY_DEFAULT", "TELEMETRY_INTERVAL_DEFAULT",
           "FlightRecorder", "events_as_dicts", "select_frame_events",
           "write_blackbox",
           "RECORDER_CAPACITY_DEFAULT", "BLACKBOX_LIMIT_DEFAULT",
           "BUCKETS", "attribute_metrics", "attribute_events",
           "aggregate_traces", "render_timeline", "render_buckets"]
