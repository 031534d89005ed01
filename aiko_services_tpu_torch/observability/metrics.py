"""Streaming metrics: O(1)-update log histograms and a labeled registry.

The perf PRs (overlap, fusion, stage-parallel) stamp per-frame numbers
into ``frame.metrics`` and fire per-event hooks, but every number dies
with its frame: nothing aggregates p50/p99 latency or queue depth over
time.  Vortex (arXiv:2511.02062) and the profiled-segmentation work
(arXiv:2503.01025) both make placement/serving decisions off exactly
this kind of percentile-resolved telemetry, so this module provides the
aggregation primitives the telemetry plane builds on:

- :class:`LogHistogram` -- a fixed-bucket log-scale histogram.  Updates
  are O(1) (one ``math.log``, one list increment, no allocation);
  quantiles interpolate geometrically inside a bucket, so the relative
  error is bounded by the bucket growth factor (~9% at 2^0.25).  Two
  windows rotate (current + previous) so windowed quantiles cover the
  last 1-2 windows of traffic while cumulative counts never reset --
  the Prometheus exposition wants monotonic counters, the dashboard
  wants "now".
- :class:`MetricsRegistry` -- named, labeled series (histograms,
  counters, gauges) behind one lock: hooks feed it from the event loop
  while the ``--metrics-port`` HTTP thread renders it, so every method
  is safe from any thread.

All histogram values are MILLISECONDS by convention (``*_ms`` series
names); counters and gauges are unitless.
"""

from __future__ import annotations

import math
import threading
import time

__all__ = ["LogHistogram", "MetricsRegistry", "HISTOGRAM_WINDOW_DEFAULT"]

HISTOGRAM_WINDOW_DEFAULT = 10.0      # seconds per rotation window

# Bucket 0 is the underflow bucket [0, _LOW); bucket i >= 1 covers
# [_LOW * _GROWTH**(i-1), _LOW * _GROWTH**i).  With _LOW = 1 microsecond
# (in ms) and 128 buckets the top bucket sits near an hour -- the whole
# latency range any pipeline event can plausibly occupy.
_LOW = 1e-3
_GROWTH = 2.0 ** 0.25
_LOG_GROWTH = math.log(_GROWTH)
_BUCKETS = 128


class LogHistogram:
    """Fixed-bucket log histogram with windowed and cumulative views."""

    __slots__ = ("counts", "window", "previous", "count", "total",
                 "vmin", "vmax", "window_s", "_window_start")

    def __init__(self, window_s: float = HISTOGRAM_WINDOW_DEFAULT):
        self.counts = [0] * _BUCKETS       # cumulative, never reset
        self.window = [0] * _BUCKETS       # current rotation window
        self.previous = [0] * _BUCKETS     # last completed window
        self.count = 0
        self.total = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None
        self.window_s = float(window_s)
        self._window_start = time.monotonic()

    @staticmethod
    def _bucket(value: float) -> int:
        if value < _LOW:
            return 0
        index = int(math.log(value / _LOW) / _LOG_GROWTH) + 1
        return index if index < _BUCKETS else _BUCKETS - 1

    def _rotate(self, now: float) -> None:
        elapsed = now - self._window_start
        if elapsed < self.window_s:
            return
        if elapsed < 2.0 * self.window_s:
            self.previous = self.window
        else:                               # idle >= a full window: both stale
            self.previous = [0] * _BUCKETS
        self.window = [0] * _BUCKETS
        self._window_start = now

    def observe(self, value: float) -> None:
        value = float(value)
        if value < 0.0:
            value = 0.0
        self._rotate(time.monotonic())
        bucket = self._bucket(value)
        self.counts[bucket] += 1
        self.window[bucket] += 1
        self.count += 1
        self.total += value
        if self.vmin is None or value < self.vmin:
            self.vmin = value
        if self.vmax is None or value > self.vmax:
            self.vmax = value

    @staticmethod
    def _bucket_value(index: int) -> float:
        if index == 0:
            return _LOW / 2.0
        # Geometric midpoint of [_LOW*G**(i-1), _LOW*G**i).
        return _LOW * (_GROWTH ** (index - 1)) * math.sqrt(_GROWTH)

    def quantile(self, q: float, windowed: bool = True) -> float | None:
        """The q-quantile (0..1).  ``windowed`` restricts to the last
        1-2 rotation windows; cumulative otherwise.  None when empty."""
        if windowed:
            self._rotate(time.monotonic())
            merged = [w + p for w, p in zip(self.window, self.previous)]
        else:
            merged = self.counts
        population = sum(merged)
        if population == 0:
            return None
        rank = q * (population - 1)
        seen = 0
        for index, bucket_count in enumerate(merged):
            seen += bucket_count
            if seen > rank:
                value = self._bucket_value(index)
                # Clamp into the observed range: interpolation must not
                # report a p99 above the largest value ever seen.
                if self.vmax is not None:
                    value = min(value, self.vmax)
                if self.vmin is not None:
                    value = max(value, self.vmin)
                return value
        return self.vmax

    def state(self) -> dict:
        """Raw cumulative state: the exact-merge substrate the fleet
        aggregator scrapes (``/metrics/raw``).  Every LogHistogram in
        the fleet shares the same fixed bucket edges, so cross-process
        merge is element-wise addition -- no quantile sketch error on
        top of the bucketing error."""
        return {"counts": list(self.counts), "count": self.count,
                "total": self.total, "vmin": self.vmin,
                "vmax": self.vmax}

    def merge_state(self, state: dict) -> None:
        """Fold one scraped :meth:`state` in (addition; same edges)."""
        counts = state.get("counts") or []
        for index in range(min(len(counts), _BUCKETS)):
            self.counts[index] += int(counts[index])
        self.count += int(state.get("count", 0))
        self.total += float(state.get("total", 0.0))
        for name, pick in (("vmin", min), ("vmax", max)):
            theirs = state.get(name)
            if theirs is None:
                continue
            ours = getattr(self, name)
            setattr(self, name, float(theirs) if ours is None
                    else pick(ours, float(theirs)))

    def summary(self, windowed: bool = True) -> dict:
        return {"count": self.count,
                "sum_ms": round(self.total, 3),
                "min_ms": round(self.vmin, 4) if self.vmin is not None
                else None,
                "max_ms": round(self.vmax, 4) if self.vmax is not None
                else None,
                "p50_ms": _round(self.quantile(0.50, windowed)),
                "p90_ms": _round(self.quantile(0.90, windowed)),
                "p99_ms": _round(self.quantile(0.99, windowed))}


def _round(value, digits: int = 4):
    return None if value is None else round(value, digits)


def _labels_key(labels: dict | None) -> tuple:
    return tuple(sorted((str(k), str(v))
                 for k, v in (labels or {}).items()))


def _labels_text(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{name}="{_escape(value)}"' for name, value in key)
    return "{" + inner + "}"


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


class MetricsRegistry:
    """Labeled histogram/counter/gauge series behind one lock.

    Series are created on first touch; the key is ``(name, labels)``
    with labels normalized to a sorted tuple, so
    ``observe("element_latency_ms", 3.1, element="DET")`` and the
    exposition agree on identity.  Keep label cardinality bounded:
    element/stage/segment names, never frame or stream ids.
    """

    def __init__(self, window_s: float = HISTOGRAM_WINDOW_DEFAULT):
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._histograms: dict[tuple, LogHistogram] = {}
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}

    # -- writes ------------------------------------------------------------

    def observe(self, name: str, value_ms: float, **labels) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            histogram = self._histograms.get(key)
            if histogram is None:
                histogram = self._histograms[key] = \
                    LogHistogram(self.window_s)
            histogram.observe(value_ms)

    def count(self, name: str, increment: float = 1, **labels) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + increment

    def gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            self._gauges[key] = value

    def reset(self) -> None:
        """Drop every series (bench: called after warmup so the timed
        window's percentiles exclude compile frames)."""
        with self._lock:
            self._histograms.clear()
            self._counters.clear()
            self._gauges.clear()

    # -- reads -------------------------------------------------------------

    def quantile(self, name: str, q: float, labels: dict | None = None,
                 windowed: bool = True) -> float | None:
        key = (name, _labels_key(labels))
        with self._lock:
            histogram = self._histograms.get(key)
            return None if histogram is None \
                else histogram.quantile(q, windowed)

    def summaries(self, windowed: bool = True) \
            -> list[tuple[str, dict, dict]]:
        """Every histogram series as (name, labels_dict, summary).
        Held under the lock end to end: summary() rotates the windows,
        and a rotation racing observe() would drop counts."""
        with self._lock:
            return [(name, dict(labels), histogram.summary(windowed))
                    for (name, labels), histogram
                    in self._histograms.items()]

    def counters(self) -> list[tuple[str, dict, float]]:
        with self._lock:
            return [(name, dict(labels), value)
                    for (name, labels), value in self._counters.items()]

    def gauges(self) -> list[tuple[str, dict, float]]:
        with self._lock:
            return [(name, dict(labels), value)
                    for (name, labels), value in self._gauges.items()]

    def state(self) -> dict:
        """JSON-able raw dump of every series (``/metrics/raw``): the
        fleet aggregator's scrape format.  Histograms ship their exact
        bucket counts (text exposition only carries quantiles, which
        cannot be merged); counters/gauges ship as-is."""
        with self._lock:
            return {
                "histograms": [
                    {"name": name, "labels": dict(labels),
                     **histogram.state()}
                    for (name, labels), histogram
                    in self._histograms.items()],
                "counters": [
                    {"name": name, "labels": dict(labels),
                     "value": value}
                    for (name, labels), value
                    in self._counters.items()],
                "gauges": [
                    {"name": name, "labels": dict(labels),
                     "value": value}
                    for (name, labels), value
                    in self._gauges.items()
                    if isinstance(value, (int, float))]}

    # -- exposition --------------------------------------------------------

    def render_text(self, prefix: str = "aiko_") -> str:
        """Prometheus-style text exposition: histograms as summaries
        (quantile label + _sum/_count), counters and gauges as-is."""
        lines: list[str] = []
        with self._lock:
            # Histogram reads happen under the lock too: cumulative
            # quantiles don't rotate, but total/count must agree with
            # the bucket counts they summarize.
            histograms = [(key, histogram.total, histogram.count,
                           [(q, histogram.quantile(q, windowed=False))
                            for q in (0.5, 0.9, 0.99)])
                          for key, histogram
                          in sorted(self._histograms.items())]
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
        seen_types: set[str] = set()
        for (name, labels), total, count, quantiles in histograms:
            full = prefix + name
            if full not in seen_types:
                lines.append(f"# TYPE {full} summary")
                seen_types.add(full)
            for q, value in quantiles:
                if value is None:
                    continue
                label_text = _labels_text(
                    labels + (("quantile", str(q)),))
                lines.append(f"{full}{label_text} {value:.6g}")
            label_text = _labels_text(labels)
            lines.append(f"{full}_sum{label_text} {total:.6g}")
            lines.append(f"{full}_count{label_text} {count}")
        emitted: set[tuple] = set()
        for (name, labels), value in counters:
            full = prefix + name
            if full not in seen_types:
                lines.append(f"# TYPE {full} counter")
                seen_types.add(full)
            emitted.add((full, labels))
            lines.append(f"{full}{_labels_text(labels)} {value:.6g}")
        for (name, labels), value in gauges:
            full = prefix + name
            if (full, labels) in emitted:
                # The same series exists as a counter (a gauge-refresh
                # of a counted total): a second sample under one name
                # would invalidate the whole scrape -- the counter is
                # authoritative.
                continue
            if full not in seen_types:
                lines.append(f"# TYPE {full} gauge")
                seen_types.add(full)
            try:
                rendered = f"{float(value):.6g}"
            except (TypeError, ValueError):
                continue                   # non-numeric gauge: skip
            lines.append(f"{full}{_labels_text(labels)} {rendered}")
        return "\n".join(lines) + "\n"
