"""Critical-path attribution: where did the frame's time go?
(ISSUE 10 tentpole part 2.)

The headline bench gap -- ``pipeline_e2e_fps`` 0.44x of device fps --
has histograms naming the slow ELEMENT but nothing splitting a frame's
end-to-end latency into causes: was it compute, admission-queue wait,
the ICI hop, a counted host fetch, the remote round trip, a replay, or
ingest pacing?  This module folds the engine's per-frame evidence into
exactly that split.

Two attribution paths, one bucket vocabulary (:data:`BUCKETS`):

- :func:`attribute_metrics` -- the CHEAP per-frame path, run at frame
  completion from ``frame.metrics`` (every number in it was already
  measured by the engine).  Feeds the ``frame_<bucket>_ms`` histograms
  and the per-trace bucket tags ``Pipeline.explain()`` aggregates.
  O(len(metrics)), no ring scan, no allocation beyond the result.
- :func:`attribute_events` -- the DEEP path over flight-recorder
  events (:mod:`.recorder`): a causal state machine that assigns every
  interval between consecutive events to the bucket of the state the
  frame was in, so the timeline is total by construction.  Used by
  ``Pipeline.explain_frame``, the black-box CLI and post-mortems.

Buckets:

- ``compute``  element/segment execution (an async element's park --
               submit to complete -- counts here: that is the element
               serving the frame, batching wait included)
- ``queue``    stage admission wait, stage-worker queue, and (on the
               event path) runnable-but-not-scheduled loop time
- ``hop``      stage-hop reshard dispatch
- ``fetch``    counted ledger fetches (host-typed inputs, segment
               finalize, remote forward encode)
- ``pipe``     remote-stage round trips, wire + remote compute (the
               remote process's own split is in its returned spans)
- ``replay``   work voided by a device-loss replay + the retry gap
- ``pacing``   ingest blocked on the bounded dispatch window

Sums are honest, not residual-balanced: ``unattributed_ms`` reports
what the evidence did not cover instead of silently inflating a
bucket.  The acceptance bar (bucket totals within 5% of measured e2e
on the bench pipeline) is enforced by ``tests/test_flight_recorder``.
"""

from __future__ import annotations

__all__ = ["BUCKETS", "attribute_metrics", "attribute_events",
           "aggregate_traces", "render_timeline", "render_buckets"]

BUCKETS = ("compute", "queue", "hop", "fetch", "pipe", "replay",
           "pacing")


def _new_report() -> dict:
    return {bucket: 0.0 for bucket in BUCKETS}


class _Attribution:
    """Accumulates (bucket, stage) -> ms with bucket totals."""

    def __init__(self):
        self.buckets = _new_report()
        self.stages: dict[str, dict] = {}

    def add(self, bucket: str, ms: float, stage: str) -> None:
        if ms <= 0.0:
            return
        self.buckets[bucket] += ms
        entry = self.stages.setdefault(stage, {})
        entry[bucket] = entry.get(bucket, 0.0) + ms

    def result(self, e2e_ms: float | None) -> dict:
        attributed = sum(self.buckets.values())
        report = {
            "e2e_ms": None if e2e_ms is None else round(e2e_ms, 3),
            "attributed_ms": round(attributed, 3),
            "buckets": {bucket: round(ms, 3)
                        for bucket, ms in self.buckets.items()},
            "stages": {stage: {bucket: round(ms, 3)
                               for bucket, ms in entry.items()}
                       for stage, entry in self.stages.items()}}
        if e2e_ms:
            report["unattributed_ms"] = round(
                max(0.0, e2e_ms - attributed), 3)
            report["coverage"] = round(min(attributed / e2e_ms, 1.0), 4)
        return report


def attribute_metrics(metrics: dict, e2e_ms: float | None = None) -> dict:
    """Bucket a completed frame's ``frame.metrics`` stamps.

    ``e2e_ms`` defaults to ``time_pipeline`` (the engine's walk-start
    -> delivery measurement).  Per-stage keys carry the replica suffix
    (``det#1``) when the frame was admitted to a replicated slot.
    """
    out = _Attribution()
    # The pacing stall happens BEFORE the walk-start stamp that feeds
    # ``time_pipeline``: the honest denominator spans ingest ->
    # delivery, i.e. measured walk time PLUS the pre-walk pace --
    # otherwise a paced frame's buckets sum past e2e and shares
    # exceed 1.
    pace_ms = float(metrics.get("ingest_pace_ms") or 0.0)
    if e2e_ms is None:
        elapsed = metrics.get("time_pipeline")
        e2e_ms = None if elapsed is None \
            else float(elapsed) * 1000.0 + pace_ms
    else:
        e2e_ms = float(e2e_ms) + pace_ms
    replica_of = {key[6:-8]: value for key, value in metrics.items()
                  if key.startswith("stage_") and key.endswith("_replica")}

    def stage_label(stage: str) -> str:
        replica = replica_of.get(stage)
        return stage if replica is None else f"{stage}#{replica}"

    for key, value in metrics.items():
        if not isinstance(value, (int, float)) \
                or isinstance(value, bool):
            continue
        if key == "ingest_pace_ms":
            out.add("pacing", float(value), "_ingest")
        elif key == "replay_lost_ms":
            out.add("replay", float(value), "_replay")
        elif key.endswith("_time") and key != "time_pipeline":
            # <element>_time: seconds of execution (async park
            # included); fused members carry 0.0 and their segment's
            # dispatch lands on the tail element.
            out.add("compute", float(value) * 1000.0,
                    stage_label(key[:-5]))
        elif key.startswith("stage_") and key.endswith("_wait_ms"):
            out.add("queue", float(value), stage_label(key[6:-8]))
        elif key.endswith("_queue_ms"):
            out.add("queue", float(value), stage_label(key[:-9]))
        elif key.endswith("_hop_ms"):
            out.add("hop", float(value), stage_label(key[:-7]))
        elif key.endswith("_fetch_ms"):
            out.add("fetch", float(value), key[:-9])
        elif key.startswith("remote_") and key.endswith("_ms"):
            out.add("pipe", float(value), key[7:-3])
    return out.result(e2e_ms)


# -- event path (flight recorder) -------------------------------------------

#: event type -> the state (bucket, use-name-as-stage) the frame
#: enters when the event lands.  Duration events (below) do not change
#: state; terminal events close the timeline.
_STATE_AFTER = {
    "ingest": "queue", "stage_wait": "queue", "admit": "queue",
    "release": "queue", "submit": "queue", "dispatch_done": "queue",
    "resume": "queue", "response": "queue", "replay": "queue",
    "dispatch": "compute", "forward": "pipe",
}
#: events carrying a measured duration [t - ms, t]: the slice is cut
#: out of the enclosing state's interval and attributed to the event's
#: own bucket.
_DURATION_BUCKET = {"pace": "pacing", "hop": "hop", "fetch": "fetch"}
_TERMINAL = {"done", "deadline", "shed"}


def attribute_events(events: list[tuple]) -> dict:
    """Causal state machine over one frame's recorder events.

    Every interval between consecutive events is attributed to the
    state in effect, so bucket totals sum EXACTLY to the event span
    (first event -> terminal event); the interval that ENDS at a
    ``replay`` event is re-classified to ``replay`` (that work was
    voided).  Returns the attribution report plus the rendered
    ``timeline`` entries (offsets relative to the first event).
    """
    events = sorted(events, key=lambda e: e[0])
    out = _Attribution()
    timeline: list[dict] = []
    start = cursor = None
    state = ("queue", "_ingest")
    end = None
    for t, etype, stream, frame, name, ms, info in events:
        if start is None:
            start = cursor = t
        interval = (t - cursor) * 1000.0
        cursor = t
        label = str(name) if name is not None else state[1]
        if etype in _DURATION_BUCKET and ms:
            sliced = min(float(ms), interval)
            out.add(state[0], interval - sliced, state[1])
            out.add(_DURATION_BUCKET[etype], sliced, label)
        elif etype == "replay":
            out.add("replay", interval, "_replay")
        else:
            out.add(state[0], interval, state[1])
        entry = {"t_ms": round((t - start) * 1000.0, 3), "type": etype}
        if name is not None:
            entry["name"] = str(name)
        if ms is not None:
            entry["ms"] = round(float(ms), 3)
        if info:
            entry.update(info)
        timeline.append(entry)
        if etype in _TERMINAL:
            end = t
            break
        bucket = _STATE_AFTER.get(etype)
        if bucket is not None:
            state = (bucket, label)
        elif etype == "park":
            kind = (info or {}).get("kind")
            state = ("pipe" if kind == "remote" else "compute", label)
    span_ms = None if start is None \
        else ((end if end is not None else cursor) - start) * 1000.0
    report = out.result(span_ms)
    report["timeline"] = timeline
    report["events"] = len(timeline)
    return report


# -- aggregation (Pipeline.explain / bench) ---------------------------------

def aggregate_traces(entries: list[dict], top_k: int = 5) -> dict:
    """Fold per-trace bucket attributions (attached by the telemetry
    plane at frame completion) into the top-k bottleneck report: bucket
    totals, per-stage/bucket totals, and the ranked contributors.
    Entries without attribution (e.g. remote-origin partial traces)
    are skipped and counted."""
    buckets = _new_report()
    stages: dict[str, dict] = {}
    frames = 0
    skipped = 0
    e2e_total = 0.0
    unattributed = 0.0
    for entry in entries:
        attribution = entry.get("buckets")
        if not attribution:
            skipped += 1
            continue
        frames += 1
        e2e_total += entry.get("e2e_ms") or 0.0
        unattributed += entry.get("unattributed_ms") or 0.0
        for bucket, ms in attribution.items():
            if bucket in buckets:
                buckets[bucket] += ms
        for stage, per_bucket in (entry.get("stages") or {}).items():
            target = stages.setdefault(stage, {})
            for bucket, ms in per_bucket.items():
                target[bucket] = target.get(bucket, 0.0) + ms
    attributed = sum(buckets.values())
    contributors = [{"stage": stage, "bucket": bucket,
                     "ms": round(ms, 3),
                     "share": round(ms / e2e_total, 4)
                     if e2e_total else None}
                    for stage, per_bucket in stages.items()
                    for bucket, ms in per_bucket.items()]
    contributors.sort(key=lambda c: -c["ms"])
    return {"frames": frames, "skipped": skipped,
            "e2e_total_ms": round(e2e_total, 3),
            "e2e_mean_ms": round(e2e_total / frames, 3) if frames
            else None,
            "buckets": {bucket: round(ms, 3)
                        for bucket, ms in buckets.items()},
            "bucket_share": {bucket: round(ms / e2e_total, 4)
                             for bucket, ms in buckets.items()}
            if e2e_total else {},
            "stages": {stage: {bucket: round(ms, 3)
                               for bucket, ms in per_bucket.items()}
                       for stage, per_bucket in stages.items()},
            "top": contributors[:max(1, int(top_k))],
            "attributed_ms": round(attributed, 3),
            "unattributed_ms": round(unattributed, 3),
            "coverage": round(min(attributed / e2e_total, 1.0), 4)
            if e2e_total else None}


# -- offline rendering (CLI) ------------------------------------------------

def render_timeline(timeline: list[dict]) -> list[str]:
    """Timeline entries -> aligned text lines for the explain CLI."""
    lines = []
    for entry in timeline:
        extras = {key: value for key, value in entry.items()
                  if key not in ("t_ms", "type", "name", "ms")}
        parts = [f"+{entry.get('t_ms', 0.0):10.3f} ms",
                 f"{entry.get('type', '?'):14}"]
        if entry.get("name") is not None:
            parts.append(str(entry["name"]))
        if entry.get("ms") is not None:
            parts.append(f"({entry['ms']:.3f} ms)")
        if extras:
            parts.append(" ".join(f"{key}={value}"
                                  for key, value in sorted(
                                      extras.items())))
        lines.append("  ".join(parts))
    return lines


def render_buckets(report: dict) -> list[str]:
    """Bucket attribution -> aligned text table for the explain CLI."""
    lines = []
    e2e = report.get("e2e_ms") or report.get("e2e_total_ms")
    buckets = report.get("buckets") or {}
    for bucket in BUCKETS:
        ms = buckets.get(bucket, 0.0)
        share = f"{ms / e2e * 100.0:5.1f}%" if e2e else "     "
        lines.append(f"{bucket:>8}  {ms:12.3f} ms  {share}")
    unattributed = report.get("unattributed_ms")
    if unattributed is not None:
        share = f"{unattributed / e2e * 100.0:5.1f}%" if e2e else ""
        lines.append(f"{'(other)':>8}  {unattributed:12.3f} ms  {share}")
    if e2e is not None:
        lines.append(f"{'e2e':>8}  {e2e:12.3f} ms")
    return lines
