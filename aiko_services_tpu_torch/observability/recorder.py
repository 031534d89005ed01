"""Flight recorder: an always-on bounded ring of typed engine events
(ISSUE 10 tentpole part 1).

The telemetry plane (PR 4) aggregates -- histograms know detect is
slow; traces know how long each span took.  Neither answers "what
happened, in order, to THIS frame" or "what was the engine doing in the
500 ms before that frame died".  The flight recorder does: every
engine seam (ingest, stage admit/credit-release, replica pick/failover,
hop dispatch, element/segment dispatch start+done, ledger fetch,
data-plane forward/claim/fallback, LLM block dispatch/retire, deadline/
shed/breaker/replay transitions) appends one typed, monotonic-stamped
event to a bounded per-pipeline ring.

Cost model (the "always-on" contract):

- ``record`` is one ``time.perf_counter()`` call, one tuple allocation
  and one ``deque.append`` on a ``maxlen`` ring -- no lock, no dict
  unless the site passes ``info``.  Appends are safe from any thread
  (stage workers, batcher threads) under the GIL.
- When the pipeline runs with ``recorder: off`` the engine holds
  ``recorder = None`` and every emission site is behind an
  ``is not None`` guard -- the hot path pays one attribute load and a
  branch, nothing else (the same discipline as the unarmed FaultPlan).
- Readers (``explain_frame``, black-box dumps, tests) take an O(n)
  snapshot; they are debug/post-mortem surfaces, never per-frame work.

Events are 7-tuples ``(t, etype, stream, frame, name, ms, info)``:
``t`` is ``time.perf_counter()`` (the same clock every frame metric
stamp uses), ``ms`` an optional duration the site already measured
(hop dispatch, ledger fetch, pacing stall), ``info`` an optional SMALL
dict of primitives (replica index, path, reason).  Sites must only put
ids/names/numbers in events -- never tensors or payloads -- which is
what makes the black-box dump redacted by construction.

The **black-box dump** (:func:`write_blackbox`) snapshots the ring tail
plus the engine's in-flight frame states to a JSON file when something
goes wrong (deadline miss, replay, breaker open, replica failover,
stream error); the ``python -m aiko_services_tpu_torch explain <dump>`` CLI
renders it offline.  Dumps are bounded: the newest ``limit`` files are
kept, oldest pruned.
"""

from __future__ import annotations

import json
import logging
import time
from collections import deque
from pathlib import Path

__all__ = ["FlightRecorder", "write_blackbox", "events_as_dicts",
           "select_frame_events", "RECORDER_CAPACITY_DEFAULT",
           "BLACKBOX_LIMIT_DEFAULT", "EVENT_TYPES", "SpanRecorder",
           "process_recorder", "PROCESS_CAPACITY"]

_logger = logging.getLogger("aiko.observability")

RECORDER_CAPACITY_DEFAULT = 4096
BLACKBOX_LIMIT_DEFAULT = 16

#: the event vocabulary (documentation + the offline renderer's
#: ordering hints; ``record`` does not validate against it -- a typo'd
#: etype costs a confusing timeline, not a hot-path check).
EVENT_TYPES = (
    "ingest",          # frame entered stream.frames
    "pace",            # ingest blocked on the dispatch window (ms)
    "stage_wait",      # frame queued for a placed stage's credit
    "admit",           # stage credit granted (info.replica = slot)
    "release",         # stage credit returned
    "hop",             # stage-hop reshard dispatched (ms)
    "submit",          # handed to a stage worker's FIFO
    "dispatch",        # element/segment execution began
    "dispatch_done",   # element/segment execution finished (ms)
    "park",            # parked at an async/remote stage (info.kind)
    "resume",          # continuation resumed on the loop
    "fetch",           # counted ledger fetch (ms, name = element)
    "forward",         # remote-stage forward (info.path = pipe|mqtt)
    "response",        # remote response arrived (ms = round trip)
    "pipe_fallback",   # data-plane fallback to MQTT (info.reason)
    "claim_drop",      # pipe claim expired; envelope dropped
    "llm_block",       # LLM decode block (name = dispatch|retire)
    "deadline",        # frame_deadline_ms blew
    "shed",            # overload shed
    "breaker",         # circuit breaker transition (info.state)
    "breaker_reject",  # frame refused by an open breaker
    "replay",          # frame replayed after device loss (info.attempt)
    "failover",        # replica failover (info.replica)
    "replace",         # full device replacement (info.generation)
    "done",            # frame finished (info.ok)
    "stream_end",      # stream destroyed (incarnation boundary)
    # Spans in the process ring (process_recorder): one event at the
    # span's end, ``ms`` its duration, so it began at t - ms / 1e3.
    "llm.inbox",       # LLM element: frame's put -> batcher submit
    "llm.wait_work",   # LLM worker blocked on its empty inbox
    "request.queue",   # batcher: submit -> slot assigned (stream = id)
    "request.admission",  # slot -> last admission chunk written
    "request.first",   # -> first token emitted
    "request.decode",  # first token -> finished
    "batcher.prefill",  # one admission pass (info.rows: slot, start, len)
    "batcher.dispatch",  # one block launched (info.slots)
    "batcher.fetch",   # a retire's wait for its block's host copy
    "batcher.emit",    # a retire's de-multiplexing of the tokens
    "microbatch.wait",  # one parked entry: submit -> its group's run
    "microbatch.run",  # one group's batched dispatch (info.rows)
    "microbatch.finish",  # one group's fetch and completions
    "compile",         # a capture (name = loop | the captured fn)
)


class FlightRecorder:
    """Bounded, lock-free ring of engine events.

    One per Pipeline (``pipeline.recorder``; None under
    ``recorder: off``).  Appends from any thread; snapshots copy the
    ring (C-level ``list(deque)``, retried on the pathological
    concurrent-mutation case).
    """

    __slots__ = ("capacity", "_ring", "recorded")

    def __init__(self, capacity: int = RECORDER_CAPACITY_DEFAULT):
        self.capacity = max(64, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        # Total events ever recorded.  Bumped without a lock from many
        # threads, so it can undercount slightly under contention --
        # it is a diagnostic ("did the ring wrap"), never accounting.
        self.recorded = 0

    def record(self, etype: str, stream=None, frame=None, name=None,
               ms: float | None = None, info: dict | None = None) -> None:
        self._ring.append((time.perf_counter(), etype, stream, frame,
                           name, ms, info))
        self.recorded += 1

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self, stream=None, frame=None,
                 tail: int | None = None) -> list[tuple]:
        """Copy of the ring (oldest first), optionally filtered to one
        stream and/or frame id, optionally only the last ``tail``
        events.  Global events (stream/frame None, e.g. ``llm_block``)
        are excluded by a frame filter -- a frame's timeline holds only
        its own causality."""
        events = None
        for _ in range(8):
            try:
                events = list(self._ring)
                break
            except RuntimeError:        # mutated mid-copy (rare)
                continue
        if events is None:              # pragma: no cover
            # Never silent: an empty snapshot here would write an
            # event-less black-box dump during exactly the overload
            # episode it exists to explain.
            _logger.warning("flight-recorder snapshot failed after 8 "
                            "concurrent-mutation retries; returning "
                            "an empty event list")
            events = []
        if stream is not None:
            stream = str(stream)
            events = [e for e in events if str(e[2]) == stream]
        if frame is not None:
            frame = int(frame)
            events = [e for e in events
                      if e[3] is not None and int(e[3]) == frame]
        if tail is not None and tail > 0:
            events = events[-int(tail):]
        return events

    def frame_events(self, stream, frame) -> list[tuple]:
        """Events for ONE frame of ONE stream incarnation (see
        :func:`select_frame_events` -- shared with the offline dump
        renderer so both apply the same stale-same-id discipline)."""
        return select_frame_events(self.snapshot(stream=stream), frame,
                                   stream=stream)

    @property
    def stats(self) -> dict:
        return {"capacity": self.capacity, "buffered": len(self._ring),
                "recorded": self.recorded}


def select_frame_events(events: list[tuple], frame,
                        stream=None) -> list[tuple]:
    """Events for ONE frame of ONE stream INCARNATION.  Frame ids
    restart when a same-id stream is recreated, so the (optionally
    pre-filtered) event list is split at ``stream_end`` markers
    (recorded at stream destroy) and the NEWEST segment holding the
    frame id wins -- a recreated stream's frame 0 never merges with
    (or terminates at) its dead predecessor's timeline, and a
    destroyed stream's last incarnation stays explainable
    post-mortem.  Shared by ``FlightRecorder.frame_events`` and the
    offline black-box renderer (the dump's ring tail carries the same
    markers)."""
    stream = None if stream is None else str(stream)
    segments: list[list] = [[]]
    for event in events:
        if event[1] == "stream_end" \
                and (stream is None or str(event[2]) == stream):
            segments.append([])
        else:
            segments[-1].append(event)
    frame = int(frame)
    for segment in reversed(segments):
        matched = [event for event in segment
                   if event[3] is not None and int(event[3]) == frame
                   and (stream is None or str(event[2]) == stream)]
        if matched:
            return matched
    return []


def events_as_dicts(events: list[tuple]) -> list[dict]:
    """Ring tuples -> JSON-ready dicts (the dump/export shape)."""
    dicts = []
    for t, etype, stream, frame, name, ms, info in events:
        entry = {"t": round(t, 6), "type": etype}
        if stream is not None:
            entry["stream"] = str(stream)
        if frame is not None:
            entry["frame"] = frame
        if name is not None:
            entry["name"] = str(name)
        if ms is not None:
            entry["ms"] = round(float(ms), 4)
        if info:
            entry.update({str(k): v for k, v in info.items()})
        dicts.append(entry)
    return dicts


def _json_safe(value):
    """Last-resort redaction: anything json cannot take (arrays,
    device buffers that leaked into an info dict) renders as its type
    name, never its contents."""
    return f"<{type(value).__name__}>"


def write_blackbox(directory, payload: dict,
                   limit: int = BLACKBOX_LIMIT_DEFAULT) -> str:
    """Write one black-box dump under ``directory`` and prune to the
    newest ``limit`` files.  Returns the written path.  The payload is
    JSON-serialized with a type-name fallback so a non-primitive that
    slipped into an event can never put tensor bytes on disk."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    reason = str(payload.get("reason", "event"))
    base = f"blackbox_{stamp}_{reason}"
    path = directory / f"{base}.json"
    serial = 0
    while path.exists():                # same second, same reason
        serial += 1
        path = directory / f"{base}_{serial}.json"
    path.write_text(json.dumps(payload, indent=1, default=_json_safe))
    dumps = sorted(directory.glob("blackbox_*.json"),
                   key=lambda p: p.stat().st_mtime)
    for stale in dumps[:max(0, len(dumps) - max(1, int(limit)))]:
        try:
            stale.unlink()
        except OSError:                 # pragma: no cover
            pass
    return str(path)


#: The process ring's capacity.  The port's serving paths write tens of
#: spans a second (on one H100, ~35 in a camera pipeline at 3 frames a
#: second: a frame's request lifecycle, three admission chunks, block
#: and micro-batch spans; ~20 in a 32-slot chat batcher); five minutes
#: of set-up and serving at 100 a second fit four times over.
PROCESS_CAPACITY = 1 << 17


class SpanRecorder(FlightRecorder):
    """The process-wide ring (:func:`process_recorder`): a
    :class:`FlightRecorder` whose sites may give the stamp they took,
    so a span is recorded at its end with its duration (``ms``) from
    the same clock reads."""

    __slots__ = ()

    def record_at(self, t: float, etype: str, stream=None, frame=None,
                  name=None, ms: float | None = None,
                  info: dict | None = None) -> None:
        self._ring.append((t, etype, stream, frame, name, ms, info))
        self.recorded += 1


_PROCESS_RECORDER = SpanRecorder(PROCESS_CAPACITY)


def process_recorder() -> SpanRecorder:
    """The ring every serving path of this process writes its spans to
    (batcher, device loop, micro-batcher, LLM worker), readable after
    the run; ``stats["recorded"]`` beyond ``capacity`` says it
    wrapped."""
    return _PROCESS_RECORDER
