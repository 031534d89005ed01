"""The program's own spans, read from the port's process ring
(``aiko_services_tpu_torch.observability.recorder.process_recorder``),
and the arithmetic their readers share.

A span is one ring event ``(t, etype, stream, frame, name, ms, info)``
recorded at its end: it began at ``t - ms / 1e3``.  Its stamps are
``time.perf_counter``'s, the clock the harness stamps the window and
frames with, and which a traced slice ties to the trace's clock
(``trace.Trace.perf_offset_us``).  A request's lifecycle spans share
its id in ``stream``: ``llm.inbox`` (the LLM element's worker inbox),
then ``request.queue``, ``request.admission``, ``request.first`` and
``request.decode``, each starting where the last ended.

Where the program keeps no such ring (a checkout from before it had
one), every reader finds nothing to read.  Where the ring dropped
events of this run (it wrapped), a reader fails the run rather than
read part of a stretch.
"""

from __future__ import annotations

import json
import sys

from . import readers

LIFECYCLE = ("request.queue", "request.admission", "request.first",
             "request.decode")
REQUEST = ("llm.inbox",) + LIFECYCLE
#: spans over a wait that work on some thread fills (a request's, a
#: parked entry's): left out of the idle split
WAITS = REQUEST + ("microbatch.wait",)
#: the idle split gives a moment to the first open span in this order,
#: then to any other span, then to "no span"
WORK = ("batcher.prefill", "batcher.dispatch", "batcher.emit",
        "batcher.fetch", "microbatch.run", "microbatch.finish", "compile",
        "llm.wait_work")
NO_SPAN = "no span"


def events(run: dict):
    """The ring's events since the run began (its set-up's start), or
    None where the program has no ring."""
    try:
        from aiko_services_tpu_torch.observability.recorder import \
            process_recorder
    except ImportError:
        return None
    ring = process_recorder()
    since = run["window"][0] - run["setup_s"]
    snapshot = ring.snapshot()
    wrapped = ring.stats["recorded"] > ring.capacity \
        or len(snapshot) >= ring.capacity
    if wrapped and (not snapshot or snapshot[0][0] > since):
        raise RuntimeError(
            f"spans: the program's ring ({ring.capacity} events) wrapped "
            f"and dropped spans of this run")
    return [event for event in snapshot if event[0] >= since]


def requests(found: list) -> dict:
    """request id -> {lifecycle span -> (start, end, ms)}."""
    out = {}
    for t, etype, stream, _, _, ms, _ in found:
        if etype in REQUEST:
            out.setdefault(stream, {})[etype] = (t - ms / 1e3, t, ms)
    return out


def request_mean(run: dict, names: tuple, ended: str):
    """The mean, over the requests whose ``ended`` span ended in the
    steady stretch (``readers.steady``), of their ``names`` spans'
    milliseconds summed.  A request without one of them fails the
    run."""
    found = events(run)
    if found is None:
        return None
    inside, _ = readers.steady(run)
    values = []
    for rid, spans in requests(found).items():
        if ended not in spans or not inside(spans[ended][1]):
            continue
        missing = [name for name in names if name not in spans]
        if missing:
            raise RuntimeError(f"spans: request {rid} has no {missing}")
        values.append(sum(spans[name][2] for name in names))
    return readers.mean(values)


def span_mean(run: dict, etype: str):
    """The mean milliseconds of the ``etype`` spans that ended in the
    steady stretch."""
    found = events(run)
    if found is None:
        return None
    inside, _ = readers.steady(run)
    return readers.mean([event[5] for event in found
                         if event[1] == etype and inside(event[0])])


def host_ms_per_block(run: dict):
    """The batcher's host work (``batcher.prefill``, ``batcher.dispatch``
    and ``batcher.emit``) that ended in the steady stretch, over the
    blocks retired in it (``batcher.emit``)."""
    found = events(run)
    if found is None:
        return None
    inside, _ = readers.steady(run)
    work = [event for event in found if inside(event[0]) and event[1]
            in ("batcher.prefill", "batcher.dispatch", "batcher.emit")]
    blocks = sum(1 for event in work if event[1] == "batcher.emit")
    return sum(event[5] for event in work) / blocks if blocks else None


def intervals(trace, found: list) -> list:
    """(start, end, etype) in the trace's clock of the spans that
    overlap the slice, by start."""
    out = []
    for t, etype, _, _, _, ms, _ in found:
        if ms is None:
            continue
        end = t * 1e6 + trace.perf_offset_us
        start = end - ms * 1e3
        if end > trace.begin_us and start < trace.end_us:
            out.append((start, end, etype))
    return sorted(out)


def idle_split(trace, spans: list) -> dict:
    """Seconds of the slice's idle time (no device operation) under each
    span name of ``spans``, each moment given to one open span (the
    first in :data:`WORK`'s order, then any other), the rest to "no
    span"."""
    order = {etype: rank for rank, etype in enumerate(WORK)}
    split = {}
    active, k = [], 0
    for a, b in trace.gaps():
        while k < len(spans) and spans[k][0] < b:
            active.append(spans[k])
            k += 1
        active = [span for span in active if span[1] > a]
        cuts = sorted({a, b, *(x for span in active for x in span[:2]
                               if a < x < b)})
        for lo, hi in zip(cuts, cuts[1:]):
            open_ = [span for span in active
                     if span[0] <= lo and span[1] >= hi]
            name = min(open_, key=lambda span: order.get(span[2],
                                                         len(WORK)))[2] \
                if open_ else NO_SPAN
            split[name] = split.get(name, 0.0) + (hi - lo) / 1e6
    return split


def idle_prefill(run: dict):
    """The share of the traced slice in which no device operation ran
    while a ``batcher.prefill`` span was open, on any thread.  Prints
    the slice's whole idle time split by span name on standard
    error."""
    trace = run.get("trace")
    found = events(run) if trace is not None else None
    if found is None or trace.window_s <= 0:
        return None
    spans = [span for span in intervals(trace, found)
             if span[2] not in WAITS]
    split = idle_split(trace, spans)
    idle_s = sum(split.values())
    print("spans: idle split " + json.dumps(
        {"idle_s": idle_s, "window_s": trace.window_s,
         "by_span": dict(sorted(split.items(), key=lambda kv: -kv[1]))}),
        file=sys.stderr, flush=True)
    prefill = idle_split(trace, [span for span in spans
                                 if span[2] == "batcher.prefill"])
    return 100.0 * prefill.get("batcher.prefill", 0.0) / trace.window_s
