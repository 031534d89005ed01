"""``torch.profiler`` integration, routed through the hook system.

Counterpart of ``aiko_services_tpu/tpu/profiling.py``.  The reference
instruments with hooks alone (reference:
src/aiko_services/main/hook.py:19-23, pipeline.py:1286-1289); on the
card the interesting timeline is the device's, so this module bridges
the two:

- :class:`Profiler` starts/stops a ``torch.profiler`` trace for the
  whole process (CPU and CUDA activities on the card, CPU alone without
  one) and, when attached to a Pipeline, opens a
  ``torch.profiler.record_function`` span around every element
  execution via the ``pipeline.process_element:0`` (enter) and
  ``pipeline.process_element_post:0`` (exit) hooks -- so each pipeline
  element shows up as a named span on the host timeline, aligned with
  the kernels it launched.
- ``stop()`` writes the trace as one Chrome trace JSON file into the
  log directory and returns its path (the JAX package writes xprof's
  TensorBoard format; a Chrome trace opens in ``chrome://tracing`` or
  Perfetto).
- :func:`profile_trace` is the context-manager form for scripts/tests.
- :class:`span` and :func:`record_span` write the serving paths' spans
  (batcher, device loop, micro-batcher, LLM worker) to the process ring
  (``observability.recorder.process_recorder``), always; a
  :class:`span` entered while a profiler records on its thread is also
  a ``record_function`` of the same name, so a trace and the ring name
  the same work.  The ring's stamps are ``time.perf_counter``'s, the
  clock frame metrics use, so its spans lay over a trace by one offset.

Relation to the telemetry plane (``observability/``): the distributed
frame traces and the spans here describe the SAME events --
``element:``/``segment:``/``compile:``/``stage:``/``hop:`` names match
one-for-one.  Debug latency with the trace/histograms, then zoom into a
span's device work in the Chrome trace.

CLI: ``python -m aiko_services_tpu_torch pipeline create DEF --profile
DIR``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..observability.recorder import process_recorder
from ..utils import get_logger

__all__ = ["Profiler", "profile_trace", "span", "record_span"]

_logger = get_logger("aiko.profiling")


_RING = process_recorder()
_profiling = torch.autograd._profiler_enabled


class span:
    """``with span("batcher.fetch", stream, info): ...`` records one
    span into the process ring at its end: ``etype``, the stream (a
    request id, an element), ``name`` (``compile:<name>``'s part after
    the colon), ``ms`` and ``info``, which the body may still set.
    While a profiler records on this thread it also opens
    ``record_function("<etype>[:<name>]")``; otherwise it costs two
    clock reads and one ring append."""

    __slots__ = ("etype", "stream", "name", "info", "_begin", "_function")

    def __init__(self, etype: str, stream=None, info: dict | None = None,
                 name: str | None = None):
        self.etype, self.stream, self.name, self.info = \
            etype, stream, name, info

    def __enter__(self):
        self._function = None
        if _profiling():
            label = self.etype if self.name is None \
                else f"{self.etype}:{self.name}"
            self._function = record_function(label)
            self._function.__enter__()
        self._begin = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        if self._function is not None:
            self._function.__exit__(None, None, None)
        _RING.record_at(end, self.etype, self.stream, None, self.name,
                        (end - self._begin) * 1e3, self.info)
        return False


def record_span(etype: str, begin: float, end: float, stream=None,
                info: dict | None = None) -> None:
    """A span whose ``perf_counter`` stamps were taken apart (a
    request's lifecycle, a parked entry's wait): one ring event at
    ``end``."""
    _RING.record_at(end, etype, stream, None, None, (end - begin) * 1e3,
                    info)


def _span(name: str):
    """An entered ``record_function`` span; exit it with
    ``__exit__(None, None, None)``."""
    span = record_function(name)
    span.__enter__()
    return span


class Profiler:
    """Process-wide trace plus per-element spans.

    With overlapped frame execution (async park/resume, cross-stream
    micro-batching) element spans INTERLEAVE: frame k+1's detect enter
    fires while frame k is still parked at the LLM, and the post hooks
    resume in completion order, not a stack order.  Spans are therefore
    keyed by (element, stream, frame) -- each span is an independent
    timed event, so out-of-order exits are fine.  A dangling span
    (element raised, so the post hook never fired) is closed when the
    same (element, frame) re-enters (frame retry) or at ``detach()``.
    """

    def __init__(self):
        self._logdir: str | None = None
        self._trace = None
        self._pipelines: list = []
        self._open: dict = {}  # (element, stream, frame) -> span

    @property
    def active(self) -> bool:
        return self._logdir is not None

    # -- process-wide trace ------------------------------------------------

    def start(self, logdir: str):
        if self._logdir is not None:
            _logger.warning("profiler already tracing to %s", self._logdir)
            return
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._trace = profile(activities=activities)
        self._trace.__enter__()
        self._logdir = logdir
        _logger.info("torch.profiler trace -> %s", logdir)

    def stop(self) -> str | None:
        """End the trace; returns the Chrome trace file written into the
        log directory (None when no trace ran)."""
        logdir, self._logdir = self._logdir, None
        self._unwind()
        if logdir is None:
            return None
        trace, self._trace = self._trace, None
        trace.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        trace.export_chrome_trace(path)
        return path

    # -- pipeline annotation hooks -----------------------------------------

    def attach(self, pipeline):
        """Annotate every element run -- and every fused-segment
        dispatch, stage occupancy window and stage hop -- of
        ``pipeline`` on the trace."""
        pipeline.add_hook_handler("pipeline.process_element:0",
                                  self._on_element)
        pipeline.add_hook_handler("pipeline.process_element_post:0",
                                  self._on_element_post)
        pipeline.add_hook_handler("pipeline.process_segment:0",
                                  self._on_segment)
        pipeline.add_hook_handler("pipeline.process_segment_post:0",
                                  self._on_segment_post)
        pipeline.add_hook_handler("pipeline.process_stage:0",
                                  self._on_stage)
        pipeline.add_hook_handler("pipeline.process_stage_post:0",
                                  self._on_stage_post)
        pipeline.add_hook_handler("pipeline.stage_hop:0",
                                  self._on_stage_hop)
        self._pipelines.append(pipeline)

    def detach(self):
        for pipeline in self._pipelines:
            pipeline.remove_hook_handler("pipeline.process_element:0",
                                         self._on_element)
            pipeline.remove_hook_handler("pipeline.process_element_post:0",
                                         self._on_element_post)
            pipeline.remove_hook_handler("pipeline.process_segment:0",
                                         self._on_segment)
            pipeline.remove_hook_handler("pipeline.process_segment_post:0",
                                         self._on_segment_post)
            pipeline.remove_hook_handler("pipeline.process_stage:0",
                                         self._on_stage)
            pipeline.remove_hook_handler("pipeline.process_stage_post:0",
                                         self._on_stage_post)
            pipeline.remove_hook_handler("pipeline.stage_hop:0",
                                         self._on_stage_hop)
        self._pipelines.clear()
        self._unwind()

    @staticmethod
    def _key(variables):
        # Stream id included: frame ids restart per stream, so two
        # overlapping streams' frame 5 must not share a span.
        return (variables.get("element"), variables.get("stream"),
                variables.get("frame"))

    def _on_element(self, component, hook, variables):
        key = self._key(variables)
        stale = self._open.pop(key, None)
        if stale is not None:   # same frame re-entered: close the
            stale.__exit__(None, None, None)    # dangling span
        self._open[key] = _span(f"element:{key[0]}")

    def _on_element_post(self, component, hook, variables):
        span = self._open.pop(self._key(variables), None)
        if span is not None:
            span.__exit__(None, None, None)

    # -- fused-segment spans ------------------------------------------------

    @staticmethod
    def _segment_keys(variables):
        base = (variables.get("segment"), variables.get("stream"),
                variables.get("frame"))
        return ("segment",) + base, ("compile",) + base

    def _on_segment(self, component, hook, variables):
        """One span per fused dispatch; a first-use capture additionally
        opens a ``compile:`` span (keyed by segment name) so first-frame
        capture time is distinguishable from steady-state step time on
        the timeline."""
        seg_key, compile_key = self._segment_keys(variables)
        for key in (seg_key, compile_key):
            stale = self._open.pop(key, None)
            if stale is not None:       # same frame re-entered (retry)
                stale.__exit__(None, None, None)
        name = variables.get("segment")
        if variables.get("compile"):
            self._open[compile_key] = _span(f"compile:{name}")
        self._open[seg_key] = _span(f"segment:{name}")

    def _on_segment_post(self, component, hook, variables):
        seg_key, compile_key = self._segment_keys(variables)
        for key in (seg_key, compile_key):   # inner (segment) first
            span = self._open.pop(key, None)
            if span is not None:
                span.__exit__(None, None, None)

    # -- stage occupancy / hop spans -----------------------------------------

    @staticmethod
    def _stage_key(variables):
        return ("stage", variables.get("stage"), variables.get("stream"),
                variables.get("frame"))

    def _on_stage(self, component, hook, variables):
        """One ``stage:`` span per (stage, stream, frame) admission --
        overlapping spans for the same stage across frames (window
        depth >= 2), and concurrently-open spans for DIFFERENT stages,
        are exactly the stage-parallel signature on the timeline."""
        key = self._stage_key(variables)
        stale = self._open.pop(key, None)
        if stale is not None:           # same frame re-admitted (retry)
            stale.__exit__(None, None, None)
        self._open[key] = _span(f"stage:{variables.get('stage')}")

    def _on_stage_post(self, component, hook, variables):
        span = self._open.pop(self._stage_key(variables), None)
        if span is not None:
            span.__exit__(None, None, None)

    @staticmethod
    def _on_stage_hop(component, hook, variables):
        # The hop already dispatched (the copy rides the device
        # timeline): a zero-width ``hop:`` mark locates it on the host
        # track, with the dispatch cost carried in the hook's ``ms``
        # variable.
        _span(f"hop:{variables.get('stage')}").__exit__(None, None, None)

    def _unwind(self):
        """Close every dangling span INNERMOST-FIRST: all
        non-``compile`` spans first (reverse insertion order), then the
        remaining ``compile:`` outers -- a re-entered key can leave an
        outer ``compile:`` span after its inner ``segment:`` span in
        insertion order, and closing in raw pop order would exit the
        outer span first."""
        for key in [key for key in reversed(list(self._open))
                    if key[0] != "compile"]:
            self._open.pop(key).__exit__(None, None, None)
        while self._open:
            _, span = self._open.popitem()
            span.__exit__(None, None, None)


@contextlib.contextmanager
def profile_trace(logdir: str, *pipelines):
    """``with profile_trace("/tmp/trace", pipeline): ...``"""
    profiler = Profiler()
    profiler.start(logdir)
    for pipeline in pipelines:
        profiler.attach(pipeline)
    try:
        yield profiler
    finally:
        profiler.detach()
        profiler.stop()
