"""A slice of a traced run under ``torch.profiler``, and what is read
from it.

The slice starts and stops at host times the system gives; the
profiler writes its Chrome trace to the run's temporary directory,
which is read once and deleted.  A span ``bench.slice`` on the thread
that runs the slice marks its bounds in the trace's clock, and ties
that clock to ``time.perf_counter``.

From the trace: every device operation (kernels, copies, fills) with
its start, duration and correlation id; every CUDA runtime call with
its host start and correlation id.  A kernel of a replayed CUDA graph
carries the correlation id of its ``cudaGraphLaunch``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: host operations shorter than this name no idle gap worth reporting
HOST_MIN_US = 20.0


@dataclass
class Trace:
    begin_us: float                 # the slice, in the trace's clock
    end_us: float
    perf_offset_us: float           # trace clock - perf_counter, in us
    device: list = field(default_factory=list)    # (name, ts, dur, corr, cat)
    runtime: list = field(default_factory=list)   # (name, ts, dur, corr)
    host: list = field(default_factory=list)      # (name, ts, dur) cpu ops

    @property
    def window_s(self) -> float:
        return (self.end_us - self.begin_us) / 1e6

    def to_perf(self, ts_us: float) -> float:
        return (ts_us - self.perf_offset_us) / 1e6

    def in_slice(self):
        """Device operations that start inside the slice."""
        return [op for op in self.device
                if self.begin_us <= op[1] < self.end_us]

    def busy_s(self) -> float:
        """Seconds of the slice in which some device operation ran."""
        spans = sorted((max(ts, self.begin_us), min(ts + dur, self.end_us))
                       for _, ts, dur, _, _ in self.device)
        busy, reach = 0.0, self.begin_us
        for start, end in spans:
            start = max(start, reach)
            if end > start:
                busy += end - start
                reach = end
        return busy / 1e6

    def gaps(self) -> list:
        """Idle stretches of the device inside the slice: (start, end)."""
        spans = sorted((ts, ts + dur) for _, ts, dur, _, _ in self.device)
        out, reach = [], self.begin_us
        for start, end in spans:
            if start > reach:
                out.append((reach, min(start, self.end_us)))
            reach = max(reach, end)
            if reach >= self.end_us:
                break
        if reach < self.end_us:
            out.append((reach, self.end_us))
        return [(a, b) for a, b in out if b > a]

    def graph_launches(self) -> list:
        """Correlation ids of ``cudaGraphLaunch`` calls, in host order."""
        return [corr for name, _, _, corr in sorted(self.runtime,
                                                    key=lambda r: r[1])
                if name.startswith("cudaGraphLaunch")]

    def launch_time(self) -> dict:
        """correlation id -> host start (perf_counter seconds)."""
        return {corr: self.to_perf(ts) for _, ts, _, corr in self.runtime}

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the slice, and
        its longest idle gaps, each named by the host operation that
        overlaps it most."""
        totals = {}
        for name, _, dur, _, _ in self.in_slice():
            totals[name] = totals.get(name, 0.0) + dur / 1e6
        device_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[name[:120], s] for name, s in device_ops],
                "idle_gaps": [[self._host_label(a, b), (b - a) / 1e6]
                              for a, b in longest]}

    def _host_label(self, start: float, end: float) -> str:
        """The host operation (other than the slice's own span) that
        overlaps [start, end) most, or "host"."""
        best, overlap = "host", 0.0
        for name, ts, dur in self.host:
            shared = min(end, ts + dur) - max(start, ts)
            if shared > overlap and name != "bench.slice":
                best, overlap = name, shared
        return best[:120]


class Slice:
    """``torch.profiler`` from ``begin`` (perf_counter seconds) for
    ``length`` seconds once it has started: :meth:`poll` from the thread
    that steps the run starts and stops it.  ``trace`` holds the parsed
    result once it stopped."""

    def __init__(self, begin: float, length: float):
        self.begin, self.length = begin, length
        self.end = begin + length
        self.trace: Trace | None = None
        self._profiler = None
        self._span = None
        self._mark = 0.0
        #: (host time the profiler began starting, host time it had
        #: stopped and its trace was read): the run is paused between
        self.paused = None

    @property
    def done(self) -> bool:
        return self.trace is not None

    def poll(self, now: float) -> None:
        if self.done:
            return
        if self._profiler is None and now >= self.begin:
            self._start()
        elif self._profiler is not None and now >= self.end:
            self._stop()

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.paused = (time.perf_counter(), None)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()
        self._span = torch.profiler.record_function("bench.slice")
        self._span.__enter__()
        self._mark = time.perf_counter()
        self.end = self._mark + self.length     # starting takes a while

    def _stop(self) -> None:
        import torch
        stopping = time.perf_counter()
        self._span.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._profiler.__exit__(None, None, None)
        handle, path = tempfile.mkstemp(suffix=".json")
        os.close(handle)
        try:
            self._profiler.export_chrome_trace(path)
            with open(path) as stream:
                events = json.load(stream)["traceEvents"]
        finally:
            os.unlink(path)
        self._profiler = None
        exported = time.perf_counter()
        self.trace = parse(events, self._mark)
        self.paused = (self.paused[0], time.perf_counter())
        print(f"trace: {self.trace.window_s:.3f} s traced, "
              f"{len(self.trace.device)} device operations; the profiler "
              f"took {self._mark - self.paused[0]:.3f} s to start, "
              f"{exported - stopping:.3f} s to stop, export and load, "
              f"{self.paused[1] - exported:.3f} s to read",
              file=sys.stderr, flush=True)

    def close(self) -> None:
        """Stop a slice still running (the window closed first)."""
        if self._profiler is not None:
            self._stop()


def parse(events: list, mark: float) -> Trace:
    """A Chrome trace's events -> :class:`Trace`; ``mark`` is the
    perf_counter time at which the ``bench.slice`` span began."""
    device, runtime, host = [], [], []
    begin = end = None
    for event in events:
        if event.get("ph") != "X":
            continue
        cat = event.get("cat", "")
        name = event.get("name", "")
        ts, dur = float(event["ts"]), float(event.get("dur", 0.0))
        corr = (event.get("args") or {}).get("correlation")
        if cat in DEVICE_CATEGORIES:
            device.append((name, ts, dur, corr, cat))
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            runtime.append((name, ts, dur, corr))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            if name == "bench.slice":
                begin, end = ts, ts + dur
            elif dur >= HOST_MIN_US:
                host.append((name, ts, dur))
    if begin is None:
        raise RuntimeError("trace: no bench.slice span")
    return Trace(begin_us=begin, end_us=end, perf_offset_us=begin - mark * 1e6,
                 device=device, runtime=runtime, host=host)
