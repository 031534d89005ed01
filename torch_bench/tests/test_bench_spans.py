"""The readers of the program's spans (``torch_bench/spans.py``): on tiny
runs of each cell every one reads a number, and a chat
request's spans add up to its taped time to first token; a ring that
dropped spans of the run fails it; a program without the ring leaves
them silent; the idle split gives each idle moment to one span."""

import json
from pathlib import Path

import pytest

from torch_bench import readers, spans
from torch_bench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = {cell["name"]: [m["name"] for m in BENCHMARK["per_layer"]
                               if m["source"] == "program_span"
                               and "engine_gap" not in m["name"]
                               and cell["name"] in m["workloads"]]
                for cell in BENCHMARK["workloads"]}


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_tiny_runs_read_every_span_metric(run_tiny, workload):
    """The idle split on a traced run; the rest on an untraced one, whose
    steady stretch is its whole window (a tiny traced run answers no
    frame before its profiler starts)."""
    from torch_bench import harness
    names = SPAN_METRICS[workload]
    traced = [name for name in names if name.startswith("idle_prefill")]
    assert traced and len(names) > len(traced)
    line, _ = run_tiny(workload, seconds=4.0, trace=True)
    for name in traced:
        assert line["metrics"][name]["value"] >= 0
    _, run = run_tiny(workload, seconds=3.0)
    for name in names:
        if name not in traced:
            value = harness.reader(name)(run)
            assert value is not None and value >= 0, name
    if workload != "mistral7b.chat":
        return
    # Each request's queue, admission and first wait make up its time
    # to first token as the clients saw it.
    firsts = [e[2] for e in readers.window_emits(run) if e[3] == 0]
    assert len(firsts) == len(run["ttft_ms"]) > 0
    found = spans.requests(spans.events(run))
    for rid, ttft in zip(firsts, run["ttft_ms"]):
        parts = sum(found[rid][name][2] for name in
                    ("request.queue", "request.admission", "request.first"))
        assert abs(parts - ttft) < 1.0, (rid, parts, ttft)


def _run(t_open=100.0, setup_s=10.0, paused=None, trace=None):
    return {"window": (t_open, t_open + 50.0), "setup_s": setup_s,
            "paused": paused, "trace": trace}


@pytest.fixture
def ring(monkeypatch):
    """A small ring in the program's place."""
    from aiko_services_tpu_torch.observability import recorder
    small = recorder.SpanRecorder(64)
    monkeypatch.setattr(recorder, "process_recorder", lambda: small)
    return small


@pytest.mark.parametrize("count, dropped", [(50, False), (80, True)])
def test_a_ring_that_dropped_spans_of_the_run_fails_it(ring, count,
                                                       dropped):
    for index in range(count):      # all after the run's start at 90 s
        ring.record_at(95.0 + index * 0.1, "batcher.fetch", ms=1.0)
    if dropped:
        with pytest.raises(RuntimeError, match="wrapped"):
            spans.events(_run())
    else:
        assert len(spans.events(_run())) == count
    # Events before the run's start were dropped: nothing of it was.
    ring.record_at(1.0, "batcher.fetch", ms=1.0)
    assert len(spans.events(_run(t_open=300.0, setup_s=1.0))) == 0


def test_without_the_programs_ring_the_readers_find_nothing(monkeypatch):
    from aiko_services_tpu_torch.observability import recorder
    from torch_bench import harness
    monkeypatch.delattr(recorder, "process_recorder")
    trace = Trace(begin_us=0.0, end_us=1e6, perf_offset_us=0.0)
    for names in SPAN_METRICS.values():
        for name in names:
            assert harness.reader(name)(_run(trace=trace)) is None


def test_request_readers_take_the_steady_stretch(ring):
    # r1 finishes inside the stretch (up to the profiler's start at
    # 120 s), r2 after it.
    for rid, begin in (("r1", 101.0), ("r2", 119.0)):
        t = begin
        for name, ms in (("llm.inbox", 2.0), ("request.queue", 8.0),
                         ("request.admission", 300.0),
                         ("request.first", 400.0),
                         ("request.decode", 500.0)):
            t += ms / 1e3
            ring.record_at(t, name, rid, ms=ms)
    run = _run(paused=(120.0, 130.0))
    assert spans.request_mean(run, ("llm.inbox", "request.queue"),
                              "request.decode") == 10.0
    assert spans.request_mean(run, ("request.first",), "request.first") \
        == 400.0
    ring.record_at(101.5, "request.decode", "r3", ms=1.0)
    with pytest.raises(RuntimeError, match="r3"):
        spans.request_mean(run, ("request.queue",), "request.decode")


def test_host_work_a_block(ring):
    for t, name, ms in ((101.0, "batcher.prefill", 30.0),
                        (101.1, "batcher.dispatch", 5.0),
                        (101.2, "batcher.fetch", 80.0),
                        (101.3, "batcher.emit", 4.0),
                        (101.4, "batcher.dispatch", 5.0),
                        (101.5, "batcher.emit", 6.0)):
        ring.record_at(t, name, ms=ms)
    assert spans.host_ms_per_block(_run()) == 25.0


def test_the_idle_split_gives_each_idle_moment_to_one_span(ring, capsys):
    # Device busy 0-200 and 600-1000 us: idle 200-600 us of a 1 ms
    # slice.  A prefill open 100-400 us on one thread and an emit
    # 300-500 us on another: the prefill takes 200-400, the emit
    # 400-500, and 500-600 lies under no span.  The request's own span
    # is a wait and takes nothing.
    trace = Trace(begin_us=0.0, end_us=1000.0, perf_offset_us=-1e8,
                  device=[("k", 0.0, 200.0, 1, "kernel"),
                          ("k", 600.0, 400.0, 2, "kernel")])
    run = _run(trace=trace)
    ring.record_at(100.0004, "batcher.prefill", ms=0.3)
    ring.record_at(100.0005, "batcher.emit", ms=0.2)
    ring.record_at(100.001, "request.queue", "r1", ms=1.0)
    assert spans.idle_prefill(run) == pytest.approx(20.0)
    printed = json.loads(capsys.readouterr().err.split(
        "spans: idle split ")[-1])
    assert printed["idle_s"] == pytest.approx(400e-6)
    assert printed["by_span"] == pytest.approx(
        {"batcher.prefill": 200e-6, "batcher.emit": 100e-6,
         "no span": 100e-6})
