"""The port's spans in the process ring (``observability/recorder.py``
``process_recorder``, written through ``tpu/profiling.py``): a
request's lifecycle through the ``ContinuousBatcher`` (one
``request.queue``, ``request.admission``, ``request.first`` and
``request.decode`` each, end to end), the step's leaves, the LLM
worker's and the micro-batcher's spans from their own threads, a
wrapped ring, and the ``record_function`` half under a profiler on the
stepping thread.  CPU, the tiny Llama configuration."""

import dataclasses
import json
import queue
import threading
import time

import pytest
import torch

from conftest import run_until
from torch_pipeline_elements import cpu_pool  # noqa: F401

from aiko_services_tpu_torch.models import batching, llama
from aiko_services_tpu_torch.observability.recorder import (
    EVENT_TYPES, PROCESS_CAPACITY, SpanRecorder, process_recorder)
from aiko_services_tpu_torch.pipeline import create_pipeline
from aiko_services_tpu_torch.tpu import profiling

LIFECYCLE = ("request.queue", "request.admission", "request.first",
             "request.decode")
MODES = {
    "host-1": dict(decode_block=1),
    "host-4": dict(decode_block=4),
    "loop-4": dict(decode_block_tokens=4),
    "dense-burst-4": dict(decode_block=4),
}


def _events_since(begin: float) -> list:
    return [event for event in process_recorder().snapshot()
            if event[0] >= begin]


def _serve(mode: str, prompts=(5, 23, 9, 40), max_new_tokens=6):
    attention = "dense" if mode.startswith("dense") else "flash"
    config = dataclasses.replace(llama.LlamaConfig.tiny(128, 64),
                                 dtype="float32", attention=attention)
    params = llama.init_params(0, config, device="cpu")
    batcher = batching.ContinuousBatcher(
        params, config, max_slots=2, prefill_chunk=16, device="cpu",
        **MODES[mode])
    finished = {}
    for index, length in enumerate(prompts):
        rid = f"{mode}/{index}"
        batcher.submit(batching.Request(
            rid, [(7 * index + k) % 128 for k in range(length)],
            max_new_tokens=max_new_tokens,
            emit=lambda r, token, done: done and finished.setdefault(
                r, time.perf_counter())))
    batcher.run_until_drained(max_steps=500)
    assert len(finished) == len(prompts)
    return batcher


@pytest.mark.parametrize("mode", list(MODES))
def test_each_request_has_one_contiguous_lifecycle(mode):
    begin = time.perf_counter()
    batcher = _serve(mode)
    events = _events_since(begin)
    stats = batcher.take_request_stats()
    assert len(stats) == 4
    by_request = {}
    for t, etype, stream, _, _, ms, _ in events:
        if etype in LIFECYCLE:
            by_request.setdefault(stream, {}).setdefault(etype, []).append(
                (t - ms / 1e3, t, ms))
    assert sorted(by_request) == [f"{mode}/{i}" for i in range(4)]
    for rid, spans in by_request.items():
        assert {name: len(found) for name, found in spans.items()} == \
            {name: 1 for name in LIFECYCLE}
        chain = [spans[name][0] for name in LIFECYCLE]
        for (_, end, _), (start, _, _) in zip(chain, chain[1:]):
            assert start == pytest.approx(end, abs=1e-9)
        submitted = chain[0][0]
        finish = chain[-1][1]
        assert sum(ms for _, _, ms in chain) == pytest.approx(
            (finish - submitted) * 1e3, abs=1e-6)
    # The same stamps reach the request stats, in finishing order.
    decode_ends = sorted((spans["request.decode"][0][1], rid)
                         for rid, spans in by_request.items())
    for entry, (_, rid) in zip(stats, decode_ends):
        spans = by_request[rid]
        for key, name in (("queue_ms", "request.queue"),
                          ("admission_ms", "request.admission"),
                          ("first_wait_ms", "request.first")):
            assert entry[key] == pytest.approx(spans[name][0][2], abs=2e-3)
        assert entry["queue_ms"] + entry["admission_ms"] \
            + entry["first_wait_ms"] == pytest.approx(entry["ttft_ms"],
                                                      abs=5e-3)


@pytest.mark.parametrize("mode", ["host-4", "loop-4", "dense-burst-4"])
def test_prefill_spans_hold_every_prompt_token(mode):
    begin = time.perf_counter()
    batcher = _serve(mode)
    events = _events_since(begin)
    rows = [row for event in events if event[1] == "batcher.prefill"
            for row in event[6]["rows"]]
    assert sum(length for _, _, length in rows) == batcher.prefill_tokens
    assert {slot for slot, _, _ in rows} <= {0, 1}
    kinds = {event[1] for event in events}
    assert {"batcher.prefill", "batcher.dispatch", "batcher.fetch",
            "batcher.emit"} <= kinds
    dispatched = [event for event in events
                  if event[1] == "batcher.dispatch"]
    retired = [event for event in events if event[1] == "batcher.emit"]
    assert len(dispatched) == len(retired)
    assert all(event[6]["slots"] for event in dispatched)
    if mode == "dense-burst-4":      # two slots admitted in one pass
        assert any(len(event[6]["rows"]) == 2 for event in events
                   if event[1] == "batcher.prefill")


@pytest.mark.parametrize("profiled", [True, False])
def test_spans_open_record_functions_only_under_a_profiler(profiled,
                                                           monkeypatch):
    opened = []
    record_function = profiling.record_function

    def counting(name):
        opened.append(name)
        return record_function(name)
    monkeypatch.setattr(profiling, "record_function", counting)
    if profiled:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _serve("loop-4", prompts=(20,), max_new_tokens=4)
        names = {event.name for event in prof.events()}
        assert {"batcher.prefill", "batcher.dispatch", "batcher.fetch",
                "batcher.emit"} <= names
        assert {"batcher.prefill", "batcher.emit"} <= set(opened)
    else:
        _serve("loop-4", prompts=(20,), max_new_tokens=4)
        assert opened == []


@pytest.mark.parametrize("capacity, count", [(64, 40), (64, 100)])
def test_a_wrapped_ring_says_so(capacity, count):
    ring = SpanRecorder(capacity)
    for index in range(count):
        ring.record_at(float(index), "batcher.fetch", ms=0.5)
    stats = ring.stats
    assert stats["recorded"] == count
    assert stats["buffered"] == min(count, capacity)
    assert (stats["recorded"] > stats["capacity"]) == (count > capacity)
    # What the ring kept: the newest, oldest first.
    assert ring.snapshot()[0][0] == float(max(0, count - capacity))


def test_the_process_ring():
    ring = process_recorder()
    assert ring is process_recorder() and ring.capacity == PROCESS_CAPACITY
    assert set(LIFECYCLE) | {"llm.inbox", "llm.wait_work",
                             "batcher.prefill", "batcher.dispatch",
                             "batcher.fetch", "batcher.emit",
                             "microbatch.wait", "microbatch.run",
                             "microbatch.finish", "compile"} \
        <= set(EVENT_TYPES)


def test_micro_batcher_spans_each_entry_and_group():
    flushes = []
    done = threading.Event()
    finished = []

    def finish(context, key, entries, result):
        finished.extend(entries)
        if len(finished) == 3:
            done.set()
    micro = batching.MicroBatcher(
        run=lambda context, key, payloads: len(payloads), finish=finish,
        context=lambda: None, schedule_flush=flushes.append,
        name="spans-test")
    begin = time.perf_counter()
    for key, payload in (("a", 1), ("b", 2), ("a", 3)):
        micro.submit(key, payload, lambda *args: None)
    flushes.pop()()
    assert done.wait(10.0)
    micro.stop()
    assert not hasattr(micro, "flushes")
    events = [event for event in _events_since(begin)
              if event[2] == "spans-test"]
    kinds = [event[1] for event in events]
    assert kinds.count("microbatch.wait") == 3
    assert sorted(event[6]["rows"] for event in events
                  if event[1] == "microbatch.run") == [1, 2]
    assert kinds.count("microbatch.finish") == 2


# -- the LLM element's worker and the detector's micro-batcher ----------

N_FRAMES = 6


@pytest.fixture
def runtime():
    from aiko_services_tpu_torch.runtime import init_process, reset_process
    from aiko_services_tpu_torch.services.share import reset_services_cache
    from aiko_services_tpu_torch.transport import reset_broker
    reset_broker()
    reset_services_cache()
    rt = init_process(transport="loopback")
    rt.initialize()
    yield rt
    rt.engine.terminate()
    reset_process()
    reset_services_cache()
    reset_broker()


def _config4(tmp_path):
    root = "aiko_services_tpu_torch"
    definition = {
        "version": 0, "name": "spans_config4", "runtime": "torch",
        "graph": ["(DET (CAP (LLM)))"],
        "elements": [
            {"name": "DET", "input": [{"name": "image"}],
             "output": [{"name": "detections"}],
             "parameters": {"width": 4, "max_batch": 4},
             "placement": {"mesh": {"dp": 1}},
             "deploy": {"local": {"module": f"{root}.elements.detect",
                                  "class_name": "Detector"}}},
            {"name": "CAP", "input": [{"name": "detections"}],
             "output": [{"name": "text"}],
             "deploy": {"local": {"module": f"{root}.elements.llm",
                                  "class_name": "DetectionCaption"}}},
            {"name": "LLM", "input": [{"name": "text"}],
             "output": [{"name": "text"}],
             "parameters": {"max_new_tokens": 4, "max_seq": 128,
                            "device": "cpu", "decode_block_tokens": 4},
             "deploy": {"local": {"module": f"{root}.elements.llm",
                                  "class_name": "LLM"}}}]}
    path = tmp_path / "spans_config4.json"
    path.write_text(json.dumps(definition))
    return str(path)


def test_worker_threads_reach_the_process_ring(tmp_path, runtime,
                                               cpu_pool):
    import numpy as np
    pipeline = create_pipeline(_config4(tmp_path), runtime=runtime)
    element = pipeline.graph.get_node("LLM").element
    begin = time.perf_counter()
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    rng = np.random.default_rng(0)
    for _ in range(N_FRAMES):
        pipeline.create_frame_local(
            stream, {"image": rng.integers(0, 255, (32, 32, 3),
                                           dtype=np.uint8)})
    assert run_until(runtime, lambda: responses.qsize() >= N_FRAMES,
                     timeout=120.0)
    while not responses.empty():
        assert responses.get()[4]
    assert run_until(runtime,
                     lambda: "llm_admission_ms" in pipeline.metrics_text())
    metrics = pipeline.metrics_text()
    assert "llm_queue_ms" in metrics and "llm_ttft_ms" in metrics
    pipeline.stop()
    element.close()
    events = _events_since(begin)
    inbox = {event[2] for event in events if event[1] == "llm.inbox"}
    assert inbox == {f"s/{n}" for n in range(1, N_FRAMES + 1)}
    waits = [event for event in events if event[1] == "microbatch.wait"
             and event[2] == "DET"]
    assert len(waits) == N_FRAMES
    assert any(event[1] == "llm.wait_work" for event in events)
    assert {event[2] for event in events
            if event[1] == "request.decode"} == inbox
    # Each request's spans run from the frame's put to its finish.
    for rid in inbox:
        mine = {event[1]: event for event in events if event[2] == rid}
        start = mine["llm.inbox"][0] - mine["llm.inbox"][5] / 1e3
        total = sum(mine[name][5] for name in ("llm.inbox",) + LIFECYCLE)
        assert total == pytest.approx(
            (mine["request.decode"][0] - start) * 1e3, abs=1e-6)
