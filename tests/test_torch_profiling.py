"""The port's profiler (``aiko_services_tpu_torch/tpu/profiling.py``):
twins of ``tests/test_profiling.py`` -- a process trace plus
``record_function`` spans driven by the pipeline hooks, written as one
Chrome trace JSON -- and the Profiler half of the fused-segment hooks
test (``tests/test_fusion.py``'s
``test_segment_hooks_flag_first_use_compile``), on the port's engine.
Here on the CPU the trace holds CPU activity alone; the card's kernels
inside the spans are held by ``chip_smoke.py`` phase 10."""

import json
import os
import queue

import numpy as np

from conftest import run_until
from test_torch_fusion import CHAIN, _definition as _fusion_definition
from test_torch_llm_element import _port_runtime, _port_teardown

import pytest

from aiko_services_tpu_torch.pipeline import Pipeline, create_pipeline
from aiko_services_tpu_torch.tpu import Profiler, profile_trace

ELEMENTS = "tests/torch_pipeline_elements.py"


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


def _definition():
    def element(name, cls, inputs, outputs):
        return {"name": name,
                "input": [{"name": n} for n in inputs],
                "output": [{"name": n} for n in outputs],
                "deploy": {"local": {"module": ELEMENTS,
                                     "class_name": cls}}}
    return {"version": 0, "name": "p_prof", "runtime": "torch",
            "graph": ["(A B)"],
            "elements": [element("A", "ElementA", ["a"], ["a"]),
                         element("B", "ElementB", ["a"], ["b"])]}


def _run_frame(runtime, pipeline, frame_data):
    responses = queue.Queue()
    pipeline.process_frame_local(frame_data, queue_response=responses)
    run_until(runtime, lambda: not responses.empty())
    assert not responses.empty()


def _spans(path) -> list[str]:
    """The names of the trace's user spans, in the file's order."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [event["name"] for event in events
            if event.get("cat") == "user_annotation"]


def test_element_annotations_balanced(runtime, tmp_path):
    pipeline = Pipeline(_definition(), runtime=runtime)
    profiler = Profiler()
    profiler.start(str(tmp_path / "trace"))
    profiler.attach(pipeline)
    try:
        _run_frame(runtime, pipeline, {"a": 1})
        _run_frame(runtime, pipeline, {"a": 2})
    finally:
        profiler.detach()
        assert not profiler._open       # every span closed
        path = profiler.stop()
    assert not profiler.active
    # post hook fired once per element per frame
    assert pipeline._hooks["pipeline.process_element_post:0"].count == 4
    # one Chrome trace file under logdir, one span per element a frame
    produced = [os.path.join(root, f)
                for root, _, files in os.walk(tmp_path) for f in files]
    assert produced == [path] and path.endswith(".json")
    spans = _spans(path)
    assert spans.count("element:A") == spans.count("element:B") == 2


def test_profile_trace_context_manager(runtime, tmp_path):
    pipeline = Pipeline(_definition(), runtime=runtime)
    with profile_trace(str(tmp_path / "t2"), pipeline) as profiler:
        assert profiler.active
        _run_frame(runtime, pipeline, {"a": 3})
    assert not profiler.active
    assert profiler._pipelines == []
    (trace,) = os.listdir(tmp_path / "t2")
    assert _spans(tmp_path / "t2" / trace).count("element:A") == 1


def test_unwind_closes_nested_pairs_innermost_first():
    """``detach()``/``_unwind()`` close nested ``compile:``/``segment:``
    pairs INNERMOST-first, whatever the insertion order."""
    profiler = Profiler()
    exits = []

    class FakeSpan:
        def __init__(self, name):
            self.name = name

        def __exit__(self, *args):
            exits.append(self.name)

    base = ("S", "stream", 0)
    # Adversarial insertion order: the outer compile: span sits AFTER
    # its inner segment: span (re-entry scramble), with an element span
    # opened in between.
    profiler._open[("segment",) + base] = FakeSpan("segment:S")
    profiler._open[("E", "stream", 0)] = FakeSpan("element:E")
    profiler._open[("compile",) + base] = FakeSpan("compile:S")
    profiler._unwind()
    assert not profiler._open
    assert exits.index("segment:S") < exits.index("compile:S"), exits
    # Non-compile spans still close in reverse insertion order.
    assert exits[0] == "element:E"


def test_dangling_annotation_unwound(runtime, tmp_path):
    """An element that raises must not leak its open span into later
    elements (detach unwinds anything that still dangles)."""
    definition = _definition()
    definition["elements"][1]["deploy"]["local"]["class_name"] = "Raiser"
    definition["graph"] = ["(A B)"]
    pipeline = Pipeline(definition, runtime=runtime)
    with profile_trace(str(tmp_path / "t3"), pipeline) as profiler:
        responses = queue.Queue()
        pipeline.process_frame_local({"a": 1}, queue_response=responses)
        run_until(runtime, lambda: not responses.empty())
        assert len(profiler._open) <= 1      # only B's dangling span
        _run_frame(runtime, pipeline, {"a": 1})
    assert not profiler._open


def test_hooks_match_the_jax_profiler():
    """Both packages' Profilers attach the same seven hooks and remove
    them all at detach."""
    from aiko_services_tpu.tpu import Profiler as JaxProfiler

    class Recorder:
        def __init__(self):
            self.hooks = []

        def add_hook_handler(self, name, handler):
            self.hooks.append(name)

        def remove_hook_handler(self, name, handler):
            self.hooks.remove(name)

    ours, theirs = Recorder(), Recorder()
    port_profiler, jax_profiler = Profiler(), JaxProfiler()
    port_profiler.attach(ours)
    jax_profiler.attach(theirs)
    assert ours.hooks == theirs.hooks and len(ours.hooks) == 7
    port_profiler.detach()
    jax_profiler.detach()
    assert ours.hooks == theirs.hooks == []


def test_stop_without_start_returns_none():
    profiler = Profiler()
    assert profiler.stop() is None
    assert not profiler.active


def test_stage_hop_and_stage_spans(tmp_path):
    """The stage hooks open one ``stage:`` span a (stage, stream, frame)
    and a hop leaves a zero-width ``hop:`` mark on the trace."""
    profiler = Profiler()
    profiler.start(str(tmp_path / "t4"))
    variables = {"stage": "s0", "stream": "1", "frame": 0}
    profiler._on_stage(None, None, variables)
    profiler._on_stage(None, None, variables)        # a retry re-enters
    assert len(profiler._open) == 1
    profiler._on_stage_hop(None, None, variables)
    profiler._on_stage_post(None, None, variables)
    assert not profiler._open
    spans = _spans(profiler.stop())
    assert spans.count("stage:s0") == 2 and spans.count("hop:s0") == 1


def test_segment_hooks_spans_balanced(tmp_path, runtime):
    """The Profiler half of the fused-segment hooks test: attached to a
    fused chain, every span closes, and the trace holds one ``segment:``
    span a dispatch and one ``compile:`` span for the first-use
    capture."""
    pipeline = create_pipeline(
        _fusion_definition(tmp_path, CHAIN, ["(up d1 d2 d3)"]),
        runtime=runtime)
    seen = []
    pipeline.add_hook_handler(
        "pipeline.process_segment:0",
        lambda component, hook, variables: seen.append(dict(variables)))
    profiler = Profiler()
    profiler.start(str(tmp_path / "trace"))
    profiler.attach(pipeline)
    try:
        responses = queue.Queue()
        stream = pipeline.create_stream_local(
            "s", queue_response=responses)
        for i in range(2):
            pipeline.create_frame_local(
                stream, {"x": np.full(4, i, dtype=np.float32)})
        assert run_until(runtime, lambda: responses.qsize() >= 2,
                         timeout=30.0)
    finally:
        profiler.detach()
        path = profiler.stop()
    assert not profiler._open               # every span closed
    assert [entry["compile"] for entry in seen] == [True, False]
    post = pipeline._hooks["pipeline.process_segment_post:0"]
    assert post.count == 2
    spans = _spans(path)
    assert spans.count("segment:up+d1+d2+d3") == 2
    assert spans.count("compile:up+d1+d2+d3") == 1
    pipeline.stop()
