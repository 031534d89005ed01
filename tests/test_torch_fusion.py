"""The port's fused device segments (``aiko_services_tpu_torch/pipeline/
fusion.py``): twins of ``tests/test_fusion.py`` -- the partitioner, the
single-dispatch fused call, donation bookkeeping, the unfused
retry/resume fallback, the segment hooks and the env-gated build
directory -- on the port's ``create_pipeline`` with ``device: cpu``
(eagerly; on the card a segment is one captured CUDA graph,
``tests/test_torch_fusion_cuda.py``), and the JAX package's
``(R1 (R2 (DET)))`` chain against the port's, frame by frame.

All fused-path pipelines here run under ``transfer_guard: disallow``
as the reference's do: one device dispatch per segment per frame, fused
outputs equal to unfused, zero ledger-counted host transfers inside a
segment."""

import dataclasses
import json
import queue

import numpy as np
import pytest
import torch

from conftest import run_until
from test_torch_image import assert_images_close
from test_torch_llm_element import _port_runtime, _port_teardown
from torch_pipeline_elements import cpu_pool  # noqa: F401

from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import detector as port_detector
from aiko_services_tpu_torch.pipeline import (DeviceFn, FusedSegment,
                                              FusionError, PipelineElement,
                                              StreamEvent, create_pipeline)
from aiko_services_tpu_torch.pipeline import fusion

# tests/test_torch_detector.py's tolerance on boxes and scores
DETECT_TOL = 1e-4


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


# -- fusable test elements ----------------------------------------------


class DeviceUpload(PipelineElement):
    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": _tensor(x)}

    def device_fn(self, stream):
        return DeviceFn(fn=lambda x: {"x": _tensor(x)},
                        inputs=("x",), outputs=("x",))


class DeviceDouble(PipelineElement):
    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": _tensor(x) * 2}

    def device_fn(self, stream):
        return DeviceFn(fn=lambda x: {"x": _tensor(x) * 2},
                        inputs=("x",), outputs=("x",))


class DeviceAddOne(PipelineElement):
    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": _tensor(x) + 1}

    def device_fn(self, stream):
        return DeviceFn(fn=lambda x: {"x": _tensor(x) + 1},
                        inputs=("x",), outputs=("x",))


class DeviceNoFn(PipelineElement):
    """Device-resident but declares no device_fn: never fused."""

    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": _tensor(x) * 3}


class HostSink(PipelineElement):
    host_inputs = ("x",)

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": _tensor(np.asarray(x) + 0.5)}


class AsyncDevice(PipelineElement):
    device_resident = True
    is_async = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": _tensor(x) - 1}

    def process_frame_start(self, stream, complete, x=None, **inputs):
        complete(StreamEvent.OKAY, {"x": _tensor(x) - 1})

    def device_fn(self, stream):
        # Declared fusable, but the async park path must still win
        # unless ``synchronous: true`` forces the blocking path.
        return DeviceFn(fn=lambda x: {"x": _tensor(x) - 1},
                        inputs=("x",), outputs=("x",))


def _host_read(x):
    """A host read of a device value inside the segment: a CUDA graph
    capture refuses it on the card; here it raises the same way, so the
    CPU walks the fallback the card would."""
    raise RuntimeError("operation not permitted when stream is capturing")


class BadTrace(PipelineElement):
    """device_fn whose capture fails (a host read of a device value):
    the engine must poison the segment and fall back to per-element
    execution."""

    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": _tensor(x) * 5}

    def device_fn(self, stream):
        return DeviceFn(fn=lambda x: {"x": x * _host_read(x)},
                        inputs=("x",), outputs=("x",))


def _definition(tmp_path, elements, graph, parameters=None):
    body = {
        "version": 0, "name": "fusion", "runtime": "torch",
        "graph": graph, "parameters": parameters or {},
        "elements": [
            {"name": name,
             "input": [{"name": "x"}],
             "output": [{"name": "x"}],
             "parameters": {"device": "cpu", **(params or {})},
             "deploy": {"local": {"module": "test_torch_fusion",
                                  "class_name": cls}}}
            for name, cls, params in elements]}
    path = tmp_path / "fusion.json"
    path.write_text(json.dumps(body))
    return str(path)


def _run_one(pipeline, runtime, value, stream_id="s"):
    responses = queue.Queue()
    stream = pipeline.create_stream_local(stream_id,
                                          queue_response=responses)
    pipeline.create_frame_local(stream, {"x": value})
    assert run_until(runtime, lambda: not responses.empty(), timeout=30.0)
    _, _, swag, metrics, okay, diagnostic = responses.get()
    return swag, metrics, okay, diagnostic


CHAIN = [("up", "DeviceUpload", {}), ("d1", "DeviceDouble", {}),
         ("d2", "DeviceDouble", {}), ("d3", "DeviceAddOne", {})]


# -- acceptance: one dispatch per segment, outputs equal, zero transfers -


def test_fused_chain_is_one_dispatch_and_matches_unfused(
        tmp_path, runtime):
    value = np.arange(8, dtype=np.float32)
    fused = create_pipeline(
        _definition(tmp_path, CHAIN, ["(up d1 d2 d3)"],
                    parameters={"transfer_guard": "disallow"}),
        runtime=runtime)
    swag, metrics, okay, diagnostic = _run_one(fused, runtime, value)
    assert okay, diagnostic
    # ONE device dispatch for the >=3-element device chain, below the
    # per-element count...
    assert metrics["device_dispatches"] == 1 < len(CHAIN)
    assert metrics["fused_segments"] == 1
    assert metrics["fused_elements"] == len(CHAIN)
    # ...with zero ledger-counted host transfers inside the segment...
    stats = fused.transfer_stats()
    assert stats["implicit"] == 0
    assert stats["explicit"] == 0
    assert isinstance(swag["x"], torch.Tensor)  # still device-resident
    fused.stop()

    unfused = create_pipeline(
        _definition(tmp_path, CHAIN, ["(up d1 d2 d3)"],
                    parameters={"transfer_guard": "disallow",
                                "fuse": "off"}),
        runtime=runtime)
    swag_off, metrics_off, okay_off, diagnostic_off = _run_one(
        unfused, runtime, value)
    assert okay_off, diagnostic_off
    # ...and fused outputs equal to unfused.
    np.testing.assert_array_equal(np.asarray(swag["x"]),
                                  np.asarray(swag_off["x"]))
    assert metrics_off["device_dispatches"] == len(CHAIN)
    assert "fused_segments" not in metrics_off
    unfused.stop()


def test_fused_share_and_jit_stats(tmp_path, runtime):
    pipeline = create_pipeline(
        _definition(tmp_path, CHAIN, ["(up d1 d2 d3)"]),
        runtime=runtime)
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    for i in range(3):
        pipeline.create_frame_local(
            stream, {"x": np.full(8, i, dtype=np.float32)})
    assert run_until(runtime, lambda: responses.qsize() >= 3,
                     timeout=30.0)
    # One capture (miss) then replays (hits), surfaced on the share
    # dict the dashboard reads and via jit_stats().
    stats = pipeline.jit_stats()
    segment_stats = list(stats["segments"].values())
    assert len(segment_stats) == 1
    assert segment_stats[0]["jit"]["misses"] == 1
    assert segment_stats[0]["jit"]["hits"] == 2
    assert segment_stats[0]["calls"] == 3
    assert segment_stats[0]["donation"] is False
    assert segment_stats[0]["dispatch_p50_ms"] is not None
    assert pipeline.share["jit_cache_misses"] == stats["misses"]
    assert pipeline.share["jit_cache_entries"] >= 1
    assert pipeline.share["fused_segments"] == 1
    assert pipeline.share["fused_dispatches"] == 3
    pipeline.stop()


# -- partitioner boundaries ----------------------------------------------


def _partition_names(pipeline, stream_id="s"):
    """[entry names]: 'a+b' for segments, plain name for nodes."""
    stream = pipeline.create_stream_local(stream_id)
    pipeline._current_stream_ref = stream
    try:
        entries = fusion.partition(
            pipeline, pipeline.graph.get_path(stream.graph_path), stream)
    finally:
        pipeline._current_stream_ref = None
    return [entry.name for entry in entries]


def test_partitioner_host_input_boundary(tmp_path, runtime):
    pipeline = create_pipeline(
        _definition(tmp_path,
                    CHAIN[:2] + [("sink", "HostSink", {})]
                    + [("d4", "DeviceDouble", {}),
                       ("d5", "DeviceDouble", {})],
                    ["(up d1 sink d4 d5)"]),
        runtime=runtime)
    # The host-input sink splits the chain; both device runs fuse.
    assert _partition_names(pipeline) == ["up+d1", "sink", "d4+d5"]
    pipeline.stop()


def test_partitioner_microbatch_async_boundary(tmp_path, runtime):
    pipeline = create_pipeline(
        _definition(tmp_path,
                    CHAIN[:2] + [("a1", "AsyncDevice", {}),
                                 ("d4", "DeviceDouble", {}),
                                 ("d5", "DeviceDouble", {})],
                    ["(up d1 a1 d4 d5)"]),
        runtime=runtime)
    # The async (park/micro-batch) stage never joins a segment...
    assert _partition_names(pipeline) == ["up+d1", "a1", "d4+d5"]
    pipeline.stop()
    # ...unless synchronous: true forces its blocking path, which IS
    # fusable.
    sync = create_pipeline(
        _definition(tmp_path,
                    CHAIN[:2] + [("a1", "AsyncDevice",
                                  {"synchronous": True}),
                                 ("d4", "DeviceDouble", {})],
                    ["(up d1 a1 d4)"]),
        runtime=runtime)
    assert _partition_names(sync) == ["up+d1+a1+d4"]
    swag, metrics, okay, diagnostic = _run_one(
        sync, runtime, np.ones(4, dtype=np.float32), stream_id="s2")
    assert okay, diagnostic
    np.testing.assert_array_equal(np.asarray(swag["x"]),
                                  (np.ones(4) * 2 - 1) * 2)
    sync.stop()


def test_device_chain_after_async_park_still_fuses(tmp_path, runtime):
    """The async park site is a partition boundary: the resumed suffix
    re-enters the fused plan, so a device chain AFTER an async stage
    still executes as one dispatch (sharing the captured segment with
    the full-path plan)."""
    pipeline = create_pipeline(
        _definition(tmp_path,
                    [("up", "DeviceUpload", {}),
                     ("a1", "AsyncDevice", {})] + CHAIN[1:],
                    ["(up a1 d1 d2 d3)"],
                    parameters={"transfer_guard": "disallow"}),
        runtime=runtime)
    value = np.arange(4, dtype=np.float32)
    swag, metrics, okay, diagnostic = _run_one(pipeline, runtime, value)
    assert okay, diagnostic
    np.testing.assert_array_equal(np.asarray(swag["x"]),
                                  (value - 1) * 2 * 2 + 1)
    assert metrics["fused_segments"] == 1           # d1+d2+d3, resumed
    assert metrics["fused_elements"] == 3
    # up (sync walk) + a1 (async submit) + the fused suffix = 3.
    assert metrics["device_dispatches"] == 3
    # One segment object serves both the full-path plan and the resume
    # suffix plan -- no duplicate capture.
    assert len(pipeline.fused_segments) == 1
    assert pipeline.fused_segments[0].calls == 1
    pipeline.stop()


def test_donation_blocked_for_mapped_qualified_reads(tmp_path, runtime):
    """A downstream node whose input mapping reads a producer-qualified
    key (``pre.x``) pins that buffer: the segment must never donate
    it, or the consumer would see a dead buffer after the alias pop."""
    pipeline = create_pipeline(
        _definition(tmp_path, CHAIN, ["(up d1 d2 d3)"]),
        runtime=runtime)
    stream = pipeline.create_stream_local("s")
    entries = pipeline._fusion_entries(
        stream, pipeline.graph.get_path(None))
    segment = next(e for e in entries if isinstance(e, FusedSegment))
    assert segment.donation is False            # never on its own
    segment.donation = True                     # as the reference's
    value = torch.arange(4, dtype=torch.float32)
    resolved = {"x": value}
    swag = {"x": value, "pre.x": value}
    assert segment.donate_keys(resolved, swag, {"x": "pre"}) == {"x"}
    # The same key with its qualified alias named by a graph mapping:
    # blocked.
    segment._qualified_reads = frozenset({"pre.x"})
    assert segment.donate_keys(resolved, swag, {"x": "pre"}) == set()
    pipeline.stop()


def test_partitioner_single_nodes_stay_unfused(tmp_path, runtime):
    """A lone fusable node between boundaries gains nothing from a
    one-element 'segment'; it stays a plain per-element dispatch.  An
    element without a device_fn is a boundary too (the wire-sink /
    opaque element case)."""
    pipeline = create_pipeline(
        _definition(tmp_path,
                    [("up", "DeviceUpload", {}),
                     ("o1", "DeviceNoFn", {}),
                     ("d1", "DeviceDouble", {}),
                     ("o2", "DeviceNoFn", {}),
                     ("d2", "DeviceDouble", {}),
                     ("d3", "DeviceDouble", {})],
                    ["(up o1 d1 o2 d2 d3)"]),
        runtime=runtime)
    assert _partition_names(pipeline) == ["up", "o1", "d1", "o2", "d2+d3"]
    swag, metrics, okay, diagnostic = _run_one(
        pipeline, runtime, np.ones(4, dtype=np.float32),
        stream_id="s2")
    assert okay, diagnostic
    np.testing.assert_array_equal(np.asarray(swag["x"]),
                                  np.ones(4) * 3 * 2 * 3 * 2 * 2)
    pipeline.stop()


def test_fuse_off_parameter_disables_partitioning(tmp_path, runtime):
    pipeline = create_pipeline(
        _definition(tmp_path, CHAIN, ["(up d1 d2 d3)"],
                    parameters={"fuse": "off"}),
        runtime=runtime)
    _run_one(pipeline, runtime, np.ones(4, dtype=np.float32))
    assert pipeline.fusion_stats()["segments"] == 0
    pipeline.stop()


# -- donation bookkeeping and replay safety ------------------------------


def test_donation_does_not_corrupt_retry_replays(tmp_path, runtime):
    """A frame that ran fused must replay cleanly through the unfused
    retry path: the swag holds only live buffers afterwards, and the
    replayed outputs match."""
    elements = [("up", "DeviceUpload", {}), ("pre", "DeviceNoFn", {})] \
        + CHAIN[1:]
    pipeline = create_pipeline(
        _definition(tmp_path, elements, ["(up pre d1 d2 d3)"],
                    parameters={"transfer_guard": "disallow"}),
        runtime=runtime)
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    value = np.arange(4, dtype=np.float32)
    pipeline.create_frame_local(stream, {"x": value})
    assert run_until(runtime, lambda: not responses.empty(), timeout=30.0)
    _, frame_id, swag, metrics, okay, diagnostic = responses.get()
    assert okay, diagnostic
    expected = value * 3 * 2 * 2 + 1
    np.testing.assert_array_equal(np.asarray(swag["x"]), expected)
    assert metrics["fused_segments"] == 1       # d1+d2+d3 fused
    # Every swag leaf is still materializable (no dangling donated
    # buffer survived map-out).
    for key, leaf in swag.items():
        np.asarray(leaf)

    # Unfused replay of the same frame from scratch: same result.
    from aiko_services_tpu_torch.pipeline.stream import Frame
    replay = Frame(frame_id=99, swag={"x": value})
    pipeline.retry_frame("s", replay)
    assert run_until(runtime, lambda: not responses.empty(), timeout=30.0)
    _, _, swag2, metrics2, okay2, diagnostic2 = responses.get()
    assert okay2, diagnostic2
    assert "fused_segments" not in metrics2     # retry path is unfused
    np.testing.assert_array_equal(np.asarray(swag2["x"]), expected)
    pipeline.stop()


def test_retry_frame_at_resumes_unfused_mid_chain(tmp_path, runtime):
    pipeline = create_pipeline(
        _definition(tmp_path, CHAIN, ["(up d1 d2 d3)"]),
        runtime=runtime)
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    value = np.arange(4, dtype=np.float32)
    pipeline.create_frame_local(stream, {"x": value})
    assert run_until(runtime, lambda: not responses.empty(), timeout=30.0)
    responses.get()

    # Resume a frame mid-(would-be-)segment: per-element execution,
    # correct continuation from the existing swag.
    from aiko_services_tpu_torch.pipeline.stream import Frame
    frame = Frame(frame_id=7, swag={"x": torch.as_tensor(value)})
    pipeline.retry_frame_at("s", frame, "d2")
    assert run_until(runtime, lambda: not responses.empty(), timeout=30.0)
    _, _, swag, metrics, okay, diagnostic = responses.get()
    assert okay, diagnostic
    assert "fused_segments" not in metrics
    np.testing.assert_array_equal(np.asarray(swag["x"]), value * 2 + 1)
    pipeline.stop()


def test_broken_trace_falls_back_to_per_element(tmp_path, runtime):
    """A device_fn that lies about purity (a host read inside the
    segment) must not take the frame down: the segment poisons itself
    and the chain runs per-element, every frame, with correct
    outputs."""
    pipeline = create_pipeline(
        _definition(tmp_path,
                    [("up", "DeviceUpload", {}),
                     ("bad", "BadTrace", {}),
                     ("d1", "DeviceDouble", {})],
                    ["(up bad d1)"]),
        runtime=runtime)
    value = np.full(4, 2.0, dtype=np.float32)
    swag, metrics, okay, diagnostic = _run_one(pipeline, runtime, value)
    assert okay, diagnostic
    np.testing.assert_array_equal(np.asarray(swag["x"]), value * 5 * 2)
    assert pipeline.fusion_stats()["broken"] == 1
    # Later frames skip the poisoned segment without re-failing.
    responses = queue.Queue()
    stream = pipeline.streams["s"]
    stream.queue_response = responses
    pipeline.create_frame_local(stream, {"x": value})
    assert run_until(runtime, lambda: not responses.empty(), timeout=30.0)
    *_, okay2, diagnostic2 = responses.get()
    assert okay2, diagnostic2
    pipeline.stop()


# -- the segment's device ------------------------------------------------


def test_segment_uploads_host_reads_and_keys_the_upload(tmp_path,
                                                        runtime):
    """A host read goes up to the segment's device before the call, and
    ``would_compile`` keys the call as it is made: a miss for the first
    numpy frame of a signature and a hit for the next -- never a probe
    on the host form that disagrees with the cache."""
    pipeline = create_pipeline(
        _definition(tmp_path, CHAIN, ["(up d1 d2 d3)"]),
        runtime=runtime)
    stream = pipeline.create_stream_local("s")
    pipeline._current_stream_ref = stream
    segment = next(e for e in pipeline._fusion_entries(
        stream, pipeline.graph.get_path(None))
        if isinstance(e, FusedSegment))
    pipeline._current_stream_ref = None
    assert segment.device == torch.device("cpu")
    host = {"x": np.arange(4, dtype=np.float32)}
    assert segment.would_compile(host, set()) is True
    out = segment.call(host, set())
    assert isinstance(out["d3.x"], torch.Tensor)
    assert segment.would_compile(host, set()) is False
    # The same signature as a tensor keys the same entry.
    assert segment.would_compile({"x": torch.arange(4.0)}, set()) is False
    assert segment.would_compile({"x": np.arange(5, dtype=np.float32)},
                                 set()) is True
    assert segment.jit_cache.stats["misses"] == 1
    pipeline.stop()


def test_members_on_different_devices_raise(tmp_path, runtime):
    pipeline = create_pipeline(
        _definition(tmp_path, CHAIN[:2], ["(up d1)"]),
        runtime=runtime)
    stream = pipeline.create_stream_local("s")
    nodes = pipeline.graph.get_path(None)
    pipeline._current_stream_ref = stream
    try:
        dfns = [fusion.fusable(pipeline, node, stream) for node in nodes]
        nodes[1].element.set_parameter("device", "meta")
        with pytest.raises(FusionError, match="different devices"):
            FusedSegment(pipeline, nodes, dfns, stream_id="s")
    finally:
        pipeline._current_stream_ref = None
    pipeline.stop()


# -- real elements: fused vs unfused equality ----------------------------


PORT = "aiko_services_tpu_torch"


def _media_definition(tmp_path, parameters=None, root=PORT,
                      runtime="torch", sizes=((32, 32), (16, 16)),
                      detector_width=4):
    """Two synchronous ImageResizes + a synchronous Detector -- the real
    device chain (image elements + detect), config4's DET leg run
    synchronously so it fuses."""
    device = {"device": "cpu"} if root == PORT else {}
    body = {
        "version": 0, "name": "fusion_media", "runtime": runtime,
        "graph": ["(R1 (R2 (DET)))"],
        "parameters": parameters or {},
        "elements": [
            {"name": name, "input": [{"name": "image"}],
             "output": [{"name": "image"}],
             "parameters": {"width": width, "height": height,
                            "synchronous": True, **device},
             "deploy": {"local": {
                 "module": f"{root}.elements.image",
                 "class_name": "ImageResize"}}}
            for name, (height, width) in zip(("R1", "R2"), sizes)] + [
            {"name": "DET", "input": [{"name": "image"}],
             "output": [{"name": "image"}, {"name": "overlay"},
                        {"name": "detections"}],
             "parameters": {"width": detector_width,
                            "synchronous": True},
             "deploy": {"local": {
                 "module": f"{root}.elements.detect",
                 "class_name": "Detector"}}},
        ]}
    path = tmp_path / f"fusion_media_{runtime}.json"
    path.write_text(json.dumps(body))
    return str(path)


def test_media_chain_fused_matches_unfused(tmp_path, runtime, cpu_pool):
    """The real ImageResize->ImageResize->Detector chain: fused under
    ``transfer_guard: disallow`` (the Detector's slate fetch rides the
    engine's ONE counted finalize fetch), outputs identical to the
    ``fuse: off`` walk."""
    rng = np.random.default_rng(3)
    image = rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)

    fused = create_pipeline(
        _media_definition(tmp_path, {"transfer_guard": "disallow"}),
        runtime=runtime)
    responses = queue.Queue()
    stream = fused.create_stream_local("sf", queue_response=responses)
    fused.create_frame_local(stream, {"image": image})
    assert run_until(runtime, lambda: not responses.empty(), timeout=60.0)
    _, _, swag, metrics, okay, diagnostic = responses.get()
    assert okay, diagnostic
    assert metrics.get("fused_segments") == 1
    assert metrics["device_dispatches"] == 1
    # The Detector finalize paid exactly ONE counted fetch.
    assert fused.transfer_stats()["explicit"] == 1
    assert fused.transfer_stats()["implicit"] == 0
    assert fused.fusion_stats()["broken"] == 0
    fused.stop()

    unfused = create_pipeline(
        _media_definition(tmp_path, {"fuse": "off"}),
        runtime=runtime)
    responses = queue.Queue()
    stream = unfused.create_stream_local("su", queue_response=responses)
    unfused.create_frame_local(stream, {"image": image})
    assert run_until(runtime, lambda: not responses.empty(), timeout=60.0)
    _, _, swag_off, _, okay_off, diagnostic_off = responses.get()
    assert okay_off, diagnostic_off
    np.testing.assert_array_equal(np.asarray(swag["image"]),
                                  np.asarray(swag_off["image"]))
    assert swag["detections"] == swag_off["detections"]
    assert swag["overlay"] == swag_off["overlay"]
    unfused.stop()


def test_audio_fft_passthrough_preserves_host_types(tmp_path, runtime):
    """sample_rate rides AROUND the trace: after a fused AudioFFT the
    swag's sample_rate is still the plain int the unfused path keeps."""
    body = {
        "version": 0, "name": "fusion_fft", "runtime": "torch",
        "graph": ["(FFT)"], "parameters": {},
        "elements": [
            {"name": "FFT",
             "input": [{"name": "frames"}, {"name": "sample_rate"}],
             "output": [{"name": "spectrum"}, {"name": "sample_rate"}],
             "parameters": {"synchronous": True, "device": "cpu"},
             "deploy": {"local": {
                 "module": f"{PORT}.elements.audio",
                 "class_name": "AudioFFT"}}}]}
    path = tmp_path / "fusion_fft.json"
    path.write_text(json.dumps(body))
    pipeline = create_pipeline(str(path), runtime=runtime)
    stream = pipeline.create_stream_local("s")
    entries = pipeline._fusion_entries(
        stream, pipeline.graph.get_path(None))
    # A single element never forms a segment; the passthrough contract
    # is exercised through a 2-element chain below instead.
    assert all(not isinstance(entry, FusedSegment) for entry in entries)
    pipeline.stop()


def test_fft_chain_passthrough_sample_rate(tmp_path, runtime):
    body = {
        "version": 0, "name": "fusion_fft2", "runtime": "torch",
        "graph": ["(FR (FFT))"], "parameters": {},
        "elements": [
            {"name": "FR",
             "input": [{"name": "audio"}, {"name": "sample_rate"}],
             "output": [{"name": "frames"}, {"name": "sample_rate"}],
             "parameters": {"window": 16, "hop": 8, "device": "cpu"},
             "deploy": {"local": {
                 "module": f"{PORT}.elements.audio",
                 "class_name": "AudioFraming"}}},
            {"name": "FFT",
             "input": [{"name": "frames"}, {"name": "sample_rate"}],
             "output": [{"name": "spectrum"}, {"name": "sample_rate"}],
             "parameters": {"synchronous": True, "device": "cpu"},
             "deploy": {"local": {
                 "module": f"{PORT}.elements.audio",
                 "class_name": "AudioFFT"}}}]}
    path = tmp_path / "fusion_fft2.json"
    path.write_text(json.dumps(body))
    pipeline = create_pipeline(str(path), runtime=runtime)
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    audio = np.sin(np.linspace(0, 20, 64)).astype(np.float32)
    pipeline.create_frame_local(stream,
                                {"audio": audio, "sample_rate": 8000})
    assert run_until(runtime, lambda: not responses.empty(), timeout=30.0)
    _, _, swag, metrics, okay, diagnostic = responses.get()
    assert okay, diagnostic
    assert swag["sample_rate"] == 8000
    assert isinstance(swag["sample_rate"], int)     # type preserved
    element = pipeline.graph.get_node("FFT").element
    pipeline._current_stream_ref = stream
    _, sync_out = element.process_frame(
        None, frames=np.asarray(swag["frames"]))
    pipeline._current_stream_ref = None
    np.testing.assert_allclose(np.asarray(swag["spectrum"]),
                               np.asarray(sync_out["spectrum"]),
                               rtol=1e-5, atol=1e-5)
    pipeline.stop()


# -- config4 graph: fused vs unfused outputs equal -----------------------


def _config4_definition(tmp_path, parameters):
    definition = {
        "version": 0, "name": "config4_fuse", "runtime": "torch",
        "graph": ["(DET (CAP (LLM)))"],
        "parameters": parameters,
        "elements": [
            {"name": "DET",
             "input": [{"name": "image"}],
             "output": [{"name": "image"}, {"name": "overlay"},
                        {"name": "detections"}],
             "parameters": {"width": 4, "synchronous": True},
             "deploy": {"local": {
                 "module": f"{PORT}.elements.detect",
                 "class_name": "Detector"}}},
            {"name": "CAP",
             "input": [{"name": "detections"}],
             "output": [{"name": "text"}],
             "deploy": {"local": {
                 "module": f"{PORT}.elements.llm",
                 "class_name": "DetectionCaption"}}},
            {"name": "LLM",
             "input": [{"name": "text"}],
             "output": [{"name": "text"}],
             "parameters": {"max_new_tokens": 4, "max_seq": 64,
                            "synchronous": True, "device": "cpu"},
             "deploy": {"local": {
                 "module": f"{PORT}.elements.llm",
                 "class_name": "LLM"}}},
        ]}
    path = tmp_path / "config4_fuse.json"
    path.write_text(json.dumps(definition))
    return str(path)


def test_config4_fused_matches_unfused(tmp_path, runtime, cpu_pool):
    """The config-4 composition under ``fuse: auto`` vs ``fuse: off``:
    identical outputs.  (Nothing in this graph is legal to fuse -- DET
    finalizes host detections consumed by the host CAP, the LLM is a
    host-text stage -- so auto mode's whole job here is to decline
    correctly.)"""
    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    texts = {}
    for mode in ("auto", "off"):
        pipeline = create_pipeline(
            _config4_definition(tmp_path, {"fuse": mode}),
            runtime=runtime)
        responses = queue.Queue()
        stream = pipeline.create_stream_local(
            f"s_{mode}", queue_response=responses)
        pipeline.create_frame_local(stream, {"image": image.copy()})
        assert run_until(runtime, lambda: not responses.empty(),
                         timeout=300.0)
        _, _, swag, _, okay, diagnostic = responses.get()
        assert okay, diagnostic
        texts[mode] = (swag["text"], swag["detections"])
        assert pipeline.fusion_stats()["segments"] == 0
        element = pipeline.graph.get_node("LLM").element
        pipeline.stop()
        element.close()
    assert texts["auto"] == texts["off"]


def test_donate_keys_eligibility(tmp_path, runtime):
    """Donation bookkeeping (unit; the port never donates on its own):
    only frame-produced, segment-overwritten, unaliased swag tensors
    qualify -- ingest/user data and externally-aliased values never
    do."""
    pipeline = create_pipeline(
        _definition(tmp_path, CHAIN, ["(up d1 d2 d3)"]),
        runtime=runtime)
    stream = pipeline.create_stream_local("s")
    entries = pipeline._fusion_entries(
        stream, pipeline.graph.get_path(None))
    segment = next(e for e in entries if isinstance(e, FusedSegment))
    value = torch.arange(4, dtype=torch.float32)
    resolved = {"x": value}
    swag = {"x": value, "pre.x": value}
    # Off by default: nothing is donated, whatever the provenance.
    assert segment.donate_keys(resolved, swag, {"x": "pre"}) == set()
    segment.donation = True                 # as the reference's

    # Ingest/user-supplied value (no provenance): never donated.
    assert segment.donate_keys(resolved, {"x": value}, {}) == set()
    # Produced by an earlier element, overwritten by the segment, only
    # the bare + producer-qualified aliases in the swag: donatable.
    assert segment.donate_keys(resolved, swag, {"x": "pre"}) == {"x"}
    # A third alias elsewhere in the swag blocks donation.
    swag["kept_copy"] = value
    assert segment.donate_keys(resolved, swag, {"x": "pre"}) == set()
    # Host values never donate.
    host = {"x": np.arange(4, dtype=np.float32)}
    assert segment.donate_keys(
        host, {"x": host["x"], "pre.x": host["x"]}, {"x": "pre"}) == set()
    pipeline.stop()


# -- segment hooks -------------------------------------------------------


def test_segment_hooks_flag_first_use_compile(tmp_path, runtime):
    """The engine fires segment enter/post hooks around the single
    dispatch, flagging the first-use capture (``compile: True``) so a
    profiler can annotate first-frame capture time separately from
    steady-state steps.  (The reference also attaches its jax
    ``Profiler``; the port has none, so the hooks are held alone.)"""
    pipeline = create_pipeline(
        _definition(tmp_path, CHAIN, ["(up d1 d2 d3)"]),
        runtime=runtime)
    seen, posts = [], []
    pipeline.add_hook_handler(
        "pipeline.process_segment:0",
        lambda component, hook, variables: seen.append(dict(variables)))
    pipeline.add_hook_handler(
        "pipeline.process_segment_post:0",
        lambda component, hook, variables: posts.append(dict(variables)))
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    for i in range(2):
        pipeline.create_frame_local(
            stream, {"x": np.full(4, i, dtype=np.float32)})
    assert run_until(runtime, lambda: responses.qsize() >= 2,
                     timeout=30.0)
    assert [entry["compile"] for entry in seen] == [True, False]
    assert seen[0]["segment"] == "up+d1+d2+d3"
    assert seen[0]["elements"] == ["up", "d1", "d2", "d3"]
    post = pipeline._hooks["pipeline.process_segment_post:0"]
    assert post.count == 2
    assert [entry["event"] for entry in posts] == [StreamEvent.OKAY] * 2
    pipeline.stop()


# -- the build directory -------------------------------------------------


def test_compilation_cache_env_gated(tmp_path, monkeypatch):
    from aiko_services_tpu_torch.ops import _build
    from aiko_services_tpu_torch.pipeline import fusion as fusion_module
    monkeypatch.setattr(fusion_module, "_CACHE_DIR_CONFIGURED", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    # Absent the gate: nothing configured.
    monkeypatch.delenv("AIKO_COMPILE_CACHE_DIR", raising=False)
    assert fusion_module.setup_compilation_cache({}) is None
    # Gated on: the directory is created and the kernel builds land
    # there.
    target = tmp_path / "build_cache"
    monkeypatch.setenv("AIKO_COMPILE_CACHE_DIR", str(target))
    assert fusion_module.setup_compilation_cache({}) == str(target)
    assert target.is_dir()
    assert str(_build.BUILD_DIR) == str(target)
    # Idempotent: a second pipeline with a different parameter dir does
    # not re-point the process-global directory.
    assert fusion_module.setup_compilation_cache(
        {"compile_cache_dir": str(tmp_path / "other")}) == str(target)
    assert str(_build.BUILD_DIR) == str(target)


# -- the whole chain against the JAX package ----------------------------


def _float32_detector(module):
    config = module.DetectorConfig

    def factory(*args, **kwargs):
        return dataclasses.replace(config(*args, **kwargs), dtype="float32")
    return factory


def _chain_frames():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (576, 576, 3), dtype=np.uint8)
            for _ in range(3)]


# bench.py's bench_pipeline_fusion: 576 x 576 frames, R1 to 512 x 512,
# R2 to 640 x 640
CHAIN_SIZES = ((512, 512), (640, 640))


def _run_chain(rt, pipeline):
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    for image in _chain_frames():
        pipeline.create_frame_local(stream, {"image": image})
    assert run_until(rt, lambda: responses.qsize() >= 3, timeout=120.0)
    out = {}
    while not responses.empty():
        _, frame_id, swag, metrics, okay, diagnostic = responses.get()
        assert okay, diagnostic
        out[frame_id] = (swag, metrics)
    return out


@pytest.fixture(scope="module")
def jax_chain(tmp_path_factory):
    """The JAX package's fused ``(R1 (R2 (DET)))`` on the frames, once
    for the module (detector in float32): each frame's swag and the
    detector's weights as numpy."""
    import jax
    from aiko_services_tpu.models import detector as jax_detector
    from aiko_services_tpu.pipeline import create_pipeline as jax_create
    from aiko_services_tpu.runtime import init_process, reset_process
    from aiko_services_tpu.services.share import reset_services_cache
    from aiko_services_tpu.transport import reset_broker

    patch = pytest.MonkeyPatch()
    patch.setattr(jax_detector, "DetectorConfig",
                  _float32_detector(jax_detector))
    reset_broker()
    reset_services_cache()
    rt = init_process(transport="loopback")
    rt.initialize()
    try:
        path = _media_definition(
            tmp_path_factory.mktemp("jax"), {"transfer_guard": "disallow"},
            root="aiko_services_tpu", runtime="jax", sizes=CHAIN_SIZES,
            detector_width=8)
        pipeline = jax_create(path, runtime=rt)
        results = _run_chain(rt, pipeline)
        weights = jax.tree_util.tree_map(
            np.asarray, pipeline.graph.get_node("DET").element._params)
        pipeline.stop()
    finally:
        rt.engine.terminate()
        reset_process()
        reset_services_cache()
        reset_broker()
        patch.undo()
    return results, weights


def test_fusion_chain_matches_jax_pipeline(jax_chain, tmp_path, runtime,
                                           cpu_pool, monkeypatch):
    """bench.py's fusion chain, JAX package against port, both fused:
    the resized image within the resize twin's tolerances and the
    detector's slate within its twin's, frame by frame."""
    theirs, weights = jax_chain
    monkeypatch.setattr(port_detector, "DetectorConfig",
                        _float32_detector(port_detector))
    monkeypatch.setattr(
        port_detector, "init_params",
        lambda seed, config, device: bridge.detector_params_from_numpy(
            weights, config, device=device))
    pipeline = create_pipeline(
        _media_definition(tmp_path, {"transfer_guard": "disallow"},
                          sizes=CHAIN_SIZES, detector_width=8),
        runtime=runtime)
    ours = _run_chain(runtime, pipeline)
    assert pipeline.fusion_stats()["broken"] == 0
    pipeline.stop()
    assert sorted(ours) == sorted(theirs)
    detected = 0
    for frame_id, (swag, metrics) in ours.items():
        want, their_metrics = theirs[frame_id]
        assert metrics["fused_segments"] == their_metrics["fused_segments"]
        assert_images_close(np.asarray(swag["image"]),
                            np.asarray(want["image"]))
        assert [d["class"] for d in swag["detections"]] \
            == [d["class"] for d in want["detections"]]
        for got, expected in zip(swag["detections"], want["detections"]):
            np.testing.assert_allclose(got["box"], expected["box"],
                                       rtol=0, atol=DETECT_TOL)
            assert abs(got["score"] - expected["score"]) <= DETECT_TOL
        detected += len(swag["detections"])
    assert detected > 0
