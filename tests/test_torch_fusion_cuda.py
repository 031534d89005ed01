"""The port's fused segments on the card: bench.py's ``(R1 (R2 (DET)))``
chain captured as ONE CUDA graph and replayed for every later frame,
bitwise equal to ``fuse: off``, and a capture that meets a host read
poisoning the segment.  Imports no JAX, so it runs on the card machine:

    python3 -m pytest --noconftest -q tests/test_torch_fusion_cuda.py

Without a card every test here skips."""

import json
import queue

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.pipeline import (DeviceFn, PipelineElement,
                                              StreamEvent, create_pipeline)

FRAMES = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graph capture has no CPU mode)")
    return torch.device("cuda", 0)


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


def _chain(tmp_path, mode):
    elements = [
        {"name": name, "input": [{"name": "image"}],
         "output": [{"name": "image"}],
         "parameters": {"width": size, "height": size,
                        "synchronous": True},
         "deploy": {"local": {
             "module": "aiko_services_tpu_torch.elements.image",
             "class_name": "ImageResize"}}}
        for name, size in (("R1", 512), ("R2", 640))]
    elements.append(
        {"name": "DET", "input": [{"name": "image"}],
         "output": [{"name": "image"}, {"name": "overlay"},
                    {"name": "detections"}],
         "parameters": {"synchronous": True},
         "deploy": {"local": {
             "module": "aiko_services_tpu_torch.elements.detect",
             "class_name": "Detector"}}})
    body = {"version": 0, "name": f"fusion_{mode}", "runtime": "torch",
            "graph": ["(R1 (R2 (DET)))"],
            "parameters": {"transfer_guard": "disallow",
                           "device_inflight": 3, "fuse": mode},
            "elements": elements}
    path = tmp_path / f"fusion_{mode}.json"
    path.write_text(json.dumps(body))
    return str(path)


def _run(runtime, pipeline, frames):
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    for frame in frames:
        pipeline.create_frame_local(stream, frame)
    runtime.run(until=lambda: responses.qsize() >= len(frames),
                timeout=300.0)
    out = {}
    while not responses.empty():
        _, frame_id, swag, metrics, okay, diagnostic = responses.get()
        assert okay, diagnostic
        out[frame_id] = (swag, metrics)
    assert len(out) == len(frames)
    return out


@pytest.mark.cuda
def test_fused_chain_is_one_graph_and_equals_unfused(cuda_device, runtime,
                                                     tmp_path):
    rng = np.random.default_rng(0)
    frames = [{"image": rng.integers(0, 256, (576, 576, 3),
                                     dtype=np.uint8)}
              for _ in range(FRAMES)]
    fused = create_pipeline(_chain(tmp_path, "auto"), runtime=runtime)
    ours = _run(runtime, fused, frames)
    stats = fused.fusion_stats()
    assert stats["segments"] == 1 and stats["broken"] == 0
    segment = fused.fused_segments[0]
    assert segment.device == cuda_device
    assert segment.jit_cache.stats["misses"] == 1
    assert segment.jit_cache.stats["hits"] == FRAMES - 1
    assert segment.jit_cache.capture_s > 0
    assert fused.transfer_stats()["explicit"] == FRAMES
    assert fused.transfer_stats()["implicit"] == 0
    fused.stop()

    unfused = create_pipeline(_chain(tmp_path, "off"), runtime=runtime)
    theirs = _run(runtime, unfused, frames)
    unfused.stop()
    for frame_id, (swag, metrics) in ours.items():
        assert metrics["device_dispatches"] == 1
        assert metrics["fused_segments"] == 1
        want, want_metrics = theirs[frame_id]
        assert want_metrics["device_dispatches"] == 3
        assert swag["image"].device == cuda_device
        assert torch.equal(swag["image"], want["image"])
        assert swag["image"].shape == (640, 640, 3)
        assert swag["detections"] == want["detections"]
        assert swag["overlay"] == want["overlay"]


class DeviceScale(PipelineElement):
    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": torch.as_tensor(x).cuda() * 2}

    def device_fn(self, stream):
        return DeviceFn(fn=lambda x: {"x": x * 2},
                        inputs=("x",), outputs=("x",))


class HostRead(PipelineElement):
    """Reads a device value on the host inside its device_fn: the
    segment's capture refuses it."""

    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": x + 1}

    def device_fn(self, stream):
        return DeviceFn(fn=lambda x: {"x": x + float(x.sum().item())},
                        inputs=("x",), outputs=("x",))


@pytest.mark.cuda
def test_host_read_in_a_segment_poisons_it(cuda_device, runtime,
                                           tmp_path):
    body = {"version": 0, "name": "poison", "runtime": "torch",
            "graph": ["(a b)"], "parameters": {},
            "elements": [
                {"name": name, "input": [{"name": "x"}],
                 "output": [{"name": "x"}], "parameters": {},
                 "deploy": {"local": {"module": "test_torch_fusion_cuda",
                                      "class_name": cls}}}
                for name, cls in (("a", "DeviceScale"), ("b", "HostRead"))]}
    path = tmp_path / "poison.json"
    path.write_text(json.dumps(body))
    pipeline = create_pipeline(str(path), runtime=runtime)
    value = np.arange(4, dtype=np.float32)
    out = _run(runtime, pipeline, [{"x": value}, {"x": value}])
    assert pipeline.fusion_stats()["broken"] == 1
    for swag, metrics in out.values():
        assert "fused_segments" not in metrics
        np.testing.assert_array_equal(swag["x"].cpu().numpy(), value * 2 + 1)
    pipeline.stop()
