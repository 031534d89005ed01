"""The port's ``ImageResize`` on its async path: the twin of
``tests/test_overlap.py``'s ``test_resize_microbatches_across_streams``
-- frames parked from two streams resize as ONE batched dispatch, each
row equal to the synchronous path and still a tensor on the element's
device (``device: cpu`` here)."""

import json
import queue

import numpy as np
import pytest
import torch

from conftest import run_until
from test_torch_llm_element import _port_runtime, _port_teardown

from aiko_services_tpu_torch.pipeline import create_pipeline


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


def _media_definition(tmp_path, name, cls, module, inputs, outputs,
                      params):
    body = {
        "version": 0, "name": f"mb_{name}", "runtime": "torch",
        "graph": [f"({name})"], "parameters": {},
        "elements": [{
            "name": name,
            "input": [{"name": n} for n in inputs],
            "output": [{"name": n} for n in outputs],
            "parameters": params,
            "deploy": {"local": {"module": module, "class_name": cls}}}]}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(body))
    return str(path)


@pytest.mark.parametrize("shape", [(32, 32, 3), (32, 32)])
def test_resize_microbatches_across_streams(tmp_path, runtime, shape):
    """Frames parked at ImageResize from TWO streams resize as ONE
    batched dispatch, each getting its own row -- identical to the
    blocking path -- and the rows stay tensors (device-resident).  The
    grayscale case batches as [N, H, W, 1] and drops the channel on
    the way out."""
    definition = _media_definition(
        tmp_path, "resize", "ImageResize",
        "aiko_services_tpu_torch.elements.image", ["image"], ["image"],
        {"width": 16, "height": 16, "device": "cpu"})
    pipeline = create_pipeline(definition, runtime=runtime)
    rng = np.random.default_rng(0)
    images = {f"s{i}": rng.integers(0, 255, shape).astype(np.uint8)
              for i in range(2)}
    queues = {}
    for stream_id, image in images.items():
        queues[stream_id] = queue.Queue()
        stream = pipeline.create_stream_local(
            stream_id, queue_response=queues[stream_id])
        pipeline.create_frame_local(stream, {"image": image})
    assert run_until(runtime,
                     lambda: all(not q.empty() for q in queues.values()),
                     timeout=30.0)
    element = pipeline.graph.get_node("resize").element
    assert element._batcher.dispatches == 1, (
        f"{element._batcher.dispatches} dispatches for 2 frames: "
        f"not cross-stream batched")
    for stream_id, image in images.items():
        _, _, swag, _, okay, diagnostic = queues[stream_id].get()
        assert okay, diagnostic
        resized = swag["image"]
        assert isinstance(resized, torch.Tensor)    # device-resident
        assert resized.shape == (16, 16) + shape[2:]
        pipeline._current_stream_ref = pipeline.streams[stream_id]
        _, sync_out = element.process_frame(None, image=image)
        pipeline._current_stream_ref = None
        np.testing.assert_array_equal(resized.numpy(),
                                      sync_out["image"].numpy())
    pipeline.stop()
