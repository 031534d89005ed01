"""Async local stages in the port: twins of the ``Detector`` and ``LLM``
cases of ``tests/test_async_stages.py`` and of
``tests/test_overlap.py``'s mixed-dtype detector burst, on the port's
``create_pipeline`` with the eight-CPU device pool
(``torch_pipeline_elements.cpu_pool``) and the ``LLM`` element's
``device: cpu``.  The detector parks its frames in the MicroBatcher and
runs each burst as one batched dispatch on the batcher's worker."""

import json
import queue

import numpy as np
import pytest

from conftest import run_until
from torch_pipeline_elements import cpu_pool  # noqa: F401

from aiko_services_tpu_torch.pipeline import StreamEvent, create_pipeline

DETECT = "aiko_services_tpu_torch.elements.detect"


@pytest.fixture
def runtime():
    """Fresh isolated process runtime of the port on its in-memory
    loopback broker."""
    from aiko_services_tpu_torch.transport import reset_broker
    from aiko_services_tpu_torch.runtime import init_process, reset_process
    from aiko_services_tpu_torch.services.share import reset_services_cache

    reset_broker()
    reset_services_cache()
    rt = init_process(transport="loopback")
    rt.initialize()
    yield rt
    rt.engine.terminate()
    reset_process()
    reset_services_cache()
    reset_broker()


def _definition(tmp_path, name, cls, module, inputs, outputs, params):
    body = {
        "version": 0, "name": f"async_{name}", "runtime": "torch",
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


def _detector(tmp_path, outputs=("detections", "overlay"), **params):
    return _definition(tmp_path, "detect", "Detector", DETECT, ["image"],
                       list(outputs), {"width": 4, **params})


def test_synchronous_parameter_forces_blocking_path(tmp_path, runtime,
                                                    cpu_pool):
    """``synchronous: true`` on the async-capable Detector runs the
    blocking process_frame."""
    responses = queue.Queue()
    pipeline = create_pipeline(
        _detector(tmp_path, outputs=("detections",), synchronous=True),
        runtime=runtime)
    stream = pipeline.create_stream_local("s", queue_response=responses)
    image = np.zeros((64, 64, 3), dtype=np.uint8)
    pipeline.create_frame_local(stream, {"image": image})
    assert run_until(runtime, lambda: not responses.empty(), timeout=60.0)
    _, _, swag, _, okay, diagnostic = responses.get()
    assert okay, diagnostic
    assert isinstance(swag["detections"], list)
    element = pipeline.graph.get_node("detect").element
    assert element._batcher is None             # never parked a frame
    pipeline.stop()


def test_detector_async_matches_sync(tmp_path, runtime, cpu_pool):
    """The async (parked) Detector path produces the same outputs as the
    blocking path."""
    responses = queue.Queue()
    pipeline = create_pipeline(_detector(tmp_path), runtime=runtime)
    stream = pipeline.create_stream_local("s", queue_response=responses)
    image = (np.random.default_rng(0)
             .integers(0, 255, (64, 64, 3)).astype(np.uint8))
    pipeline.create_frame_local(stream, {"image": image})
    assert run_until(runtime, lambda: not responses.empty(), timeout=60.0)
    _, _, swag, _, okay, diagnostic = responses.get()
    assert okay, diagnostic

    element = pipeline.graph.get_node("detect").element
    event, sync_out = element.process_frame(stream, image=image)
    assert event == StreamEvent.OKAY
    assert swag["detections"] == sync_out["detections"]
    assert swag["overlay"] == sync_out["overlay"]
    assert element.plan.device == cpu_pool[0]
    pipeline.stop()


def test_detector_microbatches_burst(tmp_path, runtime, cpu_pool):
    """A burst of parked frames dispatches as ONE batched detect, and
    each frame still gets ITS OWN row's outputs -- identical to the
    per-frame blocking path."""
    n_frames = 4
    responses = queue.Queue()
    pipeline = create_pipeline(_detector(tmp_path, max_batch=8),
                               runtime=runtime)
    stream = pipeline.create_stream_local("s", queue_response=responses)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
              for _ in range(n_frames)]
    for image in images:
        pipeline.create_frame_local(stream, {"image": image})
    assert run_until(runtime, lambda: responses.qsize() >= n_frames,
                     timeout=120.0)

    element = pipeline.graph.get_node("detect").element
    dispatches = element.jit_cache.hits + element.jit_cache.misses
    assert dispatches < n_frames, (
        f"{dispatches} dispatches for {n_frames} frames: not batched")

    by_frame = {}
    while not responses.empty():
        _, frame_id, swag, _, okay, diagnostic = responses.get()
        assert okay, diagnostic
        by_frame[frame_id] = swag
    assert len(by_frame) == n_frames
    for frame_id, image in enumerate(images):
        _, sync_out = element.process_frame(stream, image=image)
        assert by_frame[frame_id]["detections"] \
            == sync_out["detections"]
        assert by_frame[frame_id]["overlay"] == sync_out["overlay"]
    pipeline.stop()


def test_detector_bad_frame_errors_only_its_group(tmp_path, runtime,
                                                  cpu_pool):
    """A malformed frame in a micro-batched burst must error ITSELF
    (its shape group / its stream) while other streams' frames in the
    SAME batched burst complete: a failed dispatch must never strand
    parked frames."""
    good_responses = queue.Queue()
    bad_responses = queue.Queue()
    pipeline = create_pipeline(
        _detector(tmp_path, outputs=("detections",), max_batch=8),
        runtime=runtime)
    good_stream = pipeline.create_stream_local(
        "good", queue_response=good_responses)
    bad_stream = pipeline.create_stream_local(
        "bad", queue_response=bad_responses)
    rng = np.random.default_rng(0)
    pipeline.create_frame_local(good_stream, {
        "image": rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)})
    pipeline.create_frame_local(bad_stream, {   # no channel dim
        "image": rng.integers(0, 255, (64, 64)).astype(np.uint8)})
    pipeline.create_frame_local(good_stream, {
        "image": rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)})
    assert run_until(
        runtime,
        lambda: good_responses.qsize() >= 2 and not bad_responses.empty(),
        timeout=120.0)
    *_, okay, diagnostic = bad_responses.get()
    assert not okay and "detect" in diagnostic    # dispatch error surfaced
    while not good_responses.empty():             # burst-mates completed
        _, _, swag, _, okay, diagnostic = good_responses.get()
        assert okay, diagnostic
        assert isinstance(swag["detections"], list)
    pipeline.stop()


def test_detector_mixed_dtype_burst_normalizes_each_group(
        tmp_path, runtime, cpu_pool):
    """A uint8 frame and a float32 frame of the same shape submitted in
    one burst must EACH match their own blocking-path output: raw-dtype
    grouping keeps the /255 normalization per group."""
    pipeline = create_pipeline(
        _detector(tmp_path, outputs=("detections",)), runtime=runtime)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
    f32 = rng.random((64, 64, 3)).astype(np.float32)
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    pipeline.create_frame_local(stream, {"image": u8})
    pipeline.create_frame_local(stream, {"image": f32})
    assert run_until(runtime, lambda: responses.qsize() >= 2,
                     timeout=60.0)
    element = pipeline.graph.get_node("detect").element
    by_frame = {}
    while not responses.empty():
        _, frame_id, swag, _, okay, diagnostic = responses.get()
        assert okay, diagnostic
        by_frame[frame_id] = swag["detections"]
    for frame_id, image in enumerate((u8, f32)):
        _, sync_out = element.process_frame(stream, image=image)
        assert by_frame[frame_id] == sync_out["detections"]
    assert element._batcher.dispatches == 2     # one group per dtype
    pipeline.stop()


def test_detector_checkpoint_not_ported(tmp_path, runtime, cpu_pool):
    """A ``checkpoint`` parameter naming no checkpoint fails the frame:
    the port never runs random weights in its place."""
    responses = queue.Queue()
    pipeline = create_pipeline(
        _detector(tmp_path, outputs=("detections",), synchronous=True,
                  checkpoint="/no/such/dir"), runtime=runtime)
    stream = pipeline.create_stream_local("s", queue_response=responses)
    pipeline.create_frame_local(stream, {
        "image": np.zeros((64, 64, 3), dtype=np.uint8)})
    assert run_until(runtime, lambda: not responses.empty(), timeout=60.0)
    *_, okay, diagnostic = responses.get()
    assert not okay and "no checkpoint directory /no/such/dir" in diagnostic
    pipeline.stop()


def test_llm_batches_across_frames(tmp_path, runtime):
    """Multiple in-flight frames' requests decode TOGETHER in the shared
    batcher (continuous batching across frames, not per-frame drains):
    total decode steps stay near one request's worth, far below the
    serialized sum."""
    n_frames, max_new = 4, 12
    path = _definition(
        tmp_path, "llm", "LLM", "aiko_services_tpu_torch.elements.llm",
        ["text"], ["text"],
        {"max_new_tokens": max_new, "max_seq": 64, "device": "cpu"})
    responses = queue.Queue()
    pipeline = create_pipeline(path, runtime=runtime)
    stream = pipeline.create_stream_local("s", queue_response=responses)
    for i in range(n_frames):
        pipeline.create_frame_local(stream, {"text": f"prompt {i}"})
    assert run_until(runtime, lambda: responses.qsize() >= n_frames,
                     timeout=120.0)
    texts = []
    while not responses.empty():
        _, _, swag, _, okay, diagnostic = responses.get()
        assert okay, diagnostic
        texts.append(swag["text"])
    assert len(texts) == n_frames

    element = pipeline.graph.get_node("llm").element
    batcher = element._batcher
    serialized_steps = n_frames * max_new
    assert batcher.steps < serialized_steps * 0.6, (
        f"{batcher.steps} decode steps for {n_frames} frames x "
        f"{max_new} tokens: requests did not batch across frames")
    pipeline.stop()
    element.close()
