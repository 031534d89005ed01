"""BASELINE config 4 in the port: twin of ``tests/test_config4_composed.py``
-- detect -> caption -> LLM through the port's ``create_pipeline`` with
placement blocks and async stages, the detector on a dp-4 group and the
LLM on the other four devices as tp 4 of the eight-CPU device pool
(``torch_pipeline_elements.cpu_pool``) -- and its parity with the JAX
package's config 4: the same frames give the same detections (classes
exactly, boxes and scores within 1e-4) and the same greedy text and
token ids, frame by frame.

The parity case holds what the LLM parity test holds
(``tests/test_torch_llm_element.py``): float32 on both sides (the tiny
LLM and the detector), the JAX package's weights carried to the port
through numpy and ``models/bridge.py``, and the JAX LLM at
``decode_block: 1`` (its pipelined and device loops race on host mirrors
on the CPU backend, ROADMAP Queue 3); the port's LLM runs its default
loop."""

import dataclasses
import json
import queue

import jax
import numpy as np
import pytest

from conftest import run_until
from test_torch_llm_element import (_float32_tiny, _port_runtime,
                                    _port_teardown, _recording_collector)
from torch_pipeline_elements import cpu_pool  # noqa: F401

from aiko_services_tpu_torch.elements import llm as port_llm
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import detector as port_detector
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.pipeline import create_pipeline

N_FRAMES = 8
MAX_NEW = 8


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


def _definition(tmp_path, root="aiko_services_tpu_torch", runtime="torch",
                llm=None):
    llm = {"max_new_tokens": MAX_NEW, "max_seq": 64, **(llm or {})}
    definition = {
        "version": 0, "name": "config4", "runtime": runtime,
        "graph": ["(DET (CAP (LLM)))"],
        "elements": [
            {"name": "DET",
             "input": [{"name": "image"}],
             "output": [{"name": "image"}, {"name": "overlay"},
                        {"name": "detections"}],
             "parameters": {"width": 4, "max_batch": 8},
             "placement": {"mesh": {"dp": 4}},
             "deploy": {"local": {
                 "module": f"{root}.elements.detect",
                 "class_name": "Detector"}}},
            {"name": "CAP",
             "input": [{"name": "detections"}],
             "output": [{"name": "text"}],
             "deploy": {"local": {
                 "module": f"{root}.elements.llm",
                 "class_name": "DetectionCaption"}}},
            {"name": "LLM",
             "input": [{"name": "text"}],
             "output": [{"name": "text"}],
             "parameters": llm,
             "placement": {"mesh": {"tp": 4}},
             "deploy": {"local": {
                 "module": f"{root}.elements.llm",
                 "class_name": "LLM"}}},
        ]}
    path = tmp_path / f"config4_{runtime}.json"
    path.write_text(json.dumps(definition))
    return str(path)


def _frames():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
            for _ in range(N_FRAMES)]


def _run(rt, pipeline):
    """Every frame through one stream; frame id -> (swag, metrics)."""
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    for image in _frames():
        pipeline.create_frame_local(stream, {"image": image})
    assert run_until(rt, lambda: responses.qsize() >= N_FRAMES,
                     timeout=300.0)
    out = {}
    while not responses.empty():
        _, frame_id, swag, metrics, okay, diagnostic = responses.get()
        assert okay, diagnostic
        out[frame_id] = (swag, metrics)
    assert len(out) == N_FRAMES
    return out


def test_config4_placed_async_composition(tmp_path, runtime, cpu_pool):
    """detect on a 4-device dp group, LLM on the OTHER 4 devices as
    tp=4, async stages on both ends: every frame completes, detect
    micro-batches the parked burst into fewer device dispatches, and
    the LLM decodes requests from many in-flight frames together --
    frames overlapped at both model stages."""
    pipeline = create_pipeline(
        _definition(tmp_path, llm={"device": "cpu"}), runtime=runtime)

    # -- placement: disjoint groups straight from the definition --------
    placement = pipeline.stage_placement
    assert placement is not None
    assert dict(placement.plan("DET").mesh.shape) == {"dp": 4}
    assert dict(placement.plan("LLM").mesh.shape) == {"tp": 4}
    det_devices = set(placement.plan("DET").mesh.devices.flat)
    llm_devices = set(placement.plan("LLM").mesh.devices.flat)
    assert not det_devices & llm_devices

    results = _run(runtime, pipeline)
    for swag, metrics in results.values():
        assert isinstance(swag["text"], str)
        assert "DET_time" in metrics and "LLM_time" in metrics

    # -- placement transfer: the detect element resolved ITS stage's
    # group (not the local default) and its weights live there.
    det = pipeline.graph.get_node("DET").element
    assert dict(det.plan.mesh.shape) == {"dp": 4}
    assert det.plan.device in det_devices
    leaves = jax.tree_util.tree_leaves(det._params)
    assert leaves and all(leaf.device.type == det.plan.device.type
                          for leaf in leaves)

    # -- async composition, detect side: the parked burst ran as
    # MICRO-BATCHED dispatches, not one dispatch per frame.
    dispatches = det.jit_cache.hits + det.jit_cache.misses
    assert dispatches < N_FRAMES, (
        f"{dispatches} detect dispatches for {N_FRAMES} frames: parked "
        "frames were not micro-batched")

    # -- async composition, LLM side: requests from many in-flight
    # frames decoded together (total decode steps far below the
    # serialized sum) -- frames overlapped across the placed stages.
    element = pipeline.graph.get_node("LLM").element
    batcher = element._batcher
    serialized = N_FRAMES * MAX_NEW
    assert batcher.steps < serialized * 0.6, (
        f"{batcher.steps} decode steps for {N_FRAMES} frames x "
        f"{MAX_NEW} tokens: frames did not overlap at the LLM stage")
    assert pipeline.check_device_health() == []
    pipeline.stop()
    element.close()


def _float32_detector(module):
    config = module.DetectorConfig

    def factory(*args, **kwargs):
        return dataclasses.replace(config(*args, **kwargs), dtype="float32")
    return factory


@pytest.fixture(scope="module")
def jax_config4(tmp_path_factory):
    """The JAX package's config 4 on the frames, once for the module:
    each frame's detections and text, the LLM's emitted ids, and both
    elements' weights as numpy."""
    from aiko_services_tpu.elements import llm as jax_llm
    from aiko_services_tpu.models import detector as jax_detector
    from aiko_services_tpu.models import llama as jax_llama
    from aiko_services_tpu.pipeline import create_pipeline as jax_create
    from aiko_services_tpu.runtime import init_process, reset_process
    from aiko_services_tpu.services.share import reset_services_cache
    from aiko_services_tpu.transport import reset_broker

    patch = pytest.MonkeyPatch()
    tokens: dict = {}
    patch.setattr(jax_llama.LlamaConfig, "tiny", _float32_tiny(jax_llama))
    patch.setattr(jax_detector, "DetectorConfig",
                  _float32_detector(jax_detector))
    patch.setattr(jax_llm, "_collector",
                  _recording_collector(jax_llm, tokens))
    reset_broker()
    reset_services_cache()
    rt = init_process(transport="loopback")
    rt.initialize()
    try:
        path = _definition(tmp_path_factory.mktemp("jax"),
                           root="aiko_services_tpu", runtime="jax",
                           llm={"decode_block": 1})
        pipeline = jax_create(path, runtime=rt)
        results = _run(rt, pipeline)
        weights = {
            name: jax.tree_util.tree_map(np.asarray, tree)
            for name, tree in (
                ("det", pipeline.graph.get_node("DET").element._params),
                ("llm", pipeline.graph.get_node("LLM").element
                 ._batcher.params))}
        pipeline.stop()
    finally:
        rt.engine.terminate()
        reset_process()
        reset_services_cache()
        reset_broker()
        patch.undo()
    return ({frame_id: swag for frame_id, (swag, _) in results.items()},
            tokens, weights)


def test_config4_matches_jax_pipeline(jax_config4, tmp_path, runtime,
                                      cpu_pool, monkeypatch):
    theirs, their_tokens, weights = jax_config4
    ours_tokens: dict = {}
    monkeypatch.setattr(llama.LlamaConfig, "tiny", _float32_tiny(llama))
    monkeypatch.setattr(port_detector, "DetectorConfig",
                        _float32_detector(port_detector))
    monkeypatch.setattr(port_llm, "_collector",
                        _recording_collector(port_llm, ours_tokens))
    monkeypatch.setattr(
        port_llm.llama, "init_params",
        lambda seed, config, device: bridge.params_from_numpy(
            weights["llm"], config, device=device))
    monkeypatch.setattr(
        port_detector, "init_params",
        lambda seed, config, device: bridge.detector_params_from_numpy(
            weights["det"], config, device=device))
    pipeline = create_pipeline(
        _definition(tmp_path, llm={"device": "cpu"}), runtime=runtime)
    results = _run(runtime, pipeline)
    element = pipeline.graph.get_node("LLM").element
    pipeline.stop()
    element.close()

    assert sorted(results) == sorted(theirs)
    detected = 0
    for frame_id, (swag, _) in results.items():
        want = theirs[frame_id]
        assert [d["class"] for d in swag["detections"]] \
            == [d["class"] for d in want["detections"]]
        for got, expected in zip(swag["detections"], want["detections"]):
            np.testing.assert_allclose(got["box"], expected["box"],
                                       rtol=0, atol=1e-4)
            assert abs(got["score"] - expected["score"]) <= 1e-4
        detected += len(swag["detections"])
        assert swag["CAP.text"] == want["CAP.text"]
        assert swag["text"] == want["text"]
    assert detected > 0
    assert ours_tokens == their_tokens
    assert len(ours_tokens) == N_FRAMES
