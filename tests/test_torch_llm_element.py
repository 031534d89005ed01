"""The PyTorch port's LLM serving elements: twins of
``tests/test_llm_element.py`` on ``aiko_services_tpu_torch`` with
``device: cpu``, the port's refusals, and the parity test: the same
``(CAP (LLM))`` frames through the JAX package's ``create_pipeline`` and
the port's give the same greedy text, frame by frame.

The parity test holds what the batcher twins hold: the tiny config in
float32 (bf16 sums run in another order in the two packages), the same
weights carried from the JAX element's batcher to the port element
through numpy and ``models/bridge.py``, and every port mode held to the
JAX package's SYNCHRONOUS loop (``decode_block: 1``), because the JAX
package's pipelined and device loops race on host mirrors on the CPU
backend (ROADMAP Queue 3).  At temperature 0 every loop emits one
stream.  Each element's emitted token ids are recorded beside its text,
so a stream of ids the byte tokenizer cannot print still counts."""

import dataclasses
import json
import queue
import re

import jax
import numpy as np
import pytest
import torch

from conftest import run_until

from aiko_services_tpu_torch.elements import LLMService
from aiko_services_tpu_torch.elements import llm as port_llm
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.pipeline import DefinitionError, create_pipeline
from aiko_services_tpu_torch.services import get_service_proxy

PORT_MODULE = "aiko_services_tpu_torch.elements.llm"


def _port_runtime():
    from aiko_services_tpu_torch.transport import reset_broker
    from aiko_services_tpu_torch.runtime import init_process
    from aiko_services_tpu_torch.services.share import reset_services_cache

    reset_broker()
    reset_services_cache()
    rt = init_process(transport="loopback")
    rt.initialize()
    return rt


def _port_teardown(rt):
    from aiko_services_tpu_torch.transport import reset_broker
    from aiko_services_tpu_torch.runtime import reset_process
    from aiko_services_tpu_torch.services.share import reset_services_cache

    rt.engine.terminate()
    reset_process()
    reset_services_cache()
    reset_broker()


@pytest.fixture
def runtime():
    """Fresh isolated process runtime of the port on its in-memory
    loopback broker."""
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


def _tiny_service(runtime, max_slots=4):
    config = llama.LlamaConfig.tiny(vocab_size=512, max_seq=128)
    return LLMService(runtime=runtime, config=config,
                      max_slots=max_slots, device="cpu")


def _llm_definition(tmp_path, name, parameters, module=PORT_MODULE,
                    runtime="torch"):
    definition = {
        "version": 0, "name": name, "runtime": runtime,
        "graph": ["(llm)"],
        "elements": [{
            "name": "llm",
            "input": [{"name": "text"}],
            "output": [{"name": "text"}],
            "parameters": parameters,
            "deploy": {"local": {"module": module,
                                 "class_name": "LLM"}}}]}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(definition))
    return str(path)


# -- twins of tests/test_llm_element.py --------------------------------------

def test_llm_service_streams_concurrent_requests(runtime):
    service = _tiny_service(runtime)
    proxy = get_service_proxy(runtime, service.topic_path)

    events = {"a": [], "b": []}
    response_topic = f"{runtime.topic_path_process}/llm_test"

    def on_reply(topic, payload):
        from aiko_services_tpu_torch.utils import parse
        command, parameters = parse(payload)
        events[parameters[0]].append((command, parameters))

    runtime.add_message_handler(on_reply, response_topic)
    proxy.generate(response_topic, "a", "hello", 8, 0)
    proxy.generate(response_topic, "b", "world", 8, 0)

    assert run_until(
        runtime,
        lambda: any(c == "complete" for c, _ in events["a"])
        and any(c == "complete" for c, _ in events["b"]),
        timeout=30.0)
    # Streaming: token fragments preceded completion for both requests.
    for rid in ("a", "b"):
        commands = [c for c, _ in events[rid]]
        assert commands.count("token") >= 1
        assert commands[-1] == "complete"
    # Both decoded together through the shared batcher.
    assert service.batcher.tokens_emitted >= 16
    assert service.share["tokens_emitted"] >= 16


def test_llm_service_generate_local_deterministic(runtime):
    service = _tiny_service(runtime)
    first = service.generate_local("abc", max_new_tokens=6)
    second = service.generate_local("abc", max_new_tokens=6)
    assert first == second            # greedy decoding is deterministic


def test_llm_pipeline_element(runtime, tmp_path):
    path = _llm_definition(tmp_path, "llm_pipe",
                           {"max_new_tokens": 4, "max_seq": 64,
                            "device": "cpu"})
    responses = queue.Queue()
    pipeline = create_pipeline(path, runtime=runtime)
    stream = pipeline.create_stream_local("1", queue_response=responses)
    pipeline.create_frame_local(stream, {"text": "hi"})

    assert run_until(runtime, lambda: not responses.empty(), timeout=60.0)
    stream_id, frame_id, swag, metrics, okay, diagnostic = responses.get()
    assert okay, diagnostic
    assert isinstance(swag["text"], str)
    pipeline.stop()
    pipeline.graph.get_node("llm").element.close()


def test_llm_element_max_slots_parameter(runtime, tmp_path):
    """``max_slots`` sizes the element's device batch; requests beyond
    it queue and still all complete."""
    path = _llm_definition(tmp_path, "llm_slots",
                           {"max_new_tokens": 4, "max_seq": 64,
                            "max_slots": 3, "device": "cpu"})
    responses = queue.Queue()
    pipeline = create_pipeline(path, runtime=runtime)
    stream = pipeline.create_stream_local("1", queue_response=responses)
    for i in range(5):                         # 5 requests, 3 slots
        pipeline.create_frame_local(stream, {"text": f"hi {i}"})
    assert run_until(runtime, lambda: responses.qsize() >= 5,
                     timeout=120.0)
    while not responses.empty():
        *_, okay, diagnostic = responses.get()
        assert okay, diagnostic
    element = pipeline.graph.get_node("llm").element
    assert element._batcher.max_slots == 3
    pipeline.stop()
    element.close()
    assert element._batcher is None


def test_llm_element_quantize_int8(runtime, tmp_path):
    """``quantize: int8`` serves the port's ``quantize_params`` tree
    (models/quant.py) through the element; a typo is refused."""
    path = _llm_definition(tmp_path, "llm_int8",
                           {"max_new_tokens": 4, "max_seq": 64,
                            "quantize": "int8", "device": "cpu"})
    responses = queue.Queue()
    pipeline = create_pipeline(path, runtime=runtime)
    stream = pipeline.create_stream_local("1", queue_response=responses)
    pipeline.create_frame_local(stream, {"text": "hi"})
    assert run_until(runtime, lambda: not responses.empty(), timeout=60.0)
    *_, okay, diagnostic = responses.get()
    assert okay, diagnostic
    element = pipeline.graph.get_node("llm").element
    assert set(element._batcher.params["unembed"]) == {"int8", "scale"}
    pipeline.stop()
    element.close()


# -- the port's refusals ------------------------------------------------------

def _first_response(runtime, path):
    responses = queue.Queue()
    pipeline = create_pipeline(path, runtime=runtime)
    stream = pipeline.create_stream_local("1", queue_response=responses)
    pipeline.create_frame_local(stream, {"text": "hi"})
    assert run_until(runtime, lambda: not responses.empty(), timeout=60.0)
    *_, okay, diagnostic = responses.get()
    pipeline.stop()
    pipeline.graph.get_node("llm").element.close()
    return okay, diagnostic


@pytest.mark.parametrize("parameters, message", [
    ({"checkpoint": "weights/orbax"},
     "no checkpoint directory weights/orbax"),
    ({"tokenizer": "weights/hf"}, "tokenizer 'weights/hf' does not exist"),
    ({"model": "tiny-moe"}, "mixture-of-experts.*not ported"),
    ({"quantize": "int4"}, "quantize='int4'"),
], ids=["checkpoint", "tokenizer", "tiny-moe", "quantize-typo"])
def test_llm_unported_options_fail_the_frame(runtime, tmp_path, parameters,
                                              message):
    """An option of the JAX package the port cannot serve yet, or a
    malformed one (a checkpoint or tokenizer path that does not exist),
    fails the frame that would use it; none is ignored (a tokenizer path
    never turns into the byte tokenizer, a checkpoint path never into
    random weights)."""
    path = _llm_definition(tmp_path, "llm_refuse",
                           {"max_new_tokens": 2, "max_seq": 64,
                            "device": "cpu", **parameters})
    okay, diagnostic = _first_response(runtime, path)
    assert not okay
    assert re.search(message, diagnostic), diagnostic


def test_llm_without_card_or_device_cpu_fails(runtime, tmp_path,
                                              monkeypatch):
    """The port's device rule: with no card and no ``device: cpu`` the
    element serves nothing (no silent CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _llm_definition(tmp_path, "llm_nocard",
                           {"max_new_tokens": 2, "max_seq": 64})
    okay, diagnostic = _first_response(runtime, path)
    assert not okay and "no CUDA device" in diagnostic
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMService(runtime=runtime,
                   config=llama.LlamaConfig.tiny(vocab_size=512,
                                                 max_seq=64))


def test_llm_definition_runtime_jax_rejected(runtime, tmp_path):
    path = _llm_definition(tmp_path, "llm_jax", {"device": "cpu"},
                           runtime="jax")
    with pytest.raises(DefinitionError, match="torch"):
        create_pipeline(path, runtime=runtime)


# -- parity: the JAX package's (CAP (LLM)) against the port's ----------------

SYSTEM_PROMPT = "You caption traffic-camera frames. "
DETECTIONS = [
    [{"class": "car"}, {"class": "car"}, {"class": "person"}],
    [],
    [{"class": "dog"}],
    [{"class": "truck"}, {"class": "bicycle"}, {"class": "person"},
     {"class": "person"}, {"class": "person"}],
    [{"class": "cat"}, {"class": "dog"}],
    [{"class": "bus"}] * 4,
]
LLM_PARAMETERS = {"max_new_tokens": 8, "max_seq": 128, "max_slots": 4,
                  "temperature": 0, "system_prompt": SYSTEM_PROMPT,
                  "attention": "flash"}
PORT_MODES = {
    "decode_block_1": {"decode_block": 1},
    "decode_block_4": {"decode_block": 4},
    "decode_block_tokens_8": {"decode_block_tokens": 8},
    "kv_page_tokens_16": {"kv_page_tokens": 16},
}


def _cap_llm_definition(tmp_path, module_root, runtime, parameters):
    module = f"{module_root}.elements.llm"
    definition = {
        "version": 0, "name": f"cap_llm_{runtime}", "runtime": runtime,
        "graph": ["(CAP (LLM))"],
        "elements": [
            {"name": "CAP", "input": [{"name": "detections"}],
             "output": [{"name": "text"}],
             "deploy": {"local": {"module": module,
                                  "class_name": "DetectionCaption"}}},
            {"name": "LLM", "input": [{"name": "text"}],
             "output": [{"name": "text"}], "parameters": parameters,
             "deploy": {"local": {"module": module,
                                  "class_name": "LLM"}}}]}
    path = tmp_path / f"cap_llm_{runtime}.json"
    path.write_text(json.dumps(definition))
    return str(path)


def _float32_tiny(module):
    tiny = module.LlamaConfig.tiny

    def factory(*args, **kwargs):
        return dataclasses.replace(tiny(*args, **kwargs), dtype="float32")
    return factory


def _recording_collector(module, record: dict):
    """The element module's ``_collector``, also recording each
    request's emitted ids (EOS included) by request id."""
    collector = module._collector

    def factory(tokenizer, collected):
        inner = collector(tokenizer, collected)

        def emit(request_id, token, finished):
            record.setdefault(request_id, []).append(int(token))
            inner(request_id, token, finished)
        return emit
    return factory


def _run_frames(rt, path, create):
    """Push every DETECTIONS frame through one stream; returns
    (frame id -> text, the LLM element)."""
    responses = queue.Queue()
    pipeline = create(path, runtime=rt)
    stream = pipeline.create_stream_local("1", queue_response=responses)
    for detections in DETECTIONS:
        pipeline.create_frame_local(stream, {"detections": detections})
    assert run_until(rt, lambda: responses.qsize() >= len(DETECTIONS),
                     timeout=120.0)
    texts = {}
    while not responses.empty():
        _, frame_id, swag, _, okay, diagnostic = responses.get()
        assert okay, diagnostic
        texts[frame_id] = swag["text"]
    return pipeline, texts


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """The JAX package's pipeline on the frames, once for the module:
    its texts, its emitted ids, and its element's weights as numpy."""
    from aiko_services_tpu.elements import llm as jax_llm
    from aiko_services_tpu.models import llama as jax_llama
    from aiko_services_tpu.pipeline import create_pipeline as jax_create
    from aiko_services_tpu.runtime import init_process, reset_process
    from aiko_services_tpu.services.share import reset_services_cache
    from aiko_services_tpu.transport import reset_broker

    patch = pytest.MonkeyPatch()
    tokens: dict = {}
    patch.setattr(jax_llama.LlamaConfig, "tiny", _float32_tiny(jax_llama))
    patch.setattr(jax_llm, "_collector",
                  _recording_collector(jax_llm, tokens))
    reset_broker()
    reset_services_cache()
    rt = init_process(transport="loopback")
    rt.initialize()
    try:
        path = _cap_llm_definition(
            tmp_path_factory.mktemp("jax"), "aiko_services_tpu", "jax",
            dict(LLM_PARAMETERS, decode_block=1))
        pipeline, texts = _run_frames(rt, path, jax_create)
        element = pipeline.graph.get_node("LLM").element
        weights = jax.tree_util.tree_map(np.asarray,
                                         element._batcher.params)
        pipeline.stop()
    finally:
        rt.engine.terminate()
        reset_process()
        reset_services_cache()
        reset_broker()
        patch.undo()
    return texts, tokens, weights


@pytest.mark.parametrize("mode", sorted(PORT_MODES))
def test_cap_llm_matches_jax_pipeline(mode, jax_reference, tmp_path,
                                      monkeypatch):
    theirs, their_tokens, weights = jax_reference
    ours_tokens: dict = {}
    monkeypatch.setattr(llama.LlamaConfig, "tiny", _float32_tiny(llama))
    monkeypatch.setattr(port_llm, "_collector",
                        _recording_collector(port_llm, ours_tokens))
    monkeypatch.setattr(
        port_llm.llama, "init_params",
        lambda seed, config, device: bridge.params_from_numpy(
            weights, config, device=device))
    rt = _port_runtime()
    try:
        path = _cap_llm_definition(
            tmp_path, "aiko_services_tpu_torch", "torch",
            dict(LLM_PARAMETERS, device="cpu", **PORT_MODES[mode]))
        pipeline, ours = _run_frames(rt, path, create_pipeline)
        element = pipeline.graph.get_node("LLM").element
        batcher = element._batcher
        pipeline.stop()
        element.close()
    finally:
        _port_teardown(rt)
    assert len(ours) == len(DETECTIONS)
    assert ours == theirs
    assert ours_tokens == their_tokens
    assert all(len(ids) == LLM_PARAMETERS["max_new_tokens"]
               or ids[-1] == 258 for ids in ours_tokens.values())
    if mode == "kv_page_tokens_16":
        assert batcher._pages.leaked_pages() == 0
    if mode == "decode_block_tokens_8":
        ledger = pipeline.transfer_ledger
        assert ledger.explicit_by_label["llm_block"] \
            == batcher.blocks_retired > 0
