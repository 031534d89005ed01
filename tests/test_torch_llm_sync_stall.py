"""A ``synchronous: true`` frame at the port's ``LLM`` element while the
async worker is draining other streams' requests: the frame waits for
at most one of the worker's ticks, then steps the shared batcher itself
until its own request finishes -- it never waits for the worker's whole
drain.  The async frames still complete, each with the text the batcher
gives its request served directly (float32 tiny model, greedy, on the
CPU)."""

import json
import queue
import threading
import time

import pytest

from conftest import run_until
from test_torch_llm_element import (_float32_tiny, _port_runtime,
                                    _port_teardown)

from aiko_services_tpu_torch.models import batching, llama
from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer
from aiko_services_tpu_torch.pipeline import create_pipeline

ASYNC_TOKENS = 160
SYNC_TOKENS = 4
# The worker's ticks are slowed by this much, so the async drain lasts
# seconds and the synchronous frame surely arrives while it runs.
WORKER_TICK_S = 0.005
ASYNC_PROMPTS = ("the quick brown fox", "jumps over", "the lazy dog")
# Ticks the synchronous frame may see: one admission/prefill tick, one
# tick a token, and one tick of the worker that held the lock when the
# frame arrived (with slack for the worker's tick racing the first
# acquisition).
SYNC_TICK_BOUND = SYNC_TOKENS + 4


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


def _definition(tmp_path):
    body = {
        "version": 0, "name": "llm_sync_stall", "runtime": "torch",
        "graph": ["(LLM)"],
        "elements": [{
            "name": "LLM",
            "input": [{"name": "text"}],
            "output": [{"name": "text"}],
            "parameters": {"max_new_tokens": ASYNC_TOKENS, "max_seq": 256,
                           "device": "cpu"},
            "deploy": {"local": {
                "module": "aiko_services_tpu_torch.elements.llm",
                "class_name": "LLM"}}}]}
    path = tmp_path / "llm_sync_stall.json"
    path.write_text(json.dumps(body))
    return str(path)


def _direct(batcher, prompt, max_new_tokens):
    """The text the batcher gives ``prompt`` served alone."""
    tokenizer = ByteTokenizer()
    fresh = batching.ContinuousBatcher(batcher.params, batcher.config,
                                       max_slots=8, device="cpu")
    emitted = []
    fresh.submit(batching.Request(
        request_id="direct", prompt_tokens=tokenizer.encode(prompt),
        max_new_tokens=max_new_tokens, temperature=0.0,
        eos_tokens=tokenizer.eos_tokens,
        emit=lambda request_id, token, finished: emitted.append(token)))
    fresh.run_until_drained()
    return tokenizer.decode([token for token in emitted
                             if token not in tokenizer.eos_tokens])


def test_sync_frame_waits_one_tick_not_the_drain(tmp_path, runtime,
                                                 monkeypatch):
    monkeypatch.setattr(llama.LlamaConfig, "tiny", _float32_tiny(llama))
    ticks = {"count": 0}
    lock = threading.Lock()
    step = batching.ContinuousBatcher.step

    def counted_step(self):
        with lock:
            ticks["count"] += 1
        if threading.current_thread().name.startswith("llm-worker"):
            time.sleep(WORKER_TICK_S)
        return step(self)
    monkeypatch.setattr(batching.ContinuousBatcher, "step", counted_step)

    pipeline = create_pipeline(_definition(tmp_path), runtime=runtime)
    element = pipeline.graph.get_node("LLM").element
    seen = {}
    process_frame = element.process_frame

    def timed_process_frame(stream, **inputs):
        with lock:
            seen["start"] = ticks["count"]
        result = process_frame(stream, **inputs)
        with lock:
            seen["ticks"] = ticks["count"] - seen["start"]
        seen["async_live"] = element._batcher.active_count
        return result
    monkeypatch.setattr(element, "process_frame", timed_process_frame)

    async_responses = queue.Queue()
    async_stream = pipeline.create_stream_local(
        "async", queue_response=async_responses)
    for prompt in ASYNC_PROMPTS:
        pipeline.create_frame_local(async_stream, {"text": prompt})
    # The worker is draining: the model is built and tokens flow.
    assert run_until(runtime, lambda: element._batcher is not None
                     and element._batcher.tokens_emitted
                     >= len(ASYNC_PROMPTS), timeout=60.0)

    sync_responses = queue.Queue()
    sync_stream = pipeline.create_stream_local(
        "sync", {"synchronous": True, "max_new_tokens": SYNC_TOKENS},
        queue_response=sync_responses)
    pipeline.create_frame_local(sync_stream, {"text": "hello"})
    assert run_until(runtime, lambda: not sync_responses.empty(),
                     timeout=60.0)
    *_, swag, _, okay, diagnostic = sync_responses.get()
    assert okay, diagnostic
    # A few ticks, while the async requests were still decoding: the
    # frame did not wait for their drain.
    assert seen["ticks"] <= SYNC_TICK_BOUND, seen
    assert seen["async_live"] > 0, seen
    assert async_responses.empty()
    sync_text = swag["text"]

    assert run_until(runtime,
                     lambda: async_responses.qsize() >= len(ASYNC_PROMPTS),
                     timeout=120.0)
    texts = []
    while not async_responses.empty():
        *_, swag, _, okay, diagnostic = async_responses.get()
        assert okay, diagnostic
        texts.append(swag["text"])
    batcher = element._batcher
    monkeypatch.setattr(batching.ContinuousBatcher, "step", step)
    assert sorted(texts) == sorted(
        _direct(batcher, prompt, ASYNC_TOKENS) for prompt in ASYNC_PROMPTS)
    assert sync_text == _direct(batcher, "hello", SYNC_TOKENS)
    pipeline.stop()
    element.close()


def test_sync_frame_alone_drains_its_blocks(tmp_path, runtime,
                                            monkeypatch):
    """With no worker at all (every frame synchronous, pipelined decode
    blocks in flight), a frame leaves nothing in flight behind it."""
    monkeypatch.setattr(llama.LlamaConfig, "tiny", _float32_tiny(llama))
    pipeline = create_pipeline(_definition(tmp_path), runtime=runtime)
    element = pipeline.graph.get_node("LLM").element
    responses = queue.Queue()
    stream = pipeline.create_stream_local(
        "sync", {"synchronous": True, "max_new_tokens": SYNC_TOKENS,
                 "decode_block": 4, "inflight": 2},
        queue_response=responses)
    for prompt in ("one", "two"):
        pipeline.create_frame_local(stream, {"text": prompt})
    assert run_until(runtime, lambda: responses.qsize() >= 2, timeout=60.0)
    while not responses.empty():
        *_, okay, diagnostic = responses.get()
        assert okay, diagnostic
    assert element._work is None                # no worker was started
    assert element._batcher.blocks_in_flight == 0
    assert element._batcher.active_count == 0
    pipeline.stop()
    element.close()
