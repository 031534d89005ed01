"""The port's speech elements (``aiko_services_tpu_torch/elements/
speech.py``, ``text.py``): twins of ``tests/test_speech.py``'s pipelines
and ``TextFilter`` on the port with ``device: cpu``, the non-streaming
ASR against the JAX package's, and BASELINE config 5's composition --
streaming ``(ASR (GATE (LLM)))`` -- against the JAX package's frame by
frame: the same hops give the same utterance frames, the same text and
the same token ids.

The composition holds what the config-4 parity holds
(``tests/test_torch_config4.py``): float32 tiny models on both sides,
the JAX package's weights carried to the port through numpy and
``models/bridge.py`` by patching the port's ``init_params``, the JAX LLM
at ``decode_block: 1`` (its pipelined loop races on host mirrors on the
CPU backend, ROADMAP Queue 3), the port's at config 5's ``decode_block:
16``, ``inflight: 3``; both int8 (``quantize: int8``)."""

import dataclasses
import queue

import jax
import numpy as np
import pytest
import torch

from conftest import run_until
from test_torch_asr import _numpy_tree
from test_torch_llm_element import (_float32_tiny, _port_runtime,
                                    _port_teardown, _recording_collector)

from aiko_services_tpu_torch.elements import llm as port_llm
from aiko_services_tpu_torch.elements import ASR, read_wav, write_wav
from aiko_services_tpu_torch.models import asr, bridge, llama
from aiko_services_tpu_torch.pipeline import (Pipeline, PipelineElement,
                                              StreamEvent)
from aiko_services_tpu_torch.pipeline.element import ElementContext

CPU = {"device": "cpu"}
RATE = 16000
HOP = RATE // 4                 # tiny ASR: 1 s chunks, 0.25 s hops
ASR_STREAMING = {"model_size": "tiny", "streaming": True,
                 "hop_seconds": 0.25, "endpoint_silence": 0.2}
UTTERANCES = 4                  # a warm-up and three, as bench.py sends
SPEECH_HOPS = 2                 # a 0.75 s utterance stays below the chunk

SINK: list = []


class CollectText(PipelineElement):
    def process_frame(self, stream, text=None, **inputs):
        SINK.append(text)
        return StreamEvent.OKAY, {}


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


def element(name, cls, inputs, outputs, parameters=None,
            root="aiko_services_tpu_torch", module=None):
    return {"name": name,
            "input": [{"name": n} for n in inputs],
            "output": [{"name": n} for n in outputs],
            "deploy": {"local": {"module": module or f"{root}.elements",
                                 "class_name": cls}},
            "parameters": parameters or {}}


def definition(graph, elements, name="p_speech", runtime="torch"):
    return {"version": 0, "name": name, "runtime": runtime, "graph": graph,
            "parameters": {}, "elements": elements}


def test_speech_pipeline_wav_to_reply_wav(tmp_path, runtime):
    """WAV in -> resample -> ASR -> LLM -> TTS -> WAV out, tiny models,
    every element on the CPU."""
    source = tmp_path / "in.wav"
    target = tmp_path / "reply.wav"
    rng = np.random.default_rng(0)
    write_wav(source, rng.standard_normal(4000).astype(np.float32) * 0.1,
              8000)
    pipeline = Pipeline(definition(
        ["(Read Resample Asr Llm Tts Write)"],
        [element("Read", "AudioReadFile", ["path"],
                 ["audio", "sample_rate"],
                 {"data_sources": f"file://{source}"}),
         element("Resample", "AudioResampler", ["audio", "sample_rate"],
                 ["audio", "sample_rate"], {"target_rate": 16000, **CPU}),
         element("Asr", "ASR", ["audio", "sample_rate"], ["text"],
                 {"model_size": "tiny", **CPU}),
         element("Llm", "LLM", ["text"], ["text"],
                 {"max_new_tokens": 4, "max_seq": 64, **CPU}),
         element("Tts", "TTS", ["text"], ["audio", "sample_rate"],
                 {"model_size": "tiny", **CPU}),
         element("Write", "AudioWriteFile", ["audio", "sample_rate"],
                 ["path"], {"data_targets": f"file://{target}"})]),
        runtime=runtime)
    responses = queue.Queue()
    pipeline.create_stream_local("s1", queue_response=responses)
    assert run_until(runtime, lambda: not responses.empty(), timeout=120.0)
    _, _, swag, _, okay, diagnostic = responses.get()
    assert okay, diagnostic
    samples, rate = read_wav(target)
    assert rate == 16000
    assert len(samples) == asr_tts_samples(pipeline)
    pipeline.graph.get_node("Llm").element.close()
    pipeline.stop()


def asr_tts_samples(pipeline) -> int:
    config = pipeline.graph.get_node("Tts").element._config
    return config.n_frames * config.hop


def _error_of(runtime, parameters, audio, sample_rate) -> str:
    pipeline = Pipeline(definition(
        ["(Asr)"], [element("Asr", "ASR", ["audio", "sample_rate"],
                            ["text"], parameters)], name="p_asr_error"),
        runtime=runtime)
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s1", queue_response=responses)
    pipeline.create_frame_local(stream, {"audio": audio,
                                         "sample_rate": sample_rate})
    assert run_until(runtime, lambda: not responses.empty(), timeout=30.0)
    _, _, _, _, okay, diagnostic = responses.get()
    pipeline.stop()
    assert not okay
    return diagnostic


def test_asr_rejects_wrong_rate(runtime):
    assert "16000" in _error_of(runtime, {"model_size": "tiny", **CPU},
                                np.zeros(100, np.float32), 8000)


def test_asr_checkpoint_is_not_ported(runtime):
    diagnostic = _error_of(
        runtime, {"model_size": "tiny", "checkpoint": "/no/such", **CPU},
        np.zeros(100, np.float32), RATE)
    assert "no checkpoint directory /no/such" in diagnostic


def test_asr_without_a_card_fails_the_frame(runtime):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    assert "no CUDA device" in _error_of(
        runtime, {"model_size": "tiny"}, np.zeros(100, np.float32), RATE)


def test_streaming_asr_gated_speech_pipeline(runtime):
    """Per-hop frames DROP at the gate; exactly the utterance-end frame
    passes."""
    SINK.clear()
    pipeline = Pipeline(definition(
        ["(Asr (Gate (Collect)))"],
        [element("Asr", "ASR", ["audio", "sample_rate"],
                 ["text", "partial_text", "utterance_end"],
                 {**ASR_STREAMING, "endpoint_silence": 0.25, **CPU}),
         element("Gate", "TextFilter", ["text", "utterance_end"],
                 ["text"], {"gate": "utterance_end"}),
         element("Collect", "CollectText", ["text"], [],
                 module="test_torch_speech")], name="p_speech_gate"),
        runtime=runtime)
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s1", queue_response=responses)
    rng = np.random.default_rng(0)
    speech = (rng.standard_normal(HOP) * 0.3).astype(np.float32)
    silence = np.zeros(HOP, dtype=np.float32)
    asr_element = pipeline.graph.get_node("Asr").element
    for samples in (speech, speech):
        pipeline.create_frame_local(stream, {"audio": samples,
                                             "sample_rate": RATE})
    assert run_until(
        runtime, lambda: asr_element._streamers.get("s1") is not None
        and asr_element._streamers["s1"].partial_decodes >= 1,
        timeout=120.0)
    assert len(SINK) == 0
    pipeline.create_frame_local(stream, {"audio": silence,
                                         "sample_rate": RATE})
    assert run_until(runtime, lambda: len(SINK) >= 1, timeout=120.0)
    assert len(SINK) == 1 and isinstance(SINK[0], str)
    streamer = asr_element._streamers["s1"]
    assert streamer.chunks_transcribed == 1
    assert len(streamer._pending) == 0
    # Every stream's streamer shares the element's one transcriber.
    assert asr_element.jit_cache.entries == 1
    pipeline.stop()


def test_asr_long_audio_matches_jax_on_true_rows(runtime, monkeypatch):
    """Audio over two chunks and a half: three rows, bucketed to four;
    only the three real rows are decoded, as the JAX package does."""
    from aiko_services_tpu.elements.speech import ASR as JaxASR
    from aiko_services_tpu.pipeline.element import \
        ElementContext as JaxContext
    from aiko_services_tpu_torch.elements.speech import ASR

    class _FakePipeline:
        def current_stream(self):
            return None

        def get_pipeline_parameter(self, name, default=None):
            return default

    theirs = JaxASR(JaxContext("a", None, _FakePipeline(),
                               {"model_size": "tiny"}))
    audio = (np.random.default_rng(5).standard_normal(RATE * 5 // 2)
             * 0.2).astype(np.float32)
    _, want = theirs.process_frame(None, audio=audio, sample_rate=RATE)
    monkeypatch.setattr(asr, "init_params", lambda seed, config, device:
                        bridge.asr_params_from_numpy(
                            _numpy_tree(theirs._params), config, device))
    ours = ASR(ElementContext("a", None, _FakePipeline(),
                              {"model_size": "tiny", **CPU}))
    _, got = ours.process_frame(None, audio=audio, sample_rate=RATE)
    assert got["text"] == want["text"]
    assert ours._bucketer.bucket(3) == 4 and ours.jit_cache.entries == 1


def test_text_filter_drops_empty_and_gates():
    from aiko_services_tpu_torch.elements.text import TextFilter

    class _FakePipeline:
        def current_stream(self):
            return None

        def get_pipeline_parameter(self, name, default=None):
            return default

    def make(parameters):
        return TextFilter(ElementContext("f", None, _FakePipeline(),
                                         parameters))

    drop_empty = make({})
    assert drop_empty.process_frame(None, text="  ")[0] \
        == StreamEvent.DROP_FRAME
    event, outputs = drop_empty.process_frame(None, text="hi")
    assert event == StreamEvent.OKAY and outputs["text"] == "hi"
    gated = make({"gate": "utterance_end"})
    assert gated.process_frame(None, text="hi", utterance_end=False)[0] \
        == StreamEvent.DROP_FRAME
    assert gated.process_frame(None, text="", utterance_end=True)[0] \
        == StreamEvent.OKAY
    gate_text = make({"gate": "text"})
    assert gate_text.process_frame(None, text="hi")[0] == StreamEvent.OKAY
    assert gate_text.process_frame(None, text=" ")[0] \
        == StreamEvent.DROP_FRAME
    gated_array = make({"gate": "detections"})
    for value, passes in ((np.zeros((3, 4)), True),
                          (np.zeros((0, 4)), False),
                          (torch.zeros((3, 4)), True),
                          (torch.zeros((0, 4)), False),
                          (np.bool_(False), False), (np.int64(0), False),
                          (torch.tensor(True), True)):
        event, _ = gated_array.process_frame(None, text="x",
                                             detections=value)
        assert (event == StreamEvent.OKAY) == passes, value
    event, outputs = make({"gate": "missing"}).process_frame(None, text="x")
    assert event == StreamEvent.ERROR and "missing" in \
        outputs["diagnostic"]


# -- BASELINE config 5: (ASR (GATE (LLM))), JAX package against the port -----

def _config5(root: str, runtime: str, llm: dict, asr_extra: dict) -> dict:
    module = f"{root}.elements"
    return definition(
        ["(ASR (GATE (LLM)))"],
        [element("ASR", "ASR", ["audio", "sample_rate"],
                 ["text", "partial_text", "utterance_end"],
                 {**ASR_STREAMING, **asr_extra}, module=module + ".speech"),
         element("GATE", "TextFilter", ["text", "utterance_end"], ["text"],
                 {"gate": "utterance_end"}, module=module + ".text"),
         element("LLM", "LLM", ["text"], ["text"],
                 {"quantize": "int8", "max_seq": 64, "max_new_tokens": 8,
                  **llm}, module=module + ".llm")],
        name="config5", runtime=runtime)


def _hops() -> list:
    rng = np.random.default_rng(0)
    speech = (rng.standard_normal(HOP) * 0.3).astype(np.float32)
    silence = np.zeros(HOP, dtype=np.float32)
    return ([speech] * SPEECH_HOPS + [silence]) * UTTERANCES


def _drive(rt, pipeline) -> dict:
    """Every hop on one stream, as bench.py's config-5 driver posts
    them; frame id -> (text, okay) of each frame that answered."""
    responses = queue.Queue()
    for samples in _hops():
        pipeline.process_frame_local({"audio": samples, "sample_rate": RATE},
                                     stream_id="speech",
                                     queue_response=responses)
    answered = {}

    def drained():
        while not responses.empty():
            _, frame_id, swag, _, okay, diagnostic = responses.get()
            answered[frame_id] = (swag.get("text"), okay, diagnostic)
        return len(answered) >= UTTERANCES
    assert run_until(rt, drained, timeout=120.0)
    run_until(rt, lambda: drained() and False, timeout=0.5)
    return answered


def _recording(module, record: dict):
    """Wrap ``module.init_params`` to keep the weights it draws."""
    draw = module.init_params

    def wrapper(*args, **kwargs):
        params = draw(*args, **kwargs)
        record[module.__name__] = params
        return params
    return wrapper


def _float32(cls):
    """``cls.tiny`` in float32 (an element's ``_SIZES`` entry)."""
    tiny = cls.tiny

    def factory(*args, **kwargs):
        return dataclasses.replace(tiny(*args, **kwargs), dtype="float32")
    return factory


@pytest.fixture(scope="module")
def jax_config5():
    from aiko_services_tpu.elements import llm as jax_llm
    from aiko_services_tpu.elements.speech import ASR as JaxASR
    from aiko_services_tpu.models import asr as jax_asr
    from aiko_services_tpu.models import llama as jax_llama
    from aiko_services_tpu.pipeline import Pipeline as JaxPipeline
    from aiko_services_tpu.runtime import init_process, reset_process
    from aiko_services_tpu.services.share import reset_services_cache
    from aiko_services_tpu.transport import reset_broker

    patch = pytest.MonkeyPatch()
    tokens, weights = {}, {}
    patch.setattr(jax_llama.LlamaConfig, "tiny", _float32_tiny(jax_llama))
    patch.setitem(JaxASR._SIZES, "tiny", _float32(jax_asr.AsrConfig))
    patch.setattr(jax_llama, "init_params", _recording(jax_llama, weights))
    patch.setattr(jax_asr, "init_params", _recording(jax_asr, weights))
    patch.setattr(jax_llm, "_collector", _recording_collector(jax_llm,
                                                              tokens))
    reset_broker()
    reset_services_cache()
    rt = init_process(transport="loopback")
    rt.initialize()
    try:
        pipeline = JaxPipeline(_config5("aiko_services_tpu", "jax",
                                        {"decode_block": 1}, {}),
                               runtime=rt)
        answered = _drive(rt, pipeline)
        asr_element = pipeline.graph.get_node("ASR").element
        assert asr_element._params["embed"].dtype == jax.numpy.float32
        streamer = asr_element._streamers["speech"]
        counters = (streamer.partial_decodes, streamer.chunks_transcribed)
        pipeline.stop()
    finally:
        rt.engine.terminate()
        reset_process()
        reset_services_cache()
        reset_broker()
        patch.undo()
    numpy_weights = {name.rsplit(".", 1)[-1]: _numpy_tree(tree)
                     for name, tree in weights.items()}
    return answered, tokens, numpy_weights, counters


def test_config5_matches_jax_pipeline(jax_config5, runtime, monkeypatch):
    theirs, their_tokens, weights, their_counters = jax_config5
    ours_tokens: dict = {}
    monkeypatch.setattr(llama.LlamaConfig, "tiny", _float32_tiny(llama))
    monkeypatch.setitem(ASR._SIZES, "tiny", _float32(asr.AsrConfig))
    monkeypatch.setattr(port_llm, "_collector",
                        _recording_collector(port_llm, ours_tokens))
    monkeypatch.setattr(
        port_llm.llama, "init_params",
        lambda seed, config, device: bridge.params_from_numpy(
            weights["llama"], config, device=device))
    monkeypatch.setattr(
        asr, "init_params",
        lambda seed, config, device: bridge.asr_params_from_numpy(
            weights["asr"], config, device=device))
    pipeline = Pipeline(_config5(
        "aiko_services_tpu_torch", "torch",
        {"decode_block": 16, "inflight": 3, **CPU}, CPU), runtime=runtime)
    ours = _drive(runtime, pipeline)
    asr_element = pipeline.graph.get_node("ASR").element
    assert asr_element._params["embed"].dtype == torch.float32
    streamer = asr_element._streamers["speech"]
    llm_element = pipeline.graph.get_node("LLM").element
    pipeline.stop()
    llm_element.close()

    # One reply an utterance: the speech hops dropped at the gate.
    hops = len(_hops())
    ends = [index for index in range(hops)
            if index % (SPEECH_HOPS + 1) == SPEECH_HOPS]
    assert sorted(theirs) == ends
    assert sorted(ours) == sorted(theirs)
    for frame_id, (text, okay, diagnostic) in ours.items():
        assert okay, diagnostic
        assert (text, okay) == theirs[frame_id][:2]
    assert ours_tokens == their_tokens
    assert len(ours_tokens) == UTTERANCES
    assert (streamer.partial_decodes, streamer.chunks_transcribed) \
        == their_counters == (SPEECH_HOPS * UTTERANCES, UTTERANCES)
