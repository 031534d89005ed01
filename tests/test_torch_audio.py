"""The port's audio elements (``aiko_services_tpu_torch/elements/
audio.py``, ``audio_live.py``): twins of the audio cases of
``tests/test_media.py``, ``tests/test_overlap.py`` and
``tests/test_live_media.py`` on the port's pipeline with ``device: cpu``,
the DSP held against the JAX package's elements on the same inputs
(framing and FFT equal, resampling down and up against
``jax.image.resize`` -- antialiased when it downsamples), and the
device rule."""

import json
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_until
from test_live_media import FakeMicBackend, FakeSpeakerBackend

from aiko_services_tpu.elements import audio as jax_audio
from aiko_services_tpu.pipeline.element import ElementContext as JaxContext
from aiko_services_tpu_torch.elements import audio, audio_live
from aiko_services_tpu_torch.elements import read_wav, write_wav
from aiko_services_tpu_torch.pipeline import (Pipeline, PipelineElement,
                                              StreamEvent, create_pipeline)
from aiko_services_tpu_torch.pipeline.element import ElementContext

MEDIA = "aiko_services_tpu_torch.elements"
CPU = {"device": "cpu"}
# float32 tap positions and weights rounded in another order, relative
# to the signal's peak
RESAMPLE_TOL = 1e-5

SINK: list = []


class CollectSpectrum(PipelineElement):
    def process_frame(self, stream, spectrum=None, **inputs):
        SINK.append(spectrum)
        return StreamEvent.OKAY, {}


@pytest.fixture
def runtime():
    from test_torch_llm_element import _port_runtime, _port_teardown
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


class _FakePipeline:
    def current_stream(self):
        return None

    def get_pipeline_parameter(self, name, default=None):
        return default


def _ours(cls, parameters):
    return cls(ElementContext("e", None, _FakePipeline(), parameters))


def _theirs(cls, parameters):
    return cls(JaxContext("e", None, _FakePipeline(), parameters))


def element(name, cls, inputs, outputs, parameters=None, module=MEDIA):
    return {"name": name,
            "input": [{"name": n} for n in inputs],
            "output": [{"name": n} for n in outputs],
            "deploy": {"local": {"module": module, "class_name": cls}},
            "parameters": parameters or {}}


def definition(graph, elements, name="p_media"):
    return {"version": 0, "name": name, "runtime": "torch", "graph": graph,
            "parameters": {}, "elements": elements}


def test_wav_roundtrip(tmp_path):
    rate = 8000
    t = np.linspace(0, 1, rate, endpoint=False)
    tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    path = tmp_path / "tone.wav"
    write_wav(path, tone, rate)
    samples, read_rate = read_wav(str(path))
    assert read_rate == rate
    assert samples.shape == (rate, 1)
    np.testing.assert_allclose(samples[:, 0], tone, atol=1e-3)


def test_audio_pipeline_frame_fft(tmp_path, runtime):
    rate = 8000
    t = np.linspace(0, 0.1, rate // 10, endpoint=False)
    tone = (0.5 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
    path = tmp_path / "in.wav"
    write_wav(path, tone, rate)
    SINK.clear()
    pipeline = Pipeline(definition(
        ["(Read Frame FFT Collect)"],
        [element("Read", "AudioReadFile", ["path"], ["audio", "sample_rate"],
                 {"data_sources": f"file://{path}"}),
         element("Frame", "AudioFraming", ["audio"], ["frames"],
                 {"window": 256, "hop": 128, **CPU}),
         element("FFT", "AudioFFT", ["frames"], ["spectrum"], CPU),
         element("Collect", "CollectSpectrum", ["spectrum"], [],
                 module="test_torch_audio")]),
        runtime=runtime)
    pipeline.create_stream_local("s1", {})
    assert run_until(runtime, lambda: len(SINK) >= 1)
    spectrum = SINK[0]
    assert isinstance(spectrum, torch.Tensor)       # device-resident
    # peak bin should be at 1 kHz: bin = 1000 / (8000/256) = 32
    assert abs(int(spectrum[0].argmax()) - 32) <= 1
    pipeline.stop()


@pytest.mark.parametrize("shape, window, hop", [
    ((1000,), 256, 128), ((1000, 2), 400, 160), ((100, 1), 256, 64)])
def test_framing_and_fft_match_jax(shape, window, hop):
    samples = np.random.default_rng(1).standard_normal(shape) \
        .astype(np.float32)
    parameters = {"window": window, "hop": hop}
    _, want = _theirs(jax_audio.AudioFraming, parameters).process_frame(
        None, audio=samples)
    _, got = _ours(audio.AudioFraming, {**parameters, **CPU}).process_frame(
        None, audio=samples)
    np.testing.assert_array_equal(got["frames"].numpy(),
                                  np.asarray(want["frames"]))
    _, want = _theirs(jax_audio.AudioFFT, {}).process_frame(
        None, frames=np.asarray(want["frames"]))
    _, got = _ours(audio.AudioFFT, CPU).process_frame(
        None, frames=got["frames"])
    np.testing.assert_allclose(got["spectrum"].numpy(),
                               np.asarray(want["spectrum"]),
                               rtol=1e-5, atol=1e-4)


def test_audio_resampler():
    resampler = _ours(audio.AudioResampler, {"target_rate": 4000, **CPU})
    event, outputs = resampler.process_frame(
        None, audio=torch.ones(8000), sample_rate=8000)
    assert outputs["audio"].shape == (4000,)
    assert outputs["sample_rate"] == 4000
    torch.testing.assert_close(outputs["audio"], torch.ones(4000))


@pytest.mark.parametrize("n, rate, target, channels", [
    (8000, 8000, 4000, 1),          # down 2x: antialiased
    (48000, 48000, 16000, 2),       # down 3x, two channels
    (8000, 8000, 16000, 1),         # up 2x
    (8000, 8000, 12345, 1),         # up by a ratio that is no integer
    (4410, 44100, 16000, 1)])       # down 2.76x
def test_resampler_matches_jax(n, rate, target, channels):
    """``jax.image.resize(method="linear")`` antialiases when it
    downsamples: 8,000 -> 4,000 samples of N(0, 1) differ from
    ``F.interpolate(mode="linear")`` by up to ~0.85; the port holds
    JAX's numbers in both directions."""
    samples = np.random.default_rng(2).standard_normal((n, channels)) \
        .astype(np.float32)
    _, want = _theirs(jax_audio.AudioResampler,
                      {"target_rate": target}).process_frame(
        None, audio=samples, sample_rate=rate)
    _, got = _ours(audio.AudioResampler,
                   {"target_rate": target, **CPU}).process_frame(
        None, audio=samples, sample_rate=rate)
    want = np.asarray(want["audio"])
    assert tuple(got["audio"].shape) == want.shape
    np.testing.assert_allclose(got["audio"].numpy(), want, rtol=0,
                               atol=RESAMPLE_TOL * np.abs(want).max())
    if target < rate:
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(samples).T[None], size=want.shape[0],
            mode="linear", align_corners=False)[0].T.numpy()
        assert np.abs(plain - want).max() > 100 * RESAMPLE_TOL


def test_resize_linear_matches_dense_jax_resize_on_a_ramp():
    ramp = np.linspace(-1, 1, 37, dtype=np.float32)[:, None]
    for length in (5, 11, 36, 38, 80):
        want = np.asarray(jax.image.resize(jnp.asarray(ramp), (length, 1),
                                           method="linear"))
        got = audio.resize_linear(torch.from_numpy(ramp), length).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_TOL)


def test_audio_graph_xy():
    graph = _ours(audio.AudioGraphXY, {"width": 128, "height": 64})
    bins = 256
    spectrum = np.full((2, bins), 0.01, dtype=np.float32)
    spectrum[:, 64] = 1.0                       # peak at bin 64 -> col 32
    event, outputs = graph.process_frame(None, spectrum=spectrum,
                                         sample_rate=8000)
    image = outputs["image"]
    assert image.shape == (64, 128, 3) and image.dtype == np.uint8
    assert outputs["spectrum"] is spectrum      # passthrough
    bar_color = np.array([64, 200, 120], dtype=np.uint8)
    bar_rows = (image == bar_color).all(axis=-1).sum(axis=0)
    peak_col = int(bar_rows.argmax())
    assert abs(peak_col - 32) <= 1
    assert bar_rows[peak_col] >= 60
    assert np.median(bar_rows) <= 3


def test_audio_graph_xy_max_frequency():
    graph = _ours(audio.AudioGraphXY,
                  {"width": 64, "height": 32, "max_frequency": 2000})
    bins = 256                                  # nyquist 4 kHz at 8 kHz
    spectrum = np.full((bins,), 0.01, dtype=np.float32)
    spectrum[32] = 1.0                          # 0.5 kHz
    event, outputs = graph.process_frame(None, spectrum=spectrum,
                                         sample_rate=8000)
    bar_color = np.array([64, 200, 120], dtype=np.uint8)
    bar_rows = (outputs["image"] == bar_color).all(axis=-1).sum(axis=0)
    assert abs(int(bar_rows.argmax()) - 16) <= 1


def _fft_pipeline(tmp_path, runtime, parameters):
    body = definition(["(fft)"], [element(
        "fft", "AudioFFT", ["frames", "sample_rate"],
        ["spectrum", "sample_rate"], parameters,
        module="aiko_services_tpu_torch.elements.audio")], name="mb_fft")
    path = tmp_path / "fft.json"
    path.write_text(json.dumps(body))
    return create_pipeline(str(path), runtime=runtime)


def test_audio_fft_microbatch_matches_sync(tmp_path, runtime):
    pipeline = _fft_pipeline(tmp_path, runtime, CPU)
    rng = np.random.default_rng(1)
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    windows = [rng.standard_normal((4, 64, 1)).astype(np.float32)
               for _ in range(3)]
    for w in windows:
        pipeline.create_frame_local(
            stream, {"frames": w, "sample_rate": 16000})
    assert run_until(runtime, lambda: responses.qsize() >= 3, timeout=30.0)
    element_ = pipeline.graph.get_node("fft").element
    assert element_._batcher.dispatches < 3      # coalesced
    by_frame = {}
    while not responses.empty():
        _, frame_id, swag, _, okay, diagnostic = responses.get()
        assert okay, diagnostic
        by_frame[frame_id] = swag
    for frame_id, w in enumerate(windows):
        spectrum = by_frame[frame_id]["spectrum"]
        assert isinstance(spectrum, torch.Tensor)
        _, sync_out = element_.process_frame(None, frames=w)
        np.testing.assert_allclose(spectrum.numpy(),
                                   sync_out["spectrum"].numpy(),
                                   rtol=1e-5, atol=1e-5)
    pipeline.stop()


def test_audio_fft_accepts_array_like_frames(tmp_path, runtime):
    pipeline = _fft_pipeline(tmp_path, runtime, CPU)
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    frames = [[0.0, 1.0, 0.0, -1.0]] * 2        # [2 windows, 4 samples]
    pipeline.create_frame_local(
        stream, {"frames": frames, "sample_rate": 16000})
    assert run_until(runtime, lambda: not responses.empty(), timeout=30.0)
    _, _, swag, _, okay, diagnostic = responses.get()
    assert okay, diagnostic
    element_ = pipeline.graph.get_node("fft").element
    _, sync_out = element_.process_frame(None, frames=frames)
    np.testing.assert_allclose(swag["spectrum"].numpy(),
                               sync_out["spectrum"].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(swag["spectrum"].numpy(), [[0, 2, 0]] * 2,
                               atol=1e-6)
    pipeline.stop()


def test_audio_fft_without_a_card_fails_the_frame(tmp_path, runtime):
    """The device rule: no card and no ``device: cpu`` fails the frame
    (no silent fallback to the host)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    pipeline = _fft_pipeline(tmp_path, runtime, {})
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    pipeline.create_frame_local(
        stream, {"frames": np.zeros((2, 8), np.float32),
                 "sample_rate": 16000})
    assert run_until(runtime, lambda: not responses.empty(), timeout=30.0)
    _, _, _, _, okay, diagnostic = responses.get()
    assert not okay
    assert "no CUDA device" in diagnostic
    pipeline.stop()


def test_microphone_to_speaker_pipeline(runtime, monkeypatch):
    """mic:// blocks reach speaker:// playback as the host arrays they
    were captured as; both backends open and close around the stream."""
    monkeypatch.setattr(audio_live, "input_backend_factory", FakeMicBackend)
    monkeypatch.setattr(audio_live, "output_backend_factory",
                        FakeSpeakerBackend)
    FakeMicBackend.instances.clear()
    FakeSpeakerBackend.instances.clear()
    pipeline = Pipeline(definition(
        ["(Mic Play)"],
        [element("Mic", "MicrophoneRead", [], ["audio", "sample_rate"],
                 {"data_sources": "mic://default", "sample_rate": 8000,
                  "block_samples": 160}),
         element("Play", "SpeakerWrite", ["audio"], [],
                 {"data_targets": "speaker://default",
                  "sample_rate": 8000})],
        name="p_mic"), runtime=runtime)
    pipeline.create_stream_local("s1")
    assert run_until(
        runtime,
        lambda: FakeSpeakerBackend.instances
        and len(FakeSpeakerBackend.instances[0].written) >= 3,
        timeout=15.0)
    mic = FakeMicBackend.instances[0]
    speaker = FakeSpeakerBackend.instances[0]
    assert mic.sample_rate == 8000
    np.testing.assert_allclose(speaker.written[0], 0.1, rtol=1e-6)
    np.testing.assert_allclose(speaker.written[2], 0.3, rtol=1e-6)
    pipeline.destroy_stream("s1")
    assert run_until(runtime, lambda: mic.closed and speaker.closed,
                     timeout=10.0)
