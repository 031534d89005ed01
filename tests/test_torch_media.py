"""The port's media element library through real pipelines on the
loopback runtime: twins of ``tests/test_media.py`` (image, video,
audio, ZMQ, TTY, the media conversions), of the ``tensor://`` scheme's
pipeline hop in ``tests/test_tensor_pipe.py`` and of the ``rtsp://``
cases of ``tests/test_live_media.py`` (fake capture and writer
backends).  Host frames stay numpy; the elements that compute
(``ImageResize``, the audio DSP) run with ``device: cpu``.  Files are
written by the tests themselves."""

import io
import queue

import numpy as np
import pytest
import torch

import torch_pipeline_elements
from conftest import run_until
from test_live_media import FakeCapture
from test_torch_llm_element import _port_runtime, _port_teardown

from aiko_services_tpu_torch.elements import read_wav, write_wav
from aiko_services_tpu_torch.pipeline import Pipeline

MEDIA = "aiko_services_tpu_torch.elements"
HELPERS = "torch_pipeline_elements"
CPU = {"device": "cpu"}


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


def element(name, cls, inputs, outputs, parameters=None, module=MEDIA):
    return {"name": name,
            "input": [{"name": n} for n in inputs],
            "output": [{"name": n} for n in outputs],
            "deploy": {"local": {"module": module, "class_name": cls}},
            "parameters": parameters or {}}


def definition(graph, elements, name="p_media"):
    return {"version": 0, "name": name, "runtime": "torch", "graph": graph,
            "parameters": {}, "elements": elements}


def collector(cls, inputs):
    return element("Collect", cls, inputs, [], module=HELPERS)


def pump_stream(runtime, pipeline, stream_id="s1", parameters=None,
                predicate=None, timeout=10.0):
    pipeline.create_stream_local(stream_id, parameters or {})
    if predicate is not None:
        assert run_until(runtime, predicate, timeout=timeout)


def make_image(tmp_path, name="in.png", size=(32, 24), color=(200, 30, 40)):
    from PIL import Image
    path = tmp_path / name
    Image.new("RGB", size, color).save(path)
    return path


class _FakePipeline:
    def current_stream(self):
        return None

    def get_pipeline_parameter(self, name, default=None):
        return default


def _context(name, parameters):
    from aiko_services_tpu_torch.pipeline.element import ElementContext
    return ElementContext(name, None, _FakePipeline(), parameters)


# -- image ------------------------------------------------------------------

def test_image_read_resize_overlay_write(tmp_path, runtime):
    source = make_image(tmp_path)
    target = tmp_path / "out.png"
    pipeline = Pipeline(definition(
        ["(Read Resize Overlay Write)"],
        [element("Read", "ImageReadFile", ["path"], ["image"],
                 {"data_sources": f"file://{source}"}),
         element("Resize", "ImageResize", ["image"], ["image"],
                 {"width": 16, "height": 12, **CPU}),
         element("Overlay", "ImageOverlay", ["image"], ["image"]),
         element("Write", "ImageWriteFile", ["image"], ["path"],
                 {"data_targets": f"file://{target}"})]),
        runtime=runtime)
    pump_stream(runtime, pipeline, predicate=lambda: target.exists())

    from PIL import Image
    with Image.open(target) as image:
        assert image.size == (16, 12)
        # A solid colour resizes to itself.
        assert np.asarray(image)[6, 8].tolist() == [200, 30, 40]


def test_image_overlay_draws_rectangles(runtime):
    from aiko_services_tpu_torch.elements.image import ImageOverlay

    overlay = ImageOverlay(_context("o", {}))
    image = torch.zeros((20, 20, 3), dtype=torch.uint8)
    event, outputs = overlay.process_frame(
        None, image=image,
        overlay={"rectangles": [
            {"x": 0.1, "y": 0.1, "w": 0.5, "h": 0.5, "name": "cat"}]})
    out = np.asarray(outputs["image"])
    assert out.sum() > 0                   # something was drawn


# -- video ------------------------------------------------------------------

def test_video_write_then_read(tmp_path, runtime):
    cv2 = pytest.importorskip("cv2")
    video_path = tmp_path / "clip.avi"
    frames = [np.full((24, 32, 3), i * 10, dtype=np.uint8)
              for i in range(5)]
    writer = cv2.VideoWriter(
        str(video_path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (32, 24))
    assert writer.isOpened()
    for frame in frames:
        writer.write(frame)
    writer.release()

    collected = torch_pipeline_elements.SINK = []
    pipeline = Pipeline(definition(
        ["(Read Collect)"],
        [element("Read", "VideoReadFile", ["image"], ["image"],
                 {"data_sources": f"file://{video_path}"}),
         collector("Collect", ["image"])]),
        runtime=runtime)
    pump_stream(runtime, pipeline,
                predicate=lambda: len(collected) >= 5)
    assert collected[0].shape == (24, 32, 3)


def test_video_sample_drops(runtime):
    from aiko_services_tpu_torch.elements.video import VideoSample
    from aiko_services_tpu_torch.pipeline import StreamEvent
    from aiko_services_tpu_torch.pipeline.stream import Stream

    sampler = VideoSample(_context("s", {"sample_rate": 3}))
    stream = Stream(stream_id="x")
    sampler.start_stream(stream, "x")
    events = [sampler.process_frame(stream, image=i)[0] for i in range(6)]
    assert events == [StreamEvent.OKAY, StreamEvent.DROP_FRAME,
                      StreamEvent.DROP_FRAME, StreamEvent.OKAY,
                      StreamEvent.DROP_FRAME, StreamEvent.DROP_FRAME]


# -- audio ------------------------------------------------------------------

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

    collected = torch_pipeline_elements.SINK = []
    pipeline = Pipeline(definition(
        ["(Read Frame FFT Collect)"],
        [element("Read", "AudioReadFile", ["path"], ["audio", "sample_rate"],
                 {"data_sources": f"file://{path}"}),
         element("Frame", "AudioFraming", ["audio"], ["frames"],
                 {"window": 256, "hop": 128, **CPU}),
         element("FFT", "AudioFFT", ["frames"], ["spectrum"], CPU),
         collector("CollectSpectrum", ["spectrum"])]),
        runtime=runtime)
    pump_stream(runtime, pipeline, predicate=lambda: len(collected) >= 1)
    spectrum = np.asarray(collected[0])
    # peak bin should be at 1 kHz: bin = 1000 / (8000/256) = 32
    assert abs(int(spectrum[0].argmax()) - 32) <= 1


def test_audio_resampler():
    from aiko_services_tpu_torch.elements.audio import AudioResampler

    resampler = AudioResampler(_context("r", {"target_rate": 4000, **CPU}))
    audio = torch.ones((8000,), dtype=torch.float32)
    event, outputs = resampler.process_frame(None, audio=audio,
                                             sample_rate=8000)
    assert outputs["audio"].shape == (4000,)
    assert outputs["sample_rate"] == 4000


# -- zmq --------------------------------------------------------------------

def test_zmq_array_payload_roundtrip():
    from aiko_services_tpu_torch.elements.scheme_zmq import (decode_payload,
                                                             encode_payload)
    x = torch.arange(12.0).reshape(3, 4)
    decoded = decode_payload(encode_payload(x))
    assert isinstance(decoded, np.ndarray)          # stays on the host
    np.testing.assert_array_equal(decoded, x.numpy())
    assert decode_payload(encode_payload("hello")) == "hello"
    assert decode_payload(encode_payload(b"raw")) == b"raw"


def test_zmq_pipeline_pair(tmp_path, runtime):
    """Writer pipeline PUSHes text, reader pipeline PULLs it."""
    zmq = pytest.importorskip("zmq")
    from aiko_services_tpu_torch.utils import find_free_port
    port = find_free_port()

    collected = torch_pipeline_elements.SINK = []
    reader = Pipeline(definition(
        ["(Read Collect)"],
        [element("Read", "TextReadZMQ", ["payload"], ["text"],
                 {"data_sources": f"zmq://127.0.0.1:{port}",
                  "zmq_bind": True}),
         collector("CollectText", ["text"])], name="p_zmq_read"),
        runtime=runtime)
    reader.create_stream_local("rx", {})

    writer = Pipeline(definition(
        ["(Write)"],
        [element("Write", "TextWriteZMQ", ["text"], ["text"],
                 {"data_targets": f"zmq://127.0.0.1:{port}",
                  "zmq_bind": False})], name="p_zmq_write"),
        runtime=runtime)
    writer.create_stream_local("tx", {})
    run_until(runtime, lambda: False, timeout=0.2)   # let sockets settle

    responses = queue.Queue()
    writer.process_frame_local({"text": "over the wire"}, stream_id="tx",
                               queue_response=responses)
    assert run_until(runtime, lambda: len(collected) >= 1, timeout=10.0)
    assert collected[0] == "over the wire"


# -- tty --------------------------------------------------------------------

def test_tty_read_write(tmp_path, runtime):
    output = io.StringIO()
    pipeline = Pipeline(definition(
        ["(Read Write)"],
        [element("Read", "TextReadTTY", ["text"], ["text"],
                 {"data_sources": "tty://stdin"}),
         element("Write", "TextWriteTTY", ["text"], ["text"],
                 {"data_targets": "tty://stdout"})], name="p_tty"),
        runtime=runtime)
    # inject input/output streams via stream parameters
    pipeline.create_stream_local("t1", {
        "Read.tty_input": io.StringIO("alpha\nbeta\n/q\n"),
        "Write.tty_output": output})
    assert run_until(
        runtime, lambda: output.getvalue().count("\n") >= 2, timeout=10.0)
    assert output.getvalue() == "alpha\nbeta\n"


def test_audio_graph_xy():
    """AudioGraphXY renders the spectrum into an image array: a tone's
    peak column draws a full-height bar, quiet columns stay near the
    baseline."""
    from aiko_services_tpu_torch.elements.audio import AudioGraphXY

    graph = AudioGraphXY(_context("g", {"width": 128, "height": 64}))
    bins = 256
    spectrum = np.full((2, bins), 0.01, dtype=np.float32)
    spectrum[:, 64] = 1.0                       # peak at bin 64 -> col 32
    event, outputs = graph.process_frame(None, spectrum=spectrum,
                                         sample_rate=8000)
    image = outputs["image"]
    assert image.shape == (64, 128, 3) and image.dtype == np.uint8
    assert outputs["spectrum"] is spectrum      # passthrough
    bar_color = np.array([64, 200, 120], dtype=np.uint8)
    bar_rows = (image == bar_color).all(axis=-1).sum(axis=0)  # per column
    peak_col = int(bar_rows.argmax())
    assert abs(peak_col - 32) <= 1              # peak lands where it should
    assert bar_rows[peak_col] >= 60             # ~full height
    assert np.median(bar_rows) <= 3             # quiet floor stays low


def test_audio_graph_xy_max_frequency():
    from aiko_services_tpu_torch.elements.audio import AudioGraphXY

    graph = AudioGraphXY(_context(
        "g", {"width": 64, "height": 32, "max_frequency": 2000}))
    bins = 256                                  # nyquist 4 kHz at 8 kHz
    spectrum = np.full((bins,), 0.01, dtype=np.float32)
    spectrum[32] = 1.0                          # 0.5 kHz
    event, outputs = graph.process_frame(None, spectrum=spectrum,
                                         sample_rate=8000)
    image = outputs["image"]
    bar_color = np.array([64, 200, 120], dtype=np.uint8)
    bar_rows = (image == bar_color).all(axis=-1).sum(axis=0)
    assert abs(int(bar_rows.argmax()) - 16) <= 1


# -- media conversion utilities ---------------------------------------------

def test_images_to_video_to_images_roundtrip(tmp_path, runtime):
    """A directory of images encodes into a video through the port's
    engine; that video decodes back into the same number of frames."""
    cv2 = pytest.importorskip("cv2")
    del cv2
    from PIL import Image

    from aiko_services_tpu_torch.media_convert import (images_to_video,
                                                       video_to_images)

    for i in range(5):
        Image.new("RGB", (32, 24), (i * 40, 30, 40)).save(
            tmp_path / f"frame_{i}.png")
    video = tmp_path / "clip.avi"
    frames = images_to_video(f"{tmp_path}/frame_*.png", str(video),
                             rate=10.0, runtime=runtime)
    assert frames == 5
    assert video.exists() and video.stat().st_size > 0

    out_pattern = tmp_path / "decoded" / "img_{}.png"
    frames = video_to_images(str(video), str(out_pattern),
                             runtime=runtime)
    assert frames == 5
    decoded = sorted((tmp_path / "decoded").glob("img_*.png"))
    assert len(decoded) == 5
    with Image.open(decoded[0]) as image:
        assert image.size == (32, 24)


# -- tensor:// (tests/test_tensor_pipe.py) -----------------------------------

def test_pipeline_hop_over_tensor_scheme(runtime):
    """Producer pipeline -> tensor://127.0.0.1 -> consumer pipeline:
    the cross-host hop through the port's engine, arrays arriving typed
    and shaped (numpy on the consumer's side)."""
    collected = torch_pipeline_elements.SINK = []
    consumer = Pipeline({
        "version": 0, "name": "p_consumer", "runtime": "torch",
        "graph": ["(RX (Grab (image: tensor)))"],
        "parameters": {},
        "elements": [
            {"name": "RX", "input": [],
             "output": [{"name": "tensor"}, {"name": "name"}],
             "deploy": {"local": {
                 "module": f"{MEDIA}.scheme_tensor",
                 "class_name": "TensorReadPipe"}},
             "parameters": {"data_sources": "tensor://127.0.0.1:0"}},
            {"name": "Grab", "input": [{"name": "image"}],
             "output": [],
             "deploy": {"local": {"module": HELPERS,
                                  "class_name": "Collect"}},
             "parameters": {}},
        ]}, runtime=runtime)
    stream = consumer.create_stream_local("rx")
    assert stream is not None
    port = stream.variables["tensor_pipe_port"]
    producer = Pipeline({
        "version": 0, "name": "p_producer", "runtime": "torch",
        "graph": ["(TX)"],
        "parameters": {},
        "elements": [
            {"name": "TX", "input": [{"name": "tensor"}],
             "output": [{"name": "tensor"}],
             "deploy": {"local": {
                 "module": f"{MEDIA}.scheme_tensor",
                 "class_name": "TensorWritePipe"}},
             "parameters": {"data_targets":
                            f"tensor://127.0.0.1:{port}"}},
        ]}, runtime=runtime)
    responses = queue.Queue()
    tx_stream = producer.create_stream_local("tx",
                                             queue_response=responses)
    payload = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    producer.create_frame_local(tx_stream, {"tensor": payload})
    assert run_until(runtime, lambda: len(collected) >= 1, timeout=20.0)
    received = np.asarray(collected[0])
    assert received.shape == (3, 4)
    np.testing.assert_array_equal(received, payload.numpy())
    consumer.destroy_stream("rx")
    producer.destroy_stream("tx")


# -- rtsp:// (tests/test_live_media.py) --------------------------------------

def test_rtsp_rejects_multiple_urls(runtime, monkeypatch):
    from aiko_services_tpu_torch.elements import scheme_rtsp
    monkeypatch.setattr(scheme_rtsp, "capture_factory", FakeCapture)
    pipeline = Pipeline(definition(
        ["(Rtsp)"],
        [element("Rtsp", "VideoReadRTSP", [], ["image"],
                 {"data_sources": ["rtsp://cam1/s", "rtsp://cam2/s"]})],
        name="p_rtsp_multi"), runtime=runtime)
    assert pipeline.create_stream_local("s1") is None


def test_rtsp_source_decodes_frames(runtime, monkeypatch):
    """rtsp:// frames arrive as RGB numpy images; capture released at
    stop."""
    from aiko_services_tpu_torch.elements import scheme_rtsp
    monkeypatch.setattr(scheme_rtsp, "capture_factory", FakeCapture)
    FakeCapture.instances.clear()
    collected = torch_pipeline_elements.SINK = []

    pipeline = Pipeline(definition(
        ["(Rtsp Grab)"],
        [element("Rtsp", "VideoReadRTSP", [], ["image"],
                 {"data_sources": "rtsp://camera.local/stream1"}),
         element("Grab", "Collect", ["image"], [], module=HELPERS)],
        name="p_rtsp"), runtime=runtime)
    pipeline.create_stream_local("s1")
    assert run_until(runtime, lambda: len(collected) >= 3, timeout=15.0)

    capture = FakeCapture.instances[0]
    assert capture.url == "rtsp://camera.local/stream1"
    first = np.asarray(collected[0])
    assert first.shape == (8, 8, 3)
    assert first[0, 0, 2] == 255          # BGR -> RGB flip happened
    assert first[0, 0, 0] == 0
    # End-of-stream (3 frames) stops the stream and releases capture.
    assert run_until(runtime, lambda: capture.released, timeout=10.0)


def test_rtsp_release_does_not_block_on_stalled_read():
    """A stalled network read must not park release() (the engine
    thread): release signals, returns fast, and the reader performs the
    native release when the read finally returns."""
    import threading
    import time

    from aiko_services_tpu_torch.elements.scheme_rtsp import _CaptureGuard

    release_gate = threading.Event()

    class StalledCapture:
        def __init__(self):
            self.released = False

        def read(self):
            release_gate.wait(timeout=10.0)       # "network stall"
            return True, np.zeros((2, 2, 3), np.uint8)

        def release(self):
            self.released = True

    capture = StalledCapture()
    guard = _CaptureGuard(capture)
    results = []
    reader = threading.Thread(target=lambda: results.append(guard.read()))
    reader.start()
    time.sleep(0.05)                              # reader inside read()

    start = time.perf_counter()
    guard.release(timeout=0.2)
    elapsed = time.perf_counter() - start
    assert elapsed < 2.0                          # returned promptly
    assert not capture.released                   # deferred to reader

    release_gate.set()                            # stall ends
    reader.join(timeout=5.0)
    assert results == [(False, None)]             # read reports EOS
    assert capture.released                       # reader closed natively
