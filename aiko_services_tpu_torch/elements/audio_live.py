"""Live audio endpoints: microphone capture and speaker playback
(reference: src/aiko_services/elements/media/audio_io.py:412
PE_MicrophonePA, :466 PE_MicrophoneSD, :540 PE_Speaker).

``mic://<device>`` sources and ``speaker://<device>`` targets.  Capture
runs on the audio backend's own thread into a bounded queue; the frame
generator drains it on the source pump thread (the webcam pattern,
video.py:134-168) -- NO_FRAME while the queue is empty, so an idle
microphone never busy-spins the pipeline.

The hardware backend is ``sounddevice`` when importable; it is not in
this image, so the backends are injectable module hooks
(:data:`input_backend_factory` / :data:`output_backend_factory`) --
tests drive the elements with fake backends, and a deployment with
working audio gets sounddevice automatically.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from ..pipeline import DataScheme, DataSource, DataTarget, StreamEvent
from ..pipeline.stream import Stream

__all__ = ["MicrophoneRead", "SpeakerWrite", "DataSchemeMic",
           "DataSchemeSpeaker", "input_backend_factory",
           "output_backend_factory"]


class SounddeviceInput:
    """Microphone blocks via sounddevice.InputStream -> bounded queue."""

    def __init__(self, device, sample_rate: int, block_samples: int,
                 channels: int = 1, queue_depth: int = 32):
        import sounddevice  # gated: not in every image

        self._queue: queue.Queue = queue.Queue(maxsize=queue_depth)

        def callback(indata, frames, time_info, status):
            try:
                self._queue.put_nowait(np.array(indata, dtype=np.float32))
            except queue.Full:
                pass                    # drop: live capture never blocks

        self._stream = sounddevice.InputStream(
            device=device or None, samplerate=sample_rate,
            blocksize=block_samples, channels=channels, dtype="float32",
            callback=callback)
        self._stream.start()

    def read(self, timeout: float = 0.0):
        """One captured block [block, C] or None if none pending."""
        try:
            return self._queue.get(timeout=timeout) if timeout \
                else self._queue.get_nowait()
        except queue.Empty:
            return None

    def close(self):
        self._stream.stop()
        self._stream.close()


class SounddeviceOutput:
    """Speaker playback via sounddevice.OutputStream."""

    def __init__(self, device, sample_rate: int, channels: int = 1):
        import sounddevice

        self._stream = sounddevice.OutputStream(
            device=device or None, samplerate=sample_rate,
            channels=channels, dtype="float32")
        self._stream.start()

    def write(self, samples: np.ndarray):
        self._stream.write(np.ascontiguousarray(samples,
                                                dtype=np.float32))

    def close(self):
        self._stream.stop()
        self._stream.close()


# Injectable for tests / alternative audio stacks: callables with the
# SounddeviceInput / SounddeviceOutput constructor signatures.
input_backend_factory = SounddeviceInput
output_backend_factory = SounddeviceOutput


def _speaker_key(element_name: str) -> str:
    # Single definition shared by DataSchemeSpeaker and SpeakerWrite.
    return f"{element_name}.speaker_backend"


def _device_id(path: str):
    """``mic://1`` means PortAudio device *index* 1: sounddevice treats a
    str as a name-substring match, so digit-only paths must become ints."""
    return int(path) if path.isdigit() else path


class _PlaybackPump:
    """Writer thread between the engine and a (blocking) output backend.

    ``OutputStream.write`` blocks for the real-time length of the samples;
    running it on the single-threaded engine would stall every stream in
    the process for the playback duration.  The pump mirrors the capture
    pattern: the engine enqueues, a daemon thread drains."""

    def __init__(self, backend, queue_depth: int = 64,
                 label: str = "speaker"):
        self.backend = backend      # public: callers may force-kill a
        self._label = label         # wedged backend after close()
        self._queue: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._error: Exception | None = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"aiko.{label}.pump")
        self._thread.start()

    def _run(self):
        while True:
            samples = self._queue.get()
            if samples is None:
                break
            try:
                self.backend.write(samples)
            except Exception as error:
                self._error = error
        self.backend.close()        # sole closer: never races a write()

    def write(self, samples: np.ndarray, timeout: float = 1.0):
        self._raise_backend_error()
        try:
            self._queue.put(samples, timeout=timeout)
        except queue.Full:
            raise RuntimeError(
                f"{self._label} backlog exceeded (producer faster than "
                "the backend drains; sample/drop upstream or raise "
                "queue_depth)") from None

    def try_write(self, item) -> bool:
        """Drop-on-full enqueue (video semantics: a slow encoder drops
        frames rather than stalling or erroring the stream).  Returns
        False when the frame was dropped; raises only for backend
        failures."""
        self._raise_backend_error()
        try:
            self._queue.put_nowait(item)
            return True
        except queue.Full:
            return False

    def _raise_backend_error(self):
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(
                f"{self._label} backend failed: {error}")

    def close(self):
        """Signal the pump to finish and close the backend.  The backend
        close always happens on the pump thread -- sounddevice/PortAudio
        stream ops are not safe concurrently with an in-flight write --
        so a stalled write can at worst leak the daemon thread, never
        crash native code.  Bounded wait for the normal drain case;
        returns False when the thread is still wedged in a write (the
        caller may then force-kill ``self.backend`` if the backend
        supports it -- see the rtsp target scheme)."""
        try:
            self._queue.put_nowait(None)
        except queue.Full:          # drop queued audio on shutdown
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._queue.put(None)
        self._thread.join(timeout=2.0)
        return not self._thread.is_alive()


@DataScheme.register("mic")
class DataSchemeMic(DataScheme):
    """``mic://<device>`` -- opens a live capture backend and pumps its
    blocks as frames."""

    @property
    def _key(self) -> str:
        # Per-element key: two mics in one stream keep distinct handles.
        return f"{self.element.name}.mic_backend"

    def create_sources(self, stream: Stream, data_sources,
                       frame_generator=None, rate=None):
        if len(data_sources) != 1:
            return StreamEvent.ERROR, {
                "diagnostic": f"mic:// takes exactly one device per "
                              f"element, got {len(data_sources)}"}
        device = _device_id(DataScheme.parse_data_url_path(data_sources[0]))
        sample_rate, _ = self.element.get_parameter("sample_rate", 16000)
        block, _ = self.element.get_parameter("block_samples", 1600)
        channels, _ = self.element.get_parameter("channels", 1)
        try:
            backend = input_backend_factory(
                device, int(sample_rate), int(block), int(channels))
        except Exception as error:       # backend/library/device absent
            return StreamEvent.ERROR, {
                "diagnostic": f"microphone open failed: {error}"}
        stream.variables[self._key] = backend
        stream.variables[f"{self._key}.rate"] = int(sample_rate)
        generator = frame_generator or self._block_generator
        self.element.create_frames(stream, generator, rate=rate)
        return StreamEvent.OKAY, {}

    def _block_generator(self, stream: Stream):
        backend = stream.variables.get(self._key)
        if backend is None:
            return StreamEvent.STOP, {}
        block = backend.read(timeout=0.05)
        if block is None:
            return StreamEvent.NO_FRAME, {}
        return StreamEvent.OKAY, {
            "audio": block,
            "sample_rate": stream.variables[f"{self._key}.rate"]}

    def destroy_sources(self, stream: Stream):
        backend = stream.variables.pop(self._key, None)
        if backend is not None:
            backend.close()


@DataScheme.register("speaker")
class DataSchemeSpeaker(DataScheme):
    """``speaker://<device>`` -- opens a playback backend."""

    @property
    def _key(self) -> str:
        return _speaker_key(self.element.name)

    def create_targets(self, stream: Stream, data_targets):
        if len(data_targets) != 1:
            return StreamEvent.ERROR, {
                "diagnostic": f"speaker:// takes exactly one device per "
                              f"element, got {len(data_targets)}"}
        device = _device_id(DataScheme.parse_data_url_path(data_targets[0]))
        sample_rate, _ = self.element.get_parameter("sample_rate", 16000)
        channels, _ = self.element.get_parameter("channels", 1)
        queue_depth, _ = self.element.get_parameter("queue_depth", 64)
        try:
            backend = output_backend_factory(
                device, int(sample_rate), int(channels))
        except Exception as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"speaker open failed: {error}"}
        stream.variables[self._key] = _PlaybackPump(
            backend, queue_depth=int(queue_depth))
        stream.variables[f"{self._key}.rate"] = int(sample_rate)
        return StreamEvent.OKAY, {}

    def destroy_targets(self, stream: Stream):
        backend = stream.variables.pop(self._key, None)
        if backend is not None:
            backend.close()


class MicrophoneRead(DataSource):
    """Live microphone DataSource: ``data_sources: mic://<device>``;
    emits ``audio`` [block, C] + ``sample_rate`` per captured block
    (reference PE_MicrophoneSD, audio_io.py:466-540)."""


class SpeakerWrite(DataTarget):
    """Live speaker DataTarget: ``data_targets: speaker://<device>``;
    plays each frame's ``audio`` (reference PE_Speaker,
    audio_io.py:540-564)."""

    host_inputs = ("audio",)    # sink: the engine fetches explicitly

    def process_frame(self, stream: Stream, audio=None, sample_rate=None,
                      **inputs):
        key = _speaker_key(self.name)
        backend = stream.variables.get(key)
        if backend is None:
            return StreamEvent.ERROR, {"diagnostic": "speaker not open"}
        device_rate = stream.variables.get(f"{key}.rate")
        if sample_rate is not None and int(sample_rate) != device_rate:
            return StreamEvent.ERROR, {
                "diagnostic": f"speaker opened at {device_rate} Hz but "
                              f"frame audio is {sample_rate} Hz (add "
                              f"AudioResampler)"}
        if audio is not None:
            samples = np.asarray(audio, dtype=np.float32)
            if samples.ndim == 1:
                samples = samples[:, None]
            try:
                backend.write(samples)
            except Exception as error:
                return StreamEvent.ERROR, {
                    "diagnostic": f"speaker write failed: {error}"}
        return StreamEvent.OKAY, {}
