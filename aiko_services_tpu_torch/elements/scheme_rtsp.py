"""``rtsp://`` network-video ingest AND output (reference:
src/aiko_services/elements/gstreamer/scheme_rtsp.py:27 DataSchemeRTSP,
rtsp_io.py:35 VideoReadRTSP, video_stream_writer.py:26 VideoStreamWriter
+ utilities.py:27-100 H264 codec selection -- an 843-LoC
PyGObject/GStreamer subsystem).

Ingest rides cv2's bundled FFMPEG backend (``cv2.VideoCapture`` opens
RTSP URLs directly): no GStreamer dependency, same capability --
network cameras feed the Detector.  Frames decode on the source pump
thread host-side and enter the pipeline as numpy arrays; resize/normalize
run on device downstream.

Output pushes H264 over RTSP through an ffmpeg subprocess (rawvideo
RGB on stdin -> libx264 zerolatency -> ``rtsp://`` publish), the
ffmpeg-CLI equivalent of the reference's appsrc -> x264enc GStreamer
chain.

``capture_factory`` / ``writer_factory`` are injectable module hooks
(defaults: ``cv2.VideoCapture`` / the ffmpeg subprocess) so tests drive
the scheme with fakes and deployments can substitute GStreamer or a
hardware encoder without touching the elements.
"""

from __future__ import annotations

import subprocess
import threading

import numpy as np

from ..pipeline import DataScheme, DataSource, DataTarget, StreamEvent
from ..pipeline.stream import Stream
from .image import as_uint8

__all__ = ["DataSchemeRTSP", "VideoReadRTSP", "VideoWriteRTSP",
           "capture_factory", "writer_factory"]


class _CaptureGuard:
    """Serializes read() vs release(): cv2.VideoCapture is not
    thread-safe, and destroy_sources (engine thread) would otherwise
    release the handle while the pump thread sits inside read() --
    undefined behavior in native FFMPEG code.

    release() must NOT wait for an in-flight read: RTSP reads can block
    for tens of seconds (or forever) on a stalled camera, and release()
    runs on the single-threaded engine that owns every stream in the
    process.  So release() only *signals* and makes a brief attempt at
    the native release; if the pump thread is inside read(), the pump
    performs the native release itself as soon as the read returns.
    Reads after release report end-of-stream."""

    def __init__(self, capture):
        self._capture = capture
        self._lock = threading.Lock()
        self._released = threading.Event()
        self._closed = False            # native release done (under lock)

    def read(self):
        if self._released.is_set():
            self._close(blocking=True)
            return False, None
        with self._lock:
            if self._released.is_set():
                result = (False, None)
            else:
                result = self._capture.read()
        if self._released.is_set():     # released while we were reading
            self._close(blocking=True)
            return False, None
        return result

    def release(self, timeout: float = 0.5):
        """Engine-thread safe: returns within ``timeout`` even if the
        pump thread is parked inside a stalled network read."""
        self._released.set()
        self._close(timeout=timeout)

    def _close(self, blocking: bool = False, timeout: float = 0.0):
        if blocking:
            acquired = self._lock.acquire()
        else:
            acquired = self._lock.acquire(timeout=timeout) if timeout \
                else self._lock.acquire(blocking=False)
        if not acquired:
            return      # reader owns the lock; it will close afterwards
        try:
            if not self._closed:
                self._closed = True
                release = getattr(self._capture, "release", None)
                if release is not None:
                    release()
        finally:
            self._lock.release()


def _default_capture_factory(url: str):
    try:
        import cv2
    except ImportError as error:                    # pragma: no cover
        raise RuntimeError("rtsp:// needs cv2 (or an injected "
                           "capture_factory)") from error
    return cv2.VideoCapture(url)


capture_factory = _default_capture_factory


class _FfmpegWriter:
    """H264/RTSP publisher: raw RGB frames on an ffmpeg subprocess's
    stdin, x264 zerolatency encode, RTSP push to the URL (an RTSP
    server -- e.g. mediamtx -- must be listening there, the same
    contract as the reference's udpsink/rtmpsink targets)."""

    def __init__(self, url: str, width: int, height: int, fps: float):
        self._process = subprocess.Popen(
            ["ffmpeg", "-loglevel", "error", "-f", "rawvideo",
             "-pix_fmt", "rgb24", "-s", f"{width}x{height}",
             "-r", str(fps), "-i", "-",
             "-c:v", "libx264", "-preset", "ultrafast",
             "-tune", "zerolatency", "-pix_fmt", "yuv420p",
             "-f", "rtsp", url],
            stdin=subprocess.PIPE)

    def write(self, rgb_frame: np.ndarray):
        self._process.stdin.write(
            np.ascontiguousarray(rgb_frame, dtype=np.uint8).tobytes())

    def close(self):
        try:
            self._process.stdin.close()
        except (BrokenPipeError, OSError, ValueError):
            pass                    # encoder already gone / double close
        try:
            self._process.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            # ffmpeg wedged pushing to an unreachable server: a leaked
            # encoder per stream restart otherwise.
            self.kill()

    def kill(self):
        """Hard-stop the encoder (idempotent, any-thread safe: Popen
        ops take internal locks).  A kill also unblocks a pump thread
        stuck in write() -- the pipe breaks, the thread drains out."""
        self._process.kill()
        self._process.wait()


def _default_writer_factory(url: str, width: int, height: int,
                            fps: float):
    return _FfmpegWriter(url, width, height, fps)


writer_factory = _default_writer_factory


@DataScheme.register("rtsp")
class DataSchemeRTSP(DataScheme):
    """Opens the stream URL and pumps decoded frames as ``image``s."""

    @property
    def _key(self) -> str:
        # Per-element key: two rtsp sources in one stream must not
        # clobber each other's handle (pattern of video.py's counters).
        return f"{self.element.name}.rtsp_capture"

    def create_sources(self, stream: Stream, data_sources,
                       frame_generator=None, rate=None):
        if len(data_sources) != 1:
            return StreamEvent.ERROR, {
                "diagnostic": f"rtsp:// takes exactly one URL per "
                              f"element, got {len(data_sources)}"}
        url = data_sources[0]                       # full rtsp:// URL
        try:
            capture = capture_factory(url)
        except Exception as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"rtsp open failed: {error}"}
        opened = getattr(capture, "isOpened", lambda: True)()
        if not opened:
            release = getattr(capture, "release", None)
            if release is not None:     # free the native FFMPEG context
                release()
            return StreamEvent.ERROR, {
                "diagnostic": f"cannot open rtsp stream {url}"}
        stream.variables[self._key] = _CaptureGuard(capture)
        generator = frame_generator or self._frame_generator
        self.element.create_frames(stream, generator, rate=rate)
        return StreamEvent.OKAY, {}

    def _frame_generator(self, stream: Stream):
        guard = stream.variables.get(self._key)
        if guard is None:
            return StreamEvent.STOP, {}
        okay, frame = guard.read()
        if not okay:
            # Network cameras drop out; stop the stream gracefully so a
            # supervisor (lifecycle manager) can restart it.
            return StreamEvent.STOP, {}
        array = np.asarray(frame)
        if array.ndim == 3 and array.shape[2] == 3:
            array = array[:, :, ::-1]               # BGR -> RGB
        return StreamEvent.OKAY, {"image": array}

    def destroy_sources(self, stream: Stream):
        guard = stream.variables.pop(self._key, None)
        if guard is not None:
            guard.release()

    # -- output side (reference video_stream_writer.py:26) ----------------

    @property
    def _target_key(self) -> str:
        return f"{self.element.name}.rtsp_writer"

    def create_targets(self, stream: Stream, data_targets):
        if len(data_targets) != 1:
            return StreamEvent.ERROR, {
                "diagnostic": f"rtsp:// takes exactly one target URL "
                              f"per element, got {len(data_targets)}"}
        # The writer needs the frame geometry, so it opens lazily on
        # the first written frame; stash the URL for write().
        stream.variables[self._target_key + ".url"] = data_targets[0]
        return StreamEvent.OKAY, {}

    def write(self, stream: Stream, image, fps: float = 30.0) -> bool:
        """Publish one frame (any array-like HxWx3 RGB).  Returns False
        when the frame was dropped because the encoder is behind (video
        drop semantics -- a stalled RTSP server must never stall the
        engine thread, the same contract _CaptureGuard keeps on the
        ingest side; the pump thread absorbs the blocking pipe write).
        Raises ValueError on a mid-stream geometry change: the encoder
        is told the frame size once, and a different byte count would
        silently misframe every later frame into garbage."""
        from .audio_live import _PlaybackPump

        frame = as_uint8(image)
        pump = stream.variables.get(self._target_key)
        if pump is None:
            url = stream.variables[self._target_key + ".url"]
            writer = writer_factory(url, frame.shape[1], frame.shape[0],
                                    fps)
            pump = _PlaybackPump(writer, queue_depth=30, label="rtsp")
            stream.variables[self._target_key] = pump
            stream.variables[self._target_key + ".shape"] = frame.shape
        expected = stream.variables[self._target_key + ".shape"]
        if frame.shape != expected:
            raise ValueError(
                f"rtsp frame geometry changed mid-stream: "
                f"{frame.shape} vs encoder's {expected}")
        return pump.try_write(frame)

    def destroy_targets(self, stream: Stream):
        stream.variables.pop(self._target_key + ".url", None)
        stream.variables.pop(self._target_key + ".shape", None)
        pump = stream.variables.pop(self._target_key, None)
        if pump is not None and not pump.close():
            # Pump thread wedged inside a stalled pipe write: the
            # encoder must be hard-stopped or it leaks per restart
            # (the kill breaks the pipe, which also frees the thread).
            kill = getattr(pump.backend, "kill", None)
            if kill is not None:
                kill()


class VideoWriteRTSP(DataTarget):
    """H264/RTSP output DataTarget: ``data_targets: rtsp://host/path``;
    publishes each frame's ``image`` to the stream URL and passes it
    through (reference video_stream_writer.py:26 VideoStreamWriter /
    video_io's VideoWriteFile shape).  Parameter ``rate`` sets the
    encoder's nominal fps (default 30)."""

    def process_frame(self, stream: Stream, image=None, **inputs):
        scheme = self.scheme_for(stream)
        if scheme is None or image is None:
            return StreamEvent.ERROR, {
                "diagnostic": "rtsp target not initialized or no image"}
        rate, _ = self.get_parameter("rate", 30.0)
        try:
            written = scheme.write(stream, image, fps=float(rate))
        except (OSError, ValueError, RuntimeError) as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"rtsp publish failed: {error}"}
        if not written:
            self.logger.warning("rtsp encoder behind; frame dropped")
        return StreamEvent.OKAY, {"image": image, **inputs}


class VideoReadRTSP(DataSource):
    """Network camera DataSource: ``data_sources: rtsp://host/path``;
    emits ``image`` per decoded frame (reference rtsp_io.py:35)."""
