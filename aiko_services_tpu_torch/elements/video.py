"""Video elements (reference: src/aiko_services/elements/media/
video_io.py): cv2 VideoCapture/VideoWriter streaming, frame sampling,
plus the webcam source (webcam_io.py:75).

Decode stays host-side (cv2); decoded frames enter the pipeline as numpy
arrays and go up to the card where an element computes on them (resize,
detect).
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
    _HAVE_CV2 = True
except ImportError:                                 # pragma: no cover
    _HAVE_CV2 = False

from ..pipeline import DataSource, DataTarget, PipelineElement, StreamEvent
from .image import as_uint8 as _as_uint8
from .scheme_file import DataSchemeFile

__all__ = ["VideoReadFile", "VideoWriteFile", "VideoSample",
           "VideoOutput", "VideoReadWebcam"]


class VideoReadFile(DataSource):
    """Streams frames from video file(s): one pipeline frame per video
    frame, emitted by a rate-capped generator (reference
    video_io.py:129-198)."""

    def start_stream(self, stream, stream_id):
        if not _HAVE_CV2:
            return StreamEvent.ERROR, {"diagnostic": "cv2 missing"}
        return super().start_stream(stream, stream_id)

    def frame_generator(self, stream):
        capture = stream.variables.get("video_capture")
        if capture is None:
            paths = stream.variables.get("source_paths", [])
            index = stream.variables.get("video_path_index", 0)
            if index >= len(paths):
                return StreamEvent.STOP, {}
            capture = cv2.VideoCapture(paths[index])
            if not capture.isOpened():
                return StreamEvent.ERROR, {
                    "diagnostic": f"cannot open {paths[index]}"}
            stream.variables["video_capture"] = capture
            stream.variables["video_path_index"] = index + 1
        okay, frame = capture.read()
        if not okay:
            capture.release()
            stream.variables["video_capture"] = None
            return self.frame_generator(stream)     # next file or STOP
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        return StreamEvent.OKAY, {"image": rgb}

    def stop_stream(self, stream, stream_id):
        capture = stream.variables.pop("video_capture", None)
        if capture is not None:
            capture.release()
        return super().stop_stream(stream, stream_id)


class VideoWriteFile(DataTarget):
    """Writes ``image`` frames to a video file (reference
    video_io.py:263-337).  Writer opens lazily on the first frame (codec
    from the ``codec`` parameter, default MJPG; rate from ``rate``)."""

    host_inputs = ("image",)    # sink: the engine fetches explicitly

    def process_frame(self, stream, image=None, **inputs):
        if not _HAVE_CV2:
            return StreamEvent.ERROR, {"diagnostic": "cv2 missing"}
        scheme = self.scheme_for(stream)
        if not isinstance(scheme, DataSchemeFile):
            return StreamEvent.ERROR, {
                "diagnostic": "VideoWriteFile requires file:// targets"}
        writer = stream.variables.get("video_writer")
        array = _as_uint8(image)
        if writer is None:
            path = scheme.target_path(stream)
            codec, _ = self.get_parameter("codec", "MJPG")
            rate, _ = self.get_parameter("rate", 30.0)
            fourcc = cv2.VideoWriter_fourcc(*str(codec))
            writer = cv2.VideoWriter(
                path, fourcc, float(rate),
                (array.shape[1], array.shape[0]))
            if not writer.isOpened():
                return StreamEvent.ERROR, {
                    "diagnostic": f"cannot open writer for {path}"}
            stream.variables["video_writer"] = writer
            stream.variables["video_writer_path"] = path
        writer.write(cv2.cvtColor(array, cv2.COLOR_RGB2BGR))
        return StreamEvent.OKAY, {
            "path": stream.variables["video_writer_path"]}

    def stop_stream(self, stream, stream_id):
        writer = stream.variables.pop("video_writer", None)
        if writer is not None:
            writer.release()
        return super().stop_stream(stream, stream_id)


class VideoSample(PipelineElement):
    """Passes every Nth frame (``sample_rate``), drops the rest
    (reference video_io.py:198-215)."""

    def start_stream(self, stream, stream_id):
        stream.variables[f"{self.name}.count"] = 0
        return StreamEvent.OKAY, {}

    def process_frame(self, stream, image=None, **inputs):
        rate, _ = self.get_parameter("sample_rate", 1)
        key = f"{self.name}.count"
        count = stream.variables.get(key, 0)
        stream.variables[key] = count + 1
        if int(rate) > 1 and count % int(rate):
            return StreamEvent.DROP_FRAME, {}
        return StreamEvent.OKAY, {"image": image}


class VideoOutput(PipelineElement):
    """Logs frame shape; passthrough (reference video_io.py:111-129)."""

    def process_frame(self, stream, image=None, **inputs):
        if image is not None:
            self.logger.info("video frame %s",
                             tuple(getattr(image, "shape", ())))
        return StreamEvent.OKAY, {"image": image}


class VideoReadWebcam(DataSource):
    """Webcam DataSource (reference webcam_io.py:75): ``webcam://<index>``
    via cv2.VideoCapture(index)."""

    def start_stream(self, stream, stream_id):
        if not _HAVE_CV2:
            return StreamEvent.ERROR, {"diagnostic": "cv2 missing"}
        source, _ = self.get_parameter("data_sources", "webcam://0")
        url = source[0] if isinstance(source, list) else source
        index = int(str(url).rsplit("://", 1)[-1] or 0)
        capture = cv2.VideoCapture(index)
        if not capture.isOpened():
            return StreamEvent.ERROR, {
                "diagnostic": f"cannot open webcam {index}"}
        stream.variables["webcam_capture"] = capture
        rate, _ = self.get_parameter("rate", None)
        self.create_frames(stream, self.frame_generator,
                           rate=float(rate) if rate else None)
        return StreamEvent.OKAY, {}

    def frame_generator(self, stream):
        capture = stream.variables.get("webcam_capture")
        if capture is None:
            return StreamEvent.STOP, {}
        okay, frame = capture.read()
        if not okay:
            return StreamEvent.ERROR, {"diagnostic": "webcam read failed"}
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        return StreamEvent.OKAY, {"image": rgb}

    def stop_stream(self, stream, stream_id):
        capture = stream.variables.pop("webcam_capture", None)
        if capture is not None:
            capture.release()
        return StreamEvent.OKAY, {}
