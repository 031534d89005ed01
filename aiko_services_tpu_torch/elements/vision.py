"""Classical-CV detector elements: faces and ArUco fiducial markers
(reference: src/aiko_services/examples/face/face.py:52 FaceDetector,
examples/aruco_marker/aruco.py:80 ArucoMarkerDetector, :136
ArucoMarkerOverlay).

These are host-side cv2 detectors -- the work is small and pre-neural
(Haar cascade, fiducial decoding), so there is nothing to put on the
TPU; the JAX :class:`~aiko_services_tpu_torch.elements.detect.Detector` is the
accelerated path for learned detection.  Both emit the standard overlay
dict (``{"rectangles": [...], "texts": [...]}``) so the existing
:class:`ImageOverlay` draws them with no extra element -- the reference
needed a separate ArucoMarkerOverlay drawing via cv2 lines; here the
polygon corners are also passed through for consumers that want the
exact quadrilateral.

cv2 is a gated import like the reference: the module loads without it,
elements error per-stream with a diagnostic.
"""

from __future__ import annotations

import numpy as np

from ..pipeline import PipelineElement, StreamEvent
from ..pipeline.stream import Stream

__all__ = ["FaceDetect", "ArucoMarkerDetect"]

try:
    import cv2
    _HAVE_CV2 = True
except ImportError:                                 # pragma: no cover
    _HAVE_CV2 = False


def _to_gray(array: np.ndarray) -> np.ndarray:
    if array.ndim == 2:
        return array
    return cv2.cvtColor(array, cv2.COLOR_RGB2GRAY)


from .image import as_uint8 as _as_uint8


class _CascadeBackend:
    """Haar cascade (cv2 4.x; removed in the cv2 5 objdetect split)."""

    def __init__(self, element):
        path, found = element.get_parameter("cascade")
        if not found:
            path = (cv2.data.haarcascades
                    + "haarcascade_frontalface_default.xml")
        self._cascade = cv2.CascadeClassifier(path)
        if self._cascade.empty():
            raise RuntimeError(f"cannot load face cascade {path}")
        scale, _ = element.get_parameter("scale_factor", 1.1)
        neighbors, _ = element.get_parameter("min_neighbors", 5)
        min_size, _ = element.get_parameter("min_size", 24)
        self._kwargs = {"scaleFactor": float(scale),
                        "minNeighbors": int(neighbors),
                        "minSize": (int(min_size), int(min_size))}

    def detect(self, array: np.ndarray) -> np.ndarray:
        boxes = self._cascade.detectMultiScale(_to_gray(array),
                                               **self._kwargs)
        return np.asarray(boxes).reshape(-1, 4)


class _YuNetBackend:
    """cv2.FaceDetectorYN -- the cv2 5.x face path; needs an ONNX model
    file supplied via the ``model`` element parameter."""

    def __init__(self, element):
        model, found = element.get_parameter("model")
        if not found:
            raise RuntimeError(
                "this cv2 build has no CascadeClassifier; supply a "
                "YuNet ONNX file via the 'model' parameter")
        threshold, _ = element.get_parameter("score_threshold", 0.8)
        self._detector = cv2.FaceDetectorYN_create(
            str(model), "", (0, 0), float(threshold))

    def detect(self, array: np.ndarray) -> np.ndarray:
        if array.ndim == 2:
            array = cv2.cvtColor(array, cv2.COLOR_GRAY2BGR)
        height, width = array.shape[:2]
        self._detector.setInputSize((width, height))
        _, faces = self._detector.detect(array)
        if faces is None:
            return np.zeros((0, 4))
        return np.asarray(faces)[:, :4]             # x y w h (+landmarks)


def _default_face_backend(element):
    if not _HAVE_CV2:
        raise RuntimeError("cv2 missing")
    if hasattr(cv2, "CascadeClassifier"):
        return _CascadeBackend(element)
    return _YuNetBackend(element)


# Injectable: callable(element) -> object with detect(ndarray) -> [N, 4].
face_backend_factory = _default_face_backend


class FaceDetect(PipelineElement):
    """``image`` -> ``overlay`` rectangles around detected faces +
    ``faces`` list (reference face.py:52, which runs deepface/retinaface;
    here a pluggable cv2 backend -- Haar cascade where the build has it,
    YuNet via the ``model`` parameter on cv2 5.x -- same output
    contract).

    Parameters: ``scale_factor`` (default 1.1), ``min_neighbors`` (5),
    ``min_size`` (24), ``cascade``/``model`` (backend files).
    Cumulative detection count is shared as ``{element}.detections``
    (reference ``self.share["detections"]``)."""

    host_inputs = ("image",)    # cv2 runs on host: one counted fetch

    def __init__(self, context):
        super().__init__(context)
        self._backend = None
        self._detections = 0

    def process_frame(self, stream: Stream, image=None, **inputs):
        try:
            if self._backend is None:
                self._backend = face_backend_factory(self)
        except Exception as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"face backend unavailable: {error}"}
        array = _as_uint8(image)
        try:
            boxes = self._backend.detect(array)
        except Exception as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"face detection failed: {error}"}
        height, width = array.shape[:2]
        rectangles, faces = [], []
        for (x, y, w, h) in np.asarray(boxes).reshape(-1, 4):
            rectangles.append({"x": x / width, "y": y / height,
                               "w": w / width, "h": h / height,
                               "name": "face"})
            faces.append({"x": int(x), "y": int(y),
                          "w": int(w), "h": int(h)})
        self._detections += len(faces)
        producer = getattr(self.pipeline, "ec_producer", None)
        if producer is not None:
            producer.update(f"{self.name}.detections", self._detections)
        return StreamEvent.OKAY, {
            "image": image,
            "overlay": {"rectangles": rectangles},
            "faces": faces}


class ArucoMarkerDetect(PipelineElement):
    """``image`` -> ``markers`` (id + corner quadrilateral) + standard
    ``overlay`` (bounding rectangle labelled ``aruco <id>`` per marker)
    (reference aruco.py:80-136).

    Parameter ``aruco_tags`` selects the dictionary by its cv2 name
    (default ``DICT_4X4_50``, the reference default)."""

    host_inputs = ("image",)    # cv2 runs on host: one counted fetch

    def __init__(self, context):
        super().__init__(context)
        self._detector = None
        self._tags = None

    def _marker_detector(self):
        tags, _ = self.get_parameter("aruco_tags", "DICT_4X4_50")
        if self._detector is None or tags != self._tags:
            table = getattr(cv2.aruco, str(tags), None)
            if table is None:
                raise RuntimeError(f"unknown ArUco dictionary {tags!r}")
            dictionary = cv2.aruco.getPredefinedDictionary(table)
            self._detector = cv2.aruco.ArucoDetector(
                dictionary, cv2.aruco.DetectorParameters())
            self._tags = tags
        return self._detector

    def process_frame(self, stream: Stream, image=None, **inputs):
        if not _HAVE_CV2:
            return StreamEvent.ERROR, {"diagnostic": "cv2 missing"}
        array = _as_uint8(image)
        try:
            corners, ids, _rejected = \
                self._marker_detector().detectMarkers(_to_gray(array))
        except (cv2.error, RuntimeError) as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"aruco detection failed: {error}"}
        height, width = array.shape[:2]
        markers, rectangles = [], []
        if ids is not None:
            for quad, marker_id in zip(corners, np.asarray(ids).flatten()):
                points = np.asarray(quad).reshape(4, 2)
                markers.append({"id": int(marker_id),
                                "corners": points.tolist()})
                x1, y1 = points.min(axis=0)
                x2, y2 = points.max(axis=0)
                rectangles.append({
                    "x": float(x1) / width, "y": float(y1) / height,
                    "w": float(x2 - x1) / width,
                    "h": float(y2 - y1) / height,
                    "name": f"aruco {int(marker_id)}"})
        return StreamEvent.OKAY, {
            "image": image,
            "overlay": {"rectangles": rectangles},
            "markers": markers}
