"""The port's face and ArUco detector elements (reference
examples/face/face.py:52, examples/aruco_marker/aruco.py:80,136)
through real pipelines: twins of ``tests/test_vision.py`` (host cv2;
the module is a copy of the JAX package's, ``as_uint8`` the port's)."""

import queue

import numpy as np
import pytest

from conftest import run_until
from test_torch_llm_element import _port_runtime, _port_teardown
from test_torch_media import definition, element

from aiko_services_tpu_torch.pipeline import Pipeline

cv2 = pytest.importorskip("cv2")


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


def run_frame(runtime, pipeline, frame_data, timeout=10.0):
    responses = queue.Queue()
    pipeline.process_frame_local(frame_data, queue_response=responses)
    assert run_until(runtime, lambda: not responses.empty(),
                     timeout=timeout)
    _, _, swag, _, okay, diagnostic = responses.get()
    return swag, okay, diagnostic


def aruco_scene(marker_id=7, tags="DICT_4X4_50", size=64, pad=24):
    """A real rendered ArUco marker pasted on a white background."""
    dictionary = cv2.aruco.getPredefinedDictionary(
        getattr(cv2.aruco, tags))
    marker = cv2.aruco.generateImageMarker(dictionary, marker_id, size)
    canvas = np.full((size + 2 * pad, size + 2 * pad), 255, np.uint8)
    canvas[pad:pad + size, pad:pad + size] = marker
    return np.repeat(canvas[:, :, None], 3, axis=2)    # RGB


def test_aruco_detects_rendered_marker(runtime):
    pipeline = Pipeline(definition(
        ["(Aruco)"],
        [element("Aruco", "ArucoMarkerDetect", ["image"],
                 ["image", "overlay", "markers"])],
        name="p_aruco"), runtime=runtime)
    swag, okay, diagnostic = run_frame(runtime, pipeline,
                                       {"image": aruco_scene(7)})
    assert okay, diagnostic
    markers = swag["markers"]
    assert len(markers) == 1
    assert markers[0]["id"] == 7
    corners = np.asarray(markers[0]["corners"])
    assert corners.shape == (4, 2)
    # The marker sits at pad..pad+size in a 112px image.
    assert 16 <= corners[:, 0].min() <= 32
    rect = swag["overlay"]["rectangles"][0]
    assert rect["name"] == "aruco 7"
    assert 0.0 < rect["x"] < 1.0 and 0.0 < rect["w"] <= 1.0


def test_aruco_dictionary_parameter(runtime):
    """A 5x5 marker is invisible to a 4x4 detector and found by a 5x5
    detector selected via the aruco_tags parameter."""
    scene = aruco_scene(3, tags="DICT_5X5_50")
    p4 = Pipeline(definition(
        ["(Aruco)"],
        [element("Aruco", "ArucoMarkerDetect", ["image"], ["markers"])],
        name="p_aruco4"), runtime=runtime)
    swag, okay, _ = run_frame(runtime, p4, {"image": scene})
    assert okay and swag["markers"] == []

    p5 = Pipeline(definition(
        ["(Aruco)"],
        [element("Aruco", "ArucoMarkerDetect", ["image"], ["markers"],
                 {"aruco_tags": "DICT_5X5_50"})],
        name="p_aruco5"), runtime=runtime)
    swag, okay, _ = run_frame(runtime, p5, {"image": scene})
    assert okay and [m["id"] for m in swag["markers"]] == [3]


def test_aruco_unknown_dictionary_is_frame_error(runtime):
    pipeline = Pipeline(definition(
        ["(Aruco)"],
        [element("Aruco", "ArucoMarkerDetect", ["image"], ["markers"],
                 {"aruco_tags": "DICT_BOGUS"})],
        name="p_aruco_err"), runtime=runtime)
    _, okay, diagnostic = run_frame(runtime, pipeline,
                                    {"image": aruco_scene()})
    assert not okay
    assert "DICT_BOGUS" in diagnostic


def test_face_detect_blank_image(runtime):
    """With a Haar-cascade cv2 build a blank image yields the
    empty-but-well-formed output contract; on cascade-less cv2 5.x the
    element degrades to a per-frame diagnostic (not a crash)."""
    pipeline = Pipeline(definition(
        ["(Face)"],
        [element("Face", "FaceDetect", ["image"],
                 ["image", "overlay", "faces"])],
        name="p_face0"), runtime=runtime)
    image = np.full((60, 80, 3), 128, np.uint8)
    swag, okay, diagnostic = run_frame(runtime, pipeline, {"image": image})
    if hasattr(cv2, "CascadeClassifier"):
        assert okay, diagnostic
        assert swag["faces"] == []
        assert swag["overlay"] == {"rectangles": []}
    else:
        assert not okay
        assert "model" in diagnostic


def test_face_detect_reports_boxes_and_share_counter(runtime, monkeypatch):
    """Detection boxes surface as relative overlay rectangles and the
    cumulative count lands in the pipeline share dict (reference
    face.py: self.share['detections'])."""
    from aiko_services_tpu_torch.elements import vision

    class FakeBackend:
        def detect(self, array):
            return np.array([[10, 5, 20, 30]])      # x y w h pixels

    monkeypatch.setattr(vision, "face_backend_factory",
                        lambda elem: FakeBackend())
    pipeline = Pipeline(definition(
        ["(Face Draw)"],
        [element("Face", "FaceDetect", ["image"], ["image", "overlay"]),
         element("Draw", "ImageOverlay", ["image", "overlay"], ["image"])],
        name="p_face1"), runtime=runtime)
    image = np.zeros((50, 100, 3), np.uint8)
    swag, okay, diagnostic = run_frame(runtime, pipeline, {"image": image})
    assert okay, diagnostic
    rect = swag["Face.overlay"]["rectangles"][0]
    assert rect == {"x": 0.1, "y": 0.1, "w": 0.2, "h": 0.6,
                    "name": "face"}
    assert pipeline.share["Face"]["detections"] == 1
    # the overlay element consumed the rectangles and drew onto the image
    assert np.asarray(swag["image"]).any()
