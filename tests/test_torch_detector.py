"""The port's detector: twins of ``tests/test_detector.py`` on
``aiko_services_tpu_torch.models.detector`` (``device="cpu"``), and its
parity with the JAX package's on the same weights (carried by
``models/bridge.py``) and the same numpy inputs.

Tolerances, float32 on both sides (the two differ in convolution
summation order only): ``forward`` per scale within 1e-4 of the scale's
max |value|; ``decode`` within 1e-5; ``nms`` on shared boxes and scores
exact in ``valid``, ``classes`` and order; ``detect`` end to end exact
in ``valid`` and ``classes``, boxes and scores within 1e-4.  At 96x80
the stride-2 convolutions see odd sizes (XLA's SAME padding (1, 1)
beside (0, 1)) and P5 -> P4 is 3 -> 5 wide, not 2x (the half-pixel
nearest resize).  bf16 on both sides: each scale within 0.05 of its
max |value|, a few bf16 steps of the activations."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_until
from torch_pipeline_elements import cpu_pool  # noqa: F401

from aiko_services_tpu.models import detector as jax_detector
from aiko_services_tpu_torch.models import bridge, detector
from aiko_services_tpu_torch.pipeline import Pipeline

CPU = torch.device("cpu")
SIZES = [(64, 64), (96, 80)]
# The JAX package's functions, jitted once a config and shape (an eager
# op-by-op run compiles every op apart, and takes longer).
JAX_FORWARD = jax.jit(jax_detector.forward, static_argnums=1)
JAX_DECODE = jax.jit(jax_detector.decode, static_argnums=(0, 2))
JAX_NMS = jax.jit(jax_detector.nms, static_argnums=0)
JAX_INIT = jax.jit(jax_detector.init_params, static_argnums=1)


@pytest.fixture
def runtime():
    """Fresh isolated process runtime of the port on its in-memory
    loopback broker."""
    from aiko_services_tpu_torch.transport import reset_broker
    from aiko_services_tpu_torch.runtime import init_process, reset_process
    from aiko_services_tpu_torch.services.share import reset_services_cache

    reset_broker()
    reset_services_cache()
    rt = init_process(transport="loopback")
    rt.initialize()
    yield rt
    rt.engine.terminate()
    reset_process()
    reset_services_cache()
    reset_broker()


def _tiny(dtype="float32", **overrides):
    return (dataclasses.replace(jax_detector.DetectorConfig.tiny(),
                                dtype=dtype, **overrides),
            dataclasses.replace(detector.DetectorConfig.tiny(),
                                dtype=dtype, **overrides))


def _weights(jax_config, port_config, seed=0):
    """The JAX package's random weights, and the same through numpy on
    the port's side."""
    params = JAX_INIT(jax.random.PRNGKey(seed), jax_config)
    tree = jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf, np.float32), params)
    return params, bridge.detector_params_from_numpy(tree, port_config,
                                                     device="cpu")


def _images(shape, seed=1):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# -- twins of tests/test_detector.py -----------------------------------------

def test_forward_shapes():
    config = detector.DetectorConfig.tiny()
    params = detector.init_params(0, config, CPU)
    images = torch.zeros((2, 64, 64, 3), dtype=torch.float32)
    predictions = detector.forward(params, config, images)
    assert [tuple(p.shape) for p in predictions] == [
        (2, 8, 8, 4 + config.num_classes),
        (2, 4, 4, 4 + config.num_classes),
        (2, 2, 2, 4 + config.num_classes)]


def test_decode_boxes_in_bounds():
    config = detector.DetectorConfig.tiny()
    params = detector.init_params(0, config, CPU)
    images = torch.from_numpy(_images((1, 64, 64, 3)))
    boxes, scores = detector.decode(
        config, detector.forward(params, config, images), (64, 64))
    assert boxes.shape == (1, 8 * 8 + 4 * 4 + 2 * 2, 4)
    assert scores.shape[-1] == config.num_classes
    # centers inside the image; box widths positive
    assert bool((boxes[..., 2] >= boxes[..., 0]).all())
    assert bool((boxes[..., 3] >= boxes[..., 1]).all())


def test_nms_suppresses_overlaps():
    config = detector.DetectorConfig.tiny(num_classes=2)
    boxes = torch.tensor([[0.1, 0.1, 0.5, 0.5],
                          [0.12, 0.12, 0.52, 0.52],     # overlaps first
                          [0.6, 0.6, 0.9, 0.9]])
    scores = torch.tensor([[0.9, 0.0],
                           [0.8, 0.0],
                           [0.0, 0.7]])
    result = detector.nms(config, boxes, scores)
    valid = result["valid"].numpy()
    kept_boxes = result["boxes"].numpy()[valid]
    assert valid.sum() == 2
    np.testing.assert_allclose(kept_boxes[0], [0.1, 0.1, 0.5, 0.5],
                               atol=1e-6)
    np.testing.assert_allclose(kept_boxes[1], [0.6, 0.6, 0.9, 0.9],
                               atol=1e-6)
    assert result["classes"].numpy()[valid].tolist() == [0, 1]


def test_nms_score_threshold():
    config = detector.DetectorConfig.tiny(num_classes=1)
    boxes = torch.tensor([[0.1, 0.1, 0.2, 0.2], [0.5, 0.5, 0.6, 0.6]])
    scores = torch.tensor([[0.9], [0.1]])          # second below 0.25
    result = detector.nms(config, boxes, scores)
    assert result["valid"].numpy().sum() == 1


def test_detect_end_to_end():
    config = detector.DetectorConfig.tiny()
    params = detector.init_params(0, config, CPU)
    images = torch.from_numpy(_images((2, 64, 64, 3)))
    result = detector.detect(params, config, images)
    assert result["boxes"].shape == (2, config.max_detections, 4)
    assert result["valid"].dtype == torch.bool


def test_detector_element_pipeline(runtime, cpu_pool):
    """image -> Detector, end to end through the port's engine (the
    JAX test's file reader, overlay and writer elements are not ported:
    the image is the frame's input and the overlay its output)."""
    pipeline = Pipeline({
        "version": 0, "name": "p_detect", "runtime": "torch",
        "graph": ["(Detect)"], "parameters": {},
        "elements": [{
            "name": "Detect", "input": [{"name": "image"}],
            "output": [{"name": "image"}, {"name": "overlay"},
                       {"name": "detections"}],
            "parameters": {"score_threshold": 0.0},
            "deploy": {"local": {
                "module": "aiko_services_tpu_torch.elements.detect",
                "class_name": "Detector"}}}]},
        runtime=runtime)
    import queue
    responses = queue.Queue()
    image = np.full((64, 64, 3), (128, 90, 40), dtype=np.uint8)
    pipeline.process_frame_local({"image": image}, queue_response=responses)
    assert run_until(runtime, lambda: not responses.empty(), timeout=30.0)
    _, _, swag, _, okay, diagnostic = responses.get()
    assert okay, diagnostic
    assert swag["image"] is image
    rectangles = swag["overlay"]["rectangles"]
    assert len(rectangles) == len(swag["detections"]) > 0
    assert all(0.0 <= r["x"] <= 1.0 and 0.0 <= r["w"] <= 1.0
               for r in rectangles)

    detect_element = pipeline.graph.get_node("Detect").element
    assert detect_element.jit_cache.stats["misses"] == 1


# -- parity with the JAX package ---------------------------------------------

def test_same_padding_matches_xla():
    """XLA's SAME padding: (0, 1) for a stride-2 3x3 on an even size,
    (1, 1) on an odd one; symmetric at stride 1; none for a 1x1."""
    assert detector._same_padding(64, 3, 2) == (0, 1)
    assert detector._same_padding(5, 3, 2) == (1, 1)
    assert detector._same_padding(7, 3, 1) == (1, 1)
    assert detector._same_padding(7, 1, 1) == (0, 0)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_forward_and_decode_match_jax(size):
    jax_config, config = _tiny()
    jax_params, params = _weights(jax_config, config)
    images = _images((2, *size, 3))
    theirs = JAX_FORWARD(jax_params, jax_config, jnp.asarray(images))
    ours = detector.forward(params, config, torch.from_numpy(images))
    for want, got in zip(theirs, ours):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() \
            <= 1e-4 * np.abs(want).max()
    # decode on the SAME raw maps: the decode alone, within 1e-5.
    their_boxes, their_scores = JAX_DECODE(
        jax_config, [jnp.asarray(np.asarray(t)) for t in theirs], size)
    our_boxes, our_scores = detector.decode(
        config, [torch.from_numpy(np.array(t)) for t in theirs], size)
    np.testing.assert_allclose(our_boxes.numpy(), np.asarray(their_boxes),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(our_scores.numpy(),
                               np.asarray(their_scores), rtol=0, atol=1e-5)


def test_nearest_resize_is_half_pixel():
    """P5 -> P4 at 3 -> 5 wide: ``nearest-exact`` picks the JAX
    package's source columns, plain ``nearest`` does not."""
    source = np.arange(6, dtype=np.float32).reshape(1, 2, 3, 1)
    want = np.asarray(jax.image.resize(jnp.asarray(source), (1, 4, 5, 1),
                                       method="nearest"))
    nchw = torch.from_numpy(source).permute(0, 3, 1, 2)
    got = torch.nn.functional.interpolate(nchw, size=(4, 5),
                                          mode="nearest-exact")
    plain = torch.nn.functional.interpolate(nchw, size=(4, 5),
                                            mode="nearest")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert not np.array_equal(plain.permute(0, 2, 3, 1).numpy(), want)


def _nms_inputs(seed, n, classes):
    """Clustered boxes (many overlaps) and scores on a 1/16 grid (many
    ties), shared by both packages."""
    rng = np.random.default_rng(seed)
    centres = rng.random((6, 2)) * 0.8 + 0.1
    pick = rng.integers(0, 6, n)
    xy = centres[pick] + rng.normal(0, 0.03, (n, 2))
    half = rng.random((n, 2)) * 0.1 + 0.05
    boxes = np.concatenate([xy - half, xy + half], -1).astype(np.float32)
    scores = (rng.integers(0, 17, (n, classes)) / 16).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("seed,n", [(0, 200), (1, 40), (2, 9)])
def test_nms_matches_jax(seed, n):
    """Exact ``valid``, ``classes`` and order, batched over images, with
    fewer candidates than the slate at n 9 and 40 (the padded tail); a
    64-slot slate leaves room to see the suppression."""
    jax_config, config = _tiny(max_detections=64)
    images = [_nms_inputs(seed * 10 + index, n, config.num_classes)
              for index in range(3)]
    boxes = np.stack([b for b, _ in images])
    scores = np.stack([s for _, s in images])
    ours = detector.nms(config, torch.from_numpy(boxes),
                        torch.from_numpy(scores))
    for row, (b, s) in enumerate(images):
        theirs = JAX_NMS(jax_config, jnp.asarray(b), jnp.asarray(s))
        assert ours["valid"][row].numpy().tolist() \
            == np.asarray(theirs["valid"]).tolist()
        assert ours["classes"][row].numpy().tolist() \
            == np.asarray(theirs["classes"]).tolist()
        np.testing.assert_array_equal(ours["boxes"][row].numpy(),
                                      np.asarray(theirs["boxes"]))
        np.testing.assert_array_equal(ours["scores"][row].numpy(),
                                      np.asarray(theirs["scores"]))
    assert 0 < int(ours["valid"].sum()) < ours["valid"].numel()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_detect_matches_jax(size):
    jax_config, config = _tiny()
    jax_params, params = _weights(jax_config, config)
    images = _images((3, *size, 3), seed=5)
    theirs = jax_detector.detect(jax_params, jax_config, jnp.asarray(images))
    ours = detector.detect(params, config, torch.from_numpy(images))
    assert ours["valid"].numpy().tolist() \
        == np.asarray(theirs["valid"]).tolist()
    assert ours["classes"].numpy().tolist() \
        == np.asarray(theirs["classes"]).tolist()
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(ours[name].numpy(),
                                   np.asarray(theirs[name]), rtol=0,
                                   atol=1e-4)


def test_forward_matches_jax_in_bf16():
    jax_config, config = _tiny("bfloat16")
    jax_params, _ = _weights(jax_config, config)
    tree = jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf, np.float32), jax_params)
    params = bridge.detector_params_from_numpy(tree, config, device="cpu")
    assert params["stem"]["w"].dtype == torch.bfloat16
    images = _images((2, 64, 64, 3), seed=3)
    theirs = JAX_FORWARD(jax_params, jax_config, jnp.asarray(images))
    ours = detector.forward(params, config, torch.from_numpy(images))
    for want, got in zip(theirs, ours):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() \
            <= 0.05 * np.abs(want).max()


def test_bridge_checks_the_layout():
    jax_config, config = _tiny()
    tree = jax.tree_util.tree_map(
        np.asarray, JAX_INIT(jax.random.PRNGKey(0), jax_config))
    params = bridge.detector_params_from_numpy(tree, config, device="cpu")
    assert tuple(params["stem"]["w"].shape) == (8, 3, 3, 3)    # OIHW
    assert params["stem"]["w"].is_contiguous(
        memory_format=torch.channels_last)
    del tree["lateral3"]
    with pytest.raises(ValueError, match="does not hold"):
        bridge.detector_params_from_numpy(tree, config, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        bridge.detector_params_from_numpy(
            jax.tree_util.tree_map(
                np.asarray, JAX_INIT(jax.random.PRNGKey(0),
                                     dataclasses.replace(jax_config,
                                                         width=4))),
            config, device="cpu")
