"""The port's image elements (``aiko_services_tpu_torch/elements/
image.py``) held against the JAX package's on the same seeded numpy
inputs: ``ImageResize`` (``jax.image.resize(..., "bilinear")`` on
float32, antialiased when it downscales) down and up, square and not,
at factors that are not integers, uint8 and float32, RGB and grayscale,
one image and the batched ``[N, H, W, C]`` form; ``as_uint8`` and
``array_to_image``; and the device rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.elements import image as jax_image
from aiko_services_tpu.pipeline.element import ElementContext as JaxContext
from aiko_services_tpu_torch.elements import image
from aiko_services_tpu_torch.pipeline.element import ElementContext

# float32 taps summed in another order than XLA's dense product, on
# values from 0 to 255
FLOAT_TOL = 1e-3
# uint8: a value within that tolerance of a .5 boundary may round the
# other way
UINT8_EQUAL_SHARE = 0.999


class _FakePipeline:
    def current_stream(self):
        return None

    def get_pipeline_parameter(self, name, default=None):
        return default


def _ours(cls, parameters):
    return cls(ElementContext("e", None, _FakePipeline(),
                              {"device": "cpu", **parameters}))


def _theirs(cls, parameters):
    return cls(JaxContext("e", None, _FakePipeline(), parameters))


def _input(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return (rng.random(shape) * 255.0).astype(dtype)


def assert_images_close(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    if theirs.dtype == np.uint8:
        difference = np.abs(ours.astype(np.int16) - theirs.astype(np.int16))
        assert difference.max() <= 1
        assert (difference == 0).mean() >= UINT8_EQUAL_SHARE
    else:
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=FLOAT_TOL)


RESIZE_CASES = [
    # (input shape, dtype, (height, width))
    ((64, 64, 3), np.uint8, (32, 32)),           # downscale by 2
    ((24, 32, 3), np.uint8, (48, 64)),           # upscale by 2
    ((37, 29, 3), np.float32, (16, 21)),         # non-square, x2.3/x1.4
    ((30, 50, 3), np.float32, (71, 43)),         # up in H, down in W
    ((40, 40), np.uint8, (17, 23)),              # grayscale [H, W]
    ((33, 45, 1), np.float32, (19, 90)),         # one channel
    ((3, 24, 32, 3), np.uint8, (12, 40)),        # batched [N, H, W, C]
    ((2, 48, 36, 3), np.float32, (48, 20)),      # H unchanged
    ((576, 576, 3), np.uint8, (512, 512)),       # the fusion chain's R1
]


@pytest.mark.parametrize("shape, dtype, size", RESIZE_CASES)
def test_resize_matches_jax(shape, dtype, size):
    height, width = size
    parameters = {"width": width, "height": height, "synchronous": True}
    source = _input(shape, dtype, seed=len(shape) * 100 + shape[0])
    _, theirs = _theirs(jax_image.ImageResize, parameters).process_frame(
        None, image=source)
    event, ours = _ours(image.ImageResize, parameters).process_frame(
        None, image=source)
    assert isinstance(ours["image"], torch.Tensor)
    assert_images_close(ours["image"].numpy(), theirs["image"])


@pytest.mark.parametrize("shape, dtype", [
    ((32, 32, 3), np.uint8), ((20, 28), np.uint8),
    ((25, 19, 3), np.float32)])
def test_resize_batch_run_matches_jax(shape, dtype):
    """The micro-batched path: a host burst stacked once (grayscale as
    [N, H, W, 1]), padded to its bucket, resized as one call."""
    parameters = {"width": 16, "height": 12}
    images = [_input(shape, dtype, seed=i) for i in range(3)]
    theirs_element = _theirs(jax_image.ImageResize, parameters)
    ours_element = _ours(image.ImageResize, parameters)
    key = ours_element.batch_key(images[0])
    assert key == theirs_element.batch_key(images[0])
    theirs = theirs_element.batch_run(None, key, images)
    ours = ours_element.batch_run(ours_element.batch_context(), key, images)
    assert ours.shape[0] == 4                    # padded to the bucket
    assert_images_close(ours.numpy(), theirs)


def test_resize_device_fn_matches_process_frame():
    parameters = {"width": 20, "height": 10, "synchronous": True}
    element = _ours(image.ImageResize, parameters)
    source = torch.from_numpy(_input((30, 40, 3), np.uint8, seed=5))
    dfn = element.device_fn(None)
    assert dfn.inputs == ("image",) and dfn.outputs == ("image",)
    _, sync_out = element.process_frame(None, image=source)
    assert torch.equal(dfn.fn(image=source)["image"], sync_out["image"])


def test_resize_without_size_is_frame_error():
    element = _ours(image.ImageResize, {})
    event, outputs = element.process_frame(None, image=np.zeros((4, 4, 3)))
    assert "width/height" in outputs["diagnostic"]
    assert element.device_fn(None) is None


def test_resize_device_rule():
    """No ``device`` and no card: the element raises instead of running
    on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    element = image.ImageResize(ElementContext(
        "e", None, _FakePipeline(), {"width": 4, "height": 4}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        element.process_frame(None, image=np.zeros((8, 8, 3), np.uint8))


@pytest.mark.parametrize("source", [
    np.linspace(-0.5, 1.5, 24, dtype=np.float32).reshape(2, 4, 3),
    np.arange(24, dtype=np.int32).reshape(2, 4, 3) * 11,
    np.arange(24, dtype=np.uint8).reshape(2, 4, 3)])
def test_as_uint8_matches_jax(source):
    ours = image.as_uint8(source)
    np.testing.assert_array_equal(ours, jax_image.as_uint8(source))
    assert ours.dtype == np.uint8
    # A tensor converts as its host array does.
    np.testing.assert_array_equal(
        image.as_uint8(torch.from_numpy(source)), ours)
    np.testing.assert_array_equal(
        jax_image.as_uint8(jnp.asarray(source)), ours)


@pytest.mark.skipif(not image._HAVE_PIL, reason="Pillow missing")
@pytest.mark.parametrize("shape", [(6, 5, 3), (6, 5, 1)])
def test_array_to_image_matches_jax(shape):
    source = _input(shape, np.uint8, seed=9)
    ours = image.array_to_image(torch.from_numpy(source))
    theirs = jax_image.array_to_image(source)
    assert ours.mode == theirs.mode and ours.size == theirs.size
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))


def test_overlay_draws_on_host():
    overlay = _ours(image.ImageOverlay, {})
    frame = torch.zeros((20, 20, 3), dtype=torch.uint8)
    rectangles = {"rectangles": [
        {"x": 0.1, "y": 0.1, "w": 0.5, "h": 0.5, "name": "cat"}]}
    _, ours = overlay.process_frame(None, image=frame, overlay=rectangles)
    _, theirs = _theirs(jax_image.ImageOverlay, {}).process_frame(
        None, image=np.zeros((20, 20, 3), np.uint8), overlay=rectangles)
    assert isinstance(ours["image"], np.ndarray)    # stays on the host
    np.testing.assert_array_equal(ours["image"], np.asarray(theirs["image"]))
