"""Image elements (reference: src/aiko_services/elements/media/
image_io.py): read/resize/overlay/write.

Counterpart of ``aiko_services_tpu/elements/image.py``.  Decode and
encode are host-side (PIL, behind the same ``_HAVE_PIL`` guard, so the
module imports where Pillow is missing and the file elements then fail
their frame with the JAX package's diagnostic).  The port's
differences:

- readers and ``ImageOverlay`` emit numpy: a host value stays on the
  host until an element computes on it;
- ``ImageResize`` runs on its ``device`` parameter (the port's device
  rule, ``device.py``: the card unless ``cpu`` is asked for), uploading
  a host image -- or a host burst, stacked once -- through pinned
  memory.  It keeps ``jax.image.resize(x.astype(float32), ...,
  "bilinear")``'s numbers: the separable triangle kernel of
  :func:`.audio.resize_linear` along H and then along W (widened by the
  factor when downscaling, renormalised at the edges), with uint8
  images rounded half to even and clipped.  Its ``device_fn`` joins a
  fused segment (``pipeline/fusion.py``: one captured CUDA graph a
  segment on the card).
"""

from __future__ import annotations

import numpy as np
import torch

try:
    from PIL import Image, ImageDraw
    _HAVE_PIL = True
except ImportError:                                 # pragma: no cover
    _HAVE_PIL = False

from ..models.batching import MicroBatchElement, pad_to_bucket
from ..pipeline import DataSource, DataTarget, PipelineElement, StreamEvent
from .audio import _element_device, _to_device, resize_linear
from .scheme_file import DataSchemeFile

__all__ = ["ImageReadFile", "ImageWriteFile", "ImageResize",
           "ImageOverlay", "ImageOutput", "image_to_array",
           "array_to_image", "as_uint8", "resize_image"]


def image_to_array(image) -> np.ndarray:
    """PIL Image -> uint8 numpy [H, W, C] (reference image_io.py:104-125
    conversion helpers)."""
    array = np.asarray(image)
    if array.ndim == 2:
        array = array[:, :, None]
    return array


def as_uint8(image) -> np.ndarray:
    """Any array-like image -> uint8 (floats treated as 0..1 and
    scaled; integer types cast).  The one conversion every image
    writer/detector backend shares.  A tensor is copied to the host
    first (its callers are host elements)."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    array = np.asarray(image)
    if array.dtype == np.uint8:
        return array
    if array.dtype.kind == "f":
        return (np.clip(array, 0.0, 1.0) * 255).astype(np.uint8)
    return array.astype(np.uint8)


def array_to_image(array):
    """numpy array or tensor [H, W, C] (uint8 or float 0..1) -> PIL
    Image."""
    if not _HAVE_PIL:
        raise RuntimeError("Pillow is not installed")
    array = as_uint8(array)
    if array.ndim == 3 and array.shape[-1] == 1:
        array = array[:, :, 0]
    return Image.fromarray(array)


def resize_image(image: torch.Tensor, height: int,
                 width: int) -> torch.Tensor:
    """``jax.image.resize(image.astype(float32), ..., "bilinear")`` on
    [H, W], [H, W, C] or [..., H, W, C] (the leading dims keep their
    size), then, for uint8 input, round half to even and clip to uint8
    (reference image.py:117-131).  An axis whose size does not change
    is left alone, as JAX leaves it."""
    spatial = (0, 1) if image.dim() < 3 else (image.dim() - 3,
                                              image.dim() - 2)
    resized = image.float()
    for dim, size in zip(spatial, (height, width)):
        if resized.shape[dim] != size:
            resized = resize_linear(resized, size, dim)
    if image.dtype == torch.uint8:
        resized = resized.round().clamp(0, 255).to(torch.uint8)
    return resized


class ImageReadFile(DataSource):
    """Reads image file(s) from ``data_sources``; emits ``image`` as a
    uint8 numpy array [H, W, C] (reference image_io.py:278-307)."""

    def process_frame(self, stream, **inputs):
        path = inputs.get("path")
        if not _HAVE_PIL:
            return StreamEvent.ERROR, {"diagnostic": "Pillow missing"}
        try:
            with Image.open(path) as image:
                array = image_to_array(image.convert("RGB"))
        except OSError as error:
            return StreamEvent.ERROR, {"diagnostic": str(error)}
        return StreamEvent.OKAY, {"image": array, "path": path}


class ImageWriteFile(DataTarget):
    """Writes ``image`` to ``data_targets`` path; ``{}`` templates get the
    frame index (reference image_io.py:372-407)."""

    host_inputs = ("image",)    # sink: the engine fetches explicitly

    def process_frame(self, stream, image=None, **inputs):
        scheme = self.scheme_for(stream)
        if not isinstance(scheme, DataSchemeFile):
            return StreamEvent.ERROR, {
                "diagnostic": "ImageWriteFile requires file:// targets"}
        path = scheme.target_path(stream)
        try:
            array_to_image(image).save(path)
        except (OSError, ValueError) as error:
            return StreamEvent.ERROR, {"diagnostic": str(error)}
        return StreamEvent.OKAY, {"path": path}


class ImageResize(MicroBatchElement, PipelineElement):
    """Resize ``image`` to ``width`` x ``height`` parameters -- bilinear
    on the element's ``device`` (reference image_io.py:343-371 does PIL
    resize on host).

    ASYNC by default: frames parked here -- from every stream -- resize
    together as one batched [N, H, W, C] device call (MicroBatcher;
    same admission as the Detector), and each frame's output row stays
    DEVICE-RESIDENT for the next device stage.  A host-side burst
    stacks once and uploads once, through pinned memory on the card.
    Set ``synchronous: true`` for the blocking path.
    """

    is_async = True
    device_resident = True

    def _size(self) -> tuple[int, int] | None:
        width, _ = self.get_parameter("width")
        height, _ = self.get_parameter("height")
        if not width or not height:
            return None
        return int(height), int(width)

    def process_frame(self, stream, image=None, **inputs):
        size = self._size()
        if size is None:
            return StreamEvent.ERROR, {
                "diagnostic": "ImageResize needs width/height parameters"}
        # A host image goes up once; a tensor is never copied to the
        # host here.
        image = _to_device(  # aiko-lint: disable=undeclared-host-input
            image, _element_device(self))
        return StreamEvent.OKAY, {"image": resize_image(image, *size)}

    def device_fn(self, stream):
        """Fused-segment contract: with ``synchronous: true`` the resize
        is a pure device computation (its weights come from device ops,
        never an upload), so a chain of device stages around it runs as
        ONE captured CUDA graph (pipeline/fusion.py)."""
        from ..pipeline import DeviceFn
        size = self._size()
        if size is None:
            return None
        device = _element_device(self)
        return DeviceFn(
            fn=lambda image: {
                "image": resize_image(_to_device(image, device), *size)},
            inputs=("image",), outputs=("image",))

    def process_frame_start(self, stream, complete, image=None, **inputs):
        # With no card and no ``device: cpu`` this raises before the
        # frame parks: the frame fails, not the batch.
        _element_device(self)
        self.submit_microbatch(complete, image, diagnostic="bad image")

    def batch_context(self):
        return _element_device(self)

    def batch_key(self, image):
        # Target size rides the key: streams resizing to different
        # sizes (or from different source shapes) never stack.
        size = self._size()
        if size is None:
            raise ValueError("ImageResize needs width/height parameters")
        if not hasattr(image, "shape"):     # array-likes: numpy metadata
            image = np.asarray(image)
        return size + (tuple(image.shape), str(image.dtype))

    def batch_run(self, context, key, images):
        device = context
        height, width, shape, _ = key
        images = pad_to_bucket(images)
        if all(isinstance(image, np.ndarray) for image in images):
            batch = _to_device(np.stack(images), device)    # one upload
        else:
            batch = torch.stack([_to_device(image, device)
                                 for image in images])
        if len(shape) == 2:             # grayscale: batch as [N, H, W, 1]
            batch = batch[..., None]
        return resize_image(batch, height, width)

    def batch_finish(self, context, key, entries, result):
        if len(key[2]) == 2:
            result = result[..., 0]     # undo the grayscale channel dim
        for row, (complete, _) in enumerate(entries):
            # Row slices stay device-resident: the next device stage
            # consumes them without any host round trip.
            complete(StreamEvent.OKAY, {"image": result[row]})


class ImageOverlay(PipelineElement):
    """Draw detection overlays onto ``image``.

    ``overlay`` is ``{"rectangles": [{"x": .., "y": .., "w": .., "h": ..,
    "name": ..}], "texts": [...]}`` in relative (0..1) or absolute pixel
    coordinates (reference image_io.py:164-234 draws via PIL on host, as
    this does; the drawn image is a numpy array).
    """

    # PIL drawing is host work: declare it, so the engine fetches the
    # image with ONE counted fetch instead of an implicit sync.
    host_inputs = ("image",)

    def process_frame(self, stream, image=None, overlay=None, **inputs):
        if overlay is None:
            return StreamEvent.OKAY, {"image": image}
        if not _HAVE_PIL:
            return StreamEvent.ERROR, {"diagnostic": "Pillow missing"}
        pil = array_to_image(image)
        if pil.mode != "RGB":
            pil = pil.convert("RGB")
        draw = ImageDraw.Draw(pil)
        h, w = pil.height, pil.width
        color, _ = self.get_parameter("color", "red")
        for rect in overlay.get("rectangles", []):
            x, y = float(rect["x"]), float(rect["y"])
            rw, rh = float(rect["w"]), float(rect["h"])
            if max(x, y, rw, rh) <= 1.0:        # relative coordinates
                x, y, rw, rh = x * w, y * h, rw * w, rh * h
            draw.rectangle([x, y, x + rw, y + rh], outline=color,
                           width=2)
            name = rect.get("name")
            if name:
                draw.text((x + 2, max(0, y - 12)), str(name), fill=color)
        for text in overlay.get("texts", []):
            draw.text((float(text.get("x", 4)), float(text.get("y", 4))),
                      str(text.get("text", "")), fill=color)
        return StreamEvent.OKAY, {"image": np.asarray(pil)}


class ImageOutput(PipelineElement):
    """Logs image shape/dtype; passthrough (reference
    image_io.py:149-163)."""

    def process_frame(self, stream, image=None, **inputs):
        if image is not None:
            self.logger.info("image %s %s",
                             tuple(getattr(image, "shape", ())),
                             getattr(image, "dtype", type(image)))
        return StreamEvent.OKAY, {"image": image}
