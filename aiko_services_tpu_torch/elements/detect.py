"""Detection PipelineElement (BASELINE configs 2 and 4; reference
equivalent: examples/yolo/yolo.py:50-93 YoloDetector wrapping
ultralytics/torch).

Counterpart of ``aiko_services_tpu/elements/detect.py`` on the port's
``models.detector``.  ``Detector`` hosts the detector on its placed
device: weights drawn at first use and put there (``self.put``),
forward+decode+NMS captured once per input signature as a CUDA graph
(``self.jit``, ``pipeline/tensor.py`` ``JitCache``), detections emitted
as the same overlay dict the reference's elements feed ImageOverlay
(yolo.py:80-92).  The port's differences:

- ``checkpoint`` names a port checkpoint (``models/checkpoint.py``,
  ``python -m aiko_services_tpu_torch convert detector``), restored onto
  the placed device against the tree's shapes; after
  ``on_replacement`` the weights rebuild from it, not from random init;
- the devices are the placement's: the weights are put once on every
  card of the stage (``plan.put(params, P())``; one card listed at
  several positions holds them once), and a micro-batch splits over
  the stage's positions -- padded to a multiple of their count, so a
  lone frame splits too, each position's rows run on its card and the
  padding rows dropped at ``batch_finish``.  The positions dispatch in
  turn from the worker thread (their work is independent: no
  collective), so two positions that list one card never replay one
  captured graph at once.  The synchronous path and ``device_fn`` (a
  fused segment) run on the stage's lead card (``plan.device``).  The
  card by default, CPU descriptors of the tests' device pool on the
  CPU;
- the micro-batch worker runs its uploads, detect and host copies on a
  CUDA stream of its own on each card, so detect overlaps the work the
  other threads enqueue (the ``LLM`` element's blocks); a host burst is
  stacked once in pinned memory and each position's rows uploaded from
  it once, and each card's result comes back by asynchronous copies
  into pinned memory, waited for once a card;
- the transfer guard is process-wide (``device.sync_guard``): the one
  wait for a batch's result (after its event) and the synchronous
  path's fetch run with it lifted (``device.sync_allowed``), so a
  detector beside an ``LLM`` worker ticking under ``transfer_guard:
  disallow`` never trips it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import sync_allowed
from ..models import detector
from ..models.batching import MicroBatchElement, _HostTree, pad_to_bucket
from ..models.checkpoint import restore_or_init
from ..parallel.mesh import P, _placed
from ..pipeline import StreamEvent, TPUElement

__all__ = ["Detector"]

_DEFAULT_CLASSES = ["person", "robot_dog", "ball", "obstacle"]


class Detector(MicroBatchElement, TPUElement):
    """image [H, W, 3] uint8/float -> ``overlay`` rectangles +
    ``detections`` list.

    Parameters: ``num_classes``, ``class_names``, ``score_threshold``,
    ``width``, ``seed``, ``max_batch``, ``synchronous``, ``checkpoint``
    (a port checkpoint directory with {"params": ...}).

    ASYNC by default: each frame parks and joins a cross-stream
    MICRO-BATCH (models/batching.py MicroBatcher) -- all frames
    submitted in one event-loop burst, from every stream, detect
    together as a single [N, H, W, 3] dispatch, flushed when the
    engine's mailbox drains so a lone frame pays no extra latency.
    Grouping keys on the PRE-UPLOAD image signature, so a host-side
    burst stacks as ONE np.stack + ONE host->device upload (uint8
    bytes; the float conversion runs batched on device) instead of a
    per-frame upload.  Batches hand off to the MicroBatcher's worker
    thread, which dispatches (including any first-use graph capture)
    and fetches the whole result dict in ONE wait -- the event loop
    never blocks on detect device work, so frame k+1's burst collects
    while batch k runs and downstream stages (LLM decode) overlap
    detect on the device.  Set parameter ``synchronous: true`` for the
    blocking path.
    """

    is_async = True

    def __init__(self, context):
        super().__init__(context)
        self._params = None             # the lead card's weights
        self._placed = None             # every card's (a Placed)
        self._config = None
        self._detect = None
        self._streams = {}              # card -> the worker's stream
        self.position_stats = []        # per position: device, batches, rows

    def on_replacement(self):
        super().on_replacement()
        # Flush queued batches against the OLD weights first (they
        # dispatch against the snapshot they were built with, or fail
        # cleanly if those weights' devices died), then retire the
        # worker -- it referenced the old params.
        self.stop_microbatcher()
        self._params = None             # _ensure_model reloads on the
        self._placed = None             # replacement submesh
        self._detect = None
        self._streams = {}

    def _ensure_model(self):
        if self._params is not None:
            return
        names, names_found = self.get_parameter("class_names",
                                                _DEFAULT_CLASSES)
        threshold, _ = self.get_parameter("score_threshold", 0.25)
        width, _ = self.get_parameter("width", 8)
        self._class_names = list(names)
        num_classes, nc_found = self.get_parameter(
            "num_classes", len(self._class_names))
        num_classes = int(num_classes)
        if names_found and nc_found \
                and num_classes != len(self._class_names):
            raise ValueError(
                f"num_classes={num_classes} conflicts with "
                f"{len(self._class_names)} class_names")
        self._config = detector.DetectorConfig(
            num_classes=num_classes, width=int(width),
            score_threshold=float(threshold), max_detections=32)
        checkpoint, found = self.get_parameter("checkpoint", None)
        seed, _ = self.get_parameter("seed", 0)
        plan = self.plan
        self._placed = plan.put(restore_or_init(
            detector, self._config, int(seed),
            checkpoint if found else None, _placed(plan.device)), P())
        self._params = self._placed.first_shard()
        self.position_stats = [{"device": str(device), "batches": 0,
                                "rows": 0}
                               for device in plan.mesh.devices.flat]
        config = self._config
        self._detect = self.jit(
            lambda params, images: detector.detect(params, config, images))

    def _preprocess(self, image):
        """image -> [H, W, 3] float32 in [0, 1] on this element's
        device."""
        if not isinstance(image, torch.Tensor):
            image = np.asarray(image)
        array = self.put(image)
        if array.dtype == torch.uint8:
            array = array.float() / 255.0
        return array[0] if array.dim() == 4 else array

    def batch_key(self, image):
        """Pre-upload grouping key: the RAW (shape, dtype) after the
        leading batch-dim squeeze, computed from host metadata alone --
        no device work at submit time.  Keying on the raw dtype keeps
        normalization per-group correct (a uint8 group divides by 255
        batched on device; a float group passes through); after
        preprocessing both land on the same float32 signature, so
        splitting them costs no extra graph."""
        if not hasattr(image, "shape"):
            # Array-likes (nested lists) keyed via numpy metadata; the
            # worker converts the payload itself.
            image = np.asarray(image)
        shape = tuple(image.shape)
        if len(shape) == 4:
            shape = shape[1:]
        return shape, str(image.dtype)

    def batch_context(self):
        # The model is SNAPSHOTTED with the flush: a queued batch must
        # dispatch against the weights it was built with, never a
        # half-swapped model after on_replacement -- every card's.
        return self._detect, self._placed, self.position_stats

    def _dispatch(self, image):
        """Enqueue the captured detect (asynchronous on the device)."""
        return self._detect(self._params, self._preprocess(image)[None])

    def device_fn(self, stream):
        """Fused-segment contract (with ``synchronous: true``): the
        forward+decode+NMS slate is pure device math, with the weights as
        captured args (never baked-in constants); the overlay/detections
        postprocess is the host ``finalize`` step, fed by ONE
        engine-counted fetch of the slate at the segment boundary.
        ``detector.detect`` runs eagerly here: the segment's own graph
        capture takes it in (a capture cannot nest inside another, so
        never the element's ``JitCache``-wrapped ``_detect``).  A
        segment runs on one device: on a stage over several cards, the
        lead card's weights."""
        from ..pipeline import DeviceFn
        self._ensure_model()
        config = self._config

        def fn(image, params):
            batch = self._preprocess(image)[None]
            return dict(detector.detect(params, config, batch))

        return DeviceFn(
            fn=fn, inputs=("image",),
            captures={"params": self._params},
            finalize=lambda fetched: self._slate_outputs(fetched, 0),
            finalize_inputs=("boxes", "scores", "classes", "valid"),
            finalize_outputs=("overlay", "detections"))

    # -- async micro-batched path ------------------------------------------

    def process_frame_start(self, stream, complete, image=None, **inputs):
        self._ensure_model()
        self.submit_microbatch(complete, image, diagnostic="bad image")

    def _worker_stream(self, device):
        """The worker's own CUDA stream on ``device`` (None on the CPU),
        made on first use and told to wait for the work already enqueued
        on the card's default stream (device-resident frames come from
        there)."""
        if device.type != "cuda":
            return None
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.default_stream(device))
        return stream

    def batch_run(self, context, key, images):
        """Worker side: stack one same-signature group, padded to its
        bucket and to a multiple of the stage's positions, and dispatch
        each position's rows on its card's worker stream, the positions
        in turn.  An all-host group stacks ONCE on host, in pinned
        memory, and each position's rows upload from it once (uint8
        bytes upload raw; the /255 float conversion runs batched on
        device); groups with device-resident frames stack on the lead
        card.  Each card's slate copies to pinned host memory behind
        it."""
        detect, placed, stats = context
        devices = [_placed(device) for device in placed.mesh.devices.flat]
        images = pad_to_bucket(images, multiple=len(devices))
        rows = len(images) // len(devices)
        if all(isinstance(image, np.ndarray) for image in images):
            batch = torch.from_numpy(np.stack(
                [image[0] if image.ndim == 4 else image
                 for image in images]))
            if any(device.type == "cuda" for device in devices):
                batch = batch.pin_memory()
        else:
            batch = torch.stack([self._preprocess(image)
                                 for image in images])
        results = []
        for position, device in enumerate(devices):
            side = self._worker_stream(device)
            with torch.cuda.stream(side) if side is not None \
                    else contextlib.nullcontext():
                part = batch[position * rows:(position + 1) * rows].to(
                    device, non_blocking=True)
                if part.dtype == torch.uint8:
                    part = part.float() / 255.0
                results.append(_HostTree(detect(placed.shards[position],
                                                part)))
            stats[position]["batches"] += 1
            stats[position]["rows"] += rows
        return results

    def batch_finish(self, context, key, entries, result):
        """Wait for the batch's host copies ONCE a card (the
        boxes/scores/classes/valid rows land host-side together -- a
        single wait for each card's rows, not four syncs per frame),
        join the cards' rows in order and complete each frame from its
        row (the padding rows are dropped)."""
        try:
            with sync_allowed():
                parts = [part.numpy() for part in result]
            fetched = {name: np.concatenate([part[name] for part in parts])
                       for name in parts[0]}
        except Exception as error:            # pragma: no cover - defensive
            for complete, _ in entries:
                complete(StreamEvent.ERROR, {"diagnostic": str(error)})
            return
        for row, (complete, image) in enumerate(entries):
            try:
                outputs = self._postprocess(image, fetched, row)
            except Exception as error:        # pragma: no cover - defensive
                complete(StreamEvent.ERROR, {"diagnostic": str(error)})
                continue
            complete(StreamEvent.OKAY, outputs)

    # -- blocking path ------------------------------------------------------

    def process_frame(self, stream, image=None, **inputs):
        self._ensure_model()
        # ONE explicit host fetch of the whole result dict; the row
        # loop below then runs on host arrays with zero device syncs.
        with sync_allowed():
            result = _HostTree(self._dispatch(image)).numpy()
        return StreamEvent.OKAY, self._postprocess(image, result)

    def _postprocess(self, image, fetched: dict, row: int = 0) -> dict:
        return {"image": image, **self._slate_outputs(fetched, row)}

    def _slate_outputs(self, fetched: dict, row: int = 0) -> dict:
        """Build overlay/detections from the HOST-fetched result dict
        (callers did the one fetch; nothing here touches the device)."""
        boxes = np.asarray(fetched["boxes"][row], dtype=np.float32)
        scores = np.asarray(fetched["scores"][row], dtype=np.float32)
        classes = np.asarray(fetched["classes"][row])
        valid = np.asarray(fetched["valid"][row])

        rectangles, detections = [], []
        for i in np.nonzero(valid)[0]:
            x1, y1, x2, y2 = boxes[i].tolist()
            name = self._class_names[int(classes[i])] \
                if int(classes[i]) < len(self._class_names) else "?"
            # Clip to [0, 1]: ImageOverlay treats any coordinate > 1 as
            # absolute pixels, so an edge detection spilling past the
            # image border must stay in relative range.
            cx1, cy1 = min(max(x1, 0.0), 1.0), min(max(y1, 0.0), 1.0)
            cx2, cy2 = min(max(x2, 0.0), 1.0), min(max(y2, 0.0), 1.0)
            rectangles.append({
                "x": cx1, "y": cy1,
                "w": max(0.0, cx2 - cx1), "h": max(0.0, cy2 - cy1),
                "name": f"{name} {scores[i]:.2f}"})
            detections.append({"class": name,
                               "score": float(scores[i]),
                               "box": [x1, y1, x2, y2]})
        return {"overlay": {"rectangles": rectangles},
                "detections": detections}
