"""Single-shot object detector on PyTorch (BASELINE configs 2 and 4).

Counterpart of ``aiko_services_tpu/models/detector.py``: the same
YOLOv8-flavoured anchor-free network (strided Conv-SiLU stages with
residual bottlenecks, an FPN top-down fusion of P3/P4/P5, 1x1 heads
predicting [4 box ltrb + num_classes] per grid cell), the same decode
and the same static-shape greedy NMS, returning a fixed
``max_detections`` slate with a validity mask.

The JAX package runs these outside any Pallas kernel
(``lax.conv_general_dilated``, ``lax.top_k``, a ``lax.fori_loop``
NMS); here they are cuDNN convolutions and plain tensor ops, written so
that the whole of :func:`detect` enqueues with no host synchronisation
and can be captured as one CUDA graph (``pipeline/tensor.py``
``JitCache``).  What keeps the two packages' answers equal:

- layout: the API keeps the JAX package's NHWC images and NHWC
  per-scale predictions; inside, a permuted NHWC tensor IS an NCHW
  tensor in ``channels_last`` memory, the layout cuDNN's tensor-core
  convolutions read, and the weights are OIHW in ``channels_last``;
- SAME padding: XLA pads a stride-2 3x3 convolution (0, 1) on an even
  size and (1, 1) on an odd one; the asymmetric case pads explicitly
  (``F.pad``) and convolves with ``padding=0``;
- nearest resize: ``jax.image.resize(method="nearest")`` samples pixel
  centres (``"nearest-exact"``), which differs from ``"nearest"``
  whenever P5 -> P4 is not an exact 2x;
- candidate order: predictions flatten row by row from NHWC, as the
  JAX package's do;
- top-k ties: a stable descending sort puts the lower index first, as
  ``lax.top_k`` does (``torch.topk`` promises no order);
- NMS: the greedy scan of the JAX package, batched over images, over
  one [B, k, k] IoU matrix built with ``_iou``'s operand order, with
  ``torch.where`` steps and a stable ``argsort`` compaction -- no
  ``.item()``, no host-read ``.any()``, no boolean indexing.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..device import resolve_device

__all__ = ["DetectorConfig", "init_params", "forward", "decode",
           "nms", "detect"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    num_classes: int = 80
    width: int = 32               # stem channels; stages double it
    depth: int = 1                # bottleneck blocks per stage
    strides: tuple = (8, 16, 32)  # P3/P4/P5 output strides
    max_detections: int = 100
    score_threshold: float = 0.25
    iou_threshold: float = 0.45
    dtype: str = "bfloat16"

    @classmethod
    def tiny(cls, num_classes: int = 4) -> "DetectorConfig":
        return cls(num_classes=num_classes, width=8, depth=1,
                   max_detections=16)


def _dtype(config: DetectorConfig) -> torch.dtype:
    if config.dtype not in _DTYPES:
        raise ValueError(f"dtype {config.dtype!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[config.dtype]


# ---------------------------------------------------------------------------
# Layers (NCHW tensors in channels_last memory, OIHW weights).

def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding (low, high) of one spatial dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(params, x, stride=1):
    weight = params["w"]
    kernel = weight.shape[-1]
    (top, bottom), (left, right) = (
        _same_padding(x.shape[2], kernel, stride),
        _same_padding(x.shape[3], kernel, stride))
    if top == bottom and left == right:
        padding = (top, left)
    else:
        x = F.pad(x, (left, right, top, bottom))
        padding = 0
    return F.conv2d(x, weight.to(x.dtype), params["b"].to(x.dtype),
                    stride=stride, padding=padding)


def _conv_silu(params, x, stride=1):
    return F.silu(_conv(params, x, stride))


def _bottleneck(params, x):
    """Two 3x3 convs with a residual add."""
    return x + _conv_silu(params["c2"], _conv_silu(params["c1"], x))


def param_shapes(config: DetectorConfig) -> dict:
    """The parameter tree's layout: each conv as (cout, cin, kernel), in
    the JAX package's key order (which is also the draw order)."""
    w = config.width

    def stage(cin, cout):
        return {"down": (cout, cin, 3),
                "blocks": [{"c1": (cout, cout, 3), "c2": (cout, cout, 3)}
                           for _ in range(config.depth)]}

    head_out = 4 + config.num_classes
    return {
        "stem": (w, 3, 3),
        "stage1": stage(w, w * 2),
        "stage2": stage(w * 2, w * 2),
        "stage3": stage(w * 2, w * 4),
        "stage4": stage(w * 4, w * 8),
        "lateral4": (w * 4, w * 8 + w * 4, 1),
        "lateral3": (w * 2, w * 4 + w * 2, 1),
        "heads": [(head_out, c, 1) for c in (w * 2, w * 4, w * 8)],
    }


def map_layout(layout, fn):
    """Apply ``fn(cout, cin, kernel)`` to every conv of a layout."""
    if isinstance(layout, dict):
        return {name: map_layout(value, fn) for name, value in layout.items()}
    if isinstance(layout, list):
        return [map_layout(value, fn) for value in layout]
    return fn(*layout)


def init_params(seed: int, config: DetectorConfig,
                device: str | torch.device | None = None) -> dict:
    """Random weights at the JAX package's scaling (standard normal x
    fan_in^-0.5, zero biases), drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the card unless "cpu" is asked for), in
    the config's dtype; kernels OIHW in ``channels_last`` memory."""
    device = resolve_device(device)
    dtype = _dtype(config)
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def conv(cout, cin, kernel):
        w = torch.randn((cout, cin, kernel, kernel), generator=generator,
                        device=device, dtype=torch.float32)
        w = (w * (cin * kernel * kernel) ** -0.5).to(dtype)
        return {"w": w.contiguous(memory_format=torch.channels_last),
                "b": torch.zeros((cout,), dtype=dtype, device=device)}

    return map_layout(param_shapes(config), conv)


def _run_stage(params, x):
    x = _conv_silu(params["down"], x, stride=2)
    for block in params["blocks"]:
        x = _bottleneck(block, x)
    return x


def forward(params: dict, config: DetectorConfig,
            images: torch.Tensor) -> list[torch.Tensor]:
    """images: [B, H, W, 3] float32/bf16 in 0..1.  Returns per-scale
    raw predictions [B, Hs, Ws, 4 + num_classes] (P3, P4, P5)."""
    x = images.to(_dtype(config)).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)
    x = _conv_silu(params["stem"], x, stride=2)
    x = _run_stage(params["stage1"], x)
    p3 = _run_stage(params["stage2"], x)
    p4 = _run_stage(params["stage3"], p3)
    p5 = _run_stage(params["stage4"], p4)

    # FPN top-down fusion.
    up5 = F.interpolate(p5, size=p4.shape[2:], mode="nearest-exact")
    p4 = _conv_silu(params["lateral4"], torch.cat([p4, up5], dim=1))
    up4 = F.interpolate(p4, size=p3.shape[2:], mode="nearest-exact")
    p3 = _conv_silu(params["lateral3"], torch.cat([p3, up4], dim=1))

    return [_conv(params["heads"][i], feature).permute(0, 2, 3, 1)
            for i, feature in enumerate((p3, p4, p5))]


def decode(config: DetectorConfig, predictions: list[torch.Tensor],
           image_size: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw per-scale maps -> flat (boxes [B, N, 4] xyxy in 0..1 relative
    coords, scores [B, N, num_classes])."""
    h_img, w_img = image_size
    all_boxes, all_scores = [], []
    for stride, pred in zip(config.strides, predictions):
        b, h, w, _ = pred.shape
        pred = pred.float()
        ys = (torch.arange(h, dtype=torch.float32, device=pred.device)
              + 0.5) * stride
        xs = (torch.arange(w, dtype=torch.float32, device=pred.device)
              + 0.5) * stride
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        # distances to the four edges, non-negative via softplus
        dist = F.softplus(pred[..., :4]) * stride
        x1 = (cx[None] - dist[..., 0]) / w_img
        y1 = (cy[None] - dist[..., 1]) / h_img
        x2 = (cx[None] + dist[..., 2]) / w_img
        y2 = (cy[None] + dist[..., 3]) / h_img
        boxes = torch.stack([x1, y1, x2, y2], dim=-1)
        scores = torch.sigmoid(pred[..., 4:])
        all_boxes.append(boxes.reshape(b, h * w, 4))
        all_scores.append(scores.reshape(b, h * w, config.num_classes))
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """boxes [B, k, 4] xyxy -> [B, k, k]: row i is the JAX package's
    ``_iou(boxes[i], boxes)``, in its operand order."""
    box, other = boxes[:, :, None, :], boxes[:, None, :, :]
    x1 = torch.maximum(box[..., 0], other[..., 0])
    y1 = torch.maximum(box[..., 1], other[..., 1])
    x2 = torch.minimum(box[..., 2], other[..., 2])
    y2 = torch.minimum(box[..., 3], other[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    areas = (boxes[..., 2] - boxes[..., 0]).clamp(min=0) \
        * (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    union = areas[:, :, None] + areas[:, None, :] - inter
    return inter / union.clamp(min=1e-9)


def nms(config: DetectorConfig, boxes: torch.Tensor,
        scores: torch.Tensor) -> dict:
    """Static-shape class-agnostic greedy NMS, batched: boxes
    [B, N, 4], scores [B, N, C] -> the top ``max_detections`` surviving
    detections of each image: {"boxes" [B, M, 4], "scores" [B, M],
    "classes" [B, M] int64, "valid" [B, M] bool}.  Unbatched [N, 4] and
    [N, C] inputs give unbatched slates."""
    if boxes.dim() == 2:
        return {name: value[0] for name, value
                in nms(config, boxes[None], scores[None]).items()}
    m = config.max_detections
    best_scores, best_classes = scores.max(dim=-1).values, \
        scores.argmax(dim=-1)
    k = min(4 * m, boxes.shape[1])
    # lax.top_k order: descending, the lower index first on ties.
    top_scores, top_index = torch.sort(best_scores, dim=-1,
                                       descending=True, stable=True)
    top_scores, top_index = top_scores[:, :k], top_index[:, :k]
    top_boxes = torch.gather(boxes, 1, top_index[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(best_classes, 1, top_index)

    # Greedy suppression over the score-sorted candidates: candidate i
    # falls when a surviving earlier candidate overlaps it.
    position = torch.arange(k, device=boxes.device)
    overlaps = (_iou_matrix(top_boxes) > config.iou_threshold) \
        & (position[None, :] < position[:, None])      # [i, j]: j < i
    keep = top_scores > config.score_threshold
    for i in range(k):
        suppressed = (keep & overlaps[:, i, :]).any(dim=-1, keepdim=True)
        keep = torch.where(suppressed & (position == i), False, keep)

    # Compact the survivors to the front, pad with invalid slots (a
    # small input can have fewer than max_detections grid cells).
    if k < m:
        pad = m - k
        top_boxes = F.pad(top_boxes, (0, 0, 0, pad))
        top_scores = F.pad(top_scores, (0, pad))
        top_classes = F.pad(top_classes, (0, pad))
        keep = F.pad(keep, (0, pad))
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)[:, :m]
    return {"boxes": torch.gather(top_boxes, 1,
                                  order[..., None].expand(-1, -1, 4)),
            "scores": torch.gather(top_scores, 1, order),
            "classes": torch.gather(top_classes, 1, order),
            "valid": torch.gather(keep, 1, order)}


def detect(params: dict, config: DetectorConfig,
           images: torch.Tensor) -> dict:
    """Full pipeline: forward -> decode -> batched NMS.  images
    [B, H, W, 3] in 0..1; returns batched detection slates."""
    predictions = forward(params, config, images)
    boxes, scores = decode(config, predictions, tuple(images.shape[1:3]))
    return nms(config, boxes, scores)
