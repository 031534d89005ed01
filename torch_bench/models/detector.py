"""The repository's YOLOv8-flavoured detector in plain PyTorch: the
benchmark's weights, its reference (float32 convolutions, the decode and
a greedy class-agnostic NMS written as a loop), its lower-precision
control and its operation count.

The network: a stride-2 3x3 stem, four stages (a stride-2 3x3 down
convolution, then ``depth`` residual pairs of 3x3 convolutions), P3/P4/P5
from stages 2-4, a top-down fusion (nearest upsampling at pixel centres,
concatenation, a 1x1 lateral convolution), and a 1x1 head a scale
predicting 4 edge distances and the class logits a grid cell.  Every
convolution but the heads is followed by SiLU; padding is SAME (for a
stride-2 3x3 convolution over an even size: none before, one after).
Boxes are the cell centre minus/plus softplus(distance) x stride, in
image-relative xyxy; scores are sigmoid(logits).  NMS takes the
4 x max_detections best candidates by their best class score (ties to
the lower index), drops those at or under the score threshold and those
overlapping an earlier kept one by more than the IoU threshold, and
keeps the first ``max_detections``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layout(config: dict) -> dict:
    """conv name -> (cout, cin, kernel), in draw order."""
    w, depth = config["width"], config["depth"]

    def stage(cin, cout):
        return {"down": (cout, cin, 3),
                "blocks": [{"c1": (cout, cout, 3), "c2": (cout, cout, 3)}
                           for _ in range(depth)]}
    head_out = 4 + config["num_classes"]
    return {"stem": (w, 3, 3), "stage1": stage(w, w * 2),
            "stage2": stage(w * 2, w * 2), "stage3": stage(w * 2, w * 4),
            "stage4": stage(w * 4, w * 8),
            "lateral4": (w * 4, w * 8 + w * 4, 1),
            "lateral3": (w * 2, w * 4 + w * 2, 1),
            "heads": [(head_out, c, 1) for c in (w * 2, w * 4, w * 8)]}


def _map(node, fn):
    if isinstance(node, dict):
        return {name: _map(value, fn) for name, value in node.items()}
    if isinstance(node, list):
        return [_map(value, fn) for value in node]
    return fn(node)


def draw(seed: int, config: dict, device, dtype=torch.bfloat16) -> dict:
    """Random weights from ``seed`` (standard normal x fan_in^-0.5, zero
    biases), OIHW in channels-last memory, in the served type."""
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def conv(spec):
        cout, cin, kernel = spec
        w = torch.randn((cout, cin, kernel, kernel), generator=generator,
                        device=device, dtype=dtype)
        w.mul_((cin * kernel * kernel) ** -0.5)
        return {"w": w.contiguous(memory_format=torch.channels_last),
                "b": torch.zeros((cout,), dtype=dtype, device=device)}
    return _map(layout(config), conv)


def conv_flops(config: dict, batch: int, size: int) -> int:
    """2 a multiply-add over every convolution of ``batch`` images."""
    lay = layout(config)
    total = 0

    def conv(spec, n_in, stride):
        nonlocal total
        cout, cin, kernel = spec
        n_out = -(-n_in // stride)
        total += 2 * batch * cout * cin * kernel * kernel * n_out * n_out
        return n_out
    n = conv(lay["stem"], size, 2)
    sides = []
    for name in ("stage1", "stage2", "stage3", "stage4"):
        n = conv(lay[name]["down"], n, 2)
        for block in lay[name]["blocks"]:
            conv(block["c1"], n, 1)
            conv(block["c2"], n, 1)
        sides.append(n)
    p3, p4, p5 = sides[1:]
    conv(lay["lateral4"], p4, 1)
    conv(lay["lateral3"], p3, 1)
    for head, side in zip(lay["heads"], (p3, p4, p5)):
        conv(head, side, 1)
    return total


# -- the reference -----------------------------------------------------------

def _fp8(x, dims):
    scale = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _conv(p, x, stride, fp8):
    w = p["w"].float().contiguous()
    if fp8:
        x, w = _fp8(x, (1, 2, 3)), _fp8(w, (1, 2, 3))
    kernel = w.shape[-1]
    pads = []
    for size in (x.shape[3], x.shape[2]):          # width, then height
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, p["b"].float(), stride=stride)


def predictions(params: dict, config: dict, images: torch.Tensor,
                fp8: bool = False) -> list:
    """images [B, H, W, 3] in 0..1 -> per-scale [B, Hs, Ws, 4 + C]."""
    def silu_conv(p, x, stride=1):
        return F.silu(_conv(p, x, stride, fp8))

    def stage(p, x):
        x = silu_conv(p["down"], x, 2)
        for block in p["blocks"]:
            x = x + silu_conv(block["c2"], silu_conv(block["c1"], x))
        return x
    x = images.float().permute(0, 3, 1, 2).contiguous()
    x = stage(params["stage1"], silu_conv(params["stem"], x, 2))
    p3 = stage(params["stage2"], x)
    p4 = stage(params["stage3"], p3)
    p5 = stage(params["stage4"], p4)
    up5 = F.interpolate(p5, size=p4.shape[2:], mode="nearest-exact")
    p4 = silu_conv(params["lateral4"], torch.cat([p4, up5], 1))
    up4 = F.interpolate(p4, size=p3.shape[2:], mode="nearest-exact")
    p3 = silu_conv(params["lateral3"], torch.cat([p3, up4], 1))
    return [_conv(params["heads"][i], f, 1, fp8).permute(0, 2, 3, 1)
            for i, f in enumerate((p3, p4, p5))]


def candidates(config: dict, preds: list, size: int):
    """-> boxes [B, N, 4] (xyxy, relative), scores [B, N, C]."""
    boxes, scores = [], []
    for stride, pred in zip(config["strides"], preds):
        b, h, w, _ = pred.shape
        ys = (torch.arange(h, device=pred.device) + 0.5) * stride
        xs = (torch.arange(w, device=pred.device) + 0.5) * stride
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        dist = F.softplus(pred[..., :4]) * stride
        box = torch.stack([cx - dist[..., 0], cy - dist[..., 1],
                           cx + dist[..., 2], cy + dist[..., 3]], -1) / size
        boxes.append(box.reshape(b, h * w, 4))
        scores.append(torch.sigmoid(pred[..., 4:]).reshape(b, h * w, -1))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def _iou(a, b) -> float:
    w = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    h = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = w * h
    area = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1]) \
        + max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    return inter / max(area - inter, 1e-9)


def nms(config: dict, boxes: torch.Tensor, scores: torch.Tensor) -> list:
    """One image's candidates -> its slate: [(candidate, class, score)]."""
    best, classes = scores.max(-1)
    k = min(4 * config["max_detections"], best.shape[0])
    order = torch.sort(best, descending=True, stable=True).indices[:k]
    order = order.tolist()
    best, classes = best.tolist(), classes.tolist()
    box = boxes.tolist()
    kept = []
    for index in order:
        if best[index] <= config["score_threshold"]:
            continue
        if any(_iou(box[index], box[j]) > config["iou_threshold"]
               for j, _, _ in kept):
            continue
        kept.append((index, classes[index], best[index]))
        if len(kept) == config["max_detections"]:
            break
    return kept


def slate(params: dict, config: dict, images: torch.Tensor,
          fp8: bool = False) -> list:
    """Per image: (boxes [N, 4], scores [N, C], its NMS slate)."""
    size = images.shape[1]
    boxes, scores = candidates(config, predictions(params, config, images,
                                                   fp8), size)
    boxes, scores = boxes.cpu(), scores.cpu()
    return [(boxes[i], scores[i], nms(config, boxes[i], scores[i]))
            for i in range(images.shape[0])]


def judge(config: dict, reference: tuple, detections: list,
          class_names: list) -> dict:
    """One frame's served detections [{"class", "score", "box"}] against
    the reference's (boxes, scores, slate):

    - ``det_err``: for each detection, the candidate whose box lies
      nearest (largest coordinate difference): the largest of that box
      difference, the score's difference from the candidate's score of
      the served class, and how far that score lies below the
      candidate's best class score;
    - ``det_rank_gap``: how far a served detection's candidate scores
      below the reference slate's last kept score (0 when above);
    - ``det_count_gap``: served detections against the reference's.
    """
    boxes, scores, kept = reference
    cut = kept[-1][2] if len(kept) == config["max_detections"] \
        else config["score_threshold"]
    err, rank = 0.0, 0.0
    for detection in detections:
        box = torch.tensor(detection["box"], dtype=torch.float32)
        distance = (boxes - box).abs().max(-1).values
        j = int(distance.argmin())
        cls = class_names.index(detection["class"])
        own = float(scores[j, cls])
        best = float(scores[j].max())
        err = max(err, float(distance[j]), abs(detection["score"] - own),
                  best - own)
        rank = max(rank, cut - best)
    return {"det_err": err, "det_rank_gap": rank,
            "det_count_gap": float(abs(len(detections) - len(kept)))}
