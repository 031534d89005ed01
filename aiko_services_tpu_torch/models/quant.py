"""Weight-only int8 and int8 KV-cache quantization for serving.

Counterpart of ``aiko_services_tpu/models/quant.py``, all of it:
``quantize_specs`` maps ``llama.partition_specs`` onto a quantized
tree, so ``plan.put(quantize_params(params), quantize_specs(specs))``
places it on a mesh (each position multiplies its column or row shard
of every int8 leaf, through kernel #5 on the card).  A
mixture-of-experts tree's 4-D expert leaves quantize per expert and
output channel (``{"int8" [L, E, D, F], "scale" [L, E, 1, F]}``).

Decode streams every weight byte and every cached k/v byte each step.
Symmetric int8 halves both streams: weights per output channel
(``quantize_weight``: scales over the contraction axis D), the cache per
(position, kv head) over head_dim (``quantize_kv``).  The arithmetic is
the JAX package's, in float32: ``scale = max(|x|, 1e-8) / 127``, codes
``round(x / scale)`` (half to even, as ``jnp.round``) clipped to ±127,
so the port's codes are bit-equal to the JAX package's on the same
input.

Quantized leaves are ``{"int8": int8 [..., D, F], "scale": f32
[..., 1, F]}`` (weights) and ``{"int8": int8 [..., hd], "scale": f32
[..., 1]}`` (k/v rows), as in the JAX package.  The forward pass
dispatches on the leaf type (``models/llama.py`` ``matmul``).

Usage::

    params = quantize_params(llama.init_params(0, config))
    config = dataclasses.replace(config, kv_dtype="int8")   # optional
"""

from __future__ import annotations

import torch

from ..parallel.mesh import MeshPlan, Placed

__all__ = ["QUANTIZED_LAYER_KEYS", "quantize_weight", "quantize_params",
           "quantize_specs", "quantize_kv", "dequantize_kv", "is_quantized",
           "map_leaf", "draft_params"]

# The layer-stacked matmul weights + the unembed projection; embeddings
# (gather, not matmul) and norm vectors stay in the model dtype.
QUANTIZED_LAYER_KEYS = ("wq", "wk", "wv", "wo",
                        "w_gate", "w_up", "w_down")


def _quantize(x: torch.Tensor, dim: int) -> dict:
    """Symmetric int8 codes of ``x`` with one float32 scale per slice
    along ``dim`` (kept as a size-1 axis)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=dim, keepdim=True),
                        min=1e-8) / 127.0
    codes = torch.clamp(torch.round(x32 / scale), -127, 127)
    return {"int8": codes.to(torch.int8), "scale": scale}


def quantize_weight(weight: torch.Tensor) -> dict:
    """[..., D, F] -> {"int8", "scale" [..., 1, F]}: per-output-channel
    (F) symmetric scales over the contraction axis D.  A stacked
    [L, D, F] weight is quantized one layer slice at a time, so the
    float32 transient never exceeds one layer (a whole stacked w_gate
    in float32 would be 7.5 GB at Llama-3-8B widths)."""
    if weight.ndim < 3:
        return _quantize(weight, -2)
    codes = torch.empty(weight.shape, dtype=torch.int8,
                        device=weight.device)
    scales = torch.empty((*weight.shape[:-2], 1, weight.shape[-1]),
                         dtype=torch.float32, device=weight.device)
    for index in range(weight.shape[0]):
        part = quantize_weight(weight[index])
        codes[index].copy_(part["int8"])
        scales[index].copy_(part["scale"])
    return {"int8": codes, "scale": scales}


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "int8" in leaf and "scale" in leaf


def map_leaf(leaf, fn):
    """``fn`` on a raw array, or on each array of a quantized leaf (a
    layer view, a row slice, a page gather)."""
    if is_quantized(leaf):
        return {"int8": fn(leaf["int8"]), "scale": fn(leaf["scale"])}
    return fn(leaf)


def quantize_kv(x: torch.Tensor) -> dict:
    """KV-cache quantization: symmetric int8 over the trailing head_dim
    with one float32 scale per (position, kv head) -- ``[..., hd]`` ->
    ``{"int8": [..., hd], "scale": [..., 1]}``.  The scale is constant
    along the contracted head_dim, so key scales multiply the score
    logits and value scales fold into the softmax weights: exact
    dequantization inside the attention."""
    return _quantize(x, -1)


def dequantize_kv(leaf: dict, dtype: torch.dtype) -> torch.Tensor:
    """Materialise a quantized k/v block in ``dtype`` (the flash
    admission path; decode never materialises this)."""
    return leaf["int8"].to(dtype) * leaf["scale"].to(dtype)


def quantize_params(params: dict) -> dict:
    """Quantize a llama parameter tree (``models/llama.py`` layout) for
    weight-only int8 serving: the seven layer matmul weights and the
    unembed become ``{"int8", "scale"}`` leaves on the weights' device;
    embed and norms are shared with ``params`` unchanged."""
    layers = dict(params["layers"])
    for key in QUANTIZED_LAYER_KEYS:
        layers[key] = quantize_weight(layers[key])
    quantized = dict(params)
    quantized["layers"] = layers
    quantized["unembed"] = quantize_weight(params["unembed"])
    return quantized


def draft_params(params):
    """The self-drafting tree for speculative serving: the target's own
    weight-only int8 quantization (half the weight bytes a draft step,
    no second checkpoint).  An already quantized tree is returned as
    it is.  A placed tree (``parallel.Placed``) of model-dtype weights is
    quantized whole -- gathered, quantized, then placed on its mesh by
    :func:`quantize_specs` of its specs -- since a leaf split over its
    contraction axis (wo, w_down) would take other per-channel scales
    if each shard were quantized alone."""
    if isinstance(params, Placed):
        if is_quantized(params.first_shard().get("unembed")):
            return params
        whole = quantize_params(params.gather(MeshPlan(params.mesh).device))
        return MeshPlan(params.mesh).put(whole,
                                         quantize_specs(params.specs))
    if is_quantized(params.get("unembed")):
        return params
    return quantize_params(params)


def quantize_specs(specs: dict) -> dict:
    """Map a ``llama.partition_specs`` tree onto the structure of a
    :func:`quantize_params` tree: each quantized leaf becomes
    ``{"int8": <weight's spec>, "scale": <spec with the contraction
    axis unsharded>}``.

    The int8 tensor has the weight's exact shape, so it inherits the
    weight's spec unchanged; the scale is ``[..., 1, F]`` -- size 1 on
    the contraction axis (it cannot shard there) and the weight's own
    layout on the output axis, so per-output-channel scales land on the
    same positions as the output channels they rescale and tp needs no
    scale collectives.  2-D, 3-D (stacked) and 4-D (expert) leaves
    alike."""
    def scale_spec(spec):
        entries = list(spec)
        entries[-2] = None
        return type(spec)(*entries)

    layers = dict(specs["layers"])
    for key in QUANTIZED_LAYER_KEYS:
        layers[key] = {"int8": layers[key],
                       "scale": scale_spec(layers[key])}
    quantized = dict(specs)
    quantized["layers"] = layers
    quantized["unembed"] = {"int8": specs["unembed"],
                            "scale": scale_spec(specs["unembed"])}
    return quantized
