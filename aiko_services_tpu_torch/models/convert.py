"""Pretrained-weight ingestion: HF safetensors -> the port's parameter
trees, written once as a port checkpoint (``models/checkpoint.py``) that
the ``checkpoint`` parameter of the serving elements loads.

Counterpart of ``aiko_services_tpu/models/convert.py``; the same names
and the same leaves, bit for bit, in the layer-stacked layout of
``models/llama.py``:

- ``model.layers.{i}.*`` per-layer tensors are STACKED on a leading
  layer axis;
- HF ``nn.Linear`` weights are ``[out, in]`` and applied as ``x @ W^T``;
  the port stores ``[in, out]`` and applies ``x @ W`` -- every
  projection is transposed on ingest;
- ``lm_head`` missing (tied embeddings) falls back to ``embed^T``.

The port reads the files itself (``models/_safetensors.py``): each
tensor is a view of the mapped file until a leaf is built from it.
``config.json``'s ``rope_scaling`` is not read, as in the JAX package:
a converted Llama-3.1 or 3.2 checkpoint computes RoPE without the llama3
frequency scaling its publisher applies.

The detector export (:func:`convert_detector`) names its tensors by the
JAX package's detector tree (HWIO conv kernels); the port's tree holds
OIHW kernels in ``channels_last`` memory, so each kernel is permuted on
ingest.
"""

from __future__ import annotations

import json
import os
import pathlib
import re

import torch

from ._safetensors import SafetensorsFile

__all__ = ["load_safetensors", "llama_params_from_hf", "convert_llama",
           "infer_llama_config", "convert_detector"]


def load_safetensors(source) -> dict:
    """Load one ``.safetensors`` file, or every ``*.safetensors`` shard
    in a directory (sorted), into one {name: tensor} dict (bf16
    preserved; each tensor a CPU view of its mapped file)."""
    source = pathlib.Path(source)
    files = (sorted(source.glob("*.safetensors"))
             if source.is_dir() else [source])
    if not files:
        raise FileNotFoundError(f"no .safetensors under {source}")
    tensors: dict = {}
    for path in files:
        shard = SafetensorsFile(path)
        for name in shard.keys():
            tensors[name] = shard.get_tensor(name)
    return tensors


def infer_llama_config(tensors: dict, max_seq: int = 8192,
                       rope_theta: float = 500_000.0,
                       hf_config: dict | None = None):
    """Derive a LlamaConfig from the model's ``config.json`` fields
    (``hf_config``, the authoritative source -- pass it whenever
    available) plus tensor shapes.

    Without ``hf_config`` the head count is NOT recoverable from shapes
    (q_proj is square for every Llama), so this refuses to guess unless
    exactly one head count in the Llama-3 family convention (32 heads)
    fits; anything else must supply config.json or an explicit config.
    """
    from .llama import LlamaConfig

    vocab, dim = tensors["model.embed_tokens.weight"].shape
    hidden = tensors["model.layers.0.mlp.gate_proj.weight"].shape[0]
    q_out = tensors["model.layers.0.self_attn.q_proj.weight"].shape[0]
    kv_out = tensors["model.layers.0.self_attn.k_proj.weight"].shape[0]
    n_layers = 1 + max(
        int(m.group(1)) for name in tensors
        if (m := re.match(r"model\.layers\.(\d+)\.", name)))
    if q_out != dim:
        raise ValueError(f"non-Llama attention layout (q_out={q_out}, "
                         f"dim={dim})")

    if hf_config:
        n_heads = int(hf_config["num_attention_heads"])
        n_kv_heads = int(hf_config.get("num_key_value_heads", n_heads))
        rope_theta = float(hf_config.get("rope_theta", rope_theta))
    else:
        # Shape-only fallback: accept the Llama-3 convention (32 heads)
        # only when it fits exactly; otherwise demand config.json.
        n_heads = 32
        if dim % n_heads or kv_out % (dim // n_heads):
            raise ValueError(
                "head count is not recoverable from tensor shapes for "
                "this model; pass the HF config.json (kept next to the "
                "safetensors) or an explicit LlamaConfig")
        n_kv_heads = kv_out // (dim // n_heads)
    return LlamaConfig(
        vocab_size=int(vocab), dim=int(dim), n_layers=n_layers,
        n_heads=n_heads, n_kv_heads=n_kv_heads, hidden_dim=int(hidden),
        max_seq=max_seq, rope_theta=rope_theta)


def _find_hf_config(source) -> dict | None:
    """config.json sitting next to the safetensors (HF snapshot layout)."""
    source = pathlib.Path(source)
    directory = source if source.is_dir() else source.parent
    path = directory / "config.json"
    if path.exists():
        with open(path) as fh:
            return json.load(fh)
    return None


def _stack(tensors: dict, template: str, n_layers: int,
           transpose: bool) -> torch.Tensor:
    rows = []
    for i in range(n_layers):
        name = template.format(i=i)
        if name not in tensors:
            raise KeyError(f"missing tensor {name!r} "
                           f"(have {len(tensors)} tensors)")
        t = tensors[name]
        rows.append(t.T if transpose else t)
    shapes = {tuple(r.shape) for r in rows}
    if len(shapes) > 1:
        raise ValueError(f"{template}: ragged per-layer shapes "
                         f"{sorted(shapes)}")
    return torch.stack(rows, dim=0)


def llama_params_from_hf(tensors: dict, config) -> dict:
    """HF-name tensors -> the layer-stacked tree of models/llama.py (CPU
    tensors in the config's dtype)."""
    from .llama import _dtype

    n = config.n_layers
    dtype = _dtype(config)
    attn = "model.layers.{i}.self_attn.{p}_proj.weight"
    mlp = "model.layers.{i}.mlp.{p}_proj.weight"

    def proj(template, **kw):
        return _stack(tensors, template.format(i="{i}", **kw), n,
                      transpose=True).to(dtype)

    embed = tensors["model.embed_tokens.weight"].to(dtype)
    if "lm_head.weight" in tensors:
        unembed = tensors["lm_head.weight"].T.to(dtype)
    else:                                   # tied embeddings
        unembed = embed.T
    params = {
        "embed": embed,
        "layers": {
            "wq": proj(attn, p="q"),
            "wk": proj(attn, p="k"),
            "wv": proj(attn, p="v"),
            "wo": proj(attn, p="o"),
            "w_gate": proj(mlp, p="gate"),
            "w_up": proj(mlp, p="up"),
            "w_down": proj(mlp, p="down"),
            "attn_norm": _stack(
                tensors, "model.layers.{i}.input_layernorm.weight", n,
                transpose=False).to(dtype),
            "mlp_norm": _stack(
                tensors,
                "model.layers.{i}.post_attention_layernorm.weight", n,
                transpose=False).to(dtype),
        },
        "final_norm": tensors["model.norm.weight"].to(dtype),
        "unembed": unembed,
    }
    _check_llama_shapes(params, config)
    return params


def _check_llama_shapes(params: dict, c) -> None:
    hd = c.head_dim
    expect = {
        ("embed",): (c.vocab_size, c.dim),
        ("layers", "wq"): (c.n_layers, c.dim, c.n_heads * hd),
        ("layers", "wk"): (c.n_layers, c.dim, c.n_kv_heads * hd),
        ("layers", "wv"): (c.n_layers, c.dim, c.n_kv_heads * hd),
        ("layers", "wo"): (c.n_layers, c.n_heads * hd, c.dim),
        ("layers", "w_gate"): (c.n_layers, c.dim, c.hidden_dim),
        ("layers", "w_up"): (c.n_layers, c.dim, c.hidden_dim),
        ("layers", "w_down"): (c.n_layers, c.hidden_dim, c.dim),
        ("layers", "attn_norm"): (c.n_layers, c.dim),
        ("layers", "mlp_norm"): (c.n_layers, c.dim),
        ("final_norm",): (c.dim,),
        ("unembed",): (c.dim, c.vocab_size),
    }
    for path, want in expect.items():
        node = params
        for key in path:
            node = node[key]
        if tuple(node.shape) != want:
            raise ValueError(
                f"{'.'.join(path)}: shape {tuple(node.shape)} != "
                f"expected {want} for the given config")


def convert_llama(source, destination, config=None,
                  max_seq: int = 8192) -> "object":
    """safetensors file/dir -> port checkpoint at ``destination``.

    Returns the (possibly inferred) LlamaConfig.  After this,
    ``LLMService(config=cfg, checkpoint=destination)`` serves the
    pretrained weights.
    """
    from .checkpoint import save_pytree

    tensors = load_safetensors(source)
    if config is None:
        config = infer_llama_config(tensors, max_seq=max_seq,
                                    hf_config=_find_hf_config(source))
    params = llama_params_from_hf(tensors, config)
    save_pytree(destination, {"params": params},
                metadata={"source": os.fspath(source),
                          "config": config.__dict__.copy()})
    return config


def convert_detector(source, destination, config=None):
    """Detector ingestion: a safetensors file whose tensor names match
    the JAX package's detector tree paths joined with '.' (conv kernels
    [kh, kw, cin, cout], e.g. ``heads.0.w``) -> port checkpoint loadable
    via the Detector element's ``checkpoint`` parameter."""
    from .checkpoint import save_pytree
    from .detector import DetectorConfig, _dtype, param_shapes

    tensors = load_safetensors(source)
    if config is None:
        config = DetectorConfig.tiny()
    dtype = _dtype(config)

    def take(name, shape):
        if name not in tensors:
            raise KeyError(f"detector tensor {name!r} missing")
        t = tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        return t.to(dtype)

    def fill(layout, path):
        if isinstance(layout, dict):
            return {key: fill(value, f"{path}{key}.")
                    for key, value in layout.items()}
        if isinstance(layout, list):
            return [fill(value, f"{path}{index}.")
                    for index, value in enumerate(layout)]
        cout, cin, kernel = layout
        w = take(f"{path}w", (kernel, kernel, cin, cout))
        return {"w": w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last),
                "b": take(f"{path}b", (cout,))}

    params = fill(param_shapes(config), "")
    save_pytree(destination, {"params": params},
                metadata={"source": os.fspath(source)})
    return config
