"""Llama-3-family transformer on PyTorch (the serving model of BASELINE
config 3).

Counterpart of ``aiko_services_tpu/models/llama.py``: the same config,
the same layer-stacked parameter dict ([L, ...] leaves) and the same
flat ``[L, B, T, K*hd]`` KV cache, written as plain functions on
tensors.  PyTorch runs eagerly, so the layer ``scan`` is a Python loop
over layer views and there is no jit.

One deliberate difference: JAX's functions are pure and return a new
cache; here every cache write lands IN PLACE, layer by layer, and the
functions return the same cache dict.  That keeps one copy of the cache
in device memory.  Decode writes each layer's new k/v after that
layer's attention; the attention masks ``t < length`` exclude the write
position either way, and the current token enters through the self
term, so the result is the JAX package's.

The PAGED cache (``models/paged.py``) runs through the same entry
points: prefill writes whole pages through the page table
(``scatter_pages``) and attends the slot's gathered page view; decode
writes each row's k/v at ``table[row, pos // pt], pos % pt`` with the
index math on the device, and attends through the page-table-walking
kernel #3 (``flash_decode_append_paged``) or, on the reference path,
the gathered layer.  ``prefill`` stays dense-only, as in the JAX
package.

int8 serving runs through the same entry points.  A tree from
``models/quant.py`` ``quantize_params`` carries ``{"int8", "scale"}``
weight leaves, which :func:`matmul` multiplies -- on the card through
the int8 matmul kernel #5.  ``LlamaConfig(kv_dtype="int8")`` stores the
cache (dense or paged) as int8 codes with one float32 scale per
position and kv head: every write quantizes first, decode reads the
codes through the int8 branch of the decode kernels (or the dense int8
path, ``ops/layers.py``), and flash admission dequantizes the slot's
row for the prefill kernel #4.

The device-resident generation loop (``decode_loop``) runs ``ring``
tokens per row with sampling, stop detection and, optionally, ngram or
draft speculation inside one block of device work.  The JAX package's
``lax.while_loop`` becomes a fixed number of masked iterations with no
host synchronisation, which ``models/loop_graph.py`` captures as one
CUDA graph; the speculative verify step reads the cache once for all
draft positions through the chunk-verify kernel
(``flash_verify_append``).

A mixture-of-experts config (``n_experts > 0``) replaces every block's
FFN with :func:`_moe_ffn`, the JAX package's GShard einsum dispatch in
static shapes: one-hot masks, a ``cumsum`` for the slot positions and a
per-call capacity from the static row count, so it runs inside the loop
graph's capture and under the sync guard.  Every entry point routes the
rows the JAX package's counterpart routes (inactive and padded rows
included, which compete for capacity as they do there).

Training (``models/train.py``) differentiates :func:`prefill_with_aux`.
It attends each layer's k/v through an out-of-place update of the cache
layer and writes the cache detached, so no tensor autograd saved is
written in place; ``config.remat`` recomputes each layer in the
backward pass (``torch.utils.checkpoint``).

``partition_specs`` and ``cache_specs`` are the JAX package's layouts
on the port's ``P``.  A tree placed by them (``plan.put``, a
``parallel.Placed`` tree) runs through ``prefill``,
``prefill_with_aux``, ``prefill_into_slot`` and ``decode_step`` as the
JAX package's sharded arrays run through its jitted entry points: every
position of the mesh runs the one forward, :func:`_forward`, on its
shards (:class:`TensorShard`: tp Megatron blocks, fsdp gathers a layer
at its use, experts over ep), the kernels at each position on its own
heads and leaf shards, and the logits come back whole, the cache
placed (:func:`_on_mesh`).  ``models/long_context.py`` and the sharded
training step use the same forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device, upload
from ..ops import decode_backend, matmul_backend, topk as ops_topk
from ..ops.flash_attention import flash_attention
from ..ops.flash_decode import (_split_paged, _split_stacked,
                                flash_decode_append_paged,
                                flash_decode_append_stacked,
                                flash_verify_append)
from ..ops.int8_matmul import int8_matmul
from ..ops.layers import (apply_rope, attention_decode_append,
                          attention_prefill, rms_norm, rope_frequencies)
from ..parallel.mesh import (Each, Keep, P, Placed, all_gather, assemble,
                             axis_index, filter_spec, psum, shard_map)
from ..parallel.mesh import remat as mesh_remat
from .paged import (gather_layer, gather_slot, is_paged, paged_extent,
                    pool_page_tokens, scatter_pages)
from .quant import dequantize_kv, is_quantized, map_leaf, quantize_kv

__all__ = ["LlamaConfig", "init_params", "abstract_params", "param_shapes",
           "partition_specs", "cache_specs", "paged_cache_specs",
           "TensorShard", "init_cache",
           "cache_array", "cache_extent", "prefill",
           "prefill_with_aux", "prefill_into_slot", "prefill_into_slot_at",
           "prefill_into_slots",
           "decode_step", "decode_block",
           "decode_loop", "greedy_sample", "temperature_sample",
           "select_tokens"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14_336
    rope_theta: float = 500_000.0
    max_seq: int = 8192
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # Prefill attention: "dense" (ops/layers.py attention_prefill) or
    # "flash" (the blockwise kernel, ops/flash_attention.py) on the
    # single-slot admission path.
    attention: str = "dense"
    # Decode attention: "dense", "flash" (the split-K kernel,
    # ops/flash_decode.py) or "auto" (flash once the cache extent
    # reaches flash_decode_threshold; see ops.decode_backend).
    decode_attention: str = "auto"
    flash_decode_threshold: int = 1024
    matmul_kernel: str = "auto"
    kv_dtype: str = "bfloat16"
    n_experts: int = 0
    n_experts_per_token: int = 2
    capacity_factor: float = 2.0
    remat: bool = False

    def __post_init__(self):
        if self.attention not in ("dense", "flash"):
            raise ValueError(
                f"attention must be 'dense' or 'flash', "
                f"got {self.attention!r}")
        if self.decode_attention not in ("dense", "flash", "auto"):
            raise ValueError(
                f"decode_attention must be 'dense', 'flash' or 'auto', "
                f"got {self.decode_attention!r}")
        if self.kv_dtype not in ("bfloat16", "int8"):
            raise ValueError(
                f"kv_dtype must be 'bfloat16' or 'int8', "
                f"got {self.kv_dtype!r}")
        if self.matmul_kernel not in ("auto", "pallas", "off"):
            raise ValueError(
                f"matmul_kernel must be 'auto', 'pallas' or 'off', "
                f"got {self.matmul_kernel!r}")
        if self.n_experts and self.n_experts_per_token > self.n_experts:
            raise ValueError(
                f"n_experts_per_token ({self.n_experts_per_token}) "
                f"exceeds n_experts ({self.n_experts})")

    def moe_capacity(self, n_tokens: int) -> int:
        """Static per-expert buffer size for ``n_tokens`` routed tokens."""
        exact = math.ceil(self.capacity_factor * n_tokens
                          * self.n_experts_per_token / self.n_experts)
        return max(1, min(-(-exact // 8) * 8, n_tokens))

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def gqa_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def llama3_1b(cls) -> "LlamaConfig":
        return cls(dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                   hidden_dim=8192)

    @classmethod
    def tiny(cls, vocab_size: int = 512, max_seq: int = 256) \
            -> "LlamaConfig":
        """Test-size config: runs on the CPU in milliseconds."""
        return cls(vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, hidden_dim=128, max_seq=max_seq,
                   rope_theta=10_000.0)

    @classmethod
    def tiny_moe(cls, vocab_size: int = 512, max_seq: int = 256,
                 n_experts: int = 4) -> "LlamaConfig":
        """Test-size MoE config (4 experts, top-2 routing)."""
        return cls(vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, hidden_dim=128, max_seq=max_seq,
                   rope_theta=10_000.0, n_experts=n_experts)


def _dtype(config: LlamaConfig) -> torch.dtype:
    if config.dtype not in _DTYPES:
        raise ValueError(f"dtype {config.dtype!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[config.dtype]


def param_shapes(config: LlamaConfig) -> dict:
    """The parameter dict's layout: leaf -> (shape, fan_in or None for
    the norm weights, which start at one).  A mixture-of-experts config
    stacks its experts on axis 1: ``w_router`` [L, D, E], ``w_gate`` /
    ``w_up`` [L, E, D, F], ``w_down`` [L, E, F, D]."""
    c = config
    hd = c.head_dim
    if c.n_experts:
        e = c.n_experts
        ffn = {
            "w_router": ((c.n_layers, c.dim, e), c.dim),
            "w_gate": ((c.n_layers, e, c.dim, c.hidden_dim), c.dim),
            "w_up": ((c.n_layers, e, c.dim, c.hidden_dim), c.dim),
            "w_down": ((c.n_layers, e, c.hidden_dim, c.dim), c.hidden_dim),
        }
    else:
        ffn = {
            "w_gate": ((c.n_layers, c.dim, c.hidden_dim), c.dim),
            "w_up": ((c.n_layers, c.dim, c.hidden_dim), c.dim),
            "w_down": ((c.n_layers, c.hidden_dim, c.dim), c.hidden_dim),
        }
    return {
        "embed": ((c.vocab_size, c.dim), c.dim),
        "layers": {
            "wq": ((c.n_layers, c.dim, c.n_heads * hd), c.dim),
            "wk": ((c.n_layers, c.dim, c.n_kv_heads * hd), c.dim),
            "wv": ((c.n_layers, c.dim, c.n_kv_heads * hd), c.dim),
            "wo": ((c.n_layers, c.n_heads * hd, c.dim), c.n_heads * hd),
            **ffn,
            "attn_norm": ((c.n_layers, c.dim), None),
            "mlp_norm": ((c.n_layers, c.dim), None),
        },
        "final_norm": ((c.dim,), None),
        "unembed": ((c.dim, c.vocab_size), c.dim),
    }


def init_params(seed: int, config: LlamaConfig,
                device: str | torch.device | None = None) -> dict:
    """Random weights at the JAX package's init scaling (standard normal
    x fan_in^-0.5, norms at one), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the card unless "cpu" is asked
    for).  Stacked leaves are drawn one layer at a time, so the f32
    draw never holds more than one layer's slice."""
    device = resolve_device(device)
    dtype = _dtype(config)
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def leaf(shape, fan_in):
        if fan_in is None:
            return torch.ones(shape, dtype=dtype, device=device)
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out if len(shape) >= 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=device, dtype=torch.float32)
                       .mul_(fan_in ** -0.5))
        return out

    return _map_layout(param_shapes(config), lambda spec: leaf(*spec))


def partition_specs(config: LlamaConfig) -> dict:
    """Megatron TP + fsdp layout, layer axis unsharded (it is scanned).
    MoE expert weights add the ``ep`` axis on their expert dimension
    (each ep shard owns n_experts/ep experts); the router is small and
    replicated over ep.  The JAX package's specs, on the port's ``P``."""
    if config.n_experts:
        ffn = {
            "w_router": P(None, "fsdp", None),
            "w_gate": P(None, "ep", "fsdp", "tp"),
            "w_up": P(None, "ep", "fsdp", "tp"),
            "w_down": P(None, "ep", "tp", "fsdp"),
        }
    else:
        ffn = {
            "w_gate": P(None, "fsdp", "tp"),
            "w_up": P(None, "fsdp", "tp"),
            "w_down": P(None, "tp", "fsdp"),
        }
    return {
        "embed": P("fsdp", None),
        "layers": {
            "wq": P(None, "fsdp", "tp"),
            "wk": P(None, "fsdp", "tp"),
            "wv": P(None, "fsdp", "tp"),
            "wo": P(None, "tp", "fsdp"),
            **ffn,
            "attn_norm": P(None, None),
            "mlp_norm": P(None, None),
        },
        "final_norm": P(None),
        "unembed": P("fsdp", "tp"),
    }


def cache_specs(config: LlamaConfig | None = None) -> dict:
    """KV cache: batch over dp, kv heads over tp.  The FLAT payload
    ([L, B, T, K*hd]) shards its fused head axis over tp (tp divides K,
    so contiguous blocks map to whole kv heads); an int8 cache's scale
    ([L, B, T, K, 1]) shards its kv-head axis on the same positions."""
    spec = P(None, "dp", None, "tp")
    if config is not None and config.kv_dtype == "int8":
        leaf = {"int8": spec, "scale": P(None, "dp", None, "tp", None)}
        return {"k": leaf, "v": leaf}
    return {"k": spec, "v": spec}


def paged_cache_specs(config: LlamaConfig | None = None) -> dict:
    """A PAGED cache (``models/paged.py``): the pools' kv heads over tp,
    as :func:`cache_specs` lays out the flat payload ([L, P, pt, K*hd]
    on its fused head axis, an int8 pool's [L, P, pt, K, 1] scales on
    their kv-head axis); the page axis and the [B, pps] page table stay
    whole at every position, so every position walks the same table.
    No JAX counterpart: the JAX package places its paged pools only
    through GSPMD, never by a spec tree."""
    spec = P(None, None, None, "tp")
    if config is not None and config.kv_dtype == "int8":
        leaf = {"int8": spec, "scale": P(None, None, None, "tp", None)}
    else:
        leaf = spec
    return {"k": leaf, "v": leaf, "page_table": P(None, None)}


def abstract_params(config: LlamaConfig) -> dict:
    """The parameter dict as meta tensors: its shapes and dtype, no
    storage and nothing drawn (a checkpoint restore's template)."""
    dtype = _dtype(config)
    return _map_layout(param_shapes(config), lambda spec: torch.empty(
        spec[0], dtype=dtype, device="meta"))


def _map_layout(layout: dict, fn) -> dict:
    return {name: _map_layout(value, fn) if isinstance(value, dict)
            else fn(value) for name, value in layout.items()}


def init_cache(config: LlamaConfig, batch: int, max_seq: int | None = None,
               device: str | torch.device | None = None) -> dict:
    """Zeroed KV cache stored FLAT: [L, B, T, K*hd] per side -- the
    contiguous view the decode kernel reads (``cache[layer]`` is a view,
    never a copy).  With ``kv_dtype="int8"`` each side is
    ``{"int8": [L, B, T, K*hd] int8, "scale": [L, B, T, K, 1] float32}``
    (the scales keep the JAX package's grouped shape).  For a mesh,
    ``plan.put(init_cache(...), cache_specs(config))`` places it."""
    return _init_cache(config, batch, max_seq or config.max_seq,
                       resolve_device(device), config.n_kv_heads)


def _init_cache(config: LlamaConfig, batch: int, t: int,
                device: torch.device, kv_heads: int) -> dict:
    """:func:`init_cache` of ``kv_heads`` heads (a tp position's)."""
    c = config
    shape = (c.n_layers, batch, t, kv_heads * c.head_dim)
    if c.kv_dtype == "int8":
        def side():
            return {"int8": torch.zeros(shape, dtype=torch.int8,
                                        device=device),
                    "scale": torch.zeros(shape[:-1] + (kv_heads, 1),
                                         dtype=torch.float32,
                                         device=device)}
        return {"k": side(), "v": side()}
    return {"k": torch.zeros(shape, dtype=_dtype(c), device=device),
            "v": torch.zeros(shape, dtype=_dtype(c), device=device)}


def _at_layer(leaf, index: int):
    """Layer ``index`` of a stacked leaf -- a weight, a cache side or a
    pool side, raw or int8 (a view)."""
    return map_leaf(leaf, lambda arr: arr[index])


def _kv_stored(leaf, new: torch.Tensor):
    """Raw k/v ``[.., S, K, hd]`` -> what ``leaf``'s cache stores: the
    flat ``[.., S, K*hd]`` rows, quantized first for an int8 leaf
    (codes flat, scales ``[.., S, K, 1]``), as the JAX package's
    ``_kv_store`` does."""
    if is_quantized(leaf):
        quantized = quantize_kv(new)
        return {"int8": quantized["int8"].reshape(*new.shape[:-2], -1),
                "scale": quantized["scale"]}
    return new.reshape(*new.shape[:-2], -1)


def _kv_write(leaf, new, write) -> None:
    """``write(array, value)`` in place on each stored array of a cache
    leaf, ``new`` from :func:`_kv_stored`."""
    if is_quantized(leaf):
        write(leaf["int8"], new["int8"])
        write(leaf["scale"], new["scale"])
    else:
        write(leaf, new)


def _require_whole_pages(cache: dict, starts, s: int) -> None:
    """Paged prefill writes whole pages: every chunk start page-aligned
    and the chunk a whole number of pages."""
    page_tokens = pool_page_tokens(cache)
    if s % page_tokens or any(int(start) % page_tokens
                              for start in starts):
        raise ValueError(
            f"paged prefill chunk of {s} tokens at {list(starts)} is not "
            f"a whole number of page-aligned {page_tokens}-token pages")


def _local_cache(cache) -> dict:
    """A cache dict: ``cache`` itself, or the first shard this process
    holds of a placed cache (its extent, page size and page count are
    every position's)."""
    return cache.first_shard() if isinstance(cache, Placed) else cache


def cache_array(cache: dict) -> torch.Tensor:
    """The cache's key payload tensor (the first position's shard of a
    placed cache)."""
    k = _local_cache(cache)["k"]
    return k["int8"] if is_quantized(k) else k


def cache_extent(cache: dict) -> int:
    """Logical per-slot token extent T; position T-1 is the trash
    position inactive rows write to."""
    cache = _local_cache(cache)
    if is_paged(cache):
        return paged_extent(cache)
    return cache_array(cache).shape[2]


def matmul(x: torch.Tensor, w, kernel: bool = False) -> torch.Tensor:
    """``x @ w`` for raw weights (a plain product, left to PyTorch as
    the JAX package left it to XLA) or weight-only int8 leaves
    (``{"int8", "scale"}``, models/quant.py).

    ``kernel=True`` sends a 2-D int8 leaf through kernel #5
    (ops/int8_matmul.py): the weight streams as int8 bytes and the
    per-column scale applies at the store.  Callers set it when
    ``ops.matmul_backend(config.matmul_kernel)`` resolves to the kernel,
    and the port does so for EVERY 2-D int8 leaf, the layer weights
    too -- not only the unembed, as the JAX package does.  There, XLA
    fuses the int8 -> bf16 convert into the dot's operand load and a
    sliced scan operand would materialise in front of a pallas call;
    here the layer leaves are views, and the eager plain product below
    materialises a bf16 copy of the weight at every call (1 byte read,
    2 written, 2 read again per weight, more than bf16 weights cost),
    so the kernel is the port's counterpart of that fusion.  It
    computes the same function; ``matmul_kernel="off"`` keeps the
    plain product, which is the JAX package's arithmetic exactly."""
    if is_quantized(w):
        if kernel and w["int8"].ndim == 2:
            lead = x.shape[:-1]
            out = int8_matmul(x.reshape(-1, x.shape[-1]), w["int8"],
                              w["scale"])
            return out.reshape(*lead, out.shape[-1])
        return (x @ w["int8"].to(x.dtype)) * w["scale"].to(x.dtype)
    return x @ w


def _matmul_kernel(config: LlamaConfig, device: torch.device) -> bool:
    """Whether int8 weight leaves go through kernel #5 on ``device``."""
    return matmul_backend(config.matmul_kernel, device) != "reference"


def _grouped(layer, head_dim: int):
    """Flat [.., T, K*hd] -> grouped [.., T, K, hd] view (the payload of
    an int8 layer; its [.., T, K, 1] scales are grouped already).  K is
    read from the payload: a position of a tp mesh holds K/tp heads."""
    def regroup(arr):
        return arr.reshape(*arr.shape[:-1], -1, head_dim)
    if is_quantized(layer):
        return {"int8": regroup(layer["int8"]), "scale": layer["scale"]}
    return regroup(layer)


@functools.lru_cache(maxsize=8)
def _rope_table(head_dim: int, max_seq: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """The cos/sin table, uploaded once per device: the decode path
    makes no host-to-device copy (a pageable upload would wait for the
    stream and stall the pipelined batcher)."""
    return rope_frequencies(head_dim, max_seq, theta, device=device)


def _rope(config: LlamaConfig, device: torch.device) -> torch.Tensor:
    return _rope_table(config.head_dim, config.max_seq, config.rope_theta,
                       device)


def _layer(params: dict, index: int) -> dict:
    return {name: _at_layer(leaf, index)
            for name, leaf in params["layers"].items()}


def _expert_matmul(t: torch.Tensor, w, pattern: str) -> torch.Tensor:
    """Batched-over-experts einsum for raw or weight-only int8 expert
    leaves; the [E, 1, F] per-channel scale applies after the product.
    An int8 leaf takes the plain cast product (kernel #5 takes 2-D
    leaves), the JAX package's arithmetic."""
    if is_quantized(w):
        return torch.einsum(pattern, t, w["int8"].to(t.dtype)) \
            * w["scale"].to(t.dtype)
    return torch.einsum(pattern, t, w)


#: Set by :func:`record_route_drops`: the dropped-route counts of every
#: MoE FFN call made inside it (0-d device tensors).
_route_drops: list | None = None


@contextlib.contextmanager
def record_route_drops():
    """Count the (token, expert) routes the MoE FFN drops at capacity:
    inside the block every ``_moe_ffn`` call appends its count (a 0-d
    tensor on the device, no host read) to the yielded list.  On a mesh
    each routed row is counted once (by the positions at coordinate 0 on
    every axis that does not split the rows).  Use it around a forward
    without grad: a remat backward would route again."""
    global _route_drops
    found: list = []
    _route_drops = found
    try:
        yield found
    finally:
        _route_drops = None


def _moe_ffn(config: LlamaConfig, x: torch.Tensor, layer: dict,
             shard: "TensorShard | None" = None):
    """Top-k routed mixture-of-experts SwiGLU FFN, the JAX package's
    GShard einsum dispatch.  x: [B, S, D] normed activations.  Returns
    (ffn_out [B, S, D], the load-balance aux scalar, float32).

    Every shape is static: each expert takes a ``moe_capacity`` token
    buffer, and a (token, expert) route past a full buffer is dropped
    (the token keeps its residual stream).  The router's top-k is a
    stable descending sort, so equal probabilities pick the lowest
    expert first, as ``lax.top_k`` does; the gates are gathered from the
    probabilities, so they carry the router's gradient.

    On a mesh (``shard``) the result is the GLOBAL batch's, as GSPMD
    keeps it: the capacity follows the global row count
    (``shard.routed_tokens``), a route's slot counts every earlier route
    in global token-major order (the routes of the rows and sequence
    chunks before this position's, from ``shard.route_prefix``), and the
    aux takes its means over all rows.  Rows that ``shard.keep`` marks
    False (an admission burst's padding) route nothing.
    Expert parallelism keeps the batch whole over ``ep``: each ep
    position routes every row of its batch shard and runs only its E/ep
    experts on their slice of the [E, C, D] dispatch buffer; the
    caller's ``shard.reduce_experts`` sums the combine over ep (and
    tp).  No all-to-all is needed: that form moves tokens only for a
    layout that splits the batch over ep."""
    c = config
    b, s, d = x.shape
    n = b * s
    e, k = c.n_experts, c.n_experts_per_token
    rows = n if shard is None else shard.routed_tokens(n)
    cap = c.moe_capacity(rows)
    xf = x.reshape(n, d)

    probs = torch.softmax(xf.float() @ layer["w_router"].float(), dim=-1)
    choices = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]            # [n, k]
    gates = probs.gather(1, choices)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    experts = torch.arange(e, device=x.device)
    onehot = (choices[..., None] == experts).float()            # [n, k, E]
    routed = probs
    if shard is not None and shard.keep is not None:
        keep = shard.keep.repeat_interleave(s).float()          # [n]
        onehot = onehot * keep[:, None, None]
        routed = probs * keep[:, None]
    flat = onehot.reshape(n * k, e)
    # Each (token, choice)'s slot in its expert's buffer: how many
    # earlier rows picked the same expert (token-major order, so a
    # token's k distinct choices never collide).
    if shard is None:
        positions = ((torch.cumsum(flat, dim=0) - flat) * flat).sum(-1)
    else:
        per_row = flat.reshape(b, s * k, e)
        before = torch.cumsum(per_row, dim=1) - per_row \
            + shard.route_prefix(per_row.sum(1))[:, None, :]
        positions = (before * per_row).sum(-1).reshape(n * k)
    if _route_drops is not None and (shard is None or shard.counts_routes):
        _route_drops.append((positions >= cap).sum())
    slots = torch.arange(cap, device=x.device)
    pos_onehot = (positions.long()[:, None] == slots).float() \
        * (positions < cap).float()[:, None]                    # [n*k, C]
    local = onehot
    if shard is not None and shard.ep > 1:
        first, count = shard.experts(e)
        local = onehot[..., first:first + count]                # [n, k, E/ep]
    # The k choices pre-summed into one [n, E, C] dispatch/combine mask
    # (lossless: a token's choices hit distinct experts).
    mask = torch.einsum("nke,nkc->nec", local,
                        pos_onehot.reshape(n, k, cap)).to(x.dtype)
    dispatch = torch.einsum("nec,nd->ecd", mask, xf)
    gate_h = F.silu(_expert_matmul(dispatch, layer["w_gate"],
                                   "ecd,edf->ecf"))
    up_h = _expert_matmul(dispatch, layer["w_up"], "ecd,edf->ecf")
    out_e = _expert_matmul(gate_h * up_h, layer["w_down"],
                           "ecf,efd->ecd")                      # [E, C, D]
    gates_e = torch.einsum("nke,nk->ne", local, gates)          # [n, E]
    combine = mask * gates_e.to(x.dtype)[:, :, None]            # [n, E, C]
    out = torch.einsum("nec,ecd->nd", combine, out_e)

    # GShard load-balance aux: E * sum_e(fraction routed * mean prob),
    # the fraction over the n*k choices -- 1.0 at perfect balance.
    if shard is None:
        fraction = flat.reshape(n, k, e).sum(1).mean(0) / k
        aux = e * torch.sum(fraction * probs.mean(0))
    else:
        fraction = shard.route_sum(flat.reshape(n, k, e).sum((0, 1))) \
            / (rows * k)
        aux = e * torch.sum(fraction * shard.route_sum(routed.sum(0)) / rows)
    return out.reshape(b, s, d), aux


def _without_layer_axis(spec):
    """A stacked leaf's spec for one layer's view (int8 leaves' too)."""
    if isinstance(spec, dict):
        return {name: _without_layer_axis(part) for name, part in spec.items()}
    return P(*spec[1:])


class TensorShard:
    """One mesh position's part of the model: what GSPMD derives from
    ``partition_specs`` in the JAX package, written out.  Built inside a
    function mapped by ``parallel.shard_map`` over ``mesh``, for a tree
    placed by ``specs`` (filtered to the mesh), with the batch split over
    ``batch_axes`` and the sequence over ``seq_axis`` (context
    parallelism; None for none).

    - tp: the position holds 1/``size`` of the heads, kv heads and FFN
      width (columns of wq, wk, wv, w_gate and w_up; rows of wo and
      w_down), and :meth:`reduce` sums a row-parallel product over tp;
    - fsdp: :meth:`whole` gathers a leaf's fsdp shards; the forward
      gathers each layer's leaves at their use (:meth:`gathered`), so at
      most one layer stands whole at a position;
    - ep: the position runs experts :meth:`experts` of E, and
      :meth:`reduce_experts` sums the MoE FFN's output over ep and tp;
    - the routed rows: ``row_shards`` positions split them (batch and
      sequence axes), :meth:`routed_tokens`, :meth:`route_prefix` and
      :meth:`route_sum` make the MoE capacity, slots and aux those of
      the global batch."""

    #: per local row, whether it routes (None: every row does).
    keep: torch.Tensor | None = None

    def __init__(self, mesh, specs: dict, batch_axes=("dp", "fsdp"),
                 seq_axis: str | None = None):
        def present(axes):
            return tuple(axis for axis in axes
                         if mesh.shape.get(axis, 1) > 1)
        self.specs = specs
        self.size = mesh.shape.get("tp", 1)
        self.ep = mesh.shape.get("ep", 1)
        self._fsdp = bool(present(("fsdp",)))
        self._rows = present(batch_axes)
        self._seq = present((seq_axis,) if seq_axis else ())
        self.row_shards = math.prod(mesh.shape[axis]
                                    for axis in self._rows + self._seq)
        self._layer_specs = {name: _without_layer_axis(spec)
                             for name, spec in specs["layers"].items()}
        self.counts_routes = all(
            axis_index(axis) == 0 for axis in mesh.axis_names
            if axis not in self._rows + self._seq
            and mesh.shape[axis] > 1)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x, "tp") if self.size > 1 else x

    def reduce_experts(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(axis for axis, size in (("ep", self.ep),
                                             ("tp", self.size)) if size > 1)
        return psum(x, axes) if axes else x

    def experts(self, n_experts: int) -> tuple[int, int]:
        """(first, count) of this position's experts."""
        count = n_experts // self.ep
        return axis_index("ep") * count, count

    def whole(self, leaf, spec):
        """``leaf`` gathered over fsdp (an int8 leaf's arrays each)."""
        if is_quantized(leaf):
            return {name: self.whole(leaf[name], spec[name])
                    for name in ("int8", "scale")}
        if self._fsdp:
            for dim, entry in enumerate(spec):
                if entry == "fsdp":
                    leaf = all_gather(leaf, "fsdp", axis=dim)
        return leaf

    def gathered(self, layer: dict) -> dict:
        """One layer's leaves (``_layer`` views) whole over fsdp."""
        return {name: self.whole(leaf, self._layer_specs[name])
                for name, leaf in layer.items()}

    def routed_tokens(self, n: int) -> int:
        """The global token count the MoE capacity follows, from this
        position's ``n``."""
        return n * self.row_shards

    def route_prefix(self, counts: torch.Tensor) -> torch.Tensor:
        """counts [b, E]: the routes each local row's chunk sends to each
        expert -> the routes that precede the chunk in global
        token-major order (rows of the batch shards before this one,
        then this row's sequence chunks before this one), [b, E]."""
        b, e = counts.shape
        table = counts[:, None, :]
        seq_rank = row_rank = 0
        if self._seq:
            table = all_gather(table, self._seq, axis=1)
            seq_rank = axis_index(self._seq)
        if self._rows:
            table = all_gather(table, self._rows, axis=0)
            row_rank = axis_index(self._rows)
        chunks = table.shape[1]
        flat = table.reshape(-1, e)
        before = torch.cumsum(flat, dim=0) - flat
        index = (row_rank * b + torch.arange(b, device=counts.device)) \
            * chunks + seq_rank
        return before[index]

    def route_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the positions that split the routed rows."""
        axes = self._rows + self._seq
        return psum(x, axes) if axes else x


class BurstShard(TensorShard):
    """One position's part of a mixture-of-experts admission burst whose
    rows fall in several groups of ``axes`` (the axes a placed cache
    splits its batch over): each group runs its own rows, padded to the
    largest group's count with rows that route nothing (``keep``) and
    write nothing, so the routing is the whole burst's, as GSPMD routes
    it in the JAX package: the capacity follows the burst's ``rows``,
    and a route's slot counts the routes of every row before its own in
    the burst's row order.  ``order`` [groups * width]: the burst row of
    each group's rows in group order (padding after every burst row)."""

    def __init__(self, mesh, specs: dict, axes: tuple, order: torch.Tensor,
                 rows: int, keep: torch.Tensor):
        super().__init__(mesh, specs, axes)
        self._order = order
        self._burst_rows = rows
        self.keep = keep

    def routed_tokens(self, n: int) -> int:
        return self._burst_rows * (n // self.keep.numel())

    def route_prefix(self, counts: torch.Tensor) -> torch.Tensor:
        b = counts.shape[0]
        table = all_gather(counts, self._rows, axis=0)          # [G*b, E]
        ordered = torch.zeros_like(table).index_copy_(0, self._order, table)
        before = torch.cumsum(ordered, dim=0) - ordered
        mine = self._order[axis_index(self._rows) * b
                           + torch.arange(b, device=counts.device)]
        return before[mine]


def _block(config: LlamaConfig, hidden, layer: dict, attend,
           kernel: bool = False, shard: TensorShard | None = None):
    """One transformer block.  ``attend(q, k, v) -> attn_out`` does RoPE,
    the cache write and attention (prefill and decode differ there);
    ``kernel`` routes 2-D int8 weight leaves through kernel #5; ``shard``
    runs it as one position's shard (:class:`TensorShard`): its local
    heads and kv heads divided by ``shard.size``, the wo and FFN
    products summed over the shards before each residual add.  Returns
    (hidden, the MoE aux scalar -- the float 0.0 for a dense FFN, so a
    dense step launches nothing for it)."""
    c = config
    b, s, _ = hidden.shape
    hd = c.head_dim
    shards = 1 if shard is None else shard.size
    heads, kv_heads = c.n_heads // shards, c.n_kv_heads // shards

    def mm(x, w):
        return matmul(x, w, kernel)

    def reduced(partial_sum):
        return partial_sum if shard is None else shard.reduce(partial_sum)
    x = rms_norm(hidden, layer["attn_norm"], c.norm_eps)
    q = mm(x, layer["wq"]).reshape(b, s, heads, hd)
    k = mm(x, layer["wk"]).reshape(b, s, kv_heads, hd)
    v = mm(x, layer["wv"]).reshape(b, s, kv_heads, hd)
    attn_out = attend(q, k, v)
    hidden = hidden + reduced(mm(attn_out.reshape(b, s, heads * hd),
                                 layer["wo"]))
    x = rms_norm(hidden, layer["mlp_norm"], c.norm_eps)
    if c.n_experts:
        ffn_out, aux = _moe_ffn(c, x, layer, shard)
        if shard is not None:
            ffn_out = shard.reduce_experts(ffn_out)
        return hidden + ffn_out, aux
    gate = F.silu(mm(x, layer["w_gate"]))
    return hidden + reduced(mm(gate * mm(x, layer["w_up"]),
                               layer["w_down"])), 0.0


def _forward(params: dict, config: LlamaConfig, tokens: torch.Tensor,
             attend_factory, remat: bool = False,
             shard: TensorShard | None = None):
    """Embed, run every layer with ``attend_factory(layer_index)``,
    final-norm and unembed -> (logits [B, S, vocab], the MoE aux summed
    over layers).  ``remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``
    around the scanned block).

    This is the ONE forward of every entry point, on one device and at
    each position of a mesh: with ``shard`` the tree is the position's
    shards, each layer's leaves are gathered over fsdp at their use (and
    again in the backward pass under remat: ``parallel.remat`` recomputes
    every position's layer together, its collectives included) and the
    blocks run as Megatron shards."""
    kernel = _matmul_kernel(config, tokens.device)
    embed = params["embed"] if shard is None \
        else shard.whole(params["embed"], shard.specs["embed"])
    hidden = embed[tokens]
    del embed
    aux = 0.0
    for index in range(config.n_layers):
        attend = attend_factory(index)
        layer = _layer(params, index)
        if shard is None:
            args = (config, hidden, layer, attend, kernel)
            if remat:
                hidden, layer_aux = checkpoint(_block, *args,
                                               use_reentrant=False)
            else:
                hidden, layer_aux = _block(*args)
        else:
            def run(hidden, layer, attend=attend):
                return _block(config, hidden, shard.gathered(layer), attend,
                              kernel, shard)
            hidden, layer_aux = (mesh_remat(run, hidden, layer) if remat
                                 else run(hidden, layer))
        aux = aux + layer_aux
    return _finish(params, config, hidden, kernel, shard), aux


def _finish(params: dict, config: LlamaConfig, hidden,
            kernel: bool = False, shard: TensorShard | None = None) \
        -> torch.Tensor:
    hidden = rms_norm(hidden, params["final_norm"], config.norm_eps)
    unembed = params["unembed"] if shard is None \
        else shard.whole(params["unembed"], shard.specs["unembed"])
    return matmul(hidden, unembed, kernel)


def _kv_put(leaf, new, rows, cols):
    """Out-of-place :func:`_kv_write`: ``leaf`` (a cache layer) with
    ``new`` at ``[rows, cols]``, as new tensors autograd can track."""
    if is_quantized(leaf):
        return {name: leaf[name].index_put((rows, cols), new[name])
                for name in ("int8", "scale")}
    return leaf.index_put((rows, cols), new)


def prefill_with_aux(params: dict, config: LlamaConfig,
                     tokens: torch.Tensor, cache: dict,
                     start_positions: torch.Tensor) \
        -> tuple[torch.Tensor, dict, torch.Tensor]:
    """Whole-batch prompt prefill.  tokens: [B, S] (right padding
    allowed); start_positions: [B] cache offset each row begins at.
    Writes each row's k/v at [b, start + i] and returns (logits
    [B, S, vocab], cache, the MoE load-balance aux summed over layers --
    a float32 scalar, 0 for a dense FFN).  Dense caches only: paged
    serving admission goes through ``prefill_into_slot(s)``.

    Differentiable (the training path): each layer attends through
    :func:`_kv_put`'s out-of-place copy of its cache layer, and the cache
    takes the detached k/v in place, so autograd saves no tensor that a
    later write changes.  ``config.remat`` recomputes each layer in the
    backward pass.

    ``params`` may be a placed tree (``plan.put(params,
    partition_specs(config))``, :func:`_on_mesh`): the cache is then
    placed by :func:`cache_specs`, tokens and start positions are split
    with the batch over dp (or as the tokens' placement says), and the
    logits come back whole, the cache placed."""
    if isinstance(params, Placed):
        return _on_mesh(_prefill_core, params, config, tokens, cache,
                        (start_positions,), logits_dims=2, aux=True)
    return _prefill_core(params, config, tokens, cache, start_positions)


def _prefill_core(params: dict, config: LlamaConfig, tokens: torch.Tensor,
                  cache: dict | None, start_positions: torch.Tensor | None,
                  shard: TensorShard | None = None):
    """:func:`prefill_with_aux` on one device or at one position of a
    mesh (``shard``).  ``cache=None`` writes a fresh cache of S positions
    at start 0 (the training loss's)."""
    c = config
    b, s = tokens.shape
    if cache is None:
        cache = _init_cache(c, b, s, tokens.device,
                            c.n_kv_heads // (shard.size if shard else 1))
        start_positions = torch.zeros(b, dtype=torch.int32,
                                      device=tokens.device)
    if is_paged(cache):
        raise ValueError(
            "prefill works on dense caches (training / whole-batch "
            "path); paged serving admission goes through "
            "prefill_into_slot(s)")
    rope = _rope(c, tokens.device)
    positions = start_positions.to(tokens.device).long()[:, None] \
        + torch.arange(s, device=tokens.device)[None, :]
    rows = torch.arange(b, device=tokens.device)[:, None]

    def factory(index):
        def write(arr, value):
            arr[index][rows, positions] = value

        def attend(q, k, v):
            q = apply_rope(q, rope, positions)
            k = apply_rope(k, rope, positions)
            layers = []
            for side, new in (("k", k), ("v", v)):
                stored = _kv_stored(cache[side], new)
                layers.append(_kv_put(_at_layer(cache[side], index), stored,
                                      rows, positions))
                _kv_write(cache[side], map_leaf(stored, torch.Tensor.detach),
                          write)
            return attention_prefill(q, _grouped(layers[0], c.head_dim),
                                     _grouped(layers[1], c.head_dim),
                                     positions)
        return attend

    logits, aux = _forward(params, c, tokens, factory, remat=c.remat,
                           shard=shard)
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, cache, aux


def prefill(params: dict, config: LlamaConfig, tokens: torch.Tensor,
            cache: dict, start_positions: torch.Tensor) \
        -> tuple[torch.Tensor, dict]:
    """:func:`prefill_with_aux` without the aux: (logits, cache)."""
    return prefill_with_aux(params, config, tokens, cache,
                            start_positions)[:2]


def prefill_into_slot(params: dict, config: LlamaConfig,
                      tokens: torch.Tensor, cache: dict, slot: int,
                      start: int, *, runner=None) \
        -> tuple[torch.Tensor, dict]:
    """Process one prompt chunk for ONE sequence, writing its k/v into
    batch row ``slot`` of the batched cache at ``start`` (the continuous
    batcher's admission path).  tokens: [1, S] (right padding allowed).
    Queries attend the slot's whole cache row, so chunk N sees chunks
    0..N-1; with ``attention="flash"`` the kernel's causal offset hides
    the unwritten tail.  Returns (logits [1, S, vocab], cache).

    A PAGED cache is written through its page table: the chunk start
    must be page-aligned and S a whole number of pages (the batcher's
    chunk discipline guarantees both), and the attention row is the
    slot's gathered page view.

    On a placed tree the cache is placed too (:func:`cache_specs`, or
    :func:`paged_cache_specs`), and the slot's row is written where it
    lives (:func:`_admit_on_mesh`): with the batch split over dp, only
    the positions of the slot's dp group run the chunk, each writing its
    kv heads of its local row; the logits come back whole.

    ``runner`` (a ``loop_graph.AdmissionRunner`` over ``params`` and
    ``cache``) replays its captured chunk instead, the chunk's tokens
    (host) and ``(slot, start)`` uploaded into its inputs: the same
    computation as :func:`prefill_into_slot_at`, enqueued by one graph
    launch.  The logits are then the runner's buffer, valid until its
    next replay."""
    if runner is not None:
        _check_chunk(cache, int(start), tokens.shape[1])
        return runner.run(cache, tokens, int(slot), int(start)), cache
    if isinstance(params, Placed):
        return _admit_on_mesh(params, config, tokens, cache, [int(slot)],
                              [int(start)], batched=False)
    return _prefill_into_slot_impl(params, config, tokens, cache, slot,
                                   start)


def prefill_into_slot_at(params: dict, config: LlamaConfig,
                         tokens: torch.Tensor, cache: dict,
                         at: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """:func:`prefill_into_slot` with the slot and the chunk's start read
    on the device: ``at`` is an int32 [2] tensor ``(slot, start)`` on the
    tokens' device.  Nothing is read back to the host, so one captured
    CUDA graph of this call serves every slot and offset
    (``loop_graph.AdmissionRunner``): RoPE positions are ``start +
    arange(S)`` on the device, each layer's k/v land by an indexed copy
    at rows ``slot * T + positions`` of the layer's ``[slots * T, ...]``
    view, and flash attention reads the whole layer with ``at`` (the
    kernel picks the row and the offset).  It computes what the host-int
    form computes.  An unplaced tree over a dense cache of raw k/v only;
    the caller keeps the chunk inside the cache (nothing here can check
    a device value)."""
    if isinstance(params, Placed) or is_paged(cache) \
            or is_quantized(cache["k"]):
        raise ValueError("prefill_into_slot_at takes an unplaced tree and "
                         "a dense cache of raw (not int8) k/v")
    return _prefill_into_slot_impl(params, config, tokens, cache, None,
                                   None, at=at)


def _check_chunk(cache: dict, start: int, s: int) -> None:
    extent = cache_extent(cache)
    if start < 0 or start + s > extent:
        raise ValueError(f"prefill_into_slot: chunk [{start}, {start + s})"
                         f" does not fit the cache extent {extent}")


def _prefill_into_slot_impl(params: dict, config: LlamaConfig,
                            tokens: torch.Tensor, cache: dict, slot, start,
                            shard: TensorShard | None = None,
                            at: torch.Tensor | None = None):
    """The chunk at host ints ``(slot, start)``, or at the device's
    ``at`` (:func:`prefill_into_slot_at`; ``slot`` and ``start`` None)."""
    c = config
    s = tokens.shape[1]
    if at is None:
        slot, start = int(slot), int(start)
        _check_chunk(cache, start, s)
    paged = is_paged(cache)
    if paged:
        _require_whole_pages(cache, [start], s)
    rope = _rope(c, tokens.device)
    first = start if at is None else at[1].long()
    positions = (first + torch.arange(s, device=tokens.device))[None, :]
    if at is not None:
        # Rows of a layer's [slots * T, ...] view.
        rows = at[0].long() * cache_extent(cache) + positions[0]

    def factory(index):
        def write(arr, value):
            if at is None:
                arr[index, slot:slot + 1, start:start + s] = value
                return
            layer = arr[index]
            layer.view(-1, *layer.shape[2:]).index_copy_(
                0, rows, value.reshape(s, *value.shape[2:]))

        def attend(q, k, v):
            q = apply_rope(q, rope, positions)
            k = apply_rope(k, rope, positions)
            if paged:
                table, pt = cache["page_table"], pool_page_tokens(cache)
                for side, new in (("k", k), ("v", v)):
                    layer = _at_layer(cache[side], index)
                    scatter_pages(layer, _kv_stored(layer, new), table,
                                  [slot], [start], pt)
                k_row = gather_slot(_at_layer(cache["k"], index),
                                    table[slot])
                v_row = gather_slot(_at_layer(cache["v"], index),
                                    table[slot])
            else:
                for side, new in (("k", k), ("v", v)):
                    _kv_write(cache[side], _kv_stored(cache[side], new),
                              write)
                if at is None:
                    k_row, v_row = (map_leaf(
                        cache[side], lambda arr: arr[index, slot:slot + 1])
                        for side in ("k", "v"))
                elif c.attention == "flash":
                    k_row, v_row = cache["k"][index], cache["v"][index]
                else:
                    k_row, v_row = (cache[side][index].index_select(
                        0, at[:1].long()) for side in ("k", "v"))
            k_row = _grouped(k_row, c.head_dim)
            v_row = _grouped(v_row, c.head_dim)
            if c.attention == "flash":
                # The kernel reads the model dtype: an int8 row is
                # dequantized here (admission is compute-bound; decode,
                # where the bytes matter, never does this).
                if is_quantized(k_row):
                    k_row = dequantize_kv(k_row, q.dtype)
                    v_row = dequantize_kv(v_row, q.dtype)
                return flash_attention(q, k_row, v_row, q_offset=start or 0,
                                       at=at)
            return attention_prefill(q, k_row, v_row, positions)
        return attend

    return _forward(params, c, tokens, factory, shard=shard)[0], cache


def prefill_into_slots(params: dict, config: LlamaConfig,
                       tokens: torch.Tensor, cache: dict, slots,
                       starts) -> tuple[torch.Tensor, dict]:
    """Batched multi-slot admission: one prompt chunk for N sequences in
    one pass, each row writing its k/v into its own cache row.  tokens:
    [N, S]; slots/starts: N host integers.  Rows may duplicate another
    row (same slot, start and tokens): the writes are idempotent, which
    is how the batcher pads N to a power of two.  Dense attention only
    (flash admission keeps per-slot calls: its q_offset is per call).
    Returns (logits [N, S, vocab], cache).

    On a placed tree each dp group runs the rows whose slots it holds
    (:func:`_admit_on_mesh`), so rows of one burst may fall in several
    groups; a mixture-of-experts burst still routes as one."""
    if config.attention == "flash":
        raise ValueError("prefill_into_slots is dense-only; "
                         "flash admission uses prefill_into_slot")
    slots = [int(slot) for slot in slots]
    starts = [int(start) for start in starts]
    if isinstance(params, Placed):
        return _admit_on_mesh(params, config, tokens, cache, slots, starts,
                              batched=True)
    return _prefill_into_slots_impl(params, config, tokens, cache, slots,
                                    starts)


def _prefill_into_slots_impl(params: dict, config: LlamaConfig,
                             tokens: torch.Tensor, cache: dict, slots: list,
                             starts: list, shard: TensorShard | None = None):
    c = config
    n, s = tokens.shape
    extent = cache_extent(cache)
    if any(start < 0 or start + s > extent for start in starts):
        raise ValueError(f"prefill_into_slots: a chunk of {s} tokens at "
                         f"{starts} does not fit the cache extent {extent}")
    paged = is_paged(cache)
    if paged:
        _require_whole_pages(cache, starts, s)
    rope = _rope(c, tokens.device)
    positions = upload(torch.tensor(starts), tokens.device)[:, None] \
        + torch.arange(s, device=tokens.device)[None, :]
    slot_index = upload(torch.tensor([0 if slot is None else slot
                                      for slot in slots]), tokens.device)

    def factory(index):
        def write_rows(arr, value):
            for row, (slot, start) in enumerate(zip(slots, starts)):
                if slot is not None:        # None: padding, writes nothing
                    arr[index, slot, start:start + s] = value[row]

        def attend(q, k, v):
            q = apply_rope(q, rope, positions)
            k = apply_rope(k, rope, positions)
            if paged:
                table, pt = cache["page_table"], pool_page_tokens(cache)
                for side, new in (("k", k), ("v", v)):
                    layer = _at_layer(cache[side], index)
                    scatter_pages(layer, _kv_stored(layer, new), table,
                                  slots, starts, pt)
                rows_table = table[slot_index]
                k_rows = gather_layer(_at_layer(cache["k"], index),
                                      rows_table)
                v_rows = gather_layer(_at_layer(cache["v"], index),
                                      rows_table)
            else:
                for side, new in (("k", k), ("v", v)):
                    _kv_write(cache[side], _kv_stored(cache[side], new),
                              write_rows)
                k_rows, v_rows = (map_leaf(cache[side],
                                          lambda arr: arr[index][slot_index])
                                  for side in ("k", "v"))
            return attention_prefill(q, _grouped(k_rows, c.head_dim),
                                     _grouped(v_rows, c.head_dim),
                                     positions)
        return attend

    return _forward(params, c, tokens, factory, shard=shard)[0], cache


def _batch_axes(cache: Placed) -> tuple:
    """The mesh axes a placed cache splits its batch over (none for a
    paged cache or a batch kept whole)."""
    entry = _batch_spec(cache)[0]
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _admit_on_mesh(params: Placed, config: LlamaConfig, tokens, cache,
                   slots: list, starts: list, batched: bool):
    """Admission on a placed tree and cache: the chunk rows ``tokens``
    [N, S] (whole, on the mesh's first device of this process) for
    ``slots`` at
    ``starts``.  Each slot lives in one group of the axes the cache
    splits its batch over (dp; none for a paged cache, whose batch is
    whole): only that group's positions run the slot's rows, writing its
    local row (slot mod the group's rows) with their kv heads.  When
    the rows fall in one group, the others run nothing and write
    nothing, and its positions hold the whole burst, so the MoE routes
    it whole.  A mixture-of-experts burst over several groups runs at
    every group, each on its own rows padded to the largest group's
    count (:class:`BurstShard`), so it still routes as one burst.
    Returns (logits [N, S, vocab] whole on the first device of this
    process -- over processes every process gets them whole --, in row
    order, the cache placed)."""
    mesh = params.mesh
    tp = mesh.shape.get("tp", 1)
    if config.n_kv_heads % tp:
        raise ValueError(f"tp ({tp}) must divide n_kv_heads "
                         f"({config.n_kv_heads})")
    if not isinstance(cache, Placed):
        raise ValueError("admission on a placed tree needs the cache "
                         "placed (plan.put(cache, cache_specs(config)))")
    axes = _batch_axes(cache)
    sizes = [mesh.shape[axis] for axis in axes]
    rows_per_group = cache_array(cache).shape[1]
    owned: dict[int, list] = {}
    for row, slot in enumerate(slots):
        group, local = divmod(slot, rows_per_group) if axes else (0, slot)
        owned.setdefault(group, []).append((row, local))
    burst = bool(config.n_experts) and len(owned) > 1
    if burst:
        width = max(len(mine) for mine in owned.values())
        order, padding = [], len(slots)
        for group in range(math.prod(sizes)):
            mine = owned.get(group, [])
            order += [row for row, _ in mine]
            order += range(padding, padding + width - len(mine))
            padding += width - len(mine)
    specs = params.specs
    whole = list(range(len(slots)))

    def local(p, t, c):
        group = axis_index(axes) if axes else 0
        mine = owned.get(group, [])
        rows = [row for row, _ in mine]
        mine_slots = [slot for _, slot in mine]
        mine_starts = [starts[row] for row in rows]
        if burst:
            pad = width - len(mine)
            keep = torch.arange(width, device=t.device) < len(mine)
            shard = BurstShard(mesh, specs, axes,
                               upload(torch.tensor(order), t.device),
                               len(slots), keep)
            rows += [0] * pad
            mine_slots += [None] * pad
            mine_starts += [0] * pad
        elif not mine:
            return None, c
        else:
            shard = TensorShard(mesh, specs, ())
            shard.counts_routes = all(
                axis_index(axis) == 0 for axis in mesh.axis_names
                if axis not in axes and mesh.shape[axis] > 1)
        if rows != whole:
            t = torch.cat([t[row:row + 1] for row in rows])
        if not batched:
            return _prefill_into_slot_impl(p, config, t, c, mine_slots[0],
                                           mine_starts[0], shard)
        return _prefill_into_slots_impl(p, config, t, c, mine_slots,
                                        mine_starts, shard)
    each, cache = shard_map(local, mesh,
                            in_specs=(None, P(None, None), None),
                            out_specs=(Each(), Keep(cache.specs)))(
        params, tokens, cache)
    vocab = filter_spec(mesh, P("tp"))[0]
    by_row = {}
    for group, mine in owned.items():
        at = dict(zip(axes, (int(i) for i in np.unravel_index(group, sizes))))
        logits = assemble(mesh, P(None, None, vocab), each, None, at)
        by_row.update((row, logits[index:index + 1])
                      for index, (row, _) in enumerate(mine))
    if len(owned) == 1 and list(by_row) == whole:
        return logits, cache            # one group, its rows in order
    return torch.cat([by_row[row] for row in whole]), cache


def _resolve_decode_flash(c: LlamaConfig, cache: dict) -> bool:
    """Pick the decode attention backend eagerly through the ops
    capability probe: paged caches go to the page-table-walking kernel
    #3, dense flash-eligible caches to the stacked split-K kernel #2,
    everything else to the reference path.  One device holds the whole
    cache, so nothing here is distributed."""
    paged = is_paged(cache)
    backend = decode_backend(
        c.decode_attention, paged=paged, extent=cache_extent(cache),
        threshold=c.flash_decode_threshold,
        page_tokens=pool_page_tokens(cache) if paged else None)
    return backend != "reference"


def _decode_step_impl(params: dict, config: LlamaConfig,
                      tokens: torch.Tensor, cache: dict,
                      lengths: torch.Tensor, use_flash: bool,
                      shard: TensorShard | None = None) \
        -> tuple[torch.Tensor, dict]:
    """One token per row.  tokens: [B]; lengths: [B] write positions
    (= current sequence lengths).  No host synchronisation: every index
    stays on the device.  A paged cache writes row b's k/v at
    ``table[b, pos // pt], pos % pt`` (the trash page for a row whose
    table entry is 0)."""
    c = config
    b = tokens.shape[0]
    rope = _rope(c, tokens.device)
    lengths = lengths.to(torch.int32)
    positions = lengths.long()[:, None]                       # [B, 1]
    paged = is_paged(cache)
    if paged:
        table = cache["page_table"]
        page_tokens = pool_page_tokens(cache)
        rows = table.gather(1, positions // page_tokens)[:, 0].long()
        cols = positions[:, 0] % page_tokens
        split = _split_paged
    else:
        rows = torch.arange(b, device=tokens.device)
        cols = positions[:, 0]
        split = _split_stacked
    if use_flash:
        k_view = split(cache["k"])
        v_view = split(cache["v"])

    def factory(index):
        def write(arr, value):
            arr[index][rows, cols] = value[:, 0]

        def attend(q, k, v):
            q = apply_rope(q, rope, positions)
            k = apply_rope(k, rope, positions)
            if use_flash and paged:
                out = flash_decode_append_paged(q, k_view, v_view, index,
                                                k, v, table, lengths)
            elif use_flash:
                out = flash_decode_append_stacked(q, k_view, v_view, index,
                                                  k, v, lengths)
            else:
                k_layer = _at_layer(cache["k"], index)
                v_layer = _at_layer(cache["v"], index)
                if paged:
                    k_layer = gather_layer(k_layer, table)
                    v_layer = gather_layer(v_layer, table)
                out = attention_decode_append(
                    q, _grouped(k_layer, c.head_dim),
                    _grouped(v_layer, c.head_dim), k, v, lengths)
            for side, new in (("k", k), ("v", v)):
                _kv_write(cache[side], _kv_stored(cache[side], new), write)
            return out
        return attend

    logits, _ = _forward(params, c, tokens[:, None], factory, shard=shard)
    return logits[:, 0, :], cache


def decode_step(params: dict, config: LlamaConfig, tokens: torch.Tensor,
                cache: dict, lengths: torch.Tensor) \
        -> tuple[torch.Tensor, dict]:
    """One decode token per row (see _decode_step_impl); the flash
    versus dense choice resolves here, on the cache's structure -- at
    each position of a mesh on its own cache shard, for a placed tree
    and cache (:func:`_on_mesh`: the kernels run per position)."""
    if isinstance(params, Placed):
        return _on_mesh(_decode_step_local, params, config, tokens, cache,
                        (lengths,), logits_dims=1)
    return _decode_step_local(params, config, tokens, cache, lengths)


def _decode_step_local(params, config, tokens, cache, lengths, shard=None):
    return _decode_step_impl(params, config, tokens, cache, lengths,
                             _resolve_decode_flash(config, cache), shard)


def _batch_spec(cache) -> P:
    """The batch entry of a placed cache's layout (its payload's dim 1)."""
    spec = cache.specs["k"]
    return P((spec["int8"] if isinstance(spec, dict) else spec)[1])


def _on_mesh(body, params: Placed, config: LlamaConfig, tokens, cache,
             per_row: tuple, logits_dims: int, aux: bool = False,
             batch_axes=("dp",)):
    """Run an entry point's ``body(params, config, tokens, cache,
    *per_row, shard=...)`` at every position of ``params``' mesh
    (``parallel.shard_map``): the placed tree and a placed cache as they
    stand, tokens and the [B] ``per_row`` tensors split with the batch
    (over ``batch_axes``, or as a placed cache or placed tokens lay it
    out).  Returns (the logits whole -- vocabulary reassembled over tp --,
    the cache placed[, the aux]); ``cache=None`` makes a fresh local
    cache a position and returns None for it."""
    mesh = params.mesh
    tp = mesh.shape.get("tp", 1)
    if config.n_kv_heads % tp:
        raise ValueError(f"tp ({tp}) must divide n_kv_heads "
                         f"({config.n_kv_heads})")
    batch = filter_spec(mesh, P(batch_axes))
    if isinstance(tokens, Placed):
        batch = P(tokens.specs[0])
    if isinstance(cache, Placed):
        if isinstance(tokens, Placed) and _batch_spec(cache) != batch:
            raise ValueError(f"tokens placed with the batch over "
                             f"{batch[0]}, the cache over "
                             f"{_batch_spec(cache)[0]}")
        batch = _batch_spec(cache)
    row_axes = tuple(axis for axis in (batch[0] if isinstance(
        batch[0], tuple) else (batch[0],)) if axis)
    cache_in = cache_out = None
    if isinstance(cache, Placed):
        cache_out = Keep(cache.specs)
    elif cache is not None:
        cache_in = cache_specs(config)
        cache_out = Keep(cache_in)
    token_spec = None if isinstance(tokens, Placed) \
        else P(batch[0], *([None] * (tokens.ndim - 1)))
    specs = params.specs

    def local(p, t, c, *rows):
        shard = TensorShard(mesh, specs, row_axes)
        return body(p, config, t, c, *rows, shard=shard)
    vocab = filter_spec(mesh, P("tp"))[0]
    out_specs = (P(batch[0], *([None] * (logits_dims - 1)), vocab),
                 cache_out)
    if aux:
        out_specs += (P(),)
    return shard_map(local, mesh,
                     in_specs=(None, token_spec, cache_in,
                               *[batch] * len(per_row)),
                     out_specs=out_specs)(params, tokens, cache, *per_row)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(-1)


def _categorical(generator: torch.Generator,
                 logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max rule
    (no host synchronisation; -inf logits are never drawn)."""
    uniform = torch.rand(logits.shape, generator=generator,
                         device=logits.device, dtype=torch.float32)
    return (logits - torch.log(-torch.log(uniform))).argmax(-1)


def temperature_sample(generator: torch.Generator, logits: torch.Tensor,
                       temperature: float = 0.7) -> torch.Tensor:
    return _categorical(generator, logits.float() / temperature)


def select_tokens(generator: torch.Generator, logits: torch.Tensor,
                  temperatures: torch.Tensor,
                  top_k: int = 0) -> torch.Tensor:
    """Per-row sampling: rows at temperature 0 take the argmax, the
    others a categorical draw at their own temperature.  ``top_k`` > 0
    restricts the draw to the k highest logits through the ops top-k
    (the CUDA kernel on the card); greedy rows are unaffected (argmax ==
    top-1).  Draws come from ``generator``, not from jax.random, so
    sampled rows match the JAX package only in distribution."""
    greedy = logits.argmax(-1)
    safe = torch.clamp(temperatures, min=0.05)[:, None]
    if top_k:
        values, indices = ops_topk(logits.float().contiguous(), int(top_k))
        choice = _categorical(generator, values / safe)
        sampled = indices.gather(1, choice[:, None])[:, 0].long()
    else:
        sampled = _categorical(generator, logits.float() / safe)
    return torch.where(temperatures > 0, sampled, greedy)


def _decode_stepper(params, config: LlamaConfig, cache):
    """The decode step of a block or loop: the placed :func:`decode_step`
    on a placed tree (each position resolves its backend on its shard),
    else the one-device step with the backend resolved once."""
    if isinstance(params, Placed):
        return decode_step
    use_flash = _resolve_decode_flash(config, cache)
    return lambda p, c, tokens, kv, lengths: _decode_step_impl(
        p, c, tokens, kv, lengths, use_flash)


def decode_block(params: dict, config: LlamaConfig, tokens: torch.Tensor,
                 cache: dict, lengths: torch.Tensor, active: torch.Tensor,
                 temperatures: torch.Tensor, generator: torch.Generator, *,
                 num_steps: int, top_k: int = 0):
    """``num_steps`` decode iterations with sampling, enqueued back to
    back with no host synchronisation.  tokens/lengths: [B] device
    tensors; active: [B] bool (inactive rows write to the trash position
    T-1, as in the single-step batcher tick).  Returns (emitted
    [num_steps, B] int32, tokens' [B], lengths' [B], cache).

    On a placed tree and cache every step is the placed
    :func:`decode_step` (the kernels at each position on its shards) and
    the sampling runs on its whole logits, on the mesh's first device of
    this process: over processes each samples the whole rows itself,
    from logits equal bit for bit in every process, with its own
    generator seeded alike, so the tokens agree and top-k launches once
    a step in each process."""
    trash = cache_extent(cache) - 1
    step = _decode_stepper(params, config, cache)
    emitted = []
    for _ in range(num_steps):
        positions = torch.where(active, torch.clamp(lengths, max=trash),
                                torch.full_like(lengths, trash))
        logits, cache = step(params, config, tokens, cache, positions)
        tokens = select_tokens(generator, logits, temperatures,
                               top_k=top_k).to(torch.int32)
        lengths = lengths + active.to(lengths.dtype)
        emitted.append(tokens)
    return torch.stack(emitted), tokens, lengths, cache


# ---------------------------------------------------------------------------
# Device-resident generation loop: sampling, stop detection and speculation
# for ``ring`` tokens per row in one block of device work, with no host
# synchronisation inside.


def _ngram_draft(history: torch.Tensor, tokens: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Self-drafting proposal from the recent-token window: find the most
    recent PRIOR occurrence of the current token in ``history`` (the
    newest entry IS the current token) and propose the ``k`` tokens that
    followed it; rows with no prior occurrence repeat the current token.
    Unfilled window entries are -1 (never a real token id) and fall back
    to repetition too.

    history: [B, W] (old -> new); tokens: [B].  Returns [B, k] int32."""
    w = history.shape[1]
    prior = history[:, :-1]                          # continuation exists
    match = prior == tokens[:, None]
    index = torch.arange(w - 1, device=history.device)[None, :]
    latest = torch.where(match, index, torch.full_like(index, -1)).amax(1)
    gather = torch.clamp(
        latest[:, None] + 1 + torch.arange(k, device=history.device)[None, :],
        0, w - 1)
    continuation = history.gather(1, gather)
    drafts = torch.where((latest >= 0)[:, None] & (continuation >= 0),
                         continuation, tokens[:, None].to(history.dtype))
    return drafts.to(torch.int32)


def _history_push(history: torch.Tensor, candidates: torch.Tensor,
                  cut: torch.Tensor) -> torch.Tensor:
    """Append each row's first ``cut[b]`` candidate tokens to its
    recent-token window, dropping the oldest: one per-row gather over
    ``cat(history, candidates)`` shifted by ``cut`` -- rejected
    candidates (beyond the cut) sit past the gather's reach."""
    w = history.shape[1]
    combined = torch.cat([history, candidates.to(history.dtype)], dim=1)
    index = torch.arange(w, device=history.device)[None, :] \
        + cut.long()[:, None]
    return combined.gather(1, index)


def _draft_window(draft: dict, config: LlamaConfig, tokens, cache: dict,
                  lengths, active, k: int, window: int, trash: int,
                  shard: TensorShard | None = None):
    """``k`` greedy draft tokens per row from ONE read of the cache: the
    last ``window`` positions of each row are gathered once (int8 windows
    dequantized, small), and the k autoregressive draft steps attend over
    window + the steps' own scratch k/v through
    :func:`attention_prefill` with explicit key positions.  Nothing is
    written to the cache: the verify step writes target-model k/v at
    these positions.  The window approximates the full prefix (draft
    quality only: verify accepts matching tokens alone).
    tokens/lengths/active: [B]; returns drafts [B, k] int32.  With
    ``shard`` it runs at one mesh position (:func:`_draft_on_mesh`): its
    kv heads and leaf shards, each step's logits gathered over tp for
    the argmax."""
    c = config
    b = tokens.shape[0]
    w = int(window)
    device = tokens.device
    extent = cache_extent(cache)
    rope = _rope(c, device)
    kernel = _matmul_kernel(c, device)
    dtype = _dtype(c)
    lengths = lengths.long()
    # Window = the last w valid positions of each row (clamped; rows
    # shorter than w mask the underflow out).
    wpos_raw = lengths[:, None] - w + torch.arange(w, device=device)[None, :]
    wvalid = wpos_raw >= 0
    wpos = torch.clamp(wpos_raw, 0, extent - 1)               # [B, W]
    if is_paged(cache):
        pt = pool_page_tokens(cache)
        linear = cache["page_table"].gather(1, wpos // pt).long() * pt \
            + wpos % pt

        def take(arr):                                  # [L, P, pt, ...]
            return arr.reshape(arr.shape[0], -1, *arr.shape[3:])[:, linear]
    else:
        rows = torch.arange(b, device=device)[:, None]

        def take(arr):                                  # [L, B, T, ...]
            return arr[:, rows, wpos]

    def gather_window(side):
        """One cache side -> the window [L, B, W, K, hd] in the model
        dtype: the only read of the cache."""
        win = _grouped(map_leaf(side, take), c.head_dim)
        if is_quantized(win):
            win = dequantize_kv(win, dtype)
        return win.to(dtype)

    win_k, win_v = gather_window(cache["k"]), gather_window(cache["v"])
    # Scratch k/v for this call's draft tokens: column j holds step j's
    # k/v at position lengths + j.
    kv_heads = c.n_kv_heads // (shard.size if shard is not None else 1)
    scratch_k = torch.zeros((c.n_layers, b, k, kv_heads, c.head_dim),
                            dtype=dtype, device=device)
    scratch_v = torch.zeros_like(scratch_k)
    spos = torch.clamp(lengths[:, None]
                       + torch.arange(k, device=device)[None, :], max=trash)
    embed = draft["embed"] if shard is None \
        else shard.whole(draft["embed"], shard.specs["embed"])
    current = tokens
    drafts = []
    for step in range(k):
        pos = torch.where(active, torch.clamp(lengths + step, max=trash),
                          torch.full_like(lengths, trash))[:, None]
        svalid = (torch.arange(k, device=device) < step)[None, :] \
            .expand(b, k)
        kv_positions = torch.cat([wpos, spos, pos], dim=1)   # [B, W+k+1]
        valid = torch.cat([wvalid, svalid,
                           torch.ones((b, 1), dtype=torch.bool,
                                      device=device)], dim=1)
        hidden = embed[current.long()[:, None]]              # [B, 1, D]
        for index in range(c.n_layers):
            def attend(q, kk, vv, index=index):
                q = apply_rope(q, rope, pos)
                kk = apply_rope(kk, rope, pos)
                k_all = torch.cat([win_k[index], scratch_k[index],
                                   kk.to(dtype)], dim=1)
                v_all = torch.cat([win_v[index], scratch_v[index],
                                   vv.to(dtype)], dim=1)
                out = attention_prefill(q, k_all, v_all, pos,
                                        kv_length_mask=valid,
                                        kv_positions=kv_positions)
                scratch_k[index, :, step] = kk[:, 0].to(dtype)
                scratch_v[index, :, step] = vv[:, 0].to(dtype)
                return out
            layer = _layer(draft, index)
            if shard is not None:
                layer = shard.gathered(layer)
            hidden, _ = _block(c, hidden, layer, attend, kernel, shard)
        logits = _finish(draft, c, hidden, kernel, shard)    # [B, 1, V]
        if shard is not None and shard.size > 1:
            logits = all_gather(logits, "tp", axis=-1)
        current = logits[:, 0, :].argmax(-1).to(torch.int32)
        drafts.append(current)
    return torch.stack(drafts, dim=1)


def _draft_on_mesh(draft: Placed, config: LlamaConfig, tokens, cache,
                   lengths, active, k: int, window: int, trash: int):
    """:func:`_draft_window` on a placed draft tree and cache: each
    position drafts the rows its cache shard holds (the batch split as
    the cache splits it) on its leaf shards; the drafts come back whole
    [B, k] on the mesh's first device of this process (in every
    process, over processes)."""
    mesh = draft.mesh
    batch = _batch_spec(cache)
    specs = draft.specs

    def local(p, t, c, rows_lengths, rows_active):
        shard = TensorShard(mesh, specs, _batch_axes(cache))
        return _draft_window(p, config, t, c, rows_lengths, rows_active, k,
                             window, trash, shard)
    return shard_map(local, mesh, in_specs=(None, batch, None, batch, batch),
                     out_specs=P(batch[0], None))(draft, tokens, cache,
                                                  lengths, active)


def _chunk_verify(params: dict, config: LlamaConfig, chunk, cache: dict,
                  starts, trash: int, use_flash: bool = False,
                  shard: TensorShard | None = None):
    """One batched multi-token target step: forward ``chunk`` [B, S]
    (current token + S-1 draft tokens per row) at positions
    ``starts + i``, writing every position's k/v optimistically and
    returning logits [B, S, V] for all S positions.  Rejected drafts
    leave k/v beyond the advanced length, which the length masks never
    admit and later steps overwrite.  Positions clamp to the trash
    position at the cache boundary.

    ``use_flash`` routes the attention through the chunk-verify kernel
    (``flash_verify_append``: the cache read once for all S positions,
    the page table walked in the kernel, int8 dequantized in the
    kernel); otherwise the dense concat route attends the cache rows
    (a paged cache gathered, int8 rows dequantized) concatenated with
    the chunk's own k/v.  Each layer's S writes land in place after
    that layer's attention, which never admits positions >= starts.

    On a placed tree and cache it runs at every mesh position
    (:func:`_on_mesh`: the verify kernel on each position's kv heads),
    the logits whole."""
    if isinstance(params, Placed):
        return _on_mesh(functools.partial(_chunk_verify_local, trash),
                        params, config, chunk, cache, (starts,),
                        logits_dims=2)
    c = config
    b, s = chunk.shape
    device = chunk.device
    rope = _rope(c, device)
    starts = starts.to(torch.int32)
    positions = torch.clamp(starts.long()[:, None]
                            + torch.arange(s, device=device)[None, :],
                            max=trash)                         # [B, S]
    paged = is_paged(cache)
    extent = cache_extent(cache)
    if paged:
        table = cache["page_table"]
        page_tokens = pool_page_tokens(cache)
        rows = table.gather(1, positions // page_tokens).long()
        cols = positions % page_tokens
        split = _split_paged
    else:
        rows = torch.arange(b, device=device)[:, None].expand(b, s)
        cols = positions
        split = _split_stacked
    if use_flash:
        k_view = split(cache["k"])
        v_view = split(cache["v"])
    else:
        kv_positions = torch.cat(
            [torch.arange(extent, device=device)[None, :].expand(b, extent),
             positions], dim=1)
        valid = torch.cat(
            [torch.arange(extent, device=device)[None, :]
             < starts.long()[:, None],
             torch.ones((b, s), dtype=torch.bool, device=device)], dim=1)

    def factory(index):
        def write(arr, value):
            arr[index][rows, cols] = value

        def attend(q, k, v):
            q = apply_rope(q, rope, positions)
            k = apply_rope(k, rope, positions)
            if use_flash:
                out = flash_verify_append(
                    q, k_view, v_view, index, k, v, starts, positions,
                    page_table=table if paged else None)
            else:
                k_layer = _at_layer(cache["k"], index)
                v_layer = _at_layer(cache["v"], index)
                if paged:
                    k_layer = gather_layer(k_layer, table)
                    v_layer = gather_layer(v_layer, table)
                k_rows = _grouped(k_layer, c.head_dim)
                v_rows = _grouped(v_layer, c.head_dim)
                if is_quantized(k_rows):
                    k_rows = dequantize_kv(k_rows, q.dtype)
                    v_rows = dequantize_kv(v_rows, q.dtype)
                out = attention_prefill(
                    q, torch.cat([k_rows, k.to(k_rows.dtype)], dim=1),
                    torch.cat([v_rows, v.to(v_rows.dtype)], dim=1),
                    positions, kv_length_mask=valid,
                    kv_positions=kv_positions)
            for side, new in (("k", k), ("v", v)):
                _kv_write(cache[side], _kv_stored(cache[side], new), write)
            return out
        return attend

    return _forward(params, c, chunk, factory, shard=shard)[0], cache


def _chunk_verify_local(trash, params, config, chunk, cache, starts,
                        shard=None):
    return _chunk_verify(params, config, chunk, cache, starts, trash,
                         _resolve_decode_flash(config, cache), shard)


_LOOP_MODES = ("off", "ngram", "draft")


def decode_loop(params: dict, config: LlamaConfig, tokens: torch.Tensor,
                cache: dict, lengths: torch.Tensor, active: torch.Tensor,
                budget: torch.Tensor, temperatures: torch.Tensor,
                eos: torch.Tensor, history: torch.Tensor,
                generator: torch.Generator, *, ring: int,
                speculative: str = "off", spec_tokens: int = 4,
                spec_window: int = 32, draft: dict | None = None,
                top_k: int = 0):
    """The device-resident serving loop: up to ``ring`` tokens per row in
    one block, with sampling, per-row stop detection (EOS, budget, cache
    boundary) and speculative multi-token decoding (``ngram``: drafts
    from the recent-token window; ``draft``: greedy drafts of the
    ``draft`` tree, the int8 self-draft) on the device.

    tokens: [B] current (sampled, unprocessed) tokens; lengths: [B]
    valid cache positions; active: [B] bool; budget: [B] tokens each row
    may still emit; temperatures: [B]; eos: [B, E] stop tokens (-1
    pads); history: [B, W] recent-token window for the ngram draft
    ([B, 1] otherwise); ``generator`` draws the samples (the JAX
    package's ``key``).

    The JAX package's ``lax.while_loop`` becomes a FIXED number of
    masked iterations with no host synchronisation -- ``ring`` plain,
    ``ring - spec_tokens`` speculative (an active row emits at least one
    token an iteration, so the room test never holds longer).  Each
    iteration computes the while loop's condition on the device (some
    row active, the ring holding one more worst-case emission) and
    gates every update with ``active & cond``: once the condition fails
    nothing changes, inactive rows write to the trash position, and
    ``steps`` counts the iterations where it held.  Every carry comes
    back as a new tensor; the inputs are never written.

    Returns ``(emitted [B, ring], counts [B], tokens', lengths',
    active', budget', history', generator, accepted [B], drafted [B],
    steps, cache)``, int32 except the bool ``active'``.

    On a placed tree and cache every iteration's model work runs at each
    mesh position on its shards -- the placed :func:`decode_step`, the
    placed verify forward (:func:`_chunk_verify`) and draft
    (:func:`_draft_on_mesh`, on a draft tree placed on the same mesh) --
    and everything else -- the sampling, the acceptance and stop tests,
    the carries -- runs on the whole rows on the mesh's first device of
    this process (every process runs it alike over a mesh that spans
    processes), so the block is still one launch sequence with no host
    synchronisation (``models/loop_graph.py`` captures it with every
    position's work of this process)."""
    if speculative not in _LOOP_MODES:
        raise ValueError(
            f"speculative={speculative!r}: one of off|ngram|draft")
    ring = int(ring)
    b = tokens.shape[0]
    device = tokens.device
    extent = cache_extent(cache)
    trash = extent - 1
    spec = speculative != "off"
    k = int(spec_tokens) if spec else 0
    per_iter = k + 1
    window = max(1, int(spec_window))
    draft = draft if draft is not None else params
    step_fn = _decode_stepper(params, config, cache)
    use_flash = None if isinstance(params, Placed) \
        else _resolve_decode_flash(config, cache)
    int32 = torch.int32
    tokens, lengths, budget = (x.to(int32) for x in (tokens, lengths,
                                                     budget))
    rows = torch.arange(b, device=device)
    offsets = torch.arange(per_iter, device=device)[None, :]  # [1, k+1]
    emitted = torch.zeros((b, ring + 1), dtype=int32, device=device)
    counts = torch.zeros((b,), dtype=int32, device=device)
    accepted = torch.zeros_like(counts)
    drafted = torch.zeros_like(counts)
    steps = torch.zeros((), dtype=int32, device=device)
    trash_rows = torch.full_like(lengths, trash)

    def stops(token, budget_left, total):
        """Stop verdict after emitting ``token`` (any shape with a
        trailing eos broadcast) -- the host batcher's finish test."""
        return ((token[..., None] == eos.reshape(
            b, *(1,) * (token.ndim - 1), -1)).any(-1)
                | (budget_left <= 0) | (total >= extent))

    for _ in range(ring - k):
        room = torch.where(active, counts, torch.zeros_like(counts)).amax() \
            + per_iter <= ring
        go = active.any() & room
        live = active & go
        steps = steps + go.to(int32)
        if not spec:
            positions = torch.where(live, torch.clamp(lengths, max=trash),
                                    trash_rows)
            logits, cache = step_fn(params, config, tokens, cache, positions)
            sampled = select_tokens(generator, logits, temperatures,
                                    top_k=top_k).to(int32)
            slot_index = torch.where(live, counts,
                                     torch.full_like(counts, ring))
            emitted = emitted.index_put((rows, slot_index.long()), sampled)
            step = live.to(int32)
            counts, lengths, budget = counts + step, lengths + step, \
                budget - step
            stopped = stops(sampled, budget, lengths) & live
            tokens = torch.where(live, sampled, tokens)
            active = active & ~stopped
            continue
        greedy_row = live & (temperatures <= 0)
        if speculative == "ngram":
            drafts = _ngram_draft(history, tokens, k)
        elif isinstance(draft, Placed):
            drafts = _draft_on_mesh(draft, config, tokens, cache, lengths,
                                    live, k, window, trash)
        else:
            drafts = _draft_window(draft, config, tokens, cache, lengths,
                                   live, k, window, trash)
        chunk = torch.cat([tokens[:, None], drafts], dim=1)   # [B, k+1]
        starts = torch.where(live, torch.clamp(lengths, max=trash),
                             trash_rows)
        logits, cache = _chunk_verify(params, config, chunk, cache, starts,
                                      trash, use_flash)
        greedy = logits.argmax(-1).to(int32)                 # [B, k+1]
        first = select_tokens(generator, logits[:, 0, :], temperatures,
                              top_k=top_k).to(int32)
        candidates = torch.cat([first[:, None], greedy[:, 1:]], dim=1)
        # Longest matching draft prefix; sampled rows accept none (their
        # per-token distribution stays the non-speculative one).
        match = (chunk[:, 1:] == candidates[:, :-1]) & greedy_row[:, None]
        accept = torch.cumprod(match.to(int32), dim=1).sum(1)
        stop_at = stops(candidates, budget[:, None] - (offsets + 1),
                        lengths[:, None] + offsets + 1)
        clean_before = torch.cumsum(
            torch.nn.functional.pad(stop_at[:, :-1].to(int32), (1, 0)),
            dim=1) == 0
        emit_at = (offsets <= accept[:, None]) & clean_before \
            & live[:, None]
        cut = emit_at.sum(1).to(int32)
        slot_index = torch.where(emit_at, counts[:, None] + offsets,
                                 torch.full_like(emit_at, ring, dtype=int32))
        emitted = emitted.scatter(1, slot_index.long(), candidates)
        counts, lengths, budget = counts + cut, lengths + cut, budget - cut
        stopped = (emit_at & stop_at).any(1)
        last = candidates.gather(
            1, torch.clamp(cut - 1, min=0).long()[:, None])[:, 0]
        tokens = torch.where(live & (cut > 0), last, tokens)
        accepted = accepted + torch.where(live, torch.clamp(cut - 1, min=0),
                                          torch.zeros_like(cut))
        drafted = drafted + torch.where(greedy_row, torch.full_like(cut, k),
                                        torch.zeros_like(cut))
        if speculative == "ngram":
            history = _history_push(history, candidates, cut)
        active = active & ~stopped
    return (emitted[:, :ring], counts, tokens, lengths, active, budget,
            history, generator, accepted, drafted, steps, cache)
