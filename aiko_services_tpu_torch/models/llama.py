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

Not yet ported (raises ``NotImplementedError`` naming its ROADMAP item):
mixture-of-experts.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import decode_backend, matmul_backend, topk as ops_topk
from ..ops.flash_attention import flash_attention
from ..ops.flash_decode import (_split_paged, _split_stacked,
                                flash_decode_append_paged,
                                flash_decode_append_stacked,
                                flash_verify_append)
from ..ops.int8_matmul import int8_matmul
from ..ops.layers import (apply_rope, attention_decode_append,
                          attention_prefill, rms_norm, rope_frequencies)
from ..utils.misc import not_ported
from .paged import (gather_layer, gather_slot, is_paged, paged_extent,
                    pool_page_tokens, scatter_pages)
from .quant import dequantize_kv, is_quantized, map_leaf, quantize_kv

__all__ = ["LlamaConfig", "init_params", "param_shapes", "init_cache",
           "cache_array", "cache_extent", "prefill", "prefill_into_slot",
           "prefill_into_slots", "decode_step", "decode_block",
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


def _dtype(config: LlamaConfig) -> torch.dtype:
    if config.dtype not in _DTYPES:
        raise ValueError(f"dtype {config.dtype!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[config.dtype]


def param_shapes(config: LlamaConfig) -> dict:
    """The parameter dict's layout: leaf -> (shape, fan_in or None for
    the norm weights, which start at one)."""
    c = config
    if c.n_experts:
        raise not_ported("mixture-of-experts (n_experts > 0)",
                         "ROADMAP Queue 1 item 7")
    hd = c.head_dim
    return {
        "embed": ((c.vocab_size, c.dim), c.dim),
        "layers": {
            "wq": ((c.n_layers, c.dim, c.n_heads * hd), c.dim),
            "wk": ((c.n_layers, c.dim, c.n_kv_heads * hd), c.dim),
            "wv": ((c.n_layers, c.dim, c.n_kv_heads * hd), c.dim),
            "wo": ((c.n_layers, c.n_heads * hd, c.dim), c.n_heads * hd),
            "w_gate": ((c.n_layers, c.dim, c.hidden_dim), c.dim),
            "w_up": ((c.n_layers, c.dim, c.hidden_dim), c.dim),
            "w_down": ((c.n_layers, c.hidden_dim, c.dim), c.hidden_dim),
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
        for part in (out if len(shape) == 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=device, dtype=torch.float32)
                       .mul_(fan_in ** -0.5))
        return out

    return _map_layout(param_shapes(config), lambda spec: leaf(*spec))


def _map_layout(layout: dict, fn) -> dict:
    return {name: _map_layout(value, fn) if isinstance(value, dict)
            else fn(value) for name, value in layout.items()}


def init_cache(config: LlamaConfig, batch: int, max_seq: int | None = None,
               device: str | torch.device | None = None) -> dict:
    """Zeroed KV cache stored FLAT: [L, B, T, K*hd] per side -- the
    contiguous view the decode kernel reads (``cache[layer]`` is a view,
    never a copy).  With ``kv_dtype="int8"`` each side is
    ``{"int8": [L, B, T, K*hd] int8, "scale": [L, B, T, K, 1] float32}``
    (the scales keep the JAX package's grouped shape)."""
    c = config
    device = resolve_device(device)
    t = max_seq or c.max_seq
    shape = (c.n_layers, batch, t, c.n_kv_heads * c.head_dim)
    if c.kv_dtype == "int8":
        def side():
            return {"int8": torch.zeros(shape, dtype=torch.int8,
                                        device=device),
                    "scale": torch.zeros(shape[:-1] + (c.n_kv_heads, 1),
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


def cache_array(cache: dict) -> torch.Tensor:
    """The cache's key payload tensor."""
    k = cache["k"]
    return k["int8"] if is_quantized(k) else k


def cache_extent(cache: dict) -> int:
    """Logical per-slot token extent T; position T-1 is the trash
    position inactive rows write to."""
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


def _grouped(layer, kv: int):
    """Flat [.., T, K*hd] -> grouped [.., T, K, hd] view (the payload of
    an int8 layer; its [.., T, K, 1] scales are grouped already)."""
    def regroup(arr):
        return arr.reshape(*arr.shape[:-1], kv, arr.shape[-1] // kv)
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


def _block(config: LlamaConfig, hidden, layer: dict, attend,
           kernel: bool = False):
    """One transformer block.  ``attend(q, k, v) -> attn_out`` does RoPE,
    the cache write and attention (prefill and decode differ there);
    ``kernel`` routes int8 weight leaves through kernel #5."""
    c = config
    b, s, _ = hidden.shape
    hd = c.head_dim

    def mm(x, w):
        return matmul(x, w, kernel)
    x = rms_norm(hidden, layer["attn_norm"], c.norm_eps)
    q = mm(x, layer["wq"]).reshape(b, s, c.n_heads, hd)
    k = mm(x, layer["wk"]).reshape(b, s, c.n_kv_heads, hd)
    v = mm(x, layer["wv"]).reshape(b, s, c.n_kv_heads, hd)
    attn_out = attend(q, k, v)
    hidden = hidden + mm(attn_out.reshape(b, s, c.n_heads * hd),
                         layer["wo"])
    x = rms_norm(hidden, layer["mlp_norm"], c.norm_eps)
    gate = F.silu(mm(x, layer["w_gate"]))
    return hidden + mm(gate * mm(x, layer["w_up"]), layer["w_down"])


def _forward(params: dict, config: LlamaConfig, tokens: torch.Tensor,
             attend_factory) -> torch.Tensor:
    """Embed, run every layer with ``attend_factory(layer_index)``,
    final-norm and unembed -> logits [B, S, vocab]."""
    kernel = _matmul_kernel(config, tokens.device)
    hidden = params["embed"][tokens]
    for index in range(config.n_layers):
        hidden = _block(config, hidden, _layer(params, index),
                        attend_factory(index), kernel)
    return _finish(params, config, hidden, kernel)


def _finish(params: dict, config: LlamaConfig, hidden,
            kernel: bool = False) -> torch.Tensor:
    hidden = rms_norm(hidden, params["final_norm"], config.norm_eps)
    return matmul(hidden, params["unembed"], kernel)


def prefill(params: dict, config: LlamaConfig, tokens: torch.Tensor,
            cache: dict, start_positions: torch.Tensor) \
        -> tuple[torch.Tensor, dict]:
    """Whole-batch prompt prefill.  tokens: [B, S] (right padding
    allowed); start_positions: [B] cache offset each row begins at.
    Writes each row's k/v at [b, start + i] and returns (logits
    [B, S, vocab], cache).  Dense caches only: paged serving admission
    goes through ``prefill_into_slot(s)``."""
    if is_paged(cache):
        raise ValueError(
            "prefill works on dense caches (training / whole-batch "
            "path); paged serving admission goes through "
            "prefill_into_slot(s)")
    c = config
    b, s = tokens.shape
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
            for side, new in (("k", k), ("v", v)):
                _kv_write(cache[side], _kv_stored(cache[side], new), write)
            return attention_prefill(
                q, _grouped(_at_layer(cache["k"], index), c.n_kv_heads),
                _grouped(_at_layer(cache["v"], index), c.n_kv_heads),
                positions)
        return attend

    return _forward(params, c, tokens, factory), cache


def prefill_into_slot(params: dict, config: LlamaConfig,
                      tokens: torch.Tensor, cache: dict, slot: int,
                      start: int) -> tuple[torch.Tensor, dict]:
    """Process one prompt chunk for ONE sequence, writing its k/v into
    batch row ``slot`` of the batched cache at ``start`` (the continuous
    batcher's admission path).  tokens: [1, S] (right padding allowed).
    Queries attend the slot's whole cache row, so chunk N sees chunks
    0..N-1; with ``attention="flash"`` the kernel's causal offset hides
    the unwritten tail.  Returns (logits [1, S, vocab], cache).

    A PAGED cache is written through its page table: the chunk start
    must be page-aligned and S a whole number of pages (the batcher's
    chunk discipline guarantees both), and the attention row is the
    slot's gathered page view."""
    c = config
    slot, start = int(slot), int(start)
    s = tokens.shape[1]
    extent = cache_extent(cache)
    if start < 0 or start + s > extent:
        raise ValueError(f"prefill_into_slot: chunk [{start}, {start + s})"
                         f" does not fit the cache extent {extent}")
    paged = is_paged(cache)
    if paged:
        _require_whole_pages(cache, [start], s)
    rope = _rope(c, tokens.device)
    positions = (start + torch.arange(s, device=tokens.device))[None, :]

    def factory(index):
        def write(arr, value):
            arr[index, slot:slot + 1, start:start + s] = value

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
                k_row, v_row = (map_leaf(cache[side],
                                        lambda arr: arr[index, slot:slot + 1])
                                for side in ("k", "v"))
            k_row = _grouped(k_row, c.n_kv_heads)
            v_row = _grouped(v_row, c.n_kv_heads)
            if c.attention == "flash":
                # The kernel reads the model dtype: an int8 row is
                # dequantized here (admission is compute-bound; decode,
                # where the bytes matter, never does this).
                if is_quantized(k_row):
                    k_row = dequantize_kv(k_row, q.dtype)
                    v_row = dequantize_kv(v_row, q.dtype)
                return flash_attention(q, k_row, v_row, q_offset=start)
            return attention_prefill(q, k_row, v_row, positions)
        return attend

    return _forward(params, c, tokens, factory), cache


def prefill_into_slots(params: dict, config: LlamaConfig,
                       tokens: torch.Tensor, cache: dict, slots,
                       starts) -> tuple[torch.Tensor, dict]:
    """Batched multi-slot admission: one prompt chunk for N sequences in
    one pass, each row writing its k/v into its own cache row.  tokens:
    [N, S]; slots/starts: N host integers.  Rows may duplicate another
    row (same slot, start and tokens): the writes are idempotent, which
    is how the batcher pads N to a power of two.  Dense attention only
    (flash admission keeps per-slot calls: its q_offset is per call).
    Returns (logits [N, S, vocab], cache)."""
    c = config
    if c.attention == "flash":
        raise ValueError("prefill_into_slots is dense-only; "
                         "flash admission uses prefill_into_slot")
    slots = [int(slot) for slot in slots]
    starts = [int(start) for start in starts]
    n, s = tokens.shape
    extent = cache_extent(cache)
    if any(start < 0 or start + s > extent for start in starts):
        raise ValueError(f"prefill_into_slots: a chunk of {s} tokens at "
                         f"{starts} does not fit the cache extent {extent}")
    paged = is_paged(cache)
    if paged:
        _require_whole_pages(cache, starts, s)
    rope = _rope(c, tokens.device)
    positions = torch.tensor(starts, device=tokens.device)[:, None] \
        + torch.arange(s, device=tokens.device)[None, :]
    slot_index = torch.tensor(slots, device=tokens.device)

    def factory(index):
        def write_rows(arr, value):
            for row, (slot, start) in enumerate(zip(slots, starts)):
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
            return attention_prefill(q, _grouped(k_rows, c.n_kv_heads),
                                     _grouped(v_rows, c.n_kv_heads),
                                     positions)
        return attend

    return _forward(params, c, tokens, factory), cache


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
                      lengths: torch.Tensor, use_flash: bool) \
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
                    q, _grouped(k_layer, c.n_kv_heads),
                    _grouped(v_layer, c.n_kv_heads), k, v, lengths)
            for side, new in (("k", k), ("v", v)):
                _kv_write(cache[side], _kv_stored(cache[side], new), write)
            return out
        return attend

    logits = _forward(params, c, tokens[:, None], factory)
    return logits[:, 0, :], cache


def decode_step(params: dict, config: LlamaConfig, tokens: torch.Tensor,
                cache: dict, lengths: torch.Tensor) \
        -> tuple[torch.Tensor, dict]:
    """One decode token per row (see _decode_step_impl); the flash
    versus dense choice resolves here, on the cache's structure."""
    return _decode_step_impl(params, config, tokens, cache, lengths,
                             use_flash=_resolve_decode_flash(config, cache))


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


def decode_block(params: dict, config: LlamaConfig, tokens: torch.Tensor,
                 cache: dict, lengths: torch.Tensor, active: torch.Tensor,
                 temperatures: torch.Tensor, generator: torch.Generator, *,
                 num_steps: int, top_k: int = 0):
    """``num_steps`` decode iterations with sampling, enqueued back to
    back with no host synchronisation.  tokens/lengths: [B] device
    tensors; active: [B] bool (inactive rows write to the trash position
    T-1, as in the single-step batcher tick).  Returns (emitted
    [num_steps, B] int32, tokens' [B], lengths' [B], cache)."""
    trash = cache_extent(cache) - 1
    use_flash = _resolve_decode_flash(config, cache)
    emitted = []
    for _ in range(num_steps):
        positions = torch.where(active, torch.clamp(lengths, max=trash),
                                torch.full_like(lengths, trash))
        logits, cache = _decode_step_impl(params, config, tokens, cache,
                                          positions, use_flash)
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
                  lengths, active, k: int, window: int, trash: int):
    """``k`` greedy draft tokens per row from ONE read of the cache: the
    last ``window`` positions of each row are gathered once (int8 windows
    dequantized, small), and the k autoregressive draft steps attend over
    window + the steps' own scratch k/v through
    :func:`attention_prefill` with explicit key positions.  Nothing is
    written to the cache: the verify step writes target-model k/v at
    these positions.  The window approximates the full prefix (draft
    quality only: verify accepts matching tokens alone).
    tokens/lengths/active: [B]; returns drafts [B, k] int32."""
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
        win = _grouped(map_leaf(side, take), c.n_kv_heads)
        if is_quantized(win):
            win = dequantize_kv(win, dtype)
        return win.to(dtype)

    win_k, win_v = gather_window(cache["k"]), gather_window(cache["v"])
    # Scratch k/v for this call's draft tokens: column j holds step j's
    # k/v at position lengths + j.
    scratch_k = torch.zeros((c.n_layers, b, k, c.n_kv_heads, c.head_dim),
                            dtype=dtype, device=device)
    scratch_v = torch.zeros_like(scratch_k)
    spos = torch.clamp(lengths[:, None]
                       + torch.arange(k, device=device)[None, :], max=trash)
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
        hidden = draft["embed"][current.long()[:, None]]     # [B, 1, D]
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
            hidden = _block(c, hidden, _layer(draft, index), attend, kernel)
        logits = _finish(draft, c, hidden, kernel)           # [B, 1, V]
        current = logits[:, 0, :].argmax(-1).to(torch.int32)
        drafts.append(current)
    return torch.stack(drafts, dim=1)


def _chunk_verify(params: dict, config: LlamaConfig, chunk, cache: dict,
                  starts, trash: int, use_flash: bool = False):
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
    that layer's attention, which never admits positions >= starts."""
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
                k_rows = _grouped(k_layer, c.n_kv_heads)
                v_rows = _grouped(v_layer, c.n_kv_heads)
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

    return _forward(params, c, chunk, factory), cache


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
    steps, cache)``, int32 except the bool ``active'``."""
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
    use_flash = _resolve_decode_flash(config, cache)
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
            logits, cache = _decode_step_impl(params, config, tokens, cache,
                                              positions, use_flash)
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
