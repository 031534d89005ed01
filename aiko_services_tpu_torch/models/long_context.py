"""Long-context Llama forward: sequence sharded over the ``sp`` mesh axis.

Counterpart of ``aiko_services_tpu/models/long_context.py``.  The model
body is the port's Llama (``models/llama.py``): one ``_block`` a layer,
only the attention changes.  Each position keeps its S/n chunk and
attention runs as a ring (``ppermute`` K/V rotation) or Ulysses
(head-scatter all-to-all) over ``sp``.

The JAX package composes ``sp`` with dp batch sharding and Megatron tp
through its ``jit``'s sharding propagation; the port has no such
compiler, so the whole forward runs under ONE ``shard_map``
(``parallel/mesh.py``): tokens split with the batch over ``dp``/``fsdp``
and the sequence over ``sp``, parameters split by
``llama.partition_specs`` (heads and FFN columns over ``tp``, gathered
over ``fsdp`` at their use), each block a Megatron shard
(``llama.TensorShard``: a ``psum`` over ``tp`` after wo and w_down) and
the logits reassembled whole, as ``out_shardings`` reassembles them.
RoPE rotates each ``sp`` shard by its GLOBAL positions.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from . import llama
from ..ops.layers import apply_rope, repeat_kv, rms_norm
from ..parallel.mesh import (MeshPlan, P, all_gather, axis_index,
                             filter_spec, psum, shard_map)
from ..parallel.ring import (_check_heads, _ulysses_inner,
                             ring_attention_sharded)
from ..utils import not_ported

__all__ = ["make_long_context_forward", "make_long_context_loss"]

_ATTENTION = ("ring", "ulysses")


def _spec_tree(mesh, specs):
    if isinstance(specs, dict):
        return {key: _spec_tree(mesh, value) for key, value in specs.items()}
    return filter_spec(mesh, specs)


def _gathered(leaf: torch.Tensor, spec: P) -> torch.Tensor:
    """A parameter shard whole again along its ``fsdp`` dimensions."""
    for dim, entry in enumerate(spec):
        if entry == "fsdp":
            leaf = all_gather(leaf, "fsdp", axis=dim)
    return leaf


def make_long_context_forward(config: llama.LlamaConfig, plan: MeshPlan,
                              attention: str = "ring", axis: str = "sp"):
    """Build ``forward(params, tokens) -> logits`` with tokens [B, S]
    split (batch over dp/fsdp, sequence over ``axis``) onto
    ``plan.mesh``'s positions; the logits [B, S, vocab] come back whole
    on the mesh's first device."""
    mesh = plan.mesh
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {dict(mesh.shape)} has no '{axis}' "
                         f"axis for context parallelism")
    if attention not in _ATTENTION:
        raise ValueError(f"unknown attention scheme {attention!r}; "
                         f"choose from {sorted(_ATTENTION)}")
    c = config
    if c.n_experts:
        raise not_ported("a mixture-of-experts model under context "
                         "parallelism", "ROADMAP Queue 1, [moe-ep]")
    batch_axis = tuple(a for a in ("dp", "fsdp")
                       if a in mesh.axis_names) or None
    head_axis = "tp" if "tp" in mesh.axis_names else None
    tp = plan.axis_size("tp")
    if c.n_kv_heads % tp:
        raise ValueError(f"tp ({tp}) must divide n_kv_heads "
                         f"({c.n_kv_heads})")
    if attention == "ring":
        attend = ring_attention_sharded(axis, mesh.shape[axis])
    else:
        _check_heads(c.n_heads, mesh, axis, head_axis)
        attend = partial(_ulysses_inner, axis_name=axis)
    specs = _spec_tree(mesh, llama.partition_specs(c))
    shard = None if head_axis is None else llama.TensorShard(
        tp, lambda x: psum(x, "tp"))

    def local_forward(params, tokens):
        params = {
            "embed": _gathered(params["embed"], specs["embed"]),
            "layers": {name: _gathered(leaf, specs["layers"][name])
                       for name, leaf in params["layers"].items()},
            "final_norm": params["final_norm"],
            "unembed": _gathered(params["unembed"], specs["unembed"])}
        b, s = tokens.shape
        rope = llama._rope(c, tokens.device)
        positions = axis_index(axis) * s \
            + torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        hidden = params["embed"][tokens]

        def cp_attention(q, k, v):
            q = apply_rope(q, rope, positions)
            k = apply_rope(k, rope, positions)
            k = repeat_kv(k, c.gqa_groups)
            v = repeat_kv(v, c.gqa_groups)
            return attend(q, k, v, positions, positions)

        for index in range(c.n_layers):
            hidden, _aux = llama._block(c, hidden,
                                        llama._layer(params, index),
                                        cp_attention, shard=shard)
        hidden = rms_norm(hidden, params["final_norm"], c.norm_eps)
        return hidden @ params["unembed"]

    token_spec = filter_spec(mesh, P(("dp", "fsdp"), axis))
    logits_spec = P(batch_axis, axis, head_axis)
    return shard_map(local_forward, mesh, in_specs=(specs, token_spec),
                     out_specs=logits_spec)


def make_long_context_loss(config: llama.LlamaConfig, plan: MeshPlan,
                           attention: str = "ring", axis: str = "sp"):
    """Next-token loss over sequence-sharded batches (for CP training):
    ``loss_fn(params, tokens)`` -> a float32 scalar that backpropagates
    into ``params`` through every position."""
    forward = make_long_context_forward(config, plan, attention, axis)

    def loss_fn(params, tokens):
        logits = forward(params, tokens)[:, :-1, :].float()
        targets = tokens[:, 1:].to(logits.device).long()
        log_probs = F.log_softmax(logits, dim=-1)
        picked = log_probs.gather(-1, targets[..., None])[..., 0]
        return -picked.mean()

    return loss_fn
