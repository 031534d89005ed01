"""Long-context Llama forward: sequence sharded over the ``sp`` mesh axis.

Counterpart of ``aiko_services_tpu/models/long_context.py``.  The model
body is the port's Llama (``models/llama.py``): its one forward,
``llama._forward``, at each position, only the attention changes.  Each
position keeps its S/n chunk and attention runs as a ring (``ppermute``
K/V rotation) or Ulysses (head-scatter all-to-all) over ``sp``.

The JAX package composes ``sp`` with dp batch sharding and Megatron tp
through its ``jit``'s sharding propagation; the port has no such
compiler, so the whole forward runs under ONE ``shard_map``
(``parallel/mesh.py``): tokens split with the batch over ``dp``/``fsdp``
and the sequence over ``sp``, parameters split by
``llama.partition_specs`` (or taken as placed by ``plan.put``), each
position running its shard of every block (``llama.TensorShard``:
heads and FFN columns over ``tp`` with a ``psum`` after wo and w_down,
each layer's leaves gathered over ``fsdp`` at their use, a
mixture-of-experts FFN's experts over ``ep`` with the global batch's
capacity, slots and aux) and the logits reassembled whole, as
``out_shardings`` reassembles them.  RoPE rotates each ``sp`` shard by
its GLOBAL positions.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from . import llama
from ..ops.layers import apply_rope, repeat_kv
from ..parallel.mesh import (MeshPlan, P, axis_index, filter_spec,
                             filter_specs, shard_map)
from ..parallel.ring import (_check_heads, _ulysses_inner,
                             ring_attention_sharded)

__all__ = ["make_long_context_forward", "make_long_context_loss"]

_ATTENTION = ("ring", "ulysses")


def make_long_context_forward(config: llama.LlamaConfig, plan: MeshPlan,
                              attention: str = "ring", axis: str = "sp"):
    """Build ``forward(params, tokens) -> logits`` with tokens [B, S]
    split (batch over dp/fsdp, sequence over ``axis``) onto
    ``plan.mesh``'s positions and ``params`` a whole tree or one placed
    by ``plan.put(params, llama.partition_specs(config))``; the logits
    [B, S, vocab] come back whole on the mesh's first device.  A
    mixture-of-experts config routes as the whole batch would (its aux
    is dropped, as the JAX forward drops it)."""
    mesh = plan.mesh
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {dict(mesh.shape)} has no '{axis}' "
                         f"axis for context parallelism")
    if attention not in _ATTENTION:
        raise ValueError(f"unknown attention scheme {attention!r}; "
                         f"choose from {sorted(_ATTENTION)}")
    c = config
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
    specs = filter_specs(mesh, llama.partition_specs(c))

    def local_forward(params, tokens):
        shard = llama.TensorShard(mesh, specs, ("dp", "fsdp"), axis)
        b, s = tokens.shape
        rope = llama._rope(c, tokens.device)
        positions = axis_index(axis) * s \
            + torch.arange(s, device=tokens.device)[None, :].expand(b, s)

        def cp_attention(q, k, v):
            q = apply_rope(q, rope, positions)
            k = apply_rope(k, rope, positions)
            k = repeat_kv(k, c.gqa_groups)
            v = repeat_kv(v, c.gqa_groups)
            return attend(q, k, v, positions, positions)

        return llama._forward(params, c, tokens, lambda index: cp_attention,
                              shard=shard)[0]

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
