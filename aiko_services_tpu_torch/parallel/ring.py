"""Sequence/context parallelism: ring attention, Ulysses, blockwise.

Counterpart of ``aiko_services_tpu/parallel/ring.py``, with the same
names and contracts, over a named ``sp`` axis of a port mesh
(``parallel/mesh.py``):

- ``ring_attention``: K/V blocks rotate around the ring by ``ppermute``
  while each position accumulates its queries' output with an online
  (streaming) softmax.  Memory per position is O(S/n).
- ``ulysses_attention``: a head-scatter / sequence-gather all-to-all
  gives each position the FULL sequence for H/n heads; it runs dense
  attention locally and all-to-alls back.  Requires heads % n == 0.
- ``blockwise_attention``: single-device chunked online-softmax
  attention (the building block the ring repeats a hop).

All three are causal, take absolute positions, compute the softmax
statistics in float32 and return the query's dtype.  The JAX package
multiplies bf16 inputs with ``preferred_element_type=float32``; here the
inputs widen to float32 before each product (exact for bf16 values), so
the logits and the P.V sums are float32 as there, where a bf16 matmul
would round them to bf16.  Fully masked blocks are guarded with -1e30
and ``m_safe``, never with -inf.  No kernel of the port runs here: the
JAX package computes each block with ``jnp.einsum`` too.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from .mesh import P, all_gather, all_to_all, ppermute, shard_map

__all__ = ["ring_attention", "ulysses_attention", "blockwise_attention",
           "ring_attention_sharded"]

_NEG_INF = -1e30


def _online_block(q, k, v, q_pos, kv_pos, m, l, o):
    """One online-softmax accumulation step against a K/V block.

    q: [B, Sq, H, d]; k/v: [B, Sk, H, d]; q_pos: [B, Sq]; kv_pos: [B, Sk];
    m/l: [B, H, Sq] float32 running max / normalizer; o: [B, Sq, H, d]
    float32 unnormalized output.  Returns updated (m, l, o).
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    causal = kv_pos[:, None, None, :] <= q_pos[:, None, :, None]
    logits = torch.where(causal, logits, _NEG_INF)

    m_block = logits.amax(dim=-1)                           # [B, H, Sq]
    m_new = torch.maximum(m, m_block)
    # Guard fully-masked blocks: exp(-inf - -inf) would be NaN.
    m_safe = torch.where(m_new <= _NEG_INF / 2, 0.0, m_new)
    correction = torch.exp(m - m_safe)                      # [B, H, Sq]
    p = torch.exp(logits - m_safe[..., None])               # [B, H, Sq, Sk]
    p = torch.where(causal, p, 0.0)

    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhst,bthd->bshd", p, v.float())
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def _finish(l, o, dtype):
    denominator = l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return (o / denominator).to(dtype)


def _init_stats(b, s, h, d, device):
    return (torch.full((b, h, s), _NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((b, h, s), dtype=torch.float32, device=device),
            torch.zeros((b, s, h, d), dtype=torch.float32, device=device))


def blockwise_attention(q, k, v, q_positions, kv_positions=None,
                        block_size: int = 512):
    """Memory-efficient causal attention by scanning K/V blocks.

    q: [B, S, H, d]; k/v: [B, T, H, d] (GQA-expanded); q_positions: [B, S]
    absolute; kv_positions: [B, T] (default arange).  Equivalent to dense
    ``attention_prefill`` but O(block_size) live logits.  A ragged tail
    pads k/v with zeros at position 2**30, past every query.
    """
    b, t = k.shape[0], k.shape[1]
    if kv_positions is None:
        kv_positions = torch.arange(t, device=k.device)[None, :] \
            .expand(b, t)
    block_size = min(block_size, t)
    if t % block_size:
        pad = block_size - t % block_size
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=2 ** 30)
        t += pad
    s, h = q.shape[1], q.shape[2]
    stats = _init_stats(b, s, h, q.shape[-1], q.device)
    for start in range(0, t, block_size):
        stats = _online_block(q, k[:, start:start + block_size],
                              v[:, start:start + block_size], q_positions,
                              kv_positions[:, start:start + block_size],
                              *stats)
    return _finish(stats[1], stats[2], q.dtype)


def _ring_inner(q, k, v, q_pos, kv_pos, axis_name, axis_size):
    """Per-shard ring attention body (runs under shard_map over ``sp``)."""
    b, s, h, d = q.shape
    stats = _init_stats(b, s, h, d, q.device)
    perm = [(j, (j + 1) % axis_size) for j in range(axis_size)]
    current = (k, v, kv_pos)
    # n-1 rotate+accumulate hops, then the last arriving block is
    # accumulated without a wasted final ppermute.
    for _ in range(axis_size - 1):
        arriving = ppermute(current, axis_name, perm)
        stats = _online_block(q, current[0], current[1], q_pos, current[2],
                              *stats)
        current = arriving
    m, l, o = _online_block(q, current[0], current[1], q_pos, current[2],
                            *stats)
    return _finish(l, o, q.dtype)


def ring_attention(q, k, v, q_positions, mesh, axis: str = "sp",
                   kv_positions=None, batch_axis=None, head_axis=None):
    """Causal ring attention over the ``axis`` mesh axis.

    q/k/v: [B, S, H, d] GLOBAL tensors, the sequence dimension split
    over ``axis``; q_positions/kv_positions: [B, S] absolute positions.
    Each position holds S/n queries and rotates the K/V shards n times.
    ``batch_axis``/``head_axis`` name mesh axes the batch/head dims are
    split over (dp/tp).  Returns the global output on the mesh's first
    device.
    """
    if kv_positions is None:
        kv_positions = q_positions
    n = mesh.shape[axis]
    spec_qkv = P(batch_axis, axis, head_axis, None)
    spec_pos = P(batch_axis, axis)
    inner = partial(_ring_inner, axis_name=axis, axis_size=n)
    return shard_map(
        inner, mesh=mesh,
        in_specs=(spec_qkv, spec_qkv, spec_qkv, spec_pos, spec_pos),
        out_specs=spec_qkv,
    )(q, k, v, q_positions, kv_positions)


def _ulysses_inner(q, k, v, q_pos, kv_pos, axis_name):
    """Head-scatter / sequence-gather: trade the sequence shard for a head
    shard with one all-to-all each way, then dense attention locally."""
    # [B, S/n, H, d] -> [B, S, H/n, d]: split heads, concat sequence.
    qg = all_to_all(q, axis_name, split_axis=2, concat_axis=1)
    kg = all_to_all(k, axis_name, split_axis=2, concat_axis=1)
    vg = all_to_all(v, axis_name, split_axis=2, concat_axis=1)
    q_pos_g = all_gather(q_pos, axis_name, axis=1)
    kv_pos_g = all_gather(kv_pos, axis_name, axis=1)

    scale = qg.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", qg.float(), kg.float()) * scale
    causal = kv_pos_g[:, None, None, :] <= q_pos_g[:, None, :, None]
    logits = torch.where(causal, logits, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", weights.to(vg.dtype), vg)
    # Inverse all-to-all: gather heads back, scatter sequence.
    return all_to_all(out, axis_name, split_axis=1, concat_axis=2)


def _check_heads(heads: int, mesh, axis: str, head_axis=None) -> None:
    """Raise unless the ``axis`` size divides the heads a position holds
    before the all-to-all (after ``head_axis``)."""
    n = mesh.shape[axis]
    if head_axis is not None and head_axis in mesh.axis_names:
        heads //= mesh.shape[head_axis]
    if heads % n:
        raise ValueError(
            f"ulysses needs local heads ({heads}) divisible by "
            f"axis '{axis}' size ({n})")


def ulysses_attention(q, k, v, q_positions, mesh, axis: str = "sp",
                      kv_positions=None, batch_axis=None, head_axis=None):
    """Ulysses-style context parallelism (head-scatter all-to-all).

    Requires n_heads % mesh.shape[axis] == 0 (local heads, after
    ``head_axis``).  Same tensor contract as ``ring_attention``.
    """
    if kv_positions is None:
        kv_positions = q_positions
    _check_heads(q.shape[2], mesh, axis, head_axis)
    spec_qkv = P(batch_axis, axis, head_axis, None)
    spec_pos = P(batch_axis, axis)
    inner = partial(_ulysses_inner, axis_name=axis)
    return shard_map(
        inner, mesh=mesh,
        in_specs=(spec_qkv, spec_qkv, spec_qkv, spec_pos, spec_pos),
        out_specs=spec_qkv,
    )(q, k, v, q_positions, kv_positions)


def ring_attention_sharded(axis_name: str, axis_size: int):
    """Return the per-shard ring attention callable for use INSIDE an
    existing shard_map (e.g. a context-parallel model step that already
    runs under one).  Signature: fn(q, k, v, q_pos, kv_pos) with local
    shards."""
    return partial(_ring_inner, axis_name=axis_name, axis_size=axis_size)
