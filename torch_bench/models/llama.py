"""The Llama-family block in plain PyTorch: the benchmark's weights, its
reference forward pass, its lower-precision control and its operation
and byte counts.

Mistral-7B-v0.3 is this block at its own sizes: RMSNorm, rotary
positions (the rotate-half form, ``rope_theta`` from the config),
grouped-query attention with ``head_dim = hidden_size /
num_attention_heads``, a SwiGLU feed-forward and an untied output head,
no sliding window.  Nothing here imports the program: the weights are
drawn here, in the parameter layout the program takes as its input
(layer-stacked leaves, ``x @ w`` orientation), and handed to both sides.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Sizes:
    vocab: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    ffn: int
    rope_theta: float
    norm_eps: float
    max_seq: int

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @classmethod
    def of(cls, config: dict) -> "Sizes":
        """The sizes of a configuration file in Hugging Face's keys."""
        return cls(vocab=config["vocab_size"], dim=config["hidden_size"],
                   layers=config["num_hidden_layers"],
                   heads=config["num_attention_heads"],
                   kv_heads=config["num_key_value_heads"],
                   ffn=config["intermediate_size"],
                   rope_theta=float(config["rope_theta"]),
                   norm_eps=float(config["rms_norm_eps"]),
                   max_seq=config["max_position_embeddings"])


def layout(s: Sizes) -> dict:
    """leaf -> (shape, fan_in; None for a norm weight, which is one)."""
    hd, n = s.head_dim, s.layers
    return {
        "embed": ((s.vocab, s.dim), s.dim),
        "layers": {
            "wq": ((n, s.dim, s.heads * hd), s.dim),
            "wk": ((n, s.dim, s.kv_heads * hd), s.dim),
            "wv": ((n, s.dim, s.kv_heads * hd), s.dim),
            "wo": ((n, s.heads * hd, s.dim), s.heads * hd),
            "w_gate": ((n, s.dim, s.ffn), s.dim),
            "w_up": ((n, s.dim, s.ffn), s.dim),
            "w_down": ((n, s.ffn, s.dim), s.ffn),
            "attn_norm": ((n, s.dim), None),
            "mlp_norm": ((n, s.dim), None),
        },
        "final_norm": ((s.dim,), None),
        "unembed": ((s.dim, s.vocab), s.dim),
    }


def draw(seed: int, s: Sizes, device, dtype=torch.bfloat16) -> dict:
    """Random weights from ``seed``: one standard-normal draw a leaf, on
    ``device`` and in the served type, scaled by fan_in^-0.5."""
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def leaf(spec):
        shape, fan_in = spec
        if fan_in is None:
            return torch.ones(shape, dtype=dtype, device=device)
        out = torch.randn(shape, generator=generator, device=device,
                          dtype=dtype)
        return out.mul_(fan_in ** -0.5)

    def walk(node):
        if isinstance(node, dict):
            return {name: walk(value) for name, value in node.items()}
        return leaf(node)
    return walk(layout(s))


def parameters(s: Sizes) -> int:
    return sum(math.prod(shape)
               for shape, _ in _leaves(layout(s)))


def _leaves(node):
    if isinstance(node, dict):
        for value in node.values():
            yield from _leaves(value)
    else:
        yield node


# -- operation and byte counts ---------------------------------------------

def matmul_flops_per_token(s: Sizes) -> int:
    """2 a multiply-add over every weight a token multiplies: the layers'
    projections and the output head (the embedding is a lookup)."""
    hd = s.head_dim
    per_layer = s.dim * (s.heads + 2 * s.kv_heads) * hd \
        + s.heads * hd * s.dim + 3 * s.dim * s.ffn
    return 2 * (s.layers * per_layer + s.dim * s.vocab)


def attention_flops(s: Sizes, context: int) -> int:
    """One token's attention over ``context`` positions, every layer:
    the score and the value products, 2 a multiply-add each."""
    return 4 * s.layers * s.heads * s.head_dim * context


def token_flops(s: Sizes, context: int) -> int:
    return matmul_flops_per_token(s) + attention_flops(s, context)


def chunk_flops(s: Sizes, offset: int, n: int) -> int:
    """An admission chunk of ``n`` tokens written after ``offset``: each
    token attends to every position up to its own."""
    positions = n * offset + n * (n + 1) // 2
    return n * matmul_flops_per_token(s) \
        + 4 * s.layers * s.heads * s.head_dim * positions


def decode_attention_work(s: Sizes, live: int) -> tuple[int, int]:
    """(bytes, operations) of one row's decode attention over ``live``
    positions, every layer, as the split body and its combine need
    them: the bf16 keys and values of the live positions read once, the
    query read and the output written once."""
    hd = s.head_dim
    n_bytes = s.layers * (live * s.kv_heads * hd * 2 * 2
                          + 2 * s.heads * hd * 2)
    return n_bytes, 4 * s.layers * s.heads * hd * live


def prefill_attention_work(s: Sizes, offset: int, n: int) \
        -> tuple[int, int]:
    """(bytes, operations) of one chunk's prefill attention, every
    layer: queries and outputs of the chunk, keys and values of every
    position up to its end, and the causal products."""
    hd = s.head_dim
    positions = n * offset + n * (n + 1) // 2
    n_bytes = s.layers * (2 * n * s.heads * hd * 2
                          + (offset + n) * s.kv_heads * hd * 2 * 2)
    return n_bytes, 4 * s.layers * s.heads * hd * positions


# -- the reference -----------------------------------------------------------

def _rms_norm(x, weight, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * weight


def _rope(x, positions, theta):
    """x [S, H, hd]: the rotate-half form of rotary positions."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=x.device) / hd))
    angles = positions.double()[:, None] * inv[None]
    cos = angles.cos().float()[:, None, :]
    sin = angles.sin().float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _fp8(x, dim):
    """``x`` rounded to float8 e4m3 with one scale a slice along
    ``dim`` (its largest magnitude to the format's 448)."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _product(x, w, fp8: bool):
    if fp8:
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


@torch.no_grad()
def forward(weights: dict, s: Sizes, sequences: list, fp8: bool = False) \
        -> list:
    """Float32 logits [S, vocab] of each token sequence, the whole
    sequence at once, causal.  The layers go one at a time over every
    sequence, each layer's weights widened to float32 once.  ``fp8``
    rounds both operands of every product to float8 e4m3 (the control:
    the nearest precision below the configuration's bf16)."""
    device = weights["embed"].device
    hd = s.head_dim
    groups = s.heads // s.kv_heads
    hidden = [weights["embed"][torch.as_tensor(seq, device=device)].float()
              for seq in sequences]
    for index in range(s.layers):
        w = {name: leaf[index].float()
             for name, leaf in weights["layers"].items()}
        for i, h in enumerate(hidden):
            n = h.shape[0]
            positions = torch.arange(n, device=device)
            x = _rms_norm(h, w["attn_norm"], s.norm_eps)
            q = _rope(_product(x, w["wq"], fp8).view(n, s.heads, hd),
                      positions, s.rope_theta)
            k = _rope(_product(x, w["wk"], fp8).view(n, s.kv_heads, hd),
                      positions, s.rope_theta)
            v = _product(x, w["wv"], fp8).view(n, s.kv_heads, hd)
            k = k.repeat_interleave(groups, dim=1)
            v = v.repeat_interleave(groups, dim=1)
            scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
            mask = torch.ones(n, n, dtype=torch.bool,
                              device=device).triu(1)
            scores.masked_fill_(mask, float("-inf"))
            attn = torch.einsum("hqk,khd->qhd", scores.softmax(-1), v)
            del scores
            h = h + _product(attn.reshape(n, s.heads * hd), w["wo"], fp8)
            x = _rms_norm(h, w["mlp_norm"], s.norm_eps)
            gate = F.silu(_product(x, w["w_gate"], fp8))
            h = h + _product(gate * _product(x, w["w_up"], fp8),
                             w["w_down"], fp8)
            hidden[i] = h
        del w
    unembed = weights["unembed"].float()
    final = weights["final_norm"].float()
    return [_product(_rms_norm(h, final, s.norm_eps), unembed, fp8)
            for h in hidden]


# -- judging served tokens ---------------------------------------------------

def served_logits(weights: dict, s: Sizes, requests: list,
                  fp8: bool = False) -> list:
    """For each (prompt, served tokens): the logits [n_served, vocab]
    that predicted each served token (teacher forcing)."""
    sequences = [list(prompt) + list(served[:-1])
                 for prompt, served in requests]
    out = []
    for (prompt, served), logits in zip(
            requests, forward(weights, s, sequences, fp8)):
        start = len(prompt) - 1
        out.append(logits[start:start + len(served)])
    return out


def greedy_gap(logits: torch.Tensor, served) -> float:
    """The widest gap by which a served token's logit lies below the
    best logit at its position."""
    tokens = torch.as_tensor(served, device=logits.device)
    picked = logits.gather(1, tokens[:, None])[:, 0]
    return float((logits.max(-1).values - picked).max())


def topk_gap(logits: torch.Tensor, served, k: int) -> float:
    """The widest gap by which a sampled token's logit lies below the
    k-th best at its position (0 where every token is in the top k)."""
    tokens = torch.as_tensor(served, device=logits.device)
    picked = logits.gather(1, tokens[:, None])[:, 0]
    kth = logits.topk(k, dim=-1).values[:, -1]
    return float((kth - picked).clamp(min=0).max())


def control_greedy_gap(reference: torch.Tensor, lower: torch.Tensor) -> float:
    """The gap, under the reference, of the token that the lower
    precision puts first, widest over the positions."""
    return greedy_gap(reference, lower.argmax(-1).tolist())


def control_topk_gap(reference: torch.Tensor, lower: torch.Tensor,
                     k: int) -> float:
    """The widest gap below the reference's k-th best of any token in
    the lower precision's top k (any of them may be sampled)."""
    kth = reference.topk(k, dim=-1).values[:, -1:]
    chosen = reference.gather(1, lower.topk(k, dim=-1).indices)
    return float((kth - chosen).clamp(min=0).max())
