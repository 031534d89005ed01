"""The training step on one device.

Counterpart of ``aiko_services_tpu/models/train.py``: the same loss, the
same optimizer arithmetic and the same gradient accumulation, written
eagerly on PyTorch.

- ``optax.adamw`` becomes :func:`adamw`, ``torch.optim.AdamW`` at
  optax's defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 --
  not torch's 1e-2 -- on every leaf, moments in the parameter dtype).
  The optimizer state is the ``torch.optim`` object over the tree's
  leaves, and a step updates the parameters IN PLACE: the port's
  counterpart of ``donate_argnums`` (one copy of the parameters and
  moments in device memory).  The step returns the same dict.
- ``jax.value_and_grad`` of :func:`language_model_loss` becomes
  ``torch.autograd.grad`` through ``llama.prefill_with_aux``, whose
  attend writes no tensor autograd saved in place;
  ``LlamaConfig(remat=True)`` recomputes each layer in the backward pass.
- ``accumulate_steps`` splits the batch into interleaved microbatches
  (rows ``i, i + micro, ...``) and averages their gradients in float32
  buffers, as the JAX package's ``lax.scan`` does; one microbatch's
  activations are live at a time.
- ``plan`` is the port's one-device ``MeshPlan``: a plan over several
  cards raises ``not_ported`` (multi-card meshes).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import llama
from .checkpoint import flatten
from ..parallel.mesh import MeshPlan

__all__ = ["adamw", "make_train_step", "init_train_state",
           "language_model_loss"]


def adamw(learning_rate: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw(learning_rate)``: a factory that takes the
    parameters (an iterable of leaves) and returns the optimizer state,
    a ``torch.optim.AdamW`` at optax's defaults."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def _leaves(tree: dict) -> list[torch.Tensor]:
    return list(flatten(tree).values())


def language_model_loss(params: dict, config: llama.LlamaConfig,
                        tokens: torch.Tensor,
                        moe_aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross-entropy in float32 over [B, S] token batches
    (shift by one), on a fresh cache of length S at start 0.  MoE
    configs add ``moe_aux_weight`` x the GShard load-balance aux."""
    b, s = tokens.shape
    cache = llama.init_cache(config, b, s, device=tokens.device)
    logits, _, aux = llama.prefill_with_aux(
        params, config, tokens, cache,
        torch.zeros(b, dtype=torch.int32, device=tokens.device))
    logits = logits[:, :-1, :].float()
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())
    if config.n_experts:
        loss = loss + moe_aux_weight * aux
    return loss


def init_train_state(seed: int, config: llama.LlamaConfig, plan: MeshPlan,
                     learning_rate: float = 3e-4):
    """(params, opt_state, optimizer): ``llama.init_params(seed)`` on
    ``plan.device``, leaves requiring grad, and :func:`adamw`'s state
    over them (moments zero until the first step)."""
    params = llama.init_params(seed, config, plan.replicated())
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    optimizer = adamw(learning_rate)
    return params, optimizer(_leaves(params)), optimizer


def make_train_step(config: llama.LlamaConfig, plan: MeshPlan,
                    optimizer=None, learning_rate: float = 3e-4,
                    accumulate_steps: int = 1):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``.

    ``opt_state`` is the ``torch.optim`` object over ``params``' leaves,
    which require grad (:func:`init_train_state` makes both; for a tree
    made elsewhere, mark its leaves and call ``adamw()(leaves)``).  It
    carries its own learning rate: ``optimizer`` and ``learning_rate``
    are the JAX signature's and unused here.  Gradients are cast to the
    parameter dtype before the update.  ``accumulate_steps`` > 1
    averages the gradients of that many interleaved microbatches; the
    batch must divide evenly.  ``loss`` is a detached float32 scalar on
    the device."""
    del optimizer, learning_rate        # opt_state carries both
    plan.replicated()                   # a plan over several cards raises
    micro = max(1, int(accumulate_steps))

    def value_and_grad(params, leaves, tokens):
        loss = language_model_loss(params, config, tokens)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def batch_grads(params, leaves, tokens):
        if micro == 1:
            return value_and_grad(params, leaves, tokens)
        batch = tokens.shape[0]
        if batch % micro:
            raise ValueError(f"batch {batch} not divisible by "
                             f"accumulate_steps {micro}")
        # Interleaved split: rows 0, micro, 2*micro, ... form microbatch 0.
        microbatches = tokens.reshape(batch // micro, micro,
                                      -1).transpose(0, 1)
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        grad_sum = [torch.zeros(leaf.shape, dtype=torch.float32,
                                device=leaf.device) for leaf in leaves]
        for microbatch in microbatches:
            loss, grads = value_and_grad(params, leaves, microbatch)
            loss_sum = loss_sum + loss
            for total, grad in zip(grad_sum, grads):
                total.add_(grad)
        return loss_sum / micro, [total.div_(micro) for total in grad_sum]

    def step(params, opt_state, tokens):
        leaves = _leaves(params)
        loss, grads = batch_grads(params, leaves, tokens)
        for leaf, grad in zip(leaves, grads):
            leaf.grad = grad.to(leaf.dtype)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return step
