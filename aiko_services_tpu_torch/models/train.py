"""The training step, on one device or sharded over a mesh.

Counterpart of ``aiko_services_tpu/models/train.py``: the same loss, the
same optimizer arithmetic and the same gradient accumulation, written
eagerly on PyTorch.

- ``optax.adamw`` becomes :func:`adamw`, ``torch.optim.AdamW`` at
  optax's defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 --
  not torch's 1e-2 -- on every leaf, moments in the parameter dtype).
  The optimizer state is the ``torch.optim`` object over the tree's
  leaves, and a step updates the parameters IN PLACE: the port's
  counterpart of ``donate_argnums`` (one copy of the parameters and
  moments in device memory).  The step returns the same tree.
- ``jax.value_and_grad`` of :func:`language_model_loss` becomes
  ``torch.autograd.grad`` through ``llama.prefill_with_aux``, whose
  attend writes no tensor autograd saved in place;
  ``LlamaConfig(remat=True)`` recomputes each layer in the backward pass.
- ``accumulate_steps`` splits the batch into interleaved microbatches
  (rows ``i, i + micro, ...``) and averages their gradients in float32
  buffers, as the JAX package's ``lax.scan`` does; one microbatch's
  activations are live at a time.
- A ``plan`` of one position keeps the tree whole on ``plan.device``.
  Over several positions (the JAX package's dp x fsdp x tp x ep mesh)
  :func:`init_train_state` places the tree by ``llama.partition_specs``
  (``plan.put``: a :class:`~..parallel.mesh.Placed` tree) with one
  ``torch.optim.AdamW`` a position over the tensors it holds first
  (:class:`PlacedOptimizer`: a replica stored once a device is updated
  once), and each step splits the batch over ``("dp", "fsdp")``, runs
  the forward and backward at every position in ONE autograd graph
  (``llama.prefill_with_aux`` on the placed tree; a leaf split over fsdp
  gets its exact gradient through its gathers' backward), sums the
  gradients of a leaf's replicas on distinct devices (each position's
  partial of the one loss, the global batch mean) in position order so
  every replica takes the same step, and steps every position's
  optimizer in place.  :func:`value_and_grad` (no JAX counterpart: the
  JAX tests call ``jax.value_and_grad``) returns the loss and the
  gradient tree, placed like the parameters.
- Over a mesh that spans processes (``parallel/distributed.py``) every
  process runs the same step: each holds and steps its own positions'
  tensors, computes the same loss of the whole batch, and sums a
  replicated leaf's gradients with the other processes' holders of it,
  in position order.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from . import llama
from .checkpoint import flatten
from .. import device as device_rule
from ..parallel import distributed
from ..parallel.mesh import MeshPlan, Placed, _leaf_list, _shard_key

__all__ = ["adamw", "make_train_step", "init_train_state",
           "language_model_loss", "value_and_grad", "PlacedOptimizer"]

#: The axes a training batch splits over (JAX ``P(("dp", "fsdp"))``).
BATCH_AXES = ("dp", "fsdp")


def adamw(learning_rate: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw(learning_rate)``: a factory that takes the
    parameters (an iterable of leaves) and returns the optimizer state,
    a ``torch.optim.AdamW`` at optax's defaults."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


class PlacedOptimizer:
    """The optimizer state of a placed tree: one optimizer a position
    over the distinct tensors that position holds first (None for a
    position that holds none first), stepped in position order."""

    def __init__(self, optimizer, params: Placed):
        self.optimizers = [optimizer(owned) if owned else None
                           for owned in params.owned()]

    def step(self) -> None:
        for optimizer in self.optimizers:
            if optimizer is not None:
                optimizer.step()

    def zero_grad(self, set_to_none: bool = True) -> None:
        for optimizer in self.optimizers:
            if optimizer is not None:
                optimizer.zero_grad(set_to_none=set_to_none)


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, Placed):
        return tree.tensors()
    return list(flatten(tree).values())


def language_model_loss(params, config: llama.LlamaConfig,
                        tokens: torch.Tensor,
                        moe_aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross-entropy in float32 over [B, S] token batches
    (shift by one), on a fresh cache of length S at start 0.  MoE
    configs add ``moe_aux_weight`` x the GShard load-balance aux.  A
    placed ``params`` splits the batch over ``("dp", "fsdp")``
    (:func:`_batch_axes`); the loss is the global batch's mean, on the
    mesh's first device."""
    b, s = tokens.shape
    if isinstance(params, Placed):
        logits, _, aux = llama._on_mesh(
            llama._prefill_core, params, config, tokens, None, (None,),
            logits_dims=2, aux=True,
            batch_axes=_batch_axes(params.mesh, b))
        tokens = tokens.to(logits.device)
    else:
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


def _batch_axes(mesh, rows: int) -> tuple:
    """The axes a batch of ``rows`` splits over: ``("dp", "fsdp")``, or
    its longest prefix whose positions divide the rows (a microbatch
    smaller than dp x fsdp stands replicated over the rest, as GSPMD
    reshards it)."""
    axes = ()
    for axis in BATCH_AXES:
        count = mesh.shape.get(axis, 1)
        if rows % (count * math.prod(mesh.shape.get(a, 1) for a in axes)):
            break
        axes += (axis,)
    return axes


def init_train_state(seed: int, config: llama.LlamaConfig, plan: MeshPlan,
                     learning_rate: float = 3e-4):
    """(params, opt_state, optimizer): ``llama.init_params(seed)`` on
    ``plan.device``, leaves requiring grad, and :func:`adamw`'s state
    over them (moments zero until the first step).  Over a plan of
    several positions the tree is ``plan.put(init_params(seed),
    partition_specs(config))`` and the state a :class:`PlacedOptimizer`."""
    optimizer = adamw(learning_rate)
    params = llama.init_params(seed, config, plan.device)
    if plan.mesh.size > 1:
        params = plan.put(params, llama.partition_specs(config))
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    if isinstance(params, Placed):
        return params, PlacedOptimizer(optimizer, params), optimizer
    return params, optimizer(_leaves(params)), optimizer


def _reduce_replicas(params: Placed, grads: dict) -> None:
    """Every replica's gradient (``grads``: tensor id -> gradient) made
    the sum of the group's partial gradients, in position order, in
    float32: each replica then takes the same step."""
    if distributed.spans_processes(params.mesh):
        _reduce_replicas_across(params, grads)
        return
    for group in params.replicas():
        first = group[0].device
        total = grads[id(group[0])].float()
        for member in group[1:]:
            total = total + grads[id(member)].to(first).float()
        for member in group:
            grads[id(member)] = total.to(member.device, copy=True)


def _reduce_replicas_across(params: Placed, grads: dict) -> None:
    """:func:`_reduce_replicas` over a mesh that spans processes: a
    replica is held once a device (positions that list one device share
    it); the holders of a shard on other processes send their partial
    gradients, and every process sums each group's, in position order,
    in float32."""
    mesh = params.mesh
    leaf_specs = _leaf_list(params.specs, params.specs)
    columns = [None if shard is None else _leaf_list(params.specs, shard)
               for shard in params.shards]
    local = next(column for column in columns if column is not None)
    idents = [(device_rule.process_index(d), d.type, d.index)
              for d in mesh.devices.flat]
    groups: dict = {}
    for index, spec in enumerate(leaf_specs):
        for position in range(mesh.size):
            key = (index, _shard_key(mesh, position, spec,
                                     local[index].ndim))
            holders = groups.setdefault(key, {})
            holders.setdefault(idents[position], position)
    mine, me = {}, device_rule.process_index()
    for (index, shard), holders in groups.items():
        if len(holders) > 1:
            for ident, position in holders.items():
                if ident[0] == me:
                    tensor = columns[position][index]
                    mine[index, shard, position] = grads[id(tensor)].float()
    found = dict(mine)
    group = distributed.mesh_group(mesh, tuple(range(mesh.size)))
    for theirs in distributed.exchange_trees(group, mine,
                                             MeshPlan(mesh).device):
        for key, value in theirs.items():
            found.setdefault(key, value)
    for (index, shard), holders in groups.items():
        if len(holders) < 2:
            continue
        positions = sorted(holders.values())
        mine_here = [p for p in range(mesh.size) if columns[p] is not None
                     and _shard_key(mesh, p, leaf_specs[index],
                                    local[index].ndim) == shard]
        if not mine_here:
            continue
        first = columns[mine_here[0]][index].device
        total = None
        for position in positions:
            part = found[index, shard, position].to(first)
            total = part if total is None else total + part
        for tensor in {id(columns[p][index]): columns[p][index]
                       for p in mine_here}.values():
            grads[id(tensor)] = total.to(tensor.device, copy=True)


def _gradients(params, config: llama.LlamaConfig, tokens: torch.Tensor,
               accumulate_steps: int):
    """(loss, the distinct leaves, their gradients in the same order)."""
    leaves = _leaves(params)
    micro = max(1, int(accumulate_steps))

    def one(batch):
        # A replica whose rows reach no logit of the loss (a microbatch
        # replicated over fsdp) gets a zero partial gradient.
        loss = language_model_loss(params, config, batch)
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    if micro == 1:
        loss, grads = one(tokens)
    else:
        batch = tokens.shape[0]
        if batch % micro:
            raise ValueError(f"batch {batch} not divisible by "
                             f"accumulate_steps {micro}")
        # Interleaved split: rows 0, micro, 2*micro, ... form microbatch 0.
        microbatches = tokens.reshape(batch // micro, micro,
                                      -1).transpose(0, 1)
        loss = None
        grads = [torch.zeros(leaf.shape, dtype=torch.float32,
                             device=leaf.device) for leaf in leaves]
        for microbatch in microbatches:
            part, part_grads = one(microbatch)
            loss = part if loss is None else loss + part
            for total, grad in zip(grads, part_grads):
                total.add_(grad)
        loss = loss / micro
        grads = [total.div_(micro) for total in grads]
    if isinstance(params, Placed):
        by_leaf = {id(leaf): grad for leaf, grad in zip(leaves, grads)}
        _reduce_replicas(params, by_leaf)
        grads = [by_leaf[id(leaf)] for leaf in leaves]
    return loss, leaves, list(grads)


def value_and_grad(params, config: llama.LlamaConfig, tokens: torch.Tensor,
                   accumulate_steps: int = 1):
    """(loss, gradients) of :func:`language_model_loss` at ``params``:
    the gradients a tree like ``params`` (placed like it, each replica
    holding the reduced sum, for a placed tree), float32 when
    accumulated.  ``accumulate_steps`` > 1 averages the gradients of that
    many interleaved microbatches; the batch must divide evenly."""
    loss, leaves, grads = _gradients(params, config, tokens,
                                     accumulate_steps)
    by_leaf = {id(leaf): grad for leaf, grad in zip(leaves, grads)}
    if isinstance(params, Placed):
        return loss, params.map(lambda leaf: by_leaf[id(leaf)])
    return loss, _tree_like(params, by_leaf)


def _tree_like(tree, by_leaf: dict):
    if isinstance(tree, dict):
        return {key: _tree_like(value, by_leaf) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_like(value, by_leaf) for value in tree)
    return by_leaf[id(tree)]


def make_train_step(config: llama.LlamaConfig, plan: MeshPlan,
                    optimizer=None, learning_rate: float = 3e-4,
                    accumulate_steps: int = 1):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``.

    ``opt_state`` is the ``torch.optim`` object over ``params``' leaves
    (a :class:`PlacedOptimizer` for a placed tree), which require grad
    (:func:`init_train_state` makes both; for a tree made elsewhere, mark
    its leaves and call ``adamw()(leaves)``, or ``PlacedOptimizer(
    adamw(), placed)``).  It carries its own learning rate:
    ``optimizer`` and ``learning_rate`` are the JAX signature's and
    unused here.  Gradients are cast to the parameter dtype before the
    update.  ``accumulate_steps`` > 1 averages the gradients of that
    many interleaved microbatches; the batch must divide evenly.
    ``loss`` is a detached float32 scalar on the device (the mesh's
    first for a placed tree)."""
    del optimizer, learning_rate        # opt_state carries both
    del plan                            # the tree carries its placement

    def step(params, opt_state, tokens):
        loss, leaves, grads = _gradients(params, config, tokens,
                                         accumulate_steps)
        for leaf, grad in zip(leaves, grads):
            leaf.grad = grad.to(leaf.dtype)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return step
