"""Port twins of the JAX package's mesh tests in ``tests/test_models.py``
(``test_meshplan_filters_absent_axes``, ``test_sharded_prefill_on_mesh``,
``test_sharded_train_step``, ``test_remat_training_matches_and_
microbatching_averages``) on a port mesh of eight CPU descriptors (the
tests' pool), ``{"dp": 2, "fsdp": 2, "tp": 2}``, and the parity of the
sharded model step (``models/train.py`` over a placed tree,
``parallel/mesh.py``'s ``put`` / ``gather``) against the JAX package's
sharded step on its eight virtual CPU devices, from the same weights
(the JAX tree bridged through numpy).

Tolerances: the bf16 prefill within the JAX test's own atol 1.5e-1 of
the JAX package's one-device prefill; float32 losses within 1e-5,
gradients and updated parameters within 1e-4 of each leaf's largest
magnitude (summation order only); float32 logits of the placed prefill
and decode (bf16 and int8 trees) within 1e-4 of the port's one-device
entry points; a mesh that lists one device at every position against
the same mesh of distinct descriptors: the loss within 1e-6, gradients
within 1e-5 of each leaf's largest magnitude.  Replicas of a leaf on
distinct descriptors are held bitwise equal after three steps."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.models import train as jt
from aiko_services_tpu.parallel import MeshPlan as JaxPlan
from aiko_services_tpu.parallel import P as JaxP
from aiko_services_tpu.parallel import make_mesh as jax_make_mesh
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl
from aiko_services_tpu_torch.models import train as tt
from aiko_services_tpu_torch.models.checkpoint import flatten
from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                  quantize_specs)
from aiko_services_tpu_torch.parallel import (Keep, MeshPlan, P, Placed,
                                              make_mesh, shard_map)

MESH = {"dp": 2, "fsdp": 2, "tp": 2}
PREFILL_ATOL = 1.5e-1   # the JAX test's bf16 bound
LOSS_TOL = 1e-5
REL_TOL = 1e-4
F32_TOL = 1e-4
SAME_LOSS_TOL = 1e-6
SAME_GRAD_TOL = 1e-5

POOL = [torch.device("cpu", index) for index in range(8)]


def port_plan(axes=MESH, devices=POOL) -> MeshPlan:
    return MeshPlan(make_mesh(axes, devices[:int(np.prod(list(
        axes.values())))]))


def jax_plan(axes=MESH) -> JaxPlan:
    return JaxPlan(jax_make_mesh(axes, jax.devices()[:int(np.prod(list(
        axes.values())))]))


def configs(dtype="float32", **overrides):
    return (dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128,
                                                    max_seq=64),
                                dtype=dtype, **overrides),
            dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=128,
                                                    max_seq=64),
                                dtype=dtype, **overrides))


def batch(shape=(4, 16), seed=3, vocab=128) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def bridged(jax_tree, config) -> dict:
    """A JAX tree on the port, bf16 leaves bit for bit."""
    def leaf(array):
        array = np.asarray(array)
        if array.dtype == jnp.bfloat16:
            return array.view(np.uint16), "bfloat16"
        return array
    return bridge.params_from_numpy(jax.tree_util.tree_map(leaf, jax_tree),
                                    config, device="cpu")


def jax_flat(tree) -> dict:
    return {".".join(str(key.key) for key in path):
            np.asarray(leaf, dtype=np.float64)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_leaves_close(ours: dict, theirs: dict, tol: float):
    assert set(ours) == set(theirs)
    for name, leaf in ours.items():
        want = np.asarray(theirs[name], dtype=np.float64)
        got = leaf.detach().double().numpy()
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= tol * scale, name


def trainable(placed: Placed) -> Placed:
    for leaf in placed.tensors():
        leaf.requires_grad_(True)
    return placed


# -- test_models.py twins -----------------------------------------------------

def test_meshplan_filters_absent_axes():
    plan = MeshPlan.build({"dp": 8}, devices=POOL)
    sharding = plan.shard(P("dp", "tp", None))      # tp absent -> dropped
    assert sharding.spec == P("dp", None, None)
    want = JaxPlan.build({"dp": 8}).shard(JaxP("dp", "tp", None)).spec
    assert tuple(sharding.spec) == tuple(want)


def test_sharded_prefill_on_mesh():
    """Params in the tp + fsdp layout on {"dp": 2, "fsdp": 2, "tp": 2},
    tokens placed with the batch over dp, the cache placed by
    ``cache_specs``: the logits of the JAX package's one-device prefill
    (bf16, its bound), and the placed cache holds the one-device
    cache's rows."""
    config = jl.LlamaConfig.tiny()
    tc = tl.LlamaConfig.tiny()
    params = jl.init_params(jax.random.PRNGKey(0), config)
    tokens = batch((2, 8), seed=2, vocab=config.vocab_size)
    ref_logits, _ = jl.prefill(params, config, jnp.asarray(tokens),
                               jl.init_cache(config, 2, 32),
                               jnp.zeros(2, dtype=jnp.int32))
    plan = port_plan()
    ours = bridged(params, tc)
    sharded = plan.put(ours, tl.partition_specs(tc))
    cache = plan.put(tl.init_cache(tc, 2, 32, device="cpu"),
                     tl.cache_specs(tc))
    logits, cache = tl.prefill(sharded, tc,
                               plan.put(torch.from_numpy(tokens),
                                        P("dp", None)),
                               cache, torch.zeros(2, dtype=torch.int32))
    assert isinstance(cache, Placed)
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(ref_logits, dtype=np.float32),
                               atol=PREFILL_ATOL)
    one_cache = tl.init_cache(tc, 2, 32, device="cpu")
    tl.prefill(ours, tc, torch.from_numpy(tokens), one_cache,
               torch.zeros(2, dtype=torch.int32))
    whole = plan.gather(cache)
    np.testing.assert_allclose(whole["k"].float().numpy(),
                               one_cache["k"].float().numpy(),
                               atol=PREFILL_ATOL)


def test_sharded_train_step():
    config = tl.LlamaConfig.tiny()
    plan = port_plan()
    params, opt_state, optimizer = tt.init_train_state(0, config, plan)
    assert isinstance(params, Placed)
    step = tt.make_train_step(config, plan, optimizer=optimizer)
    tokens = torch.from_numpy(batch(vocab=config.vocab_size))
    params, opt_state, loss1 = step(params, opt_state, tokens)
    params, opt_state, loss2 = step(params, opt_state, tokens)
    assert float(loss2) < float(loss1)      # it learns the batch
    assert np.isfinite(float(loss1))


def test_remat_training_matches_and_microbatching_averages():
    """The JAX test's bounds, on the port mesh."""
    config = tl.LlamaConfig.tiny()
    tokens = torch.from_numpy(batch(vocab=config.vocab_size))

    def first_loss(cfg, accumulate):
        plan = port_plan()
        params, opt_state, optimizer = tt.init_train_state(0, cfg, plan)
        step = tt.make_train_step(cfg, plan, optimizer=optimizer,
                                  accumulate_steps=accumulate)
        params, opt_state, loss = step(params, opt_state, tokens)
        _, _, loss2 = step(params, opt_state, tokens)
        assert float(loss2) < float(loss)
        return float(loss)

    plain = first_loss(config, 1)
    remat = first_loss(dataclasses.replace(config, remat=True), 1)
    accumulated = first_loss(config, 2)
    assert abs(plain - remat) < 1e-2
    assert abs(plain - accumulated) < 5e-2


# -- parity of the sharded step with the JAX package's ------------------------

@pytest.mark.parametrize("mode", ["plain", "remat", "accumulate-2"])
def test_sharded_step_matches_jax(mode):
    """float32 tiny on {"dp": 2, "fsdp": 2, "tp": 2}: the JAX sharded
    step and the port's placed step from the same weights -- the loss,
    every gradient leaf (``jax.value_and_grad`` of the JAX loss on the
    sharded tree; not for accumulation, which the JAX package sums
    inside its step) and every updated parameter."""
    accumulate = 2 if mode == "accumulate-2" else 1
    jc, tc = configs(remat=mode == "remat")
    jplan = jax_plan()
    jparams, jstate, optimizer = jt.init_train_state(
        jax.random.PRNGKey(0), jc, jplan)
    tokens = batch()
    plan = port_plan()
    placed = trainable(plan.put(bridged(jparams, tc),
                                tl.partition_specs(tc)))
    if accumulate == 1:
        want_loss, want_grads = jax.jit(jax.value_and_grad(
            lambda p, t: jt.language_model_loss(p, jc, t)))(
                jparams, jnp.asarray(tokens))
        loss, grads = tt.value_and_grad(placed, tc, torch.from_numpy(tokens))
        assert isinstance(grads, Placed)
        assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
        assert_leaves_close(flatten(plan.gather(grads)),
                            jax_flat(want_grads), REL_TOL)
    step = jt.make_train_step(jc, jplan, optimizer=optimizer,
                              accumulate_steps=accumulate)
    jparams, _, want_loss = step(jparams, jstate, jnp.asarray(tokens))
    ours = tt.make_train_step(tc, plan, accumulate_steps=accumulate)
    placed, _, loss = ours(placed, tt.PlacedOptimizer(tt.adamw(), placed),
                           torch.from_numpy(tokens))
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    assert_leaves_close(flatten(plan.gather(placed)), jax_flat(jparams),
                        REL_TOL)


def test_replicas_stay_bitwise_equal():
    """Every leaf replicated over dp (and the norms and embedding over
    tp) stands on distinct descriptors, each its own tensor; after three
    steps every replica holds the same bits."""
    config = configs()[1]
    plan = port_plan()
    params, opt_state, _ = tt.init_train_state(0, config, plan)
    groups = params.replicas()
    assert groups and all(len({id(t) for t in group}) == len(group)
                          for group in groups)
    step = tt.make_train_step(config, plan)
    tokens = torch.from_numpy(batch())
    for _ in range(3):
        params, opt_state, _ = step(params, opt_state, tokens)
    for group in params.replicas():
        assert all(torch.equal(group[0], member) for member in group[1:])


def test_one_device_at_every_position_stores_a_replica_once():
    """The mesh over one descriptor at eight positions (as one card
    stands for eight): a replica is one tensor, updated once, and the
    loss and gradients equal the mesh of distinct descriptors'."""
    config = configs()[1]
    spread = port_plan()
    stacked = port_plan(devices=[torch.device("cpu")] * 8)
    a, _, _ = tt.init_train_state(0, config, spread)
    b, state, _ = tt.init_train_state(0, config, stacked)
    assert b.replicas() == [] and len(b.tensors()) < len(a.tensors())
    assert sum(t.numel() for t in b.tensors()) == sum(
        leaf.numel() for leaf in flatten(tl.init_params(
            0, config, device="cpu")).values())
    tokens = torch.from_numpy(batch())
    loss_a, grads_a = tt.value_and_grad(a, config, tokens)
    loss_b, grads_b = tt.value_and_grad(b, config, tokens)
    assert abs(float(loss_a) - float(loss_b)) <= SAME_LOSS_TOL
    assert_leaves_close(flatten(stacked.gather(grads_b)),
                        {name: leaf.double().numpy() for name, leaf in
                         flatten(spread.gather(grads_a)).items()},
                        SAME_GRAD_TOL)
    stepped = [id(t) for optimizer in state.optimizers if optimizer
               for group in optimizer.param_groups for t in group["params"]]
    assert sorted(stepped) == sorted(id(t) for t in b.tensors())


def test_put_and_gather_round_trip():
    """``put`` copies each shard (the placed tree never aliases the
    source) and ``gather`` returns the source bit for bit."""
    config = configs("bfloat16")[1]
    params = tl.init_params(0, config, device="cpu")
    plan = port_plan()
    placed = plan.put(params, tl.partition_specs(config))
    shard = placed.shards[5]["layers"]["wq"]
    assert shard.shape == (config.n_layers, config.dim // 2,
                           config.n_heads * config.head_dim // 2)
    assert shard.untyped_storage().data_ptr() != \
        params["layers"]["wq"].untyped_storage().data_ptr()
    for name, leaf in flatten(plan.gather(placed)).items():
        assert torch.equal(leaf, flatten(params)[name]), name
    one = plan.put(torch.arange(8.0), P("tp"))
    assert [t.tolist() for t in one.shards[:2]] == [[0, 1, 2, 3],
                                                    [4, 5, 6, 7]]


@pytest.mark.parametrize("weights", ["bf16-tree", "int8-tree"])
def test_decode_on_placed_tree_matches_one_device(weights):
    """float32: prefill then three ``decode_step`` calls on a placed tree
    (``quantize_params`` placed by ``quantize_specs`` with an int8 cache
    for the int8 tree) equal the port's one-device entry points."""
    config = configs(kv_dtype="int8" if weights == "int8-tree"
                     else "bfloat16")[1]
    params = tl.init_params(0, config, device="cpu")
    specs = tl.partition_specs(config)
    if weights == "int8-tree":
        params, specs = quantize_params(params), quantize_specs(specs)
    plan = port_plan()
    placed = plan.put(params, specs)
    tokens = torch.from_numpy(batch((2, 8), seed=4))
    starts = torch.zeros(2, dtype=torch.int32)
    cache = tl.init_cache(config, 2, 32, device="cpu")
    pcache = plan.put(tl.init_cache(config, 2, 32, device="cpu"),
                      tl.cache_specs(config))
    want, cache = tl.prefill(params, config, tokens, cache, starts)
    got, pcache = tl.prefill(placed, config, tokens, pcache, starts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL)
    step_tokens = tokens[:, -1]
    for index in range(3):
        lengths = torch.full((2,), 8 + index, dtype=torch.int32)
        want, cache = tl.decode_step(params, config, step_tokens, cache,
                                     lengths)
        got, pcache = tl.decode_step(placed, config, step_tokens, pcache,
                                     lengths)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL)
        step_tokens = want.argmax(-1)


@pytest.mark.parametrize("path", ["dense", "flash-int8"])
def test_prefill_into_slot_on_placed_tree(path):
    """One prompt at a time into a slot of a placed batch cache
    ({"tp": 2}), then a decode step: the one-device path's logits (also
    with flash admission on an int8 tree and cache, as the card runs
    it)."""
    overrides = {} if path == "dense" else dict(attention="flash",
                                                kv_dtype="int8")
    config = configs(**overrides)[1]
    params = tl.init_params(0, config, device="cpu")
    specs = tl.partition_specs(config)
    if path != "dense":
        params, specs = quantize_params(params), quantize_specs(specs)
    plan = port_plan({"tp": 2})
    placed = plan.put(params, specs)
    cache = tl.init_cache(config, 2, 32, device="cpu")
    pcache = plan.put(tl.init_cache(config, 2, 32, device="cpu"),
                      tl.cache_specs(config))
    prompts = [torch.from_numpy(batch((1, n), seed=n)) for n in (5, 9)]
    for slot, prompt in enumerate(prompts):
        want, cache = tl.prefill_into_slot(params, config, prompt, cache,
                                           slot, 0)
        got, pcache = tl.prefill_into_slot(placed, config, prompt, pcache,
                                           slot, 0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL)
    last = torch.tensor([int(p[0, -1]) for p in prompts])
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    want, _ = tl.decode_step(params, config, last, cache, lengths)
    got, _ = tl.decode_step(placed, config, last, pcache, lengths)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL)


def test_shard_map_takes_placed_arguments_and_keeps_outputs():
    """A placed argument reaches each position as its own shard (no
    split); a ``Keep`` output comes back placed and lives across calls;
    a global argument without a spec is refused."""
    plan = port_plan({"dp": 2, "tp": 2})
    placed = plan.put(torch.arange(16.0).reshape(4, 4), P("dp", "tp"))
    double = shard_map(lambda x: x * 2, plan.mesh, in_specs=(None,),
                       out_specs=Keep(P("dp", "tp")))
    once = double(placed)
    twice = double(once)
    assert isinstance(twice, Placed)
    assert [tuple(t.shape) for t in twice.shards] == [(2, 2)] * 4
    assert torch.equal(plan.gather(twice),
                       torch.arange(16.0).reshape(4, 4) * 4)
    with pytest.raises(ValueError, match="needs its spec"):
        double(torch.ones(4, 4))
