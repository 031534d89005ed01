"""Port twins of the JAX package's expert-parallel tests in
``tests/test_moe.py`` on port meshes of CPU descriptors (the tests'
pool): ``test_ep_sharded_matches_unsharded`` on ``{"dp": 2, "ep": 4}``
against the JAX package's forward sharded on its eight virtual devices,
at capacity factor 2.0 and at 0.1 (where routes drop: the capacity and
the slots follow the global batch), ``test_quantized_moe_specs_shard``
on ``{"dp": 2, "ep": 2, "tp": 2}`` and ``test_moe_train_step_learns``
on the same mesh; and a tiny MoE under context parallelism
(``models/long_context.py`` over ``{"sp": 2, "ep": 2}``) against the
JAX package's ``make_long_context_forward``.  The same weights reach
both packages through the numpy bridge.

Tolerances, float32: logits within 1e-4 of the JAX package's (its own
sharded test's bound; summation order only); the aux within 1e-5 of the
port's one-device aux; the routes dropped equal to the one-device
path's; ``quantize_specs`` equal to the JAX package's entry for entry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.models import long_context as jlc
from aiko_services_tpu.models.quant import quantize_specs as jax_specs
from aiko_services_tpu.parallel import MeshPlan as JaxPlan
from aiko_services_tpu.parallel import P as JaxP
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl
from aiko_services_tpu_torch.models import train as tt
from aiko_services_tpu_torch.models.long_context import \
    make_long_context_forward
from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                  quantize_specs)
from aiko_services_tpu_torch.parallel import MeshPlan, P, Placed, make_mesh

TOL = 1e-4
AUX_TOL = 1e-5

POOL = [torch.device("cpu", index) for index in range(8)]


def port_plan(axes: dict) -> MeshPlan:
    count = int(np.prod(list(axes.values())))
    return MeshPlan(make_mesh(axes, POOL[:count]))


def configs(**overrides):
    settings = dict(dtype="float32", **overrides)
    return (dataclasses.replace(jl.LlamaConfig.tiny_moe(128, 32),
                                **settings),
            dataclasses.replace(tl.LlamaConfig.tiny_moe(128, 32),
                                **settings))


def twins(**overrides):
    jc, tc = configs(**overrides)
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")


def tokens(shape=(2, 16), seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 128, shape) \
        .astype(np.int32)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.1])
def test_ep_sharded_matches_unsharded(capacity_factor):
    """Experts split over ep on {"dp": 2, "ep": 4}: the JAX package's
    sharded forward's logits; the aux and the routes dropped equal the
    port's one-device forward's (at 0.1 routes drop)."""
    jc, tc, jp, ours = twins(capacity_factor=capacity_factor)
    toks = tokens()
    with jax.default_matmul_precision("highest"):
        jplan = JaxPlan.build({"dp": 2, "ep": 4})
        sharded = jplan.put(jp, jl.partition_specs(jc))
        cache = jax.device_put(
            jl.init_cache(jc, 2, 32),
            jax.tree_util.tree_map(jplan.shard, jl.cache_specs(jc)))
        want, _ = jl.prefill(
            sharded, jc, jax.device_put(jnp.asarray(toks),
                                        jplan.shard(JaxP("dp", None))),
            cache, jnp.zeros(2, dtype=jnp.int32))
    starts = torch.zeros(2, dtype=torch.int32)
    with tl.record_route_drops() as one_drops:
        _, _, one_aux = tl.prefill_with_aux(
            ours, tc, torch.from_numpy(toks),
            tl.init_cache(tc, 2, 32, device="cpu"), starts)
    plan = port_plan({"dp": 2, "ep": 4})
    placed = plan.put(ours, tl.partition_specs(tc))
    cache = plan.put(tl.init_cache(tc, 2, 32, device="cpu"),
                     tl.cache_specs(tc))
    with tl.record_route_drops() as drops:
        logits, cache, aux = tl.prefill_with_aux(
            placed, tc, plan.put(torch.from_numpy(toks), P("dp", None)),
            cache, starts)
    assert isinstance(cache, Placed)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=TOL)
    assert abs(float(aux) - float(one_aux)) <= AUX_TOL
    assert int(sum(drops)) == int(sum(one_drops))
    assert (int(sum(drops)) > 0) == (capacity_factor < 1)


def test_quantized_moe_specs_shard():
    """``quantize_specs`` maps the MoE layout (4-D expert weights) as
    the JAX package's does; the placed int8 tree decodes on
    {"dp": 2, "ep": 2, "tp": 2}."""
    config = tl.LlamaConfig.tiny_moe()
    specs = quantize_specs(tl.partition_specs(config))
    want = jax_specs(jl.partition_specs(jl.LlamaConfig.tiny_moe()))
    assert specs["layers"]["w_gate"]["int8"] == P(None, "ep", "fsdp", "tp")
    assert specs["layers"]["w_gate"]["scale"] == P(None, "ep", None, "tp")
    flat_ours = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(tuple, specs,
                               is_leaf=lambda x: isinstance(x, P)))
    flat_want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(tuple, want,
                               is_leaf=lambda x: isinstance(x, JaxP)))
    assert flat_ours == flat_want
    params = quantize_params(tl.init_params(0, config, device="cpu"))
    plan = port_plan({"dp": 2, "ep": 2, "tp": 2})
    sharded = plan.put(params, specs)
    cache = plan.put(tl.init_cache(config, 2, 32, device="cpu"),
                     tl.cache_specs(config))
    logits, _ = tl.decode_step(sharded, config,
                               torch.zeros(2, dtype=torch.int32), cache,
                               torch.zeros(2, dtype=torch.int32))
    assert logits.shape == (2, config.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


def test_moe_train_step_learns():
    """Sharded MoE training on {"dp": 2, "ep": 2, "tp": 2}: the loss
    (CE + aux) falls on a repeated batch, and the first loss is the
    one-device step's."""
    config = tl.LlamaConfig.tiny_moe(vocab_size=128, max_seq=64)
    plan = port_plan({"dp": 2, "ep": 2, "tp": 2})
    params, opt_state, optimizer = tt.init_train_state(0, config, plan)
    step = tt.make_train_step(config, plan, optimizer=optimizer)
    toks = torch.from_numpy(tokens((4, 16), seed=3))
    params, opt_state, loss1 = step(params, opt_state, toks)
    params, opt_state, loss2 = step(params, opt_state, toks)
    assert np.isfinite(float(loss1))
    assert float(loss2) < float(loss1)
    one = MeshPlan.build({"dp": 1}, devices=[torch.device("cpu")])
    params, opt_state, _ = tt.init_train_state(0, config, one)
    _, _, want = tt.make_train_step(config, one)(params, opt_state, toks)
    assert abs(float(loss1) - float(want)) <= 1e-2


@pytest.mark.parametrize("capacity_factor", [2.0, 0.1])
def test_moe_under_context_parallelism(capacity_factor):
    """A tiny MoE under ``make_long_context_forward`` (ring) over
    {"sp": 2, "ep": 2}: the JAX package's long-context forward on the
    same weights, routes dropping at 0.1 as the whole batch's do."""
    jc, tc, jp, ours = twins(capacity_factor=capacity_factor)
    toks = tokens((2, 32), seed=5)
    axes = {"sp": 2, "ep": 2}
    with jax.default_matmul_precision("highest"):
        jplan = JaxPlan.build(axes, devices=jax.devices()[:4])
        want = jlc.make_long_context_forward(jc, jplan, "ring")(
            jp, jnp.asarray(toks))
    got = make_long_context_forward(tc, port_plan(axes), "ring")(
        ours, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
