"""Port twins for a mixture-of-experts admission burst whose rows fall in
several dp groups (``models/llama.py`` ``_admit_on_mesh`` and
``BurstShard``): the JAX package's ``prefill_into_slots`` is one jit
under GSPMD, which routes the whole burst with one capacity
(``moe_capacity`` over all N * S tokens).  The port runs each group's
rows at that group's positions, padded to the largest group's count,
and routes them as that one burst.

The JAX tree is placed over ``{"dp": 2, "tp": 2}`` on four of its
virtual CPU devices, the port's over four CPU descriptors; the same
weights reach both packages through the numpy bridge, float32.

Tolerances: logits within 1e-4 of the JAX package's sharded call (the
bound of its own sharded MoE test, as ``tests/test_torch_moe_ep.py``;
summation order only) and of the port's unplaced call; the cache rows
within 1e-5 of their largest magnitude; the routes dropped equal to
the port's unplaced call's; greedy token streams equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.parallel import MeshPlan as JaxPlan
from aiko_services_tpu.parallel import make_mesh as jax_make_mesh
from aiko_services_tpu_torch.models import batching as tb
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl
from aiko_services_tpu_torch.parallel import MeshPlan, Placed, make_mesh

TOL = 1e-4
CACHE_TOL = 1e-5
AXES = {"dp": 2, "tp": 2}
POOL = [torch.device("cpu", index) for index in range(8)]
#: a burst over both dp groups of a 4-slot cache (2 rows a group): the
#: last row pads the burst by repeating the first, as the batcher does.
SLOTS, STARTS = [3, 0, 2, 3], [16, 0, 0, 16]


def twins(capacity_factor: float, attention: str = "dense", max_seq=32):
    settings = dict(dtype="float32", capacity_factor=capacity_factor,
                    attention=attention)
    jc, tc = (dataclasses.replace(cls.tiny_moe(128, max_seq), **settings)
              for cls in (jl.LlamaConfig, tl.LlamaConfig))
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")


def port_plan(axes=AXES) -> MeshPlan:
    return MeshPlan(make_mesh(axes, POOL[:int(np.prod(list(
        axes.values())))]))


def burst_tokens() -> np.ndarray:
    tokens = np.random.default_rng(7).integers(0, 128, (4, 16)) \
        .astype(np.int32)
    tokens[3] = tokens[0]
    return tokens


@pytest.mark.parametrize("capacity_factor", [2.0, 0.25])
def test_burst_over_dp_groups_matches_jax(capacity_factor):
    """The burst through ``prefill_into_slots`` on both packages' placed
    trees: the logits of the JAX package's sharded call and of the
    port's unplaced call, in row order, and the cache rows of both."""
    jc, tc, jp, ours = twins(capacity_factor)
    tokens = burst_tokens()
    with jax.default_matmul_precision("highest"):
        jplan = JaxPlan(jax_make_mesh(AXES, jax.devices()[:4]))
        sharded = jplan.put(jp, jl.partition_specs(jc))
        jcache = jax.device_put(
            jl.init_cache(jc, 4, 32),
            jax.tree_util.tree_map(jplan.shard, jl.cache_specs(jc)))
        want, jcache = jl.prefill_into_slots(
            sharded, jc, jnp.asarray(tokens), jcache, jnp.asarray(SLOTS),
            jnp.asarray(STARTS))
    plan = port_plan()
    placed = plan.put(ours, tl.partition_specs(tc))
    cache = plan.put(tl.init_cache(tc, 4, 32, device="cpu"),
                     tl.cache_specs(tc))
    got, cache = tl.prefill_into_slots(placed, tc, torch.from_numpy(tokens),
                                       cache, SLOTS, STARTS)
    alone, _ = tl.prefill_into_slots(
        ours, tc, torch.from_numpy(tokens),
        tl.init_cache(tc, 4, 32, device="cpu"), SLOTS, STARTS)
    assert isinstance(cache, Placed)
    assert got.shape == (4, 16, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(got.numpy(), alone.numpy(), atol=TOL)
    whole = plan.gather(cache)
    for side in ("k", "v"):
        theirs = np.asarray(jcache[side])
        scale = np.abs(theirs).max()
        np.testing.assert_allclose(whole[side].numpy(), theirs,
                                   atol=CACHE_TOL * scale)
        assert not whole[side][:, 1].any()       # no row of the burst


@pytest.mark.parametrize("capacity_factor", [2.0, 0.25])
def test_burst_drops_each_route_once(capacity_factor):
    """The routes the placed burst drops, each counted once, equal the
    unplaced call's (at 0.25 they drop)."""
    _, tc, _, ours = twins(capacity_factor)
    tokens = torch.from_numpy(burst_tokens())
    with tl.record_route_drops() as alone:
        tl.prefill_into_slots(ours, tc, tokens,
                              tl.init_cache(tc, 4, 32, device="cpu"),
                              SLOTS, STARTS)
    plan = port_plan()
    placed = plan.put(ours, tl.partition_specs(tc))
    cache = plan.put(tl.init_cache(tc, 4, 32, device="cpu"),
                     tl.cache_specs(tc))
    with tl.record_route_drops() as drops:
        tl.prefill_into_slots(placed, tc, tokens, cache, SLOTS, STARTS)
    assert int(sum(drops)) == int(sum(alone))
    assert (int(sum(alone)) > 0) == (capacity_factor < 1)


def test_burst_in_one_group_runs_that_group_only():
    """A burst whose rows all fall in one dp group still runs only that
    group: the other group's cache rows stay zero, and the logits are
    the unplaced call's."""
    _, tc, _, ours = twins(0.25)
    tokens = torch.from_numpy(burst_tokens()[:2])
    plan = port_plan()
    placed = plan.put(ours, tl.partition_specs(tc))
    cache = plan.put(tl.init_cache(tc, 4, 32, device="cpu"),
                     tl.cache_specs(tc))
    got, cache = tl.prefill_into_slots(placed, tc, tokens, cache, [3, 2],
                                       [0, 0])
    want, _ = tl.prefill_into_slots(ours, tc, tokens,
                                    tl.init_cache(tc, 4, 32, device="cpu"),
                                    [3, 2], [0, 0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)
    assert not plan.gather(cache)["k"][:, :2].any()


def serve(params, config, **options) -> dict:
    batcher = tb.ContinuousBatcher(params, config, max_slots=4, max_seq=64,
                                   prefill_chunk=16, device="cpu",
                                   **options)
    rng = np.random.default_rng(2)
    streams = {}
    for index, length in enumerate((7, 23, 9, 30)):
        streams[index] = []
        batcher.submit(tb.Request(
            str(index), rng.integers(0, 128, length).tolist(),
            max_new_tokens=6,
            emit=lambda rid, token, done: streams[int(rid)].append(token)))
    assert batcher.run_until_drained(max_steps=300) < 300
    assert all(len(stream) == 6 for stream in streams.values())
    return streams


@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 2}, {"dp": 2, "ep": 2}],
                         ids=["dp2-tp2", "dp2-ep2"])
@pytest.mark.parametrize("options", [
    dict(decode_block=4, inflight=2), dict(decode_block_tokens=8)],
    ids=["pipelined", "device-loop"])
def test_placed_moe_batcher_matches_unplaced(axes, options):
    """The MoE batcher on a tree placed over ``axes``, its cache split
    over dp: admission bursts over both groups (four requests on four
    slots, dense admission), and greedy streams equal to the unplaced
    batcher's, at a capacity factor where admission drops routes."""
    _, tc, _, ours = twins(0.5, max_seq=64)
    plan = port_plan(axes)
    placed = plan.put(ours, tl.partition_specs(tc))
    assert serve(placed, tc, cache_put=lambda cache: plan.put(
        cache, tl.cache_specs(tc)), **options) == serve(ours, tc, **options)
