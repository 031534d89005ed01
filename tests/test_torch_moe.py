"""Port parity for the mixture-of-experts FFN (``models/llama.py``
``_moe_ffn``): twins of ``tests/test_moe.py`` on the port, the same
weights reaching both packages through the numpy bridge, float32.

Tolerances: logits, the FFN output and the aux within 1e-5 (absolute,
summation order only; the sharded JAX forward within 1e-4, as its own
test); quantized codes and scales bit-equal; greedy token streams equal.

The mesh tests (``test_ep_sharded_matches_unsharded`` on a port mesh,
``test_quantized_moe_specs_shard``, ``test_moe_train_step_learns`` over
dp x ep x tp) are twinned on port meshes in ``test_torch_moe_ep.py``;
here ``test_ep_sharded_matches_unsharded`` holds the port's one-device
forward to the JAX package's sharded one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import batching as jb
from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.models import quant as jq
from aiko_services_tpu.models import train as jt
from aiko_services_tpu.parallel import MeshPlan as JaxPlan, P
from aiko_services_tpu_torch.models import batching as tb
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl
from aiko_services_tpu_torch.models import quant as tq
from aiko_services_tpu_torch.models import train as tt
from aiko_services_tpu_torch.parallel.mesh import MeshPlan
from test_moe import _align_moe

TOL = 1e-5


def configs(vocab=128, max_seq=32, **overrides):
    settings = dict(dtype="float32", **overrides)
    return (dataclasses.replace(jl.LlamaConfig.tiny_moe(vocab, max_seq),
                                **settings),
            dataclasses.replace(tl.LlamaConfig.tiny_moe(vocab, max_seq),
                                **settings))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def twins(**overrides):
    jc, tc = configs(**overrides)
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, bridge.params_from_numpy(numpy_tree(jp), tc,
                                                device="cpu")


def tokens(shape=(2, 16), seed=1, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def jax_prefill(params, config, toks):
    logits, _ = jl.prefill(params, config, jnp.asarray(toks),
                           jl.init_cache(config, toks.shape[0], 32),
                           jnp.zeros(toks.shape[0], dtype=jnp.int32))
    return np.asarray(logits)


def port_prefill(params, config, toks):
    logits, _ = tl.prefill(params, config, torch.from_numpy(toks),
                           tl.init_cache(config, toks.shape[0], 32,
                                         device="cpu"),
                           torch.zeros(toks.shape[0], dtype=torch.int32))
    return logits.detach().numpy()


def test_moe_param_structure():
    config = tl.LlamaConfig.tiny_moe()
    e, d, f, n = (config.n_experts, config.dim, config.hidden_dim,
                  config.n_layers)
    params = tl.init_params(0, config, device="cpu")
    layers = params["layers"]
    assert layers["w_router"].shape == (n, d, e)
    assert layers["w_gate"].shape == (n, e, d, f)
    assert layers["w_up"].shape == (n, e, d, f)
    assert layers["w_down"].shape == (n, e, f, d)
    assert tl.abstract_params(config)["layers"]["w_down"].shape \
        == (n, e, f, d)
    # The bridge carries the JAX tree's 4-D expert leaves and the router
    # as they are.
    jc, tc, jp, tp = twins()
    for name in ("w_router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(tp["layers"][name].numpy(),
                                      np.asarray(jp["layers"][name]))


def test_single_expert_equals_dense_ffn():
    """E=1, k=1 routing is the identity: the MoE block reproduces the
    dense FFN (gates renormalize to 1, capacity holds every token)."""
    dense = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=128,
                                                    max_seq=32),
                                dtype="float32")
    moe = dataclasses.replace(dense, n_experts=1, n_experts_per_token=1)
    dense_params = tl.init_params(0, dense, device="cpu")
    layers = dict(dense_params["layers"])
    for name in ("w_gate", "w_up", "w_down"):
        layers[name] = layers[name][:, None]
    layers["w_router"] = torch.zeros((moe.n_layers, moe.dim, 1))
    moe_params = dict(dense_params, layers=layers)
    toks = tokens((2, 12))
    np.testing.assert_allclose(port_prefill(moe_params, moe, toks),
                               port_prefill(dense_params, dense, toks),
                               atol=1e-4)


def test_ep_sharded_matches_unsharded():
    """The port's one-device forward against the JAX package's forward
    with the experts sharded over ep on a {"dp": 2, "ep": 4} mesh."""
    jc, tc, jp, tp = twins()
    toks = tokens()
    with jax.default_matmul_precision("highest"):
        plan = JaxPlan.build({"dp": 2, "ep": 4})
        sharded = plan.put(jp, jl.partition_specs(jc))
        cache = jax.device_put(
            jl.init_cache(jc, 2, 32),
            jax.tree_util.tree_map(plan.shard, jl.cache_specs(jc)))
        ep_logits, _ = jl.prefill(
            sharded, jc, jax.device_put(jnp.asarray(toks),
                                        plan.shard(P("dp", None))),
            cache, jnp.zeros(2, dtype=jnp.int32))
    np.testing.assert_allclose(port_prefill(tp, tc, toks),
                               np.asarray(ep_logits), atol=1e-4)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.1])
def test_prefill_logits_match_jax(capacity_factor):
    """At 0.1 some (token, expert) routes drop: the same ones in both
    packages, so the logits still agree."""
    jc, tc, jp, tp = twins(capacity_factor=capacity_factor)
    toks = tokens()
    logits = port_prefill(tp, tc, toks)
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, jax_prefill(jp, jc, toks), atol=TOL)
    if capacity_factor == 0.1:
        assert tc.moe_capacity(32) == 8


def moe_layers(config, router: str):
    """One layer's expert weights (numpy, seed 0) with a zero, random or
    collapsed router, and all-positive activations x [1, 16, D]."""
    rng = np.random.default_rng(0)
    e, d, f = config.n_experts, config.dim, config.hidden_dim
    layer = {"w_router": np.zeros((d, e), np.float32),
             "w_gate": 0.02 * rng.standard_normal((e, d, f)),
             "w_up": 0.02 * rng.standard_normal((e, d, f)),
             "w_down": 0.02 * rng.standard_normal((e, f, d))}
    if router == "random":
        layer["w_router"] = rng.standard_normal((d, e))
    elif router == "collapsed":
        layer["w_router"][:, 0] = 10.0
    layer = {name: value.astype(np.float32) for name, value in layer.items()}
    x = rng.uniform(0.5, 1.0, (1, 16, d)).astype(np.float32)
    return layer, x


@pytest.mark.parametrize("router", ["zero", "random", "collapsed"])
def test_moe_ffn_matches_jax(router):
    """``_moe_ffn``'s output and aux equal the JAX package's on the same
    x and layer; a zero router ties every probability, so this also
    holds the lowest-index-first choice of ``lax.top_k``."""
    jc, tc = configs(max_seq=64)
    layer, x = moe_layers(tc, router)
    want_out, want_aux = jl._moe_ffn(
        jc, jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()})
    out, aux = tl._moe_ffn(tc, torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in layer.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=TOL)
    assert abs(float(aux) - float(want_aux)) <= TOL


def test_load_balance_aux():
    """Twin of test_moe.py: exactly 1.0 under uniform router
    probabilities, above 1.8 (-> E/k = 2) as routing collapses."""
    _, tc = configs(max_seq=64)
    results = {}
    for router in ("zero", "collapsed"):
        layer, x = moe_layers(tc, router)
        _, aux = tl._moe_ffn(tc, torch.from_numpy(x),
                             {k: torch.from_numpy(v)
                              for k, v in layer.items()})
        results[router] = float(aux)
    assert abs(results["zero"] - 1.0) < 1e-5
    assert results["collapsed"] > 1.8


def test_router_gates_carry_the_gradient():
    _, tc = configs(max_seq=64)
    layer, x = moe_layers(tc, "random")
    weights = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in layer.items()}
    out, aux = tl._moe_ffn(tc, torch.from_numpy(x), weights)
    out.sum().backward()
    assert weights["w_router"].grad.abs().max() > 0


# -- serving through the batcher ---------------------------------------------

def serve(module, params, config, prompts, **kwargs):
    if module is tb:
        kwargs["device"] = "cpu"
    batcher = module.ContinuousBatcher(params, config, max_slots=2,
                                       max_seq=64, prefill_chunk=16,
                                       **kwargs)
    streams = {}
    for index, prompt in enumerate(prompts):
        streams[index] = []
        batcher.submit(module.Request(
            f"r{index}", list(prompt), max_new_tokens=5,
            emit=lambda rid, token, done, i=index: streams[i].append(token)))
    assert batcher.run_until_drained(max_steps=300) < 300
    return streams, batcher


def prompts(vocab=512):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).tolist() for n in (7, 23, 9)]


LOOPS = {"sync": dict(decode_block=1),
         "pipelined": dict(decode_block=4, inflight=2),
         "paged": dict(decode_block=1, kv_page_tokens=16),
         "device-loop": dict(decode_block_tokens=8),
         "ngram-paged": dict(decode_block_tokens=8, speculative="ngram",
                             kv_page_tokens=16)}


@pytest.mark.parametrize("loop,capacity_factor", [
    *((loop, 2.0) for loop in LOOPS),
    ("sync", 0.5), ("paged", 0.5)])
def test_moe_serving_matches_jax_batcher(loop, capacity_factor):
    """Greedy MoE streams through the port's batcher equal the JAX
    package's SYNCHRONOUS loop's on the same weights (its pipelined loop
    races on the CPU backend, ROADMAP Queue 3).  At capacity factor 2.0
    (top-2 of 4 experts) the capacity is every routed row, so no route
    drops and every loop emits one stream.  At 0.5 admission chunks drop
    routes, and a loop's stream depends on which rows it routes
    together: the pipelined and device loops admit bursts through
    ``prefill_into_slots``, the synchronous loop one slot at a time, in
    both packages.  So 0.5 runs the synchronous loops here, and
    :func:`test_entry_points_route_like_jax` holds every entry point's
    rows at dropping capacity."""
    options = LOOPS[loop]
    jc, tc = (dataclasses.replace(config, dtype="float32",
                                  capacity_factor=capacity_factor)
              for config in (jl.LlamaConfig.tiny_moe(),
                             tl.LlamaConfig.tiny_moe()))
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(numpy_tree(jp), tc, device="cpu")
    theirs, _ = serve(jb, jp, jc, prompts())
    ours, batcher = serve(tb, tp, tc, prompts(), **options)
    assert ours == theirs
    assert all(len(stream) == 5 for stream in ours.values())
    if batcher._pages is not None:
        assert batcher._pages.leaked_pages() == 0


def test_entry_points_route_like_jax():
    """At capacity factor 0.25 every call below drops routes (capacity 8
    of 2n choices), so its logits equal the JAX package's only if it
    routes the same rows: one chunk row (``prefill_into_slot``), the
    admitted rows with a duplicate padding row (``prefill_into_slots``),
    all B rows of a decode step (inactive rows at the trash position
    included) and the B * S rows of a verify chunk (``_chunk_verify``)."""
    jc, tc, jp, tp = twins(max_seq=64, capacity_factor=0.25)
    rng = np.random.default_rng(5)

    def close(ours, theirs):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                                   atol=TOL)

    chunk = rng.integers(0, 128, (1, 16)).astype(np.int32)
    theirs, _ = jl.prefill_into_slot(jp, jc, jnp.asarray(chunk),
                                     jl.init_cache(jc, 4), 2, 0)
    ours, _ = tl.prefill_into_slot(tp, tc, torch.from_numpy(chunk),
                                   tl.init_cache(tc, 4, device="cpu"), 2, 0)
    close(ours, theirs)

    chunks = rng.integers(0, 128, (3, 16)).astype(np.int32)
    chunks[2] = chunks[1]
    slots, starts = [0, 3, 3], [0, 16, 16]
    theirs, _ = jl.prefill_into_slots(
        jp, jc, jnp.asarray(chunks), jl.init_cache(jc, 4),
        jnp.asarray(slots), jnp.asarray(starts))
    ours, _ = tl.prefill_into_slots(tp, tc, torch.from_numpy(chunks),
                                    tl.init_cache(tc, 4, device="cpu"),
                                    slots, starts)
    close(ours, theirs)

    b = 32
    step_tokens = rng.integers(0, 128, b).astype(np.int32)
    lengths = rng.integers(0, 40, b).astype(np.int32)
    lengths[::5] = 63                               # trash rows
    theirs, _ = jl.decode_step(jp, jc, jnp.asarray(step_tokens),
                               jl.init_cache(jc, b), jnp.asarray(lengths))
    ours, _ = tl.decode_step(tp, tc, torch.from_numpy(step_tokens),
                             tl.init_cache(tc, b, device="cpu"),
                             torch.from_numpy(lengths))
    close(ours, theirs)

    verify = rng.integers(0, 128, (8, 5)).astype(np.int32)
    verify_starts = rng.integers(0, 40, 8).astype(np.int32)
    theirs, _ = jl._chunk_verify(jp, jc, jnp.asarray(verify),
                                 jl.init_cache(jc, 8),
                                 jnp.asarray(verify_starts), 63)
    ours, _ = tl._chunk_verify(tp, tc, torch.from_numpy(verify),
                               tl.init_cache(tc, 8, device="cpu"),
                               torch.from_numpy(verify_starts), 63)
    close(ours, theirs)


# -- int8 expert leaves ------------------------------------------------------

def test_quantized_moe_forward():
    """``quantize_params`` quantizes the 4-D expert leaves per output
    channel ([L, E, 1, F] scales): codes and scales bit-equal to the JAX
    package's.  On grid-aligned weights the quantized forward matches
    the raw one (test_moe.py's 2e-3), and the JAX quantized forward."""
    jc, tc = configs(vocab=256)
    aligned = _align_moe(jl.init_params(jax.random.PRNGKey(0), jc))
    want = jq.quantize_params(aligned)
    params = bridge.params_from_numpy(numpy_tree(aligned), tc, device="cpu")
    quantized = tq.quantize_params(params)
    for name in tq.QUANTIZED_LAYER_KEYS:
        for part in ("int8", "scale"):
            np.testing.assert_array_equal(
                quantized["layers"][name][part].numpy(),
                np.asarray(want["layers"][name][part]))
    assert quantized["layers"]["w_gate"]["scale"].shape \
        == (tc.n_layers, tc.n_experts, 1, tc.hidden_dim)
    toks = tokens((2, 8), seed=2, vocab=256)
    q_logits = port_prefill(quantized, tc, toks)
    np.testing.assert_allclose(port_prefill(params, tc, toks), q_logits,
                               atol=2e-3)
    np.testing.assert_allclose(q_logits, jax_prefill(want, jc, toks),
                               atol=TOL)


# -- training ----------------------------------------------------------------

def test_moe_train_step_learns():
    """Twin of test_moe.py's train step (on the port's one device): the
    loss (CE + aux) decreases on a repeated batch, and the first loss
    equals the JAX package's on the same weights at float32."""
    jc, tc = configs(max_seq=64)
    plan = MeshPlan.build({"dp": 1}, devices=[torch.device("cpu")])
    jax_plan = JaxPlan.build({"dp": 1}, devices=jax.devices()[:1])
    toks = tokens((4, 16), seed=3)
    jparams, jstate, optimizer = jt.init_train_state(
        jax.random.PRNGKey(0), jc, jax_plan)
    params = bridge.params_from_numpy(numpy_tree(jparams), tc, device="cpu")
    _, _, want = jt.make_train_step(jc, jax_plan, optimizer=optimizer)(
        jparams, jstate, jnp.asarray(toks))
    step = tt.make_train_step(tc, plan)
    leaves = tt._leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    params, state, loss1 = step(params, tt.adamw()(leaves),
                                torch.from_numpy(toks))
    params, state, loss2 = step(params, state, torch.from_numpy(toks))
    assert abs(float(loss1) - float(want)) <= TOL
    assert np.isfinite(float(loss1)) and float(loss2) < float(loss1)
    # bf16, as test_moe.py trains.
    config = tl.LlamaConfig.tiny_moe(vocab_size=128, max_seq=64)
    params, state, _ = tt.init_train_state(0, config, plan)
    step = tt.make_train_step(config, plan)
    params, state, loss1 = step(params, state, torch.from_numpy(toks))
    _, _, loss2 = step(params, state, torch.from_numpy(toks))
    assert float(loss2) < float(loss1)
