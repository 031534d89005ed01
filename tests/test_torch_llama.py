"""Port parity for ``models/llama.py``: the same weights (bridged from
the JAX pytree through numpy) and the same inputs through both packages
on ``LlamaConfig.tiny`` at float32, logits within 1e-4 and greedy tokens
identical; plus the bf16 bridge, config parity and the option that
raises until its ROADMAP item lands."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jl
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl

TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(**overrides):
    base = dict(dtype="float32", **overrides)
    return (dataclasses.replace(jl.LlamaConfig.tiny(max_seq=64), **base),
            dataclasses.replace(tl.LlamaConfig.tiny(max_seq=64), **base))


def _tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), params)


def _twins(**overrides):
    jc, tc = _configs(**overrides)
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(_tree(jp), tc, device="cpu")
    return jc, tc, jp, tp


def _close(actual, expected):
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64),
                               np.asarray(expected, dtype=np.float64), **TOL)


def _tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def test_bridge_round_trips_bf16_bit_exactly():
    config = jl.LlamaConfig.tiny()
    params = jl.init_params(jax.random.PRNGKey(3), config)
    tagged = jax.tree_util.tree_map(
        lambda a: (np.asarray(a).view(np.uint16), "bfloat16"), params)
    widened = jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32), params)
    port = tl.LlamaConfig.tiny()
    for tree in (tagged, widened):
        ours = bridge.params_from_numpy(tree, port, device="cpu")
        for key in ("embed", "unembed"):
            assert ours[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                ours[key].view(torch.int16).numpy().view(np.uint16),
                np.asarray(params[key]).view(np.uint16))
        np.testing.assert_array_equal(
            ours["layers"]["wq"].view(torch.int16).numpy().view(np.uint16),
            np.asarray(params["layers"]["wq"]).view(np.uint16))


def test_bridge_rejects_wrong_layout():
    _, tc = _configs()
    tree = _tree(jl.init_params(jax.random.PRNGKey(0), _configs()[0]))
    tree["embed"] = tree["embed"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(tree, tc, device="cpu")
    del tree["embed"]
    with pytest.raises(ValueError, match="expected"):
        bridge.params_from_numpy(tree, tc, device="cpu")


@pytest.mark.parametrize("preset", ["llama3_8b", "llama3_1b", "tiny"])
def test_presets_match(preset):
    ours = dataclasses.asdict(getattr(tl.LlamaConfig, preset)())
    theirs = dataclasses.asdict(getattr(jl.LlamaConfig, preset)())
    assert ours == theirs
    assert getattr(tl.LlamaConfig, preset)().head_dim == \
        getattr(jl.LlamaConfig, preset)().head_dim


@pytest.mark.parametrize("field,value", [
    ("attention", "ring"), ("decode_attention", "paged"),
    ("kv_dtype", "fp8"), ("matmul_kernel", "cuda")])
def test_config_validation_matches(field, value):
    for cls in (jl.LlamaConfig, tl.LlamaConfig):
        with pytest.raises(ValueError, match=field):
            cls(**{field: value})


def test_init_params_layout_and_scale():
    jc, tc = _configs()
    ours = tl.init_params(0, tc, device="cpu")
    theirs = jl.init_params(jax.random.PRNGKey(0), jc)

    def shapes(tree):
        return {name: shapes(leaf) if isinstance(leaf, dict)
                else tuple(leaf.shape) for name, leaf in tree.items()}
    assert shapes(ours) == shapes(theirs)
    std = float(ours["layers"]["w_down"].std())
    assert abs(std - tc.hidden_dim ** -0.5) < 0.1 * tc.hidden_dim ** -0.5
    assert float(ours["layers"]["attn_norm"].min()) == 1.0
    again = tl.init_params(0, tc, device="cpu")
    assert torch.equal(again["embed"], ours["embed"])


def test_prefill_matches():
    jc, tc, jp, tp = _twins()
    tokens = _tokens((2, 12))
    starts = np.array([0, 5], dtype=np.int32)
    lj, cj = jl.prefill(jp, jc, jnp.asarray(tokens),
                        jl.init_cache(jc, 2), jnp.asarray(starts))
    lt, ct = tl.prefill(tp, tc, torch.from_numpy(tokens).long(),
                        tl.init_cache(tc, 2, device="cpu"),
                        torch.from_numpy(starts))
    _close(lt, lj)
    _close(ct["k"], cj["k"])
    _close(ct["v"], cj["v"])


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_prefill_into_slot_matches(attention):
    """Two chunks into slot 1 of a 3-slot cache: the second attends the
    first through the cache row."""
    jc, tc, jp, tp = _twins(attention=attention)
    cache_j = jl.init_cache(jc, 3)
    cache_t = tl.init_cache(tc, 3, device="cpu")
    for index, start in enumerate((0, 16)):
        chunk = _tokens((1, 16), seed=index)
        lj, cache_j = jl.prefill_into_slot(jp, jc, jnp.asarray(chunk),
                                           cache_j, jnp.int32(1),
                                           jnp.int32(start))
        lt, cache_t = tl.prefill_into_slot(tp, tc,
                                           torch.from_numpy(chunk).long(),
                                           cache_t, 1, start)
        _close(lt, lj)
    _close(cache_t["k"], cache_j["k"])


def test_prefill_into_slots_matches():
    jc, tc, jp, tp = _twins()
    tokens = _tokens((4, 8), seed=4)
    tokens[3] = tokens[0]                     # a duplicated bucket row
    slots = np.array([2, 0, 1, 2], dtype=np.int32)
    starts = np.array([0, 8, 3, 0], dtype=np.int32)
    lj, cj = jl.prefill_into_slots(jp, jc, jnp.asarray(tokens),
                                   jl.init_cache(jc, 3),
                                   jnp.asarray(slots), jnp.asarray(starts))
    lt, ct = tl.prefill_into_slots(tp, tc, torch.from_numpy(tokens).long(),
                                   tl.init_cache(tc, 3, device="cpu"),
                                   slots.tolist(), starts.tolist())
    _close(lt, lj)
    _close(ct["k"], cj["k"])
    flash_config = dataclasses.replace(tc, attention="flash")
    with pytest.raises(ValueError, match="dense-only"):
        tl.prefill_into_slots(tp, flash_config, torch.from_numpy(tokens),
                              ct, slots.tolist(), starts.tolist())


@pytest.mark.parametrize("decode_attention", ["dense", "flash"])
def test_decode_steps_match(decode_attention):
    """Prefill then 8 greedy decode steps on both packages: logits within
    1e-4 each step and identical greedy tokens."""
    jc, tc, jp, tp = _twins(decode_attention=decode_attention)
    prompts = _tokens((3, 10), seed=6)
    starts = np.zeros(3, dtype=np.int32)
    lj, cache_j = jl.prefill(jp, jc, jnp.asarray(prompts),
                             jl.init_cache(jc, 3), jnp.asarray(starts))
    lt, cache_t = tl.prefill(tp, tc, torch.from_numpy(prompts).long(),
                             tl.init_cache(tc, 3, device="cpu"),
                             torch.from_numpy(starts))
    tokens_j = jnp.argmax(lj[:, -1], -1)
    tokens_t = tl.greedy_sample(lt[:, -1])
    lengths = np.array([10, 10, 63], dtype=np.int32)  # row 2: trash row
    for _ in range(8):
        assert tokens_t.tolist() == np.asarray(tokens_j).tolist()
        lj, cache_j = jl.decode_step(jp, jc, tokens_j, cache_j,
                                     jnp.asarray(lengths))
        lt, cache_t = tl.decode_step(tp, tc, tokens_t, cache_t,
                                     torch.from_numpy(lengths))
        _close(lt, lj)
        tokens_j = jnp.argmax(lj, -1)
        tokens_t = tl.greedy_sample(lt)
        lengths[:2] += 1
    _close(cache_t["k"], cache_j["k"])


def test_decode_block_matches_at_temperature_zero():
    jc, tc, jp, tp = _twins(decode_attention="flash")
    prompts = _tokens((2, 6), seed=8)
    starts = np.zeros(2, dtype=np.int32)
    _, cache_j = jl.prefill(jp, jc, jnp.asarray(prompts),
                            jl.init_cache(jc, 2), jnp.asarray(starts))
    _, cache_t = tl.prefill(tp, tc, torch.from_numpy(prompts).long(),
                            tl.init_cache(tc, 2, device="cpu"),
                            torch.from_numpy(starts))
    first = np.array([3, 7], dtype=np.int32)
    lengths = np.array([6, 6], dtype=np.int32)
    active = np.array([True, False])
    emitted_j, tok_j, len_j, _, _ = jl.decode_block(
        jp, jc, jnp.asarray(first), cache_j, jnp.asarray(lengths),
        jnp.asarray(active), jnp.zeros(2), jax.random.PRNGKey(0),
        num_steps=5, top_k=4)
    emitted_t, tok_t, len_t, _ = tl.decode_block(
        tp, tc, torch.from_numpy(first), cache_t, torch.from_numpy(lengths),
        torch.from_numpy(active), torch.zeros(2),
        torch.Generator().manual_seed(0), num_steps=5, top_k=4)
    np.testing.assert_array_equal(emitted_t.numpy(), np.asarray(emitted_j))
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))


def test_select_tokens_top1_is_greedy():
    logits = torch.from_numpy(np.random.default_rng(9).normal(
        size=(4, 50)).astype(np.float32))
    temps = torch.tensor([0.0, 0.9, 2.0, 0.5])
    got = tl.select_tokens(torch.Generator().manual_seed(1), logits, temps,
                           top_k=1)
    assert got.tolist() == logits.argmax(-1).tolist()


def test_select_tokens_samples_within_top_k():
    logits = torch.from_numpy(np.random.default_rng(10).normal(
        size=(3, 40)).astype(np.float32))
    temps = torch.tensor([1.0, 1.0, 1.0])
    allowed = torch.topk(logits, 3).indices
    gen = torch.Generator().manual_seed(2)
    for _ in range(20):
        got = tl.select_tokens(gen, logits, temps, top_k=3)
        assert all(int(got[row]) in allowed[row].tolist() for row in range(3))


@pytest.mark.parametrize("case", ["moe"])
def test_unported_options_raise(case):
    _, tc = _configs()
    call = lambda: tl.init_params(0, dataclasses.replace(
        tc, n_experts=4), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call()
