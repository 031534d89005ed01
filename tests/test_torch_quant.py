"""Port parity for int8 serving: ``models/quant.py`` (codes and scales
bit-equal to the JAX package's), the int8 branches of ``ops/layers.py``,
the int8 matmul (#5) plain version against the Pallas kernel in
interpret mode, and the model and batcher on a quantized tree with an
int8 KV cache, dense cache here (the paged cache in
test_torch_paged.py), all on ``LlamaConfig.tiny`` at float32 with
inputs from a numpy seed.

Tolerances: quantizers bit-equal; exact dequantization paths (prefill,
the flash decode kernels) 1e-5 / 1e-4 (summation order); the dense int8
decode path, which quantizes the query and the softmax weights, 1e-4 on
the attention output and the logits (the same codes up to a rounding
tie); the int8 matmul exact on grid inputs and 1e-5 relative on random
ones; greedy streams token-identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import batching as jb
from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.models import quant as jq
from aiko_services_tpu.ops import layers as jlayers
from aiko_services_tpu.ops.pallas_matmul import int8_matmul as jax_int8_matmul
from aiko_services_tpu_torch.models import batching as tb
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl
from aiko_services_tpu_torch.models import quant as tq
from aiko_services_tpu_torch.ops import flash_decode as tdec
from aiko_services_tpu_torch.ops import layers as tlayers
from aiko_services_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                     int8_matmul_reference)

EXACT = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


def _close(actual, expected, tol=TOL):
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64),
                               np.asarray(expected, dtype=np.float64), **tol)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _same_leaf(ours: dict, theirs: dict):
    """int8 codes and float32 scales bit for bit."""
    assert ours["int8"].dtype == torch.int8
    assert ours["scale"].dtype == torch.float32
    np.testing.assert_array_equal(ours["int8"].numpy(),
                                  np.asarray(theirs["int8"]))
    np.testing.assert_array_equal(ours["scale"].numpy(),
                                  np.asarray(theirs["scale"]))


# -- the quantizers ---------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((64, 128), "float32"),
                                         ((3, 32, 48), "float32"),
                                         ((2, 16, 40), "bfloat16")])
def test_quantize_weight_bit_equal(shape, dtype):
    """Per-output-channel codes and scales equal the JAX package's,
    stacked weights (quantized a layer at a time here) included; a
    channel of zeros takes the 1e-8 floor on both sides."""
    weight = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    weight[..., 3] = 0.0
    weight[..., 0, 5] = 7.0                      # a pinned channel max
    jw = jnp.asarray(weight, getattr(jnp, dtype))
    tw = _t(weight).to(getattr(torch, dtype))
    _same_leaf(tq.quantize_weight(tw), jq.quantize_weight(jw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    x[0, 0] = 0.0                                # an all-zero row
    x[1, 2, 1] = np.linspace(-1.27, 1.27, 16)    # codes on rounding ties
    ours = tq.quantize_kv(_t(x).to(getattr(torch, dtype)))
    theirs = jq.quantize_kv(jnp.asarray(x, getattr(jnp, dtype)))
    _same_leaf(ours, theirs)
    assert ours["scale"].shape == (2, 9, 3, 1)
    for target in ("float32", "bfloat16"):
        _close(tq.dequantize_kv(ours, getattr(torch, target)).float(),
               np.asarray(jq.dequantize_kv(theirs, getattr(jnp, target)),
                          dtype=np.float32), dict(atol=0, rtol=0))


def test_quantize_params_bit_equal_and_bridges():
    """The port's quantization of the bridged bf16 tree equals the JAX
    package's quantized tree bridged through numpy, leaf for leaf; the
    tree has the JAX package's structure and about half the bytes."""
    config = jl.LlamaConfig.tiny()
    params = jl.init_params(jax.random.PRNGKey(0), config)
    tagged = jax.tree_util.tree_map(
        lambda a: (np.asarray(a).view(np.uint16), "bfloat16"), params)
    ours = tq.quantize_params(bridge.params_from_numpy(
        tagged, tl.LlamaConfig.tiny(), device="cpu"))
    theirs = jq.quantize_params(params)
    bridged = bridge.params_from_numpy(
        {**_np(theirs), "embed": tagged["embed"],
         "final_norm": tagged["final_norm"],
         "layers": {**_np(theirs["layers"]),
                    "attn_norm": tagged["layers"]["attn_norm"],
                    "mlp_norm": tagged["layers"]["mlp_norm"]}},
        tl.LlamaConfig.tiny(), device="cpu")
    for name in tq.QUANTIZED_LAYER_KEYS:
        _same_leaf(ours["layers"][name], theirs["layers"][name])
        _same_leaf(bridged["layers"][name], theirs["layers"][name])
    _same_leaf(ours["unembed"], theirs["unembed"])
    _same_leaf(bridged["unembed"], theirs["unembed"])
    assert not tq.is_quantized(ours["embed"])
    assert torch.equal(ours["embed"], bridged["embed"])
    raw = config.n_layers * config.dim * config.hidden_dim * 2
    leaf = ours["layers"]["w_gate"]
    assert leaf["int8"].nbytes + leaf["scale"].nbytes < raw * 0.55
    assert tuple(jq.QUANTIZED_LAYER_KEYS) == tq.QUANTIZED_LAYER_KEYS


def test_bridge_rejects_a_malformed_int8_leaf():
    tc = dataclasses.replace(tl.LlamaConfig.tiny(), dtype="float32")
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), dtype="float32")
    tree = _np(jq.quantize_params(jl.init_params(jax.random.PRNGKey(0), jc)))
    assert tq.is_quantized(bridge.params_from_numpy(
        tree, tc, device="cpu")["unembed"])
    tree["unembed"]["int8"] = tree["unembed"]["int8"].astype(np.int16)
    with pytest.raises(ValueError, match="int8 leaf"):
        bridge.params_from_numpy(tree, tc, device="cpu")


def test_quantize_roundtrip_error_bounded_and_draft_params():
    weight = torch.from_numpy(np.random.default_rng(2).normal(
        size=(64, 128)).astype(np.float32))
    leaf = tq.quantize_weight(weight)
    rebuilt = leaf["int8"].float() * leaf["scale"]
    per_channel_max = weight.abs().amax(0)
    assert bool(((rebuilt - weight).abs().amax(0)
                 <= per_channel_max / 254 + 1e-7).all())
    params = tl.init_params(0, tl.LlamaConfig.tiny(), device="cpu")
    draft = tq.draft_params(params)
    assert tq.is_quantized(draft["unembed"])
    assert tq.draft_params(draft) is draft


# -- the attention branches of ops/layers.py --------------------------------

def _kv_case(seed, b=2, t=16, kv=2, h=4, hd=8, s=4):
    rng = np.random.default_rng(seed)
    arrays = dict(q=rng.normal(size=(b, s, h, hd)),
                  k=rng.normal(size=(b, t, kv, hd)),
                  v=rng.normal(size=(b, t, kv, hd)),
                  k_new=rng.normal(size=(b, 1, kv, hd)),
                  v_new=rng.normal(size=(b, 1, kv, hd)))
    arrays = {name: a.astype(np.float32) for name, a in arrays.items()}
    jx = {name: jnp.asarray(a) for name, a in arrays.items()}
    tx = {name: _t(a) for name, a in arrays.items()}
    for side in ("k", "v"):
        jx[side] = jq.quantize_kv(jx[side])
        tx[side] = tq.quantize_kv(tx[side])
    return jx, tx


def test_attention_prefill_int8_matches_jax_and_dequantized():
    """Key scales on the logits and value scales on the weights are exact
    dequantization: the port equals the JAX package and the plain
    attention over the dequantized cache."""
    jx, tx = _kv_case(3)
    positions = np.tile(np.arange(4, 8)[None, :], (2, 1)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        theirs = jlayers.attention_prefill(jx["q"], jx["k"], jx["v"],
                                           jnp.asarray(positions))
    ours = tlayers.attention_prefill(tx["q"], tx["k"], tx["v"],
                                     _t(positions))
    plain = tlayers.attention_prefill(
        tx["q"], tq.dequantize_kv(tx["k"], torch.float32),
        tq.dequantize_kv(tx["v"], torch.float32), _t(positions))
    assert ours.dtype == torch.float32
    _close(ours, theirs, EXACT)
    _close(ours, plain, EXACT)


@pytest.mark.parametrize("lengths", [[5, 9], [0, 16], [16, 1]])
def test_attention_decode_append_int8_matches_jax(lengths):
    """The dense int8 decode path (query and softmax weights quantized,
    integer products exact, exact float denominator) equals the JAX
    package's; it stays within the int8 step of the dequantized path."""
    jx, tx = _kv_case(4)
    with jax.default_matmul_precision("highest"):
        theirs = jlayers.attention_decode_append(
            jx["q"][:, :1], jx["k"], jx["v"], jx["k_new"], jx["v_new"],
            jnp.asarray(lengths, dtype=jnp.int32))
    ours = tlayers.attention_decode_append(
        tx["q"][:, :1], tx["k"], tx["v"], tx["k_new"], tx["v_new"],
        torch.tensor(lengths, dtype=torch.int32))
    _close(ours, theirs)
    plain = tlayers.attention_decode_append(
        tx["q"][:, :1], tq.dequantize_kv(tx["k"], torch.float32),
        tq.dequantize_kv(tx["v"], torch.float32), tx["k_new"], tx["v_new"],
        torch.tensor(lengths, dtype=torch.int32))
    _close(ours, plain, dict(atol=3e-2, rtol=0))


def test_exact_int8_dot_switches_to_float64_past_2_24():
    """Products of codes stay exact integers: float32 while the
    contraction is short, float64 once terms * 127^2 reaches 2^24."""
    codes = torch.full((1, 1, 2000), 127.0)
    short = tlayers._exact_int8_dot("bht,btc->bhc", codes[..., :1000],
                                    torch.full((1, 1000, 1), -127.0),
                                    terms=1000)
    long = tlayers._exact_int8_dot("bht,btc->bhc", codes,
                                   torch.full((1, 2000, 1), 127.0),
                                   terms=2000)
    assert short.dtype == torch.float32 and long.dtype == torch.float64
    assert float(short) == -1000 * 127 * 127
    assert float(long) == 2000 * 127 * 127


def test_dense_int8_diffuse_tail_error_mode():
    """The port's twin of test_flash_decode.py's test of the same name:
    one spike and a tail of 8,191 positions whose weights are each below
    half the int8 step.  The dense int8 path drops the tail from the
    numerator (the documented shrink-only worst case, as in the JAX
    package); the flash path, exact in-kernel dequantization, keeps it."""
    b, t, k, hd = 1, 8192, 1, 16
    q = torch.zeros((b, 1, 1, hd))
    q[..., 0] = hd ** 0.5
    tail_logit = -np.log(260.0)
    k_vals = torch.zeros((b, t, k, hd))
    k_vals[..., 0] = tail_logit
    k_vals[:, 0, :, 0] = 0.0
    v_vals = torch.ones((b, t, k, hd))
    k_new = torch.full((b, 1, k, hd), -1e3)
    v_new = torch.zeros((b, 1, k, hd))
    lengths = torch.tensor([t], dtype=torch.int32)
    exact = tlayers.attention_decode_append(q, k_vals, v_vals, k_new, v_new,
                                            lengths)
    k_q, v_q = tq.quantize_kv(k_vals), tq.quantize_kv(v_vals)
    dense = tlayers.attention_decode_append(q, k_q, v_q, k_new, v_new,
                                            lengths)
    flash = tdec.flash_decode_append(q, k_q, v_q, k_new, v_new, lengths)
    exact_val, dense_val, flash_val = (float(x[0, 0, 0, 0])
                                       for x in (exact, dense, flash))
    assert abs(exact_val - 1.0) < 1e-3
    assert dense_val < 0.2 * exact_val
    assert abs(flash_val - exact_val) < 5e-3
    theirs = jlayers.attention_decode_append(
        jnp.asarray(q.numpy()), jq.quantize_kv(jnp.asarray(k_vals.numpy())),
        jq.quantize_kv(jnp.asarray(v_vals.numpy())),
        jnp.asarray(k_new.numpy()), jnp.asarray(v_new.numpy()),
        jnp.asarray(lengths.numpy()))
    _close(dense, theirs, EXACT)


def test_mixed_quantization_raises():
    jx, tx = _kv_case(5)
    raw = tx["q"][:, :1].new_zeros((2, 16, 2, 8))
    with pytest.raises(ValueError, match="one quantization state"):
        tdec.flash_decode_append(tx["q"][:, :1], tx["k"], raw, tx["k_new"],
                                 tx["v_new"],
                                 torch.tensor([3, 4], dtype=torch.int32))


# -- kernel #5's plain version ----------------------------------------------

def _grid(rng, shape, low, high):
    return rng.integers(low, high + 1, shape).astype(np.float32)


def test_int8_matmul_plain_matches_pallas_on_grid_inputs():
    """The contract of test_kernel_plane.py::test_int8_matmul_matches_xla:
    integer activations and weights, power-of-two scales -- every
    product and sum is exact, so plain version, Pallas kernel and the
    XLA-style reference agree bit for bit (f32 and bf16)."""
    rng = np.random.default_rng(6)
    w = _grid(rng, (96, 200), -127, 127)
    scale = (2.0 ** rng.integers(-8, -2, (1, 200))).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        x = _grid(rng, (8, 96), -3, 3)
        jx = jnp.asarray(x, getattr(jnp, dtype))
        theirs = jax_int8_matmul(jx, jnp.asarray(w, jnp.int8),
                                 jnp.asarray(scale), block_f=128,
                                 block_d=32, interpret=True)
        xla = (jx @ jnp.asarray(w, jnp.int8).astype(jx.dtype)) \
            * jnp.asarray(scale).astype(jx.dtype)
        ours = int8_matmul(_t(x).to(getattr(torch, dtype)),
                           _t(w).to(torch.int8), _t(scale))
        assert ours.dtype == getattr(torch, dtype) and ours.shape == (8, 200)
        np.testing.assert_array_equal(ours.float().numpy(),
                                      np.asarray(theirs, np.float32))
        np.testing.assert_array_equal(ours.float().numpy(),
                                      np.asarray(xla, np.float32))


def test_int8_matmul_plain_matches_pallas_blocked_over_m():
    """Prefill-shaped M: 300 rows against the Pallas kernel blocked over
    M (128-row blocks, a ragged tail), on the quantizer's own leaf."""
    rng = np.random.default_rng(2)
    w = rng.integers(-7, 8, (64, 384)).astype(np.float32)
    leaf = jq.quantize_weight(jnp.asarray(w))
    x = rng.integers(-3, 4, (300, 64)).astype(np.float32)
    theirs = jax_int8_matmul(jnp.asarray(x), leaf["int8"], leaf["scale"],
                             block_m=128, block_f=128, block_d=32,
                             interpret=True)
    ours_leaf = tq.quantize_weight(_t(w))
    ours = int8_matmul(_t(x), ours_leaf["int8"], ours_leaf["scale"])
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_int8_matmul_plain_matches_pallas_on_random_inputs():
    rng = np.random.default_rng(8)
    w = rng.normal(size=(64, 160)).astype(np.float32)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    leaf = tq.quantize_weight(_t(w))
    theirs = jax_int8_matmul(jnp.asarray(x), jnp.asarray(leaf["int8"].numpy()),
                             jnp.asarray(leaf["scale"].numpy()),
                             interpret=True)
    ours = int8_matmul(_t(x), leaf["int8"], leaf["scale"])
    _close(ours, theirs, EXACT)
    assert torch.equal(ours, int8_matmul_reference(_t(x), leaf["int8"],
                                                   leaf["scale"]))


def test_int8_matmul_checks_shapes():
    w = torch.zeros((8, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match=r"\[M, D\] @ \[D, F\]"):
        int8_matmul(torch.zeros(2, 9), w, torch.ones(1, 16))
    with pytest.raises(ValueError, match="one value per column"):
        int8_matmul(torch.zeros(2, 8), w, torch.ones(1, 8))
    with pytest.raises(ValueError, match="int8"):
        int8_matmul(torch.zeros(2, 8), w.float(), torch.ones(1, 16))


# -- the model ----------------------------------------------------------------

def _twins(max_seq=64, quantize=True, kv_dtype="int8", **overrides):
    """JAX and port configs at float32 with the int8 cache, and the same
    (optionally weight-quantized) tree on both sides."""
    settings = dict(dtype="float32", kv_dtype=kv_dtype, **overrides)
    jc = dataclasses.replace(jl.LlamaConfig.tiny(max_seq=max_seq),
                             **settings)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(max_seq=max_seq),
                             **settings)
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    if quantize:
        jp = jq.quantize_params(jp)
    tp = bridge.params_from_numpy(_np(jp), tc, device="cpu")
    return jc, tc, jp, tp


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape) \
        .astype(np.int32)


def _same_cache(ours, theirs):
    for side in ("k", "v"):
        np.testing.assert_array_equal(ours[side]["int8"].numpy(),
                                      np.asarray(theirs[side]["int8"]))
        _close(ours[side]["scale"], theirs[side]["scale"], EXACT)


def test_init_cache_int8_layout_and_bytes():
    """The twin of test_kv_cache_int8_halves_cache_bytes: codes
    [L, B, T, K*hd] int8, scales [L, B, T, K, 1] float32, (hd + 4) /
    (2 * hd) of the bf16 cache's bytes."""
    int8 = dataclasses.replace(tl.LlamaConfig.tiny(), kv_dtype="int8")
    cache = tl.init_cache(int8, 2, 32, device="cpu")
    bf16 = tl.init_cache(tl.LlamaConfig.tiny(), 2, 32, device="cpu")
    theirs = jl.init_cache(dataclasses.replace(jl.LlamaConfig.tiny(),
                                               kv_dtype="int8"), 2, 32)
    for name in ("int8", "scale"):
        assert tuple(cache["k"][name].shape) == theirs["k"][name].shape
    assert cache["k"]["int8"].dtype == torch.int8
    hd = int8.head_dim
    assert cache["k"]["int8"].nbytes + cache["k"]["scale"].nbytes \
        == bf16["k"].nbytes * (hd + 4) / (2 * hd)
    assert tl.cache_extent(cache) == 32
    assert tl.cache_array(cache) is cache["k"]["int8"]


@pytest.mark.parametrize("quantize", [True, False])
def test_prefill_int8_matches_jax(quantize):
    """Whole-batch prefill over an int8 cache, with and without weight
    quantization: logits within 1e-4 and the same cache codes."""
    jc, tc, jp, tp = _twins(quantize=quantize)
    tokens = _tokens((2, 12))
    starts = np.array([0, 5], dtype=np.int32)
    lj, cj = jl.prefill(jp, jc, jnp.asarray(tokens), jl.init_cache(jc, 2),
                        jnp.asarray(starts))
    lt, ct = tl.prefill(tp, tc, _t(tokens).long(),
                        tl.init_cache(tc, 2, device="cpu"), _t(starts))
    _close(lt, lj)
    _same_cache(ct, cj)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_prefill_into_slot_int8_matches_jax(attention):
    """Two chunks into slot 1: the second attends the first through the
    int8 cache row (flash admission dequantizes the row for #4)."""
    jc, tc, jp, tp = _twins(attention=attention)
    cache_j = jl.init_cache(jc, 3)
    cache_t = tl.init_cache(tc, 3, device="cpu")
    for index, start in enumerate((0, 16)):
        chunk = _tokens((1, 16), seed=index)
        lj, cache_j = jl.prefill_into_slot(jp, jc, jnp.asarray(chunk),
                                           cache_j, jnp.int32(1),
                                           jnp.int32(start))
        lt, cache_t = tl.prefill_into_slot(tp, tc, _t(chunk).long(),
                                           cache_t, 1, start)
        _close(lt, lj)
    _same_cache(cache_t, cache_j)
    assert int(cache_t["k"]["int8"][:, 0].abs().max()) == 0


def test_prefill_into_slots_int8_matches_jax():
    jc, tc, jp, tp = _twins()
    tokens = _tokens((4, 8), seed=4)
    tokens[3] = tokens[0]                     # a duplicated bucket row
    slots = np.array([2, 0, 1, 2], dtype=np.int32)
    starts = np.array([0, 8, 3, 0], dtype=np.int32)
    lj, cj = jl.prefill_into_slots(jp, jc, jnp.asarray(tokens),
                                   jl.init_cache(jc, 3), jnp.asarray(slots),
                                   jnp.asarray(starts))
    lt, ct = tl.prefill_into_slots(tp, tc, _t(tokens).long(),
                                   tl.init_cache(tc, 3, device="cpu"),
                                   slots.tolist(), starts.tolist())
    _close(lt, lj)
    _same_cache(ct, cj)


@pytest.mark.parametrize("decode_attention", ["dense", "flash"])
def test_decode_steps_int8_match_jax(decode_attention):
    """Prefill then 6 decode steps on a quantized tree with an int8
    cache, through the dense int8 path and the int8 kernel route: logits
    within 1e-4 each step, the same greedy tokens on the active rows and
    the same cache.  Both sides take the JAX package's tokens: row 2 is
    an inactive row over the trash position, whose random-weight logits
    hold near-ties (1e-7 apart) that either side may break."""
    jc, tc, jp, tp = _twins(decode_attention=decode_attention)
    prompts = _tokens((3, 10), seed=6)
    starts = np.zeros(3, dtype=np.int32)
    lj, cache_j = jl.prefill(jp, jc, jnp.asarray(prompts),
                             jl.init_cache(jc, 3), jnp.asarray(starts))
    lt, cache_t = tl.prefill(tp, tc, _t(prompts).long(),
                             tl.init_cache(tc, 3, device="cpu"), _t(starts))
    tokens = np.array(jnp.argmax(lj[:, -1], -1), dtype=np.int32)
    assert tl.greedy_sample(lt[:, -1]).tolist() == tokens.tolist()
    lengths = np.array([10, 10, 63], dtype=np.int32)  # row 2: trash row
    assert tl._resolve_decode_flash(tc, cache_t) == \
        (decode_attention == "flash")
    launches = tdec.flash_decode_attention_stacked.int8_launches
    for _ in range(6):
        lj, cache_j = jl.decode_step(jp, jc, jnp.asarray(tokens), cache_j,
                                     jnp.asarray(lengths))
        lt, cache_t = tl.decode_step(tp, tc, _t(tokens).long(), cache_t,
                                     _t(lengths))
        _close(lt, lj)
        tokens = np.array(jnp.argmax(lj, -1), dtype=np.int32)
        assert tl.greedy_sample(lt)[:2].tolist() == tokens[:2].tolist()
        lengths[:2] += 1
    _same_cache(cache_t, cache_j)
    # The CPU route runs the plain version and launches nothing.
    assert tdec.flash_decode_attention_stacked.int8_launches == launches


def test_decode_block_int8_matches_jax():
    jc, tc, jp, tp = _twins(decode_attention="flash")
    prompts = _tokens((2, 6), seed=8)
    starts = np.zeros(2, dtype=np.int32)
    _, cache_j = jl.prefill(jp, jc, jnp.asarray(prompts),
                            jl.init_cache(jc, 2), jnp.asarray(starts))
    _, cache_t = tl.prefill(tp, tc, _t(prompts).long(),
                            tl.init_cache(tc, 2, device="cpu"), _t(starts))
    first = np.array([3, 7], dtype=np.int32)
    lengths = np.array([6, 6], dtype=np.int32)
    active = np.array([True, False])
    emitted_j, _, len_j, _, _ = jl.decode_block(
        jp, jc, jnp.asarray(first), cache_j, jnp.asarray(lengths),
        jnp.asarray(active), jnp.zeros(2), jax.random.PRNGKey(0),
        num_steps=5, top_k=4)
    emitted_t, _, len_t, _ = tl.decode_block(
        tp, tc, _t(first), cache_t, _t(lengths), _t(active),
        torch.zeros(2), torch.Generator().manual_seed(0), num_steps=5,
        top_k=4)
    np.testing.assert_array_equal(emitted_t.numpy(), np.asarray(emitted_j))
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))


def test_matmul_kernel_route_equals_plain_route():
    """The twin of test_kernel_plane.py::test_int8_matmul_serves_the_unembed:
    ``matmul_kernel="pallas"`` (kernel #5's route, its plain version on
    the CPU, every int8 leaf) gives the logits of ``"off"`` on the same
    tree, and of the JAX package's reference route."""
    jc, tc, jp, tp = _twins(kv_dtype="bfloat16")
    tokens = _tokens((2, 9), seed=2)
    starts = np.zeros(2, dtype=np.int32)
    outs = {}
    for kernel in ("pallas", "off"):
        cfg = dataclasses.replace(tc, matmul_kernel=kernel)
        outs[kernel], _ = tl.prefill(tp, cfg, _t(tokens).long(),
                                     tl.init_cache(cfg, 2, device="cpu"),
                                     _t(starts))
    theirs, _ = jl.prefill(jp, jc, jnp.asarray(tokens), jl.init_cache(jc, 2),
                           jnp.asarray(starts))
    _close(outs["pallas"], outs["off"], EXACT)
    _close(outs["off"], theirs)


def test_quantized_forward_matches_raw_on_grid_weights():
    """The twin of test_quant.py::test_quantized_forward_matches_on_grid_
    weights: weights on an int8 grid quantize losslessly, so the
    quantized tree's prefill and decode match the raw tree's."""
    config = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=256,
                                                     max_seq=32),
                                 dtype="float32")
    rng = np.random.default_rng(42)
    params = tl.init_params(0, config, device="cpu")

    def align(weight):
        levels = rng.integers(-127, 128, weight.shape)
        levels[..., 0, :] = 127
        scale = rng.uniform(0.5, 2.0, weight.shape[-1:]) / 127.0
        return torch.from_numpy((levels * scale * 0.05).astype(np.float32))
    params["layers"] = {name: align(leaf) if name in tq.QUANTIZED_LAYER_KEYS
                        else leaf for name, leaf in params["layers"].items()}
    params["unembed"] = align(params["unembed"])
    quantized = tq.quantize_params(params)
    tokens = torch.from_numpy(_tokens((2, 9), seed=2) % 256).long()
    starts = torch.zeros(2, dtype=torch.int32)
    raw_logits, raw_cache = tl.prefill(
        params, config, tokens[:, :8], tl.init_cache(config, 2, 32,
                                                     device="cpu"), starts)
    q_logits, q_cache = tl.prefill(
        quantized, config, tokens[:, :8], tl.init_cache(config, 2, 32,
                                                        device="cpu"), starts)
    _close(q_logits, raw_logits, dict(atol=2e-3, rtol=0))
    lengths = torch.full((2,), 8, dtype=torch.int32)
    raw_step, _ = tl.decode_step(params, config, tokens[:, 8], raw_cache,
                                 lengths)
    q_step, _ = tl.decode_step(quantized, config, tokens[:, 8], q_cache,
                               lengths)
    _close(q_step, raw_step, dict(atol=2e-3, rtol=0))


# -- the batcher --------------------------------------------------------------

def _serve(module, params, config, prompts, **kwargs):
    """Drain token-list prompts through one batcher (2 slots, max_seq 64,
    16-token chunks) -> {index: [tokens]}."""
    batcher = module.ContinuousBatcher(params, config, max_slots=2,
                                       max_seq=64, prefill_chunk=16,
                                       **kwargs)
    streams = {}
    for index, prompt in enumerate(prompts):
        streams[index] = []
        batcher.submit(module.Request(
            str(index), list(prompt), max_new_tokens=8,
            emit=lambda rid, token, done, i=index: streams[i].append(token)))
    assert batcher.run_until_drained(max_steps=500) < 500
    return streams


@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("decode_attention", ["auto", "flash"])
def test_int8_streams_match_jax_batcher(decode_block, decode_attention):
    """The twin of test_quant.py::test_batcher_serves_int8_kv_cache with
    greedy streams compared: a quantized tree and an int8 cache, flash
    admission and top-k on, three requests on two slots (one queues, one
    spans two chunks), through the dense int8 path (auto at extent 64)
    and the int8 kernel route.  Both host loops of the port are held to
    the JAX package's synchronous loop: its pipelined loop hands
    ``jnp.asarray`` views of host arrays it mutates after dispatch, which
    on the CPU backend alias the numpy buffers, so under load its
    streams vary from run to run (ROADMAP Queue 3)."""
    jc, tc, jp, tp = _twins(attention="flash",
                            decode_attention=decode_attention)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).tolist() for n in (5, 23, 9)]
    theirs = _serve(jb, jp, jc, prompts, decode_block=1, sample_top_k=4)
    ours = _serve(tb, tp, tc, prompts, device="cpu",
                  decode_block=decode_block, sample_top_k=4)
    assert ours == theirs
    assert all(len(stream) == 8 for stream in ours.values())

