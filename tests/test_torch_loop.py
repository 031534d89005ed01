"""Port parity for the device-resident loop's pieces: the ngram draft and
history window, the chunk-verify attention (plain version against the
JAX Pallas kernel in interpret mode), ``_chunk_verify`` (flash route
against dense route, port against JAX), the amortized draft window and
``decode_loop`` itself, at temperature 0 on tiny float32 configs with
the same weights bridged through ``params_from_numpy``.  Tolerances:
float32 1e-5 on the raw verify attention (summation order), 1e-4 where
int8 scales or a whole model forward add rounding; token ids, counts
and carries exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.models import paged as jpaged
from aiko_services_tpu.models import quant as jq
from aiko_services_tpu.ops import pallas_decode as jdec
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl
from aiko_services_tpu_torch.models import paged as tpaged
from aiko_services_tpu_torch.models import quant as tq
from aiko_services_tpu_torch.ops import flash_decode as tdec

F32 = dict(atol=1e-5, rtol=1e-5)
LOOSE = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(actual, expected, tol):
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64),
                               np.asarray(expected, dtype=np.float64), **tol)


def _twins(vocab=64, max_seq=64, **overrides):
    settings = dict(dtype="float32", **overrides)
    jc = dataclasses.replace(jl.LlamaConfig.tiny(vocab, max_seq), **settings)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(vocab, max_seq), **settings)
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


# -- ngram draft and history window ---------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_draft_and_history_push_match_jax(seed):
    rng = np.random.default_rng(seed)
    b, w, k = 6, 12, 4
    history = rng.integers(-1, 5, (b, w)).astype(np.int32)
    tokens = rng.integers(0, 5, b).astype(np.int32)
    history[:, -1] = tokens                       # newest entry = current
    history[0] = -1                               # an empty window
    ours = tl._ngram_draft(_t(history), _t(tokens), k)
    theirs = jl._ngram_draft(jnp.asarray(history), jnp.asarray(tokens), k)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert ours.dtype == torch.int32
    candidates = rng.integers(0, 9, (b, k + 1)).astype(np.int32)
    cut = rng.integers(0, k + 2, b).astype(np.int32)
    np.testing.assert_array_equal(
        tl._history_push(_t(history), _t(candidates), _t(cut)).numpy(),
        np.asarray(jl._history_push(jnp.asarray(history),
                                    jnp.asarray(candidates),
                                    jnp.asarray(cut))))


# -- chunk-verify attention --------------------------------------------------

def _verify_inputs():
    """The shapes of the JAX package's
    test_kernel_plane.py::test_chunk_verify_kernel_matches_dense: a
    zero-start row, a mid-cache row and a trash-clamped row."""
    rng = np.random.default_rng(6)
    n_layers, b, kv, g, hd, s, t = 2, 3, 2, 2, 16, 5, 128
    starts = np.array([0, 17, t - 1], dtype=np.int32)
    positions = np.minimum(starts[:, None] + np.arange(s)[None, :],
                           t - 1).astype(np.int32)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return dict(n_layers=n_layers, b=b, kv=kv, hd=hd, t=t, starts=starts,
                positions=positions, q=normal(b, s, kv * g, hd),
                k_new=normal(b, s, kv, hd), v_new=normal(b, s, kv, hd),
                normal=normal)


def _verify_both(x, j_views, t_views, layer=1, table=None):
    common = ("k_new", "v_new", "starts", "positions")
    out_j = jdec.flash_verify_append(
        jnp.asarray(x["q"]), *j_views, jnp.int32(layer),
        *(jnp.asarray(x[name]) for name in common),
        page_table=None if table is None else jnp.asarray(table),
        interpret=True)
    out_t = tdec.flash_verify_append(
        _t(x["q"]), *t_views, layer, *(_t(x[name]) for name in common),
        page_table=None if table is None else _t(table))
    return np.asarray(out_j), out_t.numpy()


def test_verify_append_plain_matches_pallas_stacked():
    x = _verify_inputs()
    c = x["kv"] * x["hd"]
    k = x["normal"](x["n_layers"], x["b"], x["t"], c)
    v = x["normal"](x["n_layers"], x["b"], x["t"], c)
    theirs, ours = _verify_both(
        x, ((jnp.asarray(k), None), (jnp.asarray(v), None)),
        ((_t(k), None), (_t(v), None)))
    _close(ours, theirs, F32)


def test_verify_append_plain_matches_pallas_paged():
    x = _verify_inputs()
    c = x["kv"] * x["hd"]
    pages, pt = 13, 32
    pool_k = x["normal"](x["n_layers"], pages, pt, c)
    pool_v = x["normal"](x["n_layers"], pages, pt, c)
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [8, 9, 10, 11]],
                     dtype=np.int32)
    theirs, ours = _verify_both(
        x, ((jnp.asarray(pool_k), None), (jnp.asarray(pool_v), None)),
        ((_t(pool_k), None), (_t(pool_v), None)), table=table)
    _close(ours, theirs, F32)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_append_plain_matches_pallas_int8(paged):
    """int8 caches: the JAX kernel takes [.., K, T] scales, the port the
    [.., T, K] layout they are stored in."""
    x = _verify_inputs()
    kv, hd, n_layers = x["kv"], x["hd"], x["n_layers"]
    lead = (n_layers, 13, 32) if paged else (n_layers, x["b"], x["t"])
    raw_k, raw_v = (x["normal"](*lead, kv, hd) for _ in range(2))
    j_views, t_views = [], []
    for raw in (raw_k, raw_v):
        leaf = jq.quantize_kv(jnp.asarray(raw))
        codes = np.asarray(leaf["int8"]).reshape(*lead, kv * hd)
        scale = np.asarray(leaf["scale"])[..., 0]            # [.., T, K]
        j_views.append((jnp.asarray(codes),
                        jnp.asarray(scale.swapaxes(-1, -2))))
        t_views.append((_t(codes), _t(scale)))
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [8, 9, 10, 11]],
                     dtype=np.int32) if paged else None
    theirs, ours = _verify_both(x, j_views, t_views, table=table)
    _close(ours, theirs, LOOSE)


def test_verify_paged_plain_equals_stacked_on_gathered_view():
    """The paged plain version is the stacked one on the gathered rows,
    bit for bit (the contract the CUDA kernels keep on the card)."""
    x = _verify_inputs()
    c = x["kv"] * x["hd"]
    pool_k = _t(x["normal"](x["n_layers"], 13, 32, c))
    pool_v = _t(x["normal"](x["n_layers"], 13, 32, c))
    table = _t(np.array([[1, 2, 3, 0], [4, 5, 6, 7], [8, 9, 10, 11]],
                        dtype=np.int32))
    q = tdec._prep_query(_t(x["q"]), x["hd"])[0]
    paged = tdec.flash_verify_attention_paged(q, pool_k, pool_v, 1, table,
                                              _t(x["starts"]))
    stacked = tdec.flash_verify_attention_stacked(
        q, *(pool[:, table.long()].reshape(x["n_layers"], 3, 128, c)
             for pool in (pool_k, pool_v)), 1, _t(x["starts"]))
    for got, want in zip(paged, stacked):
        assert torch.equal(got, want)


# -- _chunk_verify --------------------------------------------------------

def _prefilled(jc, tc, jp, tp, prompts, paged=0, b=None):
    """The same prompts prefilled into both packages' caches (one slot
    each, 16-token chunks); paged caches map each slot's pages in order.
    Returns (jax cache, port cache, lengths, first greedy tokens)."""
    b = b or len(prompts)
    if paged:
        jcache = jpaged.init_paged_cache(jc, b, jc.max_seq, paged)
        tcache = tpaged.init_paged_cache(tc, b, tc.max_seq, paged,
                                         device="cpu")
        pps = jc.max_seq // paged
        table = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
        jcache["page_table"] = jnp.asarray(table)
        tcache["page_table"] = _t(table)
    else:
        jcache = jl.init_cache(jc, b)
        tcache = tl.init_cache(tc, b, device="cpu")
    firsts = []
    for slot, prompt in enumerate(prompts):
        chunk = np.zeros((1, 16), dtype=np.int32)
        chunk[0, :len(prompt)] = prompt
        jlogits, jcache = jl.prefill_into_slot(
            jp, jc, jnp.asarray(chunk), jcache, jnp.int32(slot),
            jnp.int32(0))
        tlogits, tcache = tl.prefill_into_slot(tp, tc, _t(chunk).long(),
                                               tcache, slot, 0)
        _close(tlogits[0, len(prompt) - 1].numpy(),
               np.asarray(jlogits)[0, len(prompt) - 1], LOOSE)
        firsts.append(int(np.asarray(jlogits)[0, len(prompt) - 1].argmax()))
    lengths = np.array([len(p) for p in prompts], dtype=np.int32)
    return jcache, tcache, lengths, np.array(firsts, dtype=np.int32)


PROMPTS = ([5, 9, 2, 7, 5, 9], [1, 3, 3, 8, 1, 3, 3, 8, 1, 3, 3],
           [4, 4, 6])


@pytest.mark.parametrize("paged", [0, 8])
def test_chunk_verify_flash_matches_dense_and_jax(paged):
    """_chunk_verify through flash_verify_append (its plain version here)
    against the dense concat route, and the port against the JAX
    package's, on logits and on the written cache."""
    jc, tc, jp, tp = _twins()
    chunk = np.array([[5, 9, 2], [1, 3, 3], [6, 6, 1]], dtype=np.int32)
    starts = np.array([6, 11, 63], dtype=np.int32)    # last: trash row
    trash = jc.max_seq - 1
    out = {}
    for use_flash in (False, True):
        jcache, tcache, _, _ = _prefilled(jc, tc, jp, tp, PROMPTS, paged)
        jlogits, jcache = jl._chunk_verify(jp, jc, jnp.asarray(chunk), jcache,
                                           jnp.asarray(starts), trash,
                                           use_flash=use_flash)
        tlogits, tcache = tl._chunk_verify(tp, tc, _t(chunk), tcache,
                                           _t(starts), trash,
                                           use_flash=use_flash)
        _close(tlogits.numpy(), np.asarray(jlogits), LOOSE)
        for side in ("k", "v"):
            # The trash position takes several clamped writes; the order
            # they land in is the packages' own.
            _close(tcache[side].numpy()[..., :trash, :] if not paged
                   else tcache[side].numpy(),
                   np.asarray(jcache[side])[..., :trash, :] if not paged
                   else np.asarray(jcache[side]), LOOSE)
        out[use_flash] = tlogits.numpy()
    _close(out[True], out[False], LOOSE)


def test_draft_window_matches_jax():
    jc, tc, jp, tp = _twins()
    jdraft, tdraft = jq.draft_params(jp), tq.draft_params(tp)
    jcache, tcache, lengths, firsts = _prefilled(jc, tc, jp, tp, PROMPTS)
    active = np.array([True, True, False])
    theirs = jl._draft_window(jdraft, jc, jnp.asarray(firsts), jcache,
                              jnp.asarray(lengths), jnp.asarray(active), 4,
                              8, jc.max_seq - 1)
    ours = tl._draft_window(tdraft, tc, _t(firsts), tcache, _t(lengths),
                            _t(active), 4, 8, tc.max_seq - 1)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


# -- decode_loop ------------------------------------------------------------

@pytest.mark.parametrize("mode,paged,attention,kv_dtype", [
    ("off", 0, "auto", "bfloat16"), ("off", 8, "auto", "bfloat16"),
    ("ngram", 0, "auto", "bfloat16"), ("ngram", 8, "auto", "bfloat16"),
    ("draft", 0, "auto", "bfloat16"), ("draft", 8, "auto", "bfloat16"),
    ("off", 0, "flash", "bfloat16"), ("ngram", 8, "flash", "bfloat16"),
    ("draft", 0, "flash", "bfloat16"), ("off", 0, "auto", "int8"),
    ("ngram", 8, "flash", "int8")])
def test_decode_loop_matches_jax(mode, paged, attention, kv_dtype):
    """One decode_loop block, port against the JAX package at
    temperature 0: a budget-limited row, a row that stops on EOS and an
    inactive row; every returned carry equal.  ``flash`` takes the
    decode and verify kernels' routes (their plain versions here, the
    Pallas kernels in interpret mode on the JAX side); ``int8`` stores
    the KV cache as int8 codes and scales (the model stays float32)."""
    jc, tc, jp, tp = _twins(decode_attention=attention, kv_dtype=kv_dtype)
    jcache, tcache, lengths, firsts = _prefilled(jc, tc, jp, tp, PROMPTS,
                                                 paged)
    ring, k, window = 12, 3, 8
    active = np.array([True, True, False])
    budget = np.array([5, 40, 0], dtype=np.int32)
    temps = np.zeros(3, dtype=np.float32)
    eos = np.full((3, 2), -1, dtype=np.int32)
    eos[1, 0] = 3
    width = window if mode == "ngram" else 1
    history = np.full((3, width), -1, dtype=np.int32)
    if mode == "ngram":
        for row, prompt in enumerate(PROMPTS):
            tail = (list(prompt) + [int(firsts[row])])[-width:]
            history[row, width - len(tail):] = tail
    draft = (jq.draft_params(jp), tq.draft_params(tp)) \
        if mode == "draft" else (None, None)
    options = dict(ring=ring, speculative=mode, spec_tokens=k,
                   spec_window=window)
    theirs = jl.decode_loop(
        jp, jc, jnp.asarray(firsts), jcache, jnp.asarray(lengths),
        jnp.asarray(active), jnp.asarray(budget), jnp.asarray(temps),
        jnp.asarray(eos), jnp.asarray(history), jax.random.PRNGKey(0),
        draft=draft[0], **options)
    ours = tl.decode_loop(
        tp, tc, _t(firsts), tcache, _t(lengths), _t(active), _t(budget),
        _t(temps), _t(eos), _t(history), torch.Generator().manual_seed(0),
        draft=draft[1], **options)
    names = ("emitted", "counts", "tokens", "lengths", "active", "budget",
             "history", None, "accepted", "drafted", "steps")
    got = {name: value.numpy() for name, value in zip(names, ours) if name}
    want = {name: np.asarray(value) for name, value in zip(names, theirs)
            if name}
    for row, count in enumerate(want["counts"]):
        np.testing.assert_array_equal(got["emitted"][row, :count],
                                      want["emitted"][row, :count])
    for name in names[1:]:
        if name:
            np.testing.assert_array_equal(got[name], want[name], name)
    assert want["counts"][0] == 5 and want["counts"][2] == 0
    if mode != "off":
        assert want["drafted"].sum() > 0


def test_decode_loop_rejects_unknown_mode():
    _, tc, _, tp = _twins()
    cache = tl.init_cache(tc, 1, device="cpu")
    zeros = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="off|ngram|draft"):
        tl.decode_loop(tp, tc, zeros, cache, zeros, zeros.bool(), zeros,
                       zeros.float(), zeros[:, None], zeros[:, None],
                       torch.Generator(), ring=4, speculative="banana")
