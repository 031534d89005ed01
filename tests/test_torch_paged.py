"""Port parity for paged KV serving: ``models/paged.py`` (page pools,
gather/scatter, ``PageAllocator`` with the shared-prefix index), the
paged paths of ``models/llama.py`` and the batcher's paged bookkeeping,
against the JAX package on the same seeded inputs.  Model and batcher
run at float32 on ``LlamaConfig.tiny`` (logits within 1e-4, greedy
streams token-identical at temperature 0), over bf16-layout pools and
over int8 pools with a weight-quantized tree; the allocator twins run
the same operation sequence on both packages and compare every
observable."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import batching as jb
from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.models import paged as jpaged
from aiko_services_tpu.models import quant as jq
from aiko_services_tpu_torch.models import batching as tb
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl
from aiko_services_tpu_torch.models import paged as tpaged
from aiko_services_tpu_torch.models import quant as tq
from aiko_services_tpu_torch.ops import flash_decode as tdec

TOL = dict(atol=1e-4, rtol=1e-4)


def _close(actual, expected):
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64),
                               np.asarray(expected, dtype=np.float64), **TOL)


def _twins(vocab=512, max_seq=64, **overrides):
    settings = dict(dtype="float32", **overrides)
    jc = dataclasses.replace(jl.LlamaConfig.tiny(vocab, max_seq), **settings)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(vocab, max_seq), **settings)
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a), jp), tc,
        device="cpu")
    return jc, tc, jp, tp


def _tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


# -- the allocator ----------------------------------------------------------

def _observe(alloc):
    return (alloc.free_pages, dict(alloc.dirty), alloc.stats,
            alloc.leaked_pages(),
            [alloc.holds(slot) for slot in range(alloc.max_slots)])


def _replay(ops, **kwargs):
    """Run ``ops`` (method name, args) on both allocators and compare
    every return value and every observable after each step."""
    ours = tpaged.PageAllocator(**kwargs)
    theirs = jpaged.PageAllocator(**kwargs)
    for name, args in ops:
        if name == "clear_dirty":
            ours.dirty.clear()
            theirs.dirty.clear()
            continue
        assert getattr(ours, name)(*args) == getattr(theirs, name)(*args), \
            (name, args)
        assert _observe(ours) == _observe(theirs), (name, args)
    return ours


def test_page_allocator_matches_jax():
    """The operation sequence of the JAX package's
    test_page_allocator_units, on both allocators."""
    ours = _replay([
        ("pages_for", (0, 16)), ("pages_for", (17, 16)),
        ("pages_for", (10_000, 16)), ("ensure", (0, 2)), ("ensure", (0, 2)),
        ("missing", (0, 4)), ("ensure", (1, 4)), ("ensure", (2, 2)),
        ("clear_dirty", ()), ("ensure", (0, 4)), ("release", (1,)),
        ("ensure", (0, 4)), ("release", (0,)), ("reset", ())],
        total_pages=9, pages_per_slot=4, max_slots=3)
    assert ours.free_pages == 8 and ours.leaked_pages() == 0


def test_prefix_page_allocator_matches_jax():
    """The operation sequence of the JAX package's
    test_prefix_page_allocator_units: hash-chain agreement, the match
    capped one page short, adoption refcounts, release keeping indexed
    pages warm, leaf-first reclaim under pressure."""
    tokens = list(range(40))
    divergent = tokens[:16] + [999] * 24
    for seq, limit in ((tokens, None), (tokens[:32], None), (divergent, 1)):
        assert tpaged.prefix_page_keys(seq, 16, limit) \
            == jpaged.prefix_page_keys(seq, 16, limit)
    ours = _replay([
        ("match_prefix", (tokens, 16)), ("ensure", (0, 3)),
        ("register_prefix", (0, tokens, 40, 16)),
        ("match_prefix", (tokens, 16)), ("match_prefix", (tokens[:33], 16)),
        ("match_prefix", (tokens[:32], 16)),
        ("match_prefix", (divergent, 16)), ("match_prefix", (tokens[:8], 16)),
        ("adopt_prefix", (1, tokens, 16)), ("release", (0,)),
        ("match_prefix", (tokens, 16)), ("release", (1,)),
        ("match_prefix", (tokens, 16)), ("ensure", (2, 4)),
        ("ensure", (0, 4)), ("match_prefix", (tokens, 16)), ("reset", ())],
        total_pages=9, pages_per_slot=4, max_slots=3, prefix_cache=True,
        prefix_min_tokens=16)
    assert ours.free_pages == 8 and ours.prefix_hits == 2


def test_pages_per_slot_and_pool_checks():
    assert tpaged.pages_per_slot(64, 16) == jpaged.pages_per_slot(64, 16)
    for module in (tpaged, jpaged):
        with pytest.raises(ValueError, match="must divide"):
            module.pages_per_slot(64, 24)
    _, tc = _twins()[:2]
    with pytest.raises(ValueError, match="at least one full slot"):
        tpaged.init_paged_cache(tc, 2, 64, page_tokens=16, total_pages=4,
                                device="cpu")
    cache = tpaged.init_paged_cache(tc, 2, 64, page_tokens=16,
                                    device="cpu")
    assert cache["k"].shape == (tc.n_layers, 9, 16, 2 * tc.head_dim)
    assert cache["page_table"].dtype == torch.int32
    assert tpaged.paged_extent(cache) == 64


def test_scatter_and_gather_pages():
    """scatter_pages writes whole pages through the table in place
    (duplicated bucket rows idempotent); gather_layer and gather_slot
    read the logical rows back as the JAX package's do."""
    rng = np.random.default_rng(1)
    pool = np.zeros((9, 4, 6), dtype=np.float32)
    table = np.array([[3, 1, 0, 0], [2, 5, 6, 0]], dtype=np.int32)
    new = rng.normal(size=(3, 8, 6)).astype(np.float32)
    new[2] = new[0]
    ours = tpaged.scatter_pages(torch.from_numpy(pool.copy()),
                                torch.from_numpy(new),
                                torch.from_numpy(table), [1, 0, 1],
                                [4, 0, 4], 4)
    theirs = jpaged.scatter_pages(jnp.asarray(pool), jnp.asarray(new),
                                  jnp.asarray(table), [1, 0, 1], [4, 0, 4],
                                  4)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(
        tpaged.gather_layer(ours, torch.from_numpy(table)).numpy(),
        np.asarray(jpaged.gather_layer(theirs, jnp.asarray(table))))
    np.testing.assert_array_equal(
        tpaged.gather_slot(ours, torch.from_numpy(table[1])).numpy(),
        np.asarray(jpaged.gather_slot(theirs, jnp.asarray(table[1]))))


# -- the model --------------------------------------------------------------

def _paged_pair(jc, tc, batch, max_seq, page_tokens, rows):
    """A JAX and a port paged cache with the same table ``rows``
    ({slot: [physical pages]})."""
    cache_j = jpaged.init_paged_cache(jc, batch, max_seq, page_tokens)
    cache_t = tpaged.init_paged_cache(tc, batch, max_seq, page_tokens,
                                      device="cpu")
    table = np.zeros((batch, max_seq // page_tokens), dtype=np.int32)
    for slot, pages in rows.items():
        table[slot, :len(pages)] = pages
    cache_j["page_table"] = jnp.asarray(table)
    cache_t["page_table"] = torch.from_numpy(table.copy())
    return cache_j, cache_t


def _gathered_row(cache, side, slot):
    return np.stack([np.asarray(tpaged.gather_slot(
        layer, cache["page_table"][slot])[0]) for layer in cache[side]])


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_paged_prefill_into_slot_matches(attention):
    """Two chunks through a scattered page table: logits equal the JAX
    package's paged prefill and the port's dense prefill, and the
    gathered cache bytes equal the dense cache row (the twin of
    test_paged_prefill_matches_dense)."""
    jc, tc, jp, tp = _twins(attention=attention)
    cache_j, cache_t = _paged_pair(jc, tc, 2, 64, 8, {1: [7, 2, 5, 1]})
    dense = tl.init_cache(tc, 2, 64, device="cpu")
    for index, start in enumerate((0, 16)):
        chunk = _tokens((1, 16), seed=index)
        lj, cache_j = jl.prefill_into_slot(jp, jc, jnp.asarray(chunk),
                                           cache_j, jnp.int32(1),
                                           jnp.int32(start))
        lt, cache_t = tl.prefill_into_slot(tp, tc,
                                           torch.from_numpy(chunk).long(),
                                           cache_t, 1, start)
        ld, dense = tl.prefill_into_slot(tp, tc,
                                         torch.from_numpy(chunk).long(),
                                         dense, 1, start)
        _close(lt, lj)
        assert torch.equal(lt, ld)
    for side in ("k", "v"):
        row = _gathered_row(cache_t, side, 1)[:, :32]
        np.testing.assert_array_equal(row, dense[side][:, 1, :32].numpy())
        _close(row, np.stack([np.asarray(jpaged.gather_slot(
            layer, cache_j["page_table"][1])[0])[:32]
            for layer in cache_j[side]]))


def test_paged_prefill_into_slots_matches():
    jc, tc, jp, tp = _twins()
    cache_j, cache_t = _paged_pair(jc, tc, 3, 64, 8,
                                   {0: [9, 10, 11], 1: [3, 4], 2: [1, 2]})
    tokens = _tokens((4, 8), seed=4)
    tokens[3] = tokens[0]                     # a duplicated bucket row
    slots = np.array([2, 0, 1, 2], dtype=np.int32)
    starts = np.array([0, 16, 8, 0], dtype=np.int32)
    lj, cache_j = jl.prefill_into_slots(jp, jc, jnp.asarray(tokens), cache_j,
                                        jnp.asarray(slots),
                                        jnp.asarray(starts))
    lt, cache_t = tl.prefill_into_slots(tp, tc,
                                        torch.from_numpy(tokens).long(),
                                        cache_t, slots.tolist(),
                                        starts.tolist())
    _close(lt, lj)
    _close(cache_t["k"], cache_j["k"])
    _close(cache_t["v"], cache_j["v"])


def test_paged_prefill_checks():
    _, tc, _, tp = _twins()
    cache = tpaged.init_paged_cache(tc, 2, 64, 16, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="whole number"):
        tl.prefill_into_slot(tp, tc, tokens, cache, 0, 0)
    with pytest.raises(ValueError, match="dense caches"):
        tl.prefill(tp, tc, tokens, cache, torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("decode_attention", ["dense", "flash"])
def test_paged_decode_steps_match(decode_attention):
    """Paged prefill then 6 greedy decode steps on both packages through
    the reference gather (``dense``) and the page-table-walking kernel
    route (``flash``): logits within 1e-4 each step, identical greedy
    tokens, and the kernel route equal to the port's reference route.
    Row 2 is an inactive row writing the trash position T-1 through an
    all-trash table row."""
    jc, tc, jp, tp = _twins(decode_attention=decode_attention)
    rows = {0: [1, 2, 3, 4], 1: [8, 5, 6, 7]}
    cache_j, cache_t = _paged_pair(jc, tc, 3, 64, 16, rows)
    ref_config = dataclasses.replace(tc, decode_attention="dense")
    cache_r = {name: value.clone() for name, value in cache_t.items()}
    prompts = _tokens((2, 16), seed=6)
    for slot in range(2):
        chunk = prompts[slot:slot + 1]
        _, cache_j = jl.prefill_into_slot(jp, jc, jnp.asarray(chunk),
                                          cache_j, jnp.int32(slot),
                                          jnp.int32(0))
        _, cache_t = tl.prefill_into_slot(tp, tc,
                                          torch.from_numpy(chunk).long(),
                                          cache_t, slot, 0)
        _, cache_r = tl.prefill_into_slot(tp, ref_config,
                                          torch.from_numpy(chunk).long(),
                                          cache_r, slot, 0)
    tokens = np.array([3, 9, 0], dtype=np.int32)
    lengths = np.array([16, 16, 63], dtype=np.int32)
    assert tl._resolve_decode_flash(tc, cache_t) == \
        (decode_attention == "flash")
    launches = tdec.flash_decode_attention_paged.launches
    for _ in range(6):
        lj, cache_j = jl.decode_step(jp, jc, jnp.asarray(tokens), cache_j,
                                     jnp.asarray(lengths))
        lt, cache_t = tl.decode_step(tp, tc, torch.from_numpy(tokens).long(),
                                     cache_t, torch.from_numpy(lengths))
        lr, cache_r = tl.decode_step(tp, ref_config,
                                     torch.from_numpy(tokens).long(),
                                     cache_r, torch.from_numpy(lengths))
        _close(lt, lj)
        _close(lt, lr)
        tokens = np.asarray(tl.greedy_sample(lt), dtype=np.int32)
        assert tokens.tolist() == np.asarray(jnp.argmax(lj, -1)).tolist()
        lengths[:2] += 1
    # The CPU route runs the plain version and launches nothing.
    assert tdec.flash_decode_attention_paged.launches == launches
    for side in ("k", "v"):
        _close(_gathered_row(cache_t, side, 0)[:, :22],
               np.stack([np.asarray(jpaged.gather_slot(
                   layer, cache_j["page_table"][0])[0])[:22]
                   for layer in cache_j[side]]))


def test_paged_decode_block_matches_jax():
    """decode_block over a paged cache: inactive rows write position T-1
    through their table row, and the emitted greedy tokens equal the
    JAX package's."""
    jc, tc, jp, tp = _twins(decode_attention="flash")
    cache_j, cache_t = _paged_pair(jc, tc, 2, 64, 16, {0: [3, 1, 2]})
    prompt = _tokens((1, 16), seed=8)
    _, cache_j = jl.prefill_into_slot(jp, jc, jnp.asarray(prompt), cache_j,
                                      jnp.int32(0), jnp.int32(0))
    _, cache_t = tl.prefill_into_slot(tp, tc, torch.from_numpy(prompt).long(),
                                      cache_t, 0, 0)
    first = np.array([3, 7], dtype=np.int32)
    lengths = np.array([16, 0], dtype=np.int32)
    active = np.array([True, False])
    emitted_j, _, len_j, _, _ = jl.decode_block(
        jp, jc, jnp.asarray(first), cache_j, jnp.asarray(lengths),
        jnp.asarray(active), jnp.zeros(2), jax.random.PRNGKey(0),
        num_steps=5, top_k=4)
    emitted_t, _, len_t, _ = tl.decode_block(
        tp, tc, torch.from_numpy(first), cache_t, torch.from_numpy(lengths),
        torch.from_numpy(active), torch.zeros(2),
        torch.Generator().manual_seed(0), num_steps=5, top_k=4)
    np.testing.assert_array_equal(emitted_t.numpy()[:, 0],
                                  np.asarray(emitted_j)[:, 0])
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))


# -- the batcher ------------------------------------------------------------

def _serve(module, params, config, prompts, max_new=24, serial_first=False,
           **kwargs):
    """Drain token-list prompts through one batcher (4 slots, max_seq
    64, 16-token chunks) -> ({index: [tokens]}, batcher)."""
    settings = dict(max_slots=4, max_seq=64, prefill_chunk=16)
    settings.update(kwargs)
    batcher = module.ContinuousBatcher(params, config, **settings)
    streams = {}
    for index, prompt in enumerate(prompts):
        streams[index] = []
        batcher.submit(module.Request(
            str(index), list(prompt), max_new_tokens=max_new,
            emit=lambda rid, token, done, i=index: streams[i].append(token)))
        if serial_first and index == 0:
            assert batcher.run_until_drained(max_steps=3000) < 3000
    assert batcher.run_until_drained(max_steps=3000) < 3000
    return streams, batcher


def _prompts(lengths=(11, 10, 12, 9), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).tolist() for n in lengths]


@pytest.fixture(scope="module")
def flash_twins():
    return _twins(attention="flash", decode_attention="flash")


@pytest.mark.parametrize("decode_block", [1, 4])
def test_paged_streams_match_jax_batcher(flash_twins, decode_block):
    """Full provisioning: the paged port batcher emits the JAX paged
    batcher's streams and the dense port batcher's, and returns every
    page once drained."""
    jc, tc, jp, tp = flash_twins
    prompts = _prompts()
    theirs, _ = _serve(jb, jp, jc, prompts, decode_block=decode_block,
                       kv_page_tokens=16)
    ours, batcher = _serve(tb, tp, tc, prompts, decode_block=decode_block,
                           kv_page_tokens=16, device="cpu")
    dense, _ = _serve(tb, tp, tc, prompts, decode_block=decode_block,
                      device="cpu")
    assert ours == theirs == dense
    assert batcher.evictions == 0 and batcher._pages.leaked_pages() == 0
    assert batcher._pages.free_pages == batcher._pages.total - 1
    # Every row is back on the trash page, on the device or in the dirty
    # rows that the next sync uploads.
    table = batcher.cache["page_table"].numpy().copy()
    for slot, row in batcher._pages.dirty.items():
        table[slot] = row
    assert not table.any()


@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("kv_pages", [9, 5])
def test_pool_pressure_streams_match_jax_batcher(flash_twins, decode_block,
                                                 kv_pages):
    """An under-provisioned pool (the kv_pages of the JAX package's
    test_pool_pressure_preempts_youngest_and_resumes and
    test_pressure_eviction_during_sync_decode_tick) preempts the youngest
    slot; every request still emits the JAX batcher's stream and the
    unpaged stream, on both host loops, with no page leaked."""
    jc, tc, jp, tp = flash_twins
    prompts = _prompts()
    reference, _ = _serve(tb, tp, tc, prompts, decode_block=decode_block,
                          device="cpu")
    theirs, _ = _serve(jb, jp, jc, prompts, decode_block=decode_block,
                       kv_page_tokens=16, kv_pages=kv_pages)
    ours, batcher = _serve(tb, tp, tc, prompts, decode_block=decode_block,
                           kv_page_tokens=16, kv_pages=kv_pages,
                           device="cpu")
    assert ours == theirs == reference
    assert batcher.evictions >= 1
    assert batcher._pages.leaked_pages() == 0
    assert all(len(stream) == 24 for stream in ours.values())


@pytest.mark.parametrize("decode_block", [1, 4])
def test_prompt_ending_in_last_page(flash_twins, decode_block):
    """A prompt that reaches the last page: while it prefills, its row
    flows through decode as an inactive row writing position T-1, which
    maps into its own last page (the JAX package's trash routing); its
    stream and its neighbour's equal the JAX batcher's."""
    jc, tc, jp, tp = flash_twins
    prompts = _prompts((9, 52), seed=3)
    theirs, _ = _serve(jb, jp, jc, prompts, max_new=8,
                       decode_block=decode_block, kv_page_tokens=16)
    ours, batcher = _serve(tb, tp, tc, prompts, max_new=8,
                           decode_block=decode_block, kv_page_tokens=16,
                           device="cpu")
    assert ours == theirs
    assert batcher._pages.leaked_pages() == 0


_SHARED_PREFIX = [3 + (i % 40) for i in range(32)]     # 2 whole pages


@pytest.mark.parametrize("decode_block", [1, 4])
def test_prefix_cache_warm_matches_cold(flash_twins, decode_block):
    """The twin of the JAX package's test_prefix_cache_warm_matches_cold:
    requests admitted onto shared prefix pages emit the streams of an
    unshared cold prefill (and of the JAX warm run), the index records
    the hits, and no page leaks."""
    jc, tc, jp, tp = flash_twins
    prompts = [_SHARED_PREFIX + [100 + i, 50 + i, 7, 11 + i, 2, 9, 4, 1]
               for i in range(3)]
    shared = dict(max_new=8, serial_first=True, decode_block=decode_block,
                  kv_page_tokens=16, prefix_min_tokens=16)
    cold, cold_b = _serve(tb, tp, tc, prompts, prefix_cache=False,
                          device="cpu", **shared)
    warm, warm_b = _serve(tb, tp, tc, prompts, prefix_cache=True,
                          device="cpu", **shared)
    theirs, theirs_b = _serve(jb, jp, jc, prompts, prefix_cache=True,
                              **shared)
    assert cold == warm == theirs
    assert warm_b.prefix_hits == theirs_b.prefix_hits == 4
    assert warm_b.prefix_lookups == theirs_b.prefix_lookups
    assert warm_b.prefix_shared_tokens == 64
    assert warm_b.prefix_hit_rate() == theirs_b.prefix_hit_rate() > 0
    assert cold_b.prefix_hits == 0
    assert warm_b._pages.leaked_pages() == cold_b._pages.leaked_pages() == 0
    warm_b.reset_prefix_stats()
    assert warm_b.prefix_hits == warm_b.prefix_lookups == 0


def test_prefix_divergence_cow_leaves_donor_untouched(flash_twins):
    """Copy-on-write at the divergent page: the adopter maps the donor's
    shared pages physically, takes a fresh page where the prompts
    diverge, and the donor's bytes over the shared span stay bit-equal
    while both generate; the adopter's stream equals an unshared run."""
    _, tc, _, tp = flash_twins
    prompt_a = _SHARED_PREFIX + [100 + i for i in range(8)]
    prompt_b = _SHARED_PREFIX + [70 + i for i in range(8)]
    streams = {"A": [], "B": []}
    batcher = tb.ContinuousBatcher(tp, tc, max_slots=3, max_seq=64,
                                   prefill_chunk=16, decode_block=4,
                                   inflight=1, kv_page_tokens=16,
                                   prefix_cache=True, prefix_min_tokens=16,
                                   device="cpu")

    def request(rid, prompt, budget):
        return tb.Request(rid, list(prompt), max_new_tokens=budget,
                          emit=lambda r, token, done: streams[r].append(
                              token))
    batcher.submit(request("A", prompt_a, 20))
    while len(streams["A"]) < 4:
        batcher.step()
    slot_a = next(i for i, r in enumerate(batcher.slots)
                  if r is not None and r.request_id == "A")

    def donor_bytes():
        return [_gathered_row(batcher.cache, side, slot_a)[:, :32]
                for side in ("k", "v")]
    before = donor_bytes()
    batcher.submit(request("B", prompt_b, 6))
    slot_b = None
    while slot_b is None:
        batcher.step()
        slot_b = next((i for i, r in enumerate(batcher.slots)
                       if r is not None and r.request_id == "B"), None)
    table = batcher.cache["page_table"].numpy()
    np.testing.assert_array_equal(table[slot_a][:2], table[slot_b][:2])
    assert table[slot_b][2] not in (0, table[slot_a][2])
    while len(streams["B"]) < 6:
        batcher.step()
    assert batcher.slots[slot_a].request_id == "A"
    for old, new in zip(before, donor_bytes()):
        np.testing.assert_array_equal(old, new)
    assert batcher.run_until_drained(max_steps=2000) < 2000
    cold, _ = _serve(tb, tp, tc, [prompt_a, prompt_b], max_new=6,
                     max_slots=3, decode_block=4, inflight=1,
                     kv_page_tokens=16, device="cpu")
    assert streams["B"] == cold[1]
    assert batcher._pages.leaked_pages() == 0


def test_paged_batcher_option_checks(flash_twins):
    _, tc, _, tp = flash_twins
    with pytest.raises(ValueError, match="prefix_cache"):
        tb.ContinuousBatcher(tp, tc, max_seq=64, prefix_cache="on",
                             device="cpu")
    with pytest.raises(ValueError, match="must divide prefill_chunk"):
        tb.ContinuousBatcher(tp, tc, max_seq=64, prefill_chunk=24,
                             kv_page_tokens=16, device="cpu")
    with pytest.raises(ValueError, match="must divide max_seq"):
        tb.ContinuousBatcher(tp, tc, max_seq=64, prefill_chunk=48,
                             kv_page_tokens=48, device="cpu")
    unpaged = tb.ContinuousBatcher(tp, tc, max_seq=64, device="cpu")
    assert unpaged.prefix_hits == unpaged.prefix_lookups == 0
    assert unpaged.prefix_hit_rate() == 0.0


# -- int8 pools ---------------------------------------------------------------

def _int8_twins(**overrides):
    """The tiny twins with ``kv_dtype="int8"`` and the JAX package's
    weight-quantized tree on both sides."""
    settings = dict(dtype="float32", kv_dtype="int8", **overrides)
    jc = dataclasses.replace(jl.LlamaConfig.tiny(512, 64), **settings)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(512, 64), **settings)
    jp = jq.quantize_params(jl.init_params(jax.random.PRNGKey(0), jc))
    tp = bridge.params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a), jp), tc,
        device="cpu")
    return jc, tc, jp, tp


def test_int8_pools_layout_scatter_and_gather():
    """init_paged_cache's int8 pools have the JAX package's layout; the
    codes and the scales go through scatter_pages, gather_layer and
    gather_slot as the JAX package's do."""
    jc, tc, _, _ = _int8_twins()
    ours = tpaged.init_paged_cache(tc, 2, 64, page_tokens=16, device="cpu")
    theirs = jpaged.init_paged_cache(jc, 2, 64, page_tokens=16)
    for name in ("int8", "scale"):
        assert tuple(ours["k"][name].shape) == theirs["k"][name].shape
        assert str(ours["k"][name].dtype).split(".")[-1] \
            == str(theirs["k"][name].dtype)
    assert tpaged.pool_page_tokens(ours) == 16
    assert tpaged.paged_extent(ours) == 64
    rng = np.random.default_rng(2)
    raw = rng.normal(size=(3, 8, 2, 16)).astype(np.float32)
    raw[2] = raw[0]
    new_t = tq.quantize_kv(torch.from_numpy(raw))
    new_t = {"int8": new_t["int8"].reshape(3, 8, 32),
             "scale": new_t["scale"]}
    new_j = jq.quantize_kv(jnp.asarray(raw))
    table = np.array([[3, 1, 0, 0], [2, 5, 6, 0]], dtype=np.int32)
    pool_t = {"int8": torch.zeros((9, 4, 32), dtype=torch.int8),
              "scale": torch.zeros((9, 4, 2, 1))}
    tpaged.scatter_pages(pool_t, new_t, torch.from_numpy(table), [1, 0, 1],
                         [4, 0, 4], 4)
    pool_j = {"int8": jpaged.scatter_pages(
        jnp.zeros((9, 4, 32), jnp.int8), new_j["int8"].reshape(3, 8, 32),
        jnp.asarray(table), [1, 0, 1], [4, 0, 4], 4),
        "scale": jpaged.scatter_pages(
            jnp.zeros((9, 4, 2, 1)), new_j["scale"], jnp.asarray(table),
            [1, 0, 1], [4, 0, 4], 4)}
    for ours_view, theirs_view in (
            (tpaged.gather_layer(pool_t, torch.from_numpy(table)),
             jpaged.gather_layer(pool_j, jnp.asarray(table))),
            (tpaged.gather_slot(pool_t, torch.from_numpy(table[1])),
             jpaged.gather_slot(pool_j, jnp.asarray(table[1])))):
        for name in ("int8", "scale"):
            np.testing.assert_array_equal(ours_view[name].numpy(),
                                          np.asarray(theirs_view[name]))


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_int8_paged_prefill_into_slot_matches(attention):
    """Two chunks through a scattered page table into int8 pools: logits
    equal the JAX package's and the port's dense int8 cache, and the
    gathered codes equal the dense cache row."""
    jc, tc, jp, tp = _int8_twins(attention=attention)
    cache_j, cache_t = _paged_pair(jc, tc, 2, 64, 8, {1: [7, 2, 5, 1]})
    dense = tl.init_cache(tc, 2, 64, device="cpu")
    for index, start in enumerate((0, 16)):
        chunk = _tokens((1, 16), seed=index)
        lj, cache_j = jl.prefill_into_slot(jp, jc, jnp.asarray(chunk),
                                           cache_j, jnp.int32(1),
                                           jnp.int32(start))
        lt, cache_t = tl.prefill_into_slot(tp, tc,
                                           torch.from_numpy(chunk).long(),
                                           cache_t, 1, start)
        ld, dense = tl.prefill_into_slot(tp, tc,
                                         torch.from_numpy(chunk).long(),
                                         dense, 1, start)
        _close(lt, lj)
        assert torch.equal(lt, ld)
    for side in ("k", "v"):
        for name in ("int8", "scale"):
            pool = {"k": cache_t["k"][name], "v": cache_t["v"][name],
                    "page_table": cache_t["page_table"]}
            np.testing.assert_array_equal(
                _gathered_row(pool, side, 1)[:, :32],
                dense[side][name][:, 1, :32].numpy())


@pytest.mark.parametrize("decode_attention", ["dense", "flash"])
def test_int8_paged_decode_steps_match(decode_attention):
    """Paged int8 prefill then 6 decode steps through the gathered dense
    int8 path and the int8 paged kernel route: logits within 1e-4 of the
    JAX package's and equal to the port's dense int8 cache."""
    jc, tc, jp, tp = _int8_twins(decode_attention=decode_attention)
    rows = {0: [1, 2, 3, 4], 1: [8, 5, 6, 7]}
    cache_j, cache_t = _paged_pair(jc, tc, 3, 64, 16, rows)
    dense = tl.init_cache(tc, 3, 64, device="cpu")
    prompts = _tokens((2, 16), seed=6)
    for slot in range(2):
        chunk = prompts[slot:slot + 1]
        _, cache_j = jl.prefill_into_slot(jp, jc, jnp.asarray(chunk),
                                          cache_j, jnp.int32(slot),
                                          jnp.int32(0))
        _, cache_t = tl.prefill_into_slot(tp, tc,
                                          torch.from_numpy(chunk).long(),
                                          cache_t, slot, 0)
        _, dense = tl.prefill_into_slot(tp, tc,
                                        torch.from_numpy(chunk).long(),
                                        dense, slot, 0)
    tokens = np.array([3, 9, 0], dtype=np.int32)
    lengths = np.array([16, 16, 63], dtype=np.int32)
    launches = tdec.flash_decode_attention_paged.int8_launches
    for _ in range(6):
        lj, cache_j = jl.decode_step(jp, jc, jnp.asarray(tokens), cache_j,
                                     jnp.asarray(lengths))
        lt, cache_t = tl.decode_step(tp, tc, torch.from_numpy(tokens).long(),
                                     cache_t, torch.from_numpy(lengths))
        ld, dense = tl.decode_step(tp, tc, torch.from_numpy(tokens).long(),
                                   dense, torch.from_numpy(lengths))
        _close(lt, lj)
        _close(lt[:2], ld[:2])
        tokens = np.array(jnp.argmax(lj, -1), dtype=np.int32)
        assert tl.greedy_sample(lt)[:2].tolist() == tokens[:2].tolist()
        lengths[:2] += 1
    assert tdec.flash_decode_attention_paged.int8_launches == launches


def test_int8_paged_prefill_into_slots_matches():
    """Batched admission into int8 pools (a duplicated bucket row
    included): logits and the pools' codes and scales equal the JAX
    package's."""
    jc, tc, jp, tp = _int8_twins()
    cache_j, cache_t = _paged_pair(jc, tc, 3, 64, 8,
                                   {0: [9, 10, 11], 1: [3, 4], 2: [1, 2]})
    tokens = _tokens((4, 8), seed=4)
    tokens[3] = tokens[0]
    slots = np.array([2, 0, 1, 2], dtype=np.int32)
    starts = np.array([0, 16, 8, 0], dtype=np.int32)
    lj, cache_j = jl.prefill_into_slots(jp, jc, jnp.asarray(tokens), cache_j,
                                        jnp.asarray(slots),
                                        jnp.asarray(starts))
    lt, cache_t = tl.prefill_into_slots(tp, tc,
                                        torch.from_numpy(tokens).long(),
                                        cache_t, slots.tolist(),
                                        starts.tolist())
    _close(lt, lj)
    for side in ("k", "v"):
        np.testing.assert_array_equal(cache_t[side]["int8"].numpy(),
                                      np.asarray(cache_j[side]["int8"]))
        _close(cache_t[side]["scale"], cache_j[side]["scale"])


def test_int8_paged_decode_block_matches_jax():
    """decode_block over int8 pools on the int8 paged kernel route: the
    emitted greedy tokens and lengths equal the JAX package's."""
    jc, tc, jp, tp = _int8_twins(decode_attention="flash")
    cache_j, cache_t = _paged_pair(jc, tc, 2, 64, 16, {0: [3, 1, 2]})
    prompt = _tokens((1, 16), seed=8)
    _, cache_j = jl.prefill_into_slot(jp, jc, jnp.asarray(prompt), cache_j,
                                      jnp.int32(0), jnp.int32(0))
    _, cache_t = tl.prefill_into_slot(tp, tc, torch.from_numpy(prompt).long(),
                                      cache_t, 0, 0)
    first = np.array([3, 7], dtype=np.int32)
    lengths = np.array([16, 0], dtype=np.int32)
    active = np.array([True, False])
    emitted_j, _, len_j, _, _ = jl.decode_block(
        jp, jc, jnp.asarray(first), cache_j, jnp.asarray(lengths),
        jnp.asarray(active), jnp.zeros(2), jax.random.PRNGKey(0),
        num_steps=5, top_k=4)
    emitted_t, _, len_t, _ = tl.decode_block(
        tp, tc, torch.from_numpy(first), cache_t, torch.from_numpy(lengths),
        torch.from_numpy(active), torch.zeros(2),
        torch.Generator().manual_seed(0), num_steps=5, top_k=4)
    np.testing.assert_array_equal(emitted_t.numpy()[:, 0],
                                  np.asarray(emitted_j)[:, 0])
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))


@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("kv_pages", [None, 5])
def test_int8_paged_streams_match_jax_batcher(decode_block, kv_pages):
    """Quantized weights, int8 pools, flash admission and the int8 paged
    kernel route, at full provisioning and under pool pressure: the port
    batcher's greedy streams equal the JAX package's synchronous paged
    loop (its pipelined loop races on aliased host arrays on the CPU
    backend, ROADMAP Queue 3) and the port's dense int8 streams, on both
    host loops, with no page leaked."""
    jc, tc, jp, tp = _int8_twins(attention="flash", decode_attention="flash")
    prompts = _prompts()
    paged = dict(kv_page_tokens=16, kv_pages=kv_pages)
    theirs, _ = _serve(jb, jp, jc, prompts, decode_block=1, **paged)
    ours, batcher = _serve(tb, tp, tc, prompts, decode_block=decode_block,
                           device="cpu", **paged)
    dense, _ = _serve(tb, tp, tc, prompts, decode_block=decode_block,
                      device="cpu")
    assert ours == theirs == dense
    assert batcher._pages.leaked_pages() == 0
    assert (batcher.evictions >= 1) == (kv_pages is not None)
