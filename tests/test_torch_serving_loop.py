"""Port parity for the device-resident serving loop: the port's
``ContinuousBatcher`` with ``decode_block_tokens > 0`` (plain, ngram and
draft speculation, dense and paged caches, bf16-free float32 and int8
KV) emits the same token streams as the JAX package's SYNCHRONOUS host
loop (``decode_block=1``) at temperature 0 -- never its pipelined or
device loop, whose host mirrors race on the CPU backend.  Plus the
recover, export/import and fetch contracts of the JAX package's
test_serving_loop.py and test_failover.py.  Tiny float32 configs; the
same weights reach both packages through ``params_from_numpy``."""

import dataclasses

import jax
import numpy as np
import pytest

from aiko_services_tpu.models import batching as jb
from aiko_services_tpu.models import llama as jl
from aiko_services_tpu_torch.models import batching as tb
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl
from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer


@pytest.fixture(scope="module")
def twins():
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), dtype="float32")
    tc = dataclasses.replace(tl.LlamaConfig.tiny(), dtype="float32")
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                                  device="cpu")
    return jc, tc, jp, tp


def _run(module, params, config, n_requests=6, max_new=9, prompts=None,
         eos=(), temperature=0.0, max_steps=3000, **kw):
    """Drain ``n_requests`` requests through one batcher (4 slots, 64
    positions, 16-token chunks) -> ({request_id: [(token, finished)]},
    batcher)."""
    tok = ByteTokenizer()
    emitted = {}

    def emit(request_id, token, finished):
        emitted.setdefault(request_id, []).append((int(token), finished))

    if module is tb:
        kw["device"] = "cpu"
    batcher = module.ContinuousBatcher(params, config, max_slots=4,
                                       max_seq=64, prefill_chunk=16, **kw)
    for i in range(n_requests):
        text = prompts[i] if prompts else f"hello world {i}"
        batcher.submit(module.Request(
            request_id=f"r{i}", prompt_tokens=tok.encode(text),
            max_new_tokens=max_new, temperature=temperature, eos_tokens=eos,
            emit=emit))
    assert batcher.run_until_drained(max_steps=max_steps) < max_steps
    return emitted, batcher


def _host(twins, **kw):
    """The JAX package's synchronous host loop: the reference stream."""
    jc, _, jp, _ = twins
    return _run(jb, jp, jc, **kw)[0]


def _loop(twins, **kw):
    _, tc, _, tp = twins
    return _run(tb, tp, tc, **kw)


def test_device_loop_matches_jax_host_loop(twins):
    ours, batcher = _loop(twins, decode_block_tokens=8)
    assert ours == _host(twins)
    assert batcher.blocks_dispatched >= 1
    assert batcher.blocks_retired == batcher.blocks_dispatched
    # Up to ring tokens per slot per dispatch: far fewer host round
    # trips than tokens emitted.
    assert batcher.blocks_retired < batcher.tokens_emitted / 4
    assert batcher.blocks_in_flight == 0 and batcher.active_count == 0


def test_device_loop_paged_matches_jax_host_loop(twins):
    ours, batcher = _loop(twins, decode_block_tokens=8, kv_page_tokens=16)
    assert ours == _host(twins)
    assert batcher._pages.leaked_pages() == 0


@pytest.mark.parametrize("paged", [0, 16])
def test_device_loop_int8_kv_matches_jax_host_loop(twins, paged):
    jc, tc, jp, tp = twins
    jc8 = dataclasses.replace(jc, kv_dtype="int8")
    tc8 = dataclasses.replace(tc, kv_dtype="int8")
    theirs, _ = _run(jb, jp, jc8)
    ours, _ = _run(tb, tp, tc8, decode_block_tokens=8,
                   kv_page_tokens=paged)
    assert ours == theirs


def test_device_loop_chains_blocks_inflight(twins):
    """inflight 3 keeps several loop blocks chained on the device; the
    retire order keeps the stream exact."""
    ours, batcher = _loop(twins, max_new=17, decode_block_tokens=4,
                          inflight=3)
    assert ours == _host(twins, max_new=17)
    assert batcher.blocks_retired >= 4


def test_device_loop_inflight_one_matches(twins):
    ours, _ = _loop(twins, max_new=13, decode_block_tokens=4, inflight=1)
    assert ours == _host(twins, max_new=13)


def test_device_loop_respects_eos(twins):
    """On-device EOS detection stops a row exactly where the host finish
    test does, an EOS on the FIRST token included."""
    reference = _host(twins, n_requests=3, max_new=12)
    # Each stream's 3rd token and r0's 1st token as the stop set.
    eos = tuple({tokens[2][0] for tokens in reference.values()}
                | {reference["r0"][0][0]})
    host = _host(twins, n_requests=3, max_new=12, eos=eos)
    ours, _ = _loop(twins, n_requests=3, max_new=12, eos=eos,
                    decode_block_tokens=8)
    assert ours == host
    assert len(ours["r0"]) == 1
    for tokens in ours.values():
        assert tokens[-1][1] is True and len(tokens) <= 12


@pytest.mark.parametrize("mode", ["ngram", "draft"])
@pytest.mark.parametrize("paged", [0, 16])
def test_speculative_matches_jax_host_loop(twins, mode, paged):
    """Lossless speculation: greedy rows accept only verified drafts, so
    the stream equals the plain host loop's."""
    ours, batcher = _loop(twins, decode_block_tokens=8, speculative=mode,
                          kv_page_tokens=paged)
    assert ours == _host(twins)
    assert batcher.draft_tokens > 0


def test_draft_speculation_accepts_tokens(twins):
    _, batcher = _loop(twins, decode_block_tokens=8, speculative="draft")
    assert 0 < batcher.accepted_tokens <= batcher.draft_tokens


def test_speculative_auto_resolves(twins):
    """``auto`` without the probe (or without room in the ring) is off;
    with the probe it measures and commits to draft or off."""
    _, tc, _, tp = twins
    off = tb.ContinuousBatcher(tp, tc, decode_block_tokens=8,
                               speculative="auto", spec_autoprobe="off",
                               device="cpu")
    assert off.speculative == "off" and off.spec_probe_ratio == 0.0
    probed = tb.ContinuousBatcher(tp, tc, max_slots=2, max_seq=64,
                                  decode_block_tokens=8,
                                  speculative="auto", device="cpu")
    assert probed.speculative in ("off", "draft")
    assert probed.spec_probe_ratio > 0.0


@pytest.mark.parametrize("mode", ["off", "ngram"])
def test_sample_top_k_one_is_greedy_on_the_loop(twins, mode):
    """sample_top_k=1 at temperature 0.9 emits the greedy stream (top-1
    == argmax); speculation accepts no drafts on sampled rows."""
    greedy, _ = _loop(twins, n_requests=2, decode_block_tokens=8,
                      speculative=mode)
    top1, batcher = _loop(twins, n_requests=2, temperature=0.9,
                          sample_top_k=1, decode_block_tokens=8,
                          speculative=mode)
    assert top1 == greedy
    assert batcher.accepted_tokens == 0


def test_fetch_hook_once_per_retired_block(twins):
    calls = []

    def fetch(tree):
        calls.append(sorted(tree.copies))
        return tree.numpy()
    _, batcher = _loop(twins, decode_block_tokens=8, fetch=fetch)
    assert len(calls) == batcher.blocks_retired >= 1


def _faulted(twins, fire_at, **kw):
    """Drain with a fault probe raising at dispatch ``fire_at`` and
    recover() on the raise -> (streams, batcher, dispatches probed)."""
    _, tc, _, tp = twins
    tok = ByteTokenizer()
    emitted = {}

    def emit(request_id, token, finished):
        emitted.setdefault(request_id, []).append((int(token), finished))

    fired = {"n": 0}

    def probe(point):
        assert point == "decode_block"
        fired["n"] += 1
        if fired["n"] == fire_at:
            raise RuntimeError("injected chip death")

    batcher = tb.ContinuousBatcher(tp, tc, max_slots=4, max_seq=64,
                                   prefill_chunk=16, inflight=1,
                                   fault_probe=probe, device="cpu", **kw)
    for i in range(6):
        batcher.submit(tb.Request(
            request_id=f"r{i}", prompt_tokens=tok.encode(f"hello world {i}"),
            max_new_tokens=13, emit=emit))
    steps = 0
    while (batcher.pending or batcher.active_count
           or batcher.blocks_in_flight) and steps < 3000:
        try:
            batcher.step()
        except RuntimeError:
            assert batcher.recover() >= 1
        steps += 1
    assert steps < 3000
    return emitted, batcher, fired["n"]


def test_recover_resumes_from_last_emitted_block(twins):
    """A fault at the 3rd dispatch: recover() re-queues every live
    request at its committed prefix and the drained streams equal an
    unfaulted run -- nothing lost, nothing re-emitted."""
    ours, batcher, fired = _faulted(twins, 3, decode_block_tokens=4)
    assert ours == _host(twins, max_new=13)
    assert batcher.recoveries == 1 and fired > 3


def test_recover_paged_speculative(twins):
    """recover() rebuilds the page pool and the speculation state too.
    The fault is armed at the 2nd dispatch, which comes: recovery really
    runs (the JAX package's twin arms it after its last dispatch)."""
    ours, batcher, fired = _faulted(twins, 2, decode_block_tokens=8,
                                    speculative="ngram", kv_page_tokens=16)
    assert ours == _host(twins, max_new=13)
    assert batcher.recoveries == 1 and fired > 2
    assert batcher._pages.leaked_pages() == 0


@pytest.mark.parametrize("loop", [0, 8])
def test_batcher_export_import_continues_byte_identical(twins, loop):
    """Export after ~8 tokens, import into a FRESH batcher: the resumed
    stream equals one uninterrupted run (the JAX package's
    test_failover.py twin), on the host loop and on the device loop."""
    _, tc, _, tp = twins
    prompt, total = [3, 5, 7, 11], 24

    def batcher():
        return tb.ContinuousBatcher(tp, tc, max_slots=2, max_seq=64,
                                    decode_block_tokens=loop, device="cpu")

    def collector(sink):
        return lambda _rid, token, _finished: sink.append(int(token))
    reference: list = []
    ref = batcher()
    ref.submit(tb.Request("r", list(prompt), max_new_tokens=total,
                          emit=collector(reference)))
    ref.run_until_drained()
    first: list = []
    b1 = batcher()
    b1.submit(tb.Request("r", list(prompt), max_new_tokens=total,
                         emit=collector(first)))
    while len(first) < 8:
        b1.step()
    exported = b1.export_state()
    assert len(exported) == 1
    entry = exported[0]
    assert entry["prompt"] == prompt
    assert entry["committed"] == first[:len(entry["committed"])]
    second: list = []
    b2 = batcher()
    assert b2.import_state(exported,
                           emit_factory=lambda _e: collector(second)) == 1
    b2.run_until_drained()
    assert entry["committed"] + second == reference
    assert len(reference) == total


def test_device_loop_eos_table_grows(twins):
    """Stop sets of different widths admitted mid-run widen the eos table
    (the runner reallocates its buffer and captures anew on the card);
    the streams still equal the JAX package's host loop."""
    jc, tc, jp, tp = twins
    reference = _host(twins, n_requests=4, max_new=10)
    stops = [(), (reference["r1"][3][0],),
             (reference["r2"][2][0], 7, reference["r2"][5][0]), (9, 8)]
    tok = ByteTokenizer()

    def serve(module, params, config, **kw):
        emitted = {}
        if module is tb:
            kw["device"] = "cpu"
        batcher = module.ContinuousBatcher(params, config, max_slots=2,
                                           max_seq=64, prefill_chunk=16,
                                           **kw)
        for i, eos in enumerate(stops):
            batcher.submit(module.Request(
                request_id=f"r{i}", prompt_tokens=tok.encode(
                    f"hello world {i}"), max_new_tokens=10, eos_tokens=eos,
                emit=lambda rid, token, done: emitted.setdefault(
                    rid, []).append((int(token), done))))
        assert batcher.run_until_drained(max_steps=3000) < 3000
        return emitted, batcher
    theirs, _ = serve(jb, jp, jc)
    ours, batcher = serve(tb, tp, tc, decode_block_tokens=8)
    assert ours == theirs
    assert batcher._loop.inputs["eos"].shape == (2, 3)
    assert all(tokens[-1][1] for tokens in ours.values())
    assert any(len(tokens) < 10 for tokens in ours.values())


@pytest.mark.parametrize("paged", [0, 16])
def test_device_loop_cancel_mid_run(twins, paged):
    """A request cancelled while its blocks are in flight emits nothing
    more, its slot's chained row goes inactive at the next dispatch, the
    others keep the JAX package's streams, and no page leaks."""
    _, tc, _, tp = twins
    tok = ByteTokenizer()
    emitted = {}
    batcher = tb.ContinuousBatcher(tp, tc, max_slots=4, max_seq=64,
                                   prefill_chunk=16, decode_block_tokens=4,
                                   kv_page_tokens=paged, device="cpu")
    for i in range(4):
        batcher.submit(tb.Request(
            request_id=f"r{i}", prompt_tokens=tok.encode(f"hello world {i}"),
            max_new_tokens=14, emit=lambda rid, token, done: emitted
            .setdefault(rid, []).append((int(token), done))))
    while len(emitted.get("r1", ())) < 2:
        batcher.step()
    assert batcher.cancel("r1")
    cut = len(emitted["r1"])
    assert batcher.run_until_drained(max_steps=3000) < 3000
    assert len(emitted["r1"]) == cut
    reference = _host(twins, n_requests=4, max_new=14)
    for rid in ("r0", "r2", "r3"):
        assert emitted[rid] == reference[rid]
    assert emitted["r1"] == reference["r1"][:cut]
    if paged:
        assert batcher._pages.leaked_pages() == 0
