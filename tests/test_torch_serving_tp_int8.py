"""Port twins of the JAX package's multichip serving claim: a weight-only
int8 tree placed by ``quantize_specs(partition_specs(config))`` served
through a real ``ContinuousBatcher`` whose ``cache_put`` places every
cache it builds (``tests/test_quant.py::
test_batcher_tp_sharded_quantized_serving`` and section 5 of
``__graft_entry__.py``'s ``dryrun_multichip``).

The port's mesh is eight CPU descriptors; the JAX package's is its eight
virtual CPU devices.  Both get the same weights: the JAX float tree
bridged through numpy, then each package's ``quantize_params`` (their
codes are bit-equal).  Everything runs in float32 at ``LlamaConfig.tiny``
widths (the JAX graft's bf16 is float32 here: the CPU backends round
bf16 differently).  The JAX batcher runs at ``decode_block`` 1, its
synchronous loop (its pipelined loop races on host mirrors the CPU
backend aliases; see ``tests/test_torch_batching.py``).

Tolerances: greedy token streams are held EXACTLY equal -- to the JAX
batcher's on the JAX sharded tree and to the port's one-device batcher's
-- at decode_block 1 and 4, through flash (per slot) and dense
(``prefill_into_slots``) admission, dense and paged (8-token pages)
caches, and the device loop (8-token ring, eager on the CPU); the
speculative device loop's (ngram, draft) to the port's one-device
run's.  Logits of
``prefill_into_slot`` into a cache whose batch is split over dp are held
within 1e-5 of the one-device call's (summation order over tp only), and
its cache rows within 1e-5 (float32 model dtype) of the one-device
cache's."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import batching as jb
from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.models import quant as jq
from aiko_services_tpu.parallel import MeshPlan as JaxPlan
from aiko_services_tpu.parallel import make_mesh as jax_make_mesh
from aiko_services_tpu_torch.models import batching as tb
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl
from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                  quantize_specs)
from aiko_services_tpu_torch.parallel import MeshPlan, Placed, make_mesh

MESH = {"dp": 2, "fsdp": 2, "tp": 2}
POOL = [torch.device("cpu", index) for index in range(8)]
LOGITS_TOL = 1e-5
NEW_TOKENS = 8


def _configs(kv_dtype="int8", attention="flash", vocab=512, max_seq=64):
    settings = dict(dtype="float32", attention=attention)
    if kv_dtype == "int8":
        settings["kv_dtype"] = "int8"
    return (dataclasses.replace(jl.LlamaConfig.tiny(vocab, max_seq),
                                **settings),
            dataclasses.replace(tl.LlamaConfig.tiny(vocab, max_seq),
                                **settings))


@functools.lru_cache(maxsize=None)
def _trees(kv_dtype="int8", attention="flash", seed=0, vocab=512,
           max_seq=64):
    """(JAX config, port config, JAX int8 tree, port int8 tree)."""
    jc, tc = _configs(kv_dtype, attention, vocab, max_seq)
    params = jl.init_params(jax.random.PRNGKey(seed), jc)
    ours = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tc, device="cpu")
    return jc, tc, jq.quantize_params(params), quantize_params(ours)


def _prompts(vocab=512):
    rng = np.random.default_rng(0)
    # Three requests on two slots queue the third; the second prompt
    # spans two 16-token chunks.
    return [rng.integers(0, vocab, n).tolist() for n in (5, 23, 9)]


def _serve(module, params, config, prompts, new_tokens=NEW_TOKENS,
           max_slots=2, **options):
    batcher = module.ContinuousBatcher(params, config, max_slots=max_slots,
                                       max_seq=64, prefill_chunk=16,
                                       **options)
    streams = {}
    for index, prompt in enumerate(prompts):
        streams[index] = []
        batcher.submit(module.Request(
            str(index), list(prompt), max_new_tokens=new_tokens,
            emit=lambda rid, token, done, i=index: streams[i].append(token)))
    steps = batcher.run_until_drained(max_steps=500)
    assert steps < 500
    return streams, batcher


def _port_plan(axes=MESH) -> MeshPlan:
    return MeshPlan(make_mesh(axes, POOL[:int(np.prod(list(
        axes.values())))]))


def _jax_plan(axes=MESH) -> JaxPlan:
    return JaxPlan(jax_make_mesh(axes, jax.devices()[:int(np.prod(list(
        axes.values())))]))


@functools.lru_cache(maxsize=None)
def _jax_streams(kv_dtype, attention):
    """The JAX batcher's greedy streams on the JAX sharded tree, its
    cache placed by ``cache_put`` (the reference test's wiring)."""
    jc, _, jparams, _ = _trees(kv_dtype, attention)
    plan = _jax_plan()
    sharded = plan.put(jparams, jq.quantize_specs(jl.partition_specs(jc)))
    cache_sharding = jax.tree_util.tree_map(plan.shard, jl.cache_specs(jc))
    streams, _ = _serve(jb, sharded, jc, _prompts(), decode_block=1,
                        cache_put=lambda c: jax.device_put(c,
                                                           cache_sharding))
    return streams


def _cache_put(plan, config, paged: bool):
    specs = tl.paged_cache_specs(config) if paged \
        else tl.cache_specs(config)
    return lambda cache: plan.put(cache, specs)


CASES = {
    "flash-1": ("int8", "flash", dict(decode_block=1)),
    "flash-4": ("int8", "flash", dict(decode_block=4, inflight=2)),
    "dense-4": ("int8", "dense", dict(decode_block=4, inflight=2)),
    "paged-flash-1": ("int8", "flash", dict(kv_page_tokens=8)),
    "paged-dense-4": ("int8", "dense", dict(kv_page_tokens=8,
                                            decode_block=4, inflight=2)),
    "loop-8": ("int8", "flash", dict(decode_block_tokens=8)),
    "loop-paged-8": ("int8", "dense", dict(decode_block_tokens=8,
                                           kv_page_tokens=8)),
    # The reference test's own config: the cache in the model dtype.
    "model-kv-flash-4": ("float32", "flash", dict(decode_block=4,
                                                  inflight=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batcher_tp_sharded_quantized_serving(case):
    """The placed int8 tree over {"dp": 2, "fsdp": 2, "tp": 2} through the
    port's batcher, ``cache_put`` placing its cache: greedy streams equal
    to the JAX batcher's on the JAX sharded tree and to the port's
    one-device batcher's, every request at its budget, the cache placed
    at the end and no block in flight."""
    kv_dtype, attention, options = CASES[case]
    _, tc, _, params = _trees(kv_dtype, attention)
    plan = _port_plan()
    placed = plan.put(params, quantize_specs(tl.partition_specs(tc)))
    paged = "kv_page_tokens" in options
    prompts = _prompts()
    ours, batcher = _serve(tb, placed, tc, prompts, device="cpu",
                           cache_put=_cache_put(plan, tc, paged), **options)
    alone, _ = _serve(tb, params, tc, prompts, device="cpu", **options)
    assert all(len(stream) == NEW_TOKENS for stream in ours.values())
    assert ours == alone
    assert ours == _jax_streams(kv_dtype, attention)
    assert isinstance(batcher.cache, Placed)
    assert batcher.active_count == 0 and batcher.blocks_in_flight == 0
    if paged:
        assert batcher._pages.leaked_pages() == 0
    if batcher.device_loop:
        assert batcher.blocks_retired == batcher.blocks_dispatched > 0


def test_graft_serving_tp_int8_section():
    """``__graft_entry__.py`` section 5 (serving-tp-int8) on {"dp": 4,
    "tp": 2}: a decode step of a placed 4-slot int8 cache gives finite
    logits, then a real batcher tick on the same mesh emits the JAX
    batcher's 4 tokens."""
    jc, tc, jparams, params = _trees("int8", "dense", seed=4, vocab=256)
    axes = {"dp": 4, "tp": 2}
    plan = _port_plan(axes)
    placed = plan.put(params, quantize_specs(tl.partition_specs(tc)))
    cache = plan.put(tl.init_cache(tc, 4, 64, device="cpu"),
                     tl.cache_specs(tc))
    logits, cache = tl.decode_step(placed, tc,
                                   torch.zeros(4, dtype=torch.int32), cache,
                                   torch.zeros(4, dtype=torch.int32))
    assert torch.isfinite(logits).all() and logits.shape == (4, 256)
    assert isinstance(cache, Placed)
    jplan = _jax_plan(axes)
    sharded = jplan.put(jparams, jq.quantize_specs(jl.partition_specs(jc)))
    sharding = jax.tree_util.tree_map(jplan.shard, jl.cache_specs(jc))
    options = dict(max_slots=4, decode_block=4, inflight=2, new_tokens=4)
    theirs, _ = _serve(jb, sharded, jc, [[1, 2, 3]],
                       cache_put=lambda c: jax.device_put(c, sharding),
                       **options)
    ours, _ = _serve(tb, placed, tc, [[1, 2, 3]], device="cpu",
                     cache_put=_cache_put(plan, tc, False), **options)
    assert len(ours[0]) == 4
    assert ours == theirs


def test_prefill_into_slot_dp_split_cache():
    """``prefill_into_slot`` into a cache whose batch is split over dp
    (``cache_specs``): for a slot in each dp group, two chunks, the
    logits of the one-device call and the slot's cache row of the
    one-device cache; the other rows stay zero."""
    _, tc, _, params = _trees("int8", "flash")
    plan = _port_plan()
    placed = plan.put(params, quantize_specs(tl.partition_specs(tc)))
    cache = plan.put(tl.init_cache(tc, 4, 64, device="cpu"),
                     tl.cache_specs(tc))
    alone = tl.init_cache(tc, 4, 64, device="cpu")
    rng = np.random.default_rng(5)
    for slot in (1, 2):                  # dp group 0, then dp group 1
        for start in (0, 16):
            tokens = torch.from_numpy(rng.integers(0, 512, (1, 16)))
            got, cache = tl.prefill_into_slot(placed, tc, tokens, cache,
                                              slot, start)
            want, alone = tl.prefill_into_slot(params, tc, tokens, alone,
                                               slot, start)
            assert got.shape == want.shape == (1, 16, 512)
            assert (got - want).abs().max() <= LOGITS_TOL * \
                want.abs().max()
    whole = plan.gather(cache)
    for side in ("k", "v"):
        for name in ("int8", "scale"):
            ours, theirs = whole[side][name], alone[side][name]
            assert ((ours.float() - theirs.float()).abs().max()
                    <= LOGITS_TOL * max(1.0, theirs.float().abs().max()))
            assert not ours[:, [0, 3]].any()


def test_prefill_into_slots_across_dp_groups():
    """A dense admission burst whose rows fall in both dp groups (a
    padded duplicate row included): the logits of the one-device call,
    in row order."""
    _, tc, _, params = _trees("int8", "dense")
    plan = _port_plan()
    placed = plan.put(params, quantize_specs(tl.partition_specs(tc)))
    cache = plan.put(tl.init_cache(tc, 4, 64, device="cpu"),
                     tl.cache_specs(tc))
    alone = tl.init_cache(tc, 4, 64, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, 512, (4, 16)))
    tokens[3] = tokens[0]
    slots, starts = [3, 0, 2, 3], [16, 0, 0, 16]
    got, cache = tl.prefill_into_slots(placed, tc, tokens, cache, slots,
                                       starts)
    want, alone = tl.prefill_into_slots(params, tc, tokens, alone, slots,
                                        starts)
    assert (got - want).abs().max() <= LOGITS_TOL * want.abs().max()
    whole = plan.gather(cache)
    assert torch.equal(whole["k"]["int8"], alone["k"]["int8"])


@pytest.mark.parametrize("paged", [False, True])
def test_recover_rebuilds_a_placed_cache(paged):
    """``recover()`` on a placed batcher after a fault at the 2nd
    device-loop dispatch: a new placed cache (through ``cache_put``),
    every stream finished and equal to the uninterrupted run's."""
    _, tc, _, params = _trees("int8", "flash")
    plan = _port_plan()
    placed = plan.put(params, quantize_specs(tl.partition_specs(tc)))
    options = dict(decode_block_tokens=8, device="cpu",
                   cache_put=_cache_put(plan, tc, paged))
    if paged:
        options["kv_page_tokens"] = 8
    want, _ = _serve(tb, placed, tc, _prompts()[:2], **options)
    dispatches = [0]

    def probe(point):
        dispatches[0] += 1
        if dispatches[0] == 2:
            raise RuntimeError("injected fault")
    batcher = tb.ContinuousBatcher(placed, tc, max_slots=2, max_seq=64,
                                   prefill_chunk=16, fault_probe=probe,
                                   **options)
    streams = {0: [], 1: []}
    for index, prompt in enumerate(_prompts()[:2]):
        batcher.submit(tb.Request(
            str(index), prompt, max_new_tokens=NEW_TOKENS,
            emit=lambda rid, token, done: streams[int(rid)].append(token)))
    before = batcher.cache
    for _ in range(200):
        if not (batcher.pending or batcher.active_count
                or batcher.blocks_in_flight):
            break
        try:
            batcher.step()
        except RuntimeError:
            assert batcher.recover() > 0
    assert batcher.recoveries == 1
    assert isinstance(batcher.cache, Placed) and batcher.cache is not before
    assert streams == want


def test_export_import_between_placed_batchers():
    """``export_state`` mid-stream on a placed batcher, ``import_state``
    into another: the streams finish as one uninterrupted run's."""
    _, tc, _, params = _trees("int8", "flash")
    plan = _port_plan()
    placed = plan.put(params, quantize_specs(tl.partition_specs(tc)))
    options = dict(decode_block=1, device="cpu",
                   cache_put=_cache_put(plan, tc, False))
    prompts = _prompts()[:2]
    want, _ = _serve(tb, placed, tc, prompts, **options)
    first = tb.ContinuousBatcher(placed, tc, max_slots=2, max_seq=64,
                                 prefill_chunk=16, **options)
    streams = {0: [], 1: []}

    def emit_for(index):
        return lambda rid, token, done: streams[index].append(token)
    for index, prompt in enumerate(prompts):
        first.submit(tb.Request(str(index), prompt,
                                max_new_tokens=NEW_TOKENS,
                                emit=emit_for(index)))
    while min(len(stream) for stream in streams.values()) < 3:
        first.step()
    entries = first.export_state()
    assert entries and all(entry["committed"] for entry in entries)
    second = tb.ContinuousBatcher(placed, tc, max_slots=2, max_seq=64,
                                  prefill_chunk=16, **options)
    second.import_state(entries, emit_factory=lambda entry: emit_for(
        int(entry["request_id"])))
    second.run_until_drained(max_steps=300)
    assert streams == want


def test_probe_cache_is_placed_with_every_table_written():
    """The speculation probe's scratch cache (paged) goes through
    ``cache_put``, and its fully mapped page table reaches every
    position's copy."""
    _, tc, _, params = _trees("int8", "flash")
    plan = _port_plan()
    placed = plan.put(params, quantize_specs(tl.partition_specs(tc)))
    batcher = tb.ContinuousBatcher(
        placed, tc, max_slots=2, max_seq=64, prefill_chunk=16,
        kv_page_tokens=8, device="cpu",
        cache_put=_cache_put(plan, tc, True))
    probe = batcher._probe_cache()
    assert isinstance(probe, Placed)
    tables = {id(shard["page_table"]): shard["page_table"]
              for shard in probe.shards}
    assert len(tables) == 8             # eight descriptors, eight copies
    first = next(iter(tables.values()))
    assert first.min() >= 1
    assert all(torch.equal(first, table) for table in tables.values())


def test_draft_params_of_a_placed_tree():
    """A placed model-dtype tree drafts through its WHOLE leaves'
    quantization, placed by ``quantize_specs``: bitwise the placed
    ``quantize_params`` of the whole tree (not each shard quantized
    alone); a placed int8 tree is its own draft."""
    from aiko_services_tpu_torch.models.checkpoint import flatten
    from aiko_services_tpu_torch.models.quant import draft_params
    tc = dataclasses.replace(tl.LlamaConfig.tiny(512, 64), dtype="float32")
    params = tl.init_params(0, tc, device="cpu")
    plan = _port_plan()
    placed = plan.put(params, tl.partition_specs(tc))
    draft = draft_params(placed)
    want = plan.put(quantize_params(params),
                    quantize_specs(tl.partition_specs(tc)))
    assert draft.specs == want.specs
    for got, expected in zip(draft.shards, want.shards):
        ours, theirs = flatten(got), flatten(expected)
        assert all(torch.equal(ours[name], theirs[name]) for name in theirs)
    assert draft_params(draft) is draft


SPECULATIVE = {
    "loop-ngram-paged-8": dict(decode_block_tokens=8, speculative="ngram",
                               kv_page_tokens=8),
    "loop-draft-8": dict(decode_block_tokens=8, speculative="draft"),
}


@pytest.mark.parametrize("case", sorted(SPECULATIVE))
def test_speculative_serving_on_a_placed_tree(case):
    """ngram and draft speculation on the placed int8 tree: the verify
    forward (and the self-draft, the tree itself) at every position,
    greedy streams equal to the port's one-device run of the same mode,
    draft tokens proposed.  (Not to the plain streams: over an int8
    cache a verified position attends the chunk's earlier k/v before
    their quantization, where plain decode reads them quantized, so the
    two loops may part at a near-tie.)"""
    options = SPECULATIVE[case]
    _, tc, _, params = _trees("int8", "flash")
    plan = _port_plan()
    placed = plan.put(params, quantize_specs(tl.partition_specs(tc)))
    prompts = _prompts()
    ours, batcher = _serve(
        tb, placed, tc, prompts, device="cpu",
        cache_put=_cache_put(plan, tc, "kv_page_tokens" in options),
        **options)
    alone, _ = _serve(tb, params, tc, prompts, device="cpu", **options)
    assert batcher.draft_tokens > 0
    assert ours == alone
