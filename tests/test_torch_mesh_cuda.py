"""The port's mesh on the card (``parallel/mesh.py``, ``parallel/ring.py``,
``models/long_context.py``, the sharded step of ``models/train.py``,
the continuous batcher on a placed int8 tree): a mesh of distinct cards
computes each position on its own card and hops between cards by peer
copies; the same mesh with one card listed at every position gives the
same numbers (the batcher: the same greedy streams, and its captured
device loop -- one CUDA graph over both cards -- the host loop's, with
the launches of card 0 listed twice; the full-width case prints its
times).  Imports no JAX, so it runs on the card machine:

    python3 -m pytest --noconftest -q tests/test_torch_mesh_cuda.py

Without a card every test here skips; the tests across cards skip
with fewer than two.  Tolerances, float32: 1e-5 between the two
placements (the same kernels on the same inputs; only cuBLAS's choice
between cards could reorder a sum) and 1e-4 against the dense prefill
(summation order); the loss within 1e-6, each gradient leaf within
1e-5 of its largest magnitude."""

import dataclasses
import gc
import json
import subprocess
import time

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.models import llama, train
from aiko_services_tpu_torch.models.batching import (ContinuousBatcher,
                                                     Request)
from aiko_services_tpu_torch.models.checkpoint import flatten
from aiko_services_tpu_torch.models.long_context import (
    make_long_context_forward, make_long_context_loss)
from aiko_services_tpu_torch.models.loop_graph import LoopRunner
from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                  quantize_specs)
from aiko_services_tpu_torch.ops import launch_counters
from aiko_services_tpu_torch.parallel import (MeshPlan, P, axis_index,
                                              make_mesh, ppermute, psum,
                                              shard_map)

PLACEMENT_TOL = 1e-5
DENSE_TOL = 1e-4
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5


@pytest.fixture
def cards() -> list:
    """Four cards of this machine, or two, or one (skips without one):
    the sequence of 256 tokens splits over each count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i)
            for i in range(4 if count >= 4 else min(count, 2))]


@pytest.fixture
def several(cards) -> list:
    if len(cards) < 2:
        pytest.skip("needs two CUDA cards")
    return cards


def config():
    return dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=256,
                                                      max_seq=512),
                               dtype="float32")


def tokens(shape=(2, 256)) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, shape).astype(np.int64))


def plan(devices: list) -> MeshPlan:
    return MeshPlan(make_mesh({"sp": len(devices)}, devices))


@pytest.mark.cuda
def test_positions_compute_on_their_cards(several):
    """Each position's shard, its arithmetic and what it receives lie on
    its own card; the result is assembled on the first."""
    n = len(several)
    mesh = make_mesh({"sp": n}, several)
    seen = {}

    def body(x):
        rotated = ppermute(x, "sp", [(j, (j + 1) % n) for j in range(n)])
        total = psum(x, "sp")
        seen[axis_index("sp")] = (x.device, rotated.device, total.device)
        return rotated + total
    x = torch.arange(n * 8, dtype=torch.float32, device=several[0])
    out = shard_map(body, mesh, in_specs=(P("sp"),),
                    out_specs=P("sp"))(x)
    assert seen == {i: (card, card, card) for i, card in enumerate(several)}
    assert out.device == several[0]
    want = x.reshape(n, 8).roll(1, 0) + x.reshape(n, 8).sum(0)
    assert torch.equal(out, want.reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_forward_across_cards_matches_one_card(several, attention):
    """The long-context forward over distinct cards equals the same mesh
    on one card and the dense prefill."""
    c = config()
    params = llama.init_params(0, c, device=several[0])
    batch = tokens().to(several[0])
    spread = make_long_context_forward(c, plan(several), attention)(
        params, batch)
    stacked = make_long_context_forward(
        c, plan([several[0]] * len(several)), attention)(params, batch)
    cache = llama.init_cache(c, *batch.shape, device=several[0])
    dense, _ = llama.prefill(params, c, batch, cache,
                             torch.zeros(batch.shape[0], dtype=torch.int32,
                                         device=several[0]))
    assert (spread - stacked).abs().max().item() <= PLACEMENT_TOL
    assert (spread - dense).abs().max().item() <= DENSE_TOL


@pytest.mark.cuda
def test_loss_gradient_across_cards_matches_one_card(several):
    """One backward of the ring loss over distinct cards: the loss and
    every gradient leaf equal to the same mesh's on one card."""
    c = config()
    batch = tokens().to(several[0])
    grads = []
    for devices in (several, [several[0]] * len(several)):
        params = llama.init_params(0, c, device=several[0])
        leaves = flatten(params)
        for leaf in leaves.values():
            leaf.requires_grad_(True)
        loss = make_long_context_loss(c, plan(devices), "ring")(params,
                                                                batch)
        loss.backward()
        grads.append((loss.item(), {name: leaf.grad
                                    for name, leaf in leaves.items()}))
    (loss_a, grad_a), (loss_b, grad_b) = grads
    assert abs(loss_a - loss_b) <= LOSS_TOL
    for name, leaf in grad_b.items():
        scale = leaf.abs().max().item()
        assert (grad_a[name] - leaf).abs().max().item() <= GRAD_TOL * scale, \
            name


@pytest.mark.cuda
def test_sharded_train_step_across_cards_matches_one_card(several):
    """The sharded model step (``models/train.py`` on a placed tree) on
    {"dp": 2, "fsdp": 2, "tp": 2} with the positions spread over the
    cards: the loss and every gradient leaf equal to the same mesh's
    with card 0 at every position; after a step, every replica of a
    leaf (on distinct cards) holds the same bits."""
    c = config()
    batch = tokens((4, 64)).to(several[0])
    axes = {"dp": 2, "fsdp": 2, "tp": 2}
    results = []
    for devices in ((several * 8)[:8], [several[0]] * 8):
        mesh_plan = MeshPlan(make_mesh(axes, devices))
        params, state, _ = train.init_train_state(0, c, mesh_plan)
        loss, grads = train.value_and_grad(params, c, batch)
        results.append((loss.item(), flatten(mesh_plan.gather(grads))))
        if devices[0] != devices[1]:
            assert params.replicas()
            params, state, _ = train.make_train_step(c, mesh_plan)(
                params, state, batch)
            for group in params.replicas():
                assert len({t.device for t in group}) == len(group)
                assert all(torch.equal(group[0], member.to(group[0].device))
                           for member in group[1:])
    (loss_a, grad_a), (loss_b, grad_b) = results
    assert abs(loss_a - loss_b) <= LOSS_TOL
    for name, leaf in grad_b.items():
        scale = leaf.abs().max().item()
        assert (grad_a[name] - leaf).abs().max().item() <= GRAD_TOL * scale, \
            name


@pytest.mark.cuda
def test_one_card_at_every_position_matches_dense(cards):
    """On any machine with a card: four positions on card 0, ring and
    Ulysses, against the dense prefill."""
    c = config()
    params = llama.init_params(0, c, device=cards[0])
    batch = tokens().to(cards[0])
    cache = llama.init_cache(c, *batch.shape, device=cards[0])
    dense, _ = llama.prefill(params, c, batch, cache,
                             torch.zeros(batch.shape[0], dtype=torch.int32,
                                         device=cards[0]))
    for attention in ("ring", "ulysses"):
        logits = make_long_context_forward(c, plan([cards[0]] * 4),
                                           attention)(params, batch)
        assert logits.device == cards[0]
        assert (logits - dense).abs().max().item() <= DENSE_TOL


@pytest.mark.cuda
def test_failure_on_a_card_aborts_the_call(cards):
    """A position that raises makes the call raise, with the others
    waiting in a collective on their cards."""
    devices = (cards * 4)[:4]
    mesh = make_mesh({"sp": 4}, devices)

    def body(x):
        if axis_index("sp") == 2:
            raise ZeroDivisionError("position 2 fails")
        return psum(x, "sp")
    with pytest.raises(ZeroDivisionError):
        shard_map(body, mesh, in_specs=(P("sp"),), out_specs=P())(
            torch.ones(8, device=cards[0]))


def serving_config():
    """int8 weights and cache at kernel-sized heads (head_dim 64; a
    1,024-token extent takes the decode kernels), bf16, flash."""
    return dataclasses.replace(
        llama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                          n_kv_heads=2, hidden_dim=512, max_seq=1024,
                          rope_theta=10_000.0),
        attention="flash", kv_dtype="int8")


def served_run(devices: list, config=None, max_new_tokens: int = 12,
               on_dispatch=None, fault_at: int = 0, **options) -> dict:
    """Four greedy requests through a ``ContinuousBatcher`` on the int8
    tree placed over {"tp": 2} on ``devices``, ``cache_put`` placing its
    cache: the token streams, the run's launches (counters zeroed
    before it) and its metrics.  ``on_dispatch`` runs after every block
    dispatch; ``fault_at`` > 0 raises at that device-loop dispatch and
    the run calls ``recover()``."""
    c = config or serving_config()
    params = quantize_params(llama.init_params(0, c, device=devices[0]))
    mesh_plan = MeshPlan(make_mesh({"tp": 2}, devices))
    placed = mesh_plan.put(params, quantize_specs(llama.partition_specs(c)))
    del params
    specs = llama.paged_cache_specs(c) if "kv_page_tokens" in options \
        else llama.cache_specs(c)
    dispatches = [0]

    def probe(point):
        dispatches[0] += 1
        if dispatches[0] == fault_at:
            raise RuntimeError(f"injected fault at dispatch {fault_at}")
    if fault_at:
        options["fault_probe"] = probe
    if on_dispatch is not None:
        options["on_block"] = lambda kind, rows: (
            on_dispatch() if kind == "dispatch" else None)
    batcher = ContinuousBatcher(
        placed, c, max_slots=4, prefill_chunk=256, device=devices[0],
        cache_put=lambda cache: mesh_plan.put(cache, specs), **options)
    rng = np.random.default_rng(3)
    streams = {}
    for index, length in enumerate((40, 300, 120, 260)):
        streams[index] = []
        batcher.submit(Request(
            str(index), rng.integers(0, c.vocab_size, length).tolist(),
            max_new_tokens=max_new_tokens,
            emit=lambda rid, token, done: streams[int(rid)].append(token)))
    counters = launch_counters()
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    for device in set(devices):
        torch.cuda.synchronize(device)
    begin = time.perf_counter()
    for _ in range(2_000):
        if not (batcher.pending or batcher.active_count
                or batcher.blocks_in_flight):
            break
        try:
            batcher.step()
        except RuntimeError:
            if not fault_at or batcher.recoveries:
                raise
            assert batcher.recover() > 0
    for device in set(devices):
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - begin
    assert all(len(stream) == max_new_tokens for stream in streams.values())
    metrics = {"wall_s": wall, "tokens_per_s": batcher.tokens_emitted / wall,
               "recoveries": batcher.recoveries}
    if batcher.device_loop:
        metrics.update(captures=batcher._loop.captures,
                       replays=batcher._loop.replays,
                       capture_s=batcher._loop.capture_s,
                       blocks=batcher.blocks_dispatched)
    return {"streams": streams, "metrics": metrics,
            "launches": {name: getattr(wrapper, attr) for name,
                         (wrapper, attr) in counters.items()
                         if getattr(wrapper, attr)}}


def served(devices: list, **options) -> dict:
    """The token streams of :func:`served_run`."""
    return served_run(devices, **options)["streams"]


@pytest.mark.cuda
@pytest.mark.parametrize("options", [
    dict(decode_block=1), dict(decode_block=4, inflight=2),
    dict(kv_page_tokens=64)], ids=["host-1", "host-4", "paged-1"])
def test_batcher_across_cards_matches_one_card(several, options):
    """The batcher over {"tp": 2} on two distinct cards gives the greedy
    streams of the same mesh with card 0 listed twice."""
    assert served(several[:2], **options) == \
        served([several[0]] * 2, **options)


@pytest.mark.cuda
def test_captured_loop_on_one_card_matches_host_loop(cards):
    """The device loop over {"tp": 2} on card 0 listed twice -- one CUDA
    graph holding both positions' work -- emits the host loop's greedy
    streams."""
    one = [cards[0]] * 2
    assert served(one, decode_block_tokens=16) == \
        served(one, decode_block=1)


LOOPS = {"plain": {},
         "ngram-paged": dict(speculative="ngram", kv_page_tokens=64),
         "self-draft": dict(speculative="draft")}


def check_replayed(run: dict) -> None:
    """Every block of a device-loop run came from a captured graph."""
    metrics = run["metrics"]
    assert metrics["captures"] >= 1
    assert metrics["replays"] == metrics["blocks"]


@pytest.mark.cuda
@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_captured_loop_across_cards_matches_one_card(several, loop):
    """The device loop over {"tp": 2} on two distinct cards -- one CUDA
    graph holding both cards' work, forked from card 0's capture stream
    -- emits the greedy streams of the same loop with card 0 listed
    twice, with the same launches, every block a replay."""
    mode = LOOPS[loop]
    across = served_run(several[:2], decode_block_tokens=16, **mode)
    twice = served_run([several[0]] * 2, decode_block_tokens=16, **mode)
    check_replayed(across)
    assert across["streams"] == twice["streams"]
    assert across["launches"] == twice["launches"]


@pytest.mark.cuda
def test_captured_loop_across_cards_matches_host_loop(several):
    """The plain device loop over {"tp": 2} on two distinct cards emits
    the greedy streams of the host loop (decode_block 1) on the same
    cards.  The speculative loops are held to card 0 listed twice above:
    their verify forward computes other sums than a decode step (#5's
    M > 16 route, the verify attention; over an int8 cache the chunk's
    k/v before quantization: ROADMAP "Decisions"), so a greedy
    near-tie may flip against the host loop on one card as on two."""
    across = served_run(several[:2], decode_block_tokens=16)
    check_replayed(across)
    assert across["streams"] == served(several[:2], decode_block=1)


@pytest.mark.cuda
def test_captured_loop_across_cards_recovers(several):
    """A fault at the 2nd device-loop dispatch on two distinct cards,
    then ``recover()``: a new placed cache, a second capture, and every
    stream equal to the uninterrupted run's."""
    want = served(several[:2], decode_block_tokens=16)
    run = served_run(several[:2], decode_block_tokens=16, fault_at=2)
    assert run["metrics"]["recoveries"] == 1
    assert run["metrics"]["captures"] == 2
    assert run["streams"] == want


@pytest.mark.cuda
def test_captured_loop_keeps_its_memory_on_the_second_card(several):
    """Tensors allocated and filled on card 1 between replays (from a
    kilobyte to 64 MiB, some kept, some freed) never land in the graph's
    memory there: the streams stay the uninterrupted run's."""
    second = several[1]
    kept = []

    def churn():
        for shift in range(10, 27, 2):
            block = torch.full((1 << shift,), 7.0, device=second)
            if shift % 4 == 0:
                kept.append(block)
    want = served(several[:2], decode_block_tokens=16)
    run = served_run(several[:2], decode_block_tokens=16, on_dispatch=churn)
    check_replayed(run)
    assert kept and run["streams"] == want


def full_width_config():
    """Llama-3-8B at its published widths and depth, int8 weights and
    cache, ``max_seq`` 2048 (cut from 8,192: no prompt here is longer
    than 300 tokens), flash."""
    return dataclasses.replace(llama.LlamaConfig.llama3_8b(), max_seq=2048,
                               attention="flash", kv_dtype="int8")


def block_device_ms(devices: list, config) -> tuple[float, float]:
    """(capture s, the mean device ms of 5 replays by CUDA events on the
    capture card) of one plain loop block: 4 rows at 1,000 cached
    positions, ring 16, on the int8 tree placed over {"tp": 2} on
    ``devices``."""
    params = quantize_params(llama.init_params(0, config,
                                               device=devices[0]))
    mesh_plan = MeshPlan(make_mesh({"tp": 2}, devices))
    placed = mesh_plan.put(params, quantize_specs(
        llama.partition_specs(config)))
    del params
    cache = mesh_plan.put(llama.init_cache(config, 4, device=devices[0]),
                          llama.cache_specs(config))
    runner = LoopRunner(placed, config, batch=4, ring=16, speculative="off",
                        spec_tokens=4, spec_window=32, draft=None, top_k=1,
                        generator=torch.Generator(
                            device=devices[0]).manual_seed(5),
                        history_width=1, device=devices[0])

    def load():
        runner.inputs["tokens"].fill_(3)
        runner.inputs["lengths"].fill_(1000)
        runner.inputs["active"].fill_(True)
        runner.inputs["budget"].fill_(16)
    load()
    runner.run(cache)                       # the capture
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        load()
        runner.run(cache)
    end.record()
    torch.cuda.synchronize(devices[0])
    capture_s = runner.capture_s
    runner.reset()
    return capture_s, start.elapsed_time(end) / 5


@pytest.mark.cuda
def test_captured_loop_across_cards_at_full_width(several):
    """Llama-3-8B int8 over {"tp": 2} on cards 0 and 1: the captured
    loop's greedy streams equal the host loop's on the same cards; its
    tokens/s, capture s and block device ms are printed beside the host
    loop's and beside the captured loop's with card 0 listed twice."""
    config = full_width_config()
    pair, twice = several[:2], [several[0]] * 2
    runs, blocks = {}, {}
    for label, devices, options in (
            ("captured, cards 0 and 1", pair, dict(decode_block_tokens=16)),
            ("host loop, cards 0 and 1", pair, dict(decode_block=1)),
            ("captured, card 0 twice", twice, dict(decode_block_tokens=16))):
        runs[label] = served_run(devices, config, 16, **options)
        gc.collect()
        torch.cuda.empty_cache()
    for label, devices in (("cards 0 and 1", pair), ("card 0 twice", twice)):
        blocks[label] = block_device_ms(devices, config)
        gc.collect()
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()
    print("full-width " + json.dumps({
        "runs": {label: run["metrics"] for label, run in runs.items()},
        "block": {label: {"capture_s": capture, "block_device_ms": ms}
                  for label, (capture, ms) in blocks.items()},
        "cards": card[:2]}), flush=True)
    across = runs["captured, cards 0 and 1"]
    check_replayed(across)
    assert across["streams"] == runs["host loop, cards 0 and 1"]["streams"]
    assert across["streams"] == runs["captured, card 0 twice"]["streams"]
    assert across["launches"] == runs["captured, card 0 twice"]["launches"]
