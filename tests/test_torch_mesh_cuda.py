"""The port's mesh on the card (``parallel/mesh.py``, ``parallel/ring.py``,
``models/long_context.py``, the sharded step of ``models/train.py``,
the continuous batcher on a placed int8 tree): a mesh of distinct cards
computes each position on its own card and hops between cards by peer
copies; the same mesh with one card listed at every position gives the
same numbers (the batcher: the same greedy streams, and its captured
device loop the host loop's).  Imports no JAX, so it runs on the card machine:

    python3 -m pytest --noconftest -q tests/test_torch_mesh_cuda.py

Without a card every test here skips; the tests across cards skip
with fewer than two.  Tolerances, float32: 1e-5 between the two
placements (the same kernels on the same inputs; only cuBLAS's choice
between cards could reorder a sum) and 1e-4 against the dense prefill
(summation order); the loss within 1e-6, each gradient leaf within
1e-5 of its largest magnitude."""

import dataclasses

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.models import llama, train
from aiko_services_tpu_torch.models.batching import (ContinuousBatcher,
                                                     Request)
from aiko_services_tpu_torch.models.checkpoint import flatten
from aiko_services_tpu_torch.models.long_context import (
    make_long_context_forward, make_long_context_loss)
from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                  quantize_specs)
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


def served(devices: list, **options) -> dict:
    """Four greedy requests through a ``ContinuousBatcher`` on the int8
    tree placed over {"tp": 2} on ``devices``, ``cache_put`` placing its
    cache: the token streams."""
    c = serving_config()
    params = quantize_params(llama.init_params(0, c, device=devices[0]))
    mesh_plan = MeshPlan(make_mesh({"tp": 2}, devices))
    placed = mesh_plan.put(params, quantize_specs(llama.partition_specs(c)))
    specs = llama.paged_cache_specs(c) if "kv_page_tokens" in options \
        else llama.cache_specs(c)
    batcher = ContinuousBatcher(
        placed, c, max_slots=4, prefill_chunk=256, device=devices[0],
        cache_put=lambda cache: mesh_plan.put(cache, specs), **options)
    rng = np.random.default_rng(3)
    streams = {}
    for index, length in enumerate((40, 300, 120, 260)):
        streams[index] = []
        batcher.submit(Request(
            str(index), rng.integers(0, 256, length).tolist(),
            max_new_tokens=12,
            emit=lambda rid, token, done: streams[int(rid)].append(token)))
    batcher.run_until_drained(max_steps=400)
    assert all(len(stream) == 12 for stream in streams.values())
    return streams


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


@pytest.mark.cuda
def test_loop_capture_across_cards_refused(several):
    """Capturing the device loop over two cards is refused loudly, never
    run eagerly in its place."""
    with pytest.raises(NotImplementedError, match="2 CUDA cards"):
        served(several[:2], decode_block_tokens=16)
