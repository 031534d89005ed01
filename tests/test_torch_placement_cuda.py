"""Stages over card groups on four distinct cards: the placement sections
of ``__graft_entry__.dryrun_multichip`` -- ``[placement]`` (3),
``[replacement]`` (4), ``[config4]`` (7), ``[stage-pipeline]`` (8),
``[chaos]`` (9), ``[replica-failover]`` (10) and ``[gateway]`` (11) --
through the port
(``tests/torch_placement_sections.py``) with the JAX sections'
assertions, plus what only distinct cards show: each shard of a hop on
its own card, config 4's stages on disjoint cards with the
``Detector``'s graphs on both of its cards and its detections equal to
a run with one card standing for both positions, ``StageWork`` on each
stage's lead card, each replica's output on its own card through a
replica failover, the mixture-of-experts training step over the four
cards bit for bit repeatable, and the time of a hop between cards.  Imports no
JAX, so it runs on the card machine:

    python3 -m pytest --noconftest -q -s tests/test_torch_placement_cuda.py

Every test skips with fewer than four cards.  The hop times print as one
``placement-hops`` JSON line with the card's name and power limit."""

import gc
import json
import subprocess
import time

import numpy as np
import pytest
import torch

import torch_multihost_worker as worker
import torch_placement_sections as sections

from aiko_services_tpu_torch import device as device_rule
from aiko_services_tpu_torch.parallel import P, Placed
from aiko_services_tpu_torch.pipeline.tensor import StagePlacement

#: The same kernels on the same rows: cuDNN may choose another algorithm
#: on another card, so boxes and scores within float rounding of bf16.
DETECT_TOL = 1e-3


@pytest.fixture
def cards() -> list:
    """Four cards of this machine (skips with fewer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    return [torch.device("cuda", index) for index in range(4)]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


@pytest.mark.cuda
def test_placement_and_replacement_sections(cards):
    """Each shard of a spec'd hop lies on its own card of the stage;
    after two cards fail no hop or lead card resolves to a dead card."""
    x = torch.arange(64.0).reshape(8, 8)
    placement, on_detect, on_llm = sections.placement_hops(cards, x)
    assert [shard.device for shard in on_detect.shards] == cards[:2]
    assert [shard.device for shard in on_llm.shards] == cards[2:]
    torch.testing.assert_close(on_llm.gather(cards[2]).cpu(), x, rtol=0,
                               atol=0)
    dead, rehop = sections.replacement_hop(placement, x)
    assert dead == cards[:1]
    assert rehop.device != cards[0]
    torch.testing.assert_close(rehop.cpu(), x, rtol=0, atol=0)


@pytest.mark.cuda
def test_config4_section_on_disjoint_cards(cards, monkeypatch):
    """DET on cards 0-1 (dp), the LLM stage on 2-3 (tp): no card shared,
    the Detector's graphs on both of its cards, both positions in every
    micro-batch, and every frame's detections equal to the same run
    with card 0 standing for both of DET's positions."""
    result = sections.config4(cards)
    assert result["det_devices"] == set(cards[:2])
    assert result["llm_devices"] == set(cards[2:])
    assert result["graph_devices"] == set(cards[:2])
    assert [stats["device"] for stats in result["positions"]] \
        == [str(card) for card in cards[:2]]
    assert all(stats["batches"] == result["micro_batches"]
               for stats in result["positions"])
    assert result["health_failed"] == []

    pool = [cards[0], cards[0], cards[1], cards[1]]
    monkeypatch.setattr(device_rule, "local_devices", lambda: list(pool))
    one = sections.config4(pool)
    assert one["det_devices"] == {cards[0]}
    assert one["graph_devices"] == {cards[0]}
    assert sorted(one["detections"]) == sorted(result["detections"])
    for frame_id, rows in result["detections"].items():
        want = one["detections"][frame_id]
        assert [d["class"] for d in rows] == [d["class"] for d in want]
        for got, expected in zip(rows, want):
            np.testing.assert_allclose(got["box"], expected["box"], rtol=0,
                                       atol=DETECT_TOL)
            assert abs(got["score"] - expected["score"]) <= DETECT_TOL


@pytest.mark.cuda
def test_stage_pipeline_section(cards):
    result = sections.stage_pipeline(cards)
    assert result["detect"] | result["llm"] == set(cards)


@pytest.mark.cuda
def test_stage_work_on_lead_cards(cards):
    """Tensor frames (pinned host memory) hop onto the detect stage's
    lead card, then between cards onto the llm stage's: ``StageWork``
    computes on each lead card, under ``transfer_guard: disallow``."""
    result = sections.stage_pipeline(
        cards, frame=lambda rng: torch.from_numpy(rng.standard_normal(
            (32, 32)).astype(np.float32)).pin_memory())
    assert min(result["llm"], key=lambda d: d.index) == result["llm_lead"]
    for frame_id, sent in enumerate(result["sent"]):
        got = result["results"][frame_id]
        assert isinstance(got, torch.Tensor) \
            and got.device == result["llm_lead"]
        torch.testing.assert_close(got.cpu(), sent * 6.0)


@pytest.mark.cuda
def test_chaos_section(cards):
    result = sections.chaos(cards)
    assert result["killed"] == set(cards[:2])
    assert all(device in cards[2:] for devices in result["stages"].values()
               for device in devices)


@pytest.mark.cuda
def test_replica_failover_section(cards, monkeypatch):
    """The pool lists card 3 twice: the three replicas on cards 0-2, the
    llm on card 3, the spare card 3's second listing.  Tensor frames
    (pinned host memory) hop onto each replica's card, where its
    ``StageWork`` output lies; the kill retires card 1's position only,
    and the rebuild re-carves the four positions left: the replicas on
    cards 0, 2 and 3, the llm on the spare, every reply ``x * 4`` on
    card 3."""
    pool = [*cards, cards[3]]
    monkeypatch.setattr(device_rule, "local_devices", lambda: list(pool))
    result = sections.replica_failover(
        frame=lambda rng: torch.from_numpy(rng.standard_normal(
            (16, 16)).astype(np.float32)).pin_memory())
    assert [device_rule.card_of(entry) for entry in result["pool"]] == pool
    assert result["leads"] == cards[:3]
    assert result["killed"] == {result["pool"][1]}
    assert result["survivors"] == [result["pool"][0], *result["pool"][2:]]
    assert result["rebuilt_leads"] == [cards[0], cards[2], cards[3]]
    assert result["llm_lead"] == cards[3]
    assert result["placed"] == set(result["survivors"])
    # Before the rebuild each replica computes on its own card (a call
    # that began on the old layout; one caught by the rebuild computes
    # where its input was hopped and is replayed); after it, on the
    # re-carved layout.
    before = result["calls"][:result["calls_before_rebuild"]]
    original = [call for call in before if call["stage"] == "detect"
                and call["lead"] == cards[call["replica"]]]
    assert {call["replica"] for call in original} == {0, 1, 2}
    for call in original:
        assert call["device"] == call["lead"], call
    for call in result["calls"][result["calls_before_rebuild"]:]:
        want = result["llm_lead"] if call["stage"] == "llm" \
            else result["rebuilt_leads"][call["replica"]]
        assert call["lead"] == want and call["device"] == want, call
    for sent, got in zip(result["sent"], result["results"]):
        assert got.device == cards[3]
        torch.testing.assert_close(got.cpu(), sent * 4.0, rtol=0, atol=0)


@pytest.mark.cuda
def test_moe_train_step_over_four_cards_is_bitwise_repeatable(cards):
    """Phase 11c's MoE over ``{"ep": 2, "tp": 2}`` on the four cards in
    one process, three steps, twice: the losses and the updated tree's
    checksum equal (each exchange's gradients summed in group order)."""
    first = worker.card_moe(cards)
    gc.collect()
    torch.cuda.empty_cache()
    second = worker.card_moe(cards)
    report = {"card": card_line(), "runs": [first, second]}
    print(f"moe-ep-four-cards {json.dumps(report)}", flush=True)
    assert first["losses"] == second["losses"]
    assert first["checksum"] == second["checksum"]


@pytest.mark.cuda
def test_gateway_section(cards):
    result = sections.gateway(cards)
    assert result["bulk_shed"] >= 1


def _hop_ms(hop, target: torch.device, calls: int = 20) -> float:
    """The median wall time of ``hop()`` to its result on ``target``
    (host clock around the hop and a synchronise of every card)."""
    times = []
    for _ in range(calls + 2):
        torch.cuda.synchronize(target)
        begin = time.perf_counter()
        hop()
        for index in range(torch.cuda.device_count()):
            torch.cuda.synchronize(index)
        times.append((time.perf_counter() - begin) * 1e3)
    return float(np.median(times[2:]))


@pytest.mark.cuda
def test_det_to_llm_hop_between_cards(cards):
    """Frames hop from config 4's DET stage (cards 0-1) to its LLM stage
    (cards 2-3): a tensor on DET's lead card to LLM's lead card, and a
    batch split over DET's dp cards resharded over LLM's tp cards.  The
    values arrive whole; the times print with the card."""
    placement = StagePlacement(cards)
    placement.assign({"DET": {"dp": 2}, "LLM": {"tp": 2}})
    generator = torch.Generator().manual_seed(0)
    rows = {"slate": (8, 32, 7), "frames": (8, 640, 640, 3)}
    out = {"card": card_line(), "cards": torch.cuda.device_count()}
    for name, shape in rows.items():
        x = torch.rand(shape, generator=generator).to(cards[0])
        landed = placement.transfer(x, "LLM")
        assert landed.device == cards[2] and torch.equal(landed.cpu(),
                                                         x.cpu())
        split = placement.transfer(x, "DET", P("dp"))
        assert [shard.device for shard in split.shards] == cards[:2]
        spec = P(None, "tp") if name == "frames" else P(None, None, None)
        moved = placement.transfer(split, "LLM", spec)
        assert isinstance(moved, Placed)
        assert [shard.device for shard in moved.shards] == cards[2:]
        assert torch.equal(moved.gather(cards[2]).cpu(), x.cpu())
        out[f"{name}_mb"] = x.numel() * x.element_size() / 1e6
        out[f"{name}_lead_to_lead_ms"] = _hop_ms(
            lambda: placement.transfer(x, "LLM"), cards[2])
        out[f"{name}_reshard_ms"] = _hop_ms(
            lambda: placement.transfer(split, "LLM", spec), cards[2])
    print(f"placement-hops {json.dumps(out)}", flush=True)
