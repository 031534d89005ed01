"""Stage placement over a pool that lists one device several times (one
card standing for a five-card walk): the replica-failover walk of
``__graft_entry__.dryrun_multichip`` (``[replica-failover]``, 10) with
the JAX section's assertions, on one CPU descriptor listed five times
and on five distinct ones (``tests/torch_placement_sections.py``), and
``drop_replica``, ``replace`` and the health probe retiring the failed
position only.  A pool of distinct devices holds the devices themselves,
as before."""

import numpy as np
import pytest
import torch

import torch_placement_sections as sections
from torch_pipeline_elements import CPU_POOL

from aiko_services_tpu_torch import device as device_rule
from aiko_services_tpu_torch.pipeline.tensor import StagePlacement
from aiko_services_tpu_torch.tpu.health import default_prober, probe_devices

ONE = torch.device("cpu", 0)


@pytest.fixture(params=["one-listed-five-times", "five-distinct"])
def pool(request, monkeypatch) -> list:
    entries = [ONE] * 5 if request.param == "one-listed-five-times" \
        else list(CPU_POOL[:5])
    monkeypatch.setattr(device_rule, "local_devices", lambda: list(entries))
    return entries


def test_replica_failover_section(pool):
    """Kill -> shed -> N-1 -> rebuild -> canary -> N: the killed position
    leaves the pool, the four others hold the three replicas and the
    llm, and every frame is ``x * 2 * 2``."""
    result = sections.replica_failover()
    assert len(result["pool"]) == 5 and len(result["survivors"]) == 4
    (killed,) = result["killed"]
    assert device_rule.card_of(killed) == pool[1]
    assert result["placed"] == set(result["survivors"])
    assert killed not in result["placed"]
    assert result["generation"] == 1          # the rebuild's, not the kill's
    assert result["rebuilds"] >= 1 and result["failover_ms"] > 0
    assert len(result["results"]) == 15
    for sent, got in zip(result["sent"], result["results"]):
        np.testing.assert_array_equal(np.asarray(got), sent * 4.0)
    assert {call["replica"] for call in result["calls"]
            if call["stage"] == "detect"} == {0, 1, 2}


def test_distinct_pool_holds_the_devices():
    placement = StagePlacement(list(CPU_POOL[:5]))
    assert placement.devices == list(CPU_POOL[:5])
    placement.assign({"detect": 1, "llm": 1}, replicas={"detect": 3})
    assert placement.replica_devices("detect", 1) == {CPU_POOL[1]}
    assert placement.drop_replica("detect", 1) == {CPU_POOL[1]}
    assert placement.devices == [CPU_POOL[0], *CPU_POOL[2:5]]


def listed_five_times() -> tuple[StagePlacement, list]:
    placement = StagePlacement([ONE] * 5)
    placement.assign({"detect": 1, "llm": 1}, replicas={"detect": 3})
    slots = list(placement.devices)
    assert [type(slot) for slot in slots] == [device_rule.PoolSlot] * 5
    assert [device_rule.card_of(slot) for slot in slots] == [ONE] * 5
    return placement, slots


def test_drop_replica_retires_its_position_only():
    placement, slots = listed_five_times()
    assert placement.replica_devices("detect", 1) == {slots[1]}
    assert placement.drop_replica("detect", 1) == {slots[1]}
    assert placement.devices == [slots[0], *slots[2:]]
    assert placement.live_replicas("detect") == [0, 2]
    assert placement.stage_devices("detect") == {slots[0], slots[2]}
    assert list(placement.plan("detect").mesh.devices.flat) == [ONE, ONE]
    assert placement.generation == 0
    placement.reassign()                      # the background rebuild
    assert placement.live_replicas("detect") == [0, 1, 2]
    assert [placement.replica_devices("detect", index)
            for index in range(3)] == [{slots[0]}, {slots[2]}, {slots[3]}]
    assert placement.stage_devices("llm") == {slots[4]}     # the spare


def test_replace_retires_one_position_or_every_listing_of_a_card():
    placement, slots = listed_five_times()
    placement.replace(placement.replica_devices("detect", 1))
    assert placement.devices == [slots[0], *slots[2:]]
    assert placement.generation == 1
    assert placement.replica_total("detect") == 3
    assert placement.stage_devices("llm") == {slots[4]}
    assert all(plan.device == ONE for plan in placement.plans.values())
    with pytest.raises(RuntimeError, match="no surviving devices"):
        placement.replace({ONE})               # the card itself failed


def test_health_probe_names_the_failed_position():
    placement, slots = listed_five_times()
    assert default_prober(slots[3])
    failed = probe_devices(placement.devices,
                           lambda entry: entry != slots[2])
    assert failed == [slots[2]]
