"""The port's data plane: twins of ``tests/test_tensor.py``'s JitCache,
StagePlacement, replica, ``tree_device_put``, codec and
definition-placement tests, on the eight-CPU device pool
(``torch_pipeline_elements.cpu_pool``), plus the port's own: the
residency rule of CPU descriptors, a plan over several cards (its lead
card, resolved without a call to a card), and the cache's counts under
threads."""

import queue

import numpy as np
import pytest
import torch

from conftest import run_until
from torch_pipeline_elements import CPU_POOL, cpu_pool  # noqa: F401

from aiko_services_tpu_torch.parallel import MeshPlan, Placed, make_mesh
from aiko_services_tpu_torch.pipeline import Pipeline
from aiko_services_tpu_torch.pipeline.tensor import (
    JitCache, ShapeBucketer, StagePlacement, decode_array, encode_array,
    resident, tree_device_put)

ELEMENTS = "tests/torch_pipeline_elements.py"


@pytest.fixture
def runtime():
    """Fresh isolated process runtime of the port on its in-memory
    loopback broker."""
    from aiko_services_tpu_torch.transport import reset_broker
    from aiko_services_tpu_torch.runtime import init_process, reset_process
    from aiko_services_tpu_torch.services.share import reset_services_cache

    reset_broker()
    reset_services_cache()
    rt = init_process(transport="loopback")
    rt.initialize()
    yield rt
    rt.engine.terminate()
    reset_process()
    reset_services_cache()
    reset_broker()


def element(name, cls, inputs, outputs, parameters=None):
    return {"name": name,
            "input": [{"name": n} for n in inputs],
            "output": [{"name": n} for n in outputs],
            "deploy": {"local": {"module": ELEMENTS, "class_name": cls}},
            "parameters": parameters or {}}


def definition(graph, elements, name="p_tensor"):
    return {"version": 0, "name": name, "runtime": "torch", "graph": graph,
            "parameters": {}, "elements": elements}


# -- JitCache ---------------------------------------------------------------

def test_jit_cache_hits_and_misses():
    cache = JitCache()
    fn = cache(lambda x: x * 2)
    fn(torch.ones((4,)))
    fn(torch.ones((4,)))        # same signature -> hit
    fn(torch.ones((8,)))        # new shape -> miss
    assert cache.stats == {"hits": 1, "misses": 2, "entries": 2,
                           "signatures": 2}
    fn(torch.ones((8,), dtype=torch.float64))   # new dtype -> miss
    fn(torch.ones((8,)), _cache_context=1)      # new context -> miss
    assert cache.probe(fn.fn, (torch.ones((8,)),), context=1) is False
    assert cache.probe(fn.fn, (torch.ones((9,)),)) is True
    assert (cache.hits, cache.misses, cache.entries) == (1, 4, 4)


def test_jit_cache_bucketed_no_recompile():
    """Bucketing keeps ragged lengths on one compiled signature."""
    cache = JitCache()
    bucketer = ShapeBucketer(buckets=[8])
    fn = cache(lambda x: x.sum())
    for n in (3, 5, 7):
        padded, _ = bucketer.pad(torch.ones((n,)))
        fn(padded)
    assert cache.stats["signatures"] == 1


def test_jit_cache_keys_on_tree_structure_and_host_leaves():
    cache = JitCache()
    fn = cache(lambda tree, scale: {name: value * scale
                                    for name, value in tree.items()})
    out = fn({"a": torch.ones(2)}, 2.0)
    fn({"a": torch.ones(2)}, 2.0)                   # hit
    fn({"a": torch.ones(2), "b": torch.ones(2)}, 2.0)   # new structure
    fn({"a": torch.ones(2)}, 3.0)                   # new host leaf
    assert (cache.hits, cache.misses) == (1, 3)
    assert out["a"].tolist() == [2.0, 2.0]


def test_jit_cache_counts_hold_under_threads():
    """Calls from more threads than cores, with a short switch
    interval: every call counts once as a hit or a miss, and each
    signature misses once."""
    import sys
    import threading
    cache = JitCache()
    fn = cache(lambda x: x + 1)
    threads, calls, sizes = 16, 50, (1, 2, 3, 4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [fn(torch.ones(sizes[i % len(sizes)]))
                            for i in range(calls)]) for _ in range(threads)]
        for worker in workers:
            worker.start()
        for worker in workers:
            worker.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(worker.is_alive() for worker in workers)
    assert cache.hits + cache.misses == threads * calls
    assert (cache.misses, cache.entries) == (len(sizes), len(sizes))


# -- StagePlacement ---------------------------------------------------------

def test_stage_placement_disjoint_submeshes(cpu_pool):
    placement = StagePlacement(cpu_pool)
    plans = placement.assign({"detect": {"dp": 2},
                              "llm": {"tp": 4},
                              "post": 2})
    all_devices = []
    for plan in plans.values():
        all_devices += list(plan.mesh.devices.flat)
    assert len(all_devices) == 8
    assert len(set(all_devices)) == 8          # disjoint
    assert dict(plans["llm"].mesh.shape) == {"tp": 4}
    assert plans["llm"].device == cpu_pool[2]
    # The default pool is device.local_devices().
    assert StagePlacement().devices == cpu_pool


def test_stage_placement_overflow_rejected(cpu_pool):
    placement = StagePlacement(cpu_pool)
    with pytest.raises(ValueError, match="want"):
        placement.assign({"a": 8, "b": 1})


def test_stage_transfer_reshards(cpu_pool):
    """A hop with a spec places a tensor over the stage's mesh (each
    position its shard); a placed value hopping to another stage is
    resharded, and one already laid out there by the same spec passes
    through.  With no spec a value lands whole on the lead card."""
    placement = StagePlacement(cpu_pool)
    placement.assign({"a": {"dp": 4}, "b": {"tp": 4}})
    x = torch.arange(16.0).reshape(4, 4)
    on_a = placement.transfer(x, "a", "dp", None)
    on_b = placement.transfer(on_a, "b", None, "tp")
    assert isinstance(on_a, Placed) and isinstance(on_b, Placed)
    assert [tuple(t.shape) for t in on_a.shards] == [(1, 4)] * 4
    assert [tuple(t.shape) for t in on_b.shards] == [(4, 1)] * 4
    assert dict(on_b.mesh.shape) == {"tp": 4}
    assert list(on_b.mesh.devices.flat) == cpu_pool[4:]
    np.testing.assert_array_equal(
        placement.plan("b").gather(on_b).numpy(), x.numpy())
    assert placement.stage_sharding("b") == cpu_pool[4]
    assert (placement.transfer_puts, placement.transfer_skipped) == (2, 0)
    assert placement.transfer(on_b, "b", None, "tp") is on_b
    whole = placement.transfer(on_b, "b")
    np.testing.assert_array_equal(whole.numpy(), x.numpy())
    # A CPU tensor is resident on every CPU descriptor: the hop skips.
    assert placement.transfer(whole, "a") is whole
    assert (placement.transfer_puts, placement.transfer_skipped) == (3, 2)
    host = placement.transfer({"image": np.ones((2, 2)), "text": "t"}, "b")
    assert isinstance(host["image"], np.ndarray) and host["text"] == "t"
    assert placement.stats["transfer_skipped"] == 2


def test_tree_device_put(cpu_pool):
    plan = MeshPlan(make_mesh({"dp": 4}, cpu_pool[:4]))
    tree = {"x": torch.ones((8, 2)), "host": np.ones((4, 3), np.float32),
            "meta": "keep-me"}
    placed = tree_device_put(tree, plan, ("dp", None))
    assert placed["meta"] == "keep-me"
    assert isinstance(placed["host"], Placed)
    assert [tuple(t.shape) for t in placed["host"].shards] == [(1, 3)] * 4
    assert [tuple(t.shape) for t in placed["x"].shards] == [(2, 2)] * 4
    np.testing.assert_array_equal(plan.gather(placed["x"]).numpy(),
                                  tree["x"].numpy())
    whole = tree_device_put(tree, plan)
    assert isinstance(whole["host"], torch.Tensor)
    assert whole["x"] is tree["x"]              # already resident
    assert dict(plan.mesh.shape) == {"dp": 4} and plan.mesh.size == 4


def test_local_devices_are_the_cards_and_raise_without_one():
    """``device.local_devices()`` -- the pool placement carves -- is
    every card; with none it raises, as ``resolve_device`` does, so a
    placed stage never lands on the host in silence."""
    from aiko_services_tpu_torch import device as device_rule
    if torch.cuda.is_available():
        assert device_rule.local_devices() == [
            torch.device("cuda", index)
            for index in range(torch.cuda.device_count())]
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_rule.local_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StagePlacement()


def test_resident_rule():
    assert resident(torch.ones(1), torch.device("cpu", 5))
    assert resident(torch.ones(1), torch.device("cpu"))
    assert not resident(torch.ones(1), torch.device("cuda", 0))


def test_plan_over_two_cards_raises_at_put_without_touching_a_card():
    """A stage over two CUDA descriptors resolves its lead card, the
    first of its chunk, and a frame of host values hops onto it without
    a call to any card -- so here, where there is no card, it hops the
    same.  (The name is kept from when such a plan raised.)"""
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    placement = StagePlacement(cards)
    placement.assign({"llm": {"tp": 2}})
    assert placement.stage_sharding("llm") == cards[0]
    assert placement.plan("llm").replicated() == cards[0]
    assert placement.plan("llm").shard("tp").device == cards[0]
    frame = {"text": "a caption", "image": np.ones((2, 2), np.uint8),
             "detections": [{"class": "dog"}]}
    hopped = placement.transfer(frame, "llm")
    assert hopped["text"] == "a caption"
    assert hopped["image"] is frame["image"]
    assert hopped["detections"] == frame["detections"]
    assert (placement.transfer_puts, placement.transfer_skipped) == (0, 0)
    assert tree_device_put({"meta": "t"}, placement.plan("llm")) \
        == {"meta": "t"}
    one = MeshPlan(make_mesh({"dp": 1}, cards[1:]))
    assert one.replicated() == cards[1]


# -- replicated stages ------------------------------------------------------

def test_replica_carve_splits_stage_into_disjoint_submeshes(cpu_pool):
    placement = StagePlacement(cpu_pool)
    placement.assign({"detect": "auto", "llm": 2},
                     replicas={"detect": 3})
    subs = placement.replica_plans["detect"]
    assert len(subs) == 3
    owned = [d for plan in subs for d in plan.mesh.devices.flat]
    assert len(owned) == len(set(owned)) == 6   # disjoint, 8 - llm's 2
    # The whole-stage plan spans every replica's chips as one dp pool.
    assert set(placement.plans["detect"].mesh.devices.flat) == set(owned)
    assert placement.live_replicas("detect") == [0, 1, 2]
    for device in subs[1].mesh.devices.flat:
        assert placement.replica_of("detect", device) == 1


def test_replica_fixed_request_describes_one_replica(cpu_pool):
    placement = StagePlacement(cpu_pool)
    placement.assign({"detect": {"dp": 2}}, replicas={"detect": 3})
    for plan in placement.replica_plans["detect"]:
        assert dict(plan.mesh.shape) == {"dp": 2}
    assert placement.plans["detect"].mesh.devices.size == 6


def test_replica_overflow_rejected(cpu_pool):
    placement = StagePlacement(cpu_pool)
    with pytest.raises(ValueError, match="want"):
        placement.assign({"detect": {"dp": 2}}, replicas={"detect": 5})


def test_drop_replica_retires_one_submesh_without_touching_peers(cpu_pool):
    placement = StagePlacement(cpu_pool)
    placement.assign({"detect": "auto"}, replicas={"detect": 4})
    before = [set(plan.mesh.devices.flat)
              for plan in placement.replica_plans["detect"]]
    placement.stage_sharding("detect", replica=0)
    epoch = placement.replica_epoch
    dead = placement.drop_replica("detect", 2)
    assert dead == before[2]
    # Peers keep their EXACT submeshes -- no generation bump, no
    # re-carve; only the replica epoch moves (per-replica caches).
    assert placement.generation == 0
    assert placement.replica_epoch == epoch + 1
    for index in (0, 1, 3):
        assert set(placement.replica_plans["detect"][index]
                   .mesh.devices.flat) == before[index]
    assert placement.replica_plans["detect"][2] is None
    assert placement.live_replicas("detect") == [0, 1, 3]
    # The dead devices left the pool and the stage-wide plan.
    assert not set(placement.devices) & dead
    assert not set(placement.plans["detect"].mesh.devices.flat) & dead
    # Stage placements were invalidated (stale submesh memo).
    assert not placement._shardings
    # Dropping again is a no-op.
    assert placement.drop_replica("detect", 2) == set()


def test_reassign_restores_desired_replica_count(cpu_pool):
    placement = StagePlacement(cpu_pool)
    placement.assign({"detect": 1}, replicas={"detect": 3},
                     replica_min={"detect": 1})
    placement.drop_replica("detect", 1)
    assert len(placement.live_replicas("detect")) == 2
    generation = placement.generation
    placement.reassign()
    # 8-device pool minus the retired one still fits 3x1.
    assert len(placement.live_replicas("detect")) == 3
    assert placement.generation == generation + 1


def test_replace_sheds_replicas_before_halving_fixed_axes(cpu_pool):
    placement = StagePlacement(cpu_pool)
    placement.assign({"detect": {"dp": 2}, "llm": {"tp": 2}},
                     replicas={"detect": 3}, replica_min={"detect": 1})
    # Kill 4 devices: 4 survivors cannot hold 3x2 + 2, so detect sheds
    # replicas down to 1 (2 devices) before llm's tp axis halves.
    placement.replace(placement.devices[:4])
    assert len(placement.live_replicas("detect")) == 1
    assert dict(placement.plans["llm"].mesh.shape) == {"tp": 2}


def test_set_replicas_validates_and_floors(cpu_pool):
    placement = StagePlacement(cpu_pool)
    placement.assign({"detect": 1}, replicas={"detect": 2},
                     replica_min={"detect": 2})
    with pytest.raises(KeyError):
        placement.set_replicas("llm", 3)
    placement.set_replicas("detect", 1)     # floored at replica_min
    placement.reassign()
    assert len(placement.live_replicas("detect")) == 2
    placement.set_replicas("detect", 4)
    placement.reassign()
    assert len(placement.live_replicas("detect")) == 4


def test_replica_transfer_lands_on_one_submesh(cpu_pool):
    placement = StagePlacement(cpu_pool)
    placement.assign({"detect": 2}, replicas={"detect": 2})
    x = torch.arange(16.0).reshape(4, 4)
    on_one = placement.transfer(x, "detect", replica=1)
    assert placement.stage_sharding("detect", replica=1) \
        in placement.replica_devices("detect", 1)
    np.testing.assert_array_equal(on_one.numpy(), x.numpy())


# -- host codec -------------------------------------------------------------

def test_array_codec_roundtrip():
    x = np.random.default_rng(0).standard_normal((3, 5)).astype("float32")
    decoded = decode_array(encode_array(torch.from_numpy(x)))
    np.testing.assert_array_equal(decoded.numpy(), x)
    assert decoded.numpy().dtype == x.dtype


# -- definition-driven stage placement --------------------------------------

def test_definition_placement_two_stage_pipeline(runtime, cpu_pool):
    """A definition file expresses a two-stage pipeline: each element's
    ``placement`` block lands it on a disjoint device group, and frames
    hop stages via StagePlacement.transfer."""
    scale_def = element("Scale", "TensorScale", ["x"], ["x"],
                        {"factor": 3.0})
    scale_def["placement"] = {"mesh": {"dp": 4}}
    sum_def = element("Sum", "TensorSum", ["x"], ["total"])
    sum_def["placement"] = {"mesh": {"tp": 4}}
    pipeline = Pipeline(definition(["(Scale Sum)"],
                                   [scale_def, sum_def]),
                        runtime=runtime)

    placement = pipeline.stage_placement
    assert placement is not None
    assert dict(placement.plan("Scale").mesh.shape) == {"dp": 4}
    assert dict(placement.plan("Sum").mesh.shape) == {"tp": 4}
    scale_devices = set(placement.plan("Scale").mesh.devices.flat)
    sum_devices = set(placement.plan("Sum").mesh.devices.flat)
    assert not scale_devices & sum_devices        # disjoint groups

    responses = queue.Queue()
    pipeline.process_frame_local({"x": torch.ones((4, 4))},
                                 queue_response=responses)
    run_until(runtime, lambda: not responses.empty())
    _, _, swag, _, okay, diagnostic = responses.get()
    assert okay, diagnostic
    assert float(swag["total"]) == 48.0
    # Each element resolved ITS stage's mesh, not the local default.
    assert dict(pipeline.graph.get_node("Scale").element.plan.mesh.shape) \
        == {"dp": 4}
    assert dict(pipeline.graph.get_node("Sum").element.plan.mesh.shape) \
        == {"tp": 4}
    assert pipeline.graph.get_node("Sum").element.plan.device == CPU_POOL[4]


def test_definition_placement_overflow_rejected(runtime, cpu_pool):
    """Placement blocks requesting more devices than exist fail at
    construction, not at frame time."""
    scale_def = element("Scale", "TensorScale", ["x"], ["x"])
    scale_def["placement"] = {"devices": 8}
    sum_def = element("Sum", "TensorSum", ["x"], ["total"])
    sum_def["placement"] = {"devices": 4}
    with pytest.raises(ValueError, match="want"):
        Pipeline(definition(["(Scale Sum)"], [scale_def, sum_def]),
                 runtime=runtime)


# -- tensor frames through a real pipeline ----------------------------------

def test_tensor_pipeline_end_to_end(runtime, cpu_pool):
    """Tensors flow through placed elements; the compiled cache is
    reused across frames."""
    pipeline = Pipeline(definition(
        ["(Scale Sum)"],
        [element("Scale", "TensorScale", ["x"], ["x"],
                 {"factor": 3.0}),
         element("Sum", "TensorSum", ["x"], ["total"])]),
        runtime=runtime)

    def run_frame(value):
        responses = queue.Queue()
        pipeline.process_frame_local({"x": value},
                                     queue_response=responses)
        run_until(runtime, lambda: not responses.empty())
        _, _, swag, _, okay, diagnostic = responses.get()
        assert okay, diagnostic
        return swag

    swag = run_frame(torch.ones((4, 4)))
    assert float(swag["total"]) == 48.0
    swag = run_frame(torch.ones((4, 4)) * 2)
    assert float(swag["total"]) == 96.0

    scale = pipeline.graph.get_node("Scale").element
    assert scale.jit_cache.stats["hits"] >= 1
    assert scale.jit_cache.stats["signatures"] == 1
    # Unplaced, the element resolves the whole local pool.
    assert dict(scale.plan.mesh.shape) == {"dp": 8}
    assert scale.metrics()["mesh"] == {"dp": 8}
