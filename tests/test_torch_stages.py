"""The port's stage-parallel execution over placed submeshes: twins of
``tests/test_stages.py`` -- per-stage admission windows, stage-worker
overlap of synchronous placed stages, in-order per-stream delivery,
topology/profile-aware placement, memoized async stage hops,
remote-retry backoff, replicas and autoscaling, and replace() under
stage-parallel flight -- on the eight-CPU device pool
(``torch_pipeline_elements.cpu_pool``)."""

import queue
import time

import numpy as np
import pytest
import torch

from conftest import run_until
from test_torch_llm_element import _port_runtime, _port_teardown
from torch_pipeline_elements import CPU_POOL, cpu_pool  # noqa: F401

from aiko_services_tpu_torch.pipeline import Pipeline
from aiko_services_tpu_torch.pipeline.stages import StageScheduler
from aiko_services_tpu_torch.pipeline.tensor import (StagePlacement,
                                                     device_sort_key,
                                                     resident)


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


@pytest.fixture(autouse=True)
def _device_pool(cpu_pool):
    """Every placement here carves the eight CPU descriptors."""
    return cpu_pool


COMMON = "aiko_services_tpu_torch.elements.common"

import threading

from aiko_services_tpu_torch.pipeline import PipelineElement, StreamEvent


class SlowAsync(PipelineElement):
    """Async element tracking its peak concurrent parked frames --
    loaded by module path ("tests/test_torch_stages.py")."""

    is_async = True
    _lock = threading.Lock()
    inflight = 0
    peak = 0

    def process_frame(self, stream, x=None):
        return StreamEvent.OKAY, {"x": x}

    def process_frame_start(self, stream, complete, x=None):
        with SlowAsync._lock:
            SlowAsync.inflight += 1
            SlowAsync.peak = max(SlowAsync.peak, SlowAsync.inflight)

        def work():
            time.sleep(0.05)
            with SlowAsync._lock:
                SlowAsync.inflight -= 1
            complete(StreamEvent.OKAY, {"x": x})

        threading.Thread(target=work, daemon=True).start()


def element(name, cls, inputs, outputs, parameters=None, placement=None,
            module=COMMON):
    definition = {"name": name,
                  "input": [{"name": n} for n in inputs],
                  "output": [{"name": n} for n in outputs],
                  "deploy": {"local": {"module": module,
                                       "class_name": cls}},
                  "parameters": parameters or {}}
    if placement:
        definition["placement"] = placement
    return definition


def two_stage_definition(busy_a=20.0, busy_b=20.0, parameters=None,
                         devices_a=4, devices_b=4):
    return {
        "version": 0, "name": "p_stages", "runtime": "torch",
        "graph": ["(detect llm)"],
        "parameters": dict(parameters or {}),
        "elements": [
            element("detect", "StageWork", ["x"], ["x"],
                    {"busy_ms": busy_a, "factor": 2.0},
                    {"devices": devices_a}),
            element("llm", "StageWork", ["x"], ["x"],
                    {"busy_ms": busy_b, "factor": 3.0},
                    {"devices": devices_b}),
        ]}


def pump_and_drain(runtime, pipeline, n_frames, stream_id="s",
                   timeout=30.0):
    responses = queue.Queue()
    for i in range(n_frames):
        pipeline.process_frame_local(
            {"x": np.full((8, 8), float(i + 1), np.float32)},
            stream_id=stream_id, queue_response=responses)
    collected = []

    def drained():
        while not responses.empty():
            collected.append(responses.get())
        return len(collected) >= n_frames

    assert run_until(runtime, drained, timeout=timeout), \
        f"only {len(collected)}/{n_frames} frames completed"
    return collected


# -- the tentpole: cross-stage pipelining -----------------------------------

def test_two_stage_overlap_and_in_order_delivery(runtime):
    """Steady state: frame k+1's detect span starts BEFORE frame k's llm
    span ends (both stages concurrently busy), while responses arrive in
    ingest order."""
    pipeline = Pipeline(two_stage_definition(), runtime=runtime)
    assert pipeline.stage_scheduler is not None
    collected = pump_and_drain(runtime, pipeline, 6)

    frame_ids = [row[1] for row in collected]
    assert frame_ids == sorted(frame_ids), \
        f"delivery out of ingest order: {frame_ids}"
    for *_, okay, diagnostic in collected:
        assert okay, diagnostic
    spans = {}
    for _, frame_id, _swag, metrics, *_ in collected:
        spans[frame_id] = metrics
    overlaps = 0
    for k in range(len(spans) - 1):
        llm_end = spans[k]["llm_time_start"] + spans[k]["llm_time"]
        if spans[k + 1]["detect_time_start"] < llm_end:
            overlaps += 1
    assert overlaps >= 2, (
        f"no cross-stage overlap: detect(k+1) never started before "
        f"llm(k) ended ({overlaps} overlaps in {len(spans)} frames)")
    # Occupancy accounting saw both stages busy.
    stats = pipeline.stage_stats()
    assert stats["detect"]["admitted"] >= 6
    assert stats["llm"]["admitted"] >= 6
    assert stats["detect"]["occupancy"] > 0
    assert stats["llm"]["occupancy"] > 0
    pipeline.stop()


def test_stage_pipeline_throughput_vs_serial_walk(runtime):
    """The acceptance ratio: stage-parallel fps >= 1.5x the serial
    stage-walk baseline (``stage_pipeline: off``) on the synthetic
    two-stage workload -- throughput approaches the slower stage's solo
    rate instead of the sum of both stages."""
    frames = 12

    def run_mode(mode, name):
        definition = two_stage_definition(
            busy_a=25.0, busy_b=25.0,
            parameters={"stage_pipeline": mode})
        definition["name"] = name
        pipeline = Pipeline(definition, runtime=runtime)
        pump_and_drain(runtime, pipeline, 2, stream_id="warm")  # warm jit
        start = time.perf_counter()
        pump_and_drain(runtime, pipeline, frames, stream_id="timed")
        elapsed = time.perf_counter() - start
        pipeline.stop()
        return frames / elapsed

    serial_fps = run_mode("off", "p_serial")
    pipelined_fps = run_mode("auto", "p_pipelined")
    assert pipelined_fps >= 1.5 * serial_fps, (
        f"stage pipelining {pipelined_fps:.1f} fps vs serial "
        f"{serial_fps:.1f} fps: below the 1.5x acceptance ratio")


def test_stage_admission_window_bounds_inflight(runtime):
    """depth=1: at most one frame inside each stage at a time, queued
    frames counted, and everything still completes in order."""
    # llm deliberately slower than detect so frames always ARRIVE at a
    # still-busy llm window (a symmetric split would race the release).
    pipeline = Pipeline(two_stage_definition(
        busy_a=5.0, busy_b=20.0,
        parameters={"stage_inflight": 1}), runtime=runtime)
    assert pipeline.stage_scheduler.depth == 1
    collected = pump_and_drain(runtime, pipeline, 5)
    assert [row[1] for row in collected] == sorted(
        row[1] for row in collected)
    stats = pipeline.stage_stats()
    for stage in ("detect", "llm"):
        assert stats[stage]["active"] == 0          # all released
        assert stats[stage]["admitted"] >= 5
    assert stats["llm"]["queued"] >= 1, \
        "a full depth-1 window never queued a frame"
    pipeline.stop()


def test_single_placed_stage_has_no_scheduler(runtime):
    """One placed stage has nothing to overlap with: the per-element
    path (and immediate responses) stay exactly as before."""
    definition = {
        "version": 0, "name": "p_single", "runtime": "torch",
        "graph": ["(only)"],
        "elements": [element("only", "StageWork", ["x"], ["x"],
                             {"factor": 2.0}, {"devices": 4})]}
    pipeline = Pipeline(definition, runtime=runtime)
    assert pipeline.stage_scheduler is None
    collected = pump_and_drain(runtime, pipeline, 2)
    assert all(okay for *_, okay, _d in collected)
    pipeline.stop()


def test_stage_local_fused_segment_runs_on_stage_worker(runtime):
    """A fusable device chain AFTER a placed head fuses stage-locally
    (segment.stage_context = the head's stage) and dispatches on that
    stage's worker thread -- one fused dispatch per frame, results
    identical to per-element, delivery in order."""
    definition = {
        "version": 0, "name": "p_fused_stage", "runtime": "torch",
        "graph": ["(detect llm dbl inc)"],
        "parameters": {"transfer_guard": "disallow"},
        "elements": [
            element("detect", "StageWork", ["x"], ["x"],
                    {"busy_ms": 5.0, "factor": 2.0}, {"devices": 4}),
            element("llm", "StageWork", ["x"], ["x"],
                    {"busy_ms": 5.0, "factor": 3.0}, {"devices": 4}),
            element("dbl", "DeviceDouble", ["x"], ["x"],
                    module="tests/test_torch_fusion.py"),
            element("inc", "DeviceAddOne", ["x"], ["x"],
                    module="tests/test_torch_fusion.py"),
        ]}
    pipeline = Pipeline(definition, runtime=runtime)
    collected = pump_and_drain(runtime, pipeline, 4)
    assert [row[1] for row in collected] == [0, 1, 2, 3]
    for _, frame_id, swag, metrics, okay, diagnostic in collected:
        assert okay, diagnostic
        expected = (frame_id + 1) * 2.0 * 3.0 * 2.0 + 1.0
        np.testing.assert_allclose(np.asarray(swag["x"])[0, 0], expected)
        assert metrics.get("fused_segments") == 1
    assert len(pipeline.fused_segments) == 1
    segment = pipeline.fused_segments[0]
    assert segment.stage_context == "llm"
    assert segment.calls == 4
    assert not segment.broken
    # The segment dispatched on the llm stage's worker, not the loop.
    worker = pipeline.stage_scheduler.executor("llm")
    assert worker.executed >= 4
    pipeline.stop()


# -- topology- and profile-aware placement ----------------------------------

def test_devices_sorted_by_coords_with_id_fallback():
    class FakeDevice:
        def __init__(self, id, coords=None):
            self.id = id
            self.coords = coords

    a = FakeDevice(3, (1, 0, 0))
    b = FakeDevice(1, (0, 1, 0))
    c = FakeDevice(2, (0, 0, 0))
    placement = StagePlacement([a, b, c])
    assert placement.devices == [c, b, a]       # coords order, not id
    plain = StagePlacement([FakeDevice(2), FakeDevice(0), FakeDevice(1)])
    assert [d.id for d in plain.devices] == [0, 1, 2]
    # CPU descriptors sort by index (no coords) and stay stable.
    placement = StagePlacement(list(reversed(list(CPU_POOL))))
    assert [d.index for d in placement.devices] == list(range(8))


def test_auto_split_equal_until_profiled():
    placement = StagePlacement(list(CPU_POOL))
    plans = placement.assign({"a": "auto", "b": "auto"})
    assert {name: plan.mesh.devices.size
            for name, plan in plans.items()} == {"a": 4, "b": 4}


def test_auto_split_proportional_to_cost_and_rebalanced_on_replace():
    placement = StagePlacement(list(CPU_POOL))
    placement.assign({"a": "auto", "b": "auto"},
                     costs={"a": 0.010, "b": 0.030})
    sizes = {name: plan.mesh.devices.size
             for name, plan in placement.plans.items()}
    assert sizes == {"a": 2, "b": 6}
    # Two of b's chips die: the auto split re-balances over the 6
    # survivors with the same 1:3 profile.
    dead = list(placement.plans["b"].mesh.devices.flat)[:2]
    placement.replace(dead)
    sizes = {name: plan.mesh.devices.size
             for name, plan in placement.plans.items()}
    assert sum(sizes.values()) == 6
    assert sizes["b"] > sizes["a"]
    assert placement.generation == 1


def test_auto_split_with_fixed_stage():
    placement = StagePlacement(list(CPU_POOL))
    plans = placement.assign({"fixed": {"tp": 2}, "x": "auto",
                              "y": "auto"})
    assert plans["fixed"].mesh.shape["tp"] == 2
    assert plans["x"].mesh.devices.size + plans["y"].mesh.devices.size \
        == 6


def test_auto_split_overflow_rejected():
    placement = StagePlacement(list(CPU_POOL))
    with pytest.raises(ValueError, match="want"):
        placement.assign({"fixed": 8, "auto_stage": "auto"})


# -- memoized, resident-skipping stage hops ---------------------------------

def test_transfer_memoizes_shardings_and_skips_resident_leaves():
    placement = StagePlacement(list(CPU_POOL))
    placement.assign({"a": {"dp": 4}, "b": {"dp": 4}})
    x = torch.ones((8, 8))
    on_b = placement.transfer(x, "b")
    puts = placement.transfer_puts
    cached = len(placement._shardings)
    assert cached == 1
    # Same stage again: sharding memo hit, and the already-resident
    # leaf passes through untouched (no device_put walk).
    again = placement.transfer(on_b, "b")
    assert again is not None
    assert placement.transfer_puts == puts          # nothing moved
    assert placement.transfer_skipped >= 1
    assert len(placement._shardings) == cached
    # Hopping to the OTHER stage is a real move on cards; a CPU tensor
    # is resident on every CPU descriptor, so here nothing moves.
    on_a = placement.transfer(on_b, "a")
    assert placement.transfer_puts == puts
    np.testing.assert_array_equal(np.asarray(on_a), np.asarray(x))


def test_transfer_sharding_cache_invalidated_by_replace():
    placement = StagePlacement(list(CPU_POOL))
    placement.assign({"a": {"dp": 4}, "b": {"dp": 4}})
    before = placement.transfer(torch.ones((4, 4)), "b")
    placement.replace(list(placement.plans["a"].mesh.devices.flat)[:2])
    after = placement.transfer(before, "b")
    survivors = set(placement.devices)
    # A tensor carries no sharding: the stage's plan names the device
    # it lands on, and the memo is keyed by the new generation.
    assert set(placement.plans["b"].mesh.devices.flat) <= survivors
    assert resident(after, placement.plans["b"].device)
    assert any(key[2] == placement.generation == 1
               for key in placement._shardings)


# -- remote-stage retry backoff ---------------------------------------------

def test_remote_retry_exponential_backoff(runtime):
    from aiko_services_tpu_torch.services import Registrar

    Registrar(runtime=runtime, primary_search_timeout=0.05)
    front = Pipeline(
        {"version": 0, "name": "front_backoff", "runtime": "torch",
         "graph": ["(inc fwd)"],
         "elements": [
             element("inc", "Increment", ["x"], ["x"]),
             {"name": "fwd", "input": [{"name": "x"}],
              "output": [{"name": "x"}],
              "deploy": {"remote": {"name": "never_appears"}}}]},
        runtime=runtime)
    responses = queue.Queue()
    front.create_stream_local("1", queue_response=responses)
    front.ingest_local("1", {"x": 0}, queue_response=responses)
    runtime.run(timeout=1.8)
    frame = front.streams["1"].frames[0]
    # Fixed 0.25 s retries would have fired ~7 times by 1.8 s; backoff
    # (0.25, 0.5, 1.0, ...) fires at most 4 -- and the count is VISIBLE
    # on the share dict, not a silent hot loop.
    assert 1 <= frame.remote_retries <= 4, frame.remote_retries
    assert front.share["remote_stage_retries"] == frame.remote_retries
    assert frame.metrics["remote_retries"] == frame.remote_retries
    assert front.streams["1"].in_flight == 1        # still parked
    front.stop()


# -- replace() under stage-parallel flight ----------------------------------

def test_replace_under_stage_parallel_execution(runtime):
    """Chips die between bursts of a stage-parallel stream: in-flight
    frames complete (or error) cleanly, and frames after the
    replacement run on the NEW generation's submeshes -- never against
    a stale mesh."""
    pipeline = Pipeline(two_stage_definition(busy_a=5.0, busy_b=5.0),
                        runtime=runtime)
    placement = pipeline.stage_placement
    collected = pump_and_drain(runtime, pipeline, 4)
    assert all(okay for *_, okay, _d in collected)
    assert placement.generation == 0

    detect_devices = list(placement.plans["detect"].mesh.devices.flat)
    dead = set(detect_devices[:2])
    failed = pipeline.check_device_health(prober=lambda d: d not in dead)
    assert set(failed) == dead
    assert placement.generation == 1

    collected = pump_and_drain(runtime, pipeline, 4, stream_id="s2")
    for *_, okay, diagnostic in collected:
        assert okay, diagnostic
    survivors = set(placement.devices)
    assert not survivors & dead
    for stage in ("detect", "llm"):
        assert set(placement.plans[stage].mesh.devices.flat) <= survivors
    for _, _fid, swag, metrics, *_ in collected:
        # A frame's leaves carry no sharding in the port: the stage
        # generation each hop ran under says which mesh it used.
        assert metrics["stage_detect_generation"] == 1, \
            "frame ran against a stale (pre-replacement) mesh"
        assert metrics["stage_llm_generation"] == 1
    # The new generation's hops filled a fresh sharding cache
    # (key = (stage, replica, generation, spec)).
    assert all(key[2] == 1 for key in placement._shardings)
    pipeline.stop()


def test_replace_midflight_frames_never_use_stale_mesh(runtime):
    """Frames IN FLIGHT across the replacement: every output that
    completes after the swap is resident on surviving devices only."""
    pipeline = Pipeline(two_stage_definition(busy_a=15.0, busy_b=15.0),
                        runtime=runtime)
    placement = pipeline.stage_placement
    responses = queue.Queue()
    for i in range(6):
        pipeline.process_frame_local(
            {"x": np.full((8, 8), float(i + 1), np.float32)},
            stream_id="mid", queue_response=responses)
    detect_devices = list(placement.plans["detect"].mesh.devices.flat)
    dead = set(detect_devices[:2])

    # Inject the failure while frames are mid-pipeline: run the loop
    # briefly, then health-check from the loop via the actor mailbox.
    runtime.run(timeout=0.03)
    pipeline.check_device_health(prober=lambda d: d not in dead)
    collected = []

    def drained():
        while not responses.empty():
            collected.append(responses.get())
        return len(collected) >= 6

    run_until(runtime, drained, timeout=30.0)
    survivors = set(placement.devices)
    new_generation = 0
    for _, _fid, swag, metrics, okay, diagnostic in collected:
        if not okay:
            continue        # erroring cleanly at the swap is legal
        leaf = swag.get("x")
        if metrics.get("stage_llm_generation") == 1:
            # Admitted to llm AFTER the swap: must be on the new
            # submeshes, never the stale mesh.
            new_generation += 1
            assert leaf is not None
            assert set(placement.plans["llm"].mesh.devices.flat) \
                <= survivors, \
                "post-replacement frame ran against a stale mesh"
    assert new_generation >= 1, \
        "no frame demonstrably re-entered at the new generation"
    pipeline.stop()


# -- failure paths must not wedge the (pipeline-global) window ---------------

def test_frame_error_releases_credits_for_other_streams(runtime):
    """A poison frame errors its stream while other frames are parked
    on stage workers / queued for admission: every stage credit comes
    back, and a FRESH stream still flows (leaked credits would wedge
    every stream at the stage)."""
    pipeline = Pipeline(two_stage_definition(busy_a=10.0, busy_b=10.0),
                        runtime=runtime)
    responses = queue.Queue()
    for i in range(3):
        pipeline.process_frame_local(
            {"x": np.full((4, 4), float(i + 1), np.float32)},
            stream_id="s1", queue_response=responses)
    # Poison: StageWork's jitted multiply raises on None input (on the
    # stage worker), erroring the stream with frames still in flight.
    pipeline.process_frame_local({"x": None}, stream_id="s1",
                                 queue_response=responses)
    for i in range(2):
        pipeline.process_frame_local(
            {"x": np.full((4, 4), 1.0, np.float32)},
            stream_id="s1", queue_response=responses)
    collected = []

    def saw_error():
        while not responses.empty():
            collected.append(responses.get())
        return any(not row[4] for row in collected)

    assert run_until(runtime, saw_error, timeout=30.0)
    runtime.run(timeout=0.3)            # let teardown posts drain
    stats = pipeline.stage_stats()
    for stage in ("detect", "llm"):
        assert stats[stage]["active"] == 0, \
            f"stage {stage} leaked admission credits: {stats[stage]}"
        assert pipeline.stage_scheduler.waiting(stage) == 0
    # The window still admits: a new stream completes all its frames.
    fresh = pump_and_drain(runtime, pipeline, 4, stream_id="s2")
    for *_, okay, diagnostic in fresh:
        assert okay, diagnostic
    pipeline.stop()


def test_error_flushes_buffered_successor_responses(runtime):
    """A frame error must not drop the buffered okay-responses of
    successors that already completed out of order: the error delivers
    in its slot and the finished work flushes behind it."""
    from aiko_services_tpu_torch.pipeline.stream import Frame

    pipeline = Pipeline(two_stage_definition(), runtime=runtime)
    responses = queue.Queue()
    stream = pipeline.create_stream_local("w", queue_response=responses)
    f0, f1 = Frame(frame_id=0), Frame(frame_id=1)
    pipeline._assign_delivery_seq(stream, f0)
    pipeline._assign_delivery_seq(stream, f1)
    stream.frames[0] = f0
    # Frame 1 completes FIRST: its response buffers behind frame 0.
    pipeline._deliver(stream, f1, okay=True)
    assert responses.empty()
    pipeline._frame_error(stream, f0, "boom")
    got = [responses.get_nowait() for _ in range(2)]
    assert [row[1] for row in got] == [0, 1]        # seq order kept
    assert got[0][4] is False and "boom" in got[0][5]
    assert got[1][4] is True, "successor's completed response was lost"
    pipeline.stop()


def test_bad_devices_request_is_definition_error(runtime):
    from aiko_services_tpu_torch.pipeline.definition import DefinitionError

    definition = two_stage_definition()
    definition["elements"][0]["placement"] = {"devices": "atuo"}  # typo
    with pytest.raises(DefinitionError, match="devices"):
        Pipeline(definition, runtime=runtime)


def test_stream_recreated_with_same_id_runs_full_path(runtime):
    """Destroy a stream mid-flight (queued waiters, parked workers),
    recreate it under the SAME id: every new frame walks the FULL path
    (stale waiter tokens must never admit a new frame mid-pipeline)."""
    pipeline = Pipeline(two_stage_definition(
        busy_a=5.0, busy_b=30.0,
        parameters={"stage_inflight": 1}), runtime=runtime)
    limbo = queue.Queue()
    for i in range(3):
        pipeline.process_frame_local(
            {"x": np.full((4, 4), 1.0, np.float32)},
            stream_id="r", queue_response=limbo)
    runtime.run(timeout=0.05)           # frames spread across stages
    pipeline.destroy_stream("r")
    collected = pump_and_drain(runtime, pipeline, 3, stream_id="r",
                               timeout=30.0)
    for _, frame_id, swag, _metrics, okay, diagnostic in collected:
        assert okay, diagnostic
        # detect (x2) AND llm (x3) both ran exactly once:
        # (frame_id + 1) * 2 * 3.
        np.testing.assert_allclose(np.asarray(swag["x"])[0, 0],
                                   (frame_id + 1) * 6.0)
    pipeline.stop()


# -- scheduler unit behaviour ------------------------------------------------

def test_scheduler_credits_and_waiters():
    scheduler = StageScheduler(["a", "b"], depth=2)
    assert scheduler.try_admit("a")
    assert scheduler.try_admit("a")
    assert not scheduler.try_admit("a")             # window full
    scheduler.enqueue("a", ("s", 1, "a"))
    token = scheduler.release("a")
    assert token == ("s", 1, "a")                   # freed credit -> waiter
    assert scheduler.active("a") == 1
    assert scheduler.stats["a"]["queued"] == 1
    scheduler.stop()


def test_in_stage_async_park_releases_stage_credit(runtime):
    """An async element DEEPER in a stage (not the placed head) still
    releases the stage credit at its park: cross-frame batching at the
    async element must not be capped at the admission window depth."""
    SlowAsync.inflight = 0
    SlowAsync.peak = 0
    definition = two_stage_definition(busy_a=1.0, busy_b=1.0)
    definition["graph"] = ["(detect batcher llm)"]
    definition["elements"].insert(1, element(
        "batcher", "SlowAsync", ["x"], ["x"],
        module="tests/test_torch_stages.py"))
    pipeline = Pipeline(definition, runtime=runtime)
    # The element class is re-imported by module path: reach the live
    # class through the graph, not the pytest import of this file.
    live_cls = type(pipeline.graph.get_node("batcher").element)
    live_cls.inflight = 0
    live_cls.peak = 0
    collected = pump_and_drain(runtime, pipeline, 6)
    assert all(row[4] for row in collected)
    assert live_cls.peak > pipeline.stage_scheduler.depth, (
        f"peak {live_cls.peak} parked frames: detect credits were "
        f"held through the in-stage async park")
    pipeline.stop()


def test_scheduler_reservation_blocks_queue_jumping():
    """A popped waiter's freed credit is RESERVED until its admission
    post lands: a fresh admission attempt arriving in between must not
    steal it (a later frame would overtake an earlier one through a
    stateful stage)."""
    scheduler = StageScheduler(["a"], depth=1)
    assert scheduler.try_admit("a")
    scheduler.enqueue("a", ("s", 0, "a"))
    token = scheduler.release("a")          # pops + reserves
    assert token == ("s", 0, "a")
    assert not scheduler.try_admit("a"), \
        "fresh admission stole a popped waiter's reserved credit"
    assert scheduler.try_admit("a", reserved=True)
    assert scheduler.active("a") == 1
    # A dead popped token cancels its reservation instead of pinning it.
    scheduler.enqueue("a", ("s", 1, "a"))
    token = scheduler.release("a")
    scheduler.cancel_reservation("a")
    assert scheduler.try_admit("a")         # credit usable again
    scheduler.stop()


def test_scheduler_fresh_admission_uses_surplus_beyond_reservations():
    """A reservation pins exactly ONE credit: fresh admissions may
    still take genuinely free capacity beyond active + reserved."""
    scheduler = StageScheduler(["a"], depth=2)
    assert scheduler.try_admit("a")
    scheduler.enqueue("a", ("s", 0, "a"))
    token = scheduler.release("a")          # active 0, reserved 1
    assert token == ("s", 0, "a")
    assert scheduler.try_admit("a"), \
        "one reservation blocked the window's free surplus credit"
    assert not scheduler.try_admit("a")     # active 1 + reserved 1 = depth
    assert scheduler.try_admit("a", reserved=True)
    scheduler.stop()


def test_remote_park_releases_stage_credit(runtime):
    """Frames parked at (or retrying discovery of) a remote stage
    DOWNSTREAM of placed stages must not pin the placed stages'
    admission windows: later frames keep flowing through the submeshes
    while earlier ones wait on the fabric."""
    from aiko_services_tpu_torch.services import Registrar

    Registrar(runtime=runtime, primary_search_timeout=0.05)
    definition = two_stage_definition(busy_a=2.0, busy_b=2.0)
    definition["graph"] = ["(detect llm fwd)"]
    definition["elements"].append(
        {"name": "fwd", "input": [{"name": "x"}],
         "output": [{"name": "x"}],
         "deploy": {"remote": {"name": "never_appears"}}})
    pipeline = Pipeline(definition, runtime=runtime)
    responses = queue.Queue()
    n_frames = 5                    # > 2x the default window depth
    for i in range(n_frames):
        pipeline.process_frame_local(
            {"x": np.full((4, 4), 1.0, np.float32)},
            stream_id="rp", queue_response=responses)
    runtime.run(timeout=1.0)
    stats = pipeline.stage_stats()
    # Every frame cleared BOTH placed stages (parked/retrying at the
    # remote now): with credits pinned across the remote park, only
    # stage_inflight frames could ever have entered llm.
    assert stats["llm"]["admitted"] == n_frames, stats
    assert stats["llm"]["active"] == 0, \
        f"remote park pinned llm admission credits: {stats['llm']}"
    assert stats["detect"]["active"] == 0
    assert pipeline.streams["rp"].in_flight == n_frames   # all parked
    pipeline.stop()


def test_scheduler_occupancy_window():
    scheduler = StageScheduler(["a"], depth=1)
    scheduler.try_admit("a")
    time.sleep(0.03)
    scheduler.release("a")
    assert scheduler.occupancy("a") > 0
    scheduler.reset_window()
    time.sleep(0.01)
    assert scheduler.occupancy("a") < 0.5           # idle since reset
    scheduler.stop()


# -- replicated stages ------------------------------------------------------


def replicated_definition(replicas=3, busy_ms=15.0, parameters=None,
                          devices=2):
    return {
        "version": 0, "name": "p_replicas", "runtime": "torch",
        "graph": ["(detect)"],
        "parameters": dict(parameters or {}),
        "elements": [
            element("detect", "StageWork", ["x"], ["x"],
                    {"busy_ms": busy_ms, "factor": 2.0},
                    {"devices": devices, "replicas": replicas}),
        ]}


def pump(pipeline, count, stream_id="r", shape=(8, 8)):
    responses = queue.Queue()
    rng = np.random.default_rng(0)
    for _ in range(count):
        pipeline.process_frame_local(
            {"x": rng.standard_normal(shape).astype(np.float32)},
            stream_id=stream_id, queue_response=responses)
    return responses


def drain(rt, responses, count, timeout=120.0):
    rows = []

    def drained():
        while not responses.empty():
            rows.append(responses.get())
        return len(rows) >= count

    run_until(rt, drained, timeout=timeout)
    return rows


def test_replica_group_round_robin_and_depth():
    from aiko_services_tpu_torch.pipeline.stages import ReplicaGroup

    group = ReplicaGroup("detect", 3, depth=1)
    picks = []
    for _ in range(3):
        index = group.pick()
        picks.append(index)
        group.admit(index)
    assert picks == [0, 1, 2]
    assert group.pick() is None                 # window full everywhere
    group.release(1)
    assert group.pick() == 1                    # freed credit wins
    assert group.stats["live"] == 3


def test_replica_group_canary_lifecycle():
    from aiko_services_tpu_torch.pipeline.stages import (
        REPLICA_DEAD, REPLICA_HALF_OPEN, REPLICA_LIVE, ReplicaGroup)

    group = ReplicaGroup("detect", 2, depth=2)
    group.fail(1)
    assert group.states == [REPLICA_LIVE, REPLICA_DEAD]
    assert group.failovers == 1
    group.rebuild(2, half_open=[1])
    assert group.states == [REPLICA_LIVE, REPLICA_HALF_OPEN]
    # The half-open slot admits exactly ONE canary.
    picks = [group.pick() for _ in range(3)]
    for index in picks:
        if index is not None:
            group.admit(index)
    assert picks.count(1) == 1
    # Canary success closes the slot live.
    group.release(1, ok=True)
    assert group.states[1] == REPLICA_LIVE
    # A second failure + rebuild, canary FAILURE re-kills.
    group.fail(1)
    group.rebuild(2, half_open=[1])
    index = None
    while index != 1:
        index = group.pick()
        group.admit(index)
    group.release(1, ok=False)
    assert group.states[1] == REPLICA_DEAD


def test_replica_group_all_dead():
    from aiko_services_tpu_torch.pipeline.stages import ReplicaGroup

    group = ReplicaGroup("detect", 2)
    group.fail(0)
    assert not group.all_dead()
    group.fail(1)
    assert group.all_dead()
    assert group.pick() is None


def test_scheduler_admit_replica_respects_reservations():
    scheduler = StageScheduler(["detect"], depth=1,
                               replicas={"detect": 2})
    assert scheduler.admit_replica("detect") == 0
    assert scheduler.admit_replica("detect") == 1
    assert scheduler.admit_replica("detect") is None
    scheduler.enqueue("detect", ["s", 0, "detect", True, None])
    waiter = scheduler.release("detect", replica=0)
    assert waiter is not None                   # popped with reservation
    # A fresh admission may not steal the reserved credit...
    assert scheduler.admit_replica("detect") is None
    # ...but the reserved waiter itself admits.
    assert scheduler.admit_replica("detect", reserved=True) is not None
    scheduler.stop()


def test_replicated_stage_round_robins_frames(runtime):
    pipeline = Pipeline(replicated_definition(replicas=3, busy_ms=10.0),
                        runtime=runtime)
    group = pipeline.stage_scheduler.groups["detect"]
    rows = drain(runtime, pump(pipeline, 12), 12)
    assert len(rows) == 12
    assert all(row[4] for row in rows), \
        [row[5] for row in rows if not row[4]]
    order = [row[1] for row in rows]
    assert order == sorted(order)
    # Admission spread across every replica, and the per-frame metric
    # recorded which submesh each frame ran on.
    assert all(count >= 2 for count in group.admitted), group.admitted
    used = {row[3].get("stage_detect_replica") for row in rows}
    assert used == {0, 1, 2}
    stats = pipeline.replica_stats()
    assert stats["stages"]["detect"]["live"] == 3
    pipeline.stop()


def test_single_replicated_stage_activates_scheduler(runtime):
    """One placed stage normally runs the serial path, but replication
    IS frame-level parallelism -- the scheduler must activate."""
    pipeline = Pipeline(replicated_definition(replicas=2),
                        runtime=runtime)
    assert pipeline.stage_scheduler is not None
    assert "detect" in pipeline.stage_scheduler.groups
    pipeline.stop()


def test_replica_failover_sheds_to_peers_in_order(runtime):
    """Kill one replica of 3 mid-flight: its frames replay on the
    peers, every frame completes IN ORDER, no duplicates, and the
    stage keeps serving at N-1 -- the peer-shed path, generation
    unchanged."""
    pipeline = Pipeline(
        replicated_definition(replicas=3, busy_ms=20.0,
                              parameters={"replica_rebuild_ms": 0}),
        runtime=runtime)
    placement = pipeline.stage_placement
    responses = pump(pipeline, 12)
    pipeline.post_self("fail_replica", ["detect", 1], delay=0.05)
    rows = drain(runtime, responses, 12)
    assert len(rows) == 12, "stream hung after replica failover"
    assert all(row[4] for row in rows), \
        [row[5] for row in rows if not row[4]]
    order = [row[1] for row in rows]
    assert order == sorted(order), f"out of order: {order}"
    assert len(order) == len(set(order)), "duplicate delivery"
    # Peer-shed, not stop-the-world: no generation bump, peers alive.
    assert placement.generation == 0
    assert placement.live_replicas("detect") == [0, 2]
    stats = pipeline.replica_stats()
    assert stats["failovers"] == 1
    assert stats["failover_ms"] > 0
    assert pipeline.share["replica_failovers"] == 1
    pipeline.stop()


def test_replica_rebuild_readmits_half_open_behind_canary(runtime):
    """After a failover the background rebuild restores the slot
    HALF-OPEN: exactly one canary frame re-admits it, success closes
    it live and it serves again."""
    pipeline = Pipeline(
        replicated_definition(replicas=3, busy_ms=10.0,
                              parameters={"replica_rebuild_ms": 40}),
        runtime=runtime)
    group = pipeline.stage_scheduler.groups["detect"]
    responses = pump(pipeline, 8)
    pipeline.post_self("fail_replica", ["detect", 2], delay=0.03)
    rows = drain(runtime, responses, 8)
    assert all(row[4] for row in rows)
    run_until(runtime,
              lambda: pipeline.replica_stats()["rebuilds"] >= 1,
              timeout=30.0)
    walk = [(slot, state) for slot, state, _ in group.transitions]
    assert (2, "dead") in walk
    assert (2, "half_open") in walk
    # More traffic: the canary closes the slot live and it serves.
    rows2 = drain(runtime, pump(pipeline, 9, stream_id="r2"), 9)
    assert all(row[4] for row in rows2)
    assert group.states == ["live", "live", "live"]
    used = {row[3].get("stage_detect_replica") for row in rows2}
    assert 2 in used, "rebuilt replica never served"
    pipeline.stop()


def test_replica_canary_off_readmits_fully(runtime):
    pipeline = Pipeline(
        replicated_definition(
            replicas=2, busy_ms=5.0,
            parameters={"replica_rebuild_ms": 30,
                        "replica_canary": "off"}),
        runtime=runtime)
    group = pipeline.stage_scheduler.groups["detect"]
    rows = drain(runtime, pump(pipeline, 4), 4)
    assert all(row[4] for row in rows)
    pipeline.post_self("fail_replica", ["detect", 0])
    run_until(runtime,
              lambda: pipeline.replica_stats()["rebuilds"] >= 1,
              timeout=30.0)
    walk = [(slot, state) for slot, state, _ in group.transitions]
    assert (0, "half_open") not in walk
    assert group.states == ["live", "live"]
    pipeline.stop()


def test_replica_failover_resets_remote_retry_backoff(runtime):
    """A frame punished for a dead replica's failures starts clean on
    a healthy peer: ``remote_retries`` (the exponential-backoff state)
    resets when the failover re-admits it elsewhere."""
    pipeline = Pipeline(
        replicated_definition(replicas=2, busy_ms=60.0,
                              parameters={"replica_rebuild_ms": 0}),
        runtime=runtime)
    responses = pump(pipeline, 4)
    # Let frames admit onto stage workers.
    run_until(runtime,
              lambda: any(frame.stage == "detect"
                          for stream in pipeline.streams.values()
                          for frame in stream.frames.values()),
              timeout=30.0)
    victims = [frame for stream in pipeline.streams.values()
               for frame in stream.frames.values()
               if frame.stage == "detect" and frame.stage_replica == 0]
    assert victims, "no frame admitted to replica 0"
    for frame in victims:
        frame.remote_retries = 3        # poisoned backoff state
    pipeline.fail_replica("detect", 0)
    for frame in victims:
        assert frame.remote_retries == 0
    rows = drain(runtime, responses, 4)
    assert all(row[4] for row in rows)
    pipeline.stop()


def test_all_replicas_dead_fails_frames_then_rebuild_recovers(runtime):
    """Every replica dead and no rebuild pending: incoming frames fail
    fast (stream stays alive) instead of queueing forever."""
    pipeline = Pipeline(
        replicated_definition(replicas=2, busy_ms=5.0,
                              parameters={"replica_rebuild_ms": 0}),
        runtime=runtime)
    rows = drain(runtime, pump(pipeline, 2), 2)
    assert all(row[4] for row in rows)
    pipeline.fail_replica("detect", 0)
    # The LAST replica's failure escalates to an immediate rebuild --
    # the stage cannot serve at N-0 -- which restores both slots.
    pipeline.fail_replica("detect", 1)
    assert pipeline.replica_stats()["rebuilds"] == 1
    rows2 = drain(runtime, pump(pipeline, 4, stream_id="r2"), 4)
    assert all(row[4] for row in rows2)
    pipeline.stop()


def test_autoscale_scales_up_on_queue_and_down_on_idle(runtime):
    pipeline = Pipeline(
        {"version": 0, "name": "p_autoscale", "runtime": "torch",
         "graph": ["(detect)"],
         "elements": [
             element("detect", "StageWork", ["x"], ["x"],
                     {"busy_ms": 5.0, "factor": 2.0},
                     {"devices": 1,
                      "replicas": {"min": 1, "max": 3}})]},
        runtime=runtime)
    placement = pipeline.stage_placement
    scheduler = pipeline.stage_scheduler
    group = scheduler.groups["detect"]
    assert placement.replica_total("detect") == 1   # starts at min
    # Synthesize load: the one replica ran hot all window and a frame
    # is queued behind it.
    group._busy[0] = 10.0
    group._window_start = time.monotonic() - 10.0
    scheduler.enqueue("detect", ["s", 0, "detect", True, None])
    decisions = pipeline.autoscale_replicas()
    assert decisions == {"detect": 2}
    assert placement.replica_total("detect") == 2
    scheduler._waiters["detect"].clear()
    scheduler.queued["detect"] = 0
    # Idle window: scale back down toward min.
    group = scheduler.groups["detect"]
    decisions = pipeline.autoscale_replicas()
    assert decisions == {"detect": 1}
    assert placement.replica_total("detect") == 1
    # At the floor with no load: no decision.
    assert pipeline.autoscale_replicas() == {}
    pipeline.stop()


def test_autoscaled_pipeline_serves_through_resplit(runtime):
    """Frames in flight when the autoscaler re-splits replicas replay
    onto the fresh carve and deliver in order."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_autoscale2", "runtime": "torch",
         "graph": ["(detect)"],
         "elements": [
             element("detect", "StageWork", ["x"], ["x"],
                     {"busy_ms": 15.0, "factor": 2.0},
                     {"devices": 1,
                      "replicas": {"min": 1, "max": 4}})]},
        runtime=runtime)
    scheduler = pipeline.stage_scheduler
    group = scheduler.groups["detect"]
    responses = pump(pipeline, 10)

    fired = []

    def resplit():
        if not fired:
            group._busy[0] = 10.0
            group._window_start = time.monotonic() - 10.0
            fired.append(pipeline.autoscale_replicas())

    pipeline.post_self("autoscale_replicas", [], delay=0.04)
    rows = drain(runtime, responses, 10)
    assert len(rows) == 10
    assert all(row[4] for row in rows), \
        [row[5] for row in rows if not row[4]]
    order = [row[1] for row in rows]
    assert order == sorted(order)
    pipeline.stop()


def test_administrative_resplit_does_not_charge_replay_budget(runtime):
    """Consecutive autoscale re-splits under a sustained backlog must
    not exhaust ``replay_limit``: the engine's own re-carve is not a
    failure, so frames replayed by it keep their full recovery budget
    (regression: with replay_limit 1, two re-splits used to error the
    whole backlog)."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_resplit_budget", "runtime": "torch",
         "graph": ["(detect)"],
         "parameters": {"replay_limit": 1},
         "elements": [
             element("detect", "StageWork", ["x"], ["x"],
                     {"busy_ms": 20.0, "factor": 2.0},
                     {"devices": 1,
                      "replicas": {"min": 1, "max": 4}})]},
        runtime=runtime)
    placement = pipeline.stage_placement
    scheduler = pipeline.stage_scheduler
    responses = pump(pipeline, 10)
    run_until(runtime,
              lambda: any(frame.stage == "detect"
                          for stream in pipeline.streams.values()
                          for frame in stream.frames.values()),
              timeout=30.0)
    for _ in range(2):                      # two consecutive up-ticks
        group = scheduler.groups["detect"]
        group._busy = [10.0] * len(group.states)
        group._window_start = time.monotonic() - 10.0
        scheduler.enqueue("detect", ["s", 99, "detect", True, None])
        assert pipeline.autoscale_replicas(), "no scale-up decision"
        scheduler._waiters["detect"].clear()
        scheduler.queued["detect"] = 0
    assert placement.replica_total("detect") == 3
    rows = drain(runtime, responses, 10)
    assert all(row[4] for row in rows), \
        [row[5] for row in rows if not row[4]]
    order = [row[1] for row in rows]
    assert order == sorted(order)
    # The budget is intact: no frame consumed a failure replay.
    for stream in pipeline.streams.values():
        for frame in stream.frames.values():
            assert frame.replays == 0
    pipeline.stop()


def test_replicated_stage_with_stage_pipeline_off_recovers(runtime):
    """``stage_pipeline: off`` disables replica admission, but a dead
    replica's chips are still dead -- fail_replica must escalate to the
    full replace path instead of silently leaving a dead submesh in the
    pool (regression: it used to no-op without a scheduler)."""
    pipeline = Pipeline(
        replicated_definition(replicas=2, busy_ms=5.0,
                              parameters={"stage_pipeline": "off"}),
        runtime=runtime)
    assert pipeline.stage_scheduler is None
    placement = pipeline.stage_placement
    doomed = placement.replica_devices("detect", 0)
    rows = drain(runtime, pump(pipeline, 2), 2)
    assert all(row[4] for row in rows)
    pipeline.fail_replica("detect", 0)
    assert placement.generation == 1, "dead replica never recovered"
    assert not (set(placement.devices) & doomed), \
        "dead chips still in the pool"
    rows2 = drain(runtime, pump(pipeline, 3, stream_id="r2"), 3)
    assert all(row[4] for row in rows2)
    pipeline.stop()


def test_autoscale_skips_scale_up_without_free_capacity(runtime):
    """A full pool cannot host another fixed-request replica: the
    control loop must not emit the decision at all -- the reassign
    would shed the increment straight back while still replaying every
    in-flight frame, every tick (regression)."""
    n = len(list(CPU_POOL))
    pipeline = Pipeline(
        {"version": 0, "name": "p_full_pool", "runtime": "torch",
         "graph": ["(detect)"],
         "elements": [
             element("detect", "StageWork", ["x"], ["x"],
                     {"busy_ms": 5.0, "factor": 2.0},
                     {"devices": 1,
                      "replicas": {"min": n, "max": n + 4}})]},
        runtime=runtime)
    placement = pipeline.stage_placement
    scheduler = pipeline.stage_scheduler
    group = scheduler.groups["detect"]
    assert placement.replica_total("detect") == n    # pool exhausted
    generation = placement.generation
    # Hot + queued: the up-condition holds, but there is no capacity.
    group._busy = [10.0] * len(group.states)
    group._window_start = time.monotonic() - 10.0
    scheduler.enqueue("detect", ["s", 0, "detect", True, None])
    assert pipeline.autoscale_replicas() == {}
    assert placement.generation == generation, \
        "no-op scale-up still re-carved the placement"
    pipeline.stop()
