"""The port's fault-injection harness and end-to-end failure recovery:
twins of ``tests/test_chaos.py`` on the eight-CPU device pool
(``torch_pipeline_elements.cpu_pool``).

The acceptance contract: with the harness injecting (a) chip death
mid-flight, (b) remote-stage death mid-park, (c) overload on a live
stream, every stream either completes or errors within its deadline --
zero hung streams -- with ``frames_replayed``/``frames_shed``/breaker
transitions proving WHICH recovery path ran, and all injection points
proven no-ops (probe counter unchanged) when no FaultPlan is armed.

Plans are deterministic: rules fire by exact after/count bookkeeping
(prob-rules seeded), so every assertion is on an exact blast radius.
The replica failover is held cheaper than a full replace by what each
touches (generation, plans re-carved, frames replayed), not by a
wall-clock race.
"""

import queue
import time

import numpy as np
import pytest
import torch

from conftest import run_until
from test_torch_llm_element import _port_runtime, _port_teardown
from torch_pipeline_elements import CPU_POOL, cpu_pool  # noqa: F401

from aiko_services_tpu_torch import faults as faults_module
from aiko_services_tpu_torch.faults import (BREAKER_CLOSED, BREAKER_OPEN,
                                            CircuitBreaker, FaultPlan,
                                            probe_count)
from aiko_services_tpu_torch.pipeline import Pipeline, PipelineElement, \
    StreamEvent
from aiko_services_tpu_torch.pipeline.tensor import TPUElement
from aiko_services_tpu_torch.services import Registrar


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


@pytest.fixture(autouse=True)
def _device_pool(cpu_pool):
    """Every placement here carves the eight CPU descriptors."""
    return cpu_pool


pytestmark = pytest.mark.chaos


# -- elements loaded by module path ------------------------------------------


class BusyStage(TPUElement):
    """Placed synchronous stage: jitted multiply + host wait, the shape
    that parks frames on stage workers."""

    def process_frame(self, stream, x):
        busy_ms, _ = self.get_parameter("busy_ms", 20.0)
        compute = self.jit(lambda a: a * 2.0)
        y = compute(x)
        time.sleep(float(busy_ms) / 1000.0)
        return StreamEvent.OKAY, {"x": y}


class SlowAsyncEcho(PipelineElement):
    """Async element completing from a worker thread after a delay --
    the parked-async shape for mid-park replacement."""

    is_async = True

    def process_frame_start(self, stream, complete, **inputs):
        import threading

        delay_ms, _ = self.get_parameter("delay_ms", 50.0)

        def finish():
            time.sleep(float(delay_ms) / 1000.0)
            complete(StreamEvent.OKAY, dict(inputs))

        threading.Thread(target=finish, daemon=True).start()


class SlowAsyncAdd(PipelineElement):
    """Async +1000 after a delay: its contribution is value-visible, so
    a duplicate remote response overwriting its park shows up as a
    wrong number, not just a timing blip."""

    is_async = True

    def process_frame_start(self, stream, complete, x=None, **inputs):
        import threading

        delay_ms, _ = self.get_parameter("delay_ms", 50.0)

        def finish():
            time.sleep(float(delay_ms) / 1000.0)
            complete(StreamEvent.OKAY, {"x": int(x) + 1000})

        threading.Thread(target=finish, daemon=True).start()


class CheapLocal(PipelineElement):
    """Degraded-mode fallback: tags its output so tests can tell the
    fallback ran instead of the remote."""

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": int(x) + 100}


def element(name, cls, inputs=("x",), outputs=("x",), parameters=None,
            placement=None, module="tests/test_torch_chaos.py"):
    entry = {"name": name,
             "input": [{"name": n} for n in inputs],
             "output": [{"name": n} for n in outputs],
             "parameters": parameters or {},
             "deploy": {"local": {"module": module, "class_name": cls}}}
    if placement:
        entry["placement"] = placement
    return entry


def ingest(pipeline, responses, count, stream_id="0", value=None):
    for i in range(count):
        data = {"x": np.float32(i + 1) if value is None else value}
        pipeline.process_frame_local(data, stream_id=stream_id,
                                     queue_response=responses)


def collect(runtime, responses, count, timeout=60.0):
    rows = []

    def drained():
        while not responses.empty():
            rows.append(responses.get())
        return len(rows) >= count

    run_until(runtime, drained, timeout=timeout)
    return rows


# -- FaultPlan / breaker units -----------------------------------------------


def test_fault_plan_parse_and_counting():
    plan = FaultPlan.parse({"seed": 7, "rules": [
        {"point": "element_raise", "target": "det", "after": 1,
         "count": 2},
        {"point": "wire_drop", "target": "process_frame",
         "count": None}]})
    assert plan.should("element_raise", target="llm") is None
    assert plan.should("element_raise", target="det") is None  # after=1
    assert plan.should("element_raise", target="det") is not None
    assert plan.should("element_raise", target="det") is not None
    assert plan.should("element_raise", target="det") is None  # count=2
    # unbounded rule + topic substring matching
    for _ in range(3):
        assert plan.should("wire_drop", target="process_frame") \
            is not None
    assert plan.fired("element_raise") == 2
    assert plan.fired("wire_drop") == 3
    assert len(plan.trace) == 5
    assert plan.probes == 8


def test_fault_plan_rejects_unknown_point_and_fields():
    with pytest.raises(ValueError, match="not one of"):
        FaultPlan.parse([{"point": "nope"}])
    with pytest.raises(ValueError, match="unknown fields"):
        FaultPlan.parse([{"point": "wire_drop", "bogus": 1}])


def test_fault_plan_seeded_prob_is_deterministic():
    def fires(seed):
        plan = FaultPlan.parse({"seed": seed, "rules": [
            {"point": "element_raise", "count": None, "prob": 0.5}]})
        return [plan.should("element_raise") is not None
                for _ in range(32)]

    assert fires(3) == fires(3)
    assert fires(3) != fires(4)


def test_circuit_breaker_state_walk():
    now = [0.0]
    breaker = CircuitBreaker(threshold=2, cooldown_s=1.0,
                             clock=lambda: now[0])
    assert breaker.allow() and breaker.state == BREAKER_CLOSED
    breaker.record_failure()
    assert breaker.state == BREAKER_CLOSED          # 1 < threshold
    breaker.record_failure()
    assert breaker.state == BREAKER_OPEN
    assert not breaker.allow()                      # cooling down
    now[0] = 1.5
    assert breaker.allow()                          # half-open probe
    assert breaker.state == "half_open"
    assert not breaker.allow()                      # one probe at a time
    breaker.record_failure()                        # probe failed
    assert breaker.state == BREAKER_OPEN
    now[0] = 3.0
    assert breaker.allow()
    breaker.record_success()                        # probe succeeded
    assert breaker.state == BREAKER_CLOSED
    assert [s for s, _ in breaker.transitions] == \
        ["open", "half_open", "open", "half_open", "closed"]


def test_circuit_breaker_halfopen_probe_timeout_allows_reprobe():
    now = [0.0]
    breaker = CircuitBreaker(threshold=1, cooldown_s=1.0,
                             clock=lambda: now[0])
    breaker.record_failure()
    now[0] = 1.1
    assert breaker.allow()          # probe 1 -- then it goes silent
    now[0] = 2.3
    assert breaker.allow()          # probe window expired: probe 2


# -- no-op when unarmed ------------------------------------------------------


def test_unarmed_pipeline_never_enters_the_harness(runtime):
    """Acceptance: with no FaultPlan armed, zero injection-point
    branches are taken (module probe counter unchanged) across a full
    placed stage-parallel run."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_noop", "runtime": "torch",
         "graph": ["(det llm)"],
         "parameters": {},
         "elements": [
             element("det", "BusyStage", parameters={"busy_ms": 1.0},
                     placement={"devices": 4}),
             element("llm", "BusyStage", parameters={"busy_ms": 1.0},
                     placement={"devices": 4})]},
        runtime=runtime)
    before = probe_count()
    responses = queue.Queue()
    ingest(pipeline, responses, 4)
    rows = collect(runtime, responses, 4)
    assert len(rows) == 4 and all(row[4] for row in rows)
    assert probe_count() == before
    assert pipeline.fault_stats()["armed"] is False
    pipeline.stop()


# -- (a) chip death mid-flight -----------------------------------------------


def test_chip_death_midflight_replays_parked_stage_frames(runtime):
    """Frames parked on a placed stage worker when replace() fires are
    replayed onto the replacement submeshes and complete -- no hung
    stream, no errored stream, frames_replayed > 0."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_replay", "runtime": "torch",
         "graph": ["(det llm)"],
         "parameters": {"replay_limit": 3},
         "elements": [
             element("det", "BusyStage", parameters={"busy_ms": 30.0},
                     placement={"devices": 4}),
             element("llm", "BusyStage", parameters={"busy_ms": 30.0},
                     placement={"devices": 4})]},
        runtime=runtime)
    responses = queue.Queue()
    ingest(pipeline, responses, 6)
    # Kill two of det's chips while frames are mid-stage: the posts
    # interleave with the frames' stage-worker parks.
    dead = list(pipeline.stage_placement.plans["det"]
                .mesh.devices.flat)[:2]
    # Small delay so the kill lands while frames occupy stage credits
    # and worker threads, not just the admission queue.
    pipeline.post_self("replace_failed_devices", [dead], delay=0.05)
    rows = collect(runtime, responses, 6)
    assert len(rows) == 6, "stream hung after mid-flight replacement"
    assert all(row[4] for row in rows), \
        [row[5] for row in rows if not row[4]]
    assert pipeline.share["frames_replayed"] > 0
    assert pipeline.stage_placement.generation == 1
    assert not (set(pipeline.stage_placement.devices) & set(dead))
    # In-order delivery survived the replay.
    order = [row[1] for row in rows]
    assert order == sorted(order)
    pipeline.stop()


def test_dispatch_raise_probe_replace_recovers_sync_element(runtime):
    """The dispatch-time story: an element raises (injected XLA 'chip
    died' error), the engine probes, the armed device_kill rule marks
    the stage's chips dead, replace() fires and the frame replays to
    completion -- one frame, one replay, zero stream errors."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_dispatch", "runtime": "torch",
         "graph": ["(sq)"],
         "parameters": {
             "health_probe_timeout": 2.0,
             "fault_plan": {"rules": [
                 {"point": "element_raise", "target": "sq", "count": 1},
                 {"point": "device_kill", "target": "sq", "count": 1},
             ]}},
         "elements": [element("sq", "BusyStage",
                              parameters={"busy_ms": 0.0},
                              placement={"mesh": {"dp": 4}})]},
        runtime=runtime)
    responses = queue.Queue()
    ingest(pipeline, responses, 1)
    rows = collect(runtime, responses, 1)
    assert rows and rows[0][4], rows[0][5]
    assert pipeline.share["frames_replayed"] == 1
    assert pipeline.stage_placement.generation == 1
    plan_stats = pipeline.fault_stats()["plan"]
    assert plan_stats["fired"] == {"element_raise": 1, "device_kill": 1}
    pipeline.stop()


def test_chip_death_midpark_async_replays_and_discards_stale(runtime):
    """A frame parked at an async element when chips die replays from
    the async stage; the pre-replay completion post is discarded by the
    replay-epoch guard (it must not double-run the suffix)."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_async", "runtime": "torch",
         "graph": ["(up echo)"],
         "parameters": {},
         "elements": [
             element("up", "BusyStage", parameters={"busy_ms": 0.0},
                     placement={"mesh": {"dp": 4}}),
             element("echo", "SlowAsyncEcho",
                     parameters={"delay_ms": 150.0})]},
        runtime=runtime)
    responses = queue.Queue()
    ingest(pipeline, responses, 1)
    # Let the frame reach the async park, then kill half the chips.
    stream_holder = {}

    def parked():
        stream = pipeline.streams.get("0")
        if stream is None:
            return False
        stream_holder["stream"] = stream
        frame = stream.frames.get(0)
        return frame is not None and frame.paused_pe_name == "echo"

    assert run_until(runtime, parked, timeout=10.0)
    dead = pipeline.stage_placement.devices[:2]
    pipeline.post_self("replace_failed_devices", [dead])
    rows = collect(runtime, responses, 1)
    assert rows and rows[0][4], rows[0][5]
    assert len(rows) == 1                   # stale completion discarded
    assert pipeline.share["frames_replayed"] == 1
    assert rows[0][3].get("replays") == 1
    pipeline.stop()


def test_replay_limit_bounds_repeated_replacement(runtime):
    """A frame caught by replace() more times than replay_limit errors
    with a clear diagnostic instead of replaying forever."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_limit", "runtime": "torch",
         "graph": ["(up echo)"],
         "parameters": {"replay_limit": 1},
         "elements": [
             element("up", "BusyStage", parameters={"busy_ms": 0.0},
                     placement={"mesh": {"dp": 8}}),
             element("echo", "SlowAsyncEcho",
                     parameters={"delay_ms": 200.0})]},
        runtime=runtime)
    responses = queue.Queue()
    ingest(pipeline, responses, 1)

    def parked():
        stream = pipeline.streams.get("0")
        frame = stream.frames.get(0) if stream else None
        return frame is not None and frame.paused_pe_name == "echo"

    assert run_until(runtime, parked, timeout=10.0)
    devices = list(pipeline.stage_placement.devices)
    pipeline.post_self("replace_failed_devices", [devices[:2]])
    assert run_until(runtime, parked, timeout=10.0)  # replay re-parked
    pipeline.post_self("replace_failed_devices", [devices[2:4]])
    rows = collect(runtime, responses, 1)
    assert rows and not rows[0][4]
    assert "replay limit" in rows[0][5]
    pipeline.stop()


def test_segment_fail_midflight_recovers_fused_chain(runtime):
    """Chip death presenting inside a FUSED dispatch (non-compiling
    call raises): the probe finds the dead chips, segments rebuild for
    the new generation, and the frame replays per-element to the same
    answer."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_seg", "runtime": "torch",
         "graph": ["(d1 d2)"],
         "parameters": {
             "health_probe_timeout": 2.0,
             "fault_plan": {"rules": [
                 # after=1: the first (compiling) dispatch succeeds so
                 # the segment is established; the second frame's
                 # warm-cache dispatch takes the injected failure.
                 {"point": "segment_fail", "target": "d1+d2",
                  "after": 1, "count": 1},
                 {"point": "device_kill", "target": "device:0",
                  "count": 1},
             ]}},
         "elements": [
             element("d1", "DeviceDouble", parameters={"device": "cpu"},
                     module="tests/test_torch_fusion.py"),
             element("d2", "DeviceAddOne", parameters={"device": "cpu"},
                     module="tests/test_torch_fusion.py"),
             # Off-graph placement block so a StagePlacement exists for
             # the probe to replace (the fused chain itself is
             # unplaced; stage plans come from element definitions).
             element("sink", "BusyStage",
                     parameters={"busy_ms": 0.0},
                     placement={"mesh": {"dp": 4}})]},
        runtime=runtime)
    responses = queue.Queue()
    ingest(pipeline, responses, 2, value=np.float32(3.0))
    rows = collect(runtime, responses, 2)
    assert len(rows) == 2
    assert all(row[4] for row in rows), \
        [row[5] for row in rows if not row[4]]
    for row in rows:
        assert float(np.asarray(row[2]["x"])) == 7.0     # 3*2+1
    assert pipeline.share["frames_replayed"] == 1
    assert pipeline.fault_stats()["plan"]["fired"]["segment_fail"] == 1
    pipeline.stop()


# -- (b) remote-stage death mid-park: breaker + deadlines --------------------


def _remote_pair_defs(fallback=False):
    front_elements = [
        {"name": "inc", "input": [{"name": "x"}],
         "output": [{"name": "x"}],
         "deploy": {"local": {
             "module": "aiko_services_tpu_torch.elements.common",
             "class_name": "Increment"}}},
        {"name": "fwd", "input": [{"name": "x"}],
         "output": [{"name": "x"}],
         "deploy": {"remote": {"name": "back"}}}]
    if fallback:
        front_elements[1]["fallback"] = "cheap"
        front_elements.append(element("cheap", "CheapLocal"))
    front = {"version": 0, "name": "front", "runtime": "torch",
             "graph": ["(inc fwd)"],
             "parameters": {"frame_deadline_ms": 400,
                            "breaker_threshold": 2,
                            "breaker_cooldown_ms": 250},
             "elements": front_elements}
    back = {"version": 0, "name": "back", "runtime": "torch",
            "graph": ["(inc)"],
            "elements": [front_elements[0]]}
    return front, back


def test_remote_death_midpark_breaker_opens_and_recloses(runtime):
    """Responses dropped on the wire -> parked frames deadline-error ->
    breaker opens (frames fail fast, stream stays alive) -> half-open
    probe succeeds once the wire heals -> breaker recloses and frames
    flow.  Zero hung streams; every frame completed or errored within
    its deadline."""
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    front_def, back_def = _remote_pair_defs()
    front = Pipeline(front_def, runtime=runtime)
    back = Pipeline(back_def, runtime=runtime)
    responses = queue.Queue()
    # Warm the remote path (discovery + first round trip) on a
    # deadline-free stream so discovery latency can't flake the warmup.
    front.create_stream_local("w", {"frame_deadline_ms": 0},
                              queue_response=responses)
    front.ingest_local("w", {"x": 0}, queue_response=responses)
    warm = collect(runtime, responses, 1)
    assert warm and warm[0][4], warm[0]
    front.create_stream_local("1", queue_response=responses)

    # Drop the next TWO responses: two deadline misses open the breaker.
    front.arm_faults({"rules": [
        {"point": "wire_drop", "target": "process_frame_response",
         "count": 2}]})
    for _ in range(2):
        front.ingest_local("1", {"x": 0}, queue_response=responses)
        rows = collect(runtime, responses, 1, timeout=10.0)
        assert rows and not rows[0][4]
        assert "deadline" in rows[0][5]
    breaker = front.breakers["fwd"]
    assert breaker.state == BREAKER_OPEN
    assert front.share["deadline_misses"] == 2

    # Breaker open: the next frame fails FAST (no deadline wait, no
    # wire traffic) and the stream survives.
    start = time.monotonic()
    front.ingest_local("1", {"x": 0}, queue_response=responses)
    rows = collect(runtime, responses, 1, timeout=10.0)
    assert rows and not rows[0][4]
    assert "circuit breaker open" in rows[0][5]
    assert time.monotonic() - start < 0.35      # < deadline: fail-fast
    assert "1" in front.streams                  # stream alive

    # Cooldown elapses; the wire is healthy again (count=2 exhausted):
    # the half-open probe round-trips and recloses the breaker.
    time.sleep(0.3)
    front.ingest_local("1", {"x": 10}, queue_response=responses)
    rows = collect(runtime, responses, 1, timeout=10.0)
    assert rows and rows[0][4], rows[0][5]
    assert int(rows[0][2]["x"]) == 12            # inc + remote inc
    assert breaker.state == BREAKER_CLOSED
    walk = [s for s, _ in breaker.transitions]
    assert walk == ["open", "half_open", "closed"]
    assert front.fault_stats()["plan"]["fired"]["wire_drop"] == 2
    front.stop()
    back.stop()


def test_breaker_open_runs_declared_fallback(runtime):
    """With a ``fallback:`` declared, an open breaker degrades to the
    local element instead of failing the frame."""
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    front_def, back_def = _remote_pair_defs(fallback=True)
    front = Pipeline(front_def, runtime=runtime)
    back = Pipeline(back_def, runtime=runtime)
    responses = queue.Queue()
    front.create_stream_local("w", {"frame_deadline_ms": 0},
                              queue_response=responses)
    front.ingest_local("w", {"x": 0}, queue_response=responses)
    warm = collect(runtime, responses, 1)
    assert warm and warm[0][4]
    front.create_stream_local("1", queue_response=responses)

    front.arm_faults({"rules": [
        {"point": "wire_drop", "target": "process_frame_response",
         "count": 2}]})
    for _ in range(2):
        front.ingest_local("1", {"x": 0}, queue_response=responses)
        rows = collect(runtime, responses, 1, timeout=10.0)
        assert rows and not rows[0][4]
    assert front.breakers["fwd"].state == BREAKER_OPEN

    front.ingest_local("1", {"x": 5}, queue_response=responses)
    rows = collect(runtime, responses, 1, timeout=10.0)
    assert rows and rows[0][4], rows[0][5]
    # inc (5->6) then CheapLocal fallback (+100), not the remote inc.
    assert int(rows[0][2]["x"]) == 106
    assert rows[0][3].get("breaker_fallbacks") == 1
    front.stop()
    back.stop()


def test_wire_dup_response_never_resumes_a_local_park(runtime):
    """A duplicated remote response (wire_dup fault, MQTT QoS1
    redelivery) must be discarded once the frame has moved past the
    remote stage -- mapping remote outputs under a LOCAL element would
    silently replace its real result."""
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    back = Pipeline(
        {"version": 0, "name": "back", "runtime": "torch",
         "graph": ["(inc)"],
         "elements": [{"name": "inc", "input": [{"name": "x"}],
                       "output": [{"name": "x"}],
                       "deploy": {"local": {
                           "module": "aiko_services_tpu_torch.elements.common",
                           "class_name": "Increment"}}}]},
        runtime=runtime)
    front = Pipeline(
        {"version": 0, "name": "front", "runtime": "torch",
         "graph": ["(fwd post)"],
         "elements": [
             {"name": "fwd", "input": [{"name": "x"}],
              "output": [{"name": "x"}],
              "deploy": {"remote": {"name": "back"}}},
             {"name": "post", "input": [{"name": "x"}],
              "output": [{"name": "x"}],
              "parameters": {"delay_ms": 60.0},
              "deploy": {"local": {"module": "tests/test_torch_chaos.py",
                                   "class_name": "SlowAsyncAdd"}}}]},
        runtime=runtime)
    responses = queue.Queue()
    front.create_stream_local("1", queue_response=responses)
    front.ingest_local("1", {"x": 0}, queue_response=responses)
    rows = collect(runtime, responses, 1)
    assert rows and rows[0][4], rows[0]

    front.arm_faults({"rules": [
        {"point": "wire_dup", "target": "process_frame_response",
         "count": 1}]})
    front.ingest_local("1", {"x": 10}, queue_response=responses)
    rows = collect(runtime, responses, 1, timeout=15.0)
    assert len(rows) == 1                   # duplicate never delivered
    assert rows[0][4], rows[0][5]
    # remote inc once (10 -> 11) THEN the async +1000: a duplicate
    # response short-circuiting post's park would deliver 11.
    assert int(rows[0][2]["x"]) == 1011
    assert front.fault_stats()["plan"]["fired"]["wire_dup"] == 1
    front.stop()
    back.stop()


def test_remote_retry_limit_errors_with_clear_message(runtime):
    """An undiscovered remote bounded by remote_retry_limit errors the
    frame with an actionable diagnostic; limit 0 keeps the unbounded
    pre-existing behavior."""
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    front = Pipeline(
        {"version": 0, "name": "front", "runtime": "torch",
         "graph": ["(fwd)"],
         "parameters": {"remote_retry_limit": 2},
         "elements": [
             {"name": "fwd", "input": [{"name": "x"}],
              "output": [{"name": "x"}],
              "deploy": {"remote": {"name": "nowhere"}}}]},
        runtime=runtime)
    responses = queue.Queue()
    front.create_stream_local("1", queue_response=responses)
    front.ingest_local("1", {"x": 0}, queue_response=responses)
    rows = collect(runtime, responses, 1, timeout=30.0)
    assert rows and not rows[0][4]
    assert "remote_retry_limit=2" in rows[0][5]
    assert "is the remote pipeline running?" in rows[0][5]
    front.stop()

    # limit 0: unbounded -- the frame stays parked, stream alive.
    unbounded = Pipeline(
        {"version": 0, "name": "front0", "runtime": "torch",
         "graph": ["(fwd)"],
         "parameters": {"remote_retry_limit": 0},
         "elements": [
             {"name": "fwd", "input": [{"name": "x"}],
              "output": [{"name": "x"}],
              "deploy": {"remote": {"name": "nowhere"}}}]},
        runtime=runtime)
    responses = queue.Queue()
    unbounded.create_stream_local("1", queue_response=responses)
    unbounded.ingest_local("1", {"x": 0}, queue_response=responses)
    runtime.run(timeout=1.5)
    assert unbounded.streams["1"].in_flight == 1     # still parked
    assert responses.empty()
    unbounded.stop()


# -- (c) overload shedding ---------------------------------------------------


def test_overload_sheds_with_inorder_delivery(runtime):
    """2x overload on a live stream with shed_oldest: some frames shed
    (counted, error-responded), the rest complete, delivery order is
    ingest order, nothing hangs."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_shed", "runtime": "torch",
         "graph": ["(det llm)"],
         "parameters": {"overload_policy": "shed_oldest",
                        "overload_limit": 3,
                        "stage_inflight": 1},
         "elements": [
             element("det", "BusyStage", parameters={"busy_ms": 25.0},
                     placement={"devices": 4}),
             element("llm", "BusyStage", parameters={"busy_ms": 25.0},
                     placement={"devices": 4})]},
        runtime=runtime)
    responses = queue.Queue()
    n_frames = 12
    ingest(pipeline, responses, n_frames)
    rows = collect(runtime, responses, n_frames)
    assert len(rows) == n_frames, "responses lost under shedding"
    shed = [row for row in rows if not row[4]]
    okay = [row for row in rows if row[4]]
    assert pipeline.share["frames_shed"] > 0
    assert len(shed) == pipeline.share["frames_shed"]
    assert all("shed: overload" in row[5] for row in shed)
    assert okay, "everything shed: limit too tight"
    # In-order delivery preserved across sheds.
    order = [row[1] for row in rows]
    assert order == sorted(order)
    assert "0" in pipeline.streams          # shed never ERRORs a stream
    pipeline.stop()


def test_shed_newest_refuses_incoming(runtime):
    pipeline = Pipeline(
        {"version": 0, "name": "p_shed_new", "runtime": "torch",
         "graph": ["(echo)"],
         "parameters": {"overload_policy": "shed_newest",
                        "overload_limit": 2},
         "elements": [element("echo", "SlowAsyncEcho",
                              parameters={"delay_ms": 80.0})]},
        runtime=runtime)
    responses = queue.Queue()
    ingest(pipeline, responses, 6)
    rows = collect(runtime, responses, 6)
    assert len(rows) == 6
    shed = [row for row in rows if not row[4]]
    assert shed and all("shed: overload" in row[5] for row in shed)
    assert pipeline.share["frames_shed"] == len(shed)
    assert len(rows) - len(shed) >= 2
    pipeline.stop()


# -- deadlines ---------------------------------------------------------------


def test_deadline_fails_parked_frame_without_killing_stream(runtime):
    """A frame parked at a stage that never answers in time errors at
    its deadline; the stream survives and later frames complete."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_deadline", "runtime": "torch",
         "graph": ["(echo)"],
         "parameters": {"frame_deadline_ms": 60},
         "elements": [element("echo", "SlowAsyncEcho",
                              parameters={"delay_ms": 500.0})]},
        runtime=runtime)
    responses = queue.Queue()
    ingest(pipeline, responses, 1)
    start = time.monotonic()
    rows = collect(runtime, responses, 1, timeout=10.0)
    elapsed = time.monotonic() - start
    assert rows and not rows[0][4]
    assert "deadline exceeded" in rows[0][5]
    assert elapsed < 0.45, "deadline error arrived after the work"
    assert pipeline.share["deadline_misses"] == 1
    assert "0" in pipeline.streams           # stream survived the miss

    # Stream still serves: a fast frame completes fine.
    pipeline.graph.get_node("echo").element.set_parameter(
        "delay_ms", 1.0)
    ingest(pipeline, responses, 1)
    rows = collect(runtime, responses, 1, timeout=10.0)
    assert rows and rows[0][4], rows[0][5]
    pipeline.stop()


# -- satellites: probe timeout, stall, live arm/disarm -----------------------


def test_health_probe_timeout_parameter_plumbs_through(runtime):
    """The ``health_probe_timeout`` pipeline parameter bounds a hung
    prober (device_hang injection) instead of the hardcoded 5 s."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_timeout", "runtime": "torch",
         "graph": ["(sq)"],
         "parameters": {"health_probe_timeout": 0.2},
         "elements": [element("sq", "BusyStage",
                              parameters={"busy_ms": 0.0},
                              placement={"mesh": {"dp": 8}})]},
        runtime=runtime)
    pipeline.arm_faults({"rules": [
        {"point": "device_hang", "target": "device:0", "count": 1,
         "delay_ms": 3000.0}]})
    start = time.perf_counter()
    failed = pipeline.check_device_health()
    elapsed = time.perf_counter() - start
    assert len(failed) == 1                 # hung chip counted as dead
    assert elapsed < 2.0, "probe ignored health_probe_timeout"
    assert pipeline.stage_placement.generation == 1
    pipeline.stop()


def test_stage_stall_delays_but_preserves_order(runtime):
    """stage_stall occupies one stage's FIFO worker; queued frames wait
    behind the stall and still deliver in order."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_stall", "runtime": "torch",
         "graph": ["(det llm)"],
         "parameters": {"fault_plan": {"rules": [
             {"point": "stage_stall", "target": "llm", "count": 1,
              "delay_ms": 150.0}]}},
         "elements": [
             element("det", "BusyStage", parameters={"busy_ms": 2.0},
                     placement={"devices": 4}),
             element("llm", "BusyStage", parameters={"busy_ms": 2.0},
                     placement={"devices": 4})]},
        runtime=runtime)
    responses = queue.Queue()
    start = time.perf_counter()
    ingest(pipeline, responses, 4)
    rows = collect(runtime, responses, 4)
    elapsed = time.perf_counter() - start
    assert len(rows) == 4 and all(row[4] for row in rows)
    assert elapsed > 0.14, "stall never hit the worker"
    assert [row[1] for row in rows] == sorted(row[1] for row in rows)
    assert pipeline.fault_stats()["plan"]["fired"]["stage_stall"] == 1
    pipeline.stop()


def test_live_arm_and_disarm_via_set_parameter(runtime):
    """The dashboard path: ``set_parameter fault_plan <json>`` arms a
    running pipeline; an empty value disarms."""
    pipeline = Pipeline(
        {"version": 0, "name": "p_live", "runtime": "torch",
         "graph": ["(inc)"],
         "elements": [
             {"name": "inc", "input": [{"name": "x"}],
              "output": [{"name": "x"}],
              "deploy": {"local": {
                  "module": "aiko_services_tpu_torch.elements.common",
                  "class_name": "Increment"}}}]},
        runtime=runtime)
    pipeline.set_parameter(
        "fault_plan",
        '{"rules": [{"point": "element_raise", "target": "inc", '
        '"count": 1}]}')
    assert pipeline.share["faults_armed"] is True
    responses = queue.Queue()
    pipeline.create_stream_local("a", queue_response=responses)
    pipeline.ingest_local("a", {"x": 1}, queue_response=responses)
    rows = collect(runtime, responses, 1)
    assert rows and not rows[0][4]          # unplaced: no replay path
    assert "injected device failure" in rows[0][5]
    pipeline.set_parameter("fault_plan", "off")
    assert pipeline.share["faults_armed"] is False
    assert pipeline.fault_stats()["armed"] is False
    pipeline.stop()


def test_fallback_definition_validation():
    from aiko_services_tpu_torch.pipeline.definition import (
        DefinitionError, parse_pipeline_definition)

    base = {"version": 0, "name": "p", "runtime": "torch",
            "graph": ["(fwd)"],
            "elements": [
                {"name": "fwd", "input": [], "output": [],
                 "deploy": {"remote": {"name": "back"}},
                 "fallback": "missing"}]}
    with pytest.raises(DefinitionError, match="not a defined element"):
        parse_pipeline_definition(base)
    local = {"version": 0, "name": "p", "runtime": "torch",
             "graph": ["(a)"],
             "elements": [
                 {"name": "a", "input": [], "output": [],
                  "deploy": {"local": {"module": "m",
                                       "class_name": "C"}},
                  "fallback": "a"}]}
    with pytest.raises(DefinitionError, match="remote-deployed"):
        parse_pipeline_definition(local)


def test_device_window_invalidate_drops_dead_leaves():
    from aiko_services_tpu_torch.pipeline.overlap import DeviceWindow

    # A CPU tensor carries no index, so a meta tensor stands for the
    # leaf on the lost card.
    lost = torch.device("meta")
    window = DeviceWindow()
    alive = torch.ones(4)
    doomed = torch.ones(4, device=lost)
    window.note(0, {"x": doomed})
    window.note(1, {"x": alive})
    assert window.outstanding == 2
    assert window.invalidate({lost}) == 1
    assert window.outstanding == 1
    window.drain()                          # survivor still paceable


# -- replicated stages: replica death under load ------------------------------


def replicated_chaos_definition(parameters=None):
    """detect at ``replicas: 3`` (2 chips each) feeding an unreplicated
    placed llm -- the BENCH e2e shape, 8 chips total on the CPU mesh."""
    return {
        "version": 0, "name": "p_replica_chaos", "runtime": "torch",
        "graph": ["(detect llm)"],
        "parameters": dict(parameters or {}),
        "elements": [
            element("detect", "BusyStage",
                    parameters={"busy_ms": 25.0},
                    placement={"devices": 2, "replicas": 3}),
            element("llm", "BusyStage", parameters={"busy_ms": 5.0},
                    placement={"devices": 2})]}


def test_replica_device_kill_sheds_to_peers_in_order_under_load(runtime):
    """The replica-failover acceptance walk: detect at ``replicas: 3``, a
    ``device_kill`` rule targeting ONE replica (``detect#1``) fires
    under >= 12 in-flight frames across two streams.  Every stream
    completes -- zero dropped, zero duplicated, in ingest order per
    stream -- the group keeps serving at N-1 (no generation bump, the
    peer-shed path, NOT stop-the-world replace), and the dead slot
    shows on the telemetry gauges."""
    pipeline = Pipeline(
        replicated_chaos_definition(parameters={
            "replay_limit": 3,
            "replica_rebuild_ms": 0,        # hold the N-1 state
            "telemetry": "on",
            "health_probe_timeout": 2.0,
            "fault_plan": {"rules": [
                {"point": "device_kill", "target": "detect#1",
                 "count": 1}]}}),
        runtime=runtime)
    n_frames = 7
    responses_a: queue.Queue = queue.Queue()
    responses_b: queue.Queue = queue.Queue()
    ingest(pipeline, responses_a, n_frames, stream_id="a")
    ingest(pipeline, responses_b, n_frames, stream_id="b")

    # Wait until replica 1 actually holds admitted frames, then run the
    # health probe: the armed rule marks exactly that submesh dead.
    def replica1_busy():
        return any(frame.stage == "detect" and frame.stage_replica == 1
                   for stream in pipeline.streams.values()
                   for frame in stream.frames.values())

    assert run_until(runtime, replica1_busy, timeout=30.0), \
        "no frame ever admitted to replica 1"
    in_flight = sum(len(stream.frames)
                    for stream in pipeline.streams.values())
    assert in_flight >= 12, f"only {in_flight} frames in flight"
    pipeline.post_self("check_device_health")
    rows_a = collect(runtime, responses_a, n_frames, timeout=120.0)
    rows_b = collect(runtime, responses_b, n_frames, timeout=120.0)
    for rows in (rows_a, rows_b):
        assert len(rows) == n_frames, \
            f"{len(rows)}/{n_frames}: dropped frames after replica kill"
        assert all(row[4] for row in rows), \
            [row[5] for row in rows if not row[4]]
        order = [row[1] for row in rows]
        assert order == sorted(order), f"out of order: {order}"
        assert len(order) == len(set(order)), "duplicate delivery"
    # Peer-shed semantics: generation unchanged, peers alive at N-1,
    # the dead replica's in-flight frames replayed.
    placement = pipeline.stage_placement
    assert placement.generation == 0, "failover escalated to replace()"
    assert placement.live_replicas("detect") == [0, 2]
    assert pipeline.share["replica_failovers"] == 1
    assert pipeline.share["replica_failover_ms"] > 0
    assert pipeline.share["frames_replayed"] > 0
    assert pipeline.fault_stats()["plan"]["fired"] == {"device_kill": 1}
    # Scrape-side view: the dead slot reads 0 on the replica_state
    # gauge while its peers read 1.
    states = {}
    for line in pipeline.metrics_text().splitlines():
        if line.startswith("aiko_replica_state{"):
            states[line] = line.rsplit(" ", 1)[1]
    assert sorted(states.values()) == ["0", "1", "1"], states
    stats = pipeline.replica_stats()
    assert stats["stages"]["detect"]["states"] == \
        ["live", "dead", "live"]
    pipeline.stop()


def test_replica_failover_strictly_cheaper_than_full_replace(runtime):
    """The robustness dividend, counted: peer-shedding one dead replica
    touches ONE submesh -- generation unchanged, every other plan kept,
    only that replica's in-flight frames replayed -- while the
    stop-the-world ``replace_failed_devices`` rebuild re-carves every
    stage (generation 1, no plan kept).  (The reference times the two
    against each other; the wall-clock race is unsteady, so the twin
    holds what each path does.)"""
    pipeline = Pipeline(
        replicated_chaos_definition(parameters={
            "replay_limit": 4, "replica_rebuild_ms": 0}),
        runtime=runtime)
    placement = pipeline.stage_placement
    n_frames = 8
    responses: queue.Queue = queue.Queue()
    ingest(pipeline, responses, n_frames, stream_id="a")

    def on_replica(index):
        return sum(1 for stream in pipeline.streams.values()
                   for frame in stream.frames.values()
                   if frame.stage == "detect"
                   and frame.stage_replica == index)

    assert run_until(runtime, lambda: on_replica(1) >= 1, timeout=30.0)
    plans = {"llm": placement.plans["llm"],
             **{("detect", index): plan for index, plan in
                enumerate(placement.replica_plans["detect"])}}
    replayed = pipeline.share["frames_replayed"]
    stranded = on_replica(1)
    pipeline.fail_replica("detect", 1)
    assert placement.generation == 0
    assert pipeline.share["frames_replayed"] - replayed == stranded
    assert placement.plans["llm"] is plans["llm"]
    for index in (0, 2):
        assert placement.replica_plans["detect"][index] \
            is plans["detect", index]
    assert placement.replica_plans["detect"][1] is None
    rows = collect(runtime, responses, n_frames, timeout=120.0)
    assert all(row[4] for row in rows), \
        [row[5] for row in rows if not row[4]]
    assert pipeline.share["replica_failover_ms"] > 0

    # Same pipeline, comparable load: now kill the llm stage's chips --
    # outside any replica, so recovery MUST stop the world.
    responses = queue.Queue()
    ingest(pipeline, responses, n_frames, stream_id="b")

    def llm_busy():
        return sum(1 for stream in pipeline.streams.values()
                   for frame in stream.frames.values()) >= 2

    assert run_until(runtime, llm_busy, timeout=30.0)
    kept = dict(placement.plans)
    dead = list(placement.plans["llm"].mesh.devices.flat)[:1]
    pipeline.replace_failed_devices(dead)
    assert placement.generation == 1
    assert all(placement.plans[name] is not plan
               for name, plan in kept.items()), "a stage kept its plan"
    rows = collect(runtime, responses, n_frames, timeout=120.0)
    assert all(row[4] for row in rows), \
        [row[5] for row in rows if not row[4]]
    pipeline.stop()


def test_replica_scoped_dispatch_probe_spares_healthy_peers(runtime):
    """Dispatch-time chip death on a replicated stage: the raising
    frame's probe is SCOPED to its own replica's submesh, so the armed
    ``device_kill`` confirms THAT replica dead and the peers never get
    probed, marked, or replayed -- one slot fails, N-1 serve on,
    generation unchanged."""
    pipeline = Pipeline(
        replicated_chaos_definition(parameters={
            "replay_limit": 3,
            "replica_rebuild_ms": 0,
            "health_probe_timeout": 2.0,
            "fault_plan": {"rules": [
                # The FIRST detect dispatch raises; round-robin admits
                # frame 0 to replica 0, so the scoped probe walks
                # replica 0's chips and finds them dead.
                {"point": "element_raise", "target": "detect",
                 "count": 1},
                {"point": "device_kill", "target": "detect#0",
                 "count": 1}]}}),
        runtime=runtime)
    n_frames = 4
    responses: queue.Queue = queue.Queue()
    ingest(pipeline, responses, n_frames)
    rows = collect(runtime, responses, n_frames, timeout=120.0)
    assert len(rows) == n_frames
    assert all(row[4] for row in rows), \
        [row[5] for row in rows if not row[4]]
    placement = pipeline.stage_placement
    assert placement.generation == 0, \
        "scoped probe escalated to a full replace"
    assert placement.live_replicas("detect") == [1, 2]
    assert pipeline.share["replica_failovers"] == 1
    assert pipeline.share["frames_replayed"] >= 1
    fired = pipeline.fault_stats()["plan"]["fired"]
    assert fired == {"element_raise": 1, "device_kill": 1}
    pipeline.stop()


def test_decode_block_kill_replays_generation_from_last_block(runtime):
    """A ``decode_block`` device_kill firing
    MID-GENERATION (after the first loop block retired, so tokens are
    already committed) replays every live request from its last
    emitted block -- the frame completes with text IDENTICAL to an
    unfaulted run (nothing lost, nothing re-emitted), one recovery."""
    def llm_pipeline(name, fault_rules):
        parameters = {}
        if fault_rules:
            parameters["fault_plan"] = {"rules": fault_rules}
        return Pipeline(
            {"version": 0, "name": name, "runtime": "torch",
             "parameters": parameters,
             "graph": ["(llm)"],
             "elements": [{
                 "name": "llm",
                 "input": [{"name": "text"}],
                 "output": [{"name": "text"}],
                 # inflight 1: each step dispatches one block (one
                 # probe) and retires it, so ``after: 1`` fires with
                 # block 1's tokens already emitted.
                 "parameters": {"max_new_tokens": 12, "max_seq": 64,
                                "decode_block_tokens": 4, "inflight": 1,
                                "device": "cpu"},
                 "deploy": {"local": {
                     "module": "aiko_services_tpu_torch.elements.llm",
                     "class_name": "LLM"}}}]},
            runtime=runtime)

    def generate(pipeline):
        responses: queue.Queue = queue.Queue()
        stream = pipeline.create_stream_local(
            "s", queue_response=responses)
        pipeline.create_frame_local(stream, {"text": "chaos prompt"})
        assert run_until(runtime, lambda: not responses.empty(),
                         timeout=120.0)
        _, _, swag, _, okay, diagnostic = responses.get()
        assert okay, diagnostic
        return swag["text"]

    reference_pipe = llm_pipeline("llm_ref", None)
    reference = generate(reference_pipe)
    reference_pipe.stop()

    pipeline = llm_pipeline("llm_chaos", [
        {"point": "decode_block", "target": "llm", "after": 1,
         "count": 1}])
    text = generate(pipeline)
    assert text == reference, "replayed generation diverged"
    batcher = pipeline.graph.get_node("llm").element._batcher
    assert batcher.recoveries == 1
    assert pipeline.fault_stats()["plan"]["fired"] == {"decode_block": 1}
    pipeline.stop()


def test_decode_block_hang_delays_but_completes(runtime):
    """A ``decode_block`` rule WITH delay_ms hangs one dispatch; the
    generation still completes (no recovery fired -- a hang is not a
    death)."""
    pipeline = Pipeline(
        {"version": 0, "name": "llm_hang", "runtime": "torch",
         "parameters": {"fault_plan": {"rules": [
             {"point": "decode_block", "target": "llm", "count": 1,
              "delay_ms": 150}]}},
         "graph": ["(llm)"],
         "elements": [{
             "name": "llm",
             "input": [{"name": "text"}],
             "output": [{"name": "text"}],
             "parameters": {"max_new_tokens": 6, "max_seq": 64,
                            "decode_block_tokens": 4, "device": "cpu"},
             "deploy": {"local": {
                 "module": "aiko_services_tpu_torch.elements.llm",
                 "class_name": "LLM"}}}]},
        runtime=runtime)
    responses: queue.Queue = queue.Queue()
    stream = pipeline.create_stream_local("s", queue_response=responses)
    pipeline.create_frame_local(stream, {"text": "hang on"})
    assert run_until(runtime, lambda: not responses.empty(),
                     timeout=120.0)
    _, _, swag, _, okay, diagnostic = responses.get()
    assert okay, diagnostic
    assert isinstance(swag["text"], str)
    batcher = pipeline.graph.get_node("llm").element._batcher
    assert batcher.recoveries == 0
    assert pipeline.fault_stats()["plan"]["fired"] == {"decode_block": 1}
    pipeline.stop()


# -- (e) wire-fault parity on the tensor-pipe data plane ---------------------
#
# The control envelope still rides MQTT when tensors take the pipe, so
# every ``wire_*`` rule must fire on a pipe-data-plane pipeline with
# the SAME blast radius and the SAME recovery (deadline -> breaker ->
# reclose; dup discard) the MQTT path shows -- chaos coverage must not
# narrow when the data moves off the broker.


def _pipe_remote_pair(runtime, **front_params):
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    back = Pipeline(
        {"version": 0, "name": "back", "runtime": "torch",
         "graph": ["(inc)"],
         "elements": [element("inc", "Identity",
                              module="aiko_services_tpu_torch.elements"
                                     ".common")]},
        runtime=runtime)
    front = Pipeline(
        {"version": 0, "name": "front", "runtime": "torch",
         "graph": ["(fwd)"],
         "parameters": {"frame_deadline_ms": 400,
                        "breaker_threshold": 2,
                        "breaker_cooldown_ms": 250, **front_params},
         "elements": [
             {"name": "fwd", "input": [{"name": "x"}],
              "output": [{"name": "x"}],
              "deploy": {"remote": {"name": "back"}}}]},
        runtime=runtime)
    stage = front.graph.get_node("fwd").element
    assert run_until(runtime,
                     lambda: stage.remote_topic_path is not None,
                     timeout=10.0)
    assert stage.remote_pipe is not None      # pipe negotiated
    return front, back


def test_wire_drop_parity_on_tensor_pipe_path(runtime):
    """wire_drop of responses on a PIPE-data-plane pipeline: the exact
    MQTT-path walk -- two deadline misses open the breaker, fail-fast,
    half-open probe recloses once the wire heals -- with tensors
    verifiably riding the pipe and EXACTLY two rule firings."""
    front, back = _pipe_remote_pair(runtime)
    responses = queue.Queue()
    x = np.arange(4096, dtype=np.float32)
    front.create_stream_local("w", {"frame_deadline_ms": 0},
                              queue_response=responses)
    front.ingest_local("w", {"x": x}, queue_response=responses)
    warm = collect(runtime, responses, 1)
    assert warm and warm[0][4], warm[0]
    assert front.data_plane_stats()["pipe_frames"] >= 1
    front.create_stream_local("1", queue_response=responses)

    front.arm_faults({"rules": [
        {"point": "wire_drop", "target": "process_frame_response",
         "count": 2}]})
    for _ in range(2):
        front.ingest_local("1", {"x": x}, queue_response=responses)
        rows = collect(runtime, responses, 1, timeout=10.0)
        assert rows and not rows[0][4]
        assert "deadline" in rows[0][5]
    breaker = front.breakers["fwd"]
    assert breaker.state == BREAKER_OPEN
    assert front.share["deadline_misses"] == 2

    front.ingest_local("1", {"x": x}, queue_response=responses)
    rows = collect(runtime, responses, 1, timeout=10.0)
    assert rows and not rows[0][4]
    assert "circuit breaker open" in rows[0][5]
    assert "1" in front.streams                  # stream alive

    time.sleep(0.3)
    front.ingest_local("1", {"x": x}, queue_response=responses)
    rows = collect(runtime, responses, 1, timeout=10.0)
    assert rows and rows[0][4], rows[0][5]
    np.testing.assert_array_equal(np.asarray(rows[0][2]["x"]), x)
    assert breaker.state == BREAKER_CLOSED
    assert [s for s, _ in breaker.transitions] == \
        ["open", "half_open", "closed"]
    # Exact blast radius, via the plan trace -- identical to MQTT.
    plan = front.fault_stats()["plan"]
    assert plan["fired"]["wire_drop"] == 2
    assert len([t for t in plan["trace"]
                if t["point"] == "wire_drop"]) == 2
    # The recovered frames still used the pipe for their tensors.
    assert front.data_plane_stats()["pipe_frames"] >= 3
    front.stop()
    back.stop()


def test_wire_corrupt_and_dup_parity_on_tensor_pipe_path(runtime):
    """wire_corrupt of a process_frame envelope on the pipe path: the
    receiver's parse drops it (same as MQTT), the parked frame
    deadline-fails without killing the stream, the next frame flows.
    wire_dup of a response: the duplicate is discarded once the frame
    moved on -- one delivery, correct value."""
    front, back = _pipe_remote_pair(runtime)
    responses = queue.Queue()
    x = np.arange(1024, dtype=np.int32)
    front.create_stream_local("w", {"frame_deadline_ms": 0},
                              queue_response=responses)
    front.ingest_local("w", {"x": x}, queue_response=responses)
    warm = collect(runtime, responses, 1)
    assert warm and warm[0][4], warm[0]

    front.create_stream_local("1", queue_response=responses)
    front.arm_faults({"rules": [
        {"point": "wire_corrupt", "target": "process_frame",
         "count": 1}]})
    front.ingest_local("1", {"x": x}, queue_response=responses)
    rows = collect(runtime, responses, 1, timeout=10.0)
    assert rows and not rows[0][4]
    assert "deadline" in rows[0][5]
    assert "1" in front.streams                  # stream alive
    front.ingest_local("1", {"x": x}, queue_response=responses)
    rows = collect(runtime, responses, 1, timeout=10.0)
    assert rows and rows[0][4], rows[0][5]

    front.arm_faults({"rules": [
        {"point": "wire_dup", "target": "process_frame_response",
         "count": 1}]})
    front.ingest_local("1", {"x": x}, queue_response=responses)
    rows = collect(runtime, responses, 2, timeout=5.0)
    assert len(rows) == 1                        # duplicate discarded
    assert rows[0][4], rows[0][5]
    np.testing.assert_array_equal(np.asarray(rows[0][2]["x"]), x)
    plan = front.fault_stats()["plan"]
    assert plan["fired"] == {"wire_dup": 1}      # re-armed plan
    front.stop()
    back.stop()
