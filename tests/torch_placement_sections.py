"""The placement sections of ``__graft_entry__.dryrun_multichip`` run
through the port: ``[placement]`` (3), ``[replacement]`` (4),
``[config4]`` (7), ``[stage-pipeline]`` (8), ``[chaos]`` (9),
``[replica-failover]`` (10) and ``[gateway]`` (11), each with the JAX
section's assertions, over a pool of four devices (five pool positions
for the replica failover).  Imports only the port, so the same sections run on
four CPU descriptors (``tests/test_torch_placement.py``) and on four
cards (``tests/test_torch_placement_cuda.py``).

The device pool is ``device.local_devices()``, as the port's pipelines
read it: the callers patch it to CPU descriptors on the CPU and leave
it alone on the card.  Each section returns what its callers hold
further (the placement, the frames' results, the elements' counts)."""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch

from aiko_services_tpu_torch.elements.common import StageWork
from aiko_services_tpu_torch.parallel import P
from aiko_services_tpu_torch.pipeline import Pipeline
from aiko_services_tpu_torch.pipeline.tensor import StagePlacement, resident

COMMON = "aiko_services_tpu_torch.elements.common"


@contextlib.contextmanager
def port_runtime():
    """A fresh process runtime of the port on its in-memory loopback
    broker, torn down on exit."""
    from aiko_services_tpu_torch.runtime import init_process, reset_process
    from aiko_services_tpu_torch.services.share import reset_services_cache
    from aiko_services_tpu_torch.transport import reset_broker
    reset_broker()
    reset_services_cache()
    runtime = init_process(transport="loopback")
    runtime.initialize()
    try:
        yield runtime
    finally:
        runtime.engine.terminate()
        reset_process()
        reset_services_cache()
        reset_broker()


def collect(runtime, responses, count: int, timeout: float = 300.0) -> list:
    collected: list = []

    def drained():
        while not responses.empty():
            collected.append(responses.get())
        return len(collected) >= count
    runtime.run(until=drained, timeout=timeout)
    return collected


# -- 3. [placement] and 4. [replacement] ------------------------------------

def placement_hops(devices: list, x: torch.Tensor) -> tuple:
    """Two disjoint stage submeshes and the frame hops between them:
    ``x`` onto detect split over dp, then onto llm split over tp ->
    (placement, on_detect, on_llm)."""
    half = len(devices) // 2
    placement = StagePlacement(devices)
    placement.assign({"detect": {"dp": half}, "llm": {"tp": half}})
    on_detect = placement.transfer(x, "detect", P("dp", None))
    on_llm = placement.transfer(on_detect, "llm", P(None, "tp"))
    whole = placement.plan("llm").gather(on_llm)
    assert float(whole.sum()) == float(x.sum()), "transfer corrupted data"
    assert dict(on_llm.sharding.mesh.shape) == {"tp": half}
    assert set(on_llm.mesh.devices.flat) \
        == set(placement.plan("llm").mesh.devices.flat)
    return placement, on_detect, on_llm


def replacement_hop(placement: StagePlacement, x: torch.Tensor) -> tuple:
    """Half of detect's devices "fail": the stages re-place onto the
    survivors (shrinking) and a hop still lands -> (dead devices, the
    hop's value)."""
    half = len(placement.devices) // 2
    dead = list(placement.plans["detect"].mesh.devices.flat)[:half // 2]
    placement.replace(dead)
    survivors = {d for plan in placement.plans.values()
                 for d in plan.mesh.devices.flat}
    assert not (survivors & set(dead)), "dead device still placed"
    rehop = placement.transfer(x, "llm")
    assert float(rehop.sum()) == float(x.sum())
    for stage, plan in placement.plans.items():
        lead = placement.stage_sharding(stage)
        assert lead not in dead and lead == plan.device
        assert resident(placement.transfer(x, stage), lead)
    assert resident(rehop, placement.plan("llm").device)
    return dead, rehop


# -- 7. [config4] ------------------------------------------------------------

def config4_definition(half: int, llm: dict, frames: int,
                       det_mesh: dict | None = None) -> dict:
    """``(DET (CAP (LLM)))``: detect on ``{"dp": half}`` (or
    ``det_mesh``), the LLM stage on ``{"tp": half}``."""
    root = "aiko_services_tpu_torch.elements"
    return {
        "version": 0, "name": "config4", "runtime": "torch",
        "graph": ["(DET (CAP (LLM)))"],
        "elements": [
            {"name": "DET",
             "input": [{"name": "image"}],
             "output": [{"name": "image"}, {"name": "overlay"},
                        {"name": "detections"}],
             "parameters": {"width": 4, "max_batch": frames},
             "placement": {"mesh": det_mesh or {"dp": half}},
             "deploy": {"local": {"module": f"{root}.detect",
                                  "class_name": "Detector"}}},
            {"name": "CAP",
             "input": [{"name": "detections"}],
             "output": [{"name": "text"}],
             "deploy": {"local": {"module": f"{root}.llm",
                                  "class_name": "DetectionCaption"}}},
            {"name": "LLM",
             "input": [{"name": "text"}],
             "output": [{"name": "text"}],
             "parameters": llm,
             "placement": {"mesh": {"tp": half}},
             "deploy": {"local": {"module": f"{root}.llm",
                                  "class_name": "LLM"}}}]}


def config4(devices: list, llm: dict | None = None, frames: int = 8,
            max_new: int = 8, det_mesh: dict | None = None) -> dict:
    """The flagship composition through the engine: detect on half the
    devices (dp), the LLM stage on the other half (tp), both async.
    Returns the frames' detections (frame id -> list) and the
    elements' counts."""
    half = len(devices) // 2
    llm = {"max_new_tokens": max_new, "max_seq": 64, **(llm or {})}
    with port_runtime() as runtime:
        pipeline = Pipeline(config4_definition(half, llm, frames, det_mesh),
                            runtime=runtime)
        det_devs = set(
            pipeline.stage_placement.plan("DET").mesh.devices.flat)
        llm_devs = set(
            pipeline.stage_placement.plan("LLM").mesh.devices.flat)
        assert not det_devs & llm_devs, "stages share chips"
        responses: queue.Queue = queue.Queue()
        rng = np.random.default_rng(0)
        for _ in range(frames):
            pipeline.process_frame_local(
                {"image": rng.integers(0, 255, (64, 64, 3),
                                       dtype=np.uint8)},
                stream_id="config4", queue_response=responses)
        collected = collect(runtime, responses, frames)
        assert len(collected) == frames, \
            f"config4: {len(collected)}/{frames} frames completed"
        for *_, okay, diagnostic in collected:
            assert okay, f"config4 frame failed: {diagnostic}"
        det = pipeline.graph.get_node("DET").element
        assert dict(det.plan.mesh.shape) == (det_mesh or {"dp": half}), \
            "detect did not resolve its placed submesh"
        dispatches = det.jit_cache.hits + det.jit_cache.misses
        micro_batches = det.position_stats[0]["batches"]
        assert micro_batches < frames, (
            f"{micro_batches} detect dispatches for {frames} frames: "
            "parked frames were not micro-batched")
        element = pipeline.graph.get_node("LLM").element
        steps = element._batcher.steps
        assert steps < frames * max_new * 0.6, (
            f"{steps} decode steps for {frames}x{max_new} tokens: frames "
            "did not overlap at the LLM stage")
        failed = pipeline.check_device_health()
        out = {"det_devices": det_devs, "llm_devices": llm_devs,
               "detections": {row[1]: row[2]["detections"]
                              for row in collected},
               "dispatches": dispatches, "micro_batches": micro_batches,
               "positions": [dict(stats) for stats in det.position_stats],
               "graph_devices": det.jit_cache.devices,
               "llm_steps": steps, "health_failed": failed}
        pipeline.stop()
        element.close()
    return out


# -- 8. [stage-pipeline] ----------------------------------------------------

def stage_element(name: str, parameters: dict, devices) -> dict:
    return {"name": name, "input": [{"name": "x"}],
            "output": [{"name": "x"}], "parameters": parameters,
            "placement": {"devices": devices},
            "deploy": {"local": {"module": COMMON,
                                 "class_name": "StageWork"}}}


def stage_pipeline(devices: list, frame=None, parameters=None) -> dict:
    """Two ``StageWork`` stages on an auto split, overlapped on their
    stage workers and delivered in order.  ``frame(rng)`` makes each
    frame's ``x`` (a float32 numpy array, as the JAX section's, by
    default)."""
    n_devices = len(devices)
    n_frames = 8
    frame = frame or (lambda rng: rng.standard_normal(
        (32, 32)).astype(np.float32))
    with port_runtime() as runtime:
        pipeline = Pipeline(
            {"version": 0, "name": "stage_pipeline", "runtime": "torch",
             "graph": ["(detect llm)"],
             "parameters": dict(parameters if parameters is not None
                                else {"transfer_guard": "disallow"}),
             "elements": [
                 stage_element("detect", {"busy_ms": 10.0, "factor": 2.0},
                               "auto"),
                 stage_element("llm", {"busy_ms": 10.0, "factor": 3.0},
                               "auto")]},
            runtime=runtime)
        assert pipeline.stage_scheduler is not None, \
            "stage-parallel scheduler did not activate"
        placement = pipeline.stage_placement
        det = set(placement.plan("detect").mesh.devices.flat)
        llm = set(placement.plan("llm").mesh.devices.flat)
        assert not det & llm, "auto split shares chips"
        assert len(det) + len(llm) == n_devices, "auto split leaks"
        responses: queue.Queue = queue.Queue()
        rng = np.random.default_rng(0)
        sent = [frame(rng) for _ in range(n_frames)]
        for x in sent:
            pipeline.process_frame_local({"x": x}, stream_id="sp",
                                         queue_response=responses)
        collected = collect(runtime, responses, n_frames)
        assert len(collected) == n_frames, \
            f"stage-pipeline: {len(collected)}/{n_frames} frames"
        for *_, okay, diagnostic in collected:
            assert okay, f"stage-pipeline frame failed: {diagnostic}"
        order = [row[1] for row in collected]
        assert order == sorted(order), \
            f"stage-pipeline delivery out of order: {order}"
        spans = {row[1]: row[3] for row in collected}
        overlaps = sum(
            1 for k in range(n_frames - 1)
            if spans[k + 1]["detect_time_start"]
            < spans[k]["llm_time_start"] + spans[k]["llm_time"])
        assert overlaps >= 1, (
            "stages never ran concurrently: detect(k+1) always started "
            "after llm(k) ended")
        out = {"detect": det, "llm": llm, "overlaps": overlaps,
               "sent": sent, "results": {row[1]: row[2]["x"]
                                         for row in collected},
               "llm_lead": placement.plan("llm").device,
               "stats": pipeline.stage_stats()}
        pipeline.stop()
    return out


# -- 9. [chaos] -------------------------------------------------------------

def chaos(devices: list) -> dict:
    """A placed two-stage pipeline with a seeded FaultPlan: one detect
    dispatch raises, the health probe's ``device_kill`` confirms the
    stage's devices dead, ``replace()`` re-places onto the survivors and
    the in-flight frame replays."""
    n_devices = len(devices)
    n_frames = 6
    half = n_devices // 2
    work = {"busy_ms": 10.0, "factor": 2.0}
    with port_runtime() as runtime:
        pipeline = Pipeline(
            {"version": 0, "name": "chaos", "runtime": "torch",
             "graph": ["(detect llm)"],
             "parameters": {
                 "replay_limit": 3,
                 "health_probe_timeout": 2.0,
                 "fault_plan": {"seed": 0, "rules": [
                     {"point": "element_raise", "target": "detect",
                      "after": 1, "count": 1},
                     {"point": "device_kill", "target": "detect",
                      "count": 1}]}},
             "elements": [stage_element("detect", work, half),
                          stage_element("llm", work, n_devices - half)]},
            runtime=runtime)
        killed = set(pipeline.stage_placement.stage_devices("detect"))
        responses: queue.Queue = queue.Queue()
        rng = np.random.default_rng(0)
        for _ in range(n_frames):
            pipeline.process_frame_local(
                {"x": rng.standard_normal((16, 16)).astype(np.float32)},
                stream_id="chaos", queue_response=responses)
        collected = collect(runtime, responses, n_frames)
        assert len(collected) == n_frames, (
            f"chaos: {len(collected)}/{n_frames} frames -- a stream hung "
            "through recovery")
        for *_, okay, diagnostic in collected:
            assert okay, f"chaos frame failed: {diagnostic}"
        order = [row[1] for row in collected]
        assert order == sorted(order), f"chaos delivery out of order: {order}"
        replayed = pipeline.share["frames_replayed"]
        assert replayed > 0, "chip death never triggered a frame replay"
        placement = pipeline.stage_placement
        assert placement.generation == 1, \
            "device_kill never triggered a replacement"
        plan_fired = pipeline.fault_stats()["plan"]["fired"]
        assert plan_fired.get("element_raise") == 1
        assert plan_fired.get("device_kill") == 1
        placed = {d for plan in placement.plans.values()
                  for d in plan.mesh.devices.flat}
        assert not placed & killed, "a killed device is still placed"
        out = {"killed": killed, "replayed": replayed,
               "stages": {name: list(plan.mesh.devices.flat)
                          for name, plan in placement.plans.items()}}
        pipeline.stop()
    return out


# -- 10. [replica-failover] -------------------------------------------------

class RecordedStageWork(StageWork):
    """``StageWork`` that notes each call: its stage, the replica it ran
    on, where its output lies and its plan's lead card as it began (None
    for a call of a replica already retired, which the shed replays on a
    peer)."""

    calls: list = []

    def process_frame(self, stream, x):
        current = self.pipeline.current_replica()
        try:
            lead = self.plan.device
        except KeyError:
            lead = None
        event, outputs = super().process_frame(stream, x)
        RecordedStageWork.calls.append({
            "stage": self.name,
            "replica": None if current is None else current[1],
            "device": getattr(outputs["x"], "device", None), "lead": lead})
        return event, outputs


def replica_failover(frame=None) -> dict:
    """detect at ``replicas: 3``, a ``device_kill`` rule on ONE replica
    (``detect#1``) fired by the health probe mid-flight: its frames shed
    to the peers in order, no generation bump; the background rebuild
    restores the slot half-open and the canary closes it live.  The pool
    (``device.local_devices()``, five positions: three replicas, the
    llm and a spare) loses the killed position only.  ``frame(rng)``
    makes each frame's ``x`` (a float32 numpy array, as the JAX
    section's, by default)."""
    n_frames = 9
    frame = frame or (lambda rng: rng.standard_normal(
        (16, 16)).astype(np.float32))
    RecordedStageWork.calls = []

    def element(name: str, placement: dict) -> dict:
        return {"name": name, "input": [{"name": "x"}],
                "output": [{"name": "x"}],
                "parameters": {"busy_ms": 20.0, "factor": 2.0},
                "placement": placement,
                "deploy": {"local": {"module": __name__,
                                     "class_name": "RecordedStageWork"}}}

    with port_runtime() as runtime:
        pipeline = Pipeline(
            {"version": 0, "name": "replica_failover", "runtime": "torch",
             "graph": ["(detect llm)"],
             "parameters": {
                 "replay_limit": 3,
                 "replica_rebuild_ms": 80,
                 "health_probe_timeout": 2.0,
                 "fault_plan": {"seed": 0, "rules": [
                     {"point": "device_kill", "target": "detect#1",
                      "count": 1}]}},
             "elements": [element("detect", {"devices": 1, "replicas": 3}),
                          element("llm", {"devices": 1})]},
            runtime=runtime)
        placement = pipeline.stage_placement
        group = pipeline.stage_scheduler.groups["detect"]
        pool = list(placement.devices)
        leads = [placement.replica_plan("detect", index).device
                 for index in range(3)]
        responses: queue.Queue = queue.Queue()
        rng = np.random.default_rng(0)
        sent = [frame(rng) for _ in range(n_frames)]
        for x in sent:
            pipeline.process_frame_local({"x": x}, stream_id="rf",
                                         queue_response=responses)

        def replica1_busy():
            return any(frame.stage == "detect" and frame.stage_replica == 1
                       for stream in pipeline.streams.values()
                       for frame in stream.frames.values())
        runtime.run(until=replica1_busy, timeout=60.0)
        assert replica1_busy(), "no frame admitted to replica 1"
        # The armed rule marks replica 1's position dead on this probe.
        pipeline.post_self("check_device_health")
        collected = collect(runtime, responses, n_frames)
        assert len(collected) == n_frames, (
            f"replica-failover: {len(collected)}/{n_frames} frames -- "
            "dropped through the shed")
        for *_, okay, diagnostic in collected:
            assert okay, f"replica-failover frame failed: {diagnostic}"
        order = [row[1] for row in collected]
        assert order == sorted(order), \
            f"replica-failover delivery out of order: {order}"
        assert pipeline.share["replica_failovers"] == 1, \
            "the replica kill never took the peer-shed path"
        fired = pipeline.fault_stats()["plan"]["fired"]
        assert fired.get("device_kill") == 1
        survivors = list(placement.devices)
        runtime.run(until=lambda: pipeline.share["replica_rebuilds"] >= 1,
                    timeout=60.0)
        assert pipeline.share["replica_rebuilds"] >= 1, \
            "background rebuild never ran"
        walk = [(slot, state) for slot, state, _ in group.transitions]
        assert (1, "dead") in walk and (1, "half_open") in walk, \
            f"missing canary lifecycle in {walk}"
        killed_calls = len(RecordedStageWork.calls)
        responses2: queue.Queue = queue.Queue()
        sent2 = [frame(rng) for _ in range(6)]
        for x in sent2:
            pipeline.process_frame_local({"x": x}, stream_id="rf2",
                                         queue_response=responses2)
        collected2 = collect(runtime, responses2, 6)
        assert len(collected2) == 6 and all(row[4] for row in collected2)
        assert group.states == ["live", "live", "live"], \
            f"canary never reclosed slot 1: {group.states}"
        out = {"pool": pool, "survivors": survivors,
               "killed": set(pool) - set(survivors),
               "leads": leads,
               "rebuilt_leads": [placement.replica_plan("detect",
                                                        index).device
                                 for index in range(3)],
               "llm_lead": placement.plan("llm").device,
               "placed": {entry for index in range(3)
                          for entry in placement.replica_devices("detect",
                                                                 index)}
               | placement.stage_devices("llm"),
               "generation": placement.generation,
               "calls": list(RecordedStageWork.calls),
               "calls_before_rebuild": killed_calls,
               "sent": sent + sent2,
               "results": [row[2]["x"] for row in collected + collected2],
               "failover_ms": pipeline.share["replica_failover_ms"],
               "rebuilds": pipeline.share["replica_rebuilds"]}
        pipeline.stop()
    return out


# -- 11. [gateway] ----------------------------------------------------------

def gateway(devices: list) -> dict:
    """A multi-tenant mixed-class run through the WebSocket gateway in
    front of a placed two-stage pipeline: the tenant inside its budget
    gets every frame in order, the over-budget one is shed at least
    once."""
    from aiko_services_tpu_torch.gateway.client import GatewayClient
    with port_runtime() as runtime:
        pipeline = Pipeline(
            {"version": 0, "name": "gateway", "runtime": "torch",
             "graph": ["(detect llm)"],
             "parameters": {
                 "gateway": "on",
                 "stage_inflight": 1,
                 "qos": {"tenants": {
                     "alice": {"class": "interactive", "budget": 32},
                     "bulk": {"class": "batch", "budget": 1}},
                     "max_inflight": 4, "age_ms": 60000}},
             "elements": [
                 stage_element("detect", {"busy_ms": 25.0, "factor": 2.0},
                               "auto"),
                 stage_element("llm", {"busy_ms": 25.0, "factor": 3.0},
                               "auto")]},
            runtime=runtime)
        port = pipeline.gateway.port
        outcome: dict = {}

        def drive():
            bulk = GatewayClient("127.0.0.1", port)
            bulk.open(session="bulk", tenant="bulk")
            for i in range(6):
                bulk.send_frame({"x": [float(i + 1)] * 4})
            alice = GatewayClient("127.0.0.1", port)
            alice.open(session="alice", tenant="alice")
            for i in range(4):
                alice.send_frame({"x": [float(i + 1)] * 4})
            outcome["alice"] = [alice.next_result() for _ in range(4)]
            outcome["bulk"] = [bulk.next_result() for _ in range(6)]
            alice.close()
            bulk.close()
            outcome["done"] = True

        thread = threading.Thread(target=drive, daemon=True)
        thread.start()
        runtime.run(until=lambda: outcome.get("done"), timeout=120.0)
        assert outcome.get("done"), "gateway dryrun hung"
        alice_rows = outcome["alice"]
        assert [r["frame"] for r in alice_rows] == [0, 1, 2, 3], \
            "per-session delivery out of order"
        assert all(r["ok"] for r in alice_rows), \
            "in-budget tenant lost frames"
        assert alice_rows[0]["data"]["x"][0] == 6.0     # *2 then *3
        bulk_shed = sum(1 for r in outcome["bulk"]
                        if not r["ok"] and "shed" in r["diagnostic"])
        assert bulk_shed >= 1, \
            "over-budget tenant was never shed under overload"
        stats = pipeline.qos_stats()
        assert stats["tenants"]["bulk"]["shed"] >= 1
        assert stats["tenants"]["alice"]["shed"] == 0
        runtime.run(until=lambda: not pipeline.streams, timeout=30.0)
        assert pipeline.gateway.session_count() == 0, \
            "sessions leaked past close"
        placement = pipeline.stage_placement
        out = {"stages": {name: list(plan.mesh.devices.flat)
                          for name, plan in placement.plans.items()},
               "bulk_shed": bulk_shed}
        pipeline.stop()
    return out
