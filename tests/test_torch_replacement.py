"""The port's stage re-placement on device failure: twins of
``tests/test_replacement.py`` (health probes, re-carving onto the
survivors, an end-to-end replacement, the terminal failure) on the
eight-CPU device pool (``torch_pipeline_elements.cpu_pool``)."""

import queue

import numpy as np
import pytest
import torch

from conftest import run_until
from torch_pipeline_elements import CPU_POOL, cpu_pool  # noqa: F401

from aiko_services_tpu_torch.pipeline import Pipeline
from aiko_services_tpu_torch.pipeline.stream import StreamEvent
from aiko_services_tpu_torch.pipeline.tensor import StagePlacement, TPUElement
from aiko_services_tpu_torch.tpu.health import probe_devices


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


def test_probe_devices_default_prober_all_healthy():
    assert probe_devices(list(CPU_POOL)) == []


def test_probe_devices_default_prober_fails_a_missing_card():
    """The default prober's round trip to a card that is not there
    fails it (on this CPU-only build every CUDA device is missing)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert probe_devices([CPU_POOL[0], torch.device("cuda", 0)]) \
        == [torch.device("cuda", 0)]


def test_probe_devices_injected_failure():
    devices = list(CPU_POOL)
    dead = {devices[3], devices[5]}
    failed = probe_devices(devices, prober=lambda d: d not in dead)
    assert set(failed) == dead


def test_replace_rebuilds_plans_on_survivors(cpu_pool):
    placement = StagePlacement(cpu_pool)
    placement.assign({"detect": {"dp": 4}, "llm": {"tp": 4}})
    detect_devices = list(placement.plans["detect"].mesh.devices.flat)

    failed = detect_devices[:2]              # two devices of stage 1 die
    placement.replace(failed)

    assert placement.generation == 1
    survivors = set(cpu_pool) - set(failed)
    placed = [d for plan in placement.plans.values()
              for d in plan.mesh.devices.flat]
    assert set(placed) <= survivors
    # 6 survivors for requests (4 + 4): largest stage halved once.
    shapes = {name: dict(plan.mesh.shape)
              for name, plan in placement.plans.items()}
    assert sorted(int(np.prod(list(s.values())))
                  for s in shapes.values()) == [2, 4]
    # Data still lands on the new meshes.
    array = placement.transfer(torch.ones((4, 4)), "llm")
    assert float(array.sum()) == 16


def test_replace_all_dead_raises(cpu_pool):
    placement = StagePlacement(cpu_pool)
    placement.assign({"s": {"dp": 8}})
    with pytest.raises(RuntimeError, match="no surviving"):
        placement.replace(list(cpu_pool))


def test_replace_cannot_shrink_below_one_device(cpu_pool):
    devices = cpu_pool[:2]
    placement = StagePlacement(devices)
    placement.assign({"a": {"dp": 1}, "b": {"dp": 1}})
    with pytest.raises(RuntimeError, match="cannot shrink"):
        placement.replace([devices[0]])


class PlacedSquare(TPUElement):
    """Captured square on its placed device; counts re-placements."""

    replaced = 0

    def process_frame(self, stream, x):
        compute = self.jit(lambda a: a * a)
        value = self.put(np.asarray(x, np.float32))
        return StreamEvent.OKAY, {"y": compute(value)}

    def on_replacement(self):
        super().on_replacement()
        PlacedSquare.replaced += 1


def element_def(name, cls, inputs, outputs, placement):
    return {"name": name,
            "input": [{"name": n} for n in inputs],
            "output": [{"name": n} for n in outputs],
            "deploy": {"local": {
                "module": "tests/test_torch_replacement.py",
                "class_name": cls}},
            "parameters": {}, "placement": placement}


def run_frame(runtime, pipeline, frame_data):
    responses = queue.Queue()
    pipeline.process_frame_local(frame_data, queue_response=responses)
    assert run_until(runtime, lambda: not responses.empty(), timeout=10.0)
    _, _, swag, _, okay, diagnostic = responses.get()
    assert okay, diagnostic
    return swag


def test_pipeline_replaces_stage_and_keeps_processing(runtime, cpu_pool):
    """End to end: a placed pipeline loses two devices mid-stream;
    health check re-places the stage, the element re-captures on the
    new group, and frames keep flowing."""
    PlacedSquare.replaced = 0
    pipeline = Pipeline(
        {"version": 0, "name": "p_replace", "runtime": "torch",
         "graph": ["(Sq)"], "parameters": {},
         "elements": [element_def("Sq", "PlacedSquare", ["x"], ["y"],
                                  {"mesh": {"dp": 4}})]},
        runtime=runtime)
    swag = run_frame(runtime, pipeline, {"x": 3.0})
    assert float(swag["y"]) == 9.0
    placement = pipeline.stage_placement
    old_devices = list(placement.plans["Sq"].mesh.devices.flat)
    assert len(old_devices) == 4

    # The element class is re-imported by module path: reach the live
    # instance through the graph, not the pytest import of this file.
    sq_element = next(node.element for node in pipeline.graph.nodes()
                      if node.name == "Sq")
    events = []
    pipeline.add_hook_handler(
        "pipeline.replacement:0",
        lambda component, hook, variables: events.append(variables))
    dead = set(old_devices[:2])
    failed = pipeline.check_device_health(
        prober=lambda d: d not in dead)
    assert set(failed) == dead
    assert type(sq_element).replaced == 1
    assert pipeline.share["replacements"] == 1
    assert len(events) == 1
    assert events[0]["generation"] == 1
    # 6 healthy devices remain for a 4-device request: spare capacity
    # absorbs the failure, the stage keeps its full mesh -- on fresh
    # devices.
    assert events[0]["stages"] == {"Sq": {"dp": 4}}

    new_devices = list(placement.plans["Sq"].mesh.devices.flat)
    assert not (set(new_devices) & dead)
    assert len(new_devices) == 4
    assert sq_element.plan.device == new_devices[0]

    swag = run_frame(runtime, pipeline, {"x": 5.0})
    assert float(swag["y"]) == 25.0

    # Healthy probe is a no-op.
    assert pipeline.check_device_health(prober=lambda d: True) == []
    assert type(sq_element).replaced == 1


def test_probe_hung_prober_counts_as_failed():
    """A hung device must not freeze the caller: the probe deadline
    expires and the device is reported failed."""
    import threading
    import time

    devices = list(CPU_POOL[:3])
    hang_forever = threading.Event()

    def prober(device):
        if device is devices[1]:
            hang_forever.wait(timeout=30.0)     # "hung transfer"
        return True

    start = time.perf_counter()
    failed = probe_devices(devices, prober=prober, timeout=0.3)
    elapsed = time.perf_counter() - start
    hang_forever.set()
    assert failed == [devices[1]]
    assert elapsed < 5.0


def test_unrecoverable_failure_is_terminal(runtime, cpu_pool):
    """Too few survivors: the health timer stops, placement_failed is
    shared, and live streams error instead of retrying forever."""
    devices = cpu_pool
    pipeline = Pipeline(
        {"version": 0, "name": "p_term", "runtime": "torch",
         "graph": ["(A B)"],
         "parameters": {"health_check_interval": 0.05},
         "elements": [
             element_def("A", "PlacedSquare", ["x"], ["y"],
                         {"mesh": {"dp": 4}}),
             element_def("B", "PlacedSquare", ["y"], ["z"],
                         {"mesh": {"dp": 4}})]},
        runtime=runtime)
    assert pipeline._health_timer is not None
    responses = queue.Queue()
    stream = pipeline.create_stream_local("s1", queue_response=responses)
    assert stream is not None

    # 7 of 8 die: even fully shrunk, two stages need 2 devices and only
    # 1 survives -> unrecoverable.
    dead = set(devices[:7])
    failed = pipeline.check_device_health(prober=lambda d: d not in dead)
    assert len(failed) == 7
    assert "placement_failed" in pipeline.share
    assert pipeline._health_timer is None        # retry loop stopped
    assert "s1" not in pipeline.streams          # stream torn down
