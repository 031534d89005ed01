"""Stages over device groups in the port, held to the JAX package on the
CPU: ``submesh`` (the twin of ``test_models.py::test_mesh_construction``),
the ``[placement]`` and ``[replacement]`` hops of
``__graft_entry__.dryrun_multichip``, the memoized stage hops of
``tests/test_stages.py`` with a spec, and the ``Detector`` split over
its stage's dp devices.  JAX runs on its eight virtual CPU devices
(``tests/conftest.py``), the port on CPU descriptors
(``torch_pipeline_elements.CPU_POOL``); inputs come from numpy seeds.

Then the dryrun's sections 3, 4, 7, 8, 9 and 11 through the port on four
CPU descriptors (``tests/torch_placement_sections.py``, which
``tests/test_torch_placement_cuda.py`` runs on four cards).

Tolerances: the hops move values, so they are exact (float32); the
detector, float32 on both sides, holds ``valid`` and ``classes`` exactly
and boxes and scores within 1e-4 of the JAX package's (convolution
summation order, as ``tests/test_torch_config4.py``), and within 1e-5 of
the port's own one-device ``detect`` on the same weights."""

import dataclasses
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_placement_sections as sections
from conftest import run_until
from test_torch_detector import JAX_INIT
from torch_pipeline_elements import CPU_POOL

from aiko_services_tpu.models import detector as jax_detector
from aiko_services_tpu.parallel import MeshPlan as JaxMeshPlan
from aiko_services_tpu.parallel import P as JaxP
from aiko_services_tpu.parallel import make_mesh as jax_make_mesh
from aiko_services_tpu.parallel.mesh import submesh as jax_submesh
from aiko_services_tpu.pipeline.tensor import \
    StagePlacement as JaxStagePlacement
from aiko_services_tpu_torch import device as device_rule
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import detector as port_detector
from aiko_services_tpu_torch.parallel import MeshPlan, P, Placed, make_mesh
from aiko_services_tpu_torch.parallel import submesh
from aiko_services_tpu_torch.pipeline import Pipeline
from aiko_services_tpu_torch.pipeline.tensor import StagePlacement

DETECT_TOL = 1e-4           # against the JAX package
SELF_TOL = 1e-5             # against the port's one-device detect


@pytest.fixture
def pool4(monkeypatch):
    """Four CPU descriptors as the process's device pool (the dryrun's
    four-chip shape)."""
    pool = list(CPU_POOL[:4])
    monkeypatch.setattr(device_rule, "local_devices", lambda: list(pool))
    return pool


def _indices(devices) -> list:
    """Device numbers in order: a JAX device's id, a descriptor's
    index."""
    return [getattr(device, "id", None) if not isinstance(
        device, torch.device) else device.index for device in devices]


# -- submesh ------------------------------------------------------------------

@pytest.mark.parametrize("axis,index", [("dp", 0), ("dp", 1), ("tp", 0),
                                        ("tp", 3)])
def test_submesh_matches_jax(axis, index):
    theirs = jax_make_mesh({"dp": 2, "tp": 4}, jax.devices())
    ours = make_mesh({"dp": 2, "tp": 4}, list(CPU_POOL))
    assert ours.shape == dict(theirs.shape) == {"dp": 2, "tp": 4}
    assert make_mesh({"dp": -1, "tp": 2}, list(CPU_POOL)).shape["dp"] == 4
    with pytest.raises(ValueError):
        make_mesh({"dp": 3, "tp": 3}, list(CPU_POOL))
    sub_theirs = jax_submesh(theirs, axis, index)
    sub_ours = submesh(ours, axis, index)
    assert sub_ours.shape == dict(sub_theirs.shape)
    assert sub_ours.axis_names == tuple(sub_theirs.axis_names)
    assert _indices(sub_ours.devices.flat) \
        == _indices(sub_theirs.devices.flat)
    assert sub_ours.devices.size == (4 if axis == "dp" else 2)


def test_submesh_of_one_device_is_a_dp_mesh():
    """A slice of one device becomes a one-position ``dp`` mesh (the
    JAX function's branch for it reads ``.ndim`` off a device object
    and raises there, so this case has no JAX twin)."""
    sub = submesh(make_mesh({"tp": 4}, list(CPU_POOL[:4])), "tp", 2)
    assert sub.shape == {"dp": 1}
    assert list(sub.devices.flat) == [CPU_POOL[2]]
    plan = MeshPlan(sub)
    assert plan.device == plan.replicated() == CPU_POOL[2]


# -- [placement] and [replacement] -------------------------------------------

def _jax_placement_hops(x: np.ndarray):
    devices = jax.devices()[:4]
    placement = JaxStagePlacement(devices)
    placement.assign({"detect": {"dp": 2}, "llm": {"tp": 2}})
    on_detect = placement.transfer(jnp.asarray(x), "detect", JaxP("dp", None))
    on_llm = placement.transfer(on_detect, "llm", JaxP(None, "tp"))
    return placement, on_detect, on_llm


def test_placement_and_replacement_hops_match_jax():
    """The dryrun's ``[placement]`` and ``[replacement]`` sequence: equal
    values after every hop (exactly), equal meshes and shards, and the
    same survivors and stage shapes after the same ``replace``."""
    x = np.arange(8.0, dtype=np.float32).reshape(4, 2)
    jp, j_detect, j_llm = _jax_placement_hops(x)
    pool = list(CPU_POOL[:4])
    placement, on_detect, on_llm = sections.placement_hops(
        pool, torch.from_numpy(x))
    for stage in ("detect", "llm"):
        assert dict(placement.plan(stage).mesh.shape) \
            == dict(jp.plan(stage).mesh.shape)
        assert _indices(placement.plan(stage).mesh.devices.flat) \
            == _indices(jp.plan(stage).mesh.devices.flat)
    for ours, theirs in ((on_detect, j_detect), (on_llm, j_llm)):
        assert isinstance(ours, Placed)
        assert dict(ours.mesh.shape) == dict(theirs.sharding.mesh.shape)
        np.testing.assert_array_equal(
            ours.gather(torch.device("cpu")).numpy(), np.asarray(theirs))
        shards = sorted(theirs.addressable_shards, key=lambda s: s.device.id)
        for mine, shard in zip(ours.shards, shards):
            np.testing.assert_array_equal(mine.numpy(),
                                          np.asarray(shard.data))
    assert (placement.transfer_puts, placement.transfer_skipped) \
        == (jp.transfer_puts, jp.transfer_skipped)

    dead, rehop = sections.replacement_hop(placement, torch.from_numpy(x))
    j_dead = list(jp.plans["detect"].mesh.devices.flat)[:1]
    jp.replace(j_dead)
    assert _indices(dead) == _indices(j_dead)
    assert placement.generation == jp.generation == 1
    for stage in ("detect", "llm"):
        assert dict(placement.plan(stage).mesh.shape) \
            == dict(jp.plan(stage).mesh.shape)
        assert _indices(placement.plan(stage).mesh.devices.flat) \
            == _indices(jp.plan(stage).mesh.devices.flat)
    np.testing.assert_array_equal(
        rehop.numpy(), np.asarray(jp.transfer(jnp.asarray(x), "llm")))


# -- memoized stage hops with a spec (tests/test_stages.py:300-331) ----------

def test_spec_transfer_memoizes_and_skips_placed_leaves():
    """The spec'd twin of ``test_transfer_memoizes_shardings_and_skips_
    resident_leaves``: a memo hit per (stage, spec), a value already laid
    out on the stage by the spec passes through, and a hop to the other
    stage reshards -- the same counts and values as the JAX package."""
    x = np.random.default_rng(3).standard_normal((8, 8)).astype(np.float32)

    def run(placement, array, spec, fetch):
        placement.assign({"a": {"dp": 4}, "b": {"dp": 4}})
        on_b = placement.transfer(array, "b", spec)
        puts, cached = placement.transfer_puts, len(placement._shardings)
        again = placement.transfer(on_b, "b", spec)
        counts = [cached, placement.transfer_puts - puts,
                  placement.transfer_skipped, len(placement._shardings)]
        on_a = placement.transfer(on_b, "a", spec)
        counts.append(placement.transfer_puts - puts)
        return counts, again is on_b, fetch(on_a)

    theirs = run(JaxStagePlacement(jax.devices()), jnp.asarray(x),
                 JaxP("dp", None), np.asarray)
    ours = run(StagePlacement(list(CPU_POOL)), torch.from_numpy(x),
               P("dp", None),
               lambda placed: placed.gather(torch.device("cpu")).numpy())
    assert ours[0] == theirs[0] == [1, 0, 1, 1, 1]
    assert ours[1] and theirs[1]
    np.testing.assert_array_equal(ours[2], theirs[2])
    np.testing.assert_array_equal(ours[2], x)


def test_spec_transfer_memo_invalidated_by_replace():
    """The spec'd twin of ``test_transfer_sharding_cache_invalidated_by_
    replace``: after a ``replace`` the hop re-resolves under the new
    generation and lands on the survivors only, the same devices as
    the JAX package's."""
    x = np.ones((4, 4), np.float32)

    def run(placement, array, spec):
        placement.assign({"a": {"dp": 4}, "b": {"dp": 4}})
        before = placement.transfer(array, "b", spec)
        dead = list(placement.plans["a"].mesh.devices.flat)[:2]
        placement.replace(dead)
        after = placement.transfer(before, "b", spec)
        assert set(after.sharding.device_set) <= set(placement.devices)
        assert not set(after.sharding.device_set) & set(dead)
        assert all(key[2] == placement.generation == 1
                   for key in placement._shardings)
        return sorted(_indices(after.sharding.device_set)), after

    theirs, _ = run(JaxStagePlacement(jax.devices()), jnp.asarray(x),
                    JaxP("dp"))
    ours, after = run(StagePlacement(list(CPU_POOL)), torch.from_numpy(x),
                      P("dp"))
    assert ours == theirs
    np.testing.assert_array_equal(after.gather(torch.device("cpu")).numpy(),
                                  x)


# -- the Detector over dp -----------------------------------------------------

def _float32_config(module):
    config = module.DetectorConfig

    def factory(*args, **kwargs):
        return dataclasses.replace(config(*args, **kwargs), dtype="float32")
    return factory


def _rows(fetched: dict, row: int, names: list) -> list:
    """One frame's detections as the element reports them."""
    valid = np.asarray(fetched["valid"][row])
    return [{"class": names[int(fetched["classes"][row][i])],
             "score": float(fetched["scores"][row][i]),
             "box": [float(v) for v in fetched["boxes"][row][i]]}
            for i in np.nonzero(valid)[0]]


def _assert_same(ours: list, want: list, tol: float) -> None:
    assert [d["class"] for d in ours] == [d["class"] for d in want]
    for got, expected in zip(ours, want):
        np.testing.assert_allclose(got["box"], expected["box"], rtol=0,
                                   atol=tol)
        assert abs(got["score"] - expected["score"]) <= tol


def test_detector_dp4_matches_jax_and_one_device(pool4, monkeypatch):
    """A ``Detector`` placed on ``{"dp": 4}``: a first frame alone
    (padded to one row a position), then seven at once (padded to 8, two
    rows a position) -- every position dispatches each micro-batch, and
    every frame's detections equal the JAX package's ``detect`` and the
    port's own one-device ``detect`` on the same weights."""
    names = ["person", "robot_dog", "ball", "obstacle"]
    jax_config = jax_detector.DetectorConfig(
        num_classes=len(names), width=4, score_threshold=0.25,
        max_detections=32, dtype="float32")
    tree = jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf, np.float32),
        JAX_INIT(jax.random.PRNGKey(0), jax_config))
    monkeypatch.setattr(port_detector, "DetectorConfig",
                        _float32_config(port_detector))
    monkeypatch.setattr(
        port_detector, "init_params",
        lambda seed, config, device: bridge.detector_params_from_numpy(
            tree, config, device=device))
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
              for _ in range(8)]

    with sections.port_runtime() as runtime:
        pipeline = Pipeline(
            {"version": 0, "name": "det_dp4", "runtime": "torch",
             "graph": ["(DET)"],
             "elements": [{
                 "name": "DET", "input": [{"name": "image"}],
                 "output": [{"name": "detections"}],
                 "parameters": {"width": 4, "max_batch": 8},
                 "placement": {"mesh": {"dp": 4}},
                 "deploy": {"local": {
                     "module": "aiko_services_tpu_torch.elements.detect",
                     "class_name": "Detector"}}}]},
            runtime=runtime)
        responses = queue.Queue()
        stream = pipeline.create_stream_local("s", queue_response=responses)
        pipeline.create_frame_local(stream, {"image": images[0]})
        assert run_until(runtime, lambda: responses.qsize() >= 1,
                         timeout=60.0)
        for image in images[1:]:
            pipeline.create_frame_local(stream, {"image": image})
        assert run_until(runtime, lambda: responses.qsize() >= 8,
                         timeout=60.0)
        ours = {}
        while not responses.empty():
            _, frame_id, swag, _, okay, diagnostic = responses.get()
            assert okay, diagnostic
            ours[frame_id] = swag["detections"]
        det = pipeline.graph.get_node("DET").element
        assert dict(det.plan.mesh.shape) == {"dp": 4}
        assert [stats["device"] for stats in det.position_stats] \
            == [str(device) for device in pool4]
        assert [(stats["batches"], stats["rows"])
                for stats in det.position_stats] == [(2, 3)] * 4
        params, config = det._params, det._config
        pipeline.stop()

    batch = np.stack(images).astype(np.float32) / 255.0
    theirs = jax.device_get(dict(jax_detector.detect(
        jax.tree_util.tree_map(jnp.asarray, tree), jax_config,
        jnp.asarray(batch))))
    one = {name: value.numpy() for name, value in port_detector.detect(
        params, config, torch.from_numpy(batch)).items()}
    assert sorted(ours) == list(range(8))
    assert sum(len(rows) for rows in ours.values()) > 0
    for frame_id in range(8):
        _assert_same(ours[frame_id], _rows(theirs, frame_id, names),
                     DETECT_TOL)
        _assert_same(ours[frame_id], _rows(one, frame_id, names), SELF_TOL)


def test_detector_weights_on_every_position(pool4):
    """``put(params, P())`` holds the weights on every position (each
    CPU descriptor its own copy; one card listed twice stores them
    once), the lead shard is what the synchronous path reads, and
    ``on_replacement`` drops every position's weights."""
    plan = MeshPlan(make_mesh({"dp": 2}, pool4[:2]))
    params = port_detector.init_params(
        0, port_detector.DetectorConfig.tiny(), "cpu")
    placed = plan.put(params, P())
    assert len(placed.owned()[1]) == len(placed.owned()[0]) > 0
    twice = MeshPlan(make_mesh({"dp": 2}, [pool4[0], pool4[0]]))
    shared = twice.put(params, P())
    assert shared.owned()[1] == []
    for group in placed.replicas():
        assert all(torch.equal(group[0], member) for member in group)


# -- the dryrun's sections on four CPU descriptors ---------------------------

def test_config4_section(pool4):
    result = sections.config4(pool4, llm={"device": "cpu"})
    assert result["det_devices"] == set(pool4[:2])
    assert result["llm_devices"] == set(pool4[2:])
    assert all(stats["batches"] == result["micro_batches"]
               for stats in result["positions"])
    assert result["health_failed"] == []


def test_stage_pipeline_section(pool4):
    result = sections.stage_pipeline(pool4)
    for frame_id, x in enumerate(result["sent"]):
        np.testing.assert_array_equal(np.asarray(result["results"][frame_id]),
                                      x * 2.0 * 3.0)


def test_chaos_section(pool4):
    result = sections.chaos(pool4)
    assert result["killed"] == set(pool4[:2])
    assert result["replayed"] > 0


def test_gateway_section(pool4):
    result = sections.gateway(pool4)
    assert result["bulk_shed"] >= 1
