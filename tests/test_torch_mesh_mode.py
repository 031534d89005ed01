"""The port's multi-host mesh mode and the ASR's partition specs: twins
of ``tests/test_data_plane.py::test_mesh_mode_carves_host_groups_and_
serves`` (a ``mesh: {hosts: 2}`` pipeline with no coordinator carves two
virtual host groups out of this process's pool -- the eight CPU
descriptors of ``torch_pipeline_elements.cpu_pool`` -- and serves frames
across the hop between them) and of ``tests/test_speech.py::
test_asr_partition_specs_cover_params``, plus ``ensure_distributed``'s
two cases (no coordinator: no bring-up; a coordinator: the
``torch.distributed`` bring-up of two spawned processes), what a bad
coordinator raises, the twins of ``tests/test_data_plane.py``'s other
mesh-mode cases, the ``parallel`` package's public names against the
JAX package's, and the port's ASR specs against the JAX package's,
leaf for leaf (the conv weights' spec read through the bridge's WIO ->
[out, in, width] permutation)."""

import queue
import time

import jax
import numpy as np
import pytest
import torch

import torch_multihost_worker as worker
from conftest import run_until
from test_torch_llm_element import _port_runtime, _port_teardown
from torch_pipeline_elements import cpu_pool  # noqa: F401

import aiko_services_tpu.parallel as jax_parallel
from aiko_services_tpu.models import asr as jax_asr
from aiko_services_tpu_torch import parallel
from aiko_services_tpu_torch.models import asr
from aiko_services_tpu_torch.models.checkpoint import flatten
from aiko_services_tpu_torch.parallel import P, distributed
from aiko_services_tpu_torch.pipeline import DefinitionError, Pipeline
from aiko_services_tpu_torch.pipeline.definition import placement_error
from aiko_services_tpu_torch.pipeline.tensor import (distributed_mesh_spec,
                                                     ensure_distributed)

COMMON = "aiko_services_tpu_torch.elements.common"


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


def _stage(name: str, placement: dict) -> dict:
    return {"name": name, "input": [{"name": "x"}],
            "output": [{"name": "x"}], "parameters": {"busy_ms": 1.0},
            "placement": placement,
            "deploy": {"local": {"module": COMMON,
                                 "class_name": "StageWork"}}}


def test_mesh_mode_carves_host_groups_and_serves(runtime, cpu_pool):
    n = len(cpu_pool)
    pipeline = Pipeline(
        {"version": 0, "name": "p_mesh", "runtime": "torch",
         "graph": ["(det llm)"],
         "parameters": {"mesh": {"hosts": 2}},
         "elements": [_stage("det", {"devices": n // 2}),
                      _stage("llm", {"devices": n // 2, "host": 1})]},
        runtime=runtime)
    placement = pipeline.stage_placement
    assert placement.hosts == 2
    assert [len(group) for group in placement.host_groups] == \
        [n - n // 2, n // 2]
    assert placement.stage_hosts == {"det": 0, "llm": 1}
    assert not placement.same_host("det", "llm")
    assert placement.stage_host("llm") == 1
    # Stages stay wholly inside their host group's devices.
    for stage, host in placement.stage_hosts.items():
        assert placement.stage_devices(stage) <= \
            set(placement.host_groups[host])
    # Frames flow across the hop between the two virtual hosts.
    responses = queue.Queue()
    x = np.ones((8, 8), dtype=np.float32)
    for _ in range(4):
        pipeline.process_frame_local({"x": x}, stream_id="s",
                                     queue_response=responses)
    rows = []

    def drained():
        while not responses.empty():
            rows.append(responses.get())
        return len(rows) >= 4
    assert run_until(runtime, drained, timeout=60.0)
    assert len(rows) == 4 and all(row[4] for row in rows), rows
    assert placement.stats["stage_hosts"] == {"det": 0, "llm": 1}
    pipeline.stop()


def test_ensure_distributed_virtual_and_real(tmp_path):
    """No coordinator: no bring-up, one process.  A coordinator and more
    than one host: the ``torch.distributed`` bring-up, here of two
    spawned processes over gloo, which returns (k, 2) in process k."""
    assert ensure_distributed(None) == (0, 1)
    assert ensure_distributed({"hosts": 2, "coordinator": None,
                               "process_id": 0}) == (0, 1)
    assert ensure_distributed({"hosts": 1, "coordinator": "localhost:1",
                               "process_id": 0}) == (0, 1)
    assert not distributed.initialized()
    for process, result in enumerate(worker.spawn(["bringup"], tmp_path)):
        assert result["_exit"] == 0, result.get("error") or result["_log"]
        assert result["bringup"]["first"] == (process, 2)


def test_mesh_mode_with_coordinator_rejected(runtime, cpu_pool):
    """A bring-up that fails is a ``DefinitionError`` naming
    torch.distributed and the coordinator, within the bring-up's
    timeout, and this process stays out of any process group."""
    body = {"version": 0, "name": "p_mesh_real", "runtime": "torch",
            "graph": ["(det)"],
            "parameters": {"mesh": {"hosts": 2,
                                    "coordinator": "127.0.0.1:notaport"}},
            "elements": [_stage("det", {"devices": 2})]}
    begin = time.monotonic()
    with pytest.raises(DefinitionError,
                       match="torch.distributed bring-up at coordinator "
                             "127.0.0.1:notaport failed"):
        Pipeline(body, runtime=runtime)
    assert time.monotonic() - begin < distributed.BRINGUP_TIMEOUT_S
    assert not distributed.initialized()


# -- tests/test_data_plane.py's other mesh-mode cases ------------------------

def test_mesh_parameter_validation_at_create(runtime, cpu_pool):
    broken = {"version": 0, "name": "p_mesh_bad", "runtime": "torch",
              "graph": ["(det)"],
              "parameters": {"mesh": {"hosts": 0}},
              "elements": [_stage("det", {"devices": 2})]}
    with pytest.raises(DefinitionError, match="mesh"):
        Pipeline(broken, runtime=runtime)


def test_mesh_stage_that_spans_hosts_rejected(runtime, cpu_pool):
    n = len(cpu_pool)
    broken = {"version": 0, "name": "p_mesh_span", "runtime": "torch",
              "graph": ["(det)"],
              # Lint would pass (the block is well-formed); the carve
              # itself must refuse a stage bigger than one host group.
              "parameters": {"mesh": {"hosts": 2}, "preflight": "off"},
              "elements": [_stage("det", {"devices": n})]}
    with pytest.raises(DefinitionError, match="never spans hosts"):
        Pipeline(broken, runtime=runtime)


def test_placement_host_key_validated():
    assert placement_error({"devices": 2, "host": 1}) is None
    assert "host" in placement_error({"devices": 2, "host": -1})
    assert "host" in placement_error({"devices": 2, "host": True})
    assert "host" in placement_error({"devices": 2, "host": "0"})


def test_mesh_env_spec(monkeypatch):
    monkeypatch.setenv("AIKO_MESH_HOSTS", "2")
    monkeypatch.setenv("AIKO_MESH_PROCESS_ID", "1")
    spec = distributed_mesh_spec({})
    assert spec["hosts"] == 2 and spec["process_id"] == 1
    # The pipeline parameter wins over the env.
    spec = distributed_mesh_spec({"mesh": {"hosts": 4}})
    assert spec["hosts"] == 4 and spec["process_id"] == 0


# -- the parallel package's public names --------------------------------------

def test_parallel_exports_cover_jax():
    """Every name the JAX package's ``parallel`` exports, the port's
    exports too."""
    theirs = {name for name in dir(jax_parallel) if not name.startswith("_")
              and not isinstance(getattr(jax_parallel, name),
                                 type(jax_parallel))}
    assert theirs <= set(parallel.__all__), theirs - set(parallel.__all__)


def test_device_inventory_and_tags_match_jax(cpu_pool):
    """One process over the tests' eight descriptors: the JAX package's
    keys and tag names, one process holding every device."""
    ours = parallel.device_inventory()
    assert set(ours) == set(jax_parallel.device_inventory())
    assert ours == {"platform": "cpu", "device_kind": "cpu",
                    "device_count": len(cpu_pool), "process_count": 1,
                    "local_device_count": len(cpu_pool)}
    tags = parallel.inventory_tags()
    assert [tag.split("=")[0] for tag in tags] == \
        [tag.split("=")[0] for tag in jax_parallel.inventory_tags()]
    assert tags == ["platform=cpu", "accelerator=cpu",
                    f"chips={len(cpu_pool)}"]


def test_virtual_cpu_devices_and_donation():
    """``virtual_cpu_devices`` gives CPU descriptors, as many as the JAX
    package's gives virtual devices; on the CPU neither package donates
    (the port never does: its steps update in place)."""
    devices = parallel.virtual_cpu_devices(4)
    assert devices == [torch.device("cpu", i) for i in range(4)]
    assert len(jax_parallel.virtual_cpu_devices(4)) == 4
    from aiko_services_tpu.parallel.mesh import (
        donate_argnums_supported as jax_donate)
    assert parallel.donate_argnums_supported((0, 1)) == \
        jax_donate((0, 1)) == ()


def _jax_leaf_specs(tree) -> dict:
    return {jax.tree_util.keystr(path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple))[0]}


def test_asr_partition_specs_cover_params():
    """Every parameter leaf has a partition spec (TP layout total)."""
    config = asr.AsrConfig.tiny()
    params = asr.init_params(0, config, device="cpu")
    specs = asr.partition_specs(config)
    assert set(flatten(params)) == set(_leaf_names(specs))
    for name, leaf in flatten(params).items():
        assert len(_leaf_names(specs)[name]) <= leaf.ndim, name


def _leaf_names(specs, prefix="") -> dict:
    out = {}
    for key, value in specs.items():
        if isinstance(value, P):
            out[prefix + key] = value
        else:
            out.update(_leaf_names(value, f"{prefix}{key}."))
    return out


def test_asr_partition_specs_match_jax():
    """The port's specs are the JAX package's, leaf for leaf: each layer
    leaf's spec unchanged (both hold [L, in, out]), each conv weight's
    permuted from WIO to [out, in, width]."""
    config = jax_asr.AsrConfig.tiny()
    theirs = _jax_leaf_specs(jax_asr.partition_specs(config))
    ours = _leaf_names(asr.partition_specs(asr.AsrConfig.tiny()))
    assert len(ours) == len(theirs)
    for name, spec in ours.items():
        key = "".join(f"['{part}']" for part in name.split("."))
        want = theirs[key]
        if name.endswith(".w"):                 # conv: WIO -> OIW
            want = (want[2], want[1], want[0])
        assert tuple(spec) == tuple(want), name
