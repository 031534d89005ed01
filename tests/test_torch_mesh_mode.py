"""The port's multi-host mesh mode and the ASR's partition specs: twins
of ``tests/test_data_plane.py::test_mesh_mode_carves_host_groups_and_
serves`` (a ``mesh: {hosts: 2}`` pipeline with no coordinator carves two
virtual host groups out of this process's pool -- the eight CPU
descriptors of ``torch_pipeline_elements.cpu_pool`` -- and serves frames
across the hop between them) and of ``tests/test_speech.py::
test_asr_partition_specs_cover_params``, plus ``ensure_distributed``'s
two cases and the port's ASR specs against the JAX package's, leaf for
leaf (the conv weights' spec read through the bridge's WIO -> [out, in,
width] permutation)."""

import queue

import jax
import numpy as np
import pytest

from conftest import run_until
from test_torch_llm_element import _port_runtime, _port_teardown
from torch_pipeline_elements import cpu_pool  # noqa: F401

from aiko_services_tpu.models import asr as jax_asr
from aiko_services_tpu_torch.models import asr
from aiko_services_tpu_torch.models.checkpoint import flatten
from aiko_services_tpu_torch.parallel import P
from aiko_services_tpu_torch.pipeline import DefinitionError, Pipeline
from aiko_services_tpu_torch.pipeline.tensor import ensure_distributed

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


def test_ensure_distributed_virtual_and_real():
    """No coordinator: no bring-up, one process.  A coordinator and more
    than one host: the ``torch.distributed`` bring-up, not ported."""
    assert ensure_distributed(None) == (0, 1)
    assert ensure_distributed({"hosts": 2, "coordinator": None,
                               "process_id": 0}) == (0, 1)
    assert ensure_distributed({"hosts": 1, "coordinator": "localhost:1",
                               "process_id": 0}) == (0, 1)
    with pytest.raises(NotImplementedError, match="not ported.*7.6"):
        ensure_distributed({"hosts": 2, "coordinator": "localhost:1",
                            "process_id": 0})


def test_mesh_mode_with_coordinator_rejected(runtime, cpu_pool):
    body = {"version": 0, "name": "p_mesh_real", "runtime": "torch",
            "graph": ["(det)"],
            "parameters": {"mesh": {"hosts": 2,
                                    "coordinator": "localhost:1"}},
            "elements": [_stage("det", {"devices": 2})]}
    with pytest.raises(DefinitionError, match="multi-host.*not ported"):
        Pipeline(body, runtime=runtime)


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
