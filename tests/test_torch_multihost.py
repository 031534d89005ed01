"""The port's multi-host backend (``parallel/distributed.py``) over two
real processes: gloo, four CPU descriptors a process
(``AIKO_CPU_DEVICES``), the processes' side in
``tests/torch_multihost_worker.py`` (JAX-free), one spawned pair for
most cases.

Held against:

- the collectives (``psum``, ``all_gather``, ``all_to_all``,
  ``ppermute`` with a position that receives nothing, a tuple
  ``ppermute``, ``axis_index``, ``remat`` around a ``psum``) over
  ``{"dp": 2, "tp": 2}`` with dp across the processes: the outputs and
  the input's gradient BITWISE equal to the same mesh run by threads of
  one process.  The cotangent is integer-valued and every sum stays
  exact, so the order in which each process adds its share cannot
  change a bit;
- the train step over ``{"dp": 2}``, ``{"dp": 2, "tp": 2}`` and the
  latter with remat, dp across the processes, and over ``{"fsdp": 2}``
  (each layer gathered across the processes): the loss within
  ``LOSS_TOL`` and every updated parameter within ``REL_TOL`` of its
  largest magnitude of the JAX package's one-process step over the same
  mesh of virtual CPU devices, from the same weights (bridged);
- the int8 tree placed over ``{"tp": 2}``, position 0 in process 0 and
  position 1 in process 1, prefill and greedy decode: tokens equal and
  logits bitwise equal to the port's one-process placed run over the
  same mesh, and within ``LOGITS_TOL`` of max |logit| of the unplaced
  tree (``tests/test_torch_serving_tp_int8.py``'s bound);
- the ``(det llm)`` pipeline over ``mesh: {hosts: 2, coordinator}``:
  the carve of ``tests/test_data_plane.py``'s mesh-mode test (the JAX
  package's virtual carve of the same pool), four frames in order in
  both processes, ``llm``'s tensors in process 1 and handles naming
  process 1 in process 0; a host value produced by ``det`` fails the
  frame in both processes, naming the stage and the host;
- a peer that exits before a collective: the survivor raises
  ``PeerLost`` within the bring-up's timeout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multihost_worker as worker
from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.models import train as jt
from aiko_services_tpu.parallel import MeshPlan as JaxPlan
from aiko_services_tpu.parallel import device_inventory as jax_inventory
from aiko_services_tpu.parallel import make_mesh as jax_make_mesh
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                  quantize_specs)
from aiko_services_tpu_torch.parallel import MeshPlan, distributed, make_mesh

LOSS_TOL = 1e-5
REL_TOL = 1e-4
LOGITS_TOL = 1e-5
CASES = ["bringup", "collectives", "train", "decode", "pipeline",
         "pipeline_host"]


def _jax_config(remat: bool = False):
    return dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128,
                                                   max_seq=64),
                               dtype="float32", remat=remat)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both processes' results of every case but the lost peer."""
    out = tmp_path_factory.mktemp("multihost")
    weights = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), _jax_config()))
    torch.save(weights, out / "weights.pt")
    results = worker.spawn(CASES, out, argument=str(out / "weights.pt"))
    for process, result in enumerate(results):
        assert result["_exit"] == 0 and "error" not in result, \
            f"process {process}: {result.get('error') or result['_log']}"
    return results


def test_bringup_gives_one_global_pool(pair):
    """Each process is (k, 2), a second call returns the first's, the
    pool lists every process's devices in process order (its own plain,
    the other's as descriptors), gloo over CPU descriptors, and
    ``device_inventory`` has the JAX package's keys over the pool."""
    pools = []
    for process, result in enumerate(pair):
        got = result["bringup"]
        assert got["first"] == got["second"] == got["virtual"] == \
            (process, 2)
        assert got["transport"] == "gloo"
        assert set(got["inventory"]) == set(jax_inventory())
        assert got["inventory"] == {
            "platform": "cpu", "device_kind": "cpu", "device_count": 8,
            "process_count": 2, "local_device_count": 4}
        pools.append(got["pool"])
    local = [f"device(type='cpu', index={i})" for i in range(4)]
    remote = [[f"RemoteDevice(process {p}, cpu:{i})" for i in range(4)]
              for p in range(2)]
    assert pools == [local + remote[1], remote[0] + local]


def test_collectives_across_processes_match_threads_bitwise(pair):
    one = worker.collectives([torch.device("cpu", i) for i in range(4)])
    for result in pair:
        got = result["collectives"]
        assert torch.equal(got["y"], one["y"])
        assert torch.equal(got["grad"], one["grad"])
        assert got["grad"].abs().sum() > 0


@pytest.mark.parametrize("label", [label for label, _, _
                                   in worker.TRAIN_MESHES])
def test_train_step_across_processes_matches_jax(pair, label):
    _, axes, remat = next(row for row in worker.TRAIN_MESHES
                          if row[0] == label)
    config = _jax_config(remat)
    plan = JaxPlan(jax_make_mesh(axes, jax.devices()[:int(np.prod(list(
        axes.values())))]))
    params, state, optimizer = jt.init_train_state(jax.random.PRNGKey(0),
                                                   config, plan)
    step = jt.make_train_step(config, plan, optimizer=optimizer)
    params, _, loss = step(params, state, jnp.asarray(worker.train_batch()))
    want = {".".join(str(key.key) for key in path):
            np.asarray(leaf, dtype=np.float64)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params)[0]}
    for result in pair:
        got = result["train"][label]
        assert abs(got["loss"] - float(loss)) <= LOSS_TOL
        assert set(got["params"]) == set(want)
        for name, leaf in want.items():
            scale = max(np.abs(leaf).max(), 1e-12)
            assert np.abs(got["params"][name] - leaf).max() \
                <= REL_TOL * scale, name


def test_placed_int8_decode_across_processes(pair):
    config = worker.decode_config()
    params = quantize_params(llama.init_params(0, config, device="cpu"))
    plan = MeshPlan(make_mesh({"tp": 2}, [torch.device("cpu", 0),
                                          torch.device("cpu", 1)]))
    one = worker.placed_decode(
        plan.put(params, quantize_specs(llama.partition_specs(config))),
        config)
    unplaced = worker.placed_decode(params, config)
    for result in pair:
        got = result["decode"]
        assert [t.tolist() for t in got["tokens"]] == \
            [t.tolist() for t in one["tokens"]]
        for ours, theirs, plain in zip(got["prefill"] + got["steps"],
                                       one["prefill"] + one["steps"],
                                       unplaced["prefill"]
                                       + unplaced["steps"]):
            assert torch.equal(ours, theirs)
            scale = plain.abs().max()
            assert (ours - plain).abs().max() <= LOGITS_TOL * scale


def test_det_llm_pipeline_serves_across_processes(pair):
    """``tests/test_data_plane.py::test_mesh_mode_carves_host_groups_
    and_serves`` over two real processes: each process's four
    descriptors are a host group, ``det`` on host 0 and ``llm`` on host
    1, and the hop between them runs over the process group."""
    for process, result in enumerate(pair):
        got = result["pipeline"]
        assert got["hosts"] == 2
        assert [len(group) for group in got["host_groups"]] == [4, 4]
        assert all(f"RemoteDevice(process {1 - process}" in name
                   for name in got["host_groups"][1 - process])
        assert got["stage_hosts"] == {"det": 0, "llm": 1}
        assert got["stats_stage_hosts"] == {"det": 0, "llm": 1}
        assert not got["same_host"]
        rows = got["rows"]
        assert [row["frame"] for row in rows] == [0, 1, 2, 3]
        assert all(row["okay"] for row in rows), rows
        for row in rows:
            if process == 1:        # det's factor 2, then llm's
                assert torch.equal(row["x"], torch.full((8, 8), 4.0))
            else:
                assert row["x"] == "RemoteValue(process 1, llm.x)"


def test_host_value_across_hosts_fails_the_frame(pair):
    """A numpy frame stays a host value through ``det`` (a hop moves
    tensor leaves only), so its hop to ``llm`` on the other host fails
    the frame in both processes, naming the stage and the host."""
    for result in pair:
        rows = result["pipeline_host"]["rows"]
        assert [row["frame"] for row in rows] == [0]
        for row in rows:
            assert not row["okay"]
            assert "stage 'det' on host 0" in row["diagnostic"]


def test_lost_peer_raises_within_the_timeout(tmp_path):
    results = worker.spawn(["lost_peer"], tmp_path, gone=(1,))
    got = results[0]["lost_peer"]
    assert got["error"] and got["error"].startswith("PeerLost")
    assert got["seconds"] < distributed.BRINGUP_TIMEOUT_S
