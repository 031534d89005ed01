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
  ``PeerLost`` within the bring-up's timeout;
- ``ContinuousBatcher`` on the int8 tree (bridged from the JAX
  package's weights) over ``{"dp": 2, "tp": 2}`` with dp across the
  processes and over ``{"tp": 2}`` with a position a process, four
  requests (two greedy, two at 0.8, top-k 8): dense at decode_block 4,
  paged at decode_block 1, the plain loop and the ngram loop over pages
  (eager on the CPU) and a fault at the 2nd dispatch with ``recover()``
  -- every stream, greedy and sampled, and the host state (slots,
  lengths, counters, page table, prefix counters) equal in both
  processes and to the port's one-process batcher over the same mesh of
  CPU descriptors, and the dense run's greedy streams token-equal to the
  JAX package's ``ContinuousBatcher`` (its synchronous loop) over the
  same mesh of virtual devices; one batcher built and stepped once
  across the processes (no refusal); ``speculative="auto"`` with each
  process's probe made to report another ratio: both take the lowest
  and serve plain;
- the capture path of the exchanges (``distributed.capturing``) over
  gloo between CPU tensors: a placed decode step's logits bitwise equal
  to the eager step's, the groups' sequences agreeing after
  ``replayed``, and an exchange whose layout no eager exchange checked
  raising;
- the dryrun's ``[moe-ep]`` train step (``tiny_moe`` over ``{"dp": 2,
  "tp": 2, "ep": 2}``) with dp across the processes (the dryrun's device
  order) and with ep across them: the loss within ``LOSS_TOL`` and every
  updated parameter within ``REL_TOL`` of the JAX package's one-process
  step over the same mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_serving_tp_int8 as tp_int8
import torch_multihost_worker as worker
from aiko_services_tpu.models import batching as jb
from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.models import quant as jq
from aiko_services_tpu.models import train as jt
from aiko_services_tpu.parallel import MeshPlan as JaxPlan
from aiko_services_tpu.parallel import device_inventory as jax_inventory
from aiko_services_tpu.parallel import make_mesh as jax_make_mesh
from aiko_services_tpu_torch.models import batching as tb
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                  quantize_specs)
from aiko_services_tpu_torch.parallel import MeshPlan, distributed, make_mesh

LOSS_TOL = 1e-5
REL_TOL = 1e-4
LOGITS_TOL = 1e-5
CASES = ["bringup", "collectives", "train", "decode", "pipeline",
         "pipeline_host", "batcher", "batcher_step", "spec_probe",
         "capture_path", "moe_ep"]
POOL = [torch.device("cpu", index) for index in range(8)]


def _jax_config(remat: bool = False):
    return dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128,
                                                   max_seq=64),
                               dtype="float32", remat=remat)


def _moe_config():
    return dataclasses.replace(jl.LlamaConfig.tiny_moe(256, 64),
                               dtype="float32")


@pytest.fixture(scope="module")
def weights():
    """The JAX package's weights (seed 0) as numpy trees: the train
    cases', the serving tree's (``tests/test_torch_serving_tp_int8.py``'s
    bridged tree) and the MoE's."""
    serving, _ = tp_int8._configs("int8", "flash")
    return {name: jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), config))
        for name, config in (("train", _jax_config()), ("serving", serving),
                             ("moe", _moe_config()))}


@pytest.fixture(scope="module")
def pair(tmp_path_factory, weights):
    """Both processes' results of every case but the lost peer."""
    out = tmp_path_factory.mktemp("multihost")
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


BATCHER_KEYS = [f"{mesh} {run}" for mesh, _ in worker.BATCHER_MESHES
                for run, _ in worker.BATCHER_RUNS]


@pytest.fixture(scope="module")
def one_process_batcher(weights):
    """The same batcher runs in this process over the same meshes of CPU
    descriptors."""
    return worker.batcher(weights["serving"], devices=POOL)


@pytest.mark.parametrize("key", BATCHER_KEYS)
def test_batcher_across_processes_matches_one_process(
        pair, one_process_batcher, key):
    """Every stream, greedy and sampled, and the host state each process
    ends with equal the one-process batcher's over the same mesh."""
    want = one_process_batcher[key]
    assert all(len(stream) == worker.BATCHER_TOKENS
               for stream in want["streams"].values())
    for result in pair:
        got = result["batcher"][key]
        assert got["streams"] == want["streams"]
        assert got["host"] == want["host"]
        assert got["recoveries"] == want["recoveries"] == (
            1 if "recover" in key else 0)
        assert got["host"]["leaked"] == 0
    if "ngram" in key:
        assert want["host"]["draft_tokens"] > 0


@pytest.mark.parametrize("mesh", [label for label, _
                                  in worker.BATCHER_MESHES])
def test_batcher_dense_greedy_streams_match_jax(pair, mesh):
    """The dense run's greedy streams against the JAX package's batcher
    (decode_block 1, its synchronous loop) on the JAX tree sharded over
    the same mesh of virtual devices, its cache placed by
    ``cache_put``."""
    axes = dict(worker.BATCHER_MESHES)[mesh]
    jc, _, jparams, _ = tp_int8._trees("int8", "flash")
    plan = tp_int8._jax_plan(axes)
    sharded = plan.put(jparams, jq.quantize_specs(jl.partition_specs(jc)))
    cache_sharding = jax.tree_util.tree_map(plan.shard, jl.cache_specs(jc))
    batcher = jb.ContinuousBatcher(
        sharded, jc, decode_block=1, **worker.SMALL_BATCHER,
        cache_put=lambda c: jax.device_put(c, cache_sharding))
    streams = {}
    for index, (prompt, temperature) in enumerate(worker.batcher_requests()):
        rid = f"r{index}"
        streams[rid] = []
        batcher.submit(jb.Request(
            rid, list(prompt), max_new_tokens=worker.BATCHER_TOKENS,
            temperature=temperature,
            emit=lambda r, token, done: streams[r].append(int(token))))
    assert batcher.run_until_drained(max_steps=500) < 500
    greedy = [f"r{index}" for index, (_, temperature)
              in enumerate(worker.batcher_requests()) if temperature == 0]
    for result in pair:
        got = result["batcher"][f"{mesh} dense-4"]["streams"]
        assert {rid: got[rid] for rid in greedy} == \
            {rid: streams[rid] for rid in greedy}


def test_batcher_builds_and_steps_across_processes(pair):
    """The refusal of a mesh that spans processes is gone: the batcher
    over ``{"tp": 2}`` across the two processes builds and steps."""
    for result in pair:
        got = result["batcher_step"]
        assert got["spans"]
        assert got["occupied"] == 1 and got["prefill_tokens"] == 5
        assert got["device"] == "cpu"


def test_spec_autoprobe_agrees_across_processes(pair):
    """Each process measures its own ratio (both arms ran across the
    processes) and is made to report another: alone, process 0 would
    serve draft and process 1 plain; both take the lowest and serve
    plain, the plain loop's streams."""
    forced = [result["spec_probe"]["forced"] for result in pair]
    assert forced[0] >= tb.SPEC_AUTO_MIN_RATIO > forced[1]
    for result in pair:
        got = result["spec_probe"]
        assert len(got["measured"]) == 1 and got["measured"][0] > 0
        assert got["spec_probe_ratio"] == min(forced)
        assert got["speculative"] == "off"
        assert got["streams"] == result["batcher"]["tp2 loop-16"]["streams"]


def test_capture_path_of_the_exchanges(pair):
    """Inside ``distributed.capturing`` a placed decode step gives the
    eager step's logits bit for bit, ``replayed`` finds the processes at
    the same sequence (the next eager step's headers agree), and an
    exchange no eager one laid out raises."""
    for result in pair:
        got = result["capture_path"]
        assert torch.equal(got["captured"], got["eager"])
        assert torch.equal(got["again"], got["eager"])
        assert got["counts"] and all(count > 0 for count in got["counts"])
        assert got["unchecked"] is not None \
            and "never made eagerly" in got["unchecked"]


@pytest.fixture(scope="module")
def one_process_moe(weights):
    """The ``[moe-ep]`` step in this process over the same mesh of CPU
    descriptors."""
    return worker.moe_ep(weights["moe"], devices=POOL)["dp-across"]


@pytest.mark.parametrize("order", worker.MOE_ORDERS)
def test_moe_ep_step_across_processes_matches_jax(pair, one_process_moe,
                                                  order):
    """The dryrun's ``[moe-ep]`` step, each process holding half the
    mesh's positions in ``order``: the loss within ``LOSS_TOL`` of the
    JAX package's one-process step over the same mesh, every gradient
    leaf within ``REL_TOL`` of its largest magnitude of the JAX
    package's gradient, and every updated parameter within ``REL_TOL``
    of the port's one-process step over the same mesh.  (AdamW's first
    step moves each weight by about the learning rate times the sign of
    its gradient, so an expert weight whose gradient is at float32's
    noise (w_down: 1e-8) moves by a noise-chosen amount: the port's
    one-process step stands 2.8e-4 of w_down's scale from the JAX
    package's, the same as the processes' step.)"""
    config = _moe_config()
    plan = JaxPlan(jax_make_mesh(worker.MOE_AXES, jax.devices()[:8]))
    params, state, optimizer = jt.init_train_state(jax.random.PRNGKey(0),
                                                   config, plan)
    tokens = jnp.asarray(worker.moe_batch())
    _, grads = jax.jit(jax.value_and_grad(
        lambda p: jt.language_model_loss(p, config, tokens)))(params)
    step = jt.make_train_step(config, plan, optimizer=optimizer)
    _, _, loss = step(params, state, tokens)

    def named(tree) -> dict:
        return {".".join(str(key.key) for key in path):
                np.asarray(leaf, dtype=np.float64)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree)[0]}
    want_grads = named(grads)
    crossing = "dp" if order == "dp-across" else "ep"
    for result in pair:
        got = result["moe_ep"][order]
        owners = np.array(got["owners"]).reshape(
            [got["axes"][axis] for axis in got["axes"]])
        split = list(got["axes"]).index(crossing)
        assert all(len(set(np.take(owners, index, axis=split).flat)) == 1
                   for index in range(2))
        assert abs(got["loss"] - float(loss)) <= LOSS_TOL
        assert set(got["grads"]) == set(want_grads) == set(got["params"])
        for name, leaf in want_grads.items():
            scale = max(np.abs(leaf).max(), 1e-12)
            assert np.abs(got["grads"][name] - leaf).max() \
                <= REL_TOL * scale, name
        for name, leaf in one_process_moe["params"].items():
            scale = max(np.abs(leaf).max(), 1e-12)
            assert np.abs(got["params"][name] - leaf).max() \
                <= REL_TOL * scale, name
