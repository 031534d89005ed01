"""The multi-host backend on four cards: two processes of two cards each
(``CUDA_VISIBLE_DEVICES`` 0,1 and 2,3), so the transport is NCCL, over
``{"dp": 2, "tp": 2}`` with dp across the processes and tp inside each.
Each path is held to the same path run by ONE process over the same
four cards (``tests/torch_multihost_worker.py`` runs both):

- Llama-3-8B int8 placed (flash, int8 cache): four prompts of 100-1,500
  tokens into their slots of a dp-split cache (each slot's dp group --
  one process -- admits it), then 8 greedy decode steps: every logits
  tensor bitwise equal (SHA-256 of its bytes) and the tokens equal;
- Llama-3.2-1B, two train steps of a 4 x 512 batch: the losses and a
  checksum of the updated tree equal (the replicas' gradients summed in
  position order in both);
- the ``(det llm)`` pipeline, two cards a stage, ``det`` in process 0
  and ``llm`` in process 1: four frames in order in both processes,
  ``llm``'s outputs in process 1 equal to the one-process virtual
  carve's, the hop between the processes' cards over NCCL.

Imports no JAX; skips with fewer than four cards.  Prints the times
(``-s``):

    python3 -m pytest --noconftest -q -s tests/test_torch_multihost_cuda.py
"""

import json
import subprocess

import pytest
import torch

import torch_multihost_worker as worker


@pytest.fixture(scope="module")
def four_cards():
    """The four cards, the kernels built first (no timed call builds
    them; the spawned processes load the same build)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    from aiko_services_tpu_torch.ops import _build
    _build.load_library()
    return [torch.device("cuda", index) for index in range(4)]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]


def _spawned(tmp_path, case: str) -> list[dict]:
    results = worker.spawn([case], tmp_path, cards=["0,1", "2,3"],
                           timeout=900.0)
    for process, result in enumerate(results):
        assert result["_exit"] == 0 and "error" not in result, \
            f"process {process}: {result.get('error') or result['_log']}"
    return [result[case] for result in results]


def _report(label: str, **numbers) -> None:
    print(f"multihost-cuda {label} {json.dumps(numbers)} on {_card()}",
          flush=True)


@pytest.mark.cuda
def test_placed_int8_decode_across_processes_matches_one_process(
        tmp_path, four_cards):
    one = worker.card_decode(four_cards)
    torch.cuda.empty_cache()
    both = _spawned(tmp_path, "card_decode")
    _report("decode", one_process={key: one[key] for key in
                                   ("prefill_ms", "decode_step_ms")},
            processes=[{key: got[key] for key in
                        ("prefill_ms", "decode_step_ms")} for got in both])
    for got in both:
        assert got["tokens"] == one["tokens"]
        assert got["digests"] == one["digests"]


@pytest.mark.cuda
def test_train_steps_across_processes_match_one_process(tmp_path,
                                                        four_cards):
    one = worker.card_train(four_cards)
    torch.cuda.empty_cache()
    both = _spawned(tmp_path, "card_train")
    _report("train", one_process={"losses": one["losses"],
                                  "step_ms": one["step_ms"]},
            processes=[{"losses": got["losses"], "step_ms": got["step_ms"]}
                       for got in both])
    for got in both:
        assert got["losses"] == one["losses"]
        assert got["checksum"] == one["checksum"]


@pytest.mark.cuda
def test_det_llm_hop_between_processes_cards(tmp_path, four_cards):
    one = worker.card_pipeline(None, 0)
    both = _spawned(tmp_path, "card_pipeline")
    _report("pipeline", one_process_seconds=one["seconds"],
            processes_seconds=[got["seconds"] for got in both])
    want = [row["x"] for row in one["rows"]]
    assert len(want) == 4 and all(row["okay"] for row in one["rows"])
    for process, got in enumerate(both):
        assert got["stage_hosts"] == {"det": 0, "llm": 1}
        assert [row["frame"] for row in got["rows"]] == [0, 1, 2, 3]
        assert all(row["okay"] for row in got["rows"]), got["rows"]
        for row, value in zip(got["rows"], want):
            if process == 1:
                assert torch.equal(row["x"], value)
            else:
                assert row["x"] == "RemoteValue(process 1, llm.x)"


@pytest.mark.cuda
def test_transport_is_nccl_across_distinct_cards(tmp_path, four_cards):
    both = _spawned(tmp_path, "bringup")
    for process, got in enumerate(both):
        assert got["first"] == (process, 2)
        assert got["transport"] == "nccl"
        assert got["inventory"]["device_count"] == 4
        assert got["inventory"]["local_device_count"] == 2
