"""Training and mixture-of-experts serving on the card, against the same
work on the CPU.  Imports no JAX, so it runs on the card machine:

    python3 -m pytest --noconftest -q tests/test_torch_train_cuda.py

Without a card every test here skips."""

import dataclasses

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.models import llama, train
from aiko_services_tpu_torch.models.batching import ContinuousBatcher, Request
from aiko_services_tpu_torch.parallel.mesh import MeshPlan

BF16_TOL = 2e-2         # bf16 weights and activations, relative to max |x|
# The first AdamW step's update (parameters after minus before, the whole
# tree), card against CPU, in the L2 norm relative to the CPU's update.
# A skipped update is 1.0 away and one of the wrong sign 2.0.  Elementwise
# the two cannot agree: the step moves a bf16 weight by lr (3e-4), one or
# two ulps, and a gradient near zero can change sign between devices.  On
# the CPU, a step from float32 gradients lands 0.14 (tiny) and 0.21
# (tiny_moe) from the bf16 step; on an H100 the card's bf16 update lands
# 0.067 and 0.062 from the CPU's.
UPDATE_TOL = 0.25


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _to(params: dict, device) -> dict:
    return {name: _to(value, device) if isinstance(value, dict)
            else value.detach().to(device).clone()
            for name, value in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tiny", "tiny_moe"])
def test_train_step_on_card_matches_cpu(cuda_device, preset):
    """Two AdamW steps of the bf16 tiny config on the card and on the CPU
    from the same weights and batch: both steps' losses within the bf16
    tolerance (the second one sees the first update), and the first
    update within UPDATE_TOL of the CPU's."""
    config = getattr(llama.LlamaConfig, preset)(vocab_size=128, max_seq=64)
    start = llama.init_params(0, config, device="cpu")
    before = torch.cat([leaf.float().flatten()
                        for leaf in train._leaves(start)])
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, (4, 16)).astype(np.int64))
    results = {}
    for device in (torch.device("cpu"), cuda_device):
        plan = MeshPlan.build({"dp": 1}, devices=[device])
        params = _to(start, device)
        leaves = train._leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        opt_state = train.adamw()(leaves)
        step = train.make_train_step(config, plan)
        _, _, loss1 = step(params, opt_state, tokens.to(device))
        update = torch.cat([leaf.detach().float().cpu().flatten()
                            for leaf in leaves]) - before
        _, _, loss2 = step(params, opt_state, tokens.to(device))
        results[device.type] = ([float(loss1), float(loss2)], update)
    cpu_losses, cpu_update = results["cpu"]
    card_losses, card_update = results["cuda"]
    # The batch makes one step visible in the second loss.
    assert cpu_losses[0] - cpu_losses[1] > BF16_TOL * cpu_losses[0]
    for ours, want in zip(card_losses, cpu_losses):
        assert abs(ours - want) <= BF16_TOL * abs(want)
    gap = float((card_update - cpu_update).norm() / cpu_update.norm())
    print(f"{preset}: losses card {card_losses} cpu {cpu_losses}; "
          f"update gap {gap:.4f}")
    assert gap <= UPDATE_TOL


def _serve(params, config, device, **options):
    batcher = ContinuousBatcher(params, config, max_slots=4, max_seq=64,
                                prefill_chunk=16, device=device, **options)
    streams = {}
    rng = np.random.default_rng(0)
    for index, length in enumerate((7, 23, 9, 12, 5)):
        streams[index] = []
        batcher.submit(Request(
            f"r{index}", rng.integers(0, config.vocab_size, length).tolist(),
            max_new_tokens=9,
            emit=lambda rid, token, done, i=index: streams[i].append(token)))
    assert batcher.run_until_drained(max_steps=500) < 500
    return streams


@pytest.mark.cuda
def test_moe_serving_on_card_matches_cpu(cuda_device):
    """tiny_moe (float32) through the batcher on the card: the host loop
    and the captured device loop (ngram over pages too) emit the CPU host
    loop's greedy streams."""
    config = dataclasses.replace(llama.LlamaConfig.tiny_moe(),
                                 dtype="float32")
    params = llama.init_params(0, config, device="cpu")
    want = _serve(params, config, "cpu")
    card = _to(params, cuda_device)
    for options in (dict(decode_block=4), dict(decode_block_tokens=8),
                    dict(decode_block_tokens=8, speculative="ngram",
                         kv_page_tokens=16)):
        assert _serve(card, config, cuda_device, **options) == want, options


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tiny", "tiny_moe"])
def test_batched_admission_makes_no_host_sync(cuda_device, preset):
    """``prefill_into_slots`` (the pipelined loops' burst admission with
    dense attention) runs under the ``error`` guard: its slot and start
    indices go up through pinned memory, and the MoE dispatch waits for
    nothing."""
    from aiko_services_tpu_torch.device import sync_guard
    config = dataclasses.replace(getattr(llama.LlamaConfig, preset)(),
                                 dtype="float32")
    params = llama.init_params(0, config, device=cuda_device)
    cache = llama.init_cache(config, 4, device=cuda_device)
    tokens = torch.arange(48, device=cuda_device).reshape(3, 16) % 97
    plain, _ = llama.prefill_into_slots(params, config, tokens, cache,
                                        [0, 2, 2], [0, 16, 16])
    with sync_guard("error"):
        guarded, _ = llama.prefill_into_slots(params, config, tokens, cache,
                                              [0, 2, 2], [0, 16, 16])
    torch.testing.assert_close(guarded, plain)


def _moe_step_twice(device) -> list[dict]:
    """Phase 11c's MoE training step (4 experts at Llama-3.2-1B widths,
    top-2, capacity factor 2.0, ``max_seq`` 512, remat, bf16, seed 0) on
    one batch of 2 x 512 tokens (numpy seed 0), run twice from scratch in
    this process: each run's gradients at the initial weights (on the
    host) and its losses over three AdamW steps."""
    config = dataclasses.replace(llama.LlamaConfig.llama3_1b(), n_experts=4,
                                 max_seq=512, remat=True)
    plan = MeshPlan.build({"dp": 1}, devices=[device])
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, config.vocab_size, (2, 512))).to(device)
    runs = []
    for _ in range(2):
        params, state, _ = train.init_train_state(0, config, plan)
        _, grads = train.value_and_grad(params, config, tokens)
        found = {"grads": [leaf.detach().cpu()
                           for leaf in train._leaves(grads)]}
        del grads
        step = train.make_train_step(config, plan)
        found["losses"] = [float(step(params, state, tokens)[2])
                           for _ in range(3)]
        runs.append(found)
        del params, state
        torch.cuda.empty_cache()
    return runs


@pytest.mark.cuda
def test_moe_train_step_is_bitwise_repeatable(cuda_device):
    """Two runs of the MoE step in one process on one card: every
    gradient leaf and every loss bit for bit equal."""
    first, second = _moe_step_twice(cuda_device)
    print(f"moe step losses {first['losses']} and {second['losses']}")
    assert first["losses"] == second["losses"]
    assert first["losses"][-1] < first["losses"][0]
    assert len(first["grads"]) == len(second["grads"])
    for ours, theirs in zip(first["grads"], second["grads"]):
        assert torch.equal(ours, theirs)
