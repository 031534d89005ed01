"""The admission chunk with its slot and start on the device
(``llama.prefill_into_slot_at``, what ``loop_graph.AdmissionRunner``
captures on the card) against the host-int form
(``llama.prefill_into_slot``), and the batcher's rule for which path a
chunk takes.

On the CPU the device form runs eagerly, so both forms must agree
exactly: the logits and every cache layer, at float32 and bfloat16,
flash and plain attention, at the first chunk, a later one and the
start the batcher clamps to, and with a padded last chunk.  The captured
replay itself runs on the card (``tests/test_torch_cuda.py``).  Nothing
here runs JAX: both forms are held to the JAX package by
``tests/test_torch_llama.py`` (the host form also by
``tests/test_torch_batching.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.models import batching, llama
from aiko_services_tpu_torch.models.loop_graph import AdmissionRunner
from aiko_services_tpu_torch.models.paged import init_paged_cache
from aiko_services_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)
from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh
from aiko_services_tpu_torch.parallel.mesh import P

CHUNK, MAX_SEQ, SLOTS = 512, 1280, 3


def _config(dtype: str, attention: str, **overrides):
    return dataclasses.replace(llama.LlamaConfig.tiny(256, MAX_SEQ),
                               dtype=dtype, attention=attention, **overrides)


def _filled_cache(config, seed: int = 1) -> dict:
    """A dense cache whose every row holds k/v already, so a chunk's
    attention reads what earlier chunks (and other slots) wrote."""
    cache = llama.init_cache(config, SLOTS, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for side in ("k", "v"):
        cache[side].copy_(torch.randn(cache[side].shape, generator=gen))
    return cache


def _chunk(real: int, seed: int) -> torch.Tensor:
    """One [1, CHUNK] chunk whose first ``real`` tokens are the prompt's,
    the rest pad zeros (the batcher's padded last chunk)."""
    tokens = torch.zeros((1, CHUNK), dtype=torch.int64)
    tokens[0, :real] = torch.from_numpy(
        np.random.default_rng(seed).integers(1, 256, real))
    return tokens


@pytest.mark.parametrize("real", [CHUNK, 100], ids=["whole", "padded"])
@pytest.mark.parametrize("start", [0, 512, MAX_SEQ - CHUNK],
                         ids=["first", "second", "clamped"])
@pytest.mark.parametrize("attention", ["flash", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_slot_and_start_equal_host_ints(dtype, attention, start,
                                               real):
    """``prefill_into_slot_at`` at ``(slot, start)`` on the device writes
    and returns exactly what ``prefill_into_slot`` does at the same host
    ints: the logits and every layer of both cache sides."""
    config = _config(dtype, attention)
    params = llama.init_params(0, config, device="cpu")
    tokens = _chunk(real, start + real)
    host_cache, device_cache = _filled_cache(config), _filled_cache(config)
    want, _ = llama.prefill_into_slot(params, config, tokens, host_cache,
                                      2, start)
    at = torch.tensor([2, start], dtype=torch.int32)
    got, cache = llama.prefill_into_slot_at(params, config, tokens,
                                            device_cache, at)
    assert cache is device_cache
    assert torch.equal(got, want)
    for side in ("k", "v"):
        for layer in range(config.n_layers):
            assert torch.equal(device_cache[side][layer],
                               host_cache[side][layer]), (side, layer)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_runner_on_the_cpu_runs_the_device_form(attention):
    """The body the runner captures (the device form over its ``tokens``
    and ``at`` inputs, filled by ``upload``) writes and returns what the
    host-int form does, slot after slot.  ``run`` itself (capture and
    replay) refuses the CPU, and ``prefill_into_slot(..., runner=)``
    checks the chunk's extent before it reaches the runner."""
    config = _config("float32", attention)
    params = llama.init_params(0, config, device="cpu")
    runner = AdmissionRunner(params, config, chunk=CHUNK,
                             device=torch.device("cpu"))
    host_cache, runner_cache = _filled_cache(config), _filled_cache(config)
    for slot, start in ((1, 0), (0, 512), (1, 512)):
        tokens = _chunk(CHUNK, slot + start)
        want, _ = llama.prefill_into_slot(params, config, tokens, host_cache,
                                          slot, start)
        runner.upload("tokens", tokens.numpy())
        runner.upload("at", np.array([slot, start], dtype=np.int32))
        assert torch.equal(runner._chunk(runner_cache), want)
    for side in ("k", "v"):
        assert torch.equal(runner_cache[side], host_cache[side])
    with pytest.raises(RuntimeError, match="captures on a CUDA card"):
        llama.prefill_into_slot(params, config, _chunk(CHUNK, 0).numpy(),
                                runner_cache, 0, 0, runner=runner)
    with pytest.raises(ValueError, match="does not fit"):
        llama.prefill_into_slot(params, config, _chunk(CHUNK, 0).numpy(),
                                runner_cache, 0, MAX_SEQ - CHUNK + 1,
                                runner=runner)
    assert runner.captures == 0 and runner.replays == 0


@pytest.mark.parametrize("offset", [0, 37, 200])
def test_reference_with_tensor_offset_and_row_equals_ints(offset):
    """#4's plain version: a 0-d tensor offset equals the int offset, and
    ``at`` (row, offset) over a whole cache layer equals the int offset
    over that row's slice."""
    gen = torch.Generator().manual_seed(offset)
    q = torch.randn((1, 40, 8, 64), generator=gen)
    k = torch.randn((3, 256, 2, 64), generator=gen)
    v = torch.randn((3, 256, 2, 64), generator=gen)
    want = flash_attention_reference(q, k[2:3], v[2:3], offset)
    got = flash_attention_reference(q, k[2:3], v[2:3], torch.tensor(offset))
    assert torch.equal(got, want)
    at = torch.tensor([2, offset], dtype=torch.int32)
    assert torch.equal(flash_attention_reference(q, k, v, at=at), want)
    assert torch.equal(flash_attention(q, k, v, at=at), want)


def test_device_form_refuses_what_it_cannot_index():
    """Paged and int8 caches keep the host-int form."""
    config = _config("float32", "flash")
    params = llama.init_params(0, config, device="cpu")
    tokens, at = _chunk(CHUNK, 0), torch.tensor([0, 0], dtype=torch.int32)
    paged = init_paged_cache(config, SLOTS, MAX_SEQ, 64, device="cpu")
    int8 = llama.init_cache(dataclasses.replace(config, kv_dtype="int8"),
                            SLOTS, device="cpu")
    for cache in (paged, int8):
        with pytest.raises(ValueError, match="dense cache of raw"):
            llama.prefill_into_slot_at(params, config, tokens, cache, at)


def test_path_rule_captures_only_unplaced_dense_raw_on_a_card():
    """The batcher replays a captured chunk on a card, for an unplaced
    tree over a dense cache of raw k/v; the CPU, a paged cache, an int8
    cache and a placed tree keep the eager call."""
    config = _config("bfloat16", "flash")
    params = {"embed": torch.zeros(1)}
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    plan = MeshPlan(make_mesh({"tp": 2}, [torch.device("cpu", i)
                                          for i in range(2)]))
    placed = plan.put({"embed": torch.zeros(2)}, P())
    int8 = dataclasses.replace(config, kv_dtype="int8")
    assert batching.captures_admission(card, params, config, 0)
    assert not batching.captures_admission(cpu, params, config, 0)
    assert not batching.captures_admission(card, params, config, 64)
    assert not batching.captures_admission(card, params, int8, 0)
    assert not batching.captures_admission(card, placed, config, 0)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_cpu_batcher_counts_eager_chunks_and_marks_spans(attention,
                                                         monkeypatch):
    """On the CPU every chunk is eager: ``admission_eager`` counts each
    chunk (a batched dense burst counts its rows), ``admission_replays``
    stays 0, and every ``batcher.prefill`` span says ``graph: False``."""
    config = dataclasses.replace(llama.LlamaConfig.tiny(256, 128),
                                 dtype="float32", attention=attention)
    params = llama.init_params(0, config, device="cpu")
    seen = []
    original = batching.span

    def recording(name, *args, **kwargs):
        made = original(name, *args, **kwargs)
        if name == "batcher.prefill":
            seen.append(made)
        return made
    monkeypatch.setattr(batching, "span", recording)
    batcher = batching.ContinuousBatcher(params, config, max_slots=2,
                                         prefill_chunk=16, decode_block=4,
                                         device="cpu")
    assert batcher._admission is None
    rng = np.random.default_rng(3)
    for index, length in enumerate((40, 23, 9)):
        batcher.submit(batching.Request(
            str(index), rng.integers(1, 256, length).tolist(),
            max_new_tokens=4))
    batcher.run_until_drained(max_steps=200)
    chunks = sum(-(-length // 16) for length in (40, 23, 9))
    assert batcher.admission_eager == chunks
    assert batcher.admission_replays == 0
    assert seen and all(made.info["graph"] is False for made in seen)


def test_replay_refuses_a_moved_cache():
    """A replay whose cache is not the one captured raises before it
    launches anything."""
    config = _config("float32", "flash")
    runner = AdmissionRunner({}, config, chunk=CHUNK,
                             device=torch.device("cpu"))
    captured, other = _filled_cache(config), _filled_cache(config)
    runner._graph = object()
    runner._bound = runner._pointers(captured)
    with pytest.raises(RuntimeError, match="AdmissionRunner: the cache"):
        runner._replay(other)
    runner.reset()
    assert runner._graph is None and runner._bound == ()

