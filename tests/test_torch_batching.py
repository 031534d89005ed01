"""Port parity for the continuous batcher: the port's ``ContinuousBatcher``
emits the same token streams as the JAX batcher at temperature 0, with
flash prefill, flash decode and top-k sampling on, through chunked
admission and queueing, at decode_block 1 (synchronous) and 4
(pipelined).  The port's streams are held to the JAX package's
SYNCHRONOUS loop: its pipelined loop races on host mirrors that the CPU
backend aliases (ROADMAP Queue 3), and at temperature 0 both loops emit
one stream.  The same weights reach both through the numpy bridge."""

import dataclasses

import jax
import numpy as np
import pytest

from aiko_services_tpu.models import batching as jb
from aiko_services_tpu.models import llama as jl
from aiko_services_tpu_torch.models import batching as tb
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl


def _twins(vocab=512, **overrides):
    settings = dict(dtype="float32", **overrides)
    jc = dataclasses.replace(jl.LlamaConfig.tiny(vocab, 64), **settings)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(vocab, 64), **settings)
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a), jp), tc,
        device="cpu")
    return jc, tc, jp, tp


def _prompts(vocab=512):
    rng = np.random.default_rng(0)
    # The second prompt is longer than a 16-token chunk (chunked
    # admission); three requests on two slots queue the third.
    return [rng.integers(0, vocab, n).tolist() for n in (5, 23, 9)]


def _serve(module, params, config, prompts, temperature=0.0, **kwargs):
    batcher = module.ContinuousBatcher(params, config, max_slots=2,
                                       prefill_chunk=16, **kwargs)
    streams = {}
    for index, prompt in enumerate(prompts):
        streams[index] = []
        batcher.submit(module.Request(
            str(index), list(prompt), max_new_tokens=10,
            temperature=temperature,
            emit=lambda rid, token, done, i=index: streams[i].append(token)))
    batcher.run_until_drained(max_steps=500)
    return streams, batcher


@pytest.mark.parametrize("decode_block", [1, 4])
def test_token_streams_match_jax_batcher(decode_block):
    settings = dict(attention="flash", decode_attention="flash")
    jc, tc, jp, tp = _twins(**settings)
    prompts = _prompts()
    theirs, _ = _serve(jb, jp, jc, prompts, sample_top_k=4, decode_block=1)
    ours, batcher = _serve(tb, tp, tc, prompts, sample_top_k=4,
                           decode_block=decode_block, device="cpu")
    assert ours == theirs
    assert all(len(stream) == 10 for stream in ours.values())
    assert batcher.prefill_tokens == sum(len(p) for p in prompts)
    assert batcher.active_count == 0 and batcher.blocks_in_flight == 0


def test_batched_dense_admission_matches_jax_batcher():
    """decode_block > 1 with dense attention admits a burst through
    prefill_into_slots (padded to a power-of-two bucket)."""
    jc, tc, jp, tp = _twins(decode_attention="dense")
    prompts = _prompts()
    theirs, _ = _serve(jb, jp, jc, prompts, decode_block=4)
    ours, _ = _serve(tb, tp, tc, prompts, decode_block=4, device="cpu")
    assert ours == theirs


@pytest.mark.parametrize("decode_block", [1, 4])
def test_sample_top_k_one_is_greedy(decode_block):
    """The contract of the JAX package's
    test_kernel_plane.py::test_batcher_sample_top_k_round_trip, on the
    port's host-loop paths: sample_top_k=1 at temperature 0.9 emits the
    greedy stream (top-1 == argmax)."""
    _, tc, _, tp = _twins(vocab=64)
    prompt = [[5, 9, 2, 7]]
    greedy, _ = _serve(tb, tp, tc, prompt, decode_block=decode_block,
                       device="cpu")
    top1, _ = _serve(tb, tp, tc, prompt, temperature=0.9, sample_top_k=1,
                     decode_block=decode_block, device="cpu")
    assert top1 == greedy


def test_cancel_and_qos_order():
    _, tc, _, tp = _twins()
    batcher = tb.ContinuousBatcher(tp, tc, max_slots=1, prefill_chunk=16,
                                   device="cpu")
    order = []
    for rid, rank in (("late", 1), ("urgent", 0), ("dropped", 0)):
        request = tb.Request(rid, [1, 2, 3], max_new_tokens=2,
                             emit=lambda r, t, done: done and order.append(r))
        request.qos_rank = rank
        batcher.submit(request)
    assert batcher.cancel("dropped")
    batcher.run_until_drained(max_steps=100)
    assert order == ["urgent", "late"]
    assert [s["tokens"] for s in batcher.take_request_stats()] == [2, 2]


def test_pad_to_bucket_matches():
    for rows in ([3], [3, 1], [3, 1, 2], [0, 1, 2, 3, 4]):
        assert tb.pad_to_bucket(rows) == jb.pad_to_bucket(rows)


@pytest.mark.parametrize("options,message", [
    (dict(speculative="ngram"), "device loop"),
    (dict(decode_block_tokens=8, speculative="banana"), "off|ngram|draft"),
    (dict(decode_block_tokens=4, speculative="ngram", spec_tokens=4),
     "speculative emission")])
def test_speculative_requires_device_loop(options, message):
    """The construction errors of the JAX package's
    test_serving_loop.py::test_speculative_requires_device_loop, word for
    word, on both packages."""
    jc, tc, jp, tp = _twins()
    for module, params, config, extra in ((jb, jp, jc, {}),
                                          (tb, tp, tc, {"device": "cpu"})):
        with pytest.raises(ValueError, match=message) as caught:
            module.ContinuousBatcher(params, config, **options, **extra)
        if module is jb:
            expected = str(caught.value)
    assert str(caught.value) == expected
