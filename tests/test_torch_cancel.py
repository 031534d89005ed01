"""Port fix for cancelling a request in the middle of its admission.

A 40-token request on a one-slot batcher (16-token chunks) is cancelled
after one ``step()`` -- one chunk in, two to go -- and a 5-token request
follows it into the same slot.  The second request's stream must be the
stream the JAX package emits for it served ALONE (its synchronous loop):
the JAX package's own cancel path keeps the cancelled slot in its
admission queue, so the next request runs an extra chunk and emits a
duplicate first token there.  Held at decode_block 1 and 4 and in the
device loop, at temperature 0 on a tiny float32 config, the weights
bridged through ``params_from_numpy``."""

import dataclasses

import jax
import numpy as np
import pytest

from aiko_services_tpu.models import batching as jb
from aiko_services_tpu.models import llama as jl
from aiko_services_tpu_torch.models import batching as tb
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl

NEW_TOKENS = 6


@pytest.fixture(scope="module")
def twins():
    jc = dataclasses.replace(jl.LlamaConfig.tiny(512, 64), dtype="float32")
    tc = dataclasses.replace(tl.LlamaConfig.tiny(512, 64), dtype="float32")
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                                  device="cpu")
    return jc, tc, jp, tp


def _prompts():
    rng = np.random.default_rng(3)
    return rng.integers(0, 512, 40).tolist(), rng.integers(0, 512, 5).tolist()


def _request(module, rid, prompt, streams):
    streams[rid] = []
    return module.Request(
        rid, list(prompt), max_new_tokens=NEW_TOKENS, temperature=0.0,
        emit=lambda r, token, done: streams[r].append(int(token)))


def _alone(twins):
    """The JAX package's synchronous loop serving the second request by
    itself: the reference stream."""
    jc, _, jp, _ = twins
    batcher = jb.ContinuousBatcher(jp, jc, max_slots=1, prefill_chunk=16,
                                   decode_block=1)
    streams = {}
    batcher.submit(_request(jb, "second", _prompts()[1], streams))
    batcher.run_until_drained(max_steps=200)
    return streams["second"]


@pytest.mark.parametrize("options", [dict(decode_block=1),
                                     dict(decode_block=4),
                                     dict(decode_block_tokens=8)],
                         ids=["decode_block-1", "decode_block-4",
                              "device-loop"])
def test_cancel_mid_admission_keeps_next_request_clean(twins, options):
    _, tc, _, tp = twins
    first, second = _prompts()
    batcher = tb.ContinuousBatcher(tp, tc, max_slots=1, prefill_chunk=16,
                                   device="cpu", **options)
    streams = {}
    batcher.submit(_request(tb, "first", first, streams))
    batcher.step()
    assert batcher.prefill_tokens == 16        # one of three chunks in
    assert batcher.cancel("first")
    assert 0 not in batcher._prefilling
    batcher.submit(_request(tb, "second", second, streams))
    batcher.run_until_drained(max_steps=200)
    assert streams["first"] == []
    assert streams["second"] == _alone(twins)
    assert len(streams["second"]) == NEW_TOKENS
    assert batcher.prefill_tokens == 16 + len(second)
    assert batcher.active_count == 0 and batcher.blocks_in_flight == 0
