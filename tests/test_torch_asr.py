"""The port's ASR (``aiko_services_tpu_torch/models/asr.py``) against the
JAX package's on the same numpy inputs and bridged weights: the log-mel
frontend and the encoder at base width, the teacher-forced decoder's
logits, the KV-cached greedy decode, :class:`StreamingAsr` hop by hop,
the loss forward, bf16 within 2e-2 -- and the twins of
``tests/test_asr_fit.py``: a tone ASR fitted by the JAX package, bridged,
transcribes held-out audio exactly in the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_asr_fit import TONES, fitted_asr, tone_chunk  # noqa: F401

from aiko_services_tpu.models import asr as jax_asr
from aiko_services_tpu_torch.models import asr
from aiko_services_tpu_torch.models.bridge import asr_params_from_numpy
from aiko_services_tpu_torch.pipeline import JitCache

F32_TOL = 1e-4          # float32 on both sides: summation order only
BF16_TOL = 2e-2         # bf16 weights and activations, relative to max


def _configs(size: str, dtype: str):
    jax_config = dataclasses.replace(getattr(jax_asr.AsrConfig, size)(),
                                     dtype=dtype)
    config = dataclasses.replace(getattr(asr.AsrConfig, size)(),
                                 dtype=dtype)
    return jax_config, config


def _numpy_tree(params) -> dict:
    def leaf(value):
        array = np.asarray(value)
        if array.dtype == jnp.bfloat16:
            return array.view(np.uint16), "bfloat16"
        return array
    return jax.tree_util.tree_map(leaf, params)


def _models(size="tiny", dtype="float32", seed=0):
    jax_config, config = _configs(size, dtype)
    params = jax_asr.init_params(jax.random.PRNGKey(seed), jax_config)
    ours = asr_params_from_numpy(_numpy_tree(params), config, device="cpu")
    return jax_config, params, config, ours


def _audio(config, rows: int, seed: int, scale=(0.1,)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    chunk = int(config.sample_rate * config.chunk_seconds)
    return np.stack([rng.standard_normal(chunk).astype(np.float32)
                     * scale[row % len(scale)] for row in range(rows)])


def _close(got: torch.Tensor, want, tol: float):
    want = np.asarray(want, dtype=np.float32)
    error = np.abs(got.float().numpy() - want).max()
    assert error <= tol * np.abs(want).max(), (error, np.abs(want).max())


def test_log_mel_matches_jax_at_base():
    """Rows of very different loudness: the 8-decade floor is one
    maximum over the whole batch, so the quiet row's floor follows the
    loud row's, as in the JAX package."""
    jax_config, config = _configs("base", "float32")
    audio = _audio(config, 2, seed=1, scale=(0.5, 1e-4))
    want = jax_asr.log_mel(jax_config, jnp.asarray(audio))
    got = asr.log_mel(config, torch.from_numpy(audio))
    assert got.shape == (2, config.n_frames, config.n_mels)
    _close(got, want, F32_TOL)


def test_encode_matches_jax_at_base():
    jax_config, params, config, ours = _models("base")
    audio = _audio(config, 1, seed=2)
    want = jax_asr.encode(params, jax_config,
                          jax_asr.log_mel(jax_config, jnp.asarray(audio)))
    got = asr.encode(ours, config, asr.log_mel(config,
                                               torch.from_numpy(audio)))
    assert got.shape == (1, config.n_audio_positions, config.dim) == \
        want.shape
    _close(got, want, F32_TOL)


def test_conv_subsampling_pads_like_xla():
    """XLA's SAME at stride 2 on an even length pads (0, 1): 1,000 ->
    500 -> 250 frames; on an odd length (1, 1)."""
    assert asr._same_padding(1000, 3, 2) == (0, 1)
    assert asr._same_padding(999, 3, 2) == (1, 1)
    assert asr._same_padding(500, 3, 1) == (1, 1)


def _jax_tokens(params, jax_config, audio) -> np.ndarray:
    return np.asarray(jax_asr.transcribe(params, jax_config,
                                         jnp.asarray(audio)))


def test_decode_states_logits_match_jax():
    jax_config, params, config, ours = _models("tiny", seed=3)
    audio = _audio(config, 2, seed=4)
    tokens = _jax_tokens(params, jax_config, audio)
    inputs = np.concatenate(
        [np.full((2, 1), config.bos_token, np.int32), tokens[:, :-1]], 1)
    encoded = jax_asr.encode(params, jax_config,
                             jax_asr.log_mel(jax_config, jnp.asarray(audio)))
    want = jax_asr._decode_states(params, jax_config, jnp.asarray(inputs),
                                  encoded)
    got = asr._decode_states(
        ours, config, torch.from_numpy(inputs),
        asr.encode(ours, config, asr.log_mel(config,
                                             torch.from_numpy(audio))))
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("seed", [0, 5])
def test_transcribe_tokens_equal_jax(seed):
    jax_config, params, config, ours = _models("tiny", seed=seed)
    audio = _audio(config, 3, seed=seed + 10)
    want = _jax_tokens(params, jax_config, audio)
    got = asr.transcribe(ours, config, torch.from_numpy(audio))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert [asr.decode_text(config, row) for row in got.numpy()] == \
        [jax_asr.decode_text(jax_config, row) for row in want]


def test_asr_loss_forward_matches_jax():
    jax_config, params, config, ours = _models("tiny", seed=6)
    audio = _audio(config, 2, seed=7)
    targets = np.full((2, config.max_text), 259, dtype=np.int32)
    for row, text in enumerate(("hi", "aloha")):
        ids = jax_asr.encode_text(jax_config, text) + [config.eos_token]
        targets[row, :len(ids)] = ids
    want = float(jax_asr.asr_loss(params, jax_config, jnp.asarray(audio),
                                  jnp.asarray(targets)))
    got = float(asr.asr_loss(ours, config, torch.from_numpy(audio),
                             torch.from_numpy(targets)))
    assert abs(got - want) <= F32_TOL * abs(want)


def test_bf16_encode_and_logits_within_tolerance():
    jax_config, params, config, ours = _models("base", dtype="bfloat16",
                                               seed=8)
    audio = _audio(config, 1, seed=9)
    encoded = jax_asr.encode(params, jax_config,
                             jax_asr.log_mel(jax_config, jnp.asarray(audio)))
    ours_encoded = asr.encode(ours, config,
                              asr.log_mel(config, torch.from_numpy(audio)))
    assert ours_encoded.dtype == torch.bfloat16
    _close(ours_encoded, encoded.astype(jnp.float32), BF16_TOL)
    inputs = np.array([[config.bos_token, 104, 105, 33]], dtype=np.int32)
    want = jax_asr._decode_states(params, jax_config, jnp.asarray(inputs),
                                  encoded)
    got = asr._decode_states(ours, config, torch.from_numpy(inputs),
                             ours_encoded)
    _close(got, want.astype(jnp.float32), BF16_TOL)


def _stream_trace(streamer, pushes) -> list:
    trace = []
    for samples in pushes:
        trace.append((streamer.push(samples), streamer.partial_text,
                      streamer.stable_text, streamer.chunks_transcribed,
                      streamer.partial_decodes))
    trace.append((streamer.flush(), streamer.partial_text,
                  streamer.stable_text, streamer.chunks_transcribed,
                  streamer.partial_decodes))
    return trace


def test_streaming_matches_jax_hop_by_hop():
    """Returns, ``partial_text``, ``stable_text`` and both counters after
    every push: hop partials, an energy endpoint, a chunk fill, the
    flush of a tail."""
    jax_config, params, config, ours = _models("tiny", seed=11)
    rate = config.sample_rate
    rng = np.random.default_rng(12)
    hop = rate // 4
    speech = [(rng.standard_normal(hop) * 0.3).astype(np.float32)
              for _ in range(8)]
    silence = np.zeros(hop, dtype=np.float32)
    pushes = [speech[0], speech[1], silence, speech[2], speech[3],
              speech[4], speech[5], speech[6], speech[7][:1000]]
    kwargs = dict(hop_seconds=0.25, endpoint_silence=0.25)
    want = _stream_trace(jax_asr.StreamingAsr(params, jax_config, **kwargs),
                         pushes)
    got = _stream_trace(asr.StreamingAsr(ours, config, **kwargs), pushes)
    assert got == want
    assert want[2][3] == 1 and want[-1][3] >= 2    # endpoint, then chunks


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asr.init_params(0, asr.AsrConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asr_params_from_numpy({}, asr.AsrConfig.tiny())


# -- twins of tests/test_asr_fit.py: the JAX package's fitted tone ASR -------

@pytest.fixture(scope="module")
def fitted_port(fitted_asr):  # noqa: F811
    jax_config, params = fitted_asr
    config = asr.AsrConfig(**dataclasses.asdict(jax_config))
    return jax_config, params, config, asr_params_from_numpy(
        _numpy_tree(params), config, device="cpu")


def test_fitted_asr_transcribes_heldout_exactly(fitted_port):
    jax_config, params, config, ours = fitted_port
    rng = np.random.default_rng(12345)          # unseen draws
    letters = ["c", "a", "d", "b", "a"]
    audio = np.stack([tone_chunk(config, TONES[letter], rng)
                      for letter in letters])
    tokens = asr.transcribe(ours, config, torch.from_numpy(audio)).numpy()
    assert [asr.decode_text(config, row) for row in tokens] == letters
    np.testing.assert_array_equal(tokens,
                                  _jax_tokens(params, jax_config, audio))


def test_cached_decode_consistent_with_teacher_forcing(fitted_port):
    _, _, config, ours = fitted_port
    rng = np.random.default_rng(99)
    audio = torch.from_numpy(tone_chunk(config, TONES["b"], rng)[None])
    tokens = asr.transcribe(ours, config, audio).numpy()[0]
    encoded = asr.encode(ours, config, asr.log_mel(config, audio))
    inputs = torch.from_numpy(
        np.concatenate([[config.bos_token], tokens[:-1]])[None])
    rechecked = asr._decode_states(ours, config, inputs,
                                   encoded)[0].argmax(-1).numpy()
    for position, token in enumerate(tokens):
        assert rechecked[position] == token, f"divergence at {position}"
        if token == config.eos_token:
            break


def test_streaming_transcription(fitted_port):
    """Chunk boundaries emit text; every chunk is one call of the one
    cached transcriber (no new signature as the stream runs)."""
    _, _, config, ours = fitted_port
    rng = np.random.default_rng(31)
    cache = JitCache()
    streamer = asr.StreamingAsr(
        ours, config, transcribe_fn=asr.transcriber(ours, config, cache))
    audio = np.concatenate([tone_chunk(config, TONES[letter], rng)
                            for letter in ["a", "d", "c"]])
    text = ""
    for piece in np.array_split(audio, 10):
        text += streamer.push(piece)
    text += streamer.flush()
    assert text == "adc"
    assert streamer.chunks_transcribed == 3
    entries, calls = cache.entries, cache.hits + cache.misses
    assert streamer.push(tone_chunk(config, TONES["b"], rng)) == "b"
    assert cache.entries == entries == 1
    assert cache.hits + cache.misses == calls + 1


def test_subchunk_streaming_partial_latency(fitted_port):
    _, _, config, ours = fitted_port
    rng = np.random.default_rng(41)
    streamer = asr.StreamingAsr(ours, config,
                                hop_seconds=config.chunk_seconds / 4)
    chunk_audio = tone_chunk(config, TONES["a"], rng)
    reference = asr.decode_text(config, asr.transcribe(
        ours, config, torch.from_numpy(chunk_audio[None])).numpy()[0])
    pieces = np.array_split(chunk_audio, 4)
    final = streamer.push(pieces[0])
    assert final == "" and streamer.partial_decodes >= 1
    first_partial = streamer.partial_text
    final += streamer.push(pieces[1])
    if streamer.partial_text == first_partial:
        assert streamer.stable_text == first_partial
    final += streamer.push(pieces[2])
    final += streamer.push(pieces[3])
    assert final == reference
    assert streamer.partial_text == ""


def test_streaming_endpoint_finalizes_early(fitted_port):
    _, _, config, ours = fitted_port
    rng = np.random.default_rng(43)
    chunk = int(config.sample_rate * config.chunk_seconds)
    streamer = asr.StreamingAsr(ours, config, endpoint_silence=0.1,
                                endpoint_threshold=0.05)
    speech = tone_chunk(config, TONES["b"], rng)[:int(chunk * 0.4)]
    silence = np.zeros(int(chunk * 0.15), dtype=np.float32)
    assert streamer.push(speech) == ""
    text = streamer.push(silence)
    reference = asr.decode_text(config, asr.transcribe(
        ours, config, torch.from_numpy(asr.pad_audio(
            config, np.concatenate([speech, silence]))[None])).numpy()[0])
    assert text == reference and text != ""
    assert len(streamer._pending) == 0
    assert streamer.push(np.zeros(chunk // 2, np.float32)) == ""
