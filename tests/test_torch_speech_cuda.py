"""The port's speech path on the card: ``transcribe`` captured as one CUDA
graph (``models/asr.py`` ``transcriber``) against the eager call, and
:class:`StreamingAsr` under the process-wide sync guard.  Imports no
JAX, so it runs on the card machine:

    python3 -m pytest --noconftest -q tests/test_torch_speech_cuda.py

Without a card every test here skips."""

import dataclasses

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.device import sync_guard
from aiko_services_tpu_torch.models import asr, tts
from aiko_services_tpu_torch.pipeline import JitCache


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graph capture has no CPU mode)")
    return torch.device("cuda", 0)


def _audio(config, rows: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    chunk = int(config.sample_rate * config.chunk_seconds)
    return torch.from_numpy((rng.standard_normal((rows, chunk)) * 0.3)
                            .astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transcribe_capture_equals_eager(cuda_device, dtype):
    """A captured replay gives the eager call's token ids exactly, for
    each batch shape its own graph; replays of new inputs reuse it."""
    config = dataclasses.replace(asr.AsrConfig.tiny(), dtype=dtype)
    params = asr.init_params(0, config, cuda_device)
    cache = JitCache()
    captured = asr.transcriber(params, config, cache)
    for rows, seed in ((1, 0), (1, 1), (4, 2)):
        audio = _audio(config, rows, seed).to(cuda_device)
        torch.testing.assert_close(captured(audio),
                                   asr.transcribe(params, config, audio),
                                   rtol=0, atol=0)
    assert cache.entries == 2 and cache.misses == 2 and cache.hits == 1
    assert cache.capture_s > 0


@pytest.mark.cuda
def test_streaming_asr_runs_under_the_error_guard(cuda_device):
    """Push and flush enqueue no implicit wait: under the ``error``
    guard only the capture and the one planned token fetch a decode run
    (both lift it), and push/flush joined equal the whole window."""
    config = asr.AsrConfig.tiny()
    params = asr.init_params(0, config, cuda_device)
    streamer = asr.StreamingAsr(params, config, hop_seconds=0.25,
                                endpoint_silence=0.25)
    audio = _audio(config, 1, 3)[0].numpy()[:12000]
    with sync_guard("error"):
        text = ""
        for piece in np.array_split(audio, 3):
            text += streamer.push(piece)
        text += streamer.flush()
    whole = asr.transcribe(params, config, asr.upload(
        asr.pad_audio(config, audio)[None], cuda_device))
    assert text == asr.decode_text(config, whole[0].cpu().numpy())
    assert streamer.partial_decodes == 3
    assert streamer.chunks_transcribed == 1


@pytest.mark.cuda
def test_synthesize_on_the_card(cuda_device):
    config = tts.TtsConfig.tiny()
    params = tts.init_params(0, config, cuda_device)
    waveform = tts.synthesize(params, config, "aloha")
    assert waveform.shape == (config.n_frames * config.hop,)
    assert np.all(np.isfinite(waveform))
    assert abs(np.abs(waveform).max() - 1.0) <= 1e-5
