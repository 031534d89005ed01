"""The port's TTS (``aiko_services_tpu_torch/models/tts.py``) against the
JAX package's on bridged weights: ``synthesize_mel`` in float32 and
bf16, ``vocode`` (Griffin-Lim) with the JAX package's own start phase
injected, ``synthesize``'s waveform and the loss forward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_asr import _numpy_tree

from aiko_services_tpu.models import tts as jax_tts
from aiko_services_tpu_torch.models import tts
from aiko_services_tpu_torch.models.bridge import tts_params_from_numpy

F32_TOL = 1e-4          # float32: summation order only
BF16_TOL = 2e-2         # bf16 weights and activations, relative to max
# Griffin-Lim with each package's own pseudo-inverse of the filterbank:
# two SVDs agree to ~5e-7, and the iterations carry that to ~1e-3 of
# the peak (with the JAX package's pinv injected, ~1e-6).
VOCODE_TOL = 2e-3


def _models(size="tiny", dtype="float32", seed=0):
    base = {"tiny": "tiny", "base": None}[size]
    jax_config = getattr(jax_tts.TtsConfig, base)() if base \
        else jax_tts.TtsConfig()
    jax_config = dataclasses.replace(jax_config, dtype=dtype)
    config = tts.TtsConfig(**dataclasses.asdict(jax_config))
    params = jax_tts.init_params(jax.random.PRNGKey(seed), jax_config)
    ours = tts_params_from_numpy(_numpy_tree(params), config, device="cpu")
    return jax_config, params, config, ours


def _tokens(config, *texts) -> np.ndarray:
    return np.stack([tts.encode_text(config, text) for text in texts])


def _relative_error(got: torch.Tensor, want) -> float:
    want = np.asarray(want, dtype=np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("size, dtype, tol", [
    ("tiny", "float32", F32_TOL), ("base", "float32", F32_TOL),
    ("base", "bfloat16", BF16_TOL)])
def test_synthesize_mel_matches_jax(size, dtype, tol):
    jax_config, params, config, ours = _models(size, dtype, seed=1)
    tokens = _tokens(config, "aloha", "speech path")
    want = jax_tts.synthesize_mel(params, jax_config, jnp.asarray(tokens))
    got = tts.synthesize_mel(ours, config, torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert got.shape == (2, config.n_frames, config.n_mels)
    assert _relative_error(got, want) <= tol


def _jax_phase(config, mel_shape) -> np.ndarray:
    """The JAX package's Griffin-Lim start phase for a mel batch."""
    bins = config.n_fft // 2 + 1
    return np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (mel_shape[0], mel_shape[1], bins)))


@pytest.mark.parametrize("size", ["tiny", "base"])
def test_vocode_with_injected_phase_matches_jax(size):
    jax_config, params, config, ours = _models(size, seed=2)
    tokens = _tokens(config, "hello")
    mel = np.array(jax_tts.synthesize_mel(params, jax_config,
                                          jnp.asarray(tokens)))
    want = np.asarray(jax_tts.vocode(jax_config, jnp.asarray(mel)))
    got = tts.vocode(config, torch.from_numpy(mel),
                     phase=_jax_phase(config, mel.shape))
    assert got.shape == (1, config.n_frames * config.hop)
    assert _relative_error(got, want) <= VOCODE_TOL


def test_vocode_with_jax_pinv_matches_jax_at_f32(monkeypatch):
    """With the JAX package's own pseudo-inverse in the port's constant
    cache, the only difference left is float32 summation order."""
    from aiko_services_tpu_torch.models import asr
    jax_config, params, config, ours = _models("base", seed=2)
    bank = tts._mel_filterbank_for(config)
    key = (("tts-pinv", config.sample_rate, config.n_fft, config.n_mels),
           "cpu")
    monkeypatch.setitem(asr._constants, key, torch.from_numpy(
        np.array(jnp.linalg.pinv(jnp.asarray(bank)))))
    mel = np.array(jax_tts.synthesize_mel(
        params, jax_config, jnp.asarray(_tokens(config, "hello"))))
    want = np.asarray(jax_tts.vocode(jax_config, jnp.asarray(mel)))
    got = tts.vocode(config, torch.from_numpy(mel),
                     phase=_jax_phase(config, mel.shape))
    assert _relative_error(got, want) <= 1e-5


def test_vocode_default_phase_is_the_ports_seeded_draw():
    _, _, config, ours = _models(seed=3)
    mel = tts.synthesize_mel(ours, config,
                             torch.from_numpy(_tokens(config, "abc")))
    phase = tts.start_phase((1, config.n_frames, config.n_fft // 2 + 1),
                            torch.device("cpu"))
    torch.testing.assert_close(tts.vocode(config, mel),
                               tts.vocode(config, mel, phase=phase),
                               rtol=0, atol=0)


def test_synthesize_waveform_is_host_float32_and_bounded():
    _, _, config, ours = _models(seed=4)
    waveform = tts.synthesize(ours, config, "aloha")
    assert isinstance(waveform, np.ndarray)
    assert waveform.dtype == np.float32
    assert waveform.shape == (config.n_frames * config.hop,)
    assert np.all(np.isfinite(waveform))
    assert np.max(np.abs(waveform)) <= 1.0 + 1e-5


def test_tts_loss_forward_matches_jax():
    jax_config, params, config, ours = _models(seed=5)
    tokens = _tokens(config, "aloha")
    target = np.random.default_rng(6).standard_normal(
        (1, config.n_frames, config.n_mels)).astype(np.float32)
    want = float(jax_tts.tts_loss(params, jax_config, jnp.asarray(tokens),
                                  jnp.asarray(target)))
    got = float(tts.tts_loss(ours, config, torch.from_numpy(tokens),
                             torch.from_numpy(target)))
    assert abs(got - want) <= F32_TOL * abs(want)


def test_init_params_draws_the_layout():
    config = tts.TtsConfig.tiny()
    params = tts.init_params(0, config, device="cpu")
    shapes = tts.param_shapes(config)
    assert params["layers"]["wq"].shape == shapes["layers"]["wq"]
    assert params["mel_head"].dtype == torch.bfloat16
    assert torch.all(params["final_norm"] == 1)
