"""The speech models' training objectives on the port: ``asr_loss`` and
``tts_loss`` gradients against ``jax.grad`` on the same (bridged)
weights in float32 -- each leaf within 1e-4 of its largest gradient --
the twins of ``test_speech.py``'s three-SGD-step tests, and
``test_asr_fit.py``'s tone fit run in the port itself with
``torch.optim.Adam(3e-3)``: the fitted port ASR transcribes held-out
tones exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_asr_fit import TONES, tone_chunk

from aiko_services_tpu.models import asr as jax_asr
from aiko_services_tpu.models import tts as jax_tts
from aiko_services_tpu_torch.models import asr, tts
from aiko_services_tpu_torch.models.bridge import (asr_params_from_numpy,
                                                   tts_params_from_numpy)
from aiko_services_tpu_torch.models.checkpoint import flatten

GRAD_TOL = 1e-4         # float32 gradients, relative to each leaf's max
LOSS_TOL = 1e-5


def leaves(params: dict) -> list[torch.Tensor]:
    return list(flatten(params).values())


def jax_grads(grads, permute=None) -> dict:
    """JAX gradient tree -> {"a.b": numpy} in the port's layout."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        name = ".".join(str(key.key) for key in path)
        value = np.asarray(leaf)
        if permute and name.split(".")[-1] in permute:
            value = value.transpose(permute[name.split(".")[-1]])
        out[name] = value
    return out


def port_grads(loss_fn, params: dict):
    names = list(flatten(params))
    tensors = leaves(params)
    for tensor in tensors:
        tensor.requires_grad_(True)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, tensors)
    return float(loss.detach()), dict(zip(names, grads))


def assert_grads_close(ours: dict, theirs: dict):
    assert set(ours) == set(theirs)
    for name, grad in ours.items():
        want = theirs[name]
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(grad.numpy() - want).max() <= GRAD_TOL * scale, name


def asr_models(dtype="float32"):
    jax_config = dataclasses.replace(jax_asr.AsrConfig.tiny(), dtype=dtype)
    config = dataclasses.replace(asr.AsrConfig.tiny(), dtype=dtype)
    params = jax_asr.init_params(jax.random.PRNGKey(0), jax_config)
    ours = asr_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 config, device="cpu")
    return jax_config, params, config, ours


def asr_batch(config, rows=2, seed=1):
    rng = np.random.default_rng(seed)
    chunk = int(config.sample_rate * config.chunk_seconds)
    audio = (rng.standard_normal((rows, chunk)) * 0.1).astype(np.float32)
    targets = np.full((rows, config.max_text), 259, dtype=np.int32)
    for row, text in enumerate(["hi", "abc"][:rows]):
        ids = asr.encode_text(config, text) + [config.eos_token]
        targets[row, :len(ids)] = ids
    return audio, targets


def test_asr_loss_grads_match_jax():
    jax_config, params, config, ours = asr_models()
    audio, targets = asr_batch(config)
    want_loss, want = jax.value_and_grad(jax_asr.asr_loss)(
        params, jax_config, jnp.asarray(audio), jnp.asarray(targets))
    loss, grads = port_grads(
        lambda p: asr.asr_loss(p, config, torch.from_numpy(audio),
                               torch.from_numpy(targets)), ours)
    assert abs(loss - float(want_loss)) <= LOSS_TOL
    assert_grads_close(grads, jax_grads(want, permute={"w": (2, 1, 0)}))


def tts_models():
    jax_config = dataclasses.replace(jax_tts.TtsConfig.tiny(),
                                     dtype="float32")
    config = dataclasses.replace(tts.TtsConfig.tiny(), dtype="float32")
    params = jax_tts.init_params(jax.random.PRNGKey(0), jax_config)
    ours = tts_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 config, device="cpu")
    return jax_config, params, config, ours


def test_tts_loss_grads_match_jax():
    jax_config, params, config, ours = tts_models()
    tokens = np.stack([tts.encode_text(config, text)
                       for text in ("aloha", "hi")])
    target = np.random.default_rng(2).standard_normal(
        (2, config.n_frames, config.n_mels)).astype(np.float32)
    want_loss, want = jax.value_and_grad(jax_tts.tts_loss)(
        params, jax_config, jnp.asarray(tokens), jnp.asarray(target))
    loss, grads = port_grads(
        lambda p: tts.tts_loss(p, config, torch.from_numpy(tokens),
                               torch.from_numpy(target)), ours)
    assert abs(loss - float(want_loss)) <= LOSS_TOL
    assert_grads_close(grads, jax_grads(want))


def sgd_losses(loss_fn, params: dict, steps=3, rate=0.1) -> list[float]:
    """Three plain SGD steps, as the JAX package's tests take them."""
    tensors = leaves(params)
    for tensor in tensors:
        tensor.requires_grad_(True)
    losses = []
    for _ in range(steps):
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, tensors)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for tensor, grad in zip(tensors, grads):
                tensor.sub_(rate * grad.to(tensor.dtype))
    return losses


def test_asr_loss_decreases_under_training():
    """Twin of ``test_speech.py::test_asr_loss_decreases_under_training``
    (the tiny config in its own dtype, one (audio, "hi") pair)."""
    config = asr.AsrConfig.tiny()
    params = asr.init_params(0, config, device="cpu")
    audio, targets = asr_batch(config, rows=1)
    losses = sgd_losses(lambda p: asr.asr_loss(
        p, config, torch.from_numpy(audio), torch.from_numpy(targets)),
        params)
    assert losses[-1] < losses[0]


def test_tts_loss_decreases_under_training():
    """Twin of ``test_speech.py::test_tts_loss_decreases_under_training``."""
    config = tts.TtsConfig.tiny()
    params = tts.init_params(0, config, device="cpu")
    tokens = torch.from_numpy(tts.encode_text(config, "aloha"))[None]
    target = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, config.n_frames, config.n_mels)).astype(np.float32))
    losses = sgd_losses(lambda p: tts.tts_loss(p, config, tokens, target),
                        params)
    assert losses[-1] < losses[0]


# -- test_asr_fit.py's fit, in the port ---------------------------------------

def tone_targets(config, letters) -> torch.Tensor:
    rows = np.full((len(letters), config.max_text), 259, dtype=np.int32)
    for row, letter in enumerate(letters):
        ids = asr.encode_text(config, letter) + [config.eos_token]
        rows[row, :len(ids)] = ids
    return torch.from_numpy(rows)


def decoded(config, params, audio: torch.Tensor) -> list[str]:
    with torch.no_grad():
        tokens = asr.transcribe(params, config, audio)
    return [asr.decode_text(config, row) for row in tokens.numpy()]


@pytest.fixture(scope="module")
def port_fitted_asr():
    """The tone ASR fitted by the port (float32, ``torch.optim.Adam`` at
    3e-3, fresh phase and noise every step from numpy seed 7) until it
    is exact on its training draws, within test_asr_fit.py's 400
    steps."""
    config = dataclasses.replace(asr.AsrConfig.tiny(), dtype="float32")
    params = asr.init_params(0, config, device="cpu")
    tensors = leaves(params)
    for tensor in tensors:
        tensor.requires_grad_(True)
    optimizer = torch.optim.Adam(tensors, lr=3e-3)
    rng = np.random.default_rng(7)
    letters = list(TONES)
    targets = tone_targets(config, letters)

    def batch():
        return torch.from_numpy(np.stack(
            [tone_chunk(config, TONES[letter], rng) for letter in letters]))

    loss = None
    for step in range(400):
        loss = asr.asr_loss(params, config, batch(), targets)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if step % 25 == 24 and decoded(config, params, batch()) == letters:
            break
    else:
        pytest.fail(f"the port's tone ASR did not converge "
                    f"(loss {float(loss)})")
    for tensor in tensors:
        tensor.requires_grad_(False)
    return config, params


def test_port_fitted_asr_transcribes_heldout_exactly(port_fitted_asr):
    config, params = port_fitted_asr
    rng = np.random.default_rng(12345)          # unseen draws
    letters = ["c", "a", "d", "b", "a"]
    audio = torch.from_numpy(np.stack(
        [tone_chunk(config, TONES[letter], rng) for letter in letters]))
    assert decoded(config, params, audio) == letters
