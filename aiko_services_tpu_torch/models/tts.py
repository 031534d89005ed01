"""Text-to-speech on PyTorch.

Counterpart of ``aiko_services_tpu/models/tts.py``: the same
FastSpeech-flavoured, fully parallel model (byte embedding + sinusoidal
positions, pre-norm transformer layers, a static length regulator of
``frames_per_char``, a linear mel head) and the same Griffin-Lim vocoder
with a fixed iteration count.  The JAX package runs them as XLA ops (no
Pallas kernel); here they are plain tensor ops.  What keeps the answers
equal:

- ``jnp.repeat`` is ``repeat_interleave``;
- the mel filterbank's pseudo-inverse is a host constant (numpy's
  float32 ``pinv``: another SVD than XLA's, equal to 5e-7, which 16
  Griffin-Lim iterations carry to ~1e-3 of the waveform's peak);
- the overlap-add (``.at[:, index].add``) is ``F.fold``, which sums each
  output sample in a fixed order (``index_add_`` would add by atomics);
- the inverse FFT zeroes the imaginary parts of the DC and Nyquist bins
  before ``irfft``, which every backend then reads the same way;
- Griffin-Lim's start phase, ``jax.random.uniform(PRNGKey(0))`` in the
  JAX package, is drawn from a ``torch.Generator`` seeded 0 on the mel's
  device; :func:`vocode` also takes a start phase, so a caller can
  inject the JAX package's draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device, sync_allowed
from ..ops.layers import rms_norm, swiglu
from .asr import (_DTYPES, _attention, _fan_in, _layer, _mel_filterbank,
                  device_constant, hann_window, sinusoid)

__all__ = ["TtsConfig", "init_params", "abstract_params", "param_shapes",
           "encode_text", "synthesize_mel", "vocode", "synthesize", "tts_loss"]


@dataclasses.dataclass(frozen=True)
class TtsConfig:
    sample_rate: int = 16_000
    n_fft: int = 400
    hop: int = 160
    n_mels: int = 80
    vocab_size: int = 256          # bytes
    max_chars: int = 128           # static text budget
    frames_per_char: int = 6       # static length regulator
    dim: int = 256
    n_heads: int = 4
    n_layers: int = 4
    hidden_dim: int = 1024
    griffin_lim_iters: int = 16
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def n_frames(self) -> int:
        return self.max_chars * self.frames_per_char

    @classmethod
    def tiny(cls) -> "TtsConfig":
        return cls(n_mels=16, max_chars=16, frames_per_char=2, dim=32,
                   n_heads=2, n_layers=2, hidden_dim=64,
                   griffin_lim_iters=2)


def _dtype(config) -> torch.dtype:
    if config.dtype not in _DTYPES:
        raise ValueError(f"dtype {config.dtype!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[config.dtype]


def param_shapes(config: TtsConfig) -> dict:
    """The parameter tree's layout, the JAX package's own (no leaf
    changes layout: ``x @ w`` reads [in, out] weights the same way)."""
    c = config
    n = c.n_layers
    proj = c.n_heads * (c.dim // c.n_heads)
    return {
        "embed": (c.vocab_size, c.dim),
        "layers": {
            "wq": (n, c.dim, proj), "wk": (n, c.dim, proj),
            "wv": (n, c.dim, proj), "wo": (n, proj, c.dim),
            "w_gate": (n, c.dim, c.hidden_dim),
            "w_up": (n, c.dim, c.hidden_dim),
            "w_down": (n, c.hidden_dim, c.dim),
            "attn_norm": (n, c.dim), "mlp_norm": (n, c.dim),
        },
        "final_norm": (c.dim,),
        "mel_head": (c.dim, c.n_mels),
    }


def abstract_params(config: TtsConfig) -> dict:
    """The parameter tree as meta tensors: its shapes and dtype, no
    storage and nothing drawn (a checkpoint restore's template)."""
    dtype = _dtype(config)

    def meta(layout: dict) -> dict:
        return {name: meta(shape) if isinstance(shape, dict)
                else torch.empty(shape, dtype=dtype, device="meta")
                for name, shape in layout.items()}

    return meta(param_shapes(config))


def init_params(seed: int, config: TtsConfig,
                device: str | torch.device | None = None) -> dict:
    """Random weights at the JAX package's scaling (standard normal x
    fan_in^-0.5, unit norms), drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the card unless "cpu" is asked for), in
    the config's dtype."""
    device = resolve_device(device)
    dtype = _dtype(config)
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def draw(layout: dict) -> dict:
        out = {}
        for name, shape in layout.items():
            if isinstance(shape, dict):
                out[name] = draw(shape)
            elif name.endswith("norm"):
                out[name] = torch.ones(shape, dtype=dtype, device=device)
            else:
                weight = torch.randn(shape, generator=generator,
                                     device=device, dtype=torch.float32)
                out[name] = (weight * _fan_in(name, shape) ** -0.5).to(dtype)
        return out

    return draw(param_shapes(config))


def encode_text(config: TtsConfig, text: str) -> np.ndarray:
    """Text -> fixed [max_chars] byte ids, zero-padded."""
    data = list(text.encode("utf-8"))[:config.max_chars]
    out = np.zeros((config.max_chars,), dtype=np.int32)
    out[:len(data)] = data
    return out


def synthesize_mel(params: dict, config: TtsConfig,
                   tokens: torch.Tensor) -> torch.Tensor:
    """byte ids [B, max_chars] -> mel [B, n_frames, n_mels] float32."""
    c = config
    hidden = params["embed"][tokens.long()]
    hidden = hidden + sinusoid(c.max_chars, c.dim,
                               hidden.device)[None].to(hidden.dtype)
    for index in range(c.n_layers):
        layer = _layer(params["layers"], index)
        h = rms_norm(hidden, layer["attn_norm"], c.norm_eps)
        attn = _attention(h @ layer["wq"], h @ layer["wk"],
                          h @ layer["wv"], c.n_heads, causal=False)
        hidden = hidden + attn @ layer["wo"]
        h = rms_norm(hidden, layer["mlp_norm"], c.norm_eps)
        hidden = hidden + swiglu(h, layer["w_gate"], layer["w_up"],
                                 layer["w_down"])
    hidden = rms_norm(hidden, params["final_norm"], c.norm_eps)
    # Static length regulator: each char -> frames_per_char mel frames.
    hidden = hidden.repeat_interleave(c.frames_per_char, dim=1)
    hidden = hidden + sinusoid(c.n_frames, c.dim,
                               hidden.device)[None].to(hidden.dtype)
    return (hidden @ params["mel_head"]).float()


def _mel_filterbank_for(config: TtsConfig) -> np.ndarray:
    proxy = dataclasses.make_dataclass(
        "MelProxy", ["sample_rate", "n_fft", "n_mels"])(
        config.sample_rate, config.n_fft, config.n_mels)
    return _mel_filterbank(proxy)


def _irfft(spec: torch.Tensor, n: int) -> torch.Tensor:
    """``irfft`` of a half spectrum whose DC and Nyquist bins may carry
    an imaginary part: zeroed first, as numpy's and JAX's inverse
    transforms ignore it."""
    bins = spec.shape[-1]

    def build():
        keep = np.ones((bins,), dtype=np.float32)
        keep[0] = 0.0
        if n % 2 == 0:
            keep[-1] = 0.0
        return keep
    keep = device_constant(("irfft-keep", bins, n), spec.device, build)
    return torch.fft.irfft(torch.complex(spec.real, spec.imag * keep), n=n,
                           dim=-1)


def start_phase(shape: tuple, device: torch.device) -> torch.Tensor:
    """Griffin-Lim's start phase: uniform [0, 1) draws of ``shape`` from
    a ``torch.Generator`` seeded 0 on ``device``."""
    generator = torch.Generator(device=device).manual_seed(0)
    return torch.rand(shape, generator=generator, device=device)


def vocode(config: TtsConfig, mel: torch.Tensor,
           phase: torch.Tensor | np.ndarray | None = None) -> torch.Tensor:
    """Griffin-Lim: mel [B, F, n_mels] -> waveform [B, F * hop].

    Inverts the mel filterbank by its pseudo-inverse, then runs a fixed
    number of magnitude-consistent phase-recovery iterations with
    rfft/irfft.  ``phase``: the start phase as uniform [0, 1) draws of
    [B, F, n_fft // 2 + 1] (default :func:`start_phase`)."""
    c = config
    device = mel.device
    frames = mel.shape[1]
    key = ("tts-pinv", c.sample_rate, c.n_fft, c.n_mels)
    inverse = device_constant(key, device, lambda: np.linalg.pinv(
        _mel_filterbank_for(c)))
    # Clamp to the normalized log-mel range (asr.log_mel maps into
    # roughly [-1, 1]): unfitted weights can emit values whose
    # exponentiation overflows float32 and NaNs Griffin-Lim.
    mel = torch.clamp(mel.float(), -4.0, 4.0)
    power = torch.clamp(10.0 ** (mel * 4.0 - 4.0), min=1e-10)
    # pinv(bank) has negative entries, so the reconstructed power can
    # dip below zero -- clamp BEFORE the sqrt or it NaNs.
    magnitude = torch.sqrt(torch.clamp(power @ inverse, min=0.0))

    window = hann_window(c.n_fft, device)
    pad = c.n_fft // 2
    length = frames * c.hop
    span = (frames - 1) * c.hop + c.n_fft            # the frames' reach
    norm = F.fold((window ** 2)[None, :, None].expand(1, -1, frames),
                  (1, span), (1, c.n_fft), stride=(1, c.hop))[:, 0, 0]

    def stft(x):
        padded = F.pad(x, (pad, pad))
        stacked = padded.unfold(-1, c.n_fft, c.hop)[:, :frames]
        return torch.fft.rfft(stacked * window, dim=-1)

    def istft(spec):
        pieces = _irfft(spec, c.n_fft) * window      # [B, F, n_fft]
        out = F.fold(pieces.transpose(1, 2), (1, span), (1, c.n_fft),
                     stride=(1, c.hop))[:, 0, 0]
        out = out / torch.clamp(norm, min=1e-8)
        # The JAX package's buffer runs ``hop`` past the last frame's
        # reach; the tail it keeps there is zeros.
        out = F.pad(out, (0, max(0, pad + length - span)))
        return out[:, pad:pad + length]

    if phase is None:
        phase = start_phase(tuple(magnitude.shape), device)
    elif isinstance(phase, np.ndarray):
        phase = torch.from_numpy(np.array(phase, dtype=np.float32)) \
            .to(device)
    waveform = istft(magnitude * torch.exp(2j * torch.pi * phase.float()))
    for _ in range(c.griffin_lim_iters):
        spec = stft(waveform)
        waveform = istft(magnitude * (spec / torch.clamp(spec.abs(),
                                                         min=1e-8)))
    peak = waveform.abs().amax(dim=-1, keepdim=True)
    return waveform / torch.clamp(peak, min=1e-8)


def synthesize(params: dict, config: TtsConfig, text: str) -> np.ndarray:
    """Convenience: text -> mono float32 waveform (numpy, host): the
    tokens go up once, the waveform comes back in one planned wait."""
    device = params["embed"].device
    tokens = torch.from_numpy(encode_text(config, text))[None]
    if device.type == "cuda":
        tokens = tokens.pin_memory()
    tokens = tokens.to(device, non_blocking=True)
    waveform = vocode(config, synthesize_mel(params, config, tokens))[0]
    with sync_allowed():
        return waveform.cpu().numpy().astype(np.float32)


def tts_loss(params: dict, config: TtsConfig, tokens: torch.Tensor,
             mel_target: torch.Tensor) -> torch.Tensor:
    """L1 mel regression -- the JAX package's fitting objective for
    (text, mel) pairs, differentiable as ``asr_loss`` is."""
    mel = synthesize_mel(params, config, tokens)
    return (mel - mel_target.to(mel.dtype)).abs().mean()
