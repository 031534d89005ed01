"""Speech recognition on PyTorch (BASELINE config 5).

Counterpart of ``aiko_services_tpu/models/asr.py``: the same
Whisper-class encoder-decoder (a log-mel frontend, two strided 1-D
convolutions, bidirectional encoder layers, a byte-level decoder with
causal self-attention and cross-attention, RMSNorm + SwiGLU blocks), the
same KV-cached greedy decode with a static token budget, and
:class:`StreamingAsr`, the incremental live transcriber.  The JAX package
runs all of it as XLA ops (no Pallas kernel); here it is plain tensor
ops, written so that :func:`transcribe` enqueues with no host
synchronisation and is captured whole as one CUDA graph a batch shape
(:func:`transcriber`, ``pipeline/tensor.py`` ``JitCache``).  What keeps
the two packages' answers equal:

- the log-mel frontend: numpy's symmetric Hann window, reflect padding,
  and ONE maximum over the whole batch for the 8-decade floor (rows are
  coupled, as in the JAX package);
- the convolutions: XLA's SAME padding, (0, 1) at stride 2 on an even
  length (1,000 -> 500 -> 250 frames), applied by ``F.pad``; weights
  [out, in, width] (the JAX package's WIO, permuted by
  ``models/bridge.py``); the tanh-approximated GELU of ``jax.nn.gelu``;
- attention: logits and softmax in float32, the weights cast to the
  values' dtype before the product;
- the decode: 128 static steps (end of sequence masked, never a break),
  step i's k/v written into the cache by slice assignment, ``argmax``
  taking the first maximum as ``jnp.argmax`` does;
- constants (window, filterbank, position tables) built on the host in
  numpy exactly as the JAX package builds them, uploaded once a device
  through pinned memory and kept, so no upload happens inside a capture.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device, sync_allowed
from ..ops.layers import attention_decode_append, rms_norm, swiglu

__all__ = ["AsrConfig", "init_params", "abstract_params", "param_shapes",
           "log_mel", "pad_audio", "encode", "transcribe", "transcriber",
           "decode_text", "encode_text", "asr_loss", "StreamingAsr"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AsrConfig:
    # audio frontend
    sample_rate: int = 16_000
    chunk_seconds: float = 10.0
    n_fft: int = 400              # 25 ms window
    hop: int = 160                # 10 ms hop
    n_mels: int = 80
    # model
    vocab_size: int = 260         # bytes + BOS/EOS/PAD specials
    dim: int = 384
    n_heads: int = 6
    n_encoder_layers: int = 4
    n_decoder_layers: int = 4
    hidden_dim: int = 1536
    max_text: int = 128           # static decode budget (tokens)
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    bos_token: int = 257
    eos_token: int = 258

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def n_frames(self) -> int:
        """Mel frames per chunk (before conv subsampling)."""
        return int(self.sample_rate * self.chunk_seconds) // self.hop

    @property
    def n_audio_positions(self) -> int:
        return self.n_frames // 4    # two stride-2 convs

    @classmethod
    def base(cls) -> "AsrConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "AsrConfig":
        """Test-size: milliseconds on a CPU mesh."""
        return cls(chunk_seconds=1.0, n_mels=16, dim=32, n_heads=2,
                   n_encoder_layers=2, n_decoder_layers=2, hidden_dim=64,
                   max_text=16)


def _dtype(config) -> torch.dtype:
    if config.dtype not in _DTYPES:
        raise ValueError(f"dtype {config.dtype!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[config.dtype]


# ---------------------------------------------------------------------------
# Host-built constants, one upload a device.

_constants: dict = {}
_constants_lock = threading.Lock()


def device_constant(key: tuple, device: torch.device, build) -> torch.Tensor:
    """The numpy array ``build()`` on ``device``, made once a (key,
    device) and kept.  On the card it goes up through pinned memory: a
    pageable upload waits for the card (and trips a sync guard), and no
    upload may happen inside a graph capture -- the capture's warm-up
    call makes every constant first."""
    cache_key = (key, str(device))
    with _constants_lock:
        tensor = _constants.get(cache_key)
        if tensor is None:
            host = torch.from_numpy(np.ascontiguousarray(build()))
            if device.type == "cuda":
                host = host.pin_memory()
            tensor = _constants[cache_key] = host.to(device,
                                                     non_blocking=True)
    return tensor


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host float32 array on ``device`` (pinned memory on the card)."""
    host = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


# ---------------------------------------------------------------------------
# Log-mel frontend (static shapes, on-device).

def _mel_filterbank(config: AsrConfig) -> np.ndarray:
    """[n_fft//2+1, n_mels] triangular filters (host-side constant)."""
    n_bins = config.n_fft // 2 + 1
    f_max = config.sample_rate / 2

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_points = np.linspace(0.0, hz_to_mel(f_max), config.n_mels + 2)
    hz_points = mel_to_hz(mel_points)
    bins = np.floor((config.n_fft + 1) * hz_points
                    / config.sample_rate).astype(int)
    bank = np.zeros((n_bins, config.n_mels), dtype=np.float32)
    for m in range(1, config.n_mels + 1):
        left, centre, right = bins[m - 1], bins[m], bins[m + 1]
        for k in range(left, centre):
            if centre > left:
                bank[k, m - 1] = (k - left) / (centre - left)
        for k in range(centre, right):
            if right > centre:
                bank[k, m - 1] = (right - k) / (right - centre)
    return bank


def hann_window(n_fft: int, device: torch.device) -> torch.Tensor:
    """numpy's symmetric Hann window (``np.hanning``), float32."""
    return device_constant(("hann", n_fft), device,
                           lambda: np.hanning(n_fft).astype(np.float32))


def mel_filterbank(config, device: torch.device) -> torch.Tensor:
    key = ("mel", config.sample_rate, config.n_fft, config.n_mels)
    return device_constant(key, device, lambda: _mel_filterbank(config))


def log_mel(config: AsrConfig, samples: torch.Tensor) -> torch.Tensor:
    """waveform [B, T] float32 (T = chunk worth of samples, pre-padded)
    -> log-mel [B, n_frames, n_mels]."""
    device = samples.device
    pad = config.n_fft // 2
    padded = F.pad(samples.float()[:, None, :], (pad, pad),
                   mode="reflect")[:, 0]
    # Strided frames: [B, n_frames, n_fft].
    stacked = padded.unfold(-1, config.n_fft, config.hop)[:, :config.n_frames]
    spectrum = torch.fft.rfft(stacked * hann_window(config.n_fft, device),
                              dim=-1)
    power = spectrum.abs() ** 2                     # [B, F, bins]
    mel = power @ mel_filterbank(config, device)    # [B, F, n_mels]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    # One maximum over the whole batch, as the JAX package takes it.
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_audio(config: AsrConfig, samples: np.ndarray) -> np.ndarray:
    """Right-pad/trim a mono waveform to exactly one chunk."""
    want = int(config.sample_rate * config.chunk_seconds)
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)[:want]
    if len(samples) < want:
        samples = np.pad(samples, (0, want - len(samples)))
    return samples


# ---------------------------------------------------------------------------
# Parameters.

def param_shapes(config: AsrConfig) -> dict:
    """The parameter tree's layout in the JAX package's key order, a
    leaf's shape as the port holds it: layer weights [L, in, out] (the
    JAX package's, since ``x @ w`` reads them the same way), conv
    weights [out, in, width] (``F.conv1d``'s; the JAX package's are
    WIO)."""
    c = config
    proj = c.n_heads * c.head_dim

    def layer_stack(n, with_cross: bool):
        stack = {
            "wq": (n, c.dim, proj), "wk": (n, c.dim, proj),
            "wv": (n, c.dim, proj), "wo": (n, proj, c.dim),
            "w_gate": (n, c.dim, c.hidden_dim),
            "w_up": (n, c.dim, c.hidden_dim),
            "w_down": (n, c.hidden_dim, c.dim),
            "attn_norm": (n, c.dim), "mlp_norm": (n, c.dim),
        }
        if with_cross:
            stack.update({"xq": (n, c.dim, proj), "xk": (n, c.dim, proj),
                          "xv": (n, c.dim, proj), "xo": (n, proj, c.dim),
                          "cross_norm": (n, c.dim)})
        return stack

    return {
        "conv1": {"w": (c.dim, c.n_mels, 3), "b": (c.dim,)},
        "conv2": {"w": (c.dim, c.dim, 3), "b": (c.dim,)},
        "encoder": layer_stack(c.n_encoder_layers, with_cross=False),
        "encoder_norm": (c.dim,),
        "embed": (c.vocab_size, c.dim),
        "decoder": layer_stack(c.n_decoder_layers, with_cross=True),
        "decoder_norm": (c.dim,),
    }


def _fan_in(name: str, shape: tuple) -> int | None:
    """The JAX package's init scale of a leaf: fan_in for a weight, None
    for a norm (ones) or a bias (zeros)."""
    if name.endswith("norm") or name == "b":
        return None
    if name == "w":                                 # conv [out, in, width]
        return shape[1] * shape[2]
    if name == "embed":
        return shape[-1]
    return shape[-2]


def abstract_params(config: AsrConfig) -> dict:
    """The parameter tree as meta tensors: its shapes and dtype, no
    storage and nothing drawn (a checkpoint restore's template)."""
    dtype = _dtype(config)

    def meta(layout: dict) -> dict:
        return {name: meta(shape) if isinstance(shape, dict)
                else torch.empty(shape, dtype=dtype, device="meta")
                for name, shape in layout.items()}

    return meta(param_shapes(config))


def init_params(seed: int, config: AsrConfig,
                device: str | torch.device | None = None) -> dict:
    """Random weights at the JAX package's scaling (standard normal x
    fan_in^-0.5, unit norms, zero biases), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card
    unless "cpu" is asked for), in the config's dtype."""
    device = resolve_device(device)
    dtype = _dtype(config)
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def draw(layout: dict) -> dict:
        out = {}
        for name, shape in layout.items():
            if isinstance(shape, dict):
                out[name] = draw(shape)
                continue
            fan_in = _fan_in(name, shape)
            if fan_in is None:
                fill = torch.ones if name.endswith("norm") else torch.zeros
                out[name] = fill(shape, dtype=dtype, device=device)
            else:
                weight = torch.randn(shape, generator=generator,
                                     device=device, dtype=torch.float32)
                out[name] = (weight * fan_in ** -0.5).to(dtype)
        return out

    return draw(param_shapes(config))


# ---------------------------------------------------------------------------
# Model body.

def _layer(stack: dict, index: int) -> dict:
    return {name: value[index] for name, value in stack.items()}


def _attention(q, k, v, n_heads: int, causal: bool):
    """q [B,S,D'], k/v [B,T,D'] already projected; multi-head dense
    attention with optional causal mask; float32 softmax."""
    b, s, _ = q.shape
    t = k.shape[1]
    hd = q.shape[-1] // n_heads
    q = q.reshape(b, s, n_heads, hd)
    k = k.reshape(b, t, n_heads, hd)
    v = v.reshape(b, t, n_heads, hd)
    logits = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float()) * hd ** -0.5
    if causal:
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", weights.to(v.dtype), v)
    return out.reshape(b, s, n_heads * hd)


def _sinusoid(positions: int, dim: int) -> np.ndarray:
    pos = np.arange(positions)[:, None]
    idx = np.arange(dim // 2)[None, :]
    angle = pos / (10_000 ** (2 * idx / dim))
    return np.concatenate([np.sin(angle), np.cos(angle)],
                          axis=-1).astype(np.float32)


def sinusoid(positions: int, dim: int, device: torch.device) -> torch.Tensor:
    return device_constant(("sinusoid", positions, dim), device,
                           lambda: _sinusoid(positions, dim))


def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding (low, high) of one dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv1d(params, x, stride: int):
    """x [B, T, C] -> [B, T/stride, C'] with 'SAME' padding + GELU."""
    weight = params["w"].to(x.dtype)                # [C', C, width]
    low, high = _same_padding(x.shape[1], weight.shape[-1], stride)
    out = F.conv1d(F.pad(x.transpose(1, 2), (low, high)), weight,
                   stride=stride).transpose(1, 2)
    return F.gelu(out + params["b"].to(x.dtype), approximate="tanh")


def encode(params: dict, config: AsrConfig,
           mel: torch.Tensor) -> torch.Tensor:
    """log-mel [B, F, n_mels] -> encoder states [B, F/4, D]."""
    c = config
    x = mel.to(_dtype(c))
    x = _conv1d(params["conv1"], x, stride=2)
    x = _conv1d(params["conv2"], x, stride=2)
    x = x + sinusoid(x.shape[1], c.dim, x.device)[None].to(x.dtype)
    for index in range(c.n_encoder_layers):
        layer = _layer(params["encoder"], index)
        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        attn = _attention(h @ layer["wq"], h @ layer["wk"],
                          h @ layer["wv"], c.n_heads, causal=False)
        x = x + attn @ layer["wo"]
        h = rms_norm(x, layer["mlp_norm"], c.norm_eps)
        x = x + swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"])
    return rms_norm(x, params["encoder_norm"], c.norm_eps)


def _decode_states(params: dict, config: AsrConfig, tokens: torch.Tensor,
                   encoded: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass: tokens [B, S] -> logits [B, S, V]."""
    c = config
    hidden = params["embed"][tokens.long()]
    hidden = hidden + sinusoid(tokens.shape[1], c.dim,
                               hidden.device)[None].to(hidden.dtype)
    for index in range(c.n_decoder_layers):
        layer = _layer(params["decoder"], index)
        h = rms_norm(hidden, layer["attn_norm"], c.norm_eps)
        attn = _attention(h @ layer["wq"], h @ layer["wk"],
                          h @ layer["wv"], c.n_heads, causal=True)
        hidden = hidden + attn @ layer["wo"]
        h = rms_norm(hidden, layer["cross_norm"], c.norm_eps)
        cross = _attention(h @ layer["xq"], encoded @ layer["xk"],
                           encoded @ layer["xv"], c.n_heads, causal=False)
        hidden = hidden + cross @ layer["xo"]
        h = rms_norm(hidden, layer["mlp_norm"], c.norm_eps)
        hidden = hidden + swiglu(h, layer["w_gate"], layer["w_up"],
                                 layer["w_down"])
    hidden = rms_norm(hidden, params["decoder_norm"], c.norm_eps)
    return hidden @ params["embed"].T


def transcribe(params: dict, config: AsrConfig,
               samples: torch.Tensor) -> torch.Tensor:
    """Greedy decode: waveform [B, T_chunk] -> token ids [B, max_text]
    int32.

    KV-cached O(S) decode: cross-attention keys/values are projected
    once per utterance, each step's self-attention reads the cache
    through the split-softmax append (``ops/layers.py``
    ``attention_decode_append``, K = H), and step i's k/v pair is
    written into the cache at position i by slice assignment.  The loop
    has a static budget of ``max_text`` steps; after EOS a row keeps
    emitting EOS (masked).  Nothing in it reads a value on the host, so
    the whole call is one CUDA graph (:func:`transcriber`)."""
    c = config
    dtype = _dtype(c)
    device = samples.device
    encoded = encode(params, c, log_mel(c, samples))
    batch = samples.shape[0]
    hd = c.head_dim
    decoder = params["decoder"]
    layers = [_layer(decoder, index) for index in range(c.n_decoder_layers)]
    # Cross-attention K/V once per utterance.
    cross = [(encoded @ layer["xk"], encoded @ layer["xv"])
             for layer in layers]
    cache_shape = (c.n_decoder_layers, batch, c.max_text, c.n_heads, hd)
    cache_k = torch.zeros(cache_shape, dtype=dtype, device=device)
    cache_v = torch.zeros(cache_shape, dtype=dtype, device=device)
    pos_table = sinusoid(c.max_text, c.dim, device).to(dtype)
    current = torch.full((batch,), c.bos_token, dtype=torch.long,
                         device=device)
    finished = torch.zeros((batch,), dtype=torch.bool, device=device)
    emitted = []
    for i in range(c.max_text):
        hidden = params["embed"][current][:, None, :] + pos_table[i]
        lengths = torch.full((batch,), i, dtype=torch.int32, device=device)
        for index, layer in enumerate(layers):
            h = rms_norm(hidden, layer["attn_norm"], c.norm_eps)
            q = (h @ layer["wq"]).reshape(batch, 1, c.n_heads, hd)
            k = (h @ layer["wk"]).reshape(batch, 1, c.n_heads, hd)
            v = (h @ layer["wv"]).reshape(batch, 1, c.n_heads, hd)
            attn = attention_decode_append(q, cache_k[index],
                                           cache_v[index], k, v, lengths)
            # Read-only inside the step: positions >= i are masked, so
            # the write lands before the next layer's read harmlessly.
            cache_k[index, :, i] = k[:, 0]
            cache_v[index, :, i] = v[:, 0]
            hidden = hidden + attn.reshape(batch, 1, -1) @ layer["wo"]
            h = rms_norm(hidden, layer["cross_norm"], c.norm_eps)
            xk, xv = cross[index]
            hidden = hidden + _attention(h @ layer["xq"], xk, xv, c.n_heads,
                                         causal=False) @ layer["xo"]
            h = rms_norm(hidden, layer["mlp_norm"], c.norm_eps)
            hidden = hidden + swiglu(h, layer["w_gate"], layer["w_up"],
                                     layer["w_down"])
        hidden = rms_norm(hidden, params["decoder_norm"], c.norm_eps)
        logits = (hidden @ params["embed"].T)[:, 0]
        next_token = torch.argmax(logits, dim=-1)
        next_token = torch.where(finished, c.eos_token, next_token)
        finished = finished | (next_token == c.eos_token)
        emitted.append(next_token)
        current = next_token
    return torch.stack(emitted, dim=1).to(torch.int32)


def transcriber(params: dict, config: AsrConfig, cache=None):
    """:func:`transcribe` bound to ``params`` and run through a
    ``JitCache`` (``cache``, else a new one): on the card one CUDA graph
    a batch shape -- the weights read in place, the waveform copied into
    the graph's input -- on the CPU the eager call.  A capture that
    fails raises."""
    from ..pipeline.tensor import JitCache
    cache = JitCache() if cache is None else cache
    return cache(lambda samples: transcribe(params, config, samples))


def decode_text(config: AsrConfig, token_row) -> str:
    """Token ids -> text (byte-level; specials stripped)."""
    data = bytearray()
    for token in np.asarray(token_row).tolist():
        if token == config.eos_token:
            break
        if 0 <= token < 256:
            data.append(token)
    return data.decode("utf-8", errors="replace")


def encode_text(config: AsrConfig, text: str) -> list[int]:
    return list(text.encode("utf-8"))[:config.max_text - 1]


class StreamingAsr:
    """Incremental transcription for live audio (the ``mic://`` -> text
    path; reference equivalent: examples/speech/speech_elements.py
    PE_WhisperX's LRU sliding window at :53-84, which batch-reprocesses
    the window -- here each decode costs exactly ONE captured replay).

    The JAX package's class, line for line, but for the decode itself
    (``_transcribe_one``): the chunk goes up through pinned memory, the
    decode is a transcriber's graph (``transcribe_fn``: one shared with
    other streams, else one of its own), and its token row comes back in
    ONE planned wait (``device.sync_allowed``: the sync guard is
    process-wide, and another thread may be ticking under it).

    Usage::

        streamer = StreamingAsr(params, config, hop_seconds=1.0,
                                endpoint_silence=0.5)
        final = streamer.push(mic_samples)   # FINALIZED text (see below)
        live = streamer.partial_text         # revisable hypothesis
        final += streamer.flush()            # finalize the tail

    Three latency mechanisms:

    - **sub-chunk partial decode**: with ``hop_seconds`` set, every
      hop's worth of new audio re-decodes the buffered (zero-padded)
      window -- the rolling re-encode strategy, one captured shape --
      updating ``partial_text`` (the current revisable hypothesis) and
      ``stable_text`` (the prefix two consecutive hypotheses agree on).
    - **energy endpointing**: with ``endpoint_silence`` set, a trailing
      silence of that many seconds after detected speech finalizes the
      utterance immediately instead of waiting for the chunk to fill.
    - **chunk completion**: a full ``chunk_seconds`` window always
      finalizes.

    ``push`` RETURNS only finalized text: exactly the whole-buffered-
    window decode, never a partial hypothesis -- so concatenated push/
    flush output equals whole-chunk transcription and is never
    retracted.  Chunks are independent utterance windows (no
    cross-chunk decoder state): a word split across a boundary may be
    mis-recognized, the standard chunked-streaming trade-off.
    """

    def __init__(self, params, config: AsrConfig,
                 hop_seconds: float | None = None,
                 endpoint_silence: float | None = None,
                 endpoint_threshold: float = 0.01, transcribe_fn=None):
        self.params = params
        self.config = config
        self.device = params["embed"].device
        self._transcribe = transcribe_fn if transcribe_fn is not None \
            else transcriber(params, config)
        rate = config.sample_rate
        self.chunk = int(rate * config.chunk_seconds)
        self.hop = int(rate * hop_seconds) if hop_seconds else None
        self.endpoint = int(rate * endpoint_silence) \
            if endpoint_silence else None
        self.endpoint_threshold = float(endpoint_threshold)
        self._pending = np.zeros((0,), dtype=np.float32)
        self._since_partial = 0
        self.partial_text = ""        # latest (revisable) hypothesis
        self.stable_text = ""         # agreed prefix of last two partials
        self.chunks_transcribed = 0
        self.partial_decodes = 0

    def _transcribe_one(self, chunk_samples: np.ndarray) -> str:
        tokens = self._transcribe(upload(chunk_samples[None], self.device))
        with sync_allowed():
            row = tokens[0].cpu().numpy()
        self.chunks_transcribed += 1
        return decode_text(self.config, row)

    def _reset_partial(self):
        self._since_partial = 0
        self.partial_text = ""
        self.stable_text = ""

    def _partial_decode(self):
        """Re-decode the buffered window (zero-padded: one compiled
        shape); keep the stable prefix = agreement with the previous
        hypothesis."""
        previous = self.partial_text
        hypothesis = self._transcribe_one(
            pad_audio(self.config, self._pending))
        self.chunks_transcribed -= 1          # partials are not chunks
        self.partial_decodes += 1
        agree = 0
        for a, b in zip(previous, hypothesis):
            if a != b:
                break
            agree += 1
        self.stable_text = hypothesis[:agree]
        self.partial_text = hypothesis
        self._since_partial = 0

    def _endpoint_reached(self) -> bool:
        """Speech followed by >= endpoint_silence of trailing quiet."""
        if self.endpoint is None \
                or len(self._pending) <= self.endpoint:
            return False
        tail = self._pending[-self.endpoint:]
        head = self._pending[:-self.endpoint]
        tail_rms = float(np.sqrt(np.mean(tail * tail)))
        head_peak = float(np.abs(head).max()) if len(head) else 0.0
        return (tail_rms < self.endpoint_threshold
                and head_peak >= self.endpoint_threshold)

    def push(self, samples) -> str:
        """Append samples; returns newly FINALIZED text ('' while the
        window fills -- watch ``partial_text``/``stable_text`` for the
        sub-chunk live hypothesis)."""
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        self._pending = np.concatenate([self._pending, samples])
        self._since_partial += len(samples)
        emitted = []
        while len(self._pending) >= self.chunk:
            chunk, self._pending = (self._pending[:self.chunk],
                                    self._pending[self.chunk:])
            emitted.append(self._transcribe_one(chunk))
            self._reset_partial()
        if emitted:
            return "".join(emitted)
        if self._endpoint_reached():
            return self.flush()
        if self.hop and len(self._pending) \
                and self._since_partial >= self.hop:
            self._partial_decode()
        return ""

    def flush(self) -> str:
        """Finalize whatever partial window remains (zero-padded)."""
        if not len(self._pending):
            return ""
        tail, self._pending = self._pending, \
            np.zeros((0,), dtype=np.float32)
        self._reset_partial()
        return self._transcribe_one(pad_audio(self.config, tail))


def asr_loss(params: dict, config: AsrConfig, samples: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
    """Teacher-forced cross-entropy; targets [B, S] padded with PAD=259
    (ignored).  The forward of the JAX package's fitting objective (the
    optimiser waits for ``models/train.py``)."""
    c = config
    encoded = encode(params, c, log_mel(c, samples))
    targets = targets.long()
    bos = torch.full((targets.shape[0], 1), c.bos_token, dtype=torch.long,
                     device=targets.device)
    inputs = torch.cat([bos, targets[:, :-1]], dim=1)
    logits = _decode_states(params, c, inputs, encoded).float()
    log_probs = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(log_probs, -1, targets[..., None])[..., 0]
    mask = (targets != 259).float()
    return -(picked * mask).sum() / torch.clamp(mask.sum(), min=1.0)
