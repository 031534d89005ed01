"""Audio elements (reference: src/aiko_services/elements/media/
audio_io.py): file read/write, framing, filter, resample, FFT.

Counterpart of ``aiko_services_tpu/elements/audio.py``.  File I/O uses
the stdlib ``wave`` module (PCM16 WAV) and is the JAX package's text.
The DSP -- windowing, resampling, FFT -- runs as tensor ops on the
element's ``device`` parameter (the port's device rule, ``device.py``:
the card unless ``cpu`` is asked for).  Host values stay on the host
until an element computes on them (a reader emits numpy samples; an
upload goes through pinned memory on the card); a tensor input hops to
the element's device.  The port's differences:

- ``AudioFraming``'s ``vmap(dynamic_slice)`` is ``unfold``;
- ``AudioResampler`` keeps ``jax.image.resize(method="linear")``'s
  numbers: a triangle kernel, widened by the downsampling factor
  (antialiasing) and renormalised at the edges
  (:func:`resize_linear`, along any axis: ``ImageResize`` applies it
  along H and W) -- ``F.interpolate`` does not antialias.
"""

from __future__ import annotations

import math
import os
import wave

import numpy as np
import torch

from ..device import resolve_device
from ..models.batching import MicroBatchElement, pad_to_bucket
from ..pipeline import DataSource, DataTarget, PipelineElement, StreamEvent
from .scheme_file import DataSchemeFile

__all__ = ["AudioReadFile", "AudioWriteFile", "AudioFraming",
           "AudioResampler", "AudioFFT", "AudioGraphXY", "AudioOutput",
           "read_wav", "write_wav", "resize_linear"]

# JAX's default dtypes (64-bit values narrow unless x64 is enabled).
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _element_device(element) -> torch.device:
    """The element's ``device`` parameter under the port's device rule."""
    device, _ = element.get_parameter("device", None)
    return resolve_device(device)


def _to_device(value, device: torch.device) -> torch.Tensor:
    """A tensor hops to ``device``; a host value (numpy, nested lists)
    goes up once, in JAX's default dtypes, through pinned memory on the
    card."""
    if isinstance(value, torch.Tensor):
        return value.to(device, non_blocking=True)
    array = np.asarray(value)
    array = np.ascontiguousarray(array, dtype=_NARROW.get(array.dtype,
                                                          array.dtype))
    host = torch.from_numpy(array)
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def resize_linear(samples: torch.Tensor, length: int,
                  dim: int = 0) -> torch.Tensor:
    """``jax.image.resize(samples, ..., "linear")`` along ``dim`` for
    float32 samples: output j reads input position
    ``(j + 0.5) * N / length - 0.5`` through a triangle kernel of half
    width ``max(N / length, 1)`` (antialiasing when downsampling), the
    taps inside [0, N) renormalised to sum to one, as JAX's
    scale-and-translate computes them -- here from the few taps in
    reach rather than a dense [N, length] weight matrix.  The weights
    are built with device ops, so a call can be captured in a CUDA
    graph.  JAX resizes every axis whose size changes in turn; a caller
    does the same with one call per axis (``ImageResize``: H, then
    W)."""
    moved = samples.movedim(dim, 0)
    n = moved.shape[0]
    flat = moved.reshape(n, -1)
    device = samples.device
    inv_scale = n / length
    kernel_scale = max(inv_scale, 1.0)
    position = (torch.arange(length, dtype=torch.float32, device=device)
                + 0.5) * inv_scale - 0.5
    radius = math.ceil(kernel_scale)
    taps = torch.floor(position).long()[:, None] + torch.arange(
        -radius, radius + 2, device=device)[None, :]        # [length, T]
    weights = torch.clamp(
        1.0 - (position[:, None] - taps).abs() / kernel_scale, min=0.0)
    weights = torch.where((taps >= 0) & (taps < n), weights, 0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (position >= -0.5) & (position <= n - 0.5)
    weights = torch.where(inside[:, None], weights, 0.0)
    gathered = flat[taps.clamp(0, n - 1)]                   # [length, T, C]
    resized = torch.einsum("lt,ltc->lc", weights, gathered)
    return resized.reshape((length,) + moved.shape[1:]).movedim(0, dim)


def read_wav(path) -> tuple[np.ndarray, int]:
    """PCM16 WAV -> (float32 samples [N, C] in -1..1, sample_rate)."""
    with wave.open(os.fspath(path), "rb") as fh:
        rate = fh.getframerate()
        channels = fh.getnchannels()
        width = fh.getsampwidth()
        raw = fh.readframes(fh.getnframes())
    if width != 2:
        raise ValueError(f"{path}: only PCM16 WAV supported, got "
                         f"{8 * width}-bit")
    samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    return samples.reshape(-1, channels), rate


def write_wav(path, samples, rate: int):
    """float32 samples [N] or [N, C] in -1..1 -> PCM16 WAV."""
    array = np.asarray(samples, dtype=np.float32)
    if array.ndim == 1:
        array = array[:, None]
    data = (np.clip(array, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(os.fspath(path), "wb") as fh:
        fh.setnchannels(array.shape[1])
        fh.setsampwidth(2)
        fh.setframerate(int(rate))
        fh.writeframes(data.tobytes())


class AudioReadFile(DataSource):
    """Reads WAV file(s); emits ``audio`` [N, C] float32 numpy samples
    (host values stay on the host) + ``sample_rate`` (reference
    audio_io.py:95-205)."""

    def process_frame(self, stream, **inputs):
        path = inputs.get("path")
        try:
            samples, rate = read_wav(path)
        except (OSError, ValueError, wave.Error) as error:
            return StreamEvent.ERROR, {"diagnostic": str(error)}
        return StreamEvent.OKAY, {"audio": samples,
                                  "sample_rate": rate, "path": path}


class AudioWriteFile(DataTarget):
    """Writes ``audio`` to a WAV path (reference speech_elements.py:88)."""

    host_inputs = ("audio",)    # sink: the engine fetches explicitly

    def process_frame(self, stream, audio=None, sample_rate=16000,
                      **inputs):
        scheme = self.scheme_for(stream)
        if not isinstance(scheme, DataSchemeFile):
            return StreamEvent.ERROR, {
                "diagnostic": "AudioWriteFile requires file:// targets"}
        path = scheme.target_path(stream)
        try:
            write_wav(path, audio, int(sample_rate))
        except (OSError, ValueError, wave.Error) as error:
            return StreamEvent.ERROR, {"diagnostic": str(error)}
        return StreamEvent.OKAY, {"path": path}


class AudioFraming(PipelineElement):
    """Splits ``audio`` into fixed windows with hop (sliding window like
    the reference's LRU audio framing, speech_elements.py:53-84); emits
    ``frames`` [num_windows, window, C] on the element's device."""

    def process_frame(self, stream, audio=None, sample_rate=16000,
                      **inputs):
        window, _ = self.get_parameter("window", 400)
        hop, _ = self.get_parameter("hop", 160)
        window, hop = int(window), int(hop)
        audio = _to_device(audio, _element_device(self))
        if audio.dim() == 1:
            audio = audio[:, None]
        n = audio.shape[0]
        if n < window:
            audio = torch.nn.functional.pad(audio, (0, 0, 0, window - n))
        frames = audio.unfold(0, window, hop).permute(0, 2, 1)
        return StreamEvent.OKAY, {"frames": frames,
                                  "sample_rate": sample_rate}


class AudioResampler(PipelineElement):
    """Linear resample to ``target_rate`` on the element's device
    (reference audio_io.py:237-299 used numpy)."""

    def process_frame(self, stream, audio=None, sample_rate=16000,
                      **inputs):
        target, _ = self.get_parameter("target_rate", 16000)
        target = int(target)
        rate = int(sample_rate)
        audio = _to_device(audio, _element_device(self))
        if rate == target:
            return StreamEvent.OKAY, {"audio": audio,
                                      "sample_rate": target}
        squeeze = audio.dim() == 1
        if squeeze:
            audio = audio[:, None]
        new_length = int(round(audio.shape[0] * target / rate))
        resampled = resize_linear(audio.float(), new_length)
        if squeeze:
            resampled = resampled[:, 0]
        return StreamEvent.OKAY, {"audio": resampled,
                                  "sample_rate": target}


class AudioFFT(MicroBatchElement, PipelineElement):
    """Magnitude spectrum per window of ``frames`` (reference
    audio_io.py:299-334's PE_FFT).

    ASYNC by default: same-shape window batches parked here -- from
    every stream -- transform together as one batched device FFT
    (MicroBatcher), each frame's spectrum row staying device-resident
    for downstream device stages.  ``synchronous: true`` for the
    blocking path.
    """

    is_async = True
    device_resident = True

    @staticmethod
    def _spectrum(frames):
        mono = frames.mean(dim=-1) if frames.dim() >= 3 else frames
        return torch.fft.rfft(mono.float(), dim=-1).abs()

    def process_frame(self, stream, frames=None, sample_rate=16000,
                      **inputs):
        return StreamEvent.OKAY, {
            "spectrum": self._spectrum(_to_device(frames,
                                                 _element_device(self))),
            "sample_rate": sample_rate}

    def device_fn(self, stream):
        """Fused-segment contract: the FFT is pure device math;
        ``sample_rate`` is not consumed by the trace, so the engine
        passes it through host-side unchanged (type preserved)."""
        from ..pipeline import DeviceFn
        device = _element_device(self)
        return DeviceFn(
            fn=lambda frames: {
                "spectrum": self._spectrum(_to_device(frames, device))},
            inputs=("frames",), outputs=("spectrum",))

    def process_frame_start(self, stream, complete, frames=None,
                            sample_rate=16000, **inputs):
        # With no card and no ``device: cpu`` this raises before the
        # frame parks: the frame fails, not the batch.
        _element_device(self)
        self.submit_microbatch(complete, (frames, sample_rate),
                               diagnostic="bad frames")

    def batch_context(self):
        return _element_device(self)

    def batch_key(self, payload):
        frames, _ = payload
        if not hasattr(frames, "shape"):    # array-likes: numpy metadata
            frames = np.asarray(frames)
        return tuple(frames.shape), str(frames.dtype)

    def batch_run(self, context, key, payloads):
        device = context
        windows = pad_to_bucket([frames for frames, _ in payloads])
        if all(isinstance(frames, np.ndarray) for frames in windows):
            batch = _to_device(np.stack(windows), device)   # one upload
        else:
            batch = torch.stack([_to_device(frames, device)
                                 for frames in windows])
        # The leading batch dim shifts the mono check by one: a batch
        # of [windows, window, C] items is 4-d.
        mono = batch.mean(dim=-1) if batch.dim() >= 4 else batch
        return torch.fft.rfft(mono.float(), dim=-1).abs()

    def batch_finish(self, context, key, entries, result):
        for row, (complete, (_, sample_rate)) in enumerate(entries):
            complete(StreamEvent.OKAY, {"spectrum": result[row],
                                        "sample_rate": sample_rate})


class AudioGraphXY(PipelineElement):
    """Render the magnitude spectrum as an amplitude-vs-frequency plot
    IMAGE (reference audio_io.py:334 PE_GraphXY, which pygal-renders a
    PNG and cv2.imshows it in a window; here the plot is an ordinary
    ``image`` array [height, width, 3] uint8, so it composes with the
    existing image sinks -- ImageWriteFile, VideoWriteRTSP, overlays --
    instead of needing a display).

    Input ``spectrum`` [windows, bins] (AudioFFT output; the windows
    are averaged) or [bins].  Parameters: ``width``/``height`` (plot
    pixels), ``max_frequency`` (clip the x axis; default Nyquist).
    Outputs the plot as ``image`` and passes ``spectrum`` through.
    """

    # numpy plotting is host work: one counted engine fetch, not an
    # implicit sync of the device-resident AudioFFT output.
    host_inputs = ("spectrum",)

    def process_frame(self, stream, spectrum=None, sample_rate=16000,
                      **inputs):
        data = np.asarray(spectrum, dtype=np.float32)
        if data.ndim == 2:
            data = data.mean(axis=0)
        bins = data.shape[0]
        width = int(self.get_parameter("width", 512)[0])
        height = int(self.get_parameter("height", 256)[0])
        nyquist = float(sample_rate) / 2.0
        max_frequency, found = self.get_parameter("max_frequency", None)
        if found and max_frequency:
            keep = max(1, int(bins * min(1.0, float(max_frequency)
                                         / max(nyquist, 1e-9))))
            data = data[:keep]
            bins = keep
        # Per-column peak over each column's bin range (reduceat gives
        # the vectorized ragged max), scaled to pixel heights.
        edges = np.floor(np.linspace(0, bins, width,
                                     endpoint=False)).astype(np.int64)
        edges = np.maximum.accumulate(edges)     # monotonic for reduceat
        columns = np.maximum.reduceat(data, edges) if bins >= width \
            else data[np.minimum(edges, bins - 1)]
        peak = float(columns.max())
        heights = np.zeros(width, dtype=np.int64) if peak <= 0 else \
            np.round(columns / peak * (height - 1)).astype(np.int64)
        rows = np.arange(height)[:, None]        # row 0 = top
        bars = rows >= (height - 1 - heights)[None, :]
        image = np.zeros((height, width, 3), dtype=np.uint8)
        image[..., :] = (16, 16, 32)             # background
        image[bars] = (64, 200, 120)             # spectrum bars
        image[-1, :, :] = 255                    # frequency axis
        return StreamEvent.OKAY, {"image": image, "spectrum": spectrum,
                                  "sample_rate": sample_rate}


class AudioOutput(PipelineElement):
    """Logs audio shape; passthrough (reference audio_io.py:75-95)."""

    def process_frame(self, stream, audio=None, **inputs):
        if audio is not None:
            self.logger.info("audio %s", tuple(getattr(audio, "shape",
                                                       ())))
        return StreamEvent.OKAY, {"audio": audio}
