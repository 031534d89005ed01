"""Speech pipeline elements: ASR (speech-to-text) and TTS
(text-to-speech), hosting the framework's own models on the card
(BASELINE config 5; reference equivalents:
examples/speech/speech_elements.py PE_WhisperX at :203-239 wrapping the
external whisperx/CUDA model, PE_COQUI_TTS at :122-146 wrapping Coqui
VITS -- here both models are the framework's, models/asr.py and
models/tts.py).

Counterpart of ``aiko_services_tpu/elements/speech.py`` on the port's
``models.asr`` and ``models.tts``.  The port's differences:

- element parameter ``device`` (the port's device rule, ``device.py``):
  the card by default, ``cpu`` for the plain PyTorch path; with no card
  and no ``device: cpu`` a frame fails;
- ``checkpoint`` fails the frame with the ``not_ported`` text until
  ROADMAP Queue 1 item 7 (no orbax reader); without one the weights
  come from ``init_params`` on the ``seed``;
- X (``JitCache``: on
  the card one CUDA graph a batch bucket, shared by every stream's
  :class:`~aiko_services_tpu_torch.models.asr.StreamingAsr`); its rows
  go up through pinned memory and its tokens come back in one planned
  wait (``device.sync_allowed``);
- the TTS emits its waveform as the host array ``synthesize`` returns
  (host values stay on the host).

Audio longer than one ASR chunk is split into chunk-sized rows and
transcribed as ONE batch: a single device dispatch, one captured graph a
row bucket, however long the utterance (the ShapeBucketer stance --
never a data-dependent shape, always a padded batch).
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device, sync_allowed
from ..models import asr as asr_model
from ..models import tts as tts_model
from ..pipeline import PipelineElement, StreamEvent
from ..pipeline.tensor import JitCache, ShapeBucketer
from .llm import _restore

__all__ = ["ASR", "TTS"]


def _chunk_rows(samples: np.ndarray, chunk: int,
                bucketer: ShapeBucketer) -> np.ndarray:
    """Mono waveform [N] -> [bucket(ceil(N/chunk)), chunk], zero
    right-padded.  The row count is bucketed (powers of two from 1) so
    ``transcribe`` compiles once per bucket, not once per utterance
    length."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    n_rows = bucketer.bucket(max(1, -(-len(samples) // chunk)))
    rows = np.zeros((n_rows, chunk), dtype=np.float32)
    flat = samples[: n_rows * chunk]
    rows.reshape(-1)[: len(flat)] = flat
    return rows


class _Hosted(PipelineElement):
    """A speech model hosted by the element: ``_SIZES`` names its
    configs, ``_MODEL`` its module.  The weights are drawn at first use
    from ``seed`` at ``model_size`` on ``device``; a bad size raises
    ValueError, a ``checkpoint`` raises ``not_ported``."""

    _SIZES: dict = {}
    _MODEL = None

    def __init__(self, context):
        super().__init__(context)
        self._params = None
        self._config = None

    def _ensure_model(self):
        if self._params is not None:
            return
        size, _ = self.get_parameter("model_size", "tiny")
        if str(size) not in self._SIZES:
            raise ValueError(f"{type(self).__name__} model_size {size!r}: "
                             f"expected one of {sorted(self._SIZES)}")
        checkpoint, _ = self.get_parameter("checkpoint", None)
        seed, _ = self.get_parameter("seed", 0)
        device, _ = self.get_parameter("device", None)
        config = self._SIZES[str(size)]()
        self._params = _restore(self._MODEL.init_params(
            int(seed), config, resolve_device(device)), checkpoint)
        self._config = config


class ASR(_Hosted):
    """``audio`` [N] or [N, C] + ``sample_rate`` -> transcript ``text``.

    Parameters: ``checkpoint`` (fails the frame until the port reads
    one), ``model_size`` (``tiny``/``base``), ``seed``, ``device``,
    ``sample_rate`` (model rate, default 16000), ``streaming`` (true:
    incremental live mode -- each frame's audio feeds a per-stream
    :class:`StreamingAsr`, the frame emits whatever text completed
    chunks produced, and ``stop_stream`` flushes the tail; the
    ``mic://`` -> ASR live path).  Input audio at another rate should
    pass through
    :class:`~aiko_services_tpu_torch.elements.audio.AudioResampler`
    first (same contract as the reference's resampler -> whisper chain).
    """

    host_inputs = ("audio",)    # np.asarray front door: one counted fetch

    _SIZES = {"tiny": asr_model.AsrConfig.tiny,
              "base": asr_model.AsrConfig.base}
    _MODEL = asr_model

    def __init__(self, context):
        super().__init__(context)
        self._bucketer = ShapeBucketer(minimum=1)
        self._streamers: dict = {}
        self.jit_cache = JitCache()
        self._transcribe = None

    def _ensure_model(self):
        super()._ensure_model()
        if self._transcribe is None:
            self._transcribe = asr_model.transcriber(
                self._params, self._config, self.jit_cache)

    def _streaming(self) -> bool:
        from ..utils import parse_bool
        return parse_bool(self.get_parameter("streaming", False)[0])

    def process_frame(self, stream, audio=None, sample_rate=16000,
                      **inputs):
        try:
            self._ensure_model()
        except (ValueError, NotImplementedError, RuntimeError) as error:
            return StreamEvent.ERROR, {"diagnostic": str(error)}
        config = self._config
        if int(sample_rate) != config.sample_rate:
            return StreamEvent.ERROR, {
                "diagnostic": f"ASR expects {config.sample_rate} Hz audio"
                              f", got {sample_rate} (add AudioResampler)"}
        samples = np.asarray(audio, dtype=np.float32)
        if samples.ndim == 2:                      # [N, C] -> mono
            samples = samples.mean(axis=-1)
        if self._streaming():
            streamer = self._streamers.get(stream.stream_id)
            if streamer is None:
                # hop_seconds: sub-chunk live hypothesis every hop;
                # endpoint_silence: trailing quiet finalizes the
                # utterance early (models/asr.py StreamingAsr).
                hop, _ = self.get_parameter("hop_seconds", None)
                endpoint, _ = self.get_parameter("endpoint_silence",
                                                 None)
                streamer = asr_model.StreamingAsr(
                    self._params, config,
                    hop_seconds=float(hop) if hop else None,
                    endpoint_silence=float(endpoint) if endpoint
                    else None, transcribe_fn=self._transcribe)
                self._streamers[stream.stream_id] = streamer
            finalized_before = streamer.chunks_transcribed
            text = streamer.push(samples)
            # utterance_end marks the EVENT (a chunk filled or the
            # endpoint fired), independent of whether the decoded text
            # is empty -- downstream gates (TextFilter gate:
            # utterance_end) trigger on utterance boundaries, not on
            # what the model happened to emit.
            return StreamEvent.OKAY, {
                "text": text, "partial_text": streamer.partial_text,
                "stable_text": streamer.stable_text,
                "utterance_end":
                    streamer.chunks_transcribed > finalized_before}
        chunk = int(config.sample_rate * config.chunk_seconds)
        true_rows = max(1, -(-len(samples) // chunk))
        rows = _chunk_rows(samples, chunk, self._bucketer)
        tokens = self._transcribe(asr_model.upload(
            rows, self._params["embed"].device))
        with sync_allowed():                       # the one planned wait
            tokens = tokens.cpu().numpy()
        # Decode only the real chunks -- bucket-padding rows are pure
        # silence and a fitted model may still hallucinate tokens there.
        text = "".join(asr_model.decode_text(config, row)
                       for row in tokens[:true_rows])
        return StreamEvent.OKAY, {"text": text}

    def stop_stream(self, stream, stream_id):
        streamer = self._streamers.pop(stream_id, None)
        if streamer is not None:
            tail = streamer.flush()
            if tail:
                # The stream is closing; surface the tail on the share
                # so callers (and tests) can retrieve it.
                self.pipeline.share[f"asr_tail_{stream_id}"] = tail


class TTS(_Hosted):
    """``text`` -> ``audio`` waveform [N] (host float32) +
    ``sample_rate``.

    Parameters: ``checkpoint`` (fails the frame until the port reads
    one), ``model_size`` (``tiny``/``base``), ``seed``, ``device``.
    """

    _SIZES = {"tiny": tts_model.TtsConfig.tiny, "base": tts_model.TtsConfig}
    _MODEL = tts_model

    def process_frame(self, stream, text=None, **inputs):
        if text is None:
            return StreamEvent.ERROR, {
                "diagnostic": "TTS frame has no 'text' input"}
        try:
            self._ensure_model()
        except (ValueError, NotImplementedError, RuntimeError) as error:
            return StreamEvent.ERROR, {"diagnostic": str(error)}
        waveform = tts_model.synthesize(self._params, self._config,
                                        str(text))
        return StreamEvent.OKAY, {
            "audio": waveform,
            "sample_rate": self._config.sample_rate}
