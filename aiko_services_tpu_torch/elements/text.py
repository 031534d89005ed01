"""Text I/O elements (reference: src/aiko_services/elements/media/
text_io.py): file read/write, sampling, case transforms.  TTY/socket
variants live with the interactive tooling."""

from __future__ import annotations

import os

from ..pipeline import (DataSource, DataTarget, PipelineElement,
                        StreamEvent)
from .scheme_file import DataSchemeFile

__all__ = ["TextReadFile", "TextWriteFile", "TextTransform", "TextSample",
           "TextFilter", "TextOutput"]


class TextReadFile(DataSource):
    """Reads text file(s) named by ``data_sources``; emits one frame per
    file with ``text`` (reference text_io.py:107-128)."""

    def process_frame(self, stream, **inputs):
        path = inputs.get("path")
        try:
            with open(path) as fh:
                text = fh.read()
        except OSError as error:
            return StreamEvent.ERROR, {"diagnostic": str(error)}
        return StreamEvent.OKAY, {"text": text, "path": path}


class TextWriteFile(DataTarget):
    """Writes ``text`` to the ``data_targets`` path; ``{}`` templates get
    the frame index (reference text_io.py:280-333)."""

    def process_frame(self, stream, text=None, **inputs):
        scheme = self.scheme_for(stream)
        if not isinstance(scheme, DataSchemeFile):
            return StreamEvent.ERROR, {
                "diagnostic": "TextWriteFile requires file:// targets"}
        path = scheme.target_path(stream)
        try:
            with open(path, "a" if "{}" not in
                      stream.variables["target_path"] else "w") as fh:
                fh.write(str(text))
                if not str(text).endswith(os.linesep):
                    fh.write(os.linesep)
        except OSError as error:
            return StreamEvent.ERROR, {"diagnostic": str(error)}
        return StreamEvent.OKAY, {"path": path}


class TextTransform(PipelineElement):
    """Case/strip transforms chosen by the ``transform`` parameter
    (reference text_io.py:236-280)."""

    TRANSFORMS = {
        "lower": str.lower, "upper": str.upper, "title": str.title,
        "strip": str.strip, "none": lambda t: t,
    }

    def process_frame(self, stream, text=None, **inputs):
        name, _ = self.get_parameter("transform", "none")
        transform = self.TRANSFORMS.get(str(name))
        if transform is None:
            return StreamEvent.ERROR, {
                "diagnostic": f"unknown transform {name!r}"}
        return StreamEvent.OKAY, {"text": transform(str(text))}


class TextFilter(PipelineElement):
    """Gates frames on content: drops frames whose ``text`` is empty or
    whitespace, or -- with parameter ``gate`` naming another input --
    frames where THAT input is falsy.  The streaming-speech use:
    ``gate: utterance_end`` passes only the frames where the ASR
    finalized an utterance, so per-hop partial frames never reach a
    downstream LLM stage (the reference's speech pipelines likewise act
    on whisper's completed segments, speech_elements.py:53-84)."""

    @staticmethod
    def _truthy(value) -> bool:
        if value is None:
            return False
        if isinstance(value, str):
            return bool(value.strip())
        ndim = getattr(value, "ndim", None)     # numpy/jax values
        if ndim is not None:
            if ndim == 0:                       # scalar (np.bool_(False),
                return bool(value)              # np.int64(0), ...)
            return len(value.reshape(-1)) > 0   # real arrays: non-empty
        return bool(value)

    def process_frame(self, stream, text=None, **inputs):
        gate, found = self.get_parameter("gate", None)
        if found and gate:
            # 'text' binds to the named parameter, never **inputs.
            if str(gate) == "text":
                value = text
            elif str(gate) in inputs:
                value = inputs[str(gate)]
            else:
                # A typo'd/unwired gate must surface, not silently
                # drop every frame forever.
                return StreamEvent.ERROR, {
                    "diagnostic": f"TextFilter gate {gate!r} is not an "
                                  f"input of this frame "
                                  f"(inputs: {sorted(inputs)})"}
        else:
            value = text
        if not self._truthy(value):
            return StreamEvent.DROP_FRAME, {}
        return StreamEvent.OKAY, {"text": text}


class TextSample(PipelineElement):
    """Passes every Nth frame, drops the rest (reference
    text_io.py:220-236)."""

    def start_stream(self, stream, stream_id):
        stream.variables[f"{self.name}.count"] = 0
        return StreamEvent.OKAY, {}

    def process_frame(self, stream, text=None, **inputs):
        rate, _ = self.get_parameter("sample_rate", 1)
        count = stream.variables.get(f"{self.name}.count", 0)
        stream.variables[f"{self.name}.count"] = count + 1
        if count % int(rate):
            return StreamEvent.DROP_FRAME, {}
        return StreamEvent.OKAY, {"text": text}


class TextOutput(PipelineElement):
    """Collects text into ``pipeline.share`` and optionally prints --
    tail element for tests/demos (reference text_io.py:89-107)."""

    def process_frame(self, stream, text=None, **inputs):
        collected = stream.variables.setdefault("text_output", [])
        collected.append(text)
        if self.get_parameter("print", False)[0]:
            print(text)
        return StreamEvent.OKAY, {"text": text}
