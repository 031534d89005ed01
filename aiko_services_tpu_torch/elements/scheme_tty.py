"""``tty://`` DataScheme + terminal text elements (reference:
src/aiko_services/elements/media/scheme_tty.py:26-74, text_io.py
TextReadTTY:128/TextWriteTTY:333).

Interactive terminal source/target: a background thread reads lines from
the input stream (stdin by default; injectable for tests) and a frame is
emitted per line.  ``/h`` prints input history like the reference's TTY
command history.
"""

from __future__ import annotations

import queue
import sys
import threading

from ..pipeline import DataScheme, DataSource, DataTarget, StreamEvent
from ..pipeline.stream import Stream

__all__ = ["DataSchemeTTY", "TextReadTTY", "TextWriteTTY"]


@DataScheme.register("tty")
class DataSchemeTTY(DataScheme):
    """Line-oriented terminal I/O.  The element's ``tty_input`` /
    ``tty_output`` parameters may inject file-like objects (tests, PTY
    wrappers); default stdin/stdout."""

    def __init__(self, element):
        super().__init__(element)
        self._stop = threading.Event()
        self._thread = None
        self._queue: "queue.Queue[str]" = queue.Queue()
        self._history: list[str] = []
        self._output = None

    def create_sources(self, stream: Stream, data_sources,
                       frame_generator=None, rate=None):
        source, _ = self.element.get_parameter("tty_input", None)
        input_stream = source if source is not None else sys.stdin

        def read_loop():
            for line in input_stream:
                if self._stop.is_set():
                    break
                self._queue.put(line.rstrip("\n"))

        self._thread = threading.Thread(
            target=read_loop, daemon=True,
            name=f"tty-read-{self.element.name}")
        self._thread.start()

        def generator(stream_):
            try:
                line = self._queue.get_nowait()
            except queue.Empty:
                return StreamEvent.NO_FRAME, {}
            if line == "/h":
                for index, entry in enumerate(self._history):
                    print(f"{index}: {entry}")
                return StreamEvent.NO_FRAME, {}
            if line in ("/q", "/quit"):
                return StreamEvent.STOP, {}
            self._history.append(line)
            return StreamEvent.OKAY, {"text": line}

        self.element.create_frames(stream, frame_generator or generator,
                                   rate=rate)
        return StreamEvent.OKAY, {}

    def create_targets(self, stream: Stream, data_targets):
        target, _ = self.element.get_parameter("tty_output", None)
        self._output = target if target is not None else sys.stdout
        return StreamEvent.OKAY, {}

    def write(self, text: str):
        print(text, file=self._output, flush=True)

    def destroy_sources(self, stream: Stream):
        self._stop.set()


class TextReadTTY(DataSource):
    """One frame per line typed on the terminal (reference
    text_io.py:128-202)."""

    def process_frame(self, stream, text=None, **inputs):
        return StreamEvent.OKAY, {"text": text}


class TextWriteTTY(DataTarget):
    """Writes ``text`` lines to the terminal (reference
    text_io.py:333-356)."""

    def process_frame(self, stream, text=None, **inputs):
        scheme = self.scheme_for(stream)
        if not isinstance(scheme, DataSchemeTTY):
            return StreamEvent.ERROR, {
                "diagnostic": "TextWriteTTY requires tty:// targets"}
        scheme.write(str(text))
        return StreamEvent.OKAY, {"text": text}
