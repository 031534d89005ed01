"""``zmq://`` DataScheme + Read/Write elements (reference:
src/aiko_services/elements/media/scheme_zmq.py:40-150, text_io.py
TextReadZMQ/TextWriteZMQ, image_io.py ImageReadZMQ/ImageWriteZMQ).

The out-of-band bulk data plane for frames that must cross hosts with no
ICI path (SURVEY.md section 5.8): PUSH/PULL pair over
``zmq://host:port``.  Payloads are either raw bytes/UTF-8 text or
npy-encoded arrays (``pipeline.tensor.encode_array``) tagged by a 1-byte
kind prefix, so arrays round-trip typed and shaped (as numpy).
"""

from __future__ import annotations

import queue
import threading

try:
    import zmq
    _HAVE_ZMQ = True
except ImportError:                                 # pragma: no cover
    _HAVE_ZMQ = False

from ..pipeline import DataScheme, DataSource, DataTarget, StreamEvent
from ..pipeline.stream import Stream
from ..pipeline.tensor import decode_array, encode_array

__all__ = ["DataSchemeZMQ", "TextReadZMQ", "TextWriteZMQ",
           "ImageReadZMQ", "ImageWriteZMQ"]

_KIND_TEXT = b"t"
_KIND_BYTES = b"b"
_KIND_ARRAY = b"a"
_RECV_POLL_MS = 100


def encode_payload(value) -> bytes:
    if isinstance(value, (bytes, bytearray)):
        return _KIND_BYTES + bytes(value)
    if isinstance(value, str):
        return _KIND_TEXT + value.encode()
    if hasattr(value, "shape"):
        return _KIND_ARRAY + encode_array(value)
    return _KIND_TEXT + str(value).encode()


def decode_payload(data: bytes):
    kind, body = data[:1], data[1:]
    if kind == _KIND_TEXT:
        return body.decode()
    if kind == _KIND_ARRAY:
        return decode_array(body).numpy()
    return body


@DataScheme.register("zmq")
class DataSchemeZMQ(DataScheme):
    """Source: PULL socket bound (or connected) with a background recv
    thread feeding a queue drained by a frame generator; target: PUSH
    socket."""

    def __init__(self, element):
        super().__init__(element)
        self._context = None
        self._socket = None
        self._thread = None
        self._stop = threading.Event()
        self._queue: "queue.Queue[bytes]" = queue.Queue()

    @staticmethod
    def _endpoint(url: str) -> str:
        return "tcp://" + DataScheme.parse_data_url_path(url)

    def create_sources(self, stream: Stream, data_sources,
                       frame_generator=None, rate=None):
        if not _HAVE_ZMQ:
            return StreamEvent.ERROR, {"diagnostic": "pyzmq missing"}
        self._context = zmq.Context.instance()
        self._socket = self._context.socket(zmq.PULL)
        endpoint = self._endpoint(data_sources[0])
        bind, _ = self.element.get_parameter("zmq_bind", True)
        if bind:
            self._socket.bind(endpoint)
        else:
            self._socket.connect(endpoint)

        def recv_loop():
            poller = zmq.Poller()
            poller.register(self._socket, zmq.POLLIN)
            while not self._stop.is_set():
                if poller.poll(_RECV_POLL_MS):
                    self._queue.put(self._socket.recv())

        self._thread = threading.Thread(
            target=recv_loop, daemon=True,
            name=f"zmq-recv-{self.element.name}")
        self._thread.start()

        def generator(stream_):
            try:
                data = self._queue.get_nowait()
            except queue.Empty:
                return StreamEvent.NO_FRAME, {}
            return StreamEvent.OKAY, {"payload": decode_payload(data)}

        self.element.create_frames(stream, frame_generator or generator,
                                   rate=rate)
        return StreamEvent.OKAY, {}

    def create_targets(self, stream: Stream, data_targets):
        if not _HAVE_ZMQ:
            return StreamEvent.ERROR, {"diagnostic": "pyzmq missing"}
        self._context = zmq.Context.instance()
        self._socket = self._context.socket(zmq.PUSH)
        endpoint = self._endpoint(data_targets[0])
        bind, _ = self.element.get_parameter("zmq_bind", False)
        if bind:
            self._socket.bind(endpoint)
        else:
            self._socket.connect(endpoint)
        return StreamEvent.OKAY, {}

    def send(self, value):
        self._socket.send(encode_payload(value))

    def _close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        if self._socket is not None:
            self._socket.close(linger=0)
            self._socket = None

    def destroy_sources(self, stream: Stream):
        self._close()

    def destroy_targets(self, stream: Stream):
        self._close()


class TextReadZMQ(DataSource):
    """Emits ``text`` received over zmq:// (reference
    text_io.py:202-220)."""

    def process_frame(self, stream, payload=None, **inputs):
        return StreamEvent.OKAY, {"text": str(payload)}


class TextWriteZMQ(DataTarget):
    """Sends ``text`` over zmq:// (reference text_io.py:356-369)."""

    def process_frame(self, stream, text=None, **inputs):
        scheme = self.scheme_for(stream)
        if not isinstance(scheme, DataSchemeZMQ):
            return StreamEvent.ERROR, {
                "diagnostic": "TextWriteZMQ requires zmq:// targets"}
        scheme.send(str(text))
        return StreamEvent.OKAY, {"text": text}


class ImageReadZMQ(DataSource):
    """Emits ``image`` arrays received over zmq:// (reference
    image_io.py:307-343)."""

    def process_frame(self, stream, payload=None, **inputs):
        return StreamEvent.OKAY, {"image": payload}


class ImageWriteZMQ(DataTarget):
    """Sends ``image`` arrays over zmq:// (reference
    image_io.py:407-425)."""

    def process_frame(self, stream, image=None, **inputs):
        scheme = self.scheme_for(stream)
        if not isinstance(scheme, DataSchemeZMQ):
            return StreamEvent.ERROR, {
                "diagnostic": "ImageWriteZMQ requires zmq:// targets"}
        scheme.send(image)
        return StreamEvent.OKAY, {"image": image}
