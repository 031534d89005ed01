"""``tensor://`` DataScheme + Read/Write elements over the native
tensor_pipe transport (native/tensor_pipe.cpp; reference equivalent:
the libzmq-backed ``zmq://`` scheme, elements/media/scheme_zmq.py:40 --
this one is the framework's own C++, zero external dependencies).

``tensor://host:port`` targets connect-and-send; sources listen on the
port and pump received arrays as frames.  Arrays cross typed and
shaped (raw bytes + JSON header), so a downstream element sees the
same array the upstream one emitted, as numpy after the host hop.
"""

from __future__ import annotations

from ..pipeline import DataScheme, DataSource, DataTarget, StreamEvent
from ..pipeline.stream import Stream
from ..transport.tensor_pipe import TensorPipeClient, TensorPipeServer

__all__ = ["DataSchemeTensorPipe", "TensorReadPipe", "TensorWritePipe"]

_RECV_POLL_S = 0.1


def _host_port(url: str) -> tuple:
    """``tensor://host:port`` -> (host, port); raises ValueError with a
    usable message on a missing/malformed port (callers surface it as
    a StreamEvent.ERROR diagnostic)."""
    location = DataScheme.parse_data_url_path(url)
    host, separator, port = location.rpartition(":")
    if not separator or not port.isdigit():
        raise ValueError(f"{url!r}: expected tensor://host:port")
    return host or "127.0.0.1", int(port)


@DataScheme.register("tensor")
class DataSchemeTensorPipe(DataScheme):
    """Sources bind a TensorPipeServer; targets hold a client."""

    def __init__(self, element):
        super().__init__(element)
        self._server = None
        self._client = None

    def create_sources(self, stream: Stream, data_sources,
                       frame_generator=None, rate=None):
        if len(data_sources) != 1:
            return StreamEvent.ERROR, {
                "diagnostic": f"tensor:// takes one URL, got "
                              f"{len(data_sources)}"}
        try:
            host, port = _host_port(data_sources[0])
            self._server = TensorPipeServer(host, port)
        except (ValueError, OSError) as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"tensor listen failed: {error}"}
        stream.variables["tensor_pipe_port"] = self._server.port

        def generator(stream_):
            frame = self._server.recv(timeout=_RECV_POLL_S)
            if frame is None:
                return StreamEvent.NO_FRAME, {}
            name, array = frame
            return StreamEvent.OKAY, {
                "tensor": array, "name": name}

        self.element.create_frames(stream,
                                   frame_generator or generator,
                                   rate=rate)
        return StreamEvent.OKAY, {}

    def create_targets(self, stream: Stream, data_targets):
        if len(data_targets) != 1:
            return StreamEvent.ERROR, {
                "diagnostic": f"tensor:// takes one URL, got "
                              f"{len(data_targets)}"}
        try:
            host, port = _host_port(data_targets[0])
            self._client = TensorPipeClient(host, port)
        except (ValueError, ConnectionError) as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"tensor connect failed: {error}"}
        return StreamEvent.OKAY, {}

    def send(self, value, name: str = ""):
        self._client.send(value, name=name)

    def destroy_sources(self, stream: Stream):
        if self._server is not None:
            self._server.close()
            self._server = None

    def destroy_targets(self, stream: Stream):
        if self._client is not None:
            self._client.close()
            self._client = None


class TensorReadPipe(DataSource):
    """``data_sources: tensor://host:port`` -> ``tensor`` frames (the
    receiving end of a cross-host pipeline hop).  The generator puts
    ``tensor``/``name`` into the swag; the inherited pass-through
    process_frame leaves them untouched (re-emitting named keys here
    would clobber the swag with this element's own -- undeclared --
    inputs)."""


class TensorWritePipe(DataTarget):
    """``tensor`` frames -> ``data_targets: tensor://host:port``;
    passes the tensor through for further local stages.  Parameter
    ``input_name`` selects a differently-named swag value."""

    def process_frame(self, stream, tensor=None, **inputs):
        scheme = self.scheme_for(stream)
        if scheme is None:
            return StreamEvent.ERROR, {
                "diagnostic": "tensor target not initialized"}
        input_name, _ = self.get_parameter("input_name", "tensor")
        value = tensor if input_name == "tensor" \
            else inputs.get(input_name)
        if value is None:
            return StreamEvent.ERROR, {
                "diagnostic": f"no {input_name!r} input on frame"}
        try:
            scheme.send(value, name=str(stream.stream_id))
        except ConnectionError as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"tensor send failed: {error}"}
        return StreamEvent.OKAY, {"tensor": value, **inputs}
