"""Bulk-tensor transport: native (native/tensor_pipe.cpp via ctypes)
with a pure-Python framing fallback.

The host<->host data plane for frames with no ICI path (SURVEY.md
§5.8): the reference fills this role with libzmq, an external C++
dependency (reference elements/media/scheme_zmq.py:12); here it is the
framework's own single-file C++ library -- length-prefixed TCP frames
carrying typed, shaped arrays -- compiled on demand like the native
MQTT broker and bound through ctypes (no pybind11 in this image).
When no compiler is available (CI images, minimal containers) the
same wire format runs over the stdlib ``socket`` module
(:class:`PyTensorPipeServer`/:class:`PyTensorPipeClient`), selected
automatically by :func:`create_pipe_server`/:func:`create_pipe_client`
-- the data plane works everywhere, the native path is the fast one.
``AIKO_TENSOR_PIPE_NATIVE=0`` forces the Python framing (tests).

Arrays cross as raw bytes plus a JSON header (dtype/shape/name), so a
[1080, 1920, 3] uint8 video frame costs its 6.2 MB payload and ~60
header bytes -- no base64, no pickling.  bfloat16 round-trips via
ml_dtypes (jax's numpy extension types).

::

    server = TensorPipeServer()                  # kernel-assigned port
    client = TensorPipeClient("127.0.0.1", server.port)
    client.send(array, name="frame0")
    name, again = server.recv(timeout=1.0)

Concurrency model: the server accepts on a background thread and fans
every connection's frames into one bounded queue (drop-oldest, like
the live-capture backends); sends are synchronous on the caller.
Drops are never silent: ``server.dropped`` counts every evicted frame
(the pipeline shares it as ``tensor_pipe_dropped_frames``) and the
first drop on each connection logs a warning.
"""

from __future__ import annotations

import ctypes
import json
import os
import queue
import socket
import struct
import threading

import numpy as np

from .broker import build_native
from ..utils import get_logger

__all__ = ["TensorPipeServer", "TensorPipeClient", "PyTensorPipeServer",
           "PyTensorPipeClient", "create_pipe_server",
           "create_pipe_client", "native_pipe_available",
           "encode_header", "decode_header"]

_logger = get_logger("aiko.tensor_pipe")

_LIBRARY = None
_LIBRARY_LOCK = threading.Lock()

# Wire frame prefix, shared with native/tensor_pipe.cpp (little-endian):
#   u32 magic 'TPIP' | u32 header_len | u64 payload_len
_MAGIC = 0x54504950
_PREFIX = struct.Struct("<IIQ")
_MAX_HEADER = 1 << 20                 # mirrors the C side's kMaxHeader
_DEFAULT_MAX_PAYLOAD = 64 * 1024 * 1024
_SEND_STALL_S = 10.0                  # mirrors the C side's kSendStallMs

# Env switch: "0"/"off"/"false" forces the pure-Python framing even
# when the native library builds (fallback-path tests; paranoia knob).
_NATIVE_ENV = "AIKO_TENSOR_PIPE_NATIVE"
_native_probe: bool | None = None     # None = not yet probed


def _build_library():
    return build_native("tensor_pipe.cpp", "libtensor_pipe.so",
                        extra_flags=("-shared", "-fPIC"))


def _library() -> ctypes.CDLL:
    global _LIBRARY
    with _LIBRARY_LOCK:
        if _LIBRARY is None:
            lib = ctypes.CDLL(str(_build_library()))
            lib.tp_listen.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.tp_listen.restype = ctypes.c_int
            lib.tp_port.argtypes = [ctypes.c_int]
            lib.tp_port.restype = ctypes.c_int
            lib.tp_accept.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.tp_accept.restype = ctypes.c_int
            lib.tp_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int]
            lib.tp_connect.restype = ctypes.c_int
            lib.tp_send.argtypes = [
                ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_void_p, ctypes.c_uint64]
            lib.tp_send.restype = ctypes.c_int
            lib.tp_recv_begin.argtypes = [
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint64)]
            lib.tp_recv_begin.restype = ctypes.c_int
            lib.tp_recv_body.argtypes = [
                ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
            lib.tp_recv_body.restype = ctypes.c_int
            lib.tp_close.argtypes = [ctypes.c_int]
            lib.tp_close.restype = None
            _LIBRARY = lib
    return _LIBRARY


def native_pipe_available() -> bool:
    """True when the native tensor_pipe library loads (cached); the
    ``AIKO_TENSOR_PIPE_NATIVE=0`` env forces False without probing."""
    if os.environ.get(_NATIVE_ENV, "").strip().lower() \
            in ("0", "off", "false"):
        return False
    global _native_probe
    if _native_probe is None:
        try:
            _library()
            _native_probe = True
        except Exception as error:
            _native_probe = False
            _logger.warning(
                "native tensor_pipe unavailable (%s); using the "
                "pure-Python framing fallback", error)
    return _native_probe


def create_pipe_server(host: str = "127.0.0.1", port: int = 0, **kwargs):
    """A tensor-pipe server: native when the C++ library builds, the
    pure-Python framing otherwise -- same wire format, same API, so
    tier-1 exercises the data plane on compilers-less images too."""
    if native_pipe_available():
        return TensorPipeServer(host, port, **kwargs)
    return PyTensorPipeServer(host, port, **kwargs)


def create_pipe_client(host: str, port: int, timeout: float = 5.0):
    if native_pipe_available():
        return TensorPipeClient(host, port, timeout=timeout)
    return PyTensorPipeClient(host, port, timeout=timeout)


def _resolve(host: str) -> str:
    """Hostname -> numeric IPv4 (the C library speaks inet_pton AF_INET
    only; resolving here keeps getaddrinfo/DNS out of the native code
    and gives a real error message for unresolvable names)."""
    try:
        infos = socket.getaddrinfo(host, None, socket.AF_INET,
                                   socket.SOCK_STREAM)
    except socket.gaierror as error:
        raise ConnectionError(
            f"tensor_pipe: cannot resolve host {host!r}: {error}") \
            from error
    return infos[0][4][0]


def encode_header(array: np.ndarray, name: str) -> bytes:
    return json.dumps({"dtype": str(array.dtype),
                       "shape": list(array.shape),
                       "name": name}).encode()


def decode_header(header: bytes) -> tuple:
    meta = json.loads(header.decode())
    return meta.get("name", ""), np.dtype(meta["dtype"]), \
        tuple(meta["shape"])


class _PipeServerMixin:
    """Shared server policy: the bounded fan-in queue with the counted
    drop-oldest eviction (ISSUE 9: drops used to be silent -- now every
    eviction bumps ``dropped`` and the FIRST drop per connection logs),
    and the ``recv`` API both backends expose."""

    def _init_queue(self, queue_depth: int) -> None:
        self._queue: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._drop_lock = threading.Lock()
        self._drop_logged: set = set()
        self.dropped = 0              # frames evicted under backlog

    def _count_drop(self, connection_id) -> None:
        with self._drop_lock:
            self.dropped += 1
            first = connection_id not in self._drop_logged
            if first:
                self._drop_logged.add(connection_id)
            total = self.dropped
        if first:
            _logger.warning(
                "tensor_pipe: receive backlog on connection %s -- "
                "dropping oldest frames (%d dropped so far; slow "
                "consumer loses frames, producers never stall)",
                connection_id, total)

    def _enqueue(self, item, connection_id) -> None:
        try:
            self._queue.put_nowait(item)
            return
        except queue.Full:
            pass
        self._count_drop(connection_id)       # the evicted oldest
        try:
            self._queue.get_nowait()
        except queue.Empty:
            pass
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            self._count_drop(connection_id)   # lost the race: new frame
                                              # dropped too

    def recv(self, timeout: float | None = None):
        """(name, array), or None on timeout.  ``timeout=None`` (the
        default) blocks until a frame arrives; ``timeout=0`` polls
        without blocking; any other value waits up to that many
        seconds."""
        try:
            if timeout == 0:
                return self._queue.get_nowait()
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None


class TensorPipeClient:
    """Synchronous sender: one TCP connection, framed array sends."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self._lib = _library()
        self._fd = self._lib.tp_connect(_resolve(host).encode(),
                                        int(port), int(timeout * 1000))
        if self._fd < 0:
            raise ConnectionError(f"tensor_pipe connect "
                                  f"{host}:{port} failed")
        self._lock = threading.Lock()

    def send(self, array, name: str = "") -> int:
        """Frame and send one array; returns the wire bytes written
        (prefix + header + payload -- callers' byte accounting)."""
        data = np.ascontiguousarray(np.asarray(array))
        header = encode_header(data, name)
        payload = data.ctypes.data_as(ctypes.c_void_p) if data.size \
            else None
        with self._lock:
            if self._lib.tp_send(self._fd, header, len(header),
                                 payload, data.nbytes) != 0:
                raise ConnectionError("tensor_pipe send failed "
                                      "(peer gone?)")
        return 16 + len(header) + data.nbytes

    def close(self):
        self._lib.tp_close(self._fd)
        self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *_):
        self.close()


class TensorPipeServer(_PipeServerMixin):
    """Receiver: accepts connections on a background thread, fans all
    frames into one bounded queue (oldest dropped under backlog -- the
    live-capture policy: a slow consumer loses frames, never stalls
    producers; every drop counted, see _PipeServerMixin)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 queue_depth: int = 64,
                 max_payload: int = _DEFAULT_MAX_PAYLOAD):
        # max_payload caps what a single peer can make this server
        # allocate (default 64 MB: plenty for video frames / model
        # tensors); a frame advertising more drops the CONNECTION --
        # the stream is misaligned or hostile, not just oversized.
        # The C side's own 4 GiB kMaxPayload stays as the wire-format
        # sanity bound.
        self._lib = _library()
        self._max_payload = int(max_payload)
        self._server_fd = self._lib.tp_listen(_resolve(host).encode(),
                                              int(port))
        if self._server_fd < 0:
            raise OSError(f"tensor_pipe listen {host}:{port} failed")
        self.port = self._lib.tp_port(self._server_fd)
        self._init_queue(queue_depth)
        self._closing = threading.Event()
        self._readers: list = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="aiko.tensor_pipe.accept")
        self._accept_thread.start()

    # -- background machinery ---------------------------------------------

    def _accept_loop(self):
        while not self._closing.is_set():
            fd = self._lib.tp_accept(self._server_fd, 200)
            if fd < 0:
                continue
            reader = threading.Thread(target=self._read_loop,
                                      args=(fd,), daemon=True,
                                      name="aiko.tensor_pipe.read")
            self._readers.append((fd, reader))
            reader.start()

    def _read_loop(self, fd: int):
        header_len = ctypes.c_uint32()
        payload_len = ctypes.c_uint64()
        while not self._closing.is_set():
            rc = self._lib.tp_recv_begin(fd, 200,
                                         ctypes.byref(header_len),
                                         ctypes.byref(payload_len))
            if rc == -1:
                continue           # clean timeout: keep polling
            if rc != 0:
                break              # closed / torn / corrupt: drop conn
            if payload_len.value > self._max_payload:
                break              # oversized advert: drop conn (cap
                                   # peer-driven allocations)
            header = ctypes.create_string_buffer(header_len.value)
            payload = (ctypes.c_char * payload_len.value)()
            if self._lib.tp_recv_body(
                    fd, header, header_len.value,
                    ctypes.cast(payload, ctypes.c_void_p),
                    payload_len.value, 5000) != 0:
                break                              # torn frame: drop conn
            try:
                name, dtype, shape = decode_header(header.raw)
                # Zero-copy view: the ctypes buffer is a fresh
                # per-frame allocation nothing else retains.
                array = np.frombuffer(payload, dtype=dtype) \
                    .reshape(shape)
            except Exception:
                # Corrupt/hostile header (np.dtype raises TypeError,
                # a non-dict body AttributeError, ...): skip the frame
                # -- never let it kill the reader thread, which would
                # leak the fd and silently deaden the connection.
                continue
            self._enqueue((name, array), fd)
        self._lib.tp_close(fd)
        self._readers[:] = [(f, t) for f, t in self._readers
                            if f != fd]

    # -- API ---------------------------------------------------------------

    def close(self, join: bool = True):
        """``join=False`` (the pipeline's teardown path) closes the
        sockets and returns immediately: the daemon threads exit on
        their next poll tick, and a stop() over many pipelines must
        not pay a join timeout per server."""
        self._closing.set()
        self._lib.tp_close(self._server_fd)
        if not join:
            return
        self._accept_thread.join(timeout=2.0)
        for _, reader in self._readers:
            reader.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *_):
        self.close()


# ---------------------------------------------------------------------------
# Pure-Python framing (same wire format over the stdlib socket module).

class PyTensorPipeClient:
    """``TensorPipeClient`` twin over ``socket``: identical wire frames,
    so either side may be native."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        try:
            self._sock = socket.create_connection(
                (_resolve(host), int(port)), timeout=timeout)
        except OSError as error:
            raise ConnectionError(f"tensor_pipe connect "
                                  f"{host}:{port} failed: {error}") \
                from error
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Bounded sends, like the C side's stall cap: a peer that
        # accepts no bytes for this long is wedged, and an unbounded
        # sendall would freeze the sending event loop forever instead
        # of letting the fallback/breaker machinery run.
        self._sock.settimeout(_SEND_STALL_S)
        self._lock = threading.Lock()

    def send(self, array, name: str = "") -> int:
        """Frame and send one array; returns the wire bytes written
        (prefix + header + payload -- callers' byte accounting)."""
        data = np.ascontiguousarray(np.asarray(array))
        header = encode_header(data, name)
        prefix = _PREFIX.pack(_MAGIC, len(header), data.nbytes)
        with self._lock:
            try:
                # One gather write for prefix+header, then the payload
                # straight from the array's buffer -- no staging copy.
                # Extension dtypes (bfloat16, float8_*) refuse the
                # buffer protocol; a same-memory uint8 view does not.
                self._sock.sendall(prefix + header)
                if data.nbytes:
                    raw = (data.reshape(1) if data.ndim == 0
                           else data).view(np.uint8)
                    self._sock.sendall(memoryview(raw))
            except OSError as error:
                raise ConnectionError(
                    f"tensor_pipe send failed (peer gone?): {error}") \
                    from error
        return len(prefix) + len(header) + data.nbytes

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *_):
        self.close()


class PyTensorPipeServer(_PipeServerMixin):
    """``TensorPipeServer`` twin over ``socket``: same accept/read
    threading model, same bounded drop-oldest queue, same counted
    drops."""

    _POLL_S = 0.2                     # mirrors the native 200 ms polls
    _BODY_TIMEOUT_S = 5.0

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 queue_depth: int = 64,
                 max_payload: int = _DEFAULT_MAX_PAYLOAD):
        self._max_payload = int(max_payload)
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._server.bind((_resolve(host), int(port)))
            self._server.listen(16)
        except OSError as error:
            self._server.close()
            raise OSError(f"tensor_pipe listen {host}:{port} "
                          f"failed: {error}") from error
        self._server.settimeout(self._POLL_S)
        self.port = self._server.getsockname()[1]
        self._init_queue(queue_depth)
        self._closing = threading.Event()
        self._readers: list = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="aiko.tensor_pipe.accept")
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                break                 # server socket closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            reader = threading.Thread(target=self._read_loop,
                                      args=(conn,), daemon=True,
                                      name="aiko.tensor_pipe.read")
            self._readers.append((conn, reader))
            reader.start()

    def _read_exact(self, conn, buffer: memoryview,
                    first_timeout: float | None) -> bool:
        """Fill ``buffer`` exactly.  ``first_timeout=None`` is the
        between-frames idle wait (poll forever in _POLL_S ticks, only
        the close flag ends it); a bounded ``first_timeout`` is a
        mid-frame read -- the first byte must arrive within it, and any
        stall after bytes started flowing tears the connection, as on
        the C side."""
        view = buffer
        started = False
        conn.settimeout(first_timeout if first_timeout is not None
                        else self._POLL_S)
        while len(view):
            try:
                got = conn.recv_into(view)
            except socket.timeout:
                if not started and first_timeout is None:
                    if self._closing.is_set():
                        return False
                    continue          # clean idle tick: keep waiting
                return False          # mid-frame stall: torn stream
            except OSError:
                return False
            if got == 0:
                return False          # peer closed
            if not started:
                started = True
                conn.settimeout(self._BODY_TIMEOUT_S)
            view = view[got:]
        return True

    def _read_loop(self, conn):
        connection_id = conn.fileno()
        prefix = bytearray(_PREFIX.size)
        while not self._closing.is_set():
            if not self._read_exact(conn, memoryview(prefix), None):
                break
            magic, header_len, payload_len = _PREFIX.unpack(bytes(prefix))
            if magic != _MAGIC or header_len > _MAX_HEADER \
                    or payload_len > self._max_payload:
                break                 # corrupt/oversized: drop conn
            header = bytearray(header_len)
            payload = bytearray(payload_len)
            if header_len and not self._read_exact(
                    conn, memoryview(header), self._BODY_TIMEOUT_S):
                break
            if payload_len and not self._read_exact(
                    conn, memoryview(payload), self._BODY_TIMEOUT_S):
                break
            try:
                name, dtype, shape = decode_header(bytes(header))
                array = np.frombuffer(payload, dtype=dtype) \
                    .reshape(shape)
            except Exception:
                continue              # corrupt header: skip the frame
            self._enqueue((name, array), connection_id)
        try:
            conn.close()
        except OSError:
            pass
        self._readers[:] = [(c, t) for c, t in self._readers
                            if c is not conn]

    def close(self, join: bool = True):
        self._closing.set()
        try:
            self._server.close()
        except OSError:
            pass
        if not join:
            return
        self._accept_thread.join(timeout=2.0)
        for conn, reader in list(self._readers):
            try:
                conn.close()
            except OSError:
                pass
            reader.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *_):
        self.close()
