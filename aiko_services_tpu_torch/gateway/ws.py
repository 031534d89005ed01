"""Minimal RFC 6455 WebSocket codec (stdlib only).

The gateway's session protocol needs exactly the core of the RFC:
the HTTP/1.1 upgrade handshake (client and server sides), text/binary
data frames with client-side masking, and the ping/pong/close control
opcodes.  No extensions, no compression, no fragmentation on send
(every frame is FIN); fragmented receives are reassembled.  Both the
server (gateway/server.py) and the in-tree client
(gateway/client.py, used by the load generator and tier-1 tests over
loopback) speak through these functions, so the protocol surface has
one implementation.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct

__all__ = ["OP_TEXT", "OP_BINARY", "OP_CLOSE", "OP_PING", "OP_PONG",
           "accept_key", "client_handshake", "server_handshake",
           "send_frame", "recv_frame", "recv_message", "WsClosed"]

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


class WsClosed(Exception):
    """The peer closed the connection (close frame or EOF)."""


def accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def client_handshake(sock: socket.socket, host: str, port: int,
                     path: str = "/v1/stream") -> None:
    """Send the upgrade request and validate the 101 response.
    Raises ConnectionError on anything but a correct accept."""
    key = base64.b64encode(os.urandom(16)).decode()
    request = (f"GET {path} HTTP/1.1\r\n"
               f"Host: {host}:{port}\r\n"
               "Upgrade: websocket\r\n"
               "Connection: Upgrade\r\n"
               f"Sec-WebSocket-Key: {key}\r\n"
               "Sec-WebSocket-Version: 13\r\n\r\n")
    sock.sendall(request.encode())
    reply = _read_head(sock)
    status = reply.split("\r\n", 1)[0]
    if " 101 " not in f"{status} ":
        raise ConnectionError(f"websocket upgrade refused: {status}")
    expected = accept_key(key)
    for line in reply.split("\r\n")[1:]:
        name, _, value = line.partition(":")
        if name.strip().lower() == "sec-websocket-accept" \
                and value.strip() == expected:
            return
    raise ConnectionError("websocket upgrade: bad Sec-WebSocket-Accept")


def server_handshake(headers: dict) -> bytes | None:
    """The 101 response bytes for an upgrade request's headers
    (lower-cased names), or None when this is not a websocket
    upgrade."""
    if "websocket" not in str(headers.get("upgrade", "")).lower():
        return None
    key = headers.get("sec-websocket-key")
    if not key:
        return None
    return ("HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(str(key).strip())}"
            "\r\n\r\n").encode()


def _read_head(sock: socket.socket) -> str:
    """Read up to the blank line ending an HTTP head."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("connection closed during handshake")
        data += chunk
        if len(data) > 65536:
            raise ConnectionError("oversized handshake")
    return data.split(b"\r\n\r\n", 1)[0].decode("latin-1")


def send_frame(sock: socket.socket, payload: bytes | str,
               opcode: int | None = None, mask: bool = False) -> None:
    """One FIN frame.  Clients MUST mask (RFC 6455 §5.3); servers must
    not."""
    if isinstance(payload, str):
        payload = payload.encode()
        opcode = OP_TEXT if opcode is None else opcode
    else:
        opcode = OP_BINARY if opcode is None else opcode
    head = bytes([0x80 | opcode])
    length = len(payload)
    mask_bit = 0x80 if mask else 0
    if length < 126:
        head += bytes([mask_bit | length])
    elif length < 65536:
        head += bytes([mask_bit | 126]) + struct.pack(">H", length)
    else:
        head += bytes([mask_bit | 127]) + struct.pack(">Q", length)
    if mask:
        key = os.urandom(4)
        body = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        sock.sendall(head + key + body)
    else:
        sock.sendall(head + payload)


def _read_exact(sock: socket.socket, count: int) -> bytes:
    data = b""
    while len(data) < count:
        chunk = sock.recv(count - len(data))
        if not chunk:
            raise WsClosed("connection closed mid-frame")
        data += chunk
    return data


#: default bound on one received frame AND one reassembled message --
#: the unauthenticated front door must not buffer an attacker-chosen
#: 64-bit length (or endless continuation fragments) into RAM before
#: any admission check runs.  Raising past it is a protocol violation:
#: the connection dies (WsClosed), never the process.
MAX_PAYLOAD_DEFAULT = 64 << 20


def recv_frame(sock: socket.socket,
               max_payload: int = MAX_PAYLOAD_DEFAULT) \
        -> tuple[int, bool, bytes]:
    """One wire frame -> (opcode, fin, unmasked payload)."""
    head = _read_exact(sock, 2)
    fin = bool(head[0] & 0x80)
    opcode = head[0] & 0x0F
    masked = bool(head[1] & 0x80)
    length = head[1] & 0x7F
    if length == 126:
        length = struct.unpack(">H", _read_exact(sock, 2))[0]
    elif length == 127:
        length = struct.unpack(">Q", _read_exact(sock, 8))[0]
    if max_payload and length > max_payload:
        raise WsClosed(f"frame of {length} bytes exceeds the "
                       f"{max_payload}-byte bound")
    key = _read_exact(sock, 4) if masked else None
    payload = _read_exact(sock, length) if length else b""
    if key is not None:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, fin, payload


def recv_message(sock: socket.socket,
                 respond_control: bool = True,
                 mask_replies: bool = False,
                 max_payload: int = MAX_PAYLOAD_DEFAULT,
                 on_frame=None) -> tuple[int, bytes]:
    """The next DATA message (text/binary), reassembling continuation
    frames and answering pings in line.  Raises :class:`WsClosed` on a
    close frame, EOF, or a frame/message past ``max_payload``.
    ``on_frame(opcode)`` fires for every wire frame received --
    control frames included, which is how the gateway's idle-session
    reaper sees a client's pong as liveness."""
    opcode, payload = None, b""
    while True:
        frame_op, fin, chunk = recv_frame(sock, max_payload=max_payload)
        if on_frame is not None:
            on_frame(frame_op)
        if frame_op == OP_CLOSE:
            if respond_control:
                try:
                    send_frame(sock, chunk, OP_CLOSE,
                               mask=mask_replies)
                except OSError:
                    pass
            raise WsClosed("close frame")
        if frame_op == OP_PING:
            if respond_control:
                send_frame(sock, chunk, OP_PONG, mask=mask_replies)
            continue
        if frame_op == OP_PONG:
            continue
        if frame_op in (OP_TEXT, OP_BINARY):
            opcode = frame_op
        elif frame_op != OP_CONT or opcode is None:
            raise WsClosed(f"unexpected opcode {frame_op}")
        payload += chunk
        if max_payload and len(payload) > max_payload:
            # continuation fragments must not sidestep the per-frame
            # bound by arriving small and endless
            raise WsClosed(f"message exceeds the {max_payload}-byte "
                           f"bound")
        if fin:
            return opcode, payload
