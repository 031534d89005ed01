"""Pure-stdlib MQTT 3.1.1 client with the (small) paho surface the
transport layer uses -- so the MQTT control plane works in images where
paho-mqtt is not installed (the reference hard-depends on paho,
reference message/mqtt.py:44; this framework degrades gracefully).

Supported: CONNECT with will/username/password/keepalive, PUBLISH QoS 0
(+ retain), SUBSCRIBE/UNSUBSCRIBE, PINGREQ keepalive, TLS via ssl,
auto-reconnect with backoff while the network loop runs.  Not
supported: QoS 1/2 sending (the control plane is QoS 0 end to end);
inbound QoS 1 is acknowledged and delivered.

Pairs with the in-tree C++ broker (native/mqtt_broker.cpp) but speaks
standard MQTT -- mosquitto etc. work unchanged.
"""

from __future__ import annotations

import socket
import ssl
import struct
import threading
import time

from ..utils import get_logger

__all__ = ["Client"]

_logger = get_logger("aiko.mini_mqtt")

CONNECT, CONNACK, PUBLISH, PUBACK = 0x10, 0x20, 0x30, 0x40
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = 0x82, 0x90, 0xa2, 0xb0
PINGREQ, PINGRESP, DISCONNECT = 0xc0, 0xd0, 0xe0

KEEPALIVE = 60
RECONNECT_DELAY_MAX = 8.0


def _string(value: str | bytes) -> bytes:
    data = value.encode() if isinstance(value, str) else bytes(value)
    return struct.pack(">H", len(data)) + data


def _remaining_length(length: int) -> bytes:
    out = bytearray()
    while True:
        digit = length % 128
        length //= 128
        out.append(digit | 0x80 if length else digit)
        if not length:
            return bytes(out)


class _ReceivedMessage:
    __slots__ = ("topic", "payload")

    def __init__(self, topic: str, payload: bytes):
        self.topic = topic
        self.payload = payload


class _PublishInfo:
    """paho-compatible handle; QoS 0 publishes are done at send."""

    def wait_for_publish(self, timeout=None):
        return True


class Client:
    """Mirrors the paho.mqtt.client.Client subset in transport/mqtt.py:
    callbacks ``on_connect/on_disconnect/on_message``, ``will_set``,
    ``username_pw_set``, ``tls_set``, ``connect_async`` + ``loop_start``,
    ``publish/subscribe/unsubscribe``, ``loop_stop``, ``disconnect``."""

    def __init__(self, *args, **kwargs):
        self.on_connect = None
        self.on_disconnect = None
        self.on_message = None
        self._host = None
        self._port = 1883
        self._will = None                 # (topic, payload, retain)
        self._auth = None                 # (username, password)
        self._tls = False
        self._socket = None
        self._socket_lock = threading.Lock()
        self._thread = None
        self._running = False
        self._packet_id = 0
        self._client_id = f"aiko-{socket.gethostname()}-{id(self):x}"

    # -- configuration (pre-connect) ---------------------------------------

    def will_set(self, topic, payload=None, qos=0, retain=False):
        self._will = (topic, payload or "", retain)

    def username_pw_set(self, username, password=None):
        self._auth = (username, password)

    def tls_set(self, *args, **kwargs):
        self._tls = True

    # -- lifecycle ----------------------------------------------------------

    def connect_async(self, host, port=1883, keepalive=KEEPALIVE):
        self._host = host
        self._port = port

    def loop_start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._running = True
        self._thread = threading.Thread(
            target=self._network_loop, daemon=True,
            name="aiko.mini_mqtt.loop")
        self._thread.start()

    def loop_stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def disconnect(self):
        self._running = False
        with self._socket_lock:
            if self._socket is not None:
                try:
                    self._socket.sendall(bytes([DISCONNECT, 0]))
                except OSError:
                    pass
                self._close_socket()

    # -- client operations ---------------------------------------------------

    def publish(self, topic, payload=None, qos=0, retain=False):
        if isinstance(payload, str):
            payload = payload.encode()
        body = _string(topic) + (payload or b"")
        header = PUBLISH | (0x01 if retain else 0x00)
        self._send(bytes([header]) + _remaining_length(len(body)) + body)
        return _PublishInfo()

    def subscribe(self, topic, qos=0):
        self._packet_id = (self._packet_id % 0xffff) + 1
        body = struct.pack(">H", self._packet_id) + _string(topic) \
            + bytes([0])
        self._send(bytes([SUBSCRIBE])
                   + _remaining_length(len(body)) + body)

    def unsubscribe(self, topic):
        self._packet_id = (self._packet_id % 0xffff) + 1
        body = struct.pack(">H", self._packet_id) + _string(topic)
        self._send(bytes([UNSUBSCRIBE])
                   + _remaining_length(len(body)) + body)

    # -- wire ---------------------------------------------------------------

    def _send(self, packet: bytes):
        with self._socket_lock:
            if self._socket is None:
                return                    # dropped; QoS 0 semantics
            try:
                self._socket.sendall(packet)
            except OSError:
                self._close_socket()

    def _close_socket(self):
        # Callers hold _socket_lock.
        if self._socket is not None:
            try:
                self._socket.close()
            except OSError:
                pass
            self._socket = None

    def _connect_packet(self) -> bytes:
        flags = 0x02                      # clean session
        payload = _string(self._client_id)
        if self._will is not None:
            topic, will_payload, retain = self._will
            flags |= 0x04 | (0x20 if retain else 0x00)
            payload += _string(topic) + _string(will_payload)
        if self._auth is not None:
            username, password = self._auth
            flags |= 0x80
            payload += _string(username)
            if password is not None:
                flags |= 0x40
                payload += _string(password)
        body = (_string("MQTT") + bytes([4, flags])
                + struct.pack(">H", KEEPALIVE) + payload)
        return bytes([CONNECT]) + _remaining_length(len(body)) + body

    def _network_loop(self):
        delay = 0.25
        while self._running:
            try:
                self._connect_once()
                delay = 0.25              # healthy session completed
            except OSError as error:
                _logger.debug("mqtt connect/read error: %s", error)
            except Exception:
                # A malformed packet (struct.error etc.) must reconnect
                # like a socket error, not silently kill this thread
                # while the transport still reports CONNECTED.
                _logger.exception("mqtt session error; reconnecting")
            if self.on_disconnect is not None:
                try:
                    self.on_disconnect(self, None)
                except Exception:
                    _logger.exception("on_disconnect handler failed")
            if self._running:
                time.sleep(delay)
                delay = min(delay * 2, RECONNECT_DELAY_MAX)

    def _connect_once(self):
        sock = socket.create_connection((self._host, self._port),
                                        timeout=5.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._tls:
            sock = ssl.create_default_context().wrap_socket(
                sock, server_hostname=self._host)
        sock.settimeout(KEEPALIVE / 2.0)
        with self._socket_lock:
            self._socket = sock
        try:
            sock.sendall(self._connect_packet())
            self._read_loop(sock)
        finally:
            with self._socket_lock:
                self._close_socket()

    def _read_exact(self, sock, count: int) -> bytes:
        data = b""
        while len(data) < count:
            chunk = sock.recv(count - len(data))
            if not chunk:
                raise OSError("connection closed")
            data += chunk
        return data

    def _read_loop(self, sock):
        while self._running:
            try:
                header = self._read_exact(sock, 1)[0]
            except socket.timeout:
                self._send(bytes([PINGREQ, 0]))    # keepalive
                continue
            remaining, multiplier = 0, 1
            for _ in range(4):
                digit = self._read_exact(sock, 1)[0]
                remaining += (digit & 0x7f) * multiplier
                multiplier *= 128
                if not digit & 0x80:
                    break
            else:
                raise OSError("malformed remaining length")
            body = self._read_exact(sock, remaining) if remaining else b""
            self._handle(header, body)

    def _handle(self, header: int, body: bytes):
        packet_type = header & 0xf0
        if packet_type == CONNACK:
            return_code = body[1] if len(body) >= 2 else 1
            if return_code == 0 and self.on_connect is not None:
                try:
                    self.on_connect(self, None, None, 0)
                except Exception:
                    _logger.exception("on_connect handler failed")
            elif return_code != 0:
                raise OSError(f"CONNACK refused rc={return_code}")
        elif packet_type == PUBLISH:
            qos = (header >> 1) & 0x03
            topic_length = struct.unpack(">H", body[:2])[0]
            topic = body[2:2 + topic_length].decode("utf-8", "replace")
            at = 2 + topic_length
            if qos > 0:                   # ack inbound QoS 1
                packet_id = body[at:at + 2]
                at += 2
                self._send(bytes([PUBACK, 2]) + packet_id)
            if self.on_message is not None:
                try:
                    self.on_message(self, None,
                                    _ReceivedMessage(topic, body[at:]))
                except Exception:
                    _logger.exception("on_message handler failed")
        # SUBACK/UNSUBACK/PINGRESP/PUBACK need no action at QoS 0.
