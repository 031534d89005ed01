"""Stdlib WebSocket client for the gateway session protocol.

The tier-1 acceptance path ("a real WebSocket client streams N frames
through a placed pipeline and receives N in-order results") runs this
client against :class:`~.server.GatewayServer` over loopback; the
load generator drives many of them concurrently.  It is a thin,
synchronous wrapper over the shared RFC 6455 codec in
:mod:`~aiko_services_tpu_torch.gateway.ws` -- client side, so every frame it
sends is masked.
"""

from __future__ import annotations

import json
import socket

from . import ws

__all__ = ["GatewayClient"]


class GatewayClient:
    def __init__(self, host: str, port: int,
                 path: str = "/v1/stream",
                 timeout: float | None = 30.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        ws.client_handshake(self.sock, host, port, path)
        self.session_id: str | None = None
        self.token: str | None = None

    # -- protocol ----------------------------------------------------------

    def send(self, payload: dict) -> None:
        ws.send_frame(self.sock, json.dumps(payload), mask=True)

    def recv(self, timeout: float | None = None) -> dict:
        """Next protocol message (result/busy/rejected/...); raises
        ``ws.WsClosed`` when the server closes, ``socket.timeout`` on
        the deadline."""
        if timeout is not None:
            self.sock.settimeout(timeout)
        _, payload = ws.recv_message(self.sock, mask_replies=True)
        return json.loads(payload.decode())

    def open(self, session: str | None = None, tenant: str = "default",
             qos_class: str | None = None,
             deadline_ms: float | None = None,
             window: int | None = None,
             token: str | None = None,
             timeout: float | None = 10.0) -> dict:
        """Open (or, with the ``token`` from a previous ``opened``
        ack, ATTACH to) a session.  The returned reply carries the
        session's attach token -- also kept on ``self.token``."""
        message: dict = {"op": "open", "tenant": tenant}
        if session is not None:
            message["session"] = session
        if qos_class is not None:
            message["class"] = qos_class
        if deadline_ms is not None:
            message["deadline_ms"] = deadline_ms
        if window is not None:
            message["window"] = window
        if token is not None:
            message["token"] = token
        self.send(message)
        reply = self.recv(timeout)
        if reply.get("op") != "opened":
            raise ConnectionError(f"open failed: {reply}")
        self.session_id = reply.get("session")
        self.token = reply.get("token")
        return reply

    def send_frame(self, data: dict, tag=None) -> None:
        message: dict = {"op": "frame", "data": data}
        if tag is not None:
            message["tag"] = tag
        self.send(message)

    def next_result(self, timeout: float | None = 30.0) -> dict:
        """Skip to the next ``result`` message (busy/rejected and
        other interleaved notifications are returned by ``recv``;
        this helper drops them -- use ``recv`` when they matter)."""
        while True:
            message = self.recv(timeout)
            if message.get("op") == "result":
                return message

    def close(self, timeout: float | None = 10.0) -> None:
        try:
            self.send({"op": "close"})
            while True:
                if self.recv(timeout).get("op") == "closed":
                    break
        except (ws.WsClosed, OSError):
            pass
        finally:
            try:
                self.sock.close()
            except OSError:
                pass

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()
