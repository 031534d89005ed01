"""In-memory message broker with full MQTT semantics.

The reference falls back to a null transport when no broker is present
(src/aiko_services/main/message/castaway.py), which means offline tests
can't exercise discovery/registrar behavior.  This loopback broker instead
implements retained messages, ``+``/``#`` wildcards and last-will-and-
testament in-process, so an entire multi-service system -- registrar
election, EC share leases, remote pipelines -- runs and is testable with
zero infrastructure.  It is also the single-host fast path: control
messages skip serialization to a socket entirely.
"""

from __future__ import annotations

import threading
from typing import Callable

from .message import Message, MessageState, topic_matches

__all__ = ["LoopbackBroker", "LoopbackMessage", "get_broker", "reset_broker"]


class LoopbackBroker:
    """Process-wide broker.  Thread-safe; delivery is synchronous on the
    publisher's thread (subscribers re-post onto their event loops)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._clients: list["LoopbackMessage"] = []
        self._retained: dict[str, object] = {}
        # Chaos harness hook (aiko_services_tpu_torch/faults): when set,
        # every publish passes through ``filter(topic, payload) ->
        # (topic, payload) | None`` (None = drop) BEFORE retention and
        # delivery -- wire-level drop/delay/duplicate/corrupt faults
        # exercised on the real message path.  None (the default) costs
        # one attribute read per publish.
        self._fault_filter = None

    def attach(self, client: "LoopbackMessage"):
        with self._lock:
            if client not in self._clients:
                self._clients.append(client)

    def detach(self, client: "LoopbackMessage", send_will: bool):
        with self._lock:
            if client in self._clients:
                self._clients.remove(client)
        if send_will:
            topic, payload, retain = client._lwt
            if topic:
                self.publish(topic, payload, retain)
            for topic, payload, retain in getattr(client, "_wills",
                                                  {}).values():
                self.publish(topic, payload, retain)

    def set_fault_filter(self, fault_filter) -> None:
        """Install (or clear, with None) the wire fault filter."""
        with self._lock:
            self._fault_filter = fault_filter

    def publish(self, topic: str, payload, retain: bool = False):
        fault_filter = self._fault_filter
        if fault_filter is not None:
            passed = fault_filter(topic, payload)
            if passed is None:
                return                  # injected wire drop/delay
            topic, payload = passed
        self.publish_direct(topic, payload, retain)

    def publish_direct(self, topic: str, payload, retain: bool = False):
        """Publish bypassing the fault filter -- delayed/duplicated
        redelivery from the filter itself must not re-enter it."""
        if retain:
            with self._lock:
                if payload in (None, "", b""):
                    self._retained.pop(topic, None)
                else:
                    self._retained[topic] = payload
        with self._lock:
            clients = list(self._clients)
        for client in clients:
            client._deliver(topic, payload)

    def retained_for(self, pattern: str) -> list[tuple[str, object]]:
        with self._lock:
            return [(t, p) for t, p in self._retained.items()
                    if topic_matches(pattern, t)]

    def clear(self):
        with self._lock:
            self._clients.clear()
            self._retained.clear()
            self._fault_filter = None


_BROKER = LoopbackBroker()


def get_broker() -> LoopbackBroker:
    return _BROKER


def reset_broker():
    """Test isolation: drop all clients and retained state."""
    _BROKER.clear()


class LoopbackMessage(Message):
    def __init__(self, message_handler=None, topics_subscribe=None,
                 lwt_topic=None, lwt_payload=None, lwt_retain=False,
                 broker: LoopbackBroker | None = None):
        super().__init__(message_handler, topics_subscribe,
                         lwt_topic, lwt_payload, lwt_retain)
        self._broker = broker or _BROKER

    def connect(self):
        self._broker.attach(self)
        self._set_state(MessageState.CONNECTED)
        for pattern in list(self._subscriptions):
            self._send_retained(pattern)

    def disconnect(self, send_will: bool = False):
        self._broker.detach(self, send_will)
        self._set_state(MessageState.DISCONNECTED)

    def publish(self, topic, payload, retain=False, wait=False):
        self._broker.publish(topic, payload, retain)

    def subscribe(self, topic):
        self._subscriptions.add(topic)
        # Retained messages re-deliver on every subscribe, as MQTT does --
        # a late-registered handler (e.g. a second registrar) must see the
        # retained election record.
        if self.state == MessageState.CONNECTED:
            self._send_retained(topic)

    def unsubscribe(self, topic):
        self._subscriptions.discard(topic)

    def _send_retained(self, pattern: str):
        for topic, payload in self._broker.retained_for(pattern):
            self._deliver(topic, payload, check=False,
                          only_pattern=pattern)

    def _deliver(self, topic, payload, check=True, only_pattern=None):
        if self._message_handler is None:
            return
        patterns = ([only_pattern] if only_pattern
                    else list(self._subscriptions))
        for pattern in patterns:
            if topic_matches(pattern, topic):
                self._message_handler(topic, payload)
                return
