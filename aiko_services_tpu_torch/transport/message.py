"""Abstract message transport (reference: src/aiko_services/main/message/
message.py:9-60).

A transport delivers (topic, payload) pairs.  Payloads are ``str`` on the
control plane (S-expressions); ``bytes`` are accepted for bulk/out-of-band
paths.  Implementations must invoke ``message_handler(topic, payload)`` for
each inbound message; handlers may be called from any thread -- the process
runtime re-posts onto the event engine.
"""

from __future__ import annotations

import enum
from typing import Callable

__all__ = ["Message", "MessageState", "topic_matches"]


class MessageState(enum.Enum):
    DISCONNECTED = "disconnected"
    CONNECTED = "connected"


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT-style matching: ``+`` one level, ``#`` trailing multi-level."""
    if pattern == topic:
        return True
    p_parts = pattern.split("/")
    t_parts = topic.split("/")
    for i, p in enumerate(p_parts):
        if p == "#":
            return True
        if i >= len(t_parts):
            return False
        if p != "+" and p != t_parts[i]:
            return False
    return len(p_parts) == len(t_parts)


class Message:
    """Transport interface."""

    def __init__(self, message_handler: Callable[[str, object], None] | None,
                 topics_subscribe=None, lwt_topic=None, lwt_payload=None,
                 lwt_retain=False):
        self._message_handler = message_handler
        self._subscriptions: set[str] = set(topics_subscribe or [])
        self._lwt = (lwt_topic, lwt_payload, lwt_retain)
        self.state = MessageState.DISCONNECTED
        self._state_handlers: list[Callable] = []

    # -- lifecycle ---------------------------------------------------------

    def connect(self):
        raise NotImplementedError

    def disconnect(self, send_will: bool = False):
        raise NotImplementedError

    # -- pub/sub -----------------------------------------------------------

    def publish(self, topic: str, payload, retain: bool = False,
                wait: bool = False):
        raise NotImplementedError

    def subscribe(self, topic: str):
        raise NotImplementedError

    def unsubscribe(self, topic: str):
        raise NotImplementedError

    def set_last_will_and_testament(self, topic, payload, retain=False):
        self._lwt = (topic, payload, retain)

    # Additional wills beyond the primary process LWT (e.g. the registrar
    # election record).  Loopback honors all of them on abnormal
    # disconnect; MQTT supports one will per connection, so there the
    # newest added will replaces the connection will (same tradeoff the
    # reference makes, reference mqtt.py:207-213).
    def add_will(self, name: str, topic, payload, retain=False):
        if not hasattr(self, "_wills"):
            self._wills = {}
        self._wills[name] = (topic, payload, retain)

    def remove_will(self, name: str):
        if hasattr(self, "_wills"):
            self._wills.pop(name, None)

    # -- state fan-out -----------------------------------------------------

    def add_state_handler(self, handler: Callable):
        self._state_handlers.append(handler)
        handler(self.state)

    def _set_state(self, state: MessageState):
        if state == self.state:
            return
        self.state = state
        for handler in list(self._state_handlers):
            handler(state)
