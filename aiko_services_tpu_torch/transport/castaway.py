"""Null transport: accepts every call, delivers nothing (reference:
src/aiko_services/main/message/castaway.py).  Used when a process must run
fully detached from any fabric."""

from __future__ import annotations

from .message import Message, MessageState

__all__ = ["CastawayMessage"]


class CastawayMessage(Message):
    def connect(self):
        self._set_state(MessageState.CONNECTED)

    def disconnect(self, send_will: bool = False):
        self._set_state(MessageState.DISCONNECTED)

    def publish(self, topic, payload, retain=False, wait=False):
        pass

    def subscribe(self, topic):
        self._subscriptions.add(topic)

    def unsubscribe(self, topic):
        self._subscriptions.discard(topic)
