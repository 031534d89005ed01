"""Connection-state ladder (reference: src/aiko_services/main/
connection.py:29-83): NONE -> NETWORK -> BOOTSTRAP -> TRANSPORT ->
REGISTRAR, with handler fan-out on every transition."""

from __future__ import annotations

import enum
from typing import Callable

__all__ = ["ConnectionState", "Connection"]


class ConnectionState(enum.IntEnum):
    NONE = 0
    NETWORK = 1
    BOOTSTRAP = 2
    TRANSPORT = 3
    REGISTRAR = 4


class Connection:
    def __init__(self):
        self._state = ConnectionState.NONE
        self._handlers: list[Callable] = []

    @property
    def state(self) -> ConnectionState:
        return self._state

    def connected(self, state: ConnectionState) -> bool:
        return self._state >= state

    def add_handler(self, handler: Callable):
        self._handlers.append(handler)
        handler(self, self._state)

    def remove_handler(self, handler: Callable):
        if handler in self._handlers:
            self._handlers.remove(handler)

    def update(self, state: ConnectionState):
        if state == self._state:
            return
        self._state = state
        for handler in list(self._handlers):
            handler(self, state)
