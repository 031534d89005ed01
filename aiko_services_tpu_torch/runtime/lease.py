"""Timer-based leases with optional auto-extension (reference:
src/aiko_services/main/lease.py:39-89).  A lease expires after
``lease_time`` seconds unless extended; auto-extend re-arms at 80% of the
period.  Used for stream grace-times, EC share consumers, and lifecycle
handshakes -- the framework's liveness primitive."""

from __future__ import annotations

import time
from typing import Callable

__all__ = ["Lease"]


class Lease:
    def __init__(self, engine, lease_time: float, lease_uuid,
                 expired_handler: Callable | None = None,
                 automatic_extend: bool = False,
                 extend_handler: Callable | None = None):
        self._engine = engine
        self.lease_time = lease_time
        self.lease_uuid = lease_uuid
        self._expired_handler = expired_handler
        self._automatic_extend = automatic_extend
        self._extend_handler = extend_handler
        self._expiry = time.monotonic() + lease_time
        self._timer = None
        self._terminated = False
        self._arm()

    def _arm(self):
        delay = (self.lease_time * 0.8 if self._automatic_extend
                 else max(0.0, self._expiry - time.monotonic()))
        self._timer = self._engine.add_oneshot_timer(self._on_timer, delay)

    def _on_timer(self):
        if self._terminated:
            return
        if self._automatic_extend:
            self.extend()
            if self._extend_handler:
                self._extend_handler(self)
            self._arm()
            return
        if time.monotonic() >= self._expiry:
            self._terminated = True
            if self._expired_handler:
                self._expired_handler(self)
        else:
            self._arm()

    def extend(self, lease_time: float | None = None):
        if lease_time is not None:
            self.lease_time = lease_time
        self._expiry = time.monotonic() + self.lease_time
        if not self._automatic_extend and not self._terminated:
            # re-arm against the new expiry
            if self._timer is not None:
                self._engine.remove_timer_handler(self._timer)
            self._arm()

    def revive(self, lease_time: float | None = None):
        """Un-expire from inside an ``expired_handler``: re-arm for
        another period.  For handlers that decide the lease must live
        on -- e.g. a stream grace lease firing while frames are still
        in flight (``Pipeline._stream_lease_expired``)."""
        self._terminated = False
        self.extend(lease_time)

    def terminate(self):
        self._terminated = True
        if self._timer is not None:
            self._engine.remove_timer_handler(self._timer)
            self._timer = None

    @property
    def active(self) -> bool:
        return not self._terminated
