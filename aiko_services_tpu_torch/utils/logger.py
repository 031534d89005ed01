"""Logging: console + pluggable distributed handler.

Mirrors the reference surface (src/aiko_services/main/utilities/logger.py:
104-216): per-module loggers controlled by ``AIKO_LOG_LEVEL`` /
``AIKO_LOG_LEVEL_<SUBSYSTEM>`` env vars, and a transport-backed handler that
ring-buffers records until the transport connects and collapses repeated
messages.  The transport handler publishes to the service's ``log`` topic so
the dashboard/recorder can tail any process in the namespace.
"""

from __future__ import annotations

import collections
import logging
import os
import time

__all__ = ["get_logger", "TransportLogHandler", "LOG_FORMAT"]

LOG_FORMAT = "%(asctime)s %(levelname)-5s %(name)s: %(message)s"
_DATE_FORMAT = "%H:%M:%S"


def _level_for(name: str) -> str:
    subsystem = name.rsplit(".", 1)[-1].upper()
    return (os.environ.get(f"AIKO_LOG_LEVEL_{subsystem}")
            or os.environ.get("AIKO_LOG_LEVEL")
            or "INFO").upper()


def get_logger(name: str, level: str | None = None,
               handler: logging.Handler | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level or _level_for(name))
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter(LOG_FORMAT, _DATE_FORMAT))
        logger.addHandler(console)
        logger.propagate = False
    if handler is not None:
        logger.addHandler(handler)
    return logger


class TransportLogHandler(logging.Handler):
    """Publishes log records to a topic once a transport is connected;
    buffers (bounded ring) beforehand; collapses immediate repeats."""

    RING_SIZE = 128

    def __init__(self, publish_fn, topic: str):
        super().__init__()
        self._publish = publish_fn          # fn(topic, payload)
        self._topic = topic
        self._connected = False
        self._ring: collections.deque = collections.deque(maxlen=self.RING_SIZE)
        self._last_message: str | None = None
        self._repeat_count = 0
        self.setFormatter(logging.Formatter(LOG_FORMAT, _DATE_FORMAT))

    def on_connected(self):
        self._connected = True
        while self._ring:
            self._publish(self._topic, self._ring.popleft())

    def on_disconnected(self):
        self._connected = False

    def emit(self, record: logging.LogRecord):
        try:
            message = self.format(record)
        except Exception:            # pragma: no cover - formatter errors
            return
        if message == self._last_message:
            self._repeat_count += 1
            if self._repeat_count % 16:
                return
            message = f"[repeated x{self._repeat_count}] {message}"
        else:
            if self._repeat_count and self._repeat_count % 16:
                # Flush suppressed repeats before switching messages.
                self._send(f"[repeated x{self._repeat_count}] "
                           f"{self._last_message}")
            self._last_message = message
            self._repeat_count = 0
        self._send(message)

    def _send(self, message: str):
        if self._connected:
            try:
                self._publish(self._topic, message)
            except Exception:        # pragma: no cover - transport races
                self._ring.append(message)
        else:
            self._ring.append(message)


class RateLimiter:
    """Token bucket used to keep telemetry off the hot path: allows
    ``rate`` events/second with a small burst."""

    def __init__(self, rate: float, burst: int = 8):
        self._rate = rate
        self._burst = burst
        self._tokens = float(burst)
        self._stamp = time.monotonic()

    def allow(self) -> bool:
        now = time.monotonic()
        self._tokens = min(self._burst,
                           self._tokens + (now - self._stamp) * self._rate)
        self._stamp = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False
