"""Recorder service: namespace-wide log aggregation (reference:
src/aiko_services/main/recorder.py:42-95).

Subscribes ``{namespace}/+/+/+/log``, keeps a bounded ring buffer of recent
lines per source service in an LRU (so at most ``MAX_SOURCES`` noisy
services are retained), and republishes the aggregate through its own
``share`` dict so any ECConsumer (dashboard, tests, remote tools) can watch
the whole system's logs without subscribing to every topic itself.
"""

from __future__ import annotations

import collections

from .actor import Actor
from ..utils import get_logger, LRUCache

__all__ = ["Recorder", "PROTOCOL_RECORDER"]

_logger = get_logger("aiko.recorder")

PROTOCOL_RECORDER = "recorder:0"


class Recorder(Actor):
    MAX_SOURCES = 64          # LRU capacity: distinct services retained
    RING_SIZE = 256           # log lines kept per service

    def __init__(self, name: str = "recorder", runtime=None,
                 ring_size: int | None = None):
        super().__init__(name, PROTOCOL_RECORDER, tags=["ec=true"],
                         runtime=runtime)
        self.ring_size = ring_size or self.RING_SIZE
        self._rings = LRUCache(self.MAX_SOURCES)
        self.share["source_count"] = 0
        self.share["line_count"] = 0
        self._line_count = 0
        self._log_pattern = f"{self.runtime.namespace}/+/+/+/log"
        self.runtime.add_message_handler(self._on_log, self._log_pattern)

    def _on_log(self, topic: str, payload):
        # topic = {ns}/{host}/{pid}/{service_id}/log
        source = topic.rsplit("/", 1)[0]
        ring = self._rings.get(source)
        if ring is None:
            ring = collections.deque(maxlen=self.ring_size)
            self._rings.put(source, ring)
            self.ec_producer.update("source_count", len(self._rings))
        ring.append(str(payload))
        self._line_count += 1
        # Telemetry about telemetry must stay cheap: update the share
        # count at a coarse stride, not per line.
        if self._line_count % 64 == 0:
            self.ec_producer.update("line_count", self._line_count)

    # -- query API (local and wire-invocable) ------------------------------

    def sources(self) -> list[str]:
        return [source for source, _ in self._rings.items()]

    def tail(self, source: str, count: int = 32) -> list[str]:
        ring = self._rings.get(source)
        if ring is None:
            return []
        return list(ring)[-int(count):]

    def replay(self, response_topic, source, count="32"):
        """Wire-invocable: publish ``(item_count N)`` + N ``(line ...)``
        entries from a source's ring to ``response_topic`` (the
        do_request pattern)."""
        lines = self.tail(str(source), int(float(count)))
        publish = self.runtime.message.publish
        from ..utils import generate
        publish(response_topic, generate("item_count", [len(lines)]))
        for line in lines:
            publish(response_topic, generate("line", [line]))

    def stop(self):
        self.runtime.remove_message_handler(self._on_log, self._log_pattern)
        super().stop()
