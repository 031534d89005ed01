"""Registrar: the discovery directory (reference: src/aiko_services/main/
registrar.py).

A leader-elected service that tracks every live Service in the namespace:

- election: start -> primary_search; if a retained ``(primary found ...)``
  arrives within the search window, become secondary, else self-promote and
  publish the retained boot record with an ``(primary absent)`` LWT
  (reference registrar.py:129-186).  Unlike the reference (which documents
  split-brain bugs, registrar.py:48-53), announcements carry the promotion
  timestamp and conflicts resolve deterministically: earliest timestamp
  (then lowest topic path) wins; losers demote.
- directory: ``(add topic name protocol transport owner (tags))`` /
  ``(remove topic)`` on ``topic/in``; every accepted change is re-published
  on ``topic/out`` for caches (reference registrar.py:241-307).
- failure detection: watches ``{ns}/+/+/+/state`` for the ``(absent)`` LWT
  and reaps all services of the dead process (reference
  registrar.py:235-239,331-354).
- queries: ``(share response_topic <filter...>)`` snapshot and
  ``(history response_topic count)`` from a ring buffer (reference
  registrar.py:261-307).
"""

from __future__ import annotations

import collections
import time

from .actor import Actor
from .service import (ServiceFilter, ServiceRecord, ServiceRegistry,
                      SERVICE_PROTOCOL_PREFIX)
from ..runtime import REGISTRAR_BOOT_VERSION
from ..utils import get_logger, generate, parse, parse_number

__all__ = ["Registrar", "REGISTRAR_PROTOCOL"]

_logger = get_logger("aiko.registrar")

REGISTRAR_PROTOCOL = f"{SERVICE_PROTOCOL_PREFIX}/registrar:0"
_HISTORY_RING_SIZE = 4096
_PRIMARY_SEARCH_TIMEOUT = 2.0


class Registrar(Actor):
    def __init__(self, name: str = "registrar", runtime=None,
                 primary_search_timeout: float = _PRIMARY_SEARCH_TIMEOUT):
        super().__init__(name, REGISTRAR_PROTOCOL, runtime=runtime)
        self.registry = ServiceRegistry()
        self._history: collections.deque = collections.deque(
            maxlen=_HISTORY_RING_SIZE)
        self.state = "start"
        self.promotion_timestamp: float | None = None
        self._search_timer = None
        self._search_timeout = primary_search_timeout
        self.share["service_count"] = 0
        self.share["state"] = self.state

        # Stale-primary detection: a secondary probes the claimed
        # primary; a retained ``(primary found)`` left behind by a
        # process that died without its will firing (e.g. graceful
        # disconnect mid-crash, broker restart) would otherwise pin
        # every registrar in secondary forever -- the condition the
        # reference clears by hand (reference scripts/system_reset.sh).
        self._primary_topic: str | None = None
        self._probe_pending = False
        self._probe_timer = None
        self._probe_interval = max(2.0, 2.0 * primary_search_timeout)
        self._probe_topic = f"{self.topic_path}/probe"
        self.runtime.add_message_handler(self._on_probe_response,
                                         self._probe_topic)

        self.runtime.add_message_handler(
            self._on_boot_topic, self.runtime.topic_registrar_boot)
        self.runtime.add_message_handler(
            self._on_service_state,
            f"{self.runtime.namespace}/+/+/+/state")
        self._enter_primary_search()

    # -- election ----------------------------------------------------------

    def _enter_primary_search(self):
        self._set_state("primary_search")
        self._search_timer = self.runtime.engine.add_oneshot_timer(
            self._promote, self._search_timeout)

    def _set_state(self, state: str):
        self.state = state
        self.share["state"] = state
        self.ec_producer.update("state", state)

    def _promote(self):
        if self.state != "primary_search":
            return
        self.promotion_timestamp = time.time()
        self._set_state("primary")
        message = self.runtime.message
        # Secondary will alongside the process LWT, not replacing it.
        message.add_will("registrar_boot",
                         self.runtime.topic_registrar_boot,
                         "(primary absent)", retain=True)
        self._publish_found()
        _logger.info("registrar %s promoted to primary", self.topic_path)
        # Register ourselves (process.on_registrar also fires for us).

    def _publish_found(self):
        self.runtime.message.publish(
            self.runtime.topic_registrar_boot,
            generate("primary", ["found", self.topic_path,
                                 REGISTRAR_BOOT_VERSION,
                                 self.promotion_timestamp]),
            retain=True)

    def _on_boot_topic(self, topic: str, payload):
        try:
            command, parameters = parse(payload)
        except Exception:
            return
        if command != "primary" or not parameters:
            return
        if parameters[0] == "found":
            other_topic = parameters[1] if len(parameters) > 1 else None
            other_time = parse_number(parameters[3], 0.0) \
                if len(parameters) > 3 else 0.0
            if other_topic == self.topic_path:
                return
            if self.state == "primary_search":
                if self._search_timer is not None:
                    self.runtime.engine.remove_timer_handler(
                        self._search_timer)
                self._set_state("secondary")
                self._watch_primary(other_topic)
                _logger.info("registrar %s is secondary to %s",
                             self.topic_path, other_topic)
            elif self.state == "secondary":
                self._watch_primary(other_topic)   # primary changed
            elif self.state == "primary":
                # Fencing: deterministic conflict resolution.
                mine = (self.promotion_timestamp or 0.0, self.topic_path)
                theirs = (float(other_time or 0.0), str(other_topic))
                if theirs < mine:
                    _logger.warning(
                        "registrar conflict: demoting %s in favor of %s",
                        self.topic_path, other_topic)
                    self._demote()
                    self._watch_primary(other_topic)
                else:
                    # I win: re-assert my retained record so the loser
                    # (whose record just overwrote mine) sees it, demotes,
                    # and the system converges to one primary.
                    _logger.warning(
                        "registrar conflict: %s re-asserting over %s",
                        self.topic_path, other_topic)
                    self._publish_found()
        elif parameters[0] == "absent":
            if self.state == "secondary":
                self._stop_probe()
                self._enter_primary_search()
            elif self.state == "primary":
                # A demoted/buggy peer's will clobbered my live record:
                # re-assert so bootstrapping processes find me.
                self._publish_found()

    def _demote(self):
        self._set_state("secondary")
        self.runtime.message.remove_will("registrar_boot")
        self.registry = ServiceRegistry()
        self.share["service_count"] = 0

    # -- stale-primary liveness probe --------------------------------------

    def _watch_primary(self, primary_topic: str):
        self._primary_topic = primary_topic
        self._probe_pending = False
        if self._probe_timer is None:
            self._probe_timer = self.runtime.engine.add_timer_handler(
                self._probe_primary, self._probe_interval)

    def _stop_probe(self):
        self._primary_topic = None
        self._probe_pending = False
        if self._probe_timer is not None:
            self.runtime.engine.remove_timer_handler(self._probe_timer)
            self._probe_timer = None

    def _probe_primary(self):
        if self.state != "secondary" or self._primary_topic is None:
            self._stop_probe()
            return
        if self._probe_pending:
            # A full interval passed with no answer: the retained
            # record is stale.  Clear it for the whole namespace and
            # stand for election.
            _logger.warning(
                "registrar %s: primary %s unresponsive; clearing stale "
                "record and re-entering election",
                self.topic_path, self._primary_topic)
            self.runtime.message.publish(
                self.runtime.topic_registrar_boot, "(primary absent)",
                retain=True)
            self._stop_probe()
            self._enter_primary_search()
            return
        self._probe_pending = True
        self.runtime.message.publish(
            f"{self._primary_topic}/in",
            generate("history", [self._probe_topic, 0]))

    def _on_probe_response(self, topic: str, payload):
        self._probe_pending = False

    # -- directory protocol (commands dispatched by the Actor layer) -------

    def add(self, *parameters):
        """(add topic name protocol transport owner (tags))"""
        if self.state != "primary" or len(parameters) < 5:
            return
        record = ServiceRecord.from_wire(list(parameters))
        self.registry.add(record)
        self._history_note("add", record)
        self.ec_producer.update("service_count", len(self.registry))
        self.publish_out("add", record.to_wire())

    def remove(self, *parameters):
        """(remove topic_path)"""
        if self.state != "primary" or not parameters:
            return
        topic_path = parameters[0]
        record = self.registry.get(topic_path)
        self.registry.remove(topic_path)
        if record is not None:
            self._history_note("remove", record)
        self.ec_producer.update("service_count", len(self.registry))
        self.publish_out("remove", [topic_path])

    def query(self, *parameters):
        """(query response_topic <filter...>) -- one-shot, no events."""
        self._respond_share(list(parameters))

    def _respond_share(self, parameters: list):
        if not parameters:
            return
        response_topic = parameters[0]
        service_filter = ServiceFilter.from_wire(parameters[1:]) \
            if len(parameters) > 1 else ServiceFilter()
        records = self.registry.query(service_filter)
        publish = self.runtime.message.publish
        publish(response_topic, generate("item_count", [len(records)]))
        for record in records:
            publish(response_topic, generate("add", record.to_wire()))
        publish(response_topic, generate("sync", [response_topic]))

    def history(self, *parameters):
        """(history response_topic count)"""
        if not parameters:
            return
        response_topic = parameters[0]
        count = int(parse_number(parameters[1], 32)) \
            if len(parameters) > 1 else 32
        entries = list(self._history)[-count:] if count > 0 else []
        publish = self.runtime.message.publish
        publish(response_topic, generate("item_count", [len(entries)]))
        for action, record, timestamp in entries:
            publish(response_topic,
                    generate("history",
                             [action, timestamp] + record.to_wire()))
        publish(response_topic, generate("sync", [response_topic]))

    def _history_note(self, action: str, record: ServiceRecord):
        self._history.append((action, record, time.time()))

    # -- registrar's own share query path ---------------------------------
    # The `share` command on topic/in is the directory query; on
    # topic/control it is the EC-producer protocol (handled by Actor).

    def _topic_in_handler(self, topic: str, payload):
        try:
            command, parameters = parse(payload)
        except Exception:
            return
        if command == "share":
            self._respond_share(parameters)
            return
        super()._topic_in_handler(topic, payload)

    # -- failure detection -------------------------------------------------

    def _on_service_state(self, topic: str, payload):
        if self.state != "primary":
            return
        try:
            command, _ = parse(payload)
        except Exception:
            return
        if command != "absent":
            return
        # topic = {ns}/{host}/{pid}/{sid}/state.  Only the process-level
        # service (id 0, the runtime's own LWT) means the whole process
        # died; a non-zero id announces just that one service's departure
        # (reference registrar.py:331-339).
        service_topic = topic.rsplit("/", 1)[0]
        service_id = service_topic.rsplit("/", 1)[1]
        if service_id != "0":
            record = self.registry.get(service_topic)
            if record is not None:
                self.registry.remove(service_topic)
                self._history_note("remove", record)
                self.publish_out("remove", [service_topic])
                self.ec_producer.update("service_count",
                                        len(self.registry))
            return
        process_topic = service_topic.rsplit("/", 1)[0]
        removed = self.registry.remove_process(process_topic)
        for record in removed:
            self._history_note("remove", record)
            self.publish_out("remove", [record.topic_path])
        if removed:
            self.ec_producer.update("service_count", len(self.registry))
            _logger.info("reaped %d services of dead process %s",
                         len(removed), process_topic)

    def stop(self):
        self._stop_probe()
        self.runtime.remove_message_handler(self._on_probe_response,
                                            self._probe_topic)
        if self.state == "primary":
            self.runtime.message.publish(
                self.runtime.topic_registrar_boot, "(primary absent)",
                retain=True)
        super().stop()
