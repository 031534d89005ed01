"""Eventual-consistency shared state (reference: src/aiko_services/main/
share.py).

``ECProducer`` replicates a service's ``share`` dictionary to any number of
remote observers under leases: a consumer publishes
``(share response_topic lease_time filter)`` to the producer's control
topic; the producer answers on ``response_topic`` with ``(item_count N)``,
N x ``(add key value)``, ``(sync response_topic)``, then pushes incremental
``(add/update/remove ...)`` while the lease lives (reference
share.py:221-352).  Consumers auto-extend by re-issuing ``share`` before
expiry (reference: 300 s leases, share.py:92).

``ECConsumer`` is the mirror image; ``ServicesCache`` composes an
ECConsumer-style query against the Registrar plus its live add/remove event
stream to maintain a local mirror of the service directory (reference
share.py:463-659).

Dotted item names address nested dictionaries two levels deep
(``"a.b"`` -> ``share["a"]["b"]``, reference share.py:121-125).
"""

from __future__ import annotations

import itertools
from typing import Callable

from .service import ServiceFilter, ServiceRecord, ServiceRegistry
from ..runtime import Lease
from ..utils import (get_logger, generate, generate_value, parse,
                     parse_value, parse_number)

__all__ = ["ECProducer", "ECConsumer", "ServicesCache",
           "EC_LEASE_TIME_DEFAULT"]

_logger = get_logger("aiko.share")

EC_LEASE_TIME_DEFAULT = 300.0     # seconds, matching the reference
_EC_COMMANDS = {"share", "update", "add", "remove", "sync", "lease_extend"}


def _dict_get(data: dict, name: str):
    if "." in name:
        head, _, rest = name.partition(".")
        inner = data.get(head)
        return inner.get(rest) if isinstance(inner, dict) else None
    return data.get(name)


def _dict_set(data: dict, name: str, value):
    if "." in name:
        head, _, rest = name.partition(".")
        data.setdefault(head, {})[rest] = value
    else:
        data[name] = value


def _dict_remove(data: dict, name: str):
    if "." in name:
        head, _, rest = name.partition(".")
        inner = data.get(head)
        if isinstance(inner, dict):
            inner.pop(rest, None)
    else:
        data.pop(name, None)


def _flatten(data: dict, prefix: str = ""):
    for key, value in data.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, f"{name}.")
        else:
            yield name, value


class ECProducer:
    """Attached to a Service; replicates its share dict to lease holders."""

    def __init__(self, service, share: dict,
                 lease_time: float = EC_LEASE_TIME_DEFAULT):
        self.service = service
        self.share = share
        self.lease_time = lease_time
        self._consumers: dict[str, Lease] = {}    # response_topic -> lease
        self._handlers: list[Callable] = []

    # -- local mutation (the producer-side API) ----------------------------

    def get(self, name: str):
        return _dict_get(self.share, name)

    def update(self, name: str, value):
        existed = _dict_get(self.share, name) is not None
        _dict_set(self.share, name, value)
        self._broadcast("update" if existed else "add", name, value)
        self._notify("update" if existed else "add", name, value)

    def remove(self, name: str):
        _dict_remove(self.share, name)
        self._broadcast("remove", name, None)
        self._notify("remove", name, None)

    def add_handler(self, handler: Callable):
        """handler(action, item_name, item_value) on every mutation,
        local or remote."""
        self._handlers.append(handler)

    def _notify(self, action, name, value):
        for handler in list(self._handlers):
            try:
                handler(action, name, value)
            except Exception:
                _logger.exception("EC handler failed")

    # -- remote protocol ---------------------------------------------------

    def handle_command(self, command: str, parameters: list) -> bool:
        """Called by the owning Actor for control-topic messages; returns
        True when the command belonged to the EC protocol."""
        if command not in _EC_COMMANDS:
            return False
        if command == "share":
            self._handle_share(parameters)
        elif command == "lease_extend":
            self._handle_lease_extend(parameters)
        elif command == "update" and len(parameters) >= 2:
            self.update(parameters[0], parameters[1])
        elif command == "add" and len(parameters) >= 2:
            self.update(parameters[0], parameters[1])
        elif command == "remove" and parameters:
            self.remove(parameters[0])
        return True

    def _handle_share(self, parameters: list):
        if not parameters:
            return
        response_topic = parameters[0]
        lease_time = parse_number(parameters[1], self.lease_time) \
            if len(parameters) > 1 else self.lease_time
        item_filter = parameters[2] if len(parameters) > 2 else "*"
        items = [(name, value) for name, value in _flatten(self.share)
                 if item_filter in ("*", "") or name == item_filter
                 or name.startswith(f"{item_filter}.")]
        publish = self.service.runtime.message.publish
        publish(response_topic, generate("item_count", [len(items)]))
        for name, value in items:
            publish(response_topic, generate("add", [name, value]))
        publish(response_topic, generate("sync", [response_topic]))
        self._grant_lease(response_topic, float(lease_time or
                                                self.lease_time))

    def _grant_lease(self, response_topic: str, lease_time: float):
        existing = self._consumers.get(response_topic)
        if existing:
            existing.extend(lease_time)
            return
        self._consumers[response_topic] = Lease(
            self.service.runtime.engine, lease_time, response_topic,
            expired_handler=self._lease_expired)

    def _handle_lease_extend(self, parameters: list):
        if not parameters:
            return
        response_topic = parameters[0]
        lease = self._consumers.get(response_topic)
        if lease:
            lease.extend()

    def _lease_expired(self, lease: Lease):
        self._consumers.pop(lease.lease_uuid, None)

    def _broadcast(self, action: str, name: str, value):
        publish = self.service.runtime.message.publish
        parameters = [name] if value is None else [name, value]
        payload = generate(action, parameters)
        for response_topic in list(self._consumers):
            publish(response_topic, payload)

    def consumer_count(self) -> int:
        return len(self._consumers)

    def terminate(self):
        for lease in self._consumers.values():
            lease.terminate()
        self._consumers.clear()


class ECConsumer:
    """Mirrors a remote service's share dict into ``self.cache``."""

    _ids = itertools.count()

    def __init__(self, runtime, target_topic_path: str, cache: dict,
                 item_filter: str = "*",
                 lease_time: float = EC_LEASE_TIME_DEFAULT):
        self.runtime = runtime
        self.cache = cache
        self.target_control = f"{target_topic_path}/control"
        self.item_filter = item_filter
        self.lease_time = lease_time
        self.synced = False
        self._handlers: list[Callable] = []
        uid = next(self._ids)
        self.response_topic = \
            f"{runtime.topic_path_process}/ec/{uid}"
        runtime.add_message_handler(self._on_message, self.response_topic)
        self._lease = Lease(runtime.engine, lease_time * 0.8, uid,
                            automatic_extend=True,
                            extend_handler=self._extend_remote)
        self._share()

    def _share(self):
        self.runtime.message.publish(
            self.target_control,
            generate("share", [self.response_topic, self.lease_time,
                               self.item_filter]))

    def _extend_remote(self, lease):
        self.runtime.message.publish(
            self.target_control,
            generate("lease_extend", [self.response_topic]))

    def _on_message(self, topic: str, payload):
        try:
            command, parameters = parse(payload)
        except Exception:
            return
        if command == "item_count":
            return
        if command == "sync":
            self.synced = True
            self._notify("sync", None, None)
            return
        if command in ("add", "update") and len(parameters) >= 2:
            _dict_set(self.cache, parameters[0], parameters[1])
            self._notify(command, parameters[0], parameters[1])
        elif command == "remove" and parameters:
            _dict_remove(self.cache, parameters[0])
            self._notify("remove", parameters[0], None)

    def add_handler(self, handler: Callable):
        self._handlers.append(handler)

    def _notify(self, action, name, value):
        for handler in list(self._handlers):
            try:
                handler(action, name, value)
            except Exception:
                _logger.exception("ECConsumer handler failed")

    def terminate(self):
        self._lease.terminate()
        self.runtime.remove_message_handler(self._on_message,
                                            self.response_topic)


class ServicesCache:
    """Local mirror of the Registrar's directory (reference
    share.py:463-659).  States: empty -> share -> loaded -> ready."""

    _ids = itertools.count()

    def __init__(self, runtime, service_filter: ServiceFilter | None = None):
        self.runtime = runtime
        self.registry = ServiceRegistry()
        self.state = "empty"
        self.filter = service_filter or ServiceFilter()
        self._handlers: list[tuple[Callable, Callable, ServiceFilter]] = []
        uid = next(self._ids)
        self.response_topic = f"{runtime.topic_path_process}/cache/{uid}"
        self._registrar_out: str | None = None
        self._pending = 0
        runtime.add_message_handler(self._on_response, self.response_topic)
        runtime.add_registrar_handler(self._on_registrar)

    # -- registrar connectivity -------------------------------------------

    def _on_registrar(self, registrar: dict | None):
        if self._registrar_out:
            self.runtime.remove_message_handler(self._on_event,
                                                self._registrar_out)
            self._registrar_out = None
        # Registrar lost OR changed: the mirror is stale either way.
        # Flip out of "ready" FIRST so purge-driven remove notifications
        # are distinguishable from genuine live removals, then purge.
        self.state = "empty"
        if len(self.registry):
            for record in self.registry.all():
                for add_h, remove_h, flt in list(self._handlers):
                    if remove_h and flt.matches(record):
                        remove_h(record)
            self.registry = ServiceRegistry()
        if registrar is None:
            return                 # stays "empty"
        self._registrar_out = f"{registrar['topic_path']}/out"
        self.runtime.add_message_handler(self._on_event, self._registrar_out)
        self.state = "share"
        self.runtime.message.publish(
            f"{registrar['topic_path']}/in",
            generate("share", [self.response_topic]
                     + self.filter.to_wire()))

    # -- share response ----------------------------------------------------

    def _on_response(self, topic: str, payload):
        try:
            command, parameters = parse(payload)
        except Exception:
            return
        if command == "item_count":
            self._pending = int(parse_number(parameters[0], 0))
            self.state = "loaded"
            if self._pending == 0:
                self.state = "ready"
            return
        if command == "add":
            self._add_record(ServiceRecord.from_wire(parameters))
            self._pending -= 1
            if self._pending <= 0:
                self.state = "ready"
        if command == "sync":
            self.state = "ready"

    # -- live events -------------------------------------------------------

    def _on_event(self, topic: str, payload):
        try:
            command, parameters = parse(payload)
        except Exception:
            return
        if command == "add" and len(parameters) >= 5:
            self._add_record(ServiceRecord.from_wire(parameters))
        elif command == "remove" and parameters:
            record = self.registry.get(parameters[0])
            self.registry.remove(parameters[0])
            if record is not None:
                for add_h, remove_h, flt in list(self._handlers):
                    if remove_h and flt.matches(record):
                        remove_h(record)

    def _add_record(self, record: ServiceRecord):
        if self.registry.get(record.topic_path) is not None:
            return
        self.registry.add(record)
        for add_h, remove_h, flt in list(self._handlers):
            if add_h and flt.matches(record):
                add_h(record)

    # -- API ---------------------------------------------------------------

    def add_handlers(self, add_handler, remove_handler,
                     service_filter: ServiceFilter | None = None):
        flt = service_filter or ServiceFilter()
        self._handlers.append((add_handler, remove_handler, flt))
        for record in self.registry.query(flt):
            if add_handler:
                add_handler(record)

    def remove_handlers(self, add_handler, remove_handler):
        self._handlers = [(a, r, f) for (a, r, f) in self._handlers
                          if not (a == add_handler and r == remove_handler)]

    def services(self) -> list[ServiceRecord]:
        return self.registry.all()


_services_cache: ServicesCache | None = None


def services_cache_singleton(runtime) -> ServicesCache:
    global _services_cache
    if _services_cache is None or _services_cache.runtime is not runtime:
        _services_cache = ServicesCache(runtime)
    return _services_cache


def reset_services_cache():
    global _services_cache
    _services_cache = None
