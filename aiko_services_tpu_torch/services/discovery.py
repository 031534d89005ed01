"""Service discovery and remote invocation (reference: src/aiko_services/
main/discovery.py).

A remote call is a message: ``proxy.method(a, b)`` publishes
``(method a b)`` to the target's ``topic/in`` (reference
discovery.py:138-170).  ``ServiceDiscovery`` watches the ServicesCache for
services matching a filter; ``do_command`` runs a callback against the
first match; ``do_request`` implements the request/response pattern
(``(item_count N)`` + N responses on a private topic, reference
discovery.py:174-238).
"""

from __future__ import annotations

import itertools
from typing import Callable

from .service import ServiceFilter, ServiceRecord
from .share import services_cache_singleton
from ..utils import get_logger, generate

__all__ = ["RemoteProxy", "ServiceDiscovery", "get_service_proxy",
           "do_discovery", "do_command", "do_request"]

_logger = get_logger("aiko.discovery")


class RemoteProxy:
    """Publishes ``(method args...)`` to ``{topic_path}/in`` for any public
    method access.  If an interface class is supplied, only its public
    method names are allowed (typo safety)."""

    def __init__(self, runtime, topic_path: str, interface=None,
                 control: bool = False):
        self._runtime = runtime
        self._topic = f"{topic_path}/{'control' if control else 'in'}"
        self._topic_path = topic_path
        self._allowed = None
        if interface is not None:
            self._allowed = {name for name in dir(interface)
                             if not name.startswith("_")
                             and callable(getattr(interface, name, None))}

    @property
    def topic_path(self) -> str:
        return self._topic_path

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if self._allowed is not None and name not in self._allowed:
            raise AttributeError(
                f"{name} not in remote interface {sorted(self._allowed)}")

        def call(*args):
            self._runtime.message.publish(self._topic,
                                          generate(name, list(args)))
        call.__name__ = name
        return call


def get_service_proxy(runtime, topic_path: str, interface=None,
                      control: bool = False) -> RemoteProxy:
    return RemoteProxy(runtime, topic_path, interface, control)


class ServiceDiscovery:
    """Tracks services matching a filter; invokes add/remove callbacks with
    (record, proxy)."""

    def __init__(self, runtime, service_filter: ServiceFilter,
                 add_handler: Callable | None = None,
                 remove_handler: Callable | None = None,
                 interface=None):
        self.runtime = runtime
        self.filter = service_filter
        self.interface = interface
        self._add_handler = add_handler
        self._remove_handler = remove_handler
        self.discovered: dict[str, RemoteProxy] = {}
        self.cache = services_cache_singleton(runtime)
        self.cache.add_handlers(self._on_add, self._on_remove,
                                service_filter)

    def _on_add(self, record: ServiceRecord):
        proxy = RemoteProxy(self.runtime, record.topic_path, self.interface)
        self.discovered[record.topic_path] = proxy
        if self._add_handler:
            self._add_handler(record, proxy)

    def _on_remove(self, record: ServiceRecord):
        proxy = self.discovered.pop(record.topic_path, None)
        if self._remove_handler and proxy is not None:
            self._remove_handler(record, proxy)

    def terminate(self):
        self.cache.remove_handlers(self._on_add, self._on_remove)


def do_discovery(runtime, service_filter: ServiceFilter,
                 add_handler=None, remove_handler=None,
                 interface=None) -> ServiceDiscovery:
    return ServiceDiscovery(runtime, service_filter, add_handler,
                            remove_handler, interface)


def do_command(runtime, interface, service_filter: ServiceFilter,
               command_handler: Callable[[RemoteProxy], None],
               once: bool = True) -> ServiceDiscovery:
    """Run ``command_handler(proxy)`` against each (or the first) service
    matching the filter, as they are discovered."""
    state = {"done": False}

    def on_add(record, proxy):
        if once and state["done"]:
            return
        state["done"] = True
        command_handler(proxy)

    return do_discovery(runtime, service_filter, on_add,
                        interface=interface)


_request_ids = itertools.count()


def do_request(runtime, interface, service_filter: ServiceFilter,
               request_handler: Callable[[RemoteProxy, str], None],
               response_handler: Callable[[list], None],
               once: bool = True) -> ServiceDiscovery:
    """Request/response: ``request_handler(proxy, response_topic)`` issues
    the request including the private response topic; responses accumulate
    until ``item_count`` items arrived, then ``response_handler(items)``
    fires and the response topic is released (reference
    discovery.py:209-238)."""
    from ..utils import parse

    response_topic = (f"{runtime.topic_path_process}"
                      f"/request/{next(_request_ids)}")
    state = {"expected": None, "items": [], "done": False}

    def on_response(topic, payload):
        try:
            command, parameters = parse(payload)
        except Exception:
            return
        if command == "item_count":
            from ..utils import parse_number
            state["expected"] = int(parse_number(parameters[0], 0))
        else:
            state["items"].append((command, parameters))
        if (state["expected"] is not None
                and len(state["items"]) >= state["expected"]
                and not state["done"]):
            state["done"] = True
            runtime.remove_message_handler(on_response, response_topic)
            response_handler(state["items"])

    runtime.add_message_handler(on_response, response_topic)
    requested = {"count": 0}

    def on_add(record, proxy):
        if once and requested["count"]:
            return
        requested["count"] += 1
        request_handler(proxy, response_topic)

    return do_discovery(runtime, service_filter, on_add,
                        interface=interface)
