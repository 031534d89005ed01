"""Process runtime: topic fabric, transport bridge, service registry,
registrar protocol client (reference: src/aiko_services/main/process.py).

One ``ProcessRuntime`` per OS process hosts any number of services.  Its
responsibilities:

- own the :class:`EventEngine` and the message transport;
- bridge inbound transport messages (arriving on a network thread) onto the
  event loop via the engine's thread-safe queue (reference
  process.py:264-291);
- maintain the topic fabric ``{namespace}/{host}/{pid}/{service_id}`` and a
  ``+``/``#`` wildcard dispatch table (reference process.py:191-213,387-403);
- register local services with the Registrar when one is present, tracking
  the retained ``(primary found ...)`` boot topic (reference
  process.py:303-367);
- set the process LWT ``(absent)`` on ``.../{pid}/0/state`` so the Registrar
  reaps all of this process's services if it dies (reference
  process.py:99-101).
"""

from __future__ import annotations

import threading
from typing import Callable

from .event import EventEngine
from .connection import Connection, ConnectionState
from ..transport import create_transport, topic_matches, MessageState
from ..utils import (get_logger, get_namespace, get_hostname, get_pid,
                     get_username, get_transport, generate, parse)

__all__ = ["ProcessRuntime", "process", "init_process", "reset_process",
           "REGISTRAR_BOOT_VERSION"]

_logger = get_logger("aiko.process")

REGISTRAR_BOOT_VERSION = "1"


class ProcessRuntime:
    def __init__(self, transport: str | None = None, namespace=None):
        self.namespace = namespace or get_namespace()
        self.hostname = get_hostname()
        self.pid = get_pid()
        self.engine = EventEngine()
        self.connection = Connection()
        self.registrar: dict | None = None      # {topic_path, version, time}
        self._transport_kind = transport or get_transport()
        self._services: dict[int, object] = {}   # service_id -> Service
        self._next_service_id = 1
        self._topic_handlers: list[tuple[str, Callable]] = []
        self._lock = threading.Lock()
        self._registrar_handlers: list[Callable] = []
        self._terminate_registrar_lost = False

        self.topic_path_process = self.topic_path(0)
        self.topic_registrar_boot = f"{self.namespace}/service/registrar"

        self.message = create_transport(
            self._transport_kind,
            message_handler=self._on_transport_message,
            lwt_topic=f"{self.topic_path_process}/state",
            lwt_payload="(absent)",
            lwt_retain=True)
        self.message.add_state_handler(self._on_transport_state)

    # -- topic fabric ------------------------------------------------------

    def topic_path(self, service_id) -> str:
        return f"{self.namespace}/{self.hostname}/{self.pid}/{service_id}"

    # -- lifecycle ---------------------------------------------------------

    def initialize(self):
        self.connection.update(ConnectionState.NETWORK)
        self.add_message_handler(self._on_registrar_boot,
                                 self.topic_registrar_boot)
        self.message.connect()

    def run(self, until=None, timeout: float | None = None,
            connected: bool = True):
        if connected and self.message.state != MessageState.CONNECTED:
            self.initialize()
        self.engine.run(until=until, timeout=timeout)

    async def run_async(self, until=None, timeout=None, connected=True):
        if connected and self.message.state != MessageState.CONNECTED:
            self.initialize()
        await self.engine.run_async(until=until, timeout=timeout)

    def terminate(self):
        for service in list(self._services.values()):
            stop = getattr(service, "stop", None)
            if stop:
                try:
                    stop()
                except Exception:
                    _logger.exception("service stop failed")
        # Graceful exit must still announce our death: publish the same
        # retained "(absent)" the LWT would have sent, so the Registrar
        # reaps this process's directory entries instead of leaking them.
        try:
            self.message.publish(f"{self.topic_path_process}/state",
                                 "(absent)", retain=True)
        except Exception:
            pass
        self.message.disconnect()
        self.engine.terminate()

    # -- transport bridge --------------------------------------------------

    def _on_transport_message(self, topic: str, payload):
        # Possibly on a network thread: hop to the event loop.
        self.engine.post(self._dispatch_message, topic, payload)

    def _on_transport_state(self, state: MessageState):
        if state == MessageState.CONNECTED:
            self.connection.update(ConnectionState.TRANSPORT)
        else:
            self.connection.update(ConnectionState.NETWORK)

    def _dispatch_message(self, topic: str, payload):
        matched = False
        for pattern, handler in list(self._topic_handlers):
            if topic_matches(pattern, topic):
                matched = True
                try:
                    handler(topic, payload)
                except Exception:
                    _logger.exception("message handler failed for %s", topic)
        if not matched:
            _logger.debug("unhandled message on %s", topic)

    def add_message_handler(self, handler: Callable, topic_pattern: str):
        with self._lock:
            self._topic_handlers.append((topic_pattern, handler))
        self.message.subscribe(topic_pattern)

    def remove_message_handler(self, handler: Callable, topic_pattern: str):
        with self._lock:
            self._topic_handlers = [
                (p, h) for (p, h) in self._topic_handlers
                if not (p == topic_pattern and h == handler)]
            still_used = any(p == topic_pattern
                             for p, _ in self._topic_handlers)
        if not still_used:
            self.message.unsubscribe(topic_pattern)

    # -- service registry --------------------------------------------------

    def add_service(self, service) -> int:
        with self._lock:
            service_id = self._next_service_id
            self._next_service_id += 1
            self._services[service_id] = service
        service.service_id = service_id
        service.topic_path = self.topic_path(service_id)
        if self.registrar:
            self._register_service(service)
        return service_id

    def remove_service(self, service_id: int):
        service = self._services.pop(service_id, None)
        if service is not None and self.registrar:
            self.message.publish(
                f"{self.registrar['topic_path']}/in",
                generate("remove", [service.topic_path]))

    def services(self) -> list:
        return list(self._services.values())

    def get_service(self, service_id: int):
        return self._services.get(service_id)

    def _register_service(self, service):
        payload = generate("add", [
            service.topic_path, service.name, service.protocol,
            service.transport, get_username(), list(service.tags)])
        self.message.publish(f"{self.registrar['topic_path']}/in", payload)

    # -- registrar protocol ------------------------------------------------

    def _on_registrar_boot(self, topic: str, payload):
        try:
            command, parameters = parse(payload)
        except Exception:
            return
        if command != "primary":
            return
        previous = self.registrar
        if parameters and parameters[0] == "found":
            new_topic = parameters[1] if len(parameters) > 1 else None
            if previous is not None \
                    and previous.get("topic_path") == new_topic:
                return       # unchanged (retained redelivery): no churn
            self.registrar = {
                "topic_path": parameters[1] if len(parameters) > 1 else None,
                "version": parameters[2] if len(parameters) > 2 else None,
                "timestamp": parameters[3] if len(parameters) > 3 else None,
            }
            for service in self._services.values():
                self._register_service(service)
            self.connection.update(ConnectionState.REGISTRAR)
        elif parameters and parameters[0] == "absent":
            if previous is None:
                return       # already absent: no churn
            self.registrar = None
            if self.connection.state == ConnectionState.REGISTRAR:
                self.connection.update(ConnectionState.TRANSPORT)
            if self._terminate_registrar_lost:
                self.terminate()
        for handler in list(self._registrar_handlers):
            handler(self.registrar)

    def add_registrar_handler(self, handler: Callable):
        self._registrar_handlers.append(handler)
        handler(self.registrar)

    def remove_registrar_handler(self, handler: Callable):
        try:
            self._registrar_handlers.remove(handler)
        except ValueError:
            pass

    def set_terminate_on_registrar_lost(self, value: bool = True):
        self._terminate_registrar_lost = value


# --------------------------------------------------------------------------
# Process singleton

_process: ProcessRuntime | None = None
_process_lock = threading.Lock()


def process() -> ProcessRuntime:
    global _process
    with _process_lock:
        if _process is None:
            _process = ProcessRuntime()
        return _process


def init_process(transport: str | None = None,
                 namespace: str | None = None) -> ProcessRuntime:
    global _process
    with _process_lock:
        _process = ProcessRuntime(transport=transport, namespace=namespace)
        return _process


def reset_process():
    """Test isolation: drop the singleton (does not stop a running loop)."""
    global _process
    with _process_lock:
        _process = None
