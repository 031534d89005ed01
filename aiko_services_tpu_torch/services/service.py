"""Service: the discoverable unit (reference: src/aiko_services/main/
service.py).

A Service has a name, protocol, transport and tags, and owns five topics
``{topic_path}/{control,in,log,out,state}`` (reference service.py:548-564).
The reference builds services through a runtime class-composition system
("FrankensteinClass", component.py:50-123); this build uses plain Python
classes -- capability parity, none of the metaprogramming.

Also here: ``ServiceRecord`` (directory entry), ``ServiceFilter`` (query by
name/protocol/owner/tags, reference service.py:213-244), ``ServiceTags``
helpers, and ``ServiceRegistry`` (two-level process/service registry used by
the Registrar and caches, reference service.py:364-503).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ..runtime import Hooks, process as default_process
from ..utils import get_logger, generate, TransportLogHandler

__all__ = ["Service", "ServiceRecord", "ServiceFilter", "ServiceTags",
           "ServiceRegistry", "SERVICE_PROTOCOL_PREFIX"]

SERVICE_PROTOCOL_PREFIX = "github.com/aiko_services_tpu_torch/protocol"


@dataclass
class ServiceRecord:
    topic_path: str
    name: str
    protocol: str
    transport: str
    owner: str
    tags: list[str] = field(default_factory=list)

    @property
    def process_topic(self) -> str:
        return self.topic_path.rsplit("/", 1)[0]

    def to_wire(self) -> list:
        return [self.topic_path, self.name, self.protocol,
                self.transport, self.owner, list(self.tags)]

    @classmethod
    def from_wire(cls, parameters) -> "ServiceRecord":
        tags = parameters[5] if len(parameters) > 5 else []
        if isinstance(tags, str):
            tags = [tags]
        return cls(topic_path=parameters[0], name=parameters[1],
                   protocol=parameters[2], transport=parameters[3],
                   owner=parameters[4], tags=list(tags))


class ServiceTags:
    @staticmethod
    def match(service_tags: list[str], filter_tags: list[str]) -> bool:
        """All filter tags must be present. ``key=value`` tags match
        exactly; a filter of ``key=*`` matches any value of that key."""
        for wanted in filter_tags:
            if wanted in ("*", ""):
                continue
            if "=" in wanted and wanted.endswith("=*"):
                key = wanted[:-1]          # keep the '='
                if not any(t.startswith(key) for t in service_tags):
                    return False
            elif wanted not in service_tags:
                return False
        return True

    @staticmethod
    def get(service_tags: list[str], key: str, default=None):
        prefix = f"{key}="
        for tag in service_tags:
            if tag.startswith(prefix):
                return tag[len(prefix):]
        return default


@dataclass
class ServiceFilter:
    topic_paths: str | list = "*"
    name: str = "*"
    protocol: str = "*"
    transport: str = "*"
    owner: str = "*"
    tags: str | list = "*"

    WILDCARD = "*"

    def matches(self, record: ServiceRecord) -> bool:
        if self.topic_paths != "*":
            paths = (self.topic_paths if isinstance(self.topic_paths, list)
                     else [self.topic_paths])
            if record.topic_path not in paths:
                return False
        if self.name != "*" and record.name != self.name:
            return False
        if self.protocol != "*":
            # Allow protocol match ignoring the version suffix ":N"
            want = self.protocol
            have = record.protocol
            if want != have and want != have.rsplit(":", 1)[0] \
                    and want.rsplit(":", 1)[0] != have:
                return False
        if self.transport != "*" and record.transport != self.transport:
            return False
        if self.owner != "*" and record.owner != self.owner:
            return False
        if self.tags != "*":
            tags = self.tags if isinstance(self.tags, list) else [self.tags]
            if not ServiceTags.match(record.tags, tags):
                return False
        return True

    def to_wire(self) -> list:
        def enc(value):
            if value == "*" or value is None:
                return "*"
            return value
        return [enc(self.topic_paths), enc(self.name), enc(self.protocol),
                enc(self.transport), enc(self.owner),
                self.tags if isinstance(self.tags, list) else enc(self.tags)]

    @classmethod
    def from_wire(cls, parameters) -> "ServiceFilter":
        fields = list(parameters) + ["*"] * (6 - len(parameters))
        return cls(topic_paths=fields[0], name=fields[1], protocol=fields[2],
                   transport=fields[3], owner=fields[4], tags=fields[5])


class ServiceRegistry:
    """Two-level registry: process topic-path -> {service topic-path ->
    ServiceRecord}."""

    def __init__(self):
        self._processes: dict[str, dict[str, ServiceRecord]] = {}

    def add(self, record: ServiceRecord):
        self._processes.setdefault(record.process_topic, {})[
            record.topic_path] = record

    def remove(self, topic_path: str) -> ServiceRecord | None:
        process_topic = topic_path.rsplit("/", 1)[0]
        services = self._processes.get(process_topic)
        if not services:
            return None
        record = services.pop(topic_path, None)
        if not services:
            del self._processes[process_topic]
        return record

    def remove_process(self, process_topic: str) -> list[ServiceRecord]:
        services = self._processes.pop(process_topic, {})
        return list(services.values())

    def get(self, topic_path: str) -> ServiceRecord | None:
        process_topic = topic_path.rsplit("/", 1)[0]
        return self._processes.get(process_topic, {}).get(topic_path)

    def query(self, service_filter: ServiceFilter) -> list[ServiceRecord]:
        return [record for services in self._processes.values()
                for record in services.values()
                if service_filter.matches(record)]

    def all(self) -> list[ServiceRecord]:
        return [record for services in self._processes.values()
                for record in services.values()]

    def __len__(self):
        return sum(len(s) for s in self._processes.values())


class Service(Hooks):
    """Base discoverable service bound to a ProcessRuntime."""

    def __init__(self, name: str, protocol: str, tags=None,
                 runtime=None, transport: str | None = None):
        Hooks.__init__(self)
        self.runtime = runtime or default_process()
        self.name = name
        self.protocol = protocol
        self.transport = transport or self.runtime._transport_kind
        self.tags: list[str] = list(tags or [])
        self.service_id: int | None = None
        self.topic_path: str | None = None
        self.runtime.add_service(self)       # assigns id + topic_path

        self.topic_control = f"{self.topic_path}/control"
        self.topic_in = f"{self.topic_path}/in"
        self.topic_log = f"{self.topic_path}/log"
        self.topic_out = f"{self.topic_path}/out"
        self.topic_state = f"{self.topic_path}/state"

        self._log_handler = TransportLogHandler(
            lambda topic, payload: self.runtime.message.publish(
                topic, payload),
            self.topic_log)
        self.logger = get_logger(f"{name}.{self.service_id}")
        self.logger.addHandler(self._log_handler)
        self._log_handler.on_connected()

    def add_tags(self, tags: list[str]):
        for tag in tags:
            if tag not in self.tags:
                self.tags.append(tag)

    def publish_out(self, command: str, parameters=None):
        self.runtime.message.publish(self.topic_out,
                                     generate(command, parameters))

    def publish_state(self, payload: str, retain: bool = True):
        self.runtime.message.publish(self.topic_state, payload, retain=retain)

    def set_log_level(self, level: str):
        try:
            self.logger.setLevel(getattr(logging, str(level).upper()))
        except AttributeError:
            self.logger.warning("unknown log level %s", level)

    def stop(self):
        """Called by the runtime at terminate; override to release
        resources."""

    def run(self, until=None, timeout=None, connected=True):
        self.runtime.run(until=until, timeout=timeout, connected=connected)
