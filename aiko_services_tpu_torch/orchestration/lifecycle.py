"""Elastic worker fleets: LifeCycleManager / LifeCycleClient (reference:
src/aiko_services/main/lifecycle.py:104-293,360-391).

Protocol (all S-expressions over the message fabric):

- The manager launches a client (by default an OS process running
  ``python -m <module> <client_id> <manager_topic_path>``) and arms a
  handshake lease (reference: 30 s, lifecycle.py:80-81).
- The client announces ``(add_client {topic_path} {client_id})`` on the
  manager's **control** topic (reference lifecycle.py:195-233,376-391).
- The manager cancels the handshake lease, attaches an :class:`ECConsumer`
  to the client's share dict to watch its ``lifecycle`` state, and counts
  it live.
- Deletion: manager publishes ``(terminate)`` to the client's ``topic/in``
  and arms a deletion lease that force-kills the OS process if the client
  does not disappear from the Registrar in time (reference
  lifecycle.py:235-274).
- Client death (crash or clean exit) is observed via Registrar service
  removal events through the ServicesCache.

For offline tests the launcher is pluggable: an in-process launcher can
instantiate :class:`LifeCycleClient` actors directly on the same runtime,
exercising the full handshake over the loopback broker without spawning
processes (the SURVEY §4 test philosophy).
"""

from __future__ import annotations

import itertools
from typing import Callable

from ..runtime import Lease
from ..services import Actor, ECConsumer, ServiceFilter
from ..services.share import services_cache_singleton
from ..utils import get_logger, generate, parse_number
from .process_manager import ProcessManager

__all__ = ["LifeCycleManager", "LifeCycleClient",
           "PROTOCOL_LIFECYCLE_MANAGER", "PROTOCOL_LIFECYCLE_CLIENT"]

_logger = get_logger("aiko.lifecycle")

PROTOCOL_LIFECYCLE_MANAGER = "lifecycle_manager:0"
PROTOCOL_LIFECYCLE_CLIENT = "lifecycle_client:0"

HANDSHAKE_LEASE_TIME = 30.0      # reference lifecycle.py:80
DELETION_LEASE_TIME = 10.0       # reference lifecycle.py:81


class _ClientRecord:
    __slots__ = ("client_id", "topic_path", "ec_consumer", "ec_cache",
                 "deletion_lease")

    def __init__(self, client_id, topic_path):
        self.client_id = client_id
        self.topic_path = topic_path
        self.ec_consumer = None
        self.ec_cache: dict = {}
        self.deletion_lease = None


class LifeCycleManager(Actor):
    """Spawns and tracks a fleet of LifeCycleClient workers.

    ``launcher(client_id, manager_topic_path)`` starts a worker; the default
    spawns ``python -m {module}`` via :class:`ProcessManager`.
    ``client_change_handler(event, client_id)`` fires on "add"/"remove".
    """

    def __init__(self, name: str = "lifecycle_manager",
                 module: str | None = None,
                 launcher: Callable | None = None,
                 client_change_handler: Callable | None = None,
                 handshake_lease_time: float = HANDSHAKE_LEASE_TIME,
                 deletion_lease_time: float = DELETION_LEASE_TIME,
                 runtime=None, tags=None):
        super().__init__(name, PROTOCOL_LIFECYCLE_MANAGER,
                         tags=tags or ["ec=true"], runtime=runtime)
        self.module = module
        self.launcher = launcher or self._launch_process
        self.client_change_handler = client_change_handler
        self.handshake_lease_time = handshake_lease_time
        self.deletion_lease_time = deletion_lease_time
        self.process_manager = ProcessManager(
            engine=self.runtime.engine, exit_handler=self._on_process_exit)
        self.clients: dict[int, _ClientRecord] = {}
        self._pending: dict[int, Lease] = {}      # awaiting handshake
        self._client_ids = itertools.count(1)
        self.share["client_count"] = 0
        self._stopped = False
        self._reconcile_pending = False
        self._cache = services_cache_singleton(self.runtime)
        # Unfiltered: workers may subclass LifeCycleClient with their own
        # protocol, so removal matching is by tracked topic path, not
        # protocol.
        self._cache.add_handlers(None, self._on_service_removed,
                                 ServiceFilter())
        self.runtime.add_registrar_handler(self._on_registrar_change)

    # -- fleet API ---------------------------------------------------------

    def create_client(self, *_ignored) -> int:
        """Launch one worker; returns its client id.  Remotely invocable:
        ``(create_client)``."""
        client_id = next(self._client_ids)
        self._pending[client_id] = Lease(
            self.runtime.engine, self.handshake_lease_time, client_id,
            expired_handler=self._handshake_expired)
        try:
            self.launcher(client_id, self.topic_path)
        except Exception:
            _logger.exception("launch failed for client %s", client_id)
            lease = self._pending.pop(client_id, None)
            if lease:
                lease.terminate()
            if self.client_change_handler:
                self.client_change_handler("launch_failed", client_id)
            return client_id
        return client_id

    def create_clients(self, count) -> list[int]:
        return [self.create_client()
                for _ in range(int(parse_number(count, 0)))]

    def destroy_client(self, client_id):
        client_id = int(parse_number(client_id, -1))
        record = self.clients.get(client_id)
        if record is None:
            lease = self._pending.pop(client_id, None)
            if lease:
                lease.terminate()
            self.process_manager.destroy(client_id)
            return
        self.runtime.message.publish(f"{record.topic_path}/in",
                                     generate("terminate", []))
        record.deletion_lease = Lease(
            self.runtime.engine, self.deletion_lease_time, client_id,
            expired_handler=self._deletion_expired)

    def destroy_all_clients(self):
        for client_id in list(self.clients):
            self.destroy_client(client_id)

    def client_count(self) -> int:
        return len(self.clients)

    # -- handshake (wire handler: client posts to our control topic) ------

    def add_client(self, client_topic_path, client_id):
        client_id = int(parse_number(client_id, -1))
        lease = self._pending.pop(client_id, None)
        if lease is None:
            # Not awaiting this id: duplicate announce, an announce arriving
            # after its handshake lease already expired (worker was killed),
            # or a malformed id.  Never admit those into the fleet.
            if client_id not in self.clients:
                _logger.warning("rejecting unexpected add_client %s from %s",
                                client_id, client_topic_path)
            return
        lease.terminate()
        record = _ClientRecord(client_id, client_topic_path)
        record.ec_consumer = ECConsumer(self.runtime, client_topic_path,
                                        record.ec_cache,
                                        item_filter="lifecycle")
        self.clients[client_id] = record
        self.ec_producer.update("client_count", len(self.clients))
        if self.client_change_handler:
            self.client_change_handler("add", client_id)

    # -- failure / removal paths ------------------------------------------

    def _handshake_expired(self, lease: Lease):
        client_id = lease.lease_uuid
        self._pending.pop(client_id, None)
        _logger.warning("client %s handshake timed out; killing", client_id)
        self.process_manager.destroy(client_id, force_after=0.0)
        if self.client_change_handler:
            self.client_change_handler("handshake_timeout", client_id)

    def _deletion_expired(self, lease: Lease):
        client_id = lease.lease_uuid
        if client_id in self.clients:
            _logger.warning("client %s ignored terminate; force-killing",
                            client_id)
            self.process_manager.destroy(client_id, force_after=0.0)
            self._drop_client(client_id)

    def _on_service_removed(self, record):
        # A registrar bounce purges the whole ServicesCache, firing remove
        # notifications for perfectly healthy workers (cache leaves
        # "ready" first -- share.py).  Only genuine live removals drop
        # fleet members; after a bounce, _reconcile prunes real deaths.
        if self._cache.state != "ready":
            # Mid-(re)load removal: can't tell purge from death now --
            # reconcile against the directory once it settles.
            self._schedule_reconcile(0.2)
            return
        for client_id, client in list(self.clients.items()):
            if client.topic_path == record.topic_path:
                self._drop_client(client_id)

    def _on_registrar_change(self, registrar):
        if registrar is not None and self.clients:
            self._schedule_reconcile(0.5)

    def _schedule_reconcile(self, delay: float):
        """Debounced: an N-client purge arms ONE timer chain, not N."""
        if self._reconcile_pending or self._stopped:
            return
        self._reconcile_pending = True
        self.runtime.engine.add_oneshot_timer(self._reconcile, delay)

    def _reconcile(self):
        """After a registrar (re)election: wait for the directory mirror,
        then drop fleet members that did not re-register (died during the
        outage)."""
        self._reconcile_pending = False
        if self._stopped:
            return
        if self._cache.state != "ready":
            self._schedule_reconcile(0.2)
            return
        for client_id, record in list(self.clients.items()):
            if self._cache.registry.get(record.topic_path) is None:
                _logger.info("client %s lost during registrar outage",
                             client_id)
                self._drop_client(client_id)

    def _on_process_exit(self, client_id, process, return_code):
        if client_id in self.clients:
            _logger.info("client %s process exited rc=%s",
                         client_id, return_code)
            self._drop_client(client_id)
            return
        lease = self._pending.pop(client_id, None)
        if lease is not None:
            # Child died before handshaking (bad argv, import error...):
            # report now instead of waiting out the handshake lease.
            lease.terminate()
            _logger.warning("client %s exited rc=%s before handshake",
                            client_id, return_code)
            if self.client_change_handler:
                self.client_change_handler("launch_failed", client_id)

    def _drop_client(self, client_id):
        record = self.clients.pop(client_id, None)
        if record is None:
            return
        if record.deletion_lease:
            record.deletion_lease.terminate()
        if record.ec_consumer:
            record.ec_consumer.terminate()
        self.ec_producer.update("client_count", len(self.clients))
        if self.client_change_handler:
            self.client_change_handler("remove", client_id)

    # -- default launcher --------------------------------------------------

    def _launch_process(self, client_id, manager_topic_path):
        if not self.module:
            raise ValueError(
                "LifeCycleManager needs module= or a custom launcher")
        self.process_manager.spawn_python(
            client_id, self.module, [client_id, manager_topic_path])

    def stop(self):
        self._stopped = True
        self._cache.remove_handlers(None, self._on_service_removed)
        self.runtime.remove_registrar_handler(self._on_registrar_change)
        for lease in self._pending.values():
            lease.terminate()
        self._pending.clear()
        for record in self.clients.values():
            if record.ec_consumer:
                record.ec_consumer.terminate()
            if record.deletion_lease:
                record.deletion_lease.terminate()
        self.process_manager.terminate()
        super().stop()


class LifeCycleClient(Actor):
    """Worker end of the handshake.  Subclass and add behavior; the base
    announces itself and honors ``(terminate)``."""

    def __init__(self, name: str, client_id: int, manager_topic_path: str,
                 protocol: str = PROTOCOL_LIFECYCLE_CLIENT,
                 runtime=None, tags=None, owns_process: bool = False):
        super().__init__(name, protocol, tags=tags or ["ec=true"],
                         runtime=runtime)
        self.client_id = int(client_id)
        self.manager_topic_path = manager_topic_path
        self.owns_process = owns_process
        # Announce now (manager reachable over the fabric already) and
        # again whenever the registrar (re)appears -- the manager dedups.
        self._announce()
        self.runtime.add_registrar_handler(self._on_registrar)

    def _on_registrar(self, registrar):
        if registrar is not None:
            self._announce()

    def stop(self):
        self.runtime.remove_registrar_handler(self._on_registrar)
        super().stop()

    def _announce(self):
        self.runtime.message.publish(
            f"{self.manager_topic_path}/control",
            generate("add_client", [self.topic_path, self.client_id]))

    def terminate(self):
        """Wire-invocable: detach from the fabric.  With
        ``owns_process=True`` (workers started standalone via the default
        launcher) the whole process runtime shuts down so ``python -m``
        exits instead of leaking a zombie event loop."""
        service_id = self.service_id
        self.stop()
        self.runtime.remove_service(service_id)
        if self.owns_process:
            self.runtime.terminate()
