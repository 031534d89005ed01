"""Environment-variable configuration.

Mirrors the reference's env-var config surface (reference:
src/aiko_services/main/utilities/configuration.py:47-186) with the same
variable names so deployments translate directly, plus TPU-specific knobs.
"""

from __future__ import annotations

import logging
import os
import socket
import threading

__all__ = [
    "get_namespace", "get_hostname", "get_pid",
    "get_mqtt_configuration", "get_mqtt_host", "get_transport",
    "get_username", "env_flag", "env_int", "env_float",
    "mqtt_broker_reachable", "bootstrap_start", "bootstrap_discover",
    "BOOTSTRAP_UDP_PORT",
]

_logger = logging.getLogger("aiko.configuration")

# UDP bootstrap for devices without DNS/mDNS (reference
# configuration.py:52 _AIKO_BOOTSTRAP_UDP_PORT and :160-186 protocol:
# broadcast "boot? <reply_ip> <reply_port>" -> unicast
# "boot <mqtt_host> <mqtt_port> <namespace>").
BOOTSTRAP_UDP_PORT = 4149


def env_flag(name: str, default: bool = False) -> bool:
    value = os.environ.get(name)
    if value is None:
        return default
    return value.strip().lower() in ("1", "true", "yes", "on")


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def get_namespace() -> str:
    return os.environ.get("AIKO_NAMESPACE", "aiko")


def get_hostname() -> str:
    return os.environ.get("AIKO_HOSTNAME", socket.gethostname().split(".")[0])


def get_pid() -> str:
    return str(os.getpid())


def get_username() -> str:
    return (os.environ.get("AIKO_USERNAME")
            or os.environ.get("USER") or os.environ.get("USERNAME") or "nobody")


def get_transport() -> str:
    """Which message transport the process runtime should create:
    ``loopback`` (in-memory, default for tests / single host), ``mqtt``,
    or ``castaway`` (null)."""
    return os.environ.get("AIKO_TRANSPORT", "loopback").lower()


def get_mqtt_host(probe: bool = True,
                  timeout: float = 1.0) -> tuple[bool, str, int]:
    """Candidate broker resolution with reachability probing (reference
    configuration.py:116-141 ``get_mqtt_host``): try ``AIKO_MQTT_HOST``
    first, then the comma-separated ``AIKO_MQTT_HOSTS`` fallback list,
    then localhost -- first host whose TCP port answers wins.  Returns
    ``(server_up, host, port)``; with every candidate down, the primary
    candidate is returned with ``server_up=False`` so a caller can still
    fail fast with a precise diagnostic instead of a slow connect."""
    port = env_int("AIKO_MQTT_PORT", 1883)
    candidates: list[tuple[str, int]] = []
    primary = os.environ.get("AIKO_MQTT_HOST")
    if primary:
        candidates.append((primary, port))
    for entry in os.environ.get("AIKO_MQTT_HOSTS", "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        host, _, entry_port = entry.partition(":")
        try:
            candidates.append((host,
                               int(entry_port) if entry_port else port))
        except ValueError:
            _logger.warning("AIKO_MQTT_HOSTS entry %r: bad port, skipped",
                            entry)
    candidates.append(("localhost", port))
    if not probe:
        return True, candidates[0][0], candidates[0][1]
    for host, candidate_port in candidates:
        if mqtt_broker_reachable(host, candidate_port, timeout=timeout):
            return True, host, candidate_port
        _logger.warning("MQTT host %s:%s unreachable", host,
                        candidate_port)
    return False, candidates[0][0], candidates[0][1]


def get_mqtt_configuration(probe: bool = False) -> dict:
    """``probe=True`` adds broker reachability probing across the
    candidate list; the default keeps the env-var fast path."""
    server_up, host, port = get_mqtt_host(probe=probe)
    tls = env_flag("AIKO_MQTT_TLS", False)
    username = os.environ.get("AIKO_MQTT_USERNAME")
    password = os.environ.get("AIKO_MQTT_PASSWORD")
    return {"host": host, "port": port, "tls": tls,
            "username": username, "password": password,
            "server_up": server_up}


def mqtt_broker_reachable(host: str, port: int, timeout: float = 1.0) -> bool:
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False


# -- UDP bootstrap ----------------------------------------------------------


def bootstrap_start(mqtt_host: str | None = None,
                    mqtt_port: int | None = None,
                    bind: str = "0.0.0.0",
                    port: int | None = None) -> threading.Event:
    """Run the bootstrap responder on a daemon thread: MCU-class devices
    broadcast ``boot? <reply_ip> <reply_port>`` and get back a unicast
    ``boot <mqtt_host> <mqtt_port> <namespace>`` (reference
    configuration.py:160-186 bootstrap_thread/bootstrap_start).

    Returns a stop event; setting it shuts the responder down."""
    if mqtt_host is None or mqtt_port is None:
        _, resolved_host, resolved_port = get_mqtt_host(probe=False)
        mqtt_host = mqtt_host or resolved_host
        mqtt_port = mqtt_port or resolved_port
    port = BOOTSTRAP_UDP_PORT if port is None else port
    stop = threading.Event()
    responder = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    responder.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    responder.bind((bind, port))
    responder.settimeout(0.5)
    response = f"boot {mqtt_host} {mqtt_port} {get_namespace()}"

    def serve():
        with responder:
            while not stop.is_set():
                try:
                    message, _address = responder.recvfrom(256)
                except socket.timeout:
                    continue
                except OSError:
                    return
                tokens = message.decode("utf-8", "replace").split()
                if len(tokens) == 3 and tokens[0] == "boot?":
                    _logger.info("bootstrap request from %s:%s",
                                 tokens[1], tokens[2])
                    try:
                        responder.sendto(response.encode(),
                                         (tokens[1], int(tokens[2])))
                    except (OSError, ValueError):
                        pass

    threading.Thread(target=serve, daemon=True,
                     name="aiko.bootstrap").start()
    return stop


def bootstrap_discover(server: str = "255.255.255.255",
                       port: int | None = None,
                       timeout: float = 2.0) -> dict | None:
    """Client side of the bootstrap protocol: broadcast ``boot?`` and
    wait for the responder's answer.  Returns ``{"host", "port",
    "namespace"}`` or None on timeout (the reference implements only the
    responder; the requester lives on the MCU)."""
    port = BOOTSTRAP_UDP_PORT if port is None else port
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as client:
        client.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        client.bind(("0.0.0.0", 0))
        # Outgoing-interface IP via a connected UDP probe -- no DNS:
        # gethostbyname(gethostname()) returns 127.0.1.1 on stock
        # Debian/Ubuntu and raises on unresolvable hostnames.
        try:
            with socket.socket(socket.AF_INET,
                               socket.SOCK_DGRAM) as probe:
                probe.setsockopt(socket.SOL_SOCKET,
                                 socket.SO_BROADCAST, 1)
                probe.connect((server, port))
                reply_ip = probe.getsockname()[0]
        except OSError:
            reply_ip = "127.0.0.1"
        reply_port = client.getsockname()[1]
        client.settimeout(timeout)
        try:
            client.sendto(f"boot? {reply_ip} {reply_port}".encode(),
                          (server, port))
            message, _address = client.recvfrom(256)
        except (socket.timeout, OSError):
            return None
    tokens = message.decode("utf-8", "replace").split()
    if len(tokens) == 4 and tokens[0] == "boot":
        return {"host": tokens[1], "port": int(tokens[2]),
                "namespace": tokens[3]}
    return None
