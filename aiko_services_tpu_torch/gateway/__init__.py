"""Multi-tenant streaming gateway (ISSUE 12): the production front
door.  ``qos`` is the one admission authority the engine's four former
admission planes consult; ``server`` is the HTTP + WebSocket service
that funnels client connections into pipeline streams; ``loadgen`` is
the open-loop mixed-tenant load generator the bench and CLI drive.

Import discipline: this package root re-exports only the jax-free QoS
authority (the engine seams import it on their hot paths); the server
and loadgen are imported lazily so ``pipeline/stages.py`` importing
``gateway.qos`` never drags sockets or the WS codec into every
process.
"""

from .qos import (DEFAULT_CLASS, QOS_CLASSES, QosScheduler, TokenBucket,
                  qos_spec_error)

__all__ = ["QosScheduler", "TokenBucket", "QOS_CLASSES",
           "DEFAULT_CLASS", "qos_spec_error", "GatewayServer",
           "GatewayClient", "run_loadgen"]


def __getattr__(name):
    if name in ("GatewayServer",):
        from .server import GatewayServer
        return GatewayServer
    if name in ("GatewayClient",):
        from .client import GatewayClient
        return GatewayClient
    if name in ("run_loadgen",):
        from .loadgen import run_loadgen
        return run_loadgen
    raise AttributeError(name)
