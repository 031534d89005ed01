"""Orchestration layer (reference: src/aiko_services/main/process_manager.py
and lifecycle.py): child-process management, elastic worker fleets, and
the guarded fleet controller (ISSUE 20)."""

from .process_manager import ProcessManager  # noqa: F401
from .lifecycle import (  # noqa: F401
    LifeCycleManager, LifeCycleClient,
    PROTOCOL_LIFECYCLE_MANAGER, PROTOCOL_LIFECYCLE_CLIENT)
from .controller import (  # noqa: F401
    FleetController, FleetSupervisor, ControllerSpec,
    controller_spec_error, CONTROLLER_MODES, peer_definition)

__all__ = ["ProcessManager", "LifeCycleManager", "LifeCycleClient",
           "PROTOCOL_LIFECYCLE_MANAGER", "PROTOCOL_LIFECYCLE_CLIENT",
           "FleetController", "FleetSupervisor", "ControllerSpec",
           "controller_spec_error", "CONTROLLER_MODES",
           "peer_definition"]
