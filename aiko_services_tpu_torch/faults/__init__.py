"""Fault-injection harness + failure-recovery primitives (ISSUE 5).

``plan``     -- :class:`FaultPlan`: declarative, counted, seeded fault
                injection threaded through the engine's hot paths
                (arm via the ``fault_plan`` pipeline parameter, the
                ``arm_faults`` wire command, or ``--fault-plan``).
``breaker``  -- :class:`CircuitBreaker`: per-remote-stage failure
                isolation with half-open probing.

Import surface is jax-free (like :mod:`..observability`): the harness
drives chaos against any backend, and dashboards can read breaker and
plan state without pulling in the TPU stack.
"""

from .breaker import (BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN,
                      CircuitBreaker)
from .plan import (POINTS, WIRE_POINTS, FaultInjected, FaultPlan,
                   FaultRule, probe_count, wire_fault_filter)

__all__ = ["FaultPlan", "FaultRule", "FaultInjected", "CircuitBreaker",
           "POINTS", "WIRE_POINTS", "probe_count", "wire_fault_filter",
           "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN"]
