"""Per-stage circuit breaker for remote pipeline stages (ISSUE 5
tentpole part 4).

A remote stage that died (or fell off the network) used to cost every
frame a full park + deadline/timeout before failing; under load that is
a convoy of doomed round trips.  The classic serving answer (Vortex,
PAPERS.md: fast failover beats patient retries under tight SLOs) is a
breaker: after ``threshold`` CONSECUTIVE failures the stage's breaker
opens and frames fail fast (or take a declared ``fallback:`` element)
without touching the wire; after ``cooldown_s`` one probe frame is let
through half-open -- success recloses, failure reopens.

Owned by the pipeline's event loop but read by the metrics exporter
thread, so state transitions take a lock.  ``transitions`` records
``(state, monotonic_time)`` pairs -- the bench derives
open->half-open->closed latency from it, and tests assert the exact
state walk.
"""

from __future__ import annotations

import threading
import time

__all__ = ["CircuitBreaker", "BREAKER_CLOSED", "BREAKER_OPEN",
           "BREAKER_HALF_OPEN"]

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

# Gauge encoding for the telemetry plane (``breaker_state``).
_STATE_VALUES = {BREAKER_CLOSED: 0.0, BREAKER_HALF_OPEN: 0.5,
                 BREAKER_OPEN: 1.0}


class CircuitBreaker:
    def __init__(self, threshold: int = 3, cooldown_s: float = 1.0,
                 clock=time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._failures = 0             # consecutive, resets on success
        self._changed_at = clock()     # entered current state
        self.transitions: list[tuple[str, float]] = []
        self.rejects = 0               # frames refused while open

    # -- state machine -----------------------------------------------------

    def _transition(self, state: str) -> None:
        # caller holds the lock
        self._state = state
        self._changed_at = self._clock()
        self.transitions.append((state, self._changed_at))

    def allow(self) -> bool:
        """May a frame be forwarded to this stage right now?  Open
        breakers let ONE probe through per cooldown window (half-open);
        a probe that never reports back (remote vanished entirely) does
        not wedge the breaker -- the half-open window times out back to
        another probe."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            now = self._clock()
            if now - self._changed_at >= self.cooldown_s:
                # open: cooldown elapsed -> promote to half-open probe;
                # half-open: the outstanding probe went silent -> allow
                # another (re-stamp so the window restarts).
                if self._state == BREAKER_OPEN:
                    self._transition(BREAKER_HALF_OPEN)
                else:
                    self._changed_at = now
                return True
            if self._state == BREAKER_OPEN \
                    or self._state == BREAKER_HALF_OPEN:
                self.rejects += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != BREAKER_CLOSED:
                self._transition(BREAKER_CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == BREAKER_HALF_OPEN:
                self._transition(BREAKER_OPEN)     # probe failed: reopen
                return
            self._failures += 1
            if self._state == BREAKER_CLOSED \
                    and self._failures >= self.threshold:
                self._transition(BREAKER_OPEN)

    # -- reporting ---------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def state_value(self) -> float:
        """Gauge encoding: 0 closed, 0.5 half-open, 1 open."""
        return _STATE_VALUES[self.state]

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"state": self._state, "failures": self._failures,
                    "threshold": self.threshold,
                    "cooldown_s": self.cooldown_s,
                    "rejects": self.rejects,
                    "transitions": [state for state, _ in
                                    self.transitions]}
