"""FaultPlan: declarative, counted fault injection (ISSUE 5 tentpole).

The recovery machinery this repo accumulated (chip health probes +
``StagePlacement.replace``, remote retry backoff, stage credit windows)
was never systematically *exercised*: nothing could kill a chip mid
frame, drop a remote response, or stall a stage worker on demand, so
"we think it recovers" was the strongest claim tier-1 could make.  This
module is the injection plane: a :class:`FaultPlan` is a list of
:class:`FaultRule`\\ s armed on a Pipeline (``fault_plan`` pipeline
parameter, ``arm_faults`` wire command, ``--fault-plan`` CLI option);
every injection point the engine threads through its hot paths asks the
armed plan ``should(point, ...)`` and acts only on a match.

Design constraints, both load-bearing:

- **Zero cost unarmed.**  Injection sites are guarded by a single
  ``self._faults is not None`` check; no plan code runs (and no rule is
  evaluated) until a plan is armed.  Every ``should``/``fire_point``
  evaluation bumps the module-level :func:`probe_count`, so a test can
  prove the unarmed hot path never entered the harness.
- **Deterministic and counted.**  Rules fire by exact ``after``/
  ``count`` bookkeeping (plus an optional seeded ``prob``), and every
  fire is appended to ``plan.trace`` -- tests assert the *exact* blast
  radius, not "something probably failed".

Injection points (the ``point`` field of a rule):

========================  ==================================================
``element_raise``         raise at element dispatch (the XLA "chip died"
                          error surface), sync / stage-worker / async submit
``element_hang``          sleep ``delay_ms`` inside element dispatch
``segment_fail``          raise inside a fused-segment dispatch
``stage_stall``           occupy a placed stage's FIFO worker ``delay_ms``
``device_kill``           health prober reports the target's chips dead
``device_hang``           health prober hangs ``delay_ms`` on the target
``decode_block``          the LLM element's device-resident generation
                          loop, probed before every block dispatch:
                          without ``delay_ms`` it raises (a chip dying
                          MID-GENERATION -- the batcher replays every
                          live request from its last emitted block);
                          with ``delay_ms`` it hangs the dispatch
``wire_drop``             drop a ``process_frame``/``_response`` message
``wire_delay``            deliver it ``delay_ms`` late
``wire_dup``              deliver it twice
``wire_corrupt``          mangle the payload (receiver's parse drops it)
``process_kill``          the whole pipeline process dies uncleanly.
                          In-process (tier-1): the engine's ingest seam
                          consults it and calls ``Pipeline.kill()`` --
                          streams drop with no responses, the retained
                          ``(absent)`` state fires like an LWT, the
                          journal is left as the crash left it.  The
                          multi-process chaos driver (``python -m
                          aiko_services_tpu_torch chaos``) realizes it as a
                          real SIGKILL.
``process_hang``          the process stops making progress for
                          ``delay_ms`` (in-process: the event loop
                          sleeps; the chaos driver: SIGSTOP/SIGCONT)
========================  ==================================================

``target`` selects where: an element/stage/segment name for engine
points, a stage name (or ``device:<index>``) for device points, a
message kind (``process_frame`` / ``process_frame_response``) or topic
substring for wire points.  ``None`` matches everything.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time

from ..utils import get_logger

__all__ = ["FaultInjected", "FaultPlan", "FaultRule", "POINTS",
           "probe_count", "wire_fault_filter", "WIRE_POINTS"]

_logger = get_logger("aiko.faults")

POINTS = frozenset({
    "element_raise", "element_hang", "segment_fail", "stage_stall",
    "device_kill", "device_hang", "decode_block",
    "wire_drop", "wire_delay", "wire_dup", "wire_corrupt",
    "process_kill", "process_hang",
})

WIRE_POINTS = ("wire_drop", "wire_delay", "wire_dup", "wire_corrupt")

# Module-level probe counter: bumped by every armed-plan evaluation and
# NEVER by an unarmed pipeline (the engine's sites don't call in).  The
# no-op acceptance test reads it around an unarmed run.
_probe_lock = threading.Lock()
_probes = 0


def probe_count() -> int:
    with _probe_lock:
        return _probes


def _count_probe() -> None:
    global _probes
    with _probe_lock:
        _probes += 1


class FaultInjected(RuntimeError):
    """Raised by an injection point standing in for a real failure
    (XLA device error, trace failure).  A distinct type so logs and
    post-mortems can tell chaos from genuine faults."""


@dataclasses.dataclass
class FaultRule:
    point: str
    target: str | None = None      # element/stage/kind selector (None=any)
    stream: str | None = None      # stream id selector (None=any)
    after: int = 0                 # skip the first N matching events
    count: int | None = 1          # fire at most N times (None=forever)
    delay_ms: float = 0.0          # hang/stall/delay duration
    prob: float = 1.0              # seeded firing probability
    seen: int = 0                  # matching events observed
    fired: int = 0                 # times actually fired

    @classmethod
    def parse(cls, spec: dict, index: int) -> "FaultRule":
        spec = dict(spec)
        point = str(spec.pop("point", "")).strip()
        if point not in POINTS:
            raise ValueError(f"fault rule [{index}]: point {point!r} not "
                             f"one of {sorted(POINTS)}")
        count = spec.pop("count", 1)
        rule = cls(point=point,
                   target=spec.pop("target", None),
                   stream=spec.pop("stream", None),
                   after=int(spec.pop("after", 0)),
                   count=None if count in (None, "forever") else int(count),
                   delay_ms=float(spec.pop("delay_ms", 0.0)),
                   prob=float(spec.pop("prob", 1.0)))
        if rule.stream is not None:
            rule.stream = str(rule.stream)
        if spec:
            raise ValueError(f"fault rule [{index}]: unknown fields "
                             f"{sorted(spec)}")
        return rule


class FaultPlan:
    """Armed rule set.  Thread-safe: injection points are hit from the
    event loop, stage workers, probe threads and the wire filter."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._random = random.Random(self.seed)
        self._lock = threading.Lock()
        self.probes = 0                    # evaluations against this plan
        self.counters: dict[str, int] = {} # point -> fires
        self.trace: list[dict] = []        # every fire, in order

    @classmethod
    def parse(cls, spec) -> "FaultPlan":
        """Accepts a JSON string, a list of rule dicts, or
        ``{"seed": ..., "rules": [...]}``."""
        if isinstance(spec, (str, bytes)):
            spec = json.loads(spec)
        seed = 0
        if isinstance(spec, dict):
            seed = int(spec.get("seed", 0))
            spec = spec.get("rules", [])
        if not isinstance(spec, (list, tuple)):
            raise ValueError("fault plan: expected a rules list or "
                             "{'seed':..., 'rules':[...]}")
        rules = [FaultRule.parse(entry, index)
                 for index, entry in enumerate(spec)]
        return cls(rules, seed=seed)

    # -- matching ----------------------------------------------------------

    @staticmethod
    def _matches(rule: FaultRule, target, stream, topic) -> bool:
        if rule.stream is not None and stream is not None \
                and rule.stream != str(stream):
            return False
        if rule.target is None:
            return True
        if target is not None and rule.target == str(target):
            return True
        return topic is not None and rule.target in str(topic)

    def _eligible(self, rule: FaultRule) -> bool:
        """after/count/prob bookkeeping for one matched event; caller
        holds the lock and has already bumped ``rule.seen``."""
        if rule.seen <= rule.after:
            return False
        if rule.count is not None and rule.fired >= rule.count:
            return False
        if rule.prob < 1.0 and self._random.random() >= rule.prob:
            return False
        return True

    def _record(self, rule: FaultRule, target, stream) -> FaultRule:
        rule.fired += 1
        self.counters[rule.point] = self.counters.get(rule.point, 0) + 1
        self.trace.append({"point": rule.point,
                           "target": target if target is not None
                           else rule.target,
                           "stream": stream, "time": time.time()})
        return rule

    def should(self, point: str, target=None, stream=None,
               topic=None) -> FaultRule | None:
        """One injection-point evaluation: the first eligible matching
        rule fires (and is returned), else None."""
        _count_probe()
        with self._lock:
            self.probes += 1
            for rule in self.rules:
                if rule.point != point \
                        or not self._matches(rule, target, stream, topic):
                    continue
                rule.seen += 1
                if not self._eligible(rule):
                    continue
                return self._record(rule, target, stream)
        return None

    def fire_point(self, point: str) -> list[FaultRule]:
        """Fire EVERY eligible rule for ``point``, ignoring target
        matching -- for selector-free sites (the health probe) where
        ``rule.target`` designates the victim instead of filtering the
        caller."""
        _count_probe()
        fired = []
        with self._lock:
            self.probes += 1
            for rule in self.rules:
                if rule.point != point:
                    continue
                rule.seen += 1
                if self._eligible(rule):
                    fired.append(self._record(rule, None, None))
        return fired

    def fired(self, point: str) -> int:
        with self._lock:
            return self.counters.get(point, 0)

    @property
    def has_wire_rules(self) -> bool:
        return any(rule.point in WIRE_POINTS for rule in self.rules)

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"seed": self.seed, "probes": self.probes,
                    "fired": dict(self.counters),
                    "rules": [dataclasses.asdict(rule)
                              for rule in self.rules],
                    "trace": list(self.trace)}


# ---------------------------------------------------------------------------
# Wire faults: a transport-level filter (loopback broker hook).

def _wire_kind(payload) -> str | None:
    text = payload if isinstance(payload, str) else None
    if text is None:
        return None
    if text.startswith("(process_frame_response"):
        return "process_frame_response"
    if text.startswith("(process_frame"):
        return "process_frame"
    return None


def wire_fault_filter(plan: FaultPlan, republish):
    """Build the broker-level filter realizing the plan's ``wire_*``
    rules.  ``republish(topic, payload)`` must bypass the filter (used
    for delayed and duplicated delivery).  Only frame traffic
    (``process_frame`` / ``process_frame_response``) is ever touched --
    registrar/discovery/share messages pass through untouched, so chaos
    stays aimed at the data plane."""

    def filt(topic, payload):
        kind = _wire_kind(payload)
        if kind is None:
            return (topic, payload)
        if plan.should("wire_drop", target=kind, topic=topic) is not None:
            _logger.warning("wire fault: dropped %s on %s", kind, topic)
            return None
        rule = plan.should("wire_delay", target=kind, topic=topic)
        if rule is not None:
            timer = threading.Timer(rule.delay_ms / 1000.0, republish,
                                    (topic, payload))
            timer.daemon = True
            timer.start()
            return None
        if plan.should("wire_dup", target=kind, topic=topic) is not None:
            republish(topic, payload)          # the duplicate
        if plan.should("wire_corrupt", target=kind,
                       topic=topic) is not None:
            text = payload if isinstance(payload, str) else str(payload)
            return (topic, text[: max(1, len(text) // 2)] + " %CHAOS%")
        return (topic, payload)

    return filt
