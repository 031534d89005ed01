"""ONE QoS admission authority (ISSUE 12 tentpole).

Admission decisions used to live in FOUR independent planes --
``DeviceWindow`` pacing (pipeline/overlap.py), ``StageScheduler``
credits and ``ReplicaGroup`` per-slot windows (pipeline/stages.py), and
the batchers (models/batching.py) -- so a frame's "priority" meant
nothing end to end: an interactive frame could jump the stage queue
only to sit behind a batch burst at the batcher.  This module is the
single authority those planes now consult: **tenant -> class ->
budget**, resolved once per frame at ingest and honored identically at
every seam (Vortex, PAPERS.md: hosting inference under tight latency
AND throughput requirements needs one scheduler, not four).

The vocabulary:

- **Priority classes** (``interactive`` / ``standard`` / ``batch`` by
  default; weights configurable) order admission everywhere a frame
  can wait.  Lower rank = more urgent.  Within one class (and one
  stream -- a stream's frames share its class) the ingest sequence
  breaks ties, so per-stream frame order and PR 3's
  anti-queue-jumping reservation discipline are preserved by
  construction: priority reorders *across* streams, never within one.
- **Promotion**: a frame within ``promote_ms`` of its
  ``frame_deadline_ms`` deadline ranks as the top class regardless of
  its own (PR 5's deadline machinery is the substrate; the promotion
  is recorded once per frame -- ``qos_promotions`` counter +
  ``gw_promote`` ring event).  Within a stream promotion is monotone
  (an earlier frame's deadline is earlier), so it cannot invert
  per-stream order either.
- **Aging**: every ``age_ms`` of queue wait improves a frame's rank by
  one class step, so the lowest class is starvation-free (bounded
  wait) even under saturating high-priority load.
- **Token buckets** rate-limit each tenant at the gateway front door
  (``rate`` requests/s, ``burst`` capacity): an over-rate frame is
  rejected before it ever touches the engine.
- **Budgets** (``budget`` = per-tenant in-flight frames) decide who
  sheds first: under overload (``max_inflight`` pipeline-wide
  in-flight frames) the scheduler picks victims over-budget-tenant
  first, then lowest class, then oldest -- so a tenant inside its
  budget keeps its SLO while the over-budget one absorbs the shed.

jax-free and import-light by design: the engine seams
(pipeline/stages.py, models/batching.py) import this module, and the
lint plane (analysis/params.py) imports :func:`qos_spec_error` as the
create-time twin of runtime validation, so pre-flight and runtime can
never disagree about what a well-formed ``qos`` block is.
"""

from __future__ import annotations

import json
import threading
import time

__all__ = ["QosScheduler", "SloTracker", "TokenBucket", "QOS_CLASSES",
           "DEFAULT_CLASS", "qos_spec_error", "slo_spec_error"]

#: default priority classes, most to least urgent; ``classes`` in the
#: ``qos`` block re-weights or extends them.
QOS_CLASSES = ("interactive", "standard", "batch")
DEFAULT_CLASS = "standard"
DEFAULT_TENANT = "default"

#: default class weights (higher = more urgent); rank order is the
#: descending-weight order.
_DEFAULT_WEIGHTS = {"interactive": 8.0, "standard": 4.0, "batch": 1.0}

PROMOTE_MS_DEFAULT = 50.0
AGE_MS_DEFAULT = 2000.0

#: Cap on LAZILY-created tenant entries (explicitly configured tenants
#: are never evicted and don't count against it).  Tenant names arrive
#: from unauthenticated clients: without a bound, cycling random names
#: grows scheduler memory and per-tenant metric cardinality forever.
#: Past the cap, unknown names share the default tenant's entry
#: (bucket + budget) -- bounded degradation, never unbounded state.
LAZY_TENANT_CAP = 1024

_TENANT_KEYS = {"rate", "burst", "budget", "class"}
_CLASS_KEYS = {"weight", "device_inflight"}
_SPEC_KEYS = {"classes", "tenants", "default_tenant", "promote_ms",
              "age_ms", "max_inflight", "session_window", "slo"}
_SLO_KEYS = {"p99_ms", "availability", "window_s"}
SLO_WINDOW_S_DEFAULT = 60.0
#: debounce between fast-burn firings for one (tenant, class) -- the
#: remediation consumer (ring event + black-box dump) must not be
#: re-triggered every result while the burn persists.
SLO_FIRE_COOLDOWN_S = 5.0


class TokenBucket:
    """Per-tenant rate limit: ``rate`` tokens/second refill into a
    ``burst``-deep bucket; each admitted frame takes one.  ``rate`` 0 =
    unlimited (the bucket never engages).  Thread-safe: the gateway's
    connection threads admit concurrently."""

    def __init__(self, rate: float = 0.0, burst: float = 1.0):
        self.rate = max(0.0, float(rate))
        self.burst = max(1.0, float(burst))
        self._level = self.burst
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def take(self, now: float | None = None) -> bool:
        if self.rate <= 0:
            return True
        now = time.monotonic() if now is None else now
        with self._lock:
            self._level = min(
                self.burst, self._level + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._level >= 1.0:
                self._level -= 1.0
                return True
            return False

    def level(self, now: float | None = None) -> float:
        if self.rate <= 0:
            return self.burst
        now = time.monotonic() if now is None else now
        with self._lock:
            return min(self.burst,
                       self._level + (now - self._stamp) * self.rate)


class _Tenant:
    """Resolved per-tenant state: bucket + budget + counters."""

    def __init__(self, name: str, spec: dict):
        self.name = name
        self.bucket = TokenBucket(spec.get("rate", 0.0),
                                  spec.get("burst", 8.0))
        self.budget = int(spec.get("budget", 0))     # 0 = unbounded
        self.default_class = str(spec.get("class", DEFAULT_CLASS))
        self.inflight = 0
        self.admitted = 0
        self.rejected = 0
        self.shed = 0

    @property
    def over_budget(self) -> bool:
        return self.budget > 0 and self.inflight > self.budget


def slo_spec_error(value) -> str | None:
    """Why an ``slo`` block is malformed, or None -- the jax-free
    create-time twin of :class:`SloTracker` construction (same
    discipline as :func:`qos_spec_error`): a typo'd objective is a
    DefinitionError at create, even under ``preflight: off``.  Shape:
    ``{class: {p99_ms: N, availability: 0..1, window_s: N}}``."""
    if isinstance(value, str):
        try:
            value = json.loads(value)
        except json.JSONDecodeError as error:
            return f"unparseable JSON ({error})"
    if not isinstance(value, dict):
        return f"expected a dict, got {type(value).__name__}"
    for name, spec in value.items():
        if not isinstance(spec, dict):
            return f"{name} must be a dict of objectives"
        bad = set(spec) - _SLO_KEYS
        if bad:
            return f"{name}: unknown keys {sorted(bad)} (one of " \
                   f"{sorted(_SLO_KEYS)})"
        if not (set(spec) & {"p99_ms", "availability"}):
            return f"{name}: declare p99_ms and/or availability"
        if "p99_ms" in spec:
            try:
                if float(spec["p99_ms"]) <= 0:
                    return f"{name}.p99_ms must be > 0"
            except (TypeError, ValueError):
                return f"{name}.p99_ms={spec['p99_ms']!r} is not a number"
        if "availability" in spec:
            try:
                availability = float(spec["availability"])
            except (TypeError, ValueError):
                return f"{name}.availability=" \
                       f"{spec['availability']!r} is not a number"
            if not 0.0 < availability < 1.0:
                return f"{name}.availability must be in (0, 1) " \
                       f"(1.0 leaves a zero error budget)"
        if "window_s" in spec:
            try:
                if float(spec["window_s"]) <= 0:
                    return f"{name}.window_s must be > 0"
            except (TypeError, ValueError):
                return f"{name}.window_s={spec['window_s']!r} is " \
                       f"not a number"
    return None


def qos_spec_error(value) -> str | None:
    """Why a ``qos`` parameter value is malformed, or None -- the
    jax-free validation twin the ``bad-parameter`` lint rule runs at
    create time, so a typo'd tenant block fails pre-flight instead of
    under load (satellite: malformed tenant/QoS blocks are create-time
    errors)."""
    if isinstance(value, str):
        try:
            value = json.loads(value)
        except json.JSONDecodeError as error:
            return f"unparseable JSON ({error})"
    if not isinstance(value, dict):
        return f"expected a dict, got {type(value).__name__}"
    unknown = set(value) - _SPEC_KEYS
    if unknown:
        return f"unknown keys {sorted(unknown)} (one of " \
               f"{sorted(_SPEC_KEYS)})"
    classes = value.get("classes", {})
    if not isinstance(classes, dict):
        return f"classes must be a dict, got {type(classes).__name__}"
    for name, spec in classes.items():
        if not isinstance(spec, dict):
            return f"classes.{name} must be a dict"
        bad = set(spec) - _CLASS_KEYS
        if bad:
            return f"classes.{name}: unknown keys {sorted(bad)}"
        try:
            weight = float(spec.get("weight", 1.0))
        except (TypeError, ValueError):
            return f"classes.{name}.weight={spec.get('weight')!r} is " \
                   f"not a number"
        if weight <= 0:
            return f"classes.{name}.weight must be > 0"
        inflight = spec.get("device_inflight")
        if inflight is not None:
            try:
                if int(inflight) < 1:
                    return f"classes.{name}.device_inflight must be >= 1"
            except (TypeError, ValueError):
                return f"classes.{name}.device_inflight=" \
                       f"{inflight!r} is not an integer"
    known = set(classes) | set(QOS_CLASSES)
    tenants = value.get("tenants", {})
    if not isinstance(tenants, dict):
        return f"tenants must be a dict, got {type(tenants).__name__}"
    entries = dict(tenants)
    if "default_tenant" in value:
        entries["default_tenant"] = value["default_tenant"]
    for name, spec in entries.items():
        if not isinstance(spec, dict):
            return f"tenants.{name} must be a dict"
        bad = set(spec) - _TENANT_KEYS
        if bad:
            return f"tenants.{name}: unknown keys {sorted(bad)}"
        for key in ("rate", "burst", "budget"):
            if key in spec:
                try:
                    if float(spec[key]) < 0:
                        return f"tenants.{name}.{key} must be >= 0"
                except (TypeError, ValueError):
                    return f"tenants.{name}.{key}={spec[key]!r} is " \
                           f"not a number"
        cls = spec.get("class")
        if cls is not None and str(cls) not in known:
            return f"tenants.{name}.class={cls!r}: one of " \
                   f"{sorted(known)}"
    for key, minimum in (("promote_ms", 0), ("age_ms", 0),
                         ("max_inflight", 0), ("session_window", 1)):
        if key in value:
            try:
                if float(value[key]) < minimum:
                    return f"{key} must be >= {minimum}"
            except (TypeError, ValueError):
                return f"{key}={value[key]!r} is not a number"
    if "slo" in value:
        problem = slo_spec_error(value["slo"])
        if problem is not None:
            return f"slo: {problem}"
        for name in value["slo"]:
            if str(name) not in known:
                return f"slo.{name}: not a declared class (one of " \
                       f"{sorted(known)})"
    return None


class SloTracker:
    """Windowed per-tenant/class error-budget burn rates from declared
    objectives (``slo: {class: {p99_ms, availability}}`` in the qos
    block).  Burn rate = (observed bad fraction) / (budgeted bad
    fraction): > 1 means the error budget is being spent faster than
    the objective allows (Vortex, PAPERS.md: per-class SLO tracking at
    the front door).  The gateway feeds it one observation per
    delivered result (+ one per front-door reject); everything here is
    jax-free, bounded, and thread-safe (gateway pump + HTTP threads).

    - latency burn: fraction of windowed samples over ``p99_ms``,
      against the 1% budget a p99 target implies.
    - availability burn: fraction of windowed samples that failed
      (error results, sheds, rejects, deadline misses), against the
      ``1 - availability`` budget.
    - overall burn = max of the declared ones.
    """

    def __init__(self, spec: dict | str | None):
        if isinstance(spec, str):
            spec = json.loads(spec) if spec else {}
        spec = dict(spec or {})
        problem = slo_spec_error(spec)
        if problem is not None:
            raise ValueError(f"slo: {problem}")
        self.objectives: dict[str, dict] = {}
        for name, entry in spec.items():
            self.objectives[str(name)] = {
                "p99_ms": (None if "p99_ms" not in entry
                           else float(entry["p99_ms"])),
                "availability": (None if "availability" not in entry
                                 else float(entry["availability"])),
                "window_s": float(entry.get("window_s",
                                            SLO_WINDOW_S_DEFAULT))}
        self._lock = threading.Lock()
        #: (tenant, cls) -> list of (monotonic stamp, e2e_ms|None, ok)
        self._samples: dict[tuple, list] = {}
        self._fired_at: dict[tuple, float] = {}
        self.fired = 0

    def tracks(self, qos_class: str | None) -> bool:
        return str(qos_class or DEFAULT_CLASS) in self.objectives

    def _window(self, qos_class: str) -> float:
        entry = self.objectives.get(qos_class)
        return SLO_WINDOW_S_DEFAULT if entry is None \
            else entry["window_s"]

    def observe(self, tenant: str | None, qos_class: str | None,
                e2e_ms: float | None, ok: bool,
                now: float | None = None) -> None:
        """One delivered result (``e2e_ms`` door-to-door) or one
        latency-less bad event (reject/shed: ``e2e_ms=None``,
        ``ok=False``)."""
        qos_class = str(qos_class or DEFAULT_CLASS)
        if qos_class not in self.objectives:
            return
        now = time.monotonic() if now is None else now
        key = (str(tenant or DEFAULT_TENANT), qos_class)
        horizon = now - self._window(qos_class)
        with self._lock:
            samples = self._samples.setdefault(key, [])
            samples.append((now, e2e_ms, bool(ok)))
            while samples and samples[0][0] < horizon:
                samples.pop(0)

    def _burn_locked(self, key: tuple, now: float) -> dict | None:
        tenant, qos_class = key
        objective = self.objectives[qos_class]
        horizon = now - objective["window_s"]
        samples = [entry for entry in self._samples.get(key, ())
                   if entry[0] >= horizon]
        if not samples:
            return None
        result = {"tenant": tenant, "cls": qos_class,
                  "samples": len(samples),
                  "window_s": objective["window_s"], "burn": 0.0}
        p99_ms = objective["p99_ms"]
        if p99_ms is not None:
            timed = [entry for entry in samples
                     if entry[1] is not None]
            over = sum(1 for entry in timed if entry[1] > p99_ms
                       or not entry[2])
            result["p99_ms_target"] = p99_ms
            result["latency_burn"] = round(
                (over / len(timed)) / 0.01, 3) if timed else 0.0
            result["burn"] = max(result["burn"],
                                 result["latency_burn"])
        availability = objective["availability"]
        if availability is not None:
            bad = sum(1 for entry in samples if not entry[2])
            result["availability_target"] = availability
            result["availability_burn"] = round(
                (bad / len(samples)) / (1.0 - availability), 3)
            result["burn"] = max(result["burn"],
                                 result["availability_burn"])
        result["burn"] = round(result["burn"], 3)
        return result

    def burn_rates(self, now: float | None = None) -> dict:
        """{tenant: {cls: burn report}} over each class's window."""
        now = time.monotonic() if now is None else now
        report: dict = {}
        with self._lock:
            for key in list(self._samples):
                entry = self._burn_locked(key, now)
                if entry is not None:
                    report.setdefault(key[0], {})[key[1]] = entry
        return report

    def fast_burns(self, now: float | None = None) -> list:
        """Newly-firing (tenant, cls, burn) triples with burn > 1,
        debounced :data:`SLO_FIRE_COOLDOWN_S` per key -- the
        remediation trigger (ring event + black-box dump; ROADMAP
        item 4's controller subscribes to exactly this)."""
        now = time.monotonic() if now is None else now
        fired = []
        with self._lock:
            for key in list(self._samples):
                entry = self._burn_locked(key, now)
                if entry is None or entry["burn"] <= 1.0:
                    continue
                last = self._fired_at.get(key, -1e9)
                if now - last < SLO_FIRE_COOLDOWN_S:
                    continue
                self._fired_at[key] = now
                self.fired += 1
                fired.append((key[0], key[1], entry["burn"]))
        return fired

    def snapshot(self, now: float | None = None) -> dict:
        return {"objectives": {name: dict(entry) for name, entry
                               in self.objectives.items()},
                "fired": self.fired,
                "tenants": self.burn_rates(now)}


class QosScheduler:
    """The one admission authority.  Holds no references into the
    engine: the planes call in with frames/classes and get ranks and
    verdicts back, so it stays unit-testable and import-cycle-free.

    Thread-safety: rank/class lookups are read-only after construction
    (safe everywhere); the mutable tenant counters (inflight,
    admit/reject/shed) are guarded by one lock because the gateway's
    connection threads and the engine loop both touch them."""

    def __init__(self, spec: dict | str | None = None):
        spec = spec or {}
        if isinstance(spec, str):
            spec = json.loads(spec)
        problem = qos_spec_error(spec)
        if problem is not None:
            raise ValueError(f"qos: {problem}")
        weights = dict(_DEFAULT_WEIGHTS)
        class_specs: dict[str, dict] = {name: {} for name in QOS_CLASSES}
        for name, entry in (spec.get("classes") or {}).items():
            class_specs.setdefault(str(name), {}).update(entry)
            if "weight" in entry:
                weights[str(name)] = float(entry["weight"])
            weights.setdefault(str(name), 1.0)
        #: class name -> rank (0 = most urgent), by descending weight;
        #: name breaks weight ties deterministically.
        ordered = sorted(class_specs,
                         key=lambda name: (-weights.get(name, 1.0), name))
        self.class_ranks: dict[str, int] = {
            name: rank for rank, name in enumerate(ordered)}
        self.classes = tuple(ordered)
        self._class_specs = class_specs
        self.promote_ms = float(spec.get("promote_ms",
                                         PROMOTE_MS_DEFAULT))
        self.age_ms = float(spec.get("age_ms", AGE_MS_DEFAULT))
        self.max_inflight = int(spec.get("max_inflight", 0))
        self.session_window = int(spec.get("session_window", 32))
        self._default_tenant_spec = dict(spec.get("default_tenant")
                                         or {})
        self._lock = threading.Lock()
        self.tenants: dict[str, _Tenant] = {}
        for name, tenant_spec in (spec.get("tenants") or {}).items():
            self.tenants[str(name)] = _Tenant(str(name), tenant_spec)
        self._configured_tenants = len(self.tenants)
        self._seq = 0
        self.promotions = 0
        self.inflight_total = 0
        #: declared objectives -> burn-rate tracker (None without an
        #: ``slo`` block); the gateway feeds it per delivered result.
        self.slo = SloTracker(spec["slo"]) if spec.get("slo") else None

    # -- resolution --------------------------------------------------------

    def resolve_class(self, name, tenant: str | None = None) -> str:
        """A stream/request's class: explicit name when known, else
        the tenant's default (falling back to the ``default_tenant``
        spec's class when the lazy entry doesn't exist yet -- the
        FIRST session of an unlisted tenant must resolve exactly like
        its second), else ``standard``."""
        if name is not None and str(name) in self.class_ranks:
            return str(name)
        entry = self.tenants.get(str(tenant or ""))
        if entry is not None \
                and entry.default_class in self.class_ranks:
            return entry.default_class
        if entry is None:
            fallback = str(self._default_tenant_spec.get("class", ""))
            if fallback in self.class_ranks:
                return fallback
        return DEFAULT_CLASS

    def tenant(self, name: str | None) -> _Tenant:
        """The tenant's resolved state, lazily created from
        ``default_tenant`` for names with no explicit block (a
        multi-tenant gateway must not require pre-registering every
        tenant -- the default block IS the policy for the long tail).
        Lazy creation is bounded at :data:`LAZY_TENANT_CAP`: past it,
        unknown names share the default entry rather than growing
        scheduler state and metric cardinality without bound."""
        key = str(name or DEFAULT_TENANT)
        with self._lock:
            entry = self.tenants.get(key)
            if entry is None:
                if len(self.tenants) >= self._configured_tenants \
                        + LAZY_TENANT_CAP:
                    entry = self.tenants.get(DEFAULT_TENANT)
                    if entry is None:
                        entry = self.tenants[DEFAULT_TENANT] = _Tenant(
                            DEFAULT_TENANT, self._default_tenant_spec)
                    return entry
                entry = self.tenants[key] = _Tenant(
                    key, self._default_tenant_spec)
            return entry

    def class_rank(self, name: str | None) -> int:
        return self.class_ranks.get(str(name or DEFAULT_CLASS),
                                    self.class_ranks.get(DEFAULT_CLASS,
                                                         0))

    def next_seq(self) -> int:
        """Global ingest sequence: the rank tiebreak that preserves
        arrival (and per-stream) order within a class."""
        with self._lock:
            self._seq += 1
            return self._seq

    # -- the four planes ---------------------------------------------------

    def rank_frame(self, frame, now: float | None = None) -> tuple:
        """Sort key for a waiting frame, used by every queue pop: the
        StageScheduler waiter queues and the pipeline-wide shed
        victim walk.  (effective class rank, ingest seq) -- promotion
        near deadline lifts to rank 0, aging subtracts one class step
        per ``age_ms`` waited."""
        now = time.monotonic() if now is None else now
        rank = self.class_rank(getattr(frame, "qos_class", None))
        promoted = False
        deadline = getattr(frame, "deadline", None)
        if deadline is not None and rank > 0 and self.promote_ms > 0 \
                and (deadline - now) * 1000.0 <= self.promote_ms:
            rank = 0
            promoted = True
        enqueued = getattr(frame, "qos_wait_start", None)
        if not promoted and rank > 0 and self.age_ms > 0 \
                and enqueued is not None:
            rank = max(0, rank - int((now - enqueued) * 1000.0
                                     // self.age_ms))
        if promoted and not getattr(frame, "qos_promoted", False):
            frame.qos_promoted = True
            with self._lock:
                self.promotions += 1
        return rank, getattr(frame, "qos_seq", 0)

    def device_limit(self, qos_class: str | None, base: int) -> int:
        """Plane 1 -- DeviceWindow pacing: a class may declare its own
        ``device_inflight`` cap (e.g. batch double-buffers while
        interactive keeps the full window).  Without one the stream's
        resolved limit stands; 0/negative base means pacing is off and
        the class cap (if any) becomes the bound."""
        spec = self._class_specs.get(str(qos_class or DEFAULT_CLASS))
        cap = None if spec is None else spec.get("device_inflight")
        if cap is None:
            return base
        cap = int(cap)
        return cap if base is None or base <= 0 else min(base, cap)

    def latency_sensitive(self, qos_class: str | None) -> bool:
        """Plane 3 -- ReplicaGroup slot pick: rank-0 classes pick the
        least-loaded live replica (head-of-line latency) instead of
        round-robin (throughput fairness)."""
        return self.class_rank(qos_class) == 0

    # -- gateway admission + budgets ---------------------------------------

    def admit(self, tenant_name: str | None,
              qos_class: str | None = None) -> tuple[bool, str]:
        """Front-door admission for one frame: (admitted, reason).
        Only the token bucket rejects here -- budget overruns shed
        later (under actual overload) rather than rejecting eagerly,
        so an over-budget tenant still gets service when the engine
        has headroom."""
        entry = self.tenant(tenant_name)
        if not entry.bucket.take():
            with self._lock:
                entry.rejected += 1
            return False, "rate"
        with self._lock:
            entry.admitted += 1
        return True, ""

    def frame_started(self, tenant_name: str | None) -> None:
        entry = self.tenant(tenant_name)
        with self._lock:
            entry.inflight += 1
            self.inflight_total += 1

    def frame_finished(self, tenant_name: str | None) -> None:
        entry = self.tenant(tenant_name)
        with self._lock:
            entry.inflight = max(0, entry.inflight - 1)
            self.inflight_total = max(0, self.inflight_total - 1)

    def count_shed(self, tenant_name: str | None) -> None:
        entry = self.tenant(tenant_name)
        with self._lock:
            entry.shed += 1

    def overloaded(self) -> bool:
        """Pipeline-wide in-flight cap (``max_inflight``; 0 = off) --
        the trigger for qos-ranked shedding across ALL streams, where
        the per-stream ``overload_limit`` cannot express "batch
        absorbs the shedding"."""
        return self.max_inflight > 0 \
            and self.inflight_total >= self.max_inflight

    def budget_snapshot(self) -> dict:
        """{tenant: over_budget} in ONE locked pass -- the shed walk
        ranks every queued frame against this snapshot instead of
        taking the scheduler lock per candidate (an overloaded ingest
        scans up to ``max_inflight`` frames on the event loop, exactly
        when the gateway threads contend hardest)."""
        with self._lock:
            return {name: entry.over_budget
                    for name, entry in self.tenants.items()}

    def shed_key(self, frame, budgets: dict | None = None) -> tuple:
        """Victim ordering under overload: BIGGEST key sheds first --
        over-budget tenants, then the lowest class, then the oldest
        frame (its deadline is nearest to being missed anyway).
        ``budgets`` is a :meth:`budget_snapshot` (pass one when
        ranking many frames); absent, the live entry is consulted."""
        name = getattr(frame, "tenant", None)
        if budgets is not None:
            over = budgets.get(str(name or DEFAULT_TENANT), False)
        else:
            over = self.tenant(name).over_budget
        return (1 if over else 0,
                self.class_rank(getattr(frame, "qos_class", None)),
                -getattr(frame, "qos_seq", 0))

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        slo = None if self.slo is None else self.slo.snapshot()
        with self._lock:
            return {
                "slo": slo,
                "classes": {name: rank for name, rank
                            in self.class_ranks.items()},
                "promote_ms": self.promote_ms,
                "age_ms": self.age_ms,
                "max_inflight": self.max_inflight,
                "inflight_total": self.inflight_total,
                "promotions": self.promotions,
                "tenants": {
                    name: {"inflight": entry.inflight,
                           "budget": entry.budget,
                           "over_budget": entry.over_budget,
                           "admitted": entry.admitted,
                           "rejected": entry.rejected,
                           "shed": entry.shed,
                           "class": entry.default_class}
                    for name, entry in self.tenants.items()}}

    @staticmethod
    def parse(spec) -> "QosScheduler | None":
        """``qos`` pipeline-parameter value -> scheduler (None when
        absent/falsy); raises ValueError with the qos_spec_error
        diagnostic on malformed input (the ``preflight: off`` escape
        hatch must not smuggle a bad block past create)."""
        if not spec:
            return None
        return QosScheduler(spec)
