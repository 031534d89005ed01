"""Guarded elastic fleet controller (ISSUE 20): close the loop from
attribution to remediation.

After ISSUE 19 everything is observable -- per-frame bucket
attribution (``Pipeline.explain``), QoS pressure
(``QosScheduler.stats``), per-tenant SLO burn rates (``SloTracker``)
-- and after ISSUEs 7/13 every remedial action is safe (replica
failover + half-open canary re-admission, drain/adopt, zero-drop
rolling restarts).  This module makes the fleet ACT on its own
evidence, through three actuator tiers that all drive machinery which
already exists:

- **knob tuning** -- queue-dominated traffic deepens the stage credit
  window (``stage_inflight``) or scales replicas through the existing
  ``autoscale_replicas`` loop; fetch/hop-dominated traffic widens the
  async-dispatch overlap (``device_inflight``); pacing-dominated
  traffic admits more through the QoS window.
- **horizontal process scaling** -- :class:`FleetSupervisor` (the
  chaos driver's supervision harness, productionized: respawn on
  SIGKILL with exponential backoff) spawns a peer pipeline process
  sharing the journal directory; the gateway discovers it through the
  registrar and routes new sessions to it; when load subsides the
  controller drains and retires it through the ISSUE 13 zero-drop
  path.
- **canary-gated version swaps** -- replica-by-replica parameter
  swaps that re-admit each swapped replica through the ISSUE 7
  half-open canary lifecycle, with automatic rollback when the
  canary's SLO burn exceeds the fleet baseline.

The robustness core is the **guardrails**, not the actions:

- hysteresis: a diagnosis must persist ``hysteresis_ticks``
  consecutive ticks before it may actuate -- oscillating load cannot
  thrash the fleet;
- per-action-kind cooldowns: the same knob is never touched twice
  within ``cooldown_ms`` (one action's effect must be observable
  before the next);
- a bounded action budget per sliding window, with LOUD refusal
  (error log + flight-recorder event + black-box dump) past it;
- ``controller: observe`` dry-run mode journals every decision it
  WOULD take, with its attribution evidence, and actuates nothing;
- fencing: any fleet-epoch change (gateway failover, journal
  adoption, drain) freezes the controller for ``fence_s`` -- it never
  fights an adoption in progress;
- the controller is a passenger, never a pilot: it runs as a guarded
  engine timer, so controller death (or a tick raising) leaves the
  fleet serving exactly as tuned.

Deliberately jax-free: signals and actuators are duck-typed off the
Pipeline, so the loop is testable against a stub in milliseconds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import deque

from ..utils import get_logger
from .process_manager import ProcessManager

__all__ = ["FleetController", "FleetSupervisor", "ControllerSpec",
           "controller_spec_error", "CONTROLLER_MODES",
           "peer_definition"]

_logger = get_logger("aiko.controller")

#: ``controller`` pipeline-parameter vocabulary ("on" resolves to act).
CONTROLLER_MODES = ("off", "observe", "act")

CONTROLLER_INTERVAL_MS_DEFAULT = 500.0
CONTROLLER_ACTION_BUDGET_DEFAULT = 4
CONTROLLER_BUDGET_WINDOW_S_DEFAULT = 30.0
CONTROLLER_HYSTERESIS_TICKS_DEFAULT = 3
CONTROLLER_COOLDOWN_MS_DEFAULT = 5000.0
CONTROLLER_FENCE_S_DEFAULT = 10.0
#: Minimum traced frames behind a bucket-share diagnosis.
CONTROLLER_MIN_FRAMES_DEFAULT = 8
#: A bucket must hold at least this share of e2e time to "dominate".
CONTROLLER_DOMINANCE_DEFAULT = 0.35
#: Ceiling for controller-driven stage_inflight / device_inflight.
CONTROLLER_KNOB_CAP_DEFAULT = 8
CANARY_WATCH_TICKS_DEFAULT = 4
CANARY_BURN_RATIO_DEFAULT = 1.5
#: Sustained burn (fraction of budget burn rate) that justifies a
#: process-level scale-out while the QoS window is saturated.
FLEET_SPAWN_BURN_DEFAULT = 1.0

_SPEC_FIELDS = {
    "mode": ("off", "on", "observe", "act"),
    "interval_ms": (1.0, None),
    "action_budget": (1.0, None),
    "budget_window_s": (1.0, None),
    "hysteresis_ticks": (1.0, None),
    "cooldown_ms": (0.0, None),
    "fence_s": (0.0, None),
    "min_frames": (1.0, None),
    "dominance": (0.0, 1.0),
    "knob_cap": (1.0, None),
    "fleet_min": (1.0, None),
    "fleet_max": (1.0, None),
    "fleet_definition": None,
    "canary_watch_ticks": (1.0, None),
    "canary_burn_ratio": (1.0, None),
    "spawn_burn": (0.0, None),
}


def controller_spec_error(value) -> str | None:
    """Why a ``controller`` parameter value is malformed, or None --
    the jax-free validation twin shared by the runtime parse and
    pre-flight's ``bad-parameter`` rule, so ``preflight: off`` cannot
    smuggle a block the runtime would choke on (the qos/slo/mesh
    discipline)."""
    if value is None:
        return None
    if isinstance(value, str):
        text = value.strip()
        if text.startswith("{"):
            try:
                value = json.loads(text)
            except json.JSONDecodeError as error:
                return f"unparseable JSON ({error})"
        else:
            if text.lower() in ("off", "on", "observe", "act",
                                "true", "false", "0", "1", ""):
                return None
            return f"mode {value!r}: one of off|on|observe|act " \
                   f"(or a spec dict)"
    if not isinstance(value, dict):
        return f"expected a mode string or spec dict, got {value!r}"
    for key, raw in value.items():
        domain = _SPEC_FIELDS.get(str(key), "-missing-")
        if domain == "-missing-":
            known = "|".join(sorted(_SPEC_FIELDS))
            return f"unknown key {key!r} (known: {known})"
        if domain is None:                       # free-form string
            continue
        if isinstance(domain, tuple) and domain \
                and isinstance(domain[0], str):  # enum
            if str(raw).strip().lower() not in domain:
                return f"{key}={raw!r}: one of {'|'.join(domain)}"
            continue
        try:
            number = float(raw)
        except (TypeError, ValueError):
            return f"{key}={raw!r}: expected a number"
        low, high = domain
        if low is not None and number < low:
            return f"{key}={raw!r}: must be >= {low:g}"
        if high is not None and number > high:
            return f"{key}={raw!r}: must be <= {high:g}"
    fleet_min = float(value.get("fleet_min", 1))
    fleet_max = float(value.get("fleet_max", fleet_min))
    if fleet_max < fleet_min:
        return f"fleet_max={fleet_max:g} < fleet_min={fleet_min:g}"
    return None


class ControllerSpec:
    """Resolved controller configuration: the ``controller`` parameter
    (mode string or spec dict), overlaid by the flat
    ``controller_*`` / ``fleet_*`` pipeline parameters (the flat
    spellings win -- they are the operator's ``set_parameter``
    surface)."""

    def __init__(self, **overrides):
        self.mode = "off"
        self.interval_ms = CONTROLLER_INTERVAL_MS_DEFAULT
        self.action_budget = CONTROLLER_ACTION_BUDGET_DEFAULT
        self.budget_window_s = CONTROLLER_BUDGET_WINDOW_S_DEFAULT
        self.hysteresis_ticks = CONTROLLER_HYSTERESIS_TICKS_DEFAULT
        self.cooldown_ms = CONTROLLER_COOLDOWN_MS_DEFAULT
        self.fence_s = CONTROLLER_FENCE_S_DEFAULT
        self.min_frames = CONTROLLER_MIN_FRAMES_DEFAULT
        self.dominance = CONTROLLER_DOMINANCE_DEFAULT
        self.knob_cap = CONTROLLER_KNOB_CAP_DEFAULT
        self.fleet_min = 1
        self.fleet_max = 1
        self.fleet_definition = ""
        self.canary_watch_ticks = CANARY_WATCH_TICKS_DEFAULT
        self.canary_burn_ratio = CANARY_BURN_RATIO_DEFAULT
        self.spawn_burn = FLEET_SPAWN_BURN_DEFAULT
        for key, value in overrides.items():
            self._apply(key, value)

    _INTS = ("action_budget", "hysteresis_ticks", "min_frames",
             "knob_cap", "fleet_min", "fleet_max",
             "canary_watch_ticks")

    def _apply(self, key, value) -> None:
        if key == "mode":
            mode = str(value).strip().lower()
            mode = {"on": "act", "true": "act", "1": "act",
                    "false": "off", "0": "off",
                    "": "off"}.get(mode, mode)
            if mode not in CONTROLLER_MODES:
                raise ValueError(
                    f"controller mode {value!r}: one of "
                    f"off|on|observe|act")
            self.mode = mode
        elif key == "fleet_definition":
            self.fleet_definition = str(value or "")
        else:
            try:
                number = float(value)
            except (TypeError, ValueError):
                raise ValueError(
                    f"controller: {key}={value!r}: expected a number")
            setattr(self, key,
                    int(number) if key in self._INTS else number)

    @classmethod
    def parse(cls, value, parameters: dict | None = None) \
            -> "ControllerSpec":
        """Raises ValueError on a malformed block -- callers wanting
        the create-time DefinitionError run
        :func:`controller_spec_error` first (same twin)."""
        problem = controller_spec_error(value)
        if problem is not None:
            raise ValueError(f"controller: {problem}")
        spec = cls()
        if isinstance(value, str) and value.strip().startswith("{"):
            value = json.loads(value)
        if isinstance(value, dict):
            for key, raw in value.items():
                spec._apply(str(key), raw)
        elif value is not None:
            spec._apply("mode", value)
        overlay = {
            "mode": (parameters or {}).get("controller_mode"),
            "interval_ms":
                (parameters or {}).get("controller_interval_ms"),
            "action_budget":
                (parameters or {}).get("controller_action_budget"),
            "budget_window_s":
                (parameters or {}).get("controller_budget_window_s"),
            "hysteresis_ticks":
                (parameters or {}).get("controller_hysteresis_ticks"),
            "cooldown_ms":
                (parameters or {}).get("controller_cooldown_ms"),
            "fleet_min": (parameters or {}).get("fleet_min"),
            "fleet_max": (parameters or {}).get("fleet_max"),
            "fleet_definition":
                (parameters or {}).get("fleet_definition"),
            "canary_watch_ticks":
                (parameters or {}).get("canary_watch_ticks"),
            "canary_burn_ratio":
                (parameters or {}).get("canary_burn_ratio"),
        }
        for key, raw in overlay.items():
            if raw is not None:
                spec._apply(key, raw)
        if spec.fleet_max < spec.fleet_min:
            raise ValueError(
                f"controller: fleet_max={spec.fleet_max} < "
                f"fleet_min={spec.fleet_min}")
        return spec


# ---------------------------------------------------------------------------


def peer_definition(definition, name: str, journal_dir: str = "") \
        -> dict:
    """Serialize a :class:`PipelineDefinition` back to the JSON dict a
    spawned peer process can load -- with the singleton planes
    stripped: the peer gets ``controller: off`` (one pilot per fleet),
    ``gateway: off`` / ``fleet: off`` (one front door, one
    aggregator), kernel-assigned ports, and the caller's name.  The
    journal block survives (same ``journal_dir`` = the peer is
    adoptable)."""
    elements = []
    for element in definition.elements:
        entry: dict = {"name": element.name,
                       "input": list(element.input),
                       "output": list(element.output)}
        if element.parameters:
            entry["parameters"] = dict(element.parameters)
        if element.placement:
            entry["placement"] = dict(element.placement)
        deploy = {}
        if element.deploy_local is not None:
            deploy["local"] = dict(element.deploy_local)
        if element.deploy_remote is not None:
            deploy["remote"] = dict(element.deploy_remote)
        if deploy:
            entry["deploy"] = deploy
        if element.fallback:
            entry["fallback"] = element.fallback
        if element.lint_disable:
            entry["lint"] = list(element.lint_disable)
        elements.append(entry)
    parameters = dict(definition.parameters)
    for key in list(parameters):
        if key == "controller" or key.startswith("controller_") \
                or key in ("gateway", "gateway_port", "fleet",
                           "fleet_min", "fleet_max",
                           "fleet_definition", "metrics_port"):
            del parameters[key]
    parameters["controller"] = "off"
    parameters["gateway"] = "off"
    if journal_dir:
        parameters["journal"] = "on"
        parameters["journal_dir"] = journal_dir
    result = {"version": definition.version, "name": name,
              "runtime": definition.runtime,
              "graph": list(definition.graph),
              "parameters": parameters, "elements": elements}
    if definition.lint_disable:
        result["lint"] = list(definition.lint_disable)
    return result


class FleetSupervisor:
    """Production supervision harness for peer pipeline processes --
    the chaos driver's spawn/respawn machinery extracted behind one
    class (the driver now runs THIS, so every chaos walk exercises the
    production path).

    ``spawner(name) -> subprocess.Popen`` creates one peer process;
    the supervisor polls through :class:`ProcessManager` and respawns
    any peer that exits uncommanded (SIGKILL, OOM, crash) with
    exponential backoff -- reset after a stable run -- unless the peer
    was :meth:`retire`\\ d first (the controller's scale-in drain)."""

    def __init__(self, spawner, engine=None,
                 backoff_s: float = 0.5, backoff_max_s: float = 30.0,
                 stable_s: float = 30.0, time_fn=time.monotonic):
        self.spawner = spawner
        self.engine = engine
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.stable_s = stable_s
        self._time = time_fn
        self.manager = ProcessManager(engine=engine,
                                      exit_handler=self._on_exit)
        self._retiring: set = set()
        self._backoff: dict = {}        # name -> next respawn delay
        self._started: dict = {}        # name -> spawn monotonic
        self.respawns = 0
        self.retired = 0
        self._stopped = False

    # -- lifecycle ---------------------------------------------------------

    def spawn(self, name: str) -> "subprocess.Popen":
        process = self.spawner(name)
        self._started[name] = self._time()
        self._retiring.discard(name)
        self.manager.adopt(name, process)
        _logger.info("fleet supervisor: spawned %s (pid %s)", name,
                     process.pid)
        return process

    def retire(self, name: str) -> None:
        """Mark a peer as intentionally leaving (drain in progress):
        its exit is an expected retirement, not a death -- no
        respawn."""
        self._retiring.add(name)
        self._backoff.pop(name, None)

    def destroy(self, name: str) -> None:
        self.retire(name)
        self.manager.destroy(name)

    def stop_all(self, timeout: float = 5.0) -> None:
        self._stopped = True
        self.manager.destroy_all(timeout)
        self.manager.terminate()

    # -- respawn-on-death --------------------------------------------------

    def _on_exit(self, name, process, return_code) -> None:
        if self._stopped or name in self._retiring:
            self._retiring.discard(name)
            self._backoff.pop(name, None)
            self.retired += 1
            _logger.info("fleet supervisor: %s retired (rc=%s)",
                         name, return_code)
            return
        uptime = self._time() - self._started.get(name, 0.0)
        delay = self._backoff.get(name, self.backoff_s)
        if uptime >= self.stable_s:
            delay = self.backoff_s       # stable run: forgive history
        self._backoff[name] = min(self.backoff_max_s, delay * 2.0)
        _logger.warning(
            "fleet supervisor: %s died (rc=%s, uptime %.1fs); "
            "respawn in %.1fs", name, return_code, uptime, delay)
        if self.engine is not None:
            self.engine.add_oneshot_timer(
                lambda: self._respawn(name), delay)
        else:
            import threading
            timer = threading.Timer(delay, self._respawn, [name])
            timer.daemon = True
            timer.start()

    def _respawn(self, name) -> None:
        if self._stopped or name in self._retiring \
                or self.manager.get(name) is not None:
            return
        self.respawns += 1
        try:
            self.spawn(name)
        except Exception:
            _logger.exception("fleet supervisor: respawn of %s "
                              "failed", name)

    # -- introspection -----------------------------------------------------

    @property
    def size(self) -> int:
        return len(self.manager)

    def names(self) -> list:
        return sorted(self.manager.processes)

    @property
    def stats(self) -> dict:
        return {"peers": self.names(), "respawns": self.respawns,
                "retired": self.retired,
                "retiring": sorted(self._retiring)}


def default_spawner(definition, journal_dir: str = "",
                    workdir: str = "", env: dict | None = None):
    """The production ``spawner``: write the peer's definition (via
    :func:`peer_definition`) and launch ``python -m aiko_services_tpu_torch
    pipeline create`` against it, logs captured per peer -- exactly
    the chaos driver's spawn, promoted."""
    import tempfile
    workdir = workdir or tempfile.mkdtemp(prefix="aiko_fleet_")
    base_env = dict(os.environ)
    base_env.update(env or {})
    base_env.setdefault("JAX_PLATFORMS", "cpu")

    def spawn(name: str) -> subprocess.Popen:
        path = os.path.join(workdir, f"{name}.json")
        with open(path, "w") as stream:
            json.dump(peer_definition(definition, name, journal_dir),
                      stream)
        log = open(os.path.join(workdir, f"{name}.log"), "w")
        return subprocess.Popen(
            [sys.executable, "-m", "aiko_services_tpu_torch", "pipeline",
             "create", path, "-t", "mqtt", "--name", name],
            env=base_env, stdout=log, stderr=log,
            start_new_session=True)

    return spawn


# ---------------------------------------------------------------------------

#: Action kinds (cooldowns are tracked per kind; the decision journal
#: and the ``controller_actions`` counter label with them).
ACTION_KINDS = ("stage_inflight", "device_inflight", "replicas",
                "admit", "spawn", "retire", "swap", "rollback")

#: bucket_share keys -> the actuator tier they indict.
_QUEUE_BUCKETS = ("queue",)
_FETCH_BUCKETS = ("fetch", "hop", "pipe")
_PACING_BUCKETS = ("pacing",)


class FleetController:
    """The supervised control loop.  One instance per pilot pipeline,
    ticked by a guarded engine timer (``controller_interval_ms``).

    Everything is duck-typed off ``pipeline``: ``explain()`` for
    bucket attribution, ``qos`` for pressure + SLO burn,
    ``stage_scheduler`` / ``set_stage_inflight`` /
    ``set_device_inflight`` / ``autoscale_replicas`` /
    ``swap_replica_version`` for actuation, ``_rec`` / ``_blackbox``
    / ``share`` for the journal trail.  A ``supervisor``
    (:class:`FleetSupervisor`) enables the process tier; without one
    the controller is knobs-only."""

    def __init__(self, pipeline, spec: ControllerSpec,
                 supervisor: FleetSupervisor | None = None,
                 time_fn=time.monotonic):
        self.pipeline = pipeline
        self.spec = spec
        self.supervisor = supervisor
        self._time = time_fn
        self.paused = False
        self.ticks = 0
        self.decisions = 0
        self.refusals = 0
        self.actions_taken = 0
        self.rollbacks = 0
        self._actions = deque()          # budget window timestamps
        self._streak_kind: str | None = None
        self._streak = 0
        self._cooldown_until: dict = {}  # kind -> monotonic
        self._epoch: tuple | None = None
        self._fence_until = 0.0
        self._burn_hot_until = 0.0       # gateway fast-burn feed
        self._admit_cap: int | None = None
        self._peer_seq = 0
        self.swap: dict | None = None    # active canary swap state
        self.last: dict = {}             # last tick's decision surface

    # -- feeds -------------------------------------------------------------

    def note_burns(self, fired) -> None:
        """Fast-burn feed from the gateway's SLO pump (via the
        pipeline's ``note_slo_burn``): each fired entry marks the
        budget as burning NOW, which is the spawn tier's urgency
        signal (``burn_rates`` alone lags by the window)."""
        if fired:
            self._burn_hot_until = self._time() + 10.0

    # -- control surface (fleetctl) ----------------------------------------

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def status(self) -> dict:
        return {"mode": self.spec.mode, "paused": self.paused,
                "ticks": self.ticks, "decisions": self.decisions,
                "actions": self.actions_taken,
                "refusals": self.refusals,
                "rollbacks": self.rollbacks,
                "fleet_size": self.fleet_size(),
                "fenced": self._time() < self._fence_until,
                "swap": None if self.swap is None else {
                    key: self.swap[key] for key in
                    ("stage", "parameter", "swapped", "pending")},
                "budget_left": max(
                    0, self.spec.action_budget - len(self._actions)),
                "last": dict(self.last),
                "supervisor": None if self.supervisor is None
                else self.supervisor.stats}

    def force_action(self, kind: str, **detail) -> str | None:
        """Operator override (fleetctl): run one action NOW, bypassing
        hysteresis and cooldown -- but not the budget, the fence, or
        observe mode (forcing past those is exactly the thrash the
        guardrails exist to stop).  Returns a refusal reason or
        None."""
        if kind not in ACTION_KINDS:
            return f"unknown action {kind!r} (one of " \
                   f"{'|'.join(ACTION_KINDS)})"
        now = self._time()
        if now < self._fence_until:
            return "fenced: failover/adoption in progress"
        if self.spec.mode != "act":
            return f"mode is {self.spec.mode!r}: refusing to actuate"
        self._prune_budget(now)
        if len(self._actions) >= self.spec.action_budget:
            self._refuse(kind, {"forced": True}, now)
            return "action budget exhausted"
        okay = self._act(kind, dict(detail), now,
                         evidence={"forced": True})
        return None if okay else "action was a no-op (see log)"

    # -- the loop ----------------------------------------------------------

    def tick(self) -> None:
        """One control decision.  Runs on the pipeline's event loop;
        must never raise (the pipeline additionally guards the timer
        so a controller bug cannot take the fleet down with it)."""
        self.ticks += 1
        now = self._time()
        self._publish_gauges()
        if self.paused or self.spec.mode == "off":
            return
        if self._check_fence(now):
            return
        if self.swap is not None:
            self._advance_swap(now)
            return                       # one concern per tick
        signals = self._signals()
        kind, detail = self._diagnose(signals)
        self.last = {"signals": signals, "diagnosis": kind,
                     "detail": detail, "streak": self._streak}
        if kind is None:
            self._streak_kind, self._streak = None, 0
            return
        if kind == self._streak_kind:
            self._streak += 1
        else:
            self._streak_kind, self._streak = kind, 1
        self.last["streak"] = self._streak
        if self._streak < self.spec.hysteresis_ticks:
            return                       # hysteresis: not yet proven
        if now < self._cooldown_until.get(kind, 0.0):
            return                       # cooling down: quiet skip
        self._prune_budget(now)
        if len(self._actions) >= self.spec.action_budget:
            self._refuse(kind, detail, now)
            return
        self.decisions += 1
        evidence = {"signals": signals, "streak": self._streak}
        if self.spec.mode == "observe":
            self._journal("would_act", kind, detail, evidence)
            # Dry-run consumes the streak like a real action would --
            # otherwise observe mode "acts" every tick and the logged
            # cadence stops resembling what act mode would do.
            self._streak_kind, self._streak = None, 0
            self._cooldown_until[kind] = \
                now + self.spec.cooldown_ms / 1000.0
            return
        self._act(kind, detail, now, evidence)

    # -- fencing -----------------------------------------------------------

    def _fleet_epoch(self) -> tuple:
        """Anything that changes mid-adoption: gateway failover count,
        streams adopted from dead peers, our own draining flag."""
        pipeline = self.pipeline
        gateway = getattr(pipeline, "gateway", None)
        share = getattr(pipeline, "share", {})
        return (0 if gateway is None else int(gateway.failovers),
                int(share.get("streams_adopted", 0) or 0),
                bool(getattr(pipeline, "_draining", False)))

    def _check_fence(self, now: float) -> bool:
        epoch = self._fleet_epoch()
        if epoch != self._epoch:
            previous, self._epoch = self._epoch, epoch
            if previous is not None:
                self._fence_until = now + self.spec.fence_s
                self._streak_kind, self._streak = None, 0
                self._journal("fenced", "fence",
                              {"epoch": list(epoch),
                               "was": list(previous)}, {})
        if now < self._fence_until:
            self.last = {"fenced": True,
                         "epoch": list(epoch)}
            return True
        if self._epoch is not None and self._epoch[2]:
            # Draining: we are the one leaving -- never actuate.
            self.last = {"fenced": True, "draining": True}
            return True
        return False

    # -- signals -----------------------------------------------------------

    def _signals(self) -> dict:
        pipeline = self.pipeline
        report = {}
        try:
            report = pipeline.explain() or {}
        except Exception:
            _logger.exception("controller: explain() failed")
        shares = dict(report.get("bucket_share") or {})
        frames = int(report.get("frames") or 0)
        qos = getattr(pipeline, "qos", None)
        overloaded = False
        inflight = 0
        if qos is not None:
            try:
                overloaded = bool(qos.overloaded())
                inflight = int(qos.stats().get("inflight_total") or 0)
            except Exception:
                _logger.exception("controller: qos stats failed")
        burn = self._max_burn(qos)
        scheduler = getattr(pipeline, "stage_scheduler", None)
        waiting = 0
        if scheduler is not None:
            waiting = sum(scheduler.waiting(stage)
                          for stage in scheduler.stages)
        return {"bucket_share": {key: round(value, 4)
                                 for key, value in shares.items()},
                "frames": frames, "overloaded": overloaded,
                "inflight": inflight, "waiting": waiting,
                "burn": round(burn, 3),
                "burn_hot": self._time() < self._burn_hot_until,
                "fleet_size": self.fleet_size()}

    def _max_burn(self, qos) -> float:
        tracker = getattr(qos, "slo", None)
        if tracker is None:
            return 0.0
        try:
            burns = tracker.burn_rates()
        except Exception:
            _logger.exception("controller: burn_rates failed")
            return 0.0
        worst = 0.0
        for classes in burns.values():
            for entry in classes.values():
                worst = max(worst, float(entry.get("burn") or 0.0))
        return worst

    def fleet_size(self) -> int:
        return 1 + (0 if self.supervisor is None
                    else self.supervisor.size)

    # -- diagnosis ---------------------------------------------------------

    def _dominant(self, signals) -> tuple:
        shares = signals["bucket_share"]
        if signals["frames"] < self.spec.min_frames or not shares:
            return None, 0.0
        bucket = max(shares, key=shares.get)
        share = shares[bucket]
        if share < self.spec.dominance:
            return None, share
        return bucket, share

    def _diagnose(self, signals) -> tuple:
        """(action kind, detail) -- or (None, reason).  Priority:
        process scale-out under burning SLO, then knob tuning off the
        dominant bucket, then scale-in when idle."""
        spec = self.spec
        pipeline = self.pipeline
        if self.supervisor is not None \
                and self.fleet_size() < spec.fleet_max \
                and signals["overloaded"] \
                and (signals["burn"] >= spec.spawn_burn
                     or signals["burn_hot"]):
            return "spawn", {"burn": signals["burn"],
                             "fleet_size": self.fleet_size()}
        bucket, share = self._dominant(signals)
        if bucket in _QUEUE_BUCKETS:
            if getattr(pipeline, "_has_elastic_replicas",
                       lambda: False)():
                return "replicas", {"bucket": bucket, "share": share}
            scheduler = getattr(pipeline, "stage_scheduler", None)
            depth = getattr(scheduler, "depth", spec.knob_cap)
            if depth < spec.knob_cap:
                return "stage_inflight", {"bucket": bucket,
                                          "share": share,
                                          "to": depth + 1}
            return None, {"why": f"{bucket}-dominated but "
                                 f"stage_inflight at cap"}
        if bucket in _FETCH_BUCKETS:
            current = self._device_inflight()
            if 1 <= current < spec.knob_cap:
                return "device_inflight", {"bucket": bucket,
                                           "share": share,
                                           "to": current + 1}
            return None, {"why": f"{bucket}-dominated but "
                                 f"device_inflight {current} not "
                                 f"widenable (0 = operator opt-out)"}
        if bucket in _PACING_BUCKETS:
            qos = getattr(pipeline, "qos", None)
            limit = int(getattr(qos, "max_inflight", 0) or 0)
            if limit > 0:
                if self._admit_cap is None:
                    self._admit_cap = 4 * limit
                if limit < self._admit_cap:
                    return "admit", {"bucket": bucket,
                                     "share": share,
                                     "to": limit + 1}
            return None, {"why": "pacing-dominated but no bounded "
                                 "QoS window to widen"}
        if self.supervisor is not None \
                and self.fleet_size() > spec.fleet_min \
                and not signals["overloaded"] \
                and signals["inflight"] == 0 \
                and signals["waiting"] == 0 \
                and signals["burn"] < 1.0 and not signals["burn_hot"]:
            return "retire", {"fleet_size": self.fleet_size()}
        return None, {"why": "no dominant signal"}

    def _device_inflight(self) -> int:
        pipeline = self.pipeline
        try:
            from ..utils import parse_number
            return int(parse_number(
                pipeline.get_pipeline_parameter("device_inflight"),
                0))
        except Exception:
            return 0

    # -- actuation ---------------------------------------------------------

    def _act(self, kind: str, detail: dict, now: float,
             evidence: dict | None = None) -> bool:
        handler = getattr(self, f"_act_{kind}", None)
        okay = False
        try:
            okay = bool(handler(detail)) if handler else False
        except Exception:
            _logger.exception("controller: action %s failed", kind)
        if okay:
            self.actions_taken += 1
            self._actions.append(now)
            self._cooldown_until[kind] = \
                now + self.spec.cooldown_ms / 1000.0
            self._streak_kind, self._streak = None, 0
            self._journal("action", kind, detail, evidence or {})
            self._count("controller_actions", kind)
        return okay

    def _act_stage_inflight(self, detail) -> bool:
        pipeline = self.pipeline
        depth = int(detail.get("to") or 0)
        if depth <= 0:
            depth = getattr(pipeline.stage_scheduler, "depth", 1) + 1
        depth = min(depth, self.spec.knob_cap)
        return pipeline.set_stage_inflight(depth)

    def _act_device_inflight(self, detail) -> bool:
        depth = int(detail.get("to") or 0)
        if depth <= 0:
            depth = self._device_inflight() + 1
        depth = min(depth, self.spec.knob_cap)
        return self.pipeline.set_device_inflight(depth)

    def _act_replicas(self, detail) -> bool:
        decisions = self.pipeline.autoscale_replicas()
        detail["decisions"] = dict(decisions)
        return bool(decisions)

    def _act_admit(self, detail) -> bool:
        qos = getattr(self.pipeline, "qos", None)
        if qos is None or int(qos.max_inflight or 0) <= 0:
            return False
        to = int(detail.get("to") or qos.max_inflight + 1)
        if self._admit_cap is not None:
            to = min(to, self._admit_cap)
        if to <= qos.max_inflight:
            return False
        qos.max_inflight = to
        return True

    def _act_spawn(self, detail) -> bool:
        if self.supervisor is None \
                or self.fleet_size() >= self.spec.fleet_max:
            return False
        self._peer_seq += 1
        name = f"{getattr(self.pipeline, 'name', 'fleet')}" \
               f"-peer{self._peer_seq}"
        try:
            self.supervisor.spawn(name)
        except Exception:
            _logger.exception("controller: spawn of %s failed", name)
            return False
        detail["peer"] = name
        return True

    def _act_retire(self, detail) -> bool:
        """Scale-in: drain the youngest supervised peer through the
        ISSUE 13 zero-drop path.  The drain command rides MQTT via the
        gateway's peer map; the supervisor is told first so the exit
        reads as retirement, not death."""
        supervisor = self.supervisor
        if supervisor is None or supervisor.size == 0:
            return False
        candidates = [name for name in supervisor.names()
                      if name not in supervisor._retiring]
        if not candidates:
            return False
        name = candidates[-1]
        gateway = getattr(self.pipeline, "gateway", None)
        topic = None
        if gateway is not None:
            with gateway._peers_lock:
                topic = next((t for t, n in gateway._peers.items()
                              if n == name), None)
        supervisor.retire(name)
        if topic is not None:
            try:
                self.pipeline.runtime.message.publish(
                    f"{topic}/in", "(drain)")
            except Exception:
                _logger.exception("controller: drain publish failed")
                supervisor.destroy(name)
        else:
            # Never joined the peer pool (still compiling?): nothing
            # routes to it, a plain destroy loses no frames.
            supervisor.destroy(name)
        detail["peer"] = name
        return True

    def _act_swap(self, detail) -> bool:
        """Operator-forced swap entry (``fleetctl force-action swap``):
        delegates to the canary-gated lifecycle, never a blind flip."""
        problem = self.begin_swap(str(detail.get("stage") or ""),
                                  str(detail.get("parameter") or ""),
                                  detail.get("value"))
        if problem is not None:
            detail["refused"] = problem
            _logger.error("controller: swap refused: %s", problem)
            return False
        return True

    def _act_rollback(self, detail) -> bool:
        if self.swap is None:
            detail["refused"] = "no swap in flight"
            return False
        self._rollback_swap("operator-forced rollback")
        return True

    # -- canary-gated version swap -----------------------------------------

    def begin_swap(self, stage: str, parameter: str, value) \
            -> str | None:
        """Start a replica-by-replica canary-gated swap of one element
        parameter (the "model version" knob): each replica gets the
        new value and re-admits half-open behind a single canary frame
        (ISSUE 7); after the canary proves it, SLO burn is watched for
        ``canary_watch_ticks`` -- burn above ``canary_burn_ratio`` x
        the pre-swap baseline rolls EVERY swapped replica back.
        Returns a refusal reason or None."""
        if self.swap is not None:
            return "a swap is already in flight"
        if self.spec.mode != "act":
            return f"mode is {self.spec.mode!r}: refusing to swap"
        if self._time() < self._fence_until:
            return "fenced: failover/adoption in progress"
        scheduler = getattr(self.pipeline, "stage_scheduler", None)
        group = None if scheduler is None \
            else scheduler.groups.get(stage)
        if group is None:
            return f"stage {stage!r} is not replicated (swap " \
                   f"process-by-process via drain instead)"
        pending = [index for index, state in enumerate(group.states)
                   if state == "live"]
        if not pending:
            return f"stage {stage!r} has no live replicas"
        baseline = self._max_burn(getattr(self.pipeline, "qos", None))
        self.swap = {"stage": stage, "parameter": parameter,
                     "value": value, "pending": pending,
                     "swapped": [], "old": {}, "unit": None,
                     "watch": 0, "baseline": baseline}
        self._journal("swap_begin", "swap",
                      {"stage": stage, "parameter": parameter,
                       "replicas": list(pending),
                       "baseline_burn": round(baseline, 3)}, {})
        return None

    def _advance_swap(self, now: float) -> None:
        swap = self.swap
        pipeline = self.pipeline
        scheduler = getattr(pipeline, "stage_scheduler", None)
        group = None if scheduler is None \
            else scheduler.groups.get(swap["stage"])
        if group is None:
            self._rollback_swap("stage group vanished (reassign)")
            return
        unit = swap["unit"]
        if unit is None:
            if not swap["pending"]:
                self._journal("swap_done", "swap",
                              {"stage": swap["stage"],
                               "parameter": swap["parameter"],
                               "swapped": swap["swapped"]}, {})
                self.swap = None
                return
            unit = swap["pending"].pop(0)
            swap["old"][unit] = pipeline.swap_replica_version(
                swap["stage"], unit, swap["parameter"],
                swap["value"])
            swap["unit"], swap["watch"] = unit, 0
            self._count("controller_actions", "swap")
            self.actions_taken += 1
            return
        state = group.states[unit] if unit < len(group.states) \
            else "dead"
        if state == "dead":
            self._rollback_swap(f"replica {unit} canary failed")
            return
        if state == "half_open":
            return                       # canary still in flight
        burn = self._max_burn(getattr(pipeline, "qos", None))
        threshold = max(1.0, swap["baseline"]
                        * self.spec.canary_burn_ratio)
        if burn > threshold:
            self._rollback_swap(
                f"replica {unit} burn {burn:.2f}x > "
                f"{threshold:.2f}x baseline")
            return
        swap["watch"] += 1
        if swap["watch"] >= self.spec.canary_watch_ticks:
            swap["swapped"].append(unit)
            swap["unit"] = None          # next replica

    def _rollback_swap(self, reason: str) -> None:
        swap, self.swap = self.swap, None
        pipeline = self.pipeline
        units = list(swap["swapped"])
        if swap["unit"] is not None:
            units.append(swap["unit"])
        for unit in units:
            try:
                pipeline.swap_replica_version(
                    swap["stage"], unit, swap["parameter"],
                    swap["old"].get(unit), canary=False)
            except Exception:
                _logger.exception("controller: rollback of replica "
                                  "%s failed", unit)
        self.rollbacks += 1
        self._count("canary_rollbacks", "rollback")
        share = getattr(pipeline, "share", None)
        if share is not None:
            share["canary_rollbacks"] = self.rollbacks
        self._journal("rollback", "rollback",
                      {"stage": swap["stage"],
                       "parameter": swap["parameter"],
                       "replicas": units, "reason": reason}, {})
        _logger.error("controller: canary swap rolled back: %s",
                      reason)
        try:
            pipeline._blackbox("canary_rollback", detail=reason)
        except Exception:
            pass

    # -- guardrail plumbing ------------------------------------------------

    def _prune_budget(self, now: float) -> None:
        window = self.spec.budget_window_s
        while self._actions and now - self._actions[0] > window:
            self._actions.popleft()

    def _refuse(self, kind: str, detail: dict, now: float) -> None:
        """Loud refusal: the budget exists to stop a runaway loop, and
        hitting it IS an incident signal -- error log, ring event,
        counter, black box."""
        self.refusals += 1
        _logger.error(
            "controller: action budget exhausted (%d in %.0fs): "
            "refusing %s %s", len(self._actions),
            self.spec.budget_window_s, kind, detail)
        self._journal("refusal", kind, detail,
                      {"budget": self.spec.action_budget,
                       "window_s": self.spec.budget_window_s})
        self._count("controller_refusals", kind)
        share = getattr(self.pipeline, "share", None)
        if share is not None:
            share["controller_refusals"] = self.refusals
        try:
            self.pipeline._blackbox(
                "controller_refusal",
                detail=f"budget {self.spec.action_budget} exhausted "
                       f"refusing {kind}")
        except Exception:
            pass

    def _journal(self, etype: str, kind: str, detail: dict,
                 evidence: dict) -> None:
        info = {"kind": kind}
        for key, value in {**detail, **evidence}.items():
            if isinstance(value, (int, float, str, bool)):
                info[key] = value
            else:
                info[key] = json.dumps(value, default=str)[:200]
        try:
            self.pipeline._rec(f"controller_{etype}", None, None,
                               kind, None, info)
        except Exception:
            pass
        _logger.info("controller %s: %s %s", etype, kind, detail)

    def _count(self, metric: str, kind: str) -> None:
        # One literal registry call per series (the metric-registry
        # selfcheck pins emission sites to README rows).
        telemetry = getattr(self.pipeline, "telemetry", None)
        if telemetry is None:
            return
        registry = telemetry.registry
        try:
            if metric == "controller_actions":
                registry.count("controller_actions", kind=kind)
            elif metric == "controller_refusals":
                registry.count("controller_refusals", kind=kind)
            elif metric == "canary_rollbacks":
                registry.count("canary_rollbacks", kind=kind)
        except Exception:
            pass

    def _publish_gauges(self) -> None:
        share = getattr(self.pipeline, "share", None)
        if share is not None:
            share["fleet_size"] = self.fleet_size()
            share["controller_actions"] = self.actions_taken
        telemetry = getattr(self.pipeline, "telemetry", None)
        if telemetry is not None:
            try:
                telemetry.registry.gauge("fleet_size",
                                         float(self.fleet_size()))
            except Exception:
                pass
