"""Pipeline-parameter registry (ISSUE 6).

One authoritative table of every engine-level pipeline parameter: its
value domain (for the ``bad-parameter`` dataflow rule) and a one-line
description (the README "Static analysis & pre-flight" table renders
from the same data).  The framework self-check's
``parameter-registry`` rule keeps this table honest both ways: every
parameter literal the engine reads must be registered AND documented
in README.md, and every registered parameter must still be read
somewhere -- so the table can neither rot nor drift.

Element-level parameters (``width``, ``max_new_tokens``, ...) are the
element author's namespace and deliberately NOT registered here; the
``unread-parameter`` residency rule covers those per class.

Exception: the LLM serving element's DOMAIN-constrained knobs
(``speculative: off|ngram|draft``, page/block sizes -- ISSUE 8) are
registered in :data:`ELEMENT_PARAMETERS` keyed by element class, so a
typo'd mode or a negative page size fails at create time under the
same ``bad-parameter`` rule instead of at frame N on the device
worker.  Only the registered names are validated; the rest of an
element's parameter namespace stays free-form.
"""

from __future__ import annotations

from dataclasses import dataclass

from .findings import Finding

__all__ = ["ParamSpec", "PIPELINE_PARAMETERS", "ELEMENT_PARAMETERS",
           "validate_parameters", "validate_element_parameters"]


@dataclass(frozen=True)
class ParamSpec:
    description: str
    choices: tuple = ()             # enum domain ("" allows absence)
    number: bool = False            # must parse as a number
    minimum: float | None = None    # inclusive lower bound
    maximum: float | None = None    # inclusive upper bound
    kind: str = "string"            # free-form: string | json


PIPELINE_PARAMETERS: dict[str, ParamSpec] = {
    "transfer_guard": ParamSpec(
        "device-resident swag policy for device elements",
        choices=("allow", "log", "disallow")),
    "fuse": ParamSpec(
        "fused device-segment compilation", choices=("auto", "off")),
    "stage_pipeline": ParamSpec(
        "stage-parallel execution over placed submeshes",
        choices=("auto", "off")),
    "preflight": ParamSpec(
        "static pre-flight at pipeline create: on (errors fail), "
        "strict (warnings fail too), off",
        choices=("on", "strict", "off")),
    "telemetry": ParamSpec(
        "telemetry plane (histograms, traces, /metrics)",
        choices=("on", "off", "true", "false", "0", "1")),
    "overload_policy": ParamSpec(
        "live-stream overload behavior",
        choices=("block", "shed_oldest", "shed_newest")),
    "device_inflight": ParamSpec(
        "bounded async-dispatch window depth (0 disables)",
        number=True, minimum=0),
    "stage_inflight": ParamSpec(
        "per-stage admission-window credits", number=True, minimum=1),
    "overload_limit": ParamSpec(
        "in-flight frames before the overload policy engages "
        "(0 disables)", number=True, minimum=0),
    "frame_deadline_ms": ParamSpec(
        "per-frame deadline in ms (0 disables)",
        number=True, minimum=0),
    "replay_limit": ParamSpec(
        "replays per frame across device replacements (0 = unbounded)",
        number=True, minimum=0),
    "replica_rebuild_ms": ParamSpec(
        "delay before the background rebuild of a failed replica "
        "(0 = no automatic rebuild)", number=True, minimum=0),
    "replica_canary": ParamSpec(
        "rebuilt replicas re-admit half-open behind one canary frame",
        choices=("on", "off", "true", "false", "0", "1")),
    "replica_autoscale_interval": ParamSpec(
        "replica control-loop tick in seconds (absent/0 = off)",
        number=True, minimum=0),
    "remote_retry_limit": ParamSpec(
        "undiscovered-remote retries before the frame errors "
        "(0 = forever)", number=True, minimum=0),
    "breaker_threshold": ParamSpec(
        "consecutive remote failures that open the circuit breaker "
        "(0 disables)", number=True, minimum=0),
    "breaker_cooldown_ms": ParamSpec(
        "breaker open time before the half-open probe",
        number=True, minimum=0),
    "health_check_interval": ParamSpec(
        "periodic device health probe interval in seconds "
        "(absent = off)", number=True, minimum=0),
    "health_probe_timeout": ParamSpec(
        "per-probe deadline in seconds (hung chip counts as dead)",
        number=True, minimum=0),
    "telemetry_window": ParamSpec(
        "histogram rotation window in seconds", number=True, minimum=0),
    "telemetry_interval": ParamSpec(
        "share-dict telemetry publish interval in seconds",
        number=True, minimum=0),
    "trace_capacity": ParamSpec(
        "bounded TraceBuffer size", number=True, minimum=1),
    # -- flight recorder + black-box (ISSUE 10) ------------------------
    "recorder": ParamSpec(
        "always-on flight recorder of typed engine events "
        "(off = None, every emission site no-ops)",
        choices=("on", "off", "true", "false", "0", "1")),
    "recorder_capacity": ParamSpec(
        "flight-recorder ring size in events",
        number=True, minimum=64),
    "blackbox_dir": ParamSpec(
        "directory for black-box dumps on deadline miss / replay / "
        "breaker open / replica failover / stream error "
        "(absent = no dumps; needs the recorder on -- dumps are ring "
        "snapshots)"),
    "blackbox_limit": ParamSpec(
        "black-box dump files kept (oldest pruned)",
        number=True, minimum=1),
    "compile_cache_dir": ParamSpec(
        "persistent XLA compile cache directory"),
    "fault_plan": ParamSpec(
        "chaos FaultPlan armed at startup (rules list / JSON)",
        kind="json"),
    # -- binary data plane + multi-host mesh (ISSUE 9) -----------------
    "data_plane": ParamSpec(
        "remote-stage tensor path: auto (pipe when the peer "
        "advertises one), tensor_pipe, or mqtt (control-fabric "
        "payloads only)",
        choices=("auto", "tensor_pipe", "mqtt")),
    "tensor_pipe_host": ParamSpec(
        "interface the tensor-pipe endpoint binds (default "
        "127.0.0.1; use a routable address for real multi-host)"),
    "tensor_pipe_port": ParamSpec(
        "tensor-pipe listen port (0 = kernel-assigned)",
        number=True, minimum=0),
    "pipe_claim_timeout_ms": ParamSpec(
        "how long an envelope waits for its pipe tensors before the "
        "frame is dropped like a wire drop",
        number=True, minimum=0),
    "pipe_token_capacity": ParamSpec(
        "endpoint token-store cap; must exceed in-flight forwards or "
        "evicted frames pay the claim timeout (counted)",
        number=True, minimum=1),
    "mesh": ParamSpec(
        "multi-host mesh mode: {hosts: N, coordinator, process_id} "
        "(dict or JSON; AIKO_MESH_* env equivalent)",
        kind="json"),
    # -- gateway front door + unified QoS (ISSUE 12) -------------------
    "gateway": ParamSpec(
        "HTTP + WebSocket front door service (gateway/server.py)",
        choices=("on", "off", "true", "false", "0", "1")),
    "gateway_host": ParamSpec(
        "interface the gateway binds (default 127.0.0.1; use a "
        "routable address to serve real clients)"),
    "gateway_port": ParamSpec(
        "gateway listen port (0 = kernel-assigned, echoed on "
        "share.gateway_port)", number=True, minimum=0),
    "qos": ParamSpec(
        "unified QoS policy: {classes, tenants, default_tenant, "
        "promote_ms, age_ms, max_inflight, session_window} (dict or "
        "JSON) -- the ONE admission authority every plane consults",
        kind="json"),
    # -- process-level fault domain (ISSUE 13) -------------------------
    "journal": ParamSpec(
        "durable stream journal: per-stream recoverable state at "
        "commit points, so a peer can adopt this pipeline's live "
        "streams after process death (needs a writable journal_dir "
        "-- on with none is a create-time DefinitionError)",
        choices=("on", "off", "true", "false", "0", "1")),
    "journal_dir": ParamSpec(
        "directory holding <pipeline>.journal files; shared across "
        "the fleet so survivors can re-read a dead peer's journal"),
    "journal_fsync_ms": ParamSpec(
        "batched-fsync interval for journal appends (0 = fsync every "
        "record)", number=True, minimum=0),
    "adopt_limit": ParamSpec(
        "streams one adopt command reconstructs from a dead peer's "
        "journal (the replay_limit discipline applied to adoption)",
        number=True, minimum=1),
    "drain_timeout_ms": ParamSpec(
        "how long drain waits for in-flight frames before parking "
        "the leftovers in the journal for adoption",
        number=True, minimum=0),
    "session_idle_ms": ParamSpec(
        "gateway idle-session reaping: a session with no client "
        "activity (frames/pongs) for this long frees its stream, "
        "window slots and QoS budget (0 = never reap)",
        number=True, minimum=0),
    # -- fleet observability plane (ISSUE 19) --------------------------
    "metrics_port": ParamSpec(
        "telemetry HTTP endpoint, bound pre-registration and "
        "advertised as the metrics= registrar tag the fleet "
        "aggregator discovers (0 = kernel-assigned, echoed on "
        "share.metrics_port)", number=True, minimum=0),
    "metrics_host": ParamSpec(
        "interface the metrics endpoint binds (default 127.0.0.1)"),
    "fleet": ParamSpec(
        "run the registrar-discovered fleet metrics/trace/SLO "
        "aggregator in this process (mounted at the gateway's "
        "/fleet* routes when the door is open)",
        choices=("on", "off", "true", "false", "0", "1")),
    "fleet_scrape_ms": ParamSpec(
        "fleet aggregator sweep interval over member /metrics/raw "
        "endpoints (0 = no background thread)",
        number=True, minimum=0),
    "slo": ParamSpec(
        "per-tenant SLO objectives {class: {p99_ms, availability, "
        "window_s}} (dict or JSON) -- attaches the error-budget burn "
        "engine without a qos admission block (qos: {slo: ...} is the "
        "usual home)", kind="json"),
    # -- guarded elastic fleet controller (ISSUE 20) -------------------
    "controller": ParamSpec(
        "fleet controller: off, observe (dry-run: journals every "
        "decision it WOULD take, actuates nothing), on/act -- or a "
        "spec dict {mode, interval_ms, action_budget, fleet_max, ...} "
        "(dict or JSON)", kind="json"),
    "controller_mode": ParamSpec(
        "flat override of the controller mode",
        choices=("off", "on", "observe", "act")),
    "controller_interval_ms": ParamSpec(
        "controller tick interval in ms",
        number=True, minimum=1),
    "controller_action_budget": ParamSpec(
        "actions allowed per sliding budget window; past it the "
        "controller refuses LOUDLY (error log + ring event + "
        "black box)", number=True, minimum=1),
    "controller_budget_window_s": ParamSpec(
        "sliding window the action budget counts over",
        number=True, minimum=1),
    "controller_hysteresis_ticks": ParamSpec(
        "consecutive ticks a diagnosis must persist before the "
        "controller may act on it (oscillation damping)",
        number=True, minimum=1),
    "controller_cooldown_ms": ParamSpec(
        "per-action-kind cooldown: the same knob is never touched "
        "twice within this window", number=True, minimum=0),
    "fleet_min": ParamSpec(
        "process-pool floor the controller scales within (1 = just "
        "this process)", number=True, minimum=1),
    "fleet_max": ParamSpec(
        "process-pool ceiling; > 1 arms the FleetSupervisor spawn "
        "tier (act mode only)", number=True, minimum=1),
    "fleet_definition": ParamSpec(
        "definition path spawned peers load (absent = this "
        "pipeline's definition, controller/gateway stripped)"),
    "canary_watch_ticks": ParamSpec(
        "controller ticks a swapped replica's SLO burn is watched "
        "before the next replica swaps", number=True, minimum=1),
    "canary_burn_ratio": ParamSpec(
        "burn multiple over the pre-swap baseline that rolls a "
        "canary-gated version swap back", number=True, minimum=1),
}


def mesh_spec_error(value) -> str | None:
    """Why a ``mesh`` parameter value is malformed, or None -- the
    jax-free twin of ``pipeline.tensor.distributed_mesh_spec``'s
    validation, so pre-flight and runtime can never disagree."""
    import json as _json
    if isinstance(value, str):
        try:
            value = _json.loads(value)
        except _json.JSONDecodeError as error:
            return f"unparseable JSON ({error})"
    if not isinstance(value, dict) or "hosts" not in value:
        return f"expected {{'hosts': N, ...}}, got {value!r}"
    try:
        hosts = int(value["hosts"])
    except (TypeError, ValueError):
        return f"hosts={value['hosts']!r} is not an integer"
    if hosts < 1:
        return f"hosts must be >= 1, got {hosts}"
    try:
        int(value.get("process_id") or 0)
    except (TypeError, ValueError):
        return f"process_id={value.get('process_id')!r} is not an " \
               f"integer"
    return None


#: (module, class) -> {parameter: spec}: the serving knobs with real
#: value domains (README "LLM serving" documents each).  Validated by
#: ``validate_element_parameters`` wherever the element's definition
#: entry carries a parameters block.  Keyed by the deploy module AND
#: class name so a user's unrelated class that happens to share a
#: name never has these domains imposed on it (modules normalize
#: path->dotted, see ``_module_key``).
ELEMENT_PARAMETERS: dict[tuple[str, str], dict[str, ParamSpec]] = {
    ("aiko_services_tpu_torch.elements.llm", "LLM"): {
        "decode_block_tokens": ParamSpec(
            "device-resident generation: emitted-ring tokens fetched "
            "per block (0 = host-driven decode)",
            number=True, minimum=0),
        "speculative": ParamSpec(
            "speculative multi-token decoding mode (auto probes draft "
            "vs plain at startup and keeps the winner)",
            choices=("off", "ngram", "draft", "auto")),
        "spec_autoprobe": ParamSpec(
            "allow 'speculative: auto' to run its startup micro-probe "
            "(off resolves auto to plain decode)",
            choices=("on", "off", "true", "false", "0", "1")),
        "spec_tokens": ParamSpec(
            "draft tokens proposed per speculative step",
            number=True, minimum=1),
        "spec_window": ParamSpec(
            "recent-token window the ngram draft matches against",
            number=True, minimum=4),
        "kv_page_tokens": ParamSpec(
            "paged KV cache page size in tokens (0 = monolithic)",
            number=True, minimum=0),
        "kv_pages": ParamSpec(
            "physical page-pool size (absent = full provisioning)",
            number=True, minimum=2),
        "prefix_cache": ParamSpec(
            "share KV pages across requests with a common prompt "
            "prefix (copy-on-write; requires kv_page_tokens > 0)",
            choices=("on", "off", "true", "false", "0", "1")),
        "prefix_min_tokens": ParamSpec(
            "shortest prompt the prefix cache will index or match",
            number=True, minimum=1),
        "decode_block": ParamSpec(
            "fused decode steps per dispatch (host-pipelined path)",
            number=True, minimum=1),
        "inflight": ParamSpec(
            "decode blocks kept in flight, chained device-side",
            number=True, minimum=1),
        "max_slots": ParamSpec(
            "device batch width (concurrent request slots)",
            number=True, minimum=1),
        # -- kernel plane (ISSUE 11) ----------------------------------
        "decode_kernel": ParamSpec(
            "decode-attention backend in the ops capability-probe "
            "vocabulary (ops.decode_backend); auto follows the cache "
            "structure and extent threshold",
            choices=("auto", "paged-kernel", "dense-flash",
                     "reference")),
        "sample_top_k": ParamSpec(
            "restrict sampled rows to the k highest logits via the "
            "ops top-k interface (0 = full-vocab categorical; the "
            "kernel holds candidates in one 128-lane tile)",
            number=True, minimum=0, maximum=128),
        # -- the port's device rule (device.py) ----------------------
        "device": ParamSpec(
            "where the element serves: the card (default; cuda or "
            "cuda:N) or cpu (the plain PyTorch path, no kernels)"),
    },
}


def _parse_number(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def _check_value(name: str, spec: ParamSpec, value, spot: str) \
        -> Finding | None:
    """One value against one spec -> a ``bad-parameter`` finding or
    None (shared by the pipeline- and element-level validators)."""
    if spec.choices:
        normalized = str(value).strip().lower()
        if normalized not in spec.choices:
            return Finding(
                "bad-parameter",
                f"{name}={value!r}: one of "
                f"{'|'.join(spec.choices)}", spot)
        return None
    if spec.number:
        number = _parse_number(value)
        if number is None:
            return Finding(
                "bad-parameter",
                f"{name}={value!r}: expected a number", spot)
        if spec.minimum is not None and number < spec.minimum:
            return Finding(
                "bad-parameter",
                f"{name}={value!r}: must be >= {spec.minimum:g}", spot)
        if spec.maximum is not None and number > spec.maximum:
            return Finding(
                "bad-parameter",
                f"{name}={value!r}: must be <= {spec.maximum:g}", spot)
        return None
    if spec.kind == "json" and name == "fault_plan" and value:
        try:
            from ..faults import FaultPlan
            FaultPlan.parse(value)
        except (ValueError, TypeError) as error:
            return Finding("bad-parameter", f"fault_plan: {error}", spot)
    if spec.kind == "json" and name == "mesh" and value is not None:
        # ``is not None``, not truthiness: {} and "" are malformed
        # specs the runtime rejects, so pre-flight must too.
        problem = mesh_spec_error(value)
        if problem is not None:
            return Finding("bad-parameter", f"mesh: {problem}", spot)
    if spec.kind == "json" and name == "qos" and value:
        # The gateway's tenant/class/budget policy (ISSUE 12):
        # validated by the same jax-free twin the runtime parse uses
        # (gateway/qos.py qos_spec_error), so a malformed tenant block
        # fails at create time, not under load.
        from ..gateway.qos import qos_spec_error
        problem = qos_spec_error(value)
        if problem is not None:
            return Finding("bad-parameter", f"qos: {problem}", spot)
    if spec.kind == "json" and name == "controller" \
            and value is not None:
        # Fleet controller block (ISSUE 20): same jax-free twin the
        # runtime parse uses, so a typo'd guardrail knob fails at
        # create time -- not as a controller that silently never
        # guards.
        from ..orchestration.controller import controller_spec_error
        problem = controller_spec_error(value)
        if problem is not None:
            return Finding("bad-parameter", f"controller: {problem}",
                           spot)
    if spec.kind == "json" and name == "slo" and value is not None:
        # Per-tenant SLO objectives (ISSUE 19): same jax-free twin the
        # runtime uses (gateway/qos.py slo_spec_error) -- a malformed
        # objective is a create-time finding, not a silent no-burn.
        from ..gateway.qos import slo_spec_error
        problem = slo_spec_error(value)
        if problem is not None:
            return Finding("bad-parameter", f"slo: {problem}", spot)
    return None


def validate_parameters(parameters: dict, where: str) -> list:
    """``bad-parameter`` findings for one parameters dict (pipeline
    definition level, or a stream-parameters default block)."""
    findings: list[Finding] = []
    for name, spec in PIPELINE_PARAMETERS.items():
        if name not in parameters:
            continue
        finding = _check_value(name, spec, parameters[name],
                               f"{where}.parameters.{name}")
        if finding is not None:
            findings.append(finding)
    return findings


def _module_key(module) -> str:
    """Normalize a deploy module reference (dotted name or file path)
    to the dotted form ELEMENT_PARAMETERS keys use."""
    module = str(module or "")
    if module.endswith(".py"):
        module = module[:-3]
    return module.replace("/", ".").replace("\\", ".").strip(".")


def validate_element_parameters(class_name: str, parameters: dict,
                                where: str, module: str = "") -> list:
    """``bad-parameter`` findings for one ELEMENT's parameters block,
    against the (module, class)-registered knob domains (no-op for
    classes with nothing registered)."""
    registry = ELEMENT_PARAMETERS.get(
        (_module_key(module), class_name), {})
    findings: list[Finding] = []
    for name, spec in registry.items():
        if name not in (parameters or {}):
            continue
        finding = _check_value(name, spec, parameters[name],
                               f"{where}.parameters.{name}")
        if finding is not None:
            findings.append(finding)
    return findings
