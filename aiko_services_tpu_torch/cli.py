"""Command-line tools (reference: ``aiko_pipeline`` / ``aiko_registrar`` /
``aiko_dashboard`` console scripts, src/aiko_services/main/pipeline.py:
1826-2034, registrar.py:358, dashboard.py:771-790).

No pip entry points are assumed; everything runs via::

    python -m aiko_services_tpu_torch registrar
    python -m aiko_services_tpu_torch pipeline create def.json -fd "(x: 1)"
    python -m aiko_services_tpu_torch pipeline list
    python -m aiko_services_tpu_torch pipeline destroy NAME
    python -m aiko_services_tpu_torch recorder | storage | dashboard
"""

from __future__ import annotations

import json
import os
import sys

import click

from .runtime import init_process
from .utils import get_logger

_logger = get_logger("aiko.cli")


def _runtime(transport: str | None):
    runtime = init_process(transport=transport)
    runtime.initialize()
    return runtime


_transport_option = click.option(
    "--transport", "-t", default=None,
    help="message fabric: mqtt | loopback (default: $AIKO_TRANSPORT)")

_HOOK_ALIASES = {"pf": "pipeline.process_frame:0",
                 "pe": "pipeline.process_element:0",
                 "pep": "pipeline.process_element_post:0",
                 "ps": "pipeline.process_segment:0",
                 "psp": "pipeline.process_segment_post:0",
                 "pst": "pipeline.process_stage:0",
                 "pstp": "pipeline.process_stage_post:0",
                 "hop": "pipeline.stage_hop:0",
                 "rp": "pipeline.replacement:0"}


def _parse_hooks_spec(hooks_spec: str | None) -> list[str]:
    if not hooks_spec:
        return []
    wanted = {part.strip() for part in hooks_spec.split(",")}
    unknown = wanted - set(_HOOK_ALIASES) - {"all"}
    if unknown:
        raise click.BadParameter(
            f"unknown hooks {sorted(unknown)}; "
            f"choose from {sorted(_HOOK_ALIASES)} or 'all'")
    if "all" in wanted:
        return list(_HOOK_ALIASES.values())
    return [_HOOK_ALIASES[part] for part in wanted]


@click.group()
def main():
    """aiko_services_tpu_torch command line."""


# -- registrar --------------------------------------------------------------

@main.command()
@_transport_option
def registrar(transport):
    """Run a Registrar (discovery directory + primary election)."""
    from .services import Registrar

    runtime = _runtime(transport)
    Registrar(runtime=runtime)
    runtime.run()


# -- recorder / storage -----------------------------------------------------

@main.command()
@_transport_option
def recorder(transport):
    """Run a Recorder (namespace-wide log aggregation)."""
    from .services import Recorder

    runtime = _runtime(transport)
    Recorder(runtime=runtime)
    runtime.run()


@main.command()
@_transport_option
@click.option("--database", "-d", default="aiko_storage.db",
              help="sqlite database path")
def storage(transport, database):
    """Run a Storage actor (persistent key/value)."""
    from .services import Storage

    runtime = _runtime(transport)
    Storage(database_path=database, runtime=runtime)
    runtime.run()


# -- pipeline ---------------------------------------------------------------

@main.group()
def pipeline():
    """Create / list / destroy dataflow pipelines."""


@pipeline.command("create")
@click.argument("definition_pathname")
@_transport_option
@click.option("--name", "-n", default=None, help="override pipeline name")
@click.option("--stream-id", "-s", default=None,
              help="create a stream with this id at startup")
@click.option("--frame-data", "-fd", default=None,
              help="frame data for the startup stream, e.g. '(x: 1)'")
@click.option("--parameter", "-p", "parameters", nargs=2, multiple=True,
              help="stream parameter NAME VALUE (repeatable)")
@click.option("--frame-rate", "-fr", default=0.0,
              help="frame generator rate limit (frames/sec, 0 = max)")
@click.option("--profile", "profile_dir", default=None,
              help="write a torch.profiler Chrome trace to DIR with "
                   "per-element spans while running")
@click.option("--hooks", "hooks_spec", default=None,
              help="attach the default printing handler to hooks: "
                   "comma list of pf,pe,pep,rp,all (reference "
                   "pipeline.py:1613-1625)")
@click.option("--metrics-port", default=None, type=int,
              help="serve the telemetry plane over HTTP on this port "
                   "(0 = assigned): /metrics Prometheus text, /traces "
                   "recent distributed frame traces")
@click.option("--metrics-host", default="127.0.0.1",
              help="bind address for --metrics-port (default loopback; "
                   "0.0.0.0 opts into remote scraping)")
@click.option("--fault-plan", "fault_plan", default=None,
              help="arm a chaos FaultPlan at startup: inline JSON or "
                   "@path/to/plan.json (see README 'Failure model'); "
                   "arm/disarm a RUNNING pipeline with "
                   "'pipeline update NAME -p fault_plan <json|off>'")
@click.option("--check", "strict_preflight", is_flag=True,
              help="strict pre-flight: refuse to start on lint "
                   "WARNINGS too (overrides the definition's "
                   "'preflight' parameter, including 'off')")
def pipeline_create(definition_pathname, transport, name, stream_id,
                    frame_data, parameters, frame_rate, profile_dir,
                    hooks_spec, metrics_port, metrics_host, fault_plan,
                    strict_preflight):
    """Create a Pipeline from DEFINITION_PATHNAME (JSON) and run it."""
    from .pipeline import create_pipeline
    from .utils import parse_value

    hook_names = _parse_hooks_spec(hooks_spec)   # fail before building
    if fault_plan and fault_plan.startswith("@"):
        try:
            with open(fault_plan[1:]) as fh:
                fault_plan = fh.read()
        except OSError as error:
            raise click.BadParameter(f"--fault-plan: {error}")
    if fault_plan:
        from .faults import FaultPlan
        try:                                     # fail before building
            FaultPlan.parse(fault_plan)
        except (ValueError, TypeError) as error:
            raise click.BadParameter(f"--fault-plan: {error}")
    runtime = _runtime(transport)
    instance = create_pipeline(
        definition_pathname, name=name, runtime=runtime,
        preflight="strict" if strict_preflight else None)
    if fault_plan:
        instance.arm_faults(fault_plan)
    if hook_names:
        from .runtime.hooks import default_hook_handler

        for hook_name in hook_names:
            instance.add_hook_handler(hook_name, default_hook_handler)
    metrics_server = None
    if metrics_port is not None:
        from .observability import MetricsServer

        if instance.telemetry is None:
            raise click.ClickException(
                "--metrics-port needs telemetry, but the definition "
                "sets 'telemetry: off'")
        metrics_server = MetricsServer(instance, metrics_port,
                                       host=metrics_host)
        click.echo(f"metrics on {metrics_host}:{metrics_server.port}"
                   f"/metrics (traces on /traces)")
    profiler = None
    if profile_dir:
        from .tpu import Profiler

        profiler = Profiler()
        profiler.start(profile_dir)
        profiler.attach(instance)
    try:
        if stream_id is not None or frame_data is not None:
            stream_parameters = {key: value for key, value in parameters}
            if frame_rate:
                stream_parameters["rate"] = frame_rate
            stream = instance.create_stream_local(stream_id or "1",
                                                  stream_parameters)
            if stream is None:
                raise click.ClickException(
                    f"stream {stream_id or '1'} rejected at start "
                    "(element start_stream failed; see log)")
            if frame_data:
                data = parse_value(frame_data)
                if not isinstance(data, dict):
                    raise click.BadParameter(
                        "frame data must be an S-expression dictionary, "
                        "e.g. '(x: 1)'")
                instance.create_frame_local(stream, data)
        # A drained pipeline retires its process: the rolling-restart
        # driver (and any supervisor) respawns it fresh (ISSUE 13).
        runtime.run(until=lambda: instance.share.get("drained"))
        if instance.share.get("drained"):
            click.echo("pipeline drained; exiting")
    finally:
        if profiler is not None:
            profiler.detach()
            profiler.stop()
        if metrics_server is not None:
            metrics_server.stop()


@pipeline.command("list")
@_transport_option
@click.option("--timeout", default=3.0, help="discovery wait seconds")
def pipeline_list(transport, timeout):
    """List pipelines registered in the namespace directory."""
    from .pipeline import PROTOCOL_PIPELINE
    from .services import ServiceFilter
    from .services.share import services_cache_singleton

    runtime = _runtime(transport)
    cache = services_cache_singleton(runtime)
    runtime.run(until=lambda: cache.state == "ready", timeout=timeout)
    records = cache.registry.query(
        ServiceFilter(protocol=PROTOCOL_PIPELINE))
    if cache.state != "ready":
        click.echo("warning: no registrar found", err=True)
    for record in records:
        click.echo(f"{record.topic_path}  {record.name}  "
                   f"tags={','.join(record.tags)}")
    click.echo(f"{len(records)} pipeline(s)")


def _with_named_pipeline(name, transport, timeout, action, verb):
    """Discover ONE pipeline by name and run ``action(proxy)`` against
    it (shared by destroy/update; the next named-pipeline command should
    use this too)."""
    from .pipeline import PROTOCOL_PIPELINE
    from .services import ServiceFilter, do_command

    runtime = _runtime(transport)
    done = []

    def run_action(proxy):
        action(runtime, proxy)
        done.append(proxy.topic_path)

    do_command(runtime, None,
               ServiceFilter(name=name, protocol=PROTOCOL_PIPELINE),
               run_action)
    runtime.run(until=lambda: bool(done), timeout=timeout)
    if done:
        click.echo(f"{verb} sent to {done[0]}")
    else:
        click.echo(f"pipeline {name!r} not found", err=True)
        sys.exit(1)


@pipeline.command("destroy")
@click.argument("name")
@_transport_option
@click.option("--timeout", default=3.0, help="discovery wait seconds")
def pipeline_destroy(name, transport, timeout):
    """Ask the named pipeline process to stop."""
    _with_named_pipeline(name, transport, timeout,
                         lambda runtime, proxy: proxy.stop(), "stop")


@pipeline.command("update")
@click.argument("name")
@_transport_option
@click.option("--parameter", "-p", "parameters", nargs=2, multiple=True,
              help="update a live parameter NAME VALUE (repeatable); "
                   "qualified 'Element.param' targets that element")
@click.option("--stream-id", "-s", default=None,
              help="stream id for --frame-data (created on demand)")
@click.option("--frame-data", "-fd", default=None,
              help="inject a frame, e.g. '(x: 1)'")
@click.option("--timeout", default=3.0, help="discovery wait seconds")
def pipeline_update(name, transport, parameters, stream_id, frame_data,
                    timeout):
    """Live-update a running pipeline found by NAME: set parameters
    (``set_parameter`` routes qualified names to the element) and/or
    inject a frame (reference ``aiko_pipeline update``,
    pipeline.py:1982-2034)."""
    from .utils import parse_value

    if not parameters and frame_data is None:
        raise click.UsageError("nothing to update: pass -p and/or -fd")
    data = None
    if frame_data is not None:
        data = parse_value(frame_data)
        if not isinstance(data, dict):
            raise click.BadParameter(
                "frame data must be an S-expression dictionary, "
                "e.g. '(x: 1)'")

    def send_update(runtime, proxy):
        # RemoteProxy encodes the wire format; these become
        # "(set_parameter k v)" / "(process_frame (stream_id: ..) ..)"
        # on the pipeline's in-topic.
        for key, value in parameters:
            proxy.set_parameter(key, value)
        if data is not None:
            proxy.process_frame({"stream_id": stream_id or "1"}, data)

    _with_named_pipeline(name, transport, timeout, send_update, "update")


@pipeline.command("drain")
@click.argument("name")
@_transport_option
@click.option("--timeout", default=3.0, help="discovery wait seconds")
def pipeline_drain(name, transport, timeout):
    """Cooperatively drain the named pipeline (ISSUE 13): admission
    stops, in-flight work finishes or parks in the durable journal,
    then the service announces its death so a peer adopts its streams
    -- zero frame drop.  Requires ``journal: on`` for the handoff to
    carry state."""
    _with_named_pipeline(name, transport, timeout,
                         lambda runtime, proxy: proxy.drain(), "drain")


@pipeline.command("restart")
@click.option("--name", default="*",
              help="pipeline name to restart (default: every pipeline)")
@_transport_option
@click.option("--rolling", is_flag=True, required=True,
              help="drain pipelines ONE AT A TIME, waiting for each "
                   "to hand off and exit before touching the next -- "
                   "with journaled streams and a peer to adopt them, "
                   "a zero-frame-drop fleet restart (weight swaps "
                   "included)")
@click.option("--timeout", default=30.0,
              help="seconds to wait for each drain to complete")
def pipeline_restart(name, transport, rolling, timeout):
    """Rolling restart: drain each matching pipeline in sequence.
    Each drain parks undelivered work in the journal and exits; the
    gateway re-binds its sessions to a surviving peer, which adopts
    the journal -- so the fleet serves through the whole walk.  Your
    supervisor (systemd/k8s/the chaos driver) restarts the drained
    processes; the refreshed instance rejoins the peer pool and the
    next drain can hand off to it."""
    import time as time_module

    from .pipeline import PROTOCOL_PIPELINE
    from .services import ServiceFilter
    from .services.share import services_cache_singleton

    runtime = _runtime(transport)
    cache = services_cache_singleton(runtime)
    runtime.run(until=lambda: cache.state == "ready", timeout=5.0)
    service_filter = ServiceFilter(protocol=PROTOCOL_PIPELINE) \
        if name == "*" else ServiceFilter(name=name,
                                          protocol=PROTOCOL_PIPELINE)
    records = cache.registry.query(service_filter)
    if not records:
        click.echo(f"no pipelines matching {name!r}", err=True)
        sys.exit(1)
    all_pipelines = ServiceFilter(protocol=PROTOCOL_PIPELINE)

    def peers_of(record):
        return [entry for entry in
                cache.registry.query(all_pipelines)
                if entry.topic_path != record.topic_path]

    walked = 0
    for record in records:
        if not peers_of(record):
            # Draining the last live pipeline strands its sessions
            # and leaves its journal unadopted -- refuse, like
            # replay_limit refuses unbounded replays.
            click.echo(f"  refusing to drain {record.name}: no live "
                       f"peer to adopt its streams (respawn one "
                       f"first)", err=True)
            continue
        click.echo(f"draining {record.name} ({record.topic_path})")
        runtime.message.publish(f"{record.topic_path}/in", "(drain)")
        deadline = time_module.monotonic() + timeout
        gone = lambda: cache.registry.get(record.topic_path) is None
        runtime.run(until=gone,
                    timeout=max(0.1, deadline - time_module.monotonic()))
        if not gone():
            click.echo(f"  {record.name} still serving after "
                       f"{timeout:.0f}s (journal off, or frames "
                       f"wedged past drain_timeout_ms)", err=True)
            continue
        walked += 1
        click.echo(f"  {record.name} drained and retired")
        # Wait for the supervisor's respawn to REJOIN before touching
        # the next pipeline: draining onward while the fleet is a
        # peer short risks a no-survivor handoff at the next step.
        rejoined = lambda: any(
            entry.name == record.name for entry in
            cache.registry.query(all_pipelines))
        runtime.run(until=rejoined, timeout=timeout)
        if rejoined():
            click.echo(f"  {record.name} respawned and rejoined")
        else:
            click.echo(f"  warning: no respawn of {record.name} "
                       f"within {timeout:.0f}s; continuing (next "
                       f"drain is refused unless a peer remains)",
                       err=True)
    click.echo(f"rolling restart: {walked}/{len(records)} "
               f"pipeline(s) walked")


@pipeline.command("validate")
@click.argument("definition_pathname")
def pipeline_validate(definition_pathname):
    """Parse + schema-check a pipeline definition without running it."""
    from .pipeline import load_pipeline_definition

    definition = load_pipeline_definition(definition_pathname)
    click.echo(json.dumps(
        {"name": definition.name,
         "graph": definition.graph,
         "elements": definition.element_names()}, indent=2))


# -- static analysis --------------------------------------------------------

@main.command("lint")
@click.argument("paths", nargs=-1)
@click.option("--self", "self_check", is_flag=True,
              help="run the framework self-check rules over the "
                   "aiko_services_tpu_torch sources (hook parity, span sync, "
                   "resume-post identity, parameter registry)")
@click.option("--strict", is_flag=True,
              help="exit 1 on warnings too (the `pipeline create "
                   "--check` gate)")
@click.option("--rules", "list_rules", is_flag=True,
              help="print the rule catalogue and exit")
def lint(paths, self_check, strict, list_rules):
    """aiko_lint: static dataflow, residency, and contract analysis.

    PATHS are pipeline definitions (.json) and/or element sources
    (.py files or directories).  Definitions get the dataflow +
    residency layers (exactly what `pipeline create` pre-flights);
    element sources get the residency rules standalone.  Exit 0 clean,
    1 on error findings (or any finding under --strict).
    """
    from .analysis import RULES, run_lint

    if list_rules:
        for rule, (severity, description) in RULES.items():
            click.echo(f"{rule:24} {severity:8} {description}")
        return
    if not paths and not self_check:
        raise click.UsageError(
            "nothing to lint: pass definition/source paths, --self, "
            "or --rules")
    sys.exit(run_lint(paths, self_check=self_check, strict=strict,
                      echo=click.echo))


# -- gateway load generator --------------------------------------------------

@main.command("loadgen")
@click.option("--host", default=None,
              help="target a RUNNING gateway at this host (with "
                   "--port); default builds a self-contained 2-stage "
                   "pipeline + gateway on loopback")
@click.option("--port", default=None, type=int,
              help="target gateway port (with --host)")
@click.option("--rate", default=25.0,
              help="interactive tenant arrival rate, frames/sec "
                   "(open loop)")
@click.option("--overload", default=2.0,
              help="batch tenants' combined rate as a multiple of "
                   "--rate (2.0 = 2x overload pressure)")
@click.option("--frames", default=100,
              help="frames per tenant")
@click.option("--deadline-ms", default=0.0,
              help="per-frame deadline for the interactive tenant "
                   "(0 = none)")
@click.option("--busy-ms", default=5.0,
              help="self-contained mode: per-stage busy time")
def loadgen(host, port, rate, overload, frames, deadline_ms, busy_ms):
    """Open-loop mixed-tenant load against a gateway: an interactive
    tenant at --rate plus a batch tenant at --rate * --overload,
    per-class p50/p99/goodput and per-tenant shed/reject counts as
    JSON (the same generator bench_pipeline_gateway drives)."""
    import json as json_module
    import threading

    from .gateway.loadgen import LoadSpec, run_loadgen

    specs = [
        LoadSpec("alice", "interactive", rate, int(frames),
                 data={"x": [1.0] * 16},
                 deadline_ms=deadline_ms or 0.0),
        LoadSpec("bulk", "batch", rate * overload,
                 int(frames * overload), data={"x": [1.0] * 16}),
    ]
    if host is not None and port is not None:
        click.echo(json_module.dumps(run_loadgen(host, port, specs),
                                     indent=2))
        return
    if (host is None) != (port is None):
        raise click.UsageError("--host and --port go together")
    from .pipeline import Pipeline

    runtime = _runtime("loopback")

    def stage(name):
        return {"name": name, "input": [{"name": "x"}],
                "output": [{"name": "x"}],
                "parameters": {"busy_ms": busy_ms, "factor": 2.0},
                "placement": {"devices": "auto"},
                "deploy": {"local": {
                    "module": "aiko_services_tpu_torch.elements.common",
                    "class_name": "StageWork"}}}

    instance = Pipeline(
        {"version": 0, "name": "loadgen", "runtime": "torch",
         "graph": ["(detect llm)"],
         "parameters": {
             "gateway": "on",
             "qos": {"classes": {"batch": {"device_inflight": 1}},
                     "tenants": {
                         "alice": {"class": "interactive",
                                   "budget": 64},
                         "bulk": {"class": "batch", "budget": 16}},
                     "max_inflight": 64}},
         "elements": [stage("detect"), stage("llm")]},
        runtime=runtime)
    report: list = []

    def drive():
        try:
            report.append(run_loadgen("127.0.0.1",
                                      instance.gateway.port, specs))
        finally:
            runtime.engine.terminate()

    threading.Thread(target=drive, daemon=True,
                     name="loadgen-driver").start()
    runtime.run()
    if report:
        click.echo(json_module.dumps(report[0], indent=2))


# -- fleet observability -----------------------------------------------------

@main.command("fleet")
@_transport_option
@click.option("--member", "members", multiple=True,
              help="static host:port scrape target (repeatable; "
                   "additive with registrar discovery)")
@click.option("--scrape-ms", default=None, type=float,
              help="scrape cadence (default: 1000)")
@click.option("--interval", default=2.0,
              help="seconds between terminal renders")
@click.option("--once", is_flag=True,
              help="one scrape sweep, one render, exit")
def fleet(transport, members, scrape_ms, interval, once):
    """Run a standalone fleet collector: registrar-discovered members
    (the ``metrics=`` / ``gateway=`` tags pipelines bind) plus any
    ``--member`` targets, scraped at ``/metrics/raw``, merged exactly,
    rendered as a terminal view.  jax-free -- runs anywhere."""
    import threading
    import time as time_module

    from .observability.fleet import (FLEET_SCRAPE_MS_DEFAULT,
                                      FleetCollector)

    cadence = scrape_ms if scrape_ms is not None \
        else FLEET_SCRAPE_MS_DEFAULT
    if once and members:
        # Static targets need no fabric at all: sweep, render, exit.
        collector = FleetCollector(scrape_ms=0, members=members)
        collector.scrape_once()
        click.echo(collector.render_terminal())
        return
    runtime = _runtime(transport)
    collector = FleetCollector(runtime=runtime, scrape_ms=cadence,
                               members=members)
    collector.start()

    def render_loop():
        try:
            if once:
                # Give discovery one beat to populate, then one sweep.
                time_module.sleep(max(interval, 0.5))
                collector.scrape_once()
                click.echo(collector.render_terminal())
                return
            while True:
                time_module.sleep(interval)
                click.echo(collector.render_terminal())
                click.echo("")
        finally:
            if once:
                runtime.engine.terminate()

    threading.Thread(target=render_loop, daemon=True,
                     name="fleet-render").start()
    runtime.run()


# -- critical-path explain (offline) ----------------------------------------

@main.command("explain")
@click.argument("path")
@click.option("--frame", "frame_id", type=int, default=None,
              help="restrict the timeline to ONE frame id (default: "
                   "the dump's trigger frame, or everything)")
@click.option("--stream", "stream_id", default=None,
              help="with --frame: the frame's stream id")
def explain(path, frame_id, stream_id):
    """Render a black-box dump or a saved trace offline: the causal
    timeline plus the critical-path bucket table (where did the
    frame's time go).

    PATH is a ``blackbox_*.json`` dump (written under the pipeline's
    ``blackbox_dir`` on deadline miss / replay / breaker open /
    replica failover / stream error), a single trace from
    ``GET /traces/<id>``, or a ``GET /traces`` / ``GET /explain``
    body saved to disk.  jax-free -- runs anywhere the dump landed.
    """
    from .observability import render_buckets, render_timeline
    from .observability.critical_path import attribute_events

    try:
        payload = json.loads(open(path).read())
    except (OSError, ValueError) as error:
        raise click.ClickException(f"cannot read {path}: {error}")

    if isinstance(payload, dict) \
            and isinstance(payload.get("events"), list):
        # Black-box dump: ring tail + in-flight frame states.  The
        # list check discriminates against a saved /explain?frame=
        # body, whose "events" key is an int COUNT, not the ring.
        click.echo(f"black box: {payload.get('reason', '?')} in "
                   f"pipeline {payload.get('pipeline', '?')} "
                   f"(stream {payload.get('stream')}, frame "
                   f"{payload.get('frame')})")
        if payload.get("detail"):
            click.echo(f"  {payload['detail']}")
        target = frame_id if frame_id is not None \
            else payload.get("frame")
        target_stream = stream_id if stream_id is not None \
            else payload.get("stream")
        raw = payload["events"]
        if target is not None:
            from .observability import select_frame_events
            known = {"t", "type", "stream", "frame", "name", "ms"}
            events = [(entry.get("t", 0.0), entry.get("type", "?"),
                       entry.get("stream"), entry.get("frame"),
                       entry.get("name"), entry.get("ms"),
                       {key: value for key, value in entry.items()
                        if key not in known} or None)
                      for entry in raw]
            # Same stale-same-id discipline as the live engine: the
            # dump's ring tail can span a destroyed stream AND its
            # recreated same-id successor -- only the newest
            # incarnation's frame events form one causal timeline.
            events = select_frame_events(events, target, target_stream)
            click.echo(f"\ntimeline for frame {target} "
                       f"({len(events)} event(s)):")
            report = attribute_events(events)
            for line in render_timeline(report["timeline"]):
                click.echo("  " + line)
            click.echo("\nattribution:")
            for line in render_buckets(report):
                click.echo("  " + line)
        else:
            # No trigger frame (e.g. a replica_failover dump): the
            # ring tail interleaves MANY frames, and the single-frame
            # state machine would bill one frame's waits to another's
            # compute -- render the raw interleaved timeline instead
            # (shared renderer, each line tagged with its frame) and
            # point at --frame for per-frame attribution.  The dump's
            # entries are already ``events_as_dicts`` output: reshape
            # in place, no tuple round trip.
            click.echo(f"\ninterleaved timeline "
                       f"({len(raw)} event(s)):")
            base = raw[0].get("t", 0.0) if raw else 0.0
            timeline = []
            for entry in raw:
                line_entry = dict(entry)
                line_entry["t_ms"] = round(
                    (line_entry.pop("t", 0.0) - base) * 1000.0, 3)
                frame = line_entry.pop("frame", None)
                stream = line_entry.pop("stream", None)
                if frame is not None:
                    line_entry["at"] = f"{stream}/{frame}"
                timeline.append(line_entry)
            for line in render_timeline(timeline):
                click.echo("  " + line)
            frames_seen = sorted(
                {(str(entry.get("stream")), entry.get("frame"))
                 for entry in raw if entry.get("frame") is not None})
            if frames_seen:
                click.echo(
                    "\nper-frame attribution: re-run with --frame N "
                    "[--stream S]; frames on this timeline: "
                    + ", ".join(f"{s}/{f}" for s, f in frames_seen))
        frames = payload.get("frames") or []
        if frames:
            click.echo(f"\nin-flight frames at dump time "
                       f"({len(frames)}):")
            for state in frames:
                where = state.get("paused") or state.get("waiting") \
                    or state.get("stage") or "walking"
                click.echo(f"  stream {state.get('stream')} frame "
                           f"{state.get('frame')}: at {where}, "
                           f"replays={state.get('replays', 0)}, "
                           f"age={state.get('age_s', 0)}s")
        return

    if isinstance(payload, dict) \
            and isinstance(payload.get("timeline"), list):
        # Saved /explain?frame= body (its "events" key is a COUNT).
        click.echo(f"frame {payload.get('frame')} "
                   f"(stream {payload.get('stream')}):")
        for line in render_timeline(payload["timeline"]):
            click.echo("  " + line)
        if payload.get("buckets"):
            click.echo("\nattribution:")
            for line in render_buckets(payload):
                click.echo("  " + line)
        return

    # Trace shapes: one trace, a /traces body, or an /explain report.
    traces = []
    if isinstance(payload, dict) and "spans" in payload:
        traces = [payload]
    elif isinstance(payload, dict) and "traces" in payload:
        traces = payload["traces"]
    if traces:
        if frame_id is not None:
            traces = [t for t in traces
                      if any(s.get("frame") == frame_id
                             for s in t.get("spans", []))]
        for trace in traces:
            click.echo(f"trace {trace.get('trace_id')} "
                       f"({'ok' if trace.get('okay') else 'ERROR'}):")
            spans = sorted(trace.get("spans", []),
                           key=lambda s: s.get("start", 0.0))
            base = spans[0].get("start", 0.0) if spans else 0.0
            for span in spans:
                offset = (span.get("start", 0.0) - base) * 1000.0
                click.echo(f"  +{offset:10.3f} ms  "
                           f"{span.get('kind', '?'):8} "
                           f"{span.get('name', '?'):28} "
                           f"{span.get('duration_ms', 0.0):10.3f} ms  "
                           f"{span.get('status', '')}")
            if trace.get("buckets"):
                click.echo("  attribution:")
                for line in render_buckets(trace):
                    click.echo("    " + line)
        return
    if isinstance(payload, dict) and "buckets" in payload:
        click.echo(f"aggregate over {payload.get('frames', '?')} "
                   f"frame(s):")
        for line in render_buckets(payload):
            click.echo("  " + line)
        for entry in payload.get("top", []):
            click.echo(f"  top: {entry.get('stage')}:"
                       f"{entry.get('bucket')} {entry.get('ms')} ms")
        return
    raise click.ClickException(
        "unrecognized payload: expected a blackbox_*.json dump, a "
        "trace, a /traces body, or an /explain report")


# -- weight conversion ------------------------------------------------------

@main.group()
def convert():
    """Ingest pretrained weights (HF safetensors -> port safetensors)."""


@convert.command("llama")
@click.argument("source")
@click.argument("destination")
@click.option("--max-seq", default=8192, help="serving context length")
def convert_llama_cmd(source, destination, max_seq):
    """Convert an HF Llama safetensors file/dir to a port checkpoint.

    Afterwards: pipeline elements load it via the ``checkpoint``
    parameter; ``LLMService(checkpoint=DESTINATION)`` serves it.
    """
    from .models.convert import convert_llama

    config = convert_llama(source, destination, max_seq=max_seq)
    click.echo(json.dumps({"destination": destination,
                           "config": config.__dict__}))


@convert.command("detector")
@click.argument("source")
@click.argument("destination")
def convert_detector_cmd(source, destination):
    """Convert a detector safetensors export to a port checkpoint."""
    from .models.convert import convert_detector

    convert_detector(source, destination)
    click.echo(json.dumps({"destination": destination}))


# -- media conversion -------------------------------------------------------

@main.group()
def media():
    """Media conversion (reference images_to_video / video_to_images)."""


@media.command("images-to-video")
@click.argument("pattern")
@click.argument("output")
@click.option("--rate", default=29.97, help="output frame rate")
@click.option("--codec", default="MJPG", help="fourcc codec")
def images_to_video_cmd(pattern, output, rate, codec):
    """Encode images matching PATTERN (glob or '{}' template) into the
    OUTPUT video file, via a real ImageReadFile->VideoWriteFile
    pipeline (reference elements/media/images_to_video.py:1-33)."""
    from .media_convert import images_to_video

    frames = images_to_video(pattern, output, rate=rate, codec=codec)
    click.echo(json.dumps({"frames": frames, "output": output}))


@media.command("video-to-images")
@click.argument("video")
@click.argument("pattern")
def video_to_images_cmd(video, pattern):
    """Decode VIDEO into per-frame images at PATTERN (a '{}' template,
    e.g. out/frame_{}.png), via a real VideoReadFile->ImageWriteFile
    pipeline (reference elements/media/video_to_images.py:1-42)."""
    from .media_convert import video_to_images

    frames = video_to_images(video, pattern)
    click.echo(json.dumps({"frames": frames, "pattern": pattern}))


# -- chaos ------------------------------------------------------------------

@main.command()
@click.option("--pipelines", default=2,
              help="pipeline processes to spawn (>= 2 so adoption has "
                   "a survivor)")
@click.option("--frames", default=12, help="frames the session streams")
@click.option("--mode",
              type=click.Choice(["kill", "rolling", "controller"]),
              default="kill",
              help="kill: SIGKILL one pipeline mid-stream and assert "
                   "adoption + supervised respawn; rolling: "
                   "drain+respawn every pipeline in sequence and "
                   "assert zero drops; controller: overload a pilot "
                   "running the fleet controller until it scales out, "
                   "SIGKILL the spawned peer mid-stream, and assert "
                   "respawn + zero-drop convergence")
@click.option("--hang-ms", default=0.0,
              help="SIGSTOP the victim this long before the kill "
                   "(process_hang, kill mode only)")
@click.option("--busy-ms", default=60.0, help="per-stage busy time")
@click.option("--timeout", default=180.0, help="overall deadline")
def chaos(pipelines, frames, mode, hang_ms, busy_ms, timeout):
    """Multi-process chaos driver (ISSUE 13): native MQTT broker +
    registrar + N pipeline processes sharing a journal directory, a
    standalone gateway in THIS process, and a live WebSocket session
    streaming through the fleet while pipelines die (SIGKILL) or
    drain under it.  Asserts in-order, duplicate-free, zero-drop
    delivery across the failover."""
    from .faults.chaos import run_chaos

    result = run_chaos(pipelines=pipelines, frames=frames, mode=mode,
                       hang_ms=hang_ms, busy_ms=busy_ms,
                       timeout=timeout, echo=click.echo)
    if not result.get("ok"):
        raise click.ClickException(f"chaos walk failed: {result}")
    click.echo("chaos walk passed")


# -- fleetctl (ISSUE 20: guarded elastic fleet controller) ------------------

def _fleetctl_request(name, transport, timeout, command, arguments):
    """Publish one ``(fleetctl <response_topic> <command> ...)`` to
    the named pipeline and return its JSON report (do_request
    pattern)."""
    from .pipeline import PROTOCOL_PIPELINE
    from .services import ServiceFilter, do_request

    runtime = _runtime(transport)
    reports = []

    def request(proxy, response_topic):
        proxy.fleetctl(response_topic, command, *arguments)

    def response(items):
        for reply_command, parameters in items:
            if reply_command == "fleetctl" and parameters:
                try:
                    reports.append(json.loads(str(parameters[0])))
                except ValueError:
                    reports.append({"raw": str(parameters[0])})

    do_request(runtime, None,
               ServiceFilter(name=name, protocol=PROTOCOL_PIPELINE),
               request, response)
    runtime.run(until=lambda: bool(reports), timeout=timeout)
    if not reports:
        click.echo(f"no fleetctl reply from pipeline {name!r} "
                   f"(not found, or not answering?)", err=True)
        sys.exit(1)
    report = reports[0]
    if isinstance(report, dict) and report.get("error"):
        raise click.ClickException(report["error"])
    return report


@main.group()
def fleetctl():
    """Operate a live fleet controller (``controller:`` pipelines):
    inspect its decision surface, pause/resume the loop, or force one
    guarded action."""


@fleetctl.command("status")
@click.argument("name")
@_transport_option
@click.option("--timeout", default=5.0, help="discovery wait seconds")
def fleetctl_status(name, transport, timeout):
    """Show the named pipeline's controller status: mode, fleet size,
    budget left, last decision, supervisor roster."""
    report = _fleetctl_request(name, transport, timeout, "status", ())
    click.echo(json.dumps(report, indent=2, default=str))


@fleetctl.command("pause")
@click.argument("name")
@_transport_option
@click.option("--timeout", default=5.0, help="discovery wait seconds")
def fleetctl_pause(name, transport, timeout):
    """Pause the control loop (the fleet keeps serving as tuned)."""
    report = _fleetctl_request(name, transport, timeout, "pause", ())
    click.echo(f"controller paused "
               f"(fleet_size={report.get('status', {}).get('fleet_size')})")


@fleetctl.command("resume")
@click.argument("name")
@_transport_option
@click.option("--timeout", default=5.0, help="discovery wait seconds")
def fleetctl_resume(name, transport, timeout):
    """Resume a paused control loop."""
    report = _fleetctl_request(name, transport, timeout, "resume", ())
    click.echo(f"controller resumed "
               f"(fleet_size={report.get('status', {}).get('fleet_size')})")


@fleetctl.command("force-action")
@click.argument("name")
@click.argument("kind")
@_transport_option
@click.option("--detail", default=None,
              help='action detail as JSON, e.g. \'{"to": 4}\'')
@click.option("--yes", is_flag=True,
              help="skip the confirmation prompt")
@click.option("--timeout", default=5.0, help="discovery wait seconds")
def fleetctl_force(name, transport, kind, detail, yes, timeout):
    """Force ONE action now (stage_inflight | device_inflight |
    replicas | admit | spawn | retire | swap | rollback), bypassing
    hysteresis and cooldown -- the budget, the fence, and observe
    mode still apply."""
    if detail is not None:
        try:
            json.loads(detail)
        except ValueError as error:
            raise click.BadParameter(f"--detail is not JSON: {error}")
    if not yes:
        click.confirm(f"force {kind!r} on pipeline {name!r} "
                      f"(bypasses hysteresis + cooldown)?", abort=True)
    arguments = (kind,) if detail is None else (kind, detail)
    report = _fleetctl_request(name, transport, timeout, "force",
                               arguments)
    refused = report.get("refused")
    if refused:
        raise click.ClickException(f"refused: {refused}")
    click.echo(f"forced {kind}: done "
               f"(actions={report.get('status', {}).get('actions')})")


@fleetctl.command("swap")
@click.argument("name")
@click.argument("stage")
@click.argument("parameter")
@click.argument("value")
@_transport_option
@click.option("--yes", is_flag=True,
              help="skip the confirmation prompt")
@click.option("--timeout", default=5.0, help="discovery wait seconds")
def fleetctl_swap(name, transport, stage, parameter, value, yes,
                  timeout):
    """Begin a canary-gated replica-by-replica swap of one element
    parameter (the "model version" knob) on STAGE.  VALUE is JSON
    (bare strings pass through).  Burn above the canary ratio rolls
    every swapped replica back automatically."""
    if not yes:
        click.confirm(f"swap {stage}.{parameter}={value!r} on "
                      f"{name!r} replica-by-replica (canary-gated)?",
                      abort=True)
    report = _fleetctl_request(name, transport, timeout, "swap",
                               (stage, parameter, value))
    refused = report.get("refused")
    if refused:
        raise click.ClickException(f"refused: {refused}")
    click.echo(f"swap of {stage}.{parameter} begun "
               f"(watch: fleetctl status {name})")


# -- broker -----------------------------------------------------------------

@main.command()
@click.option("--port", default=1883, help="listen port (0 = assigned)")
def broker(port):
    """Run the in-tree native MQTT broker (mosquitto equivalent)."""
    import time

    from .transport import BrokerProcess

    instance = BrokerProcess(port=port, export_env=False).start()
    click.echo(f"mqtt broker listening on {instance.port}")
    try:
        while instance.process.poll() is None:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        instance.stop()


# -- system lifecycle -------------------------------------------------------
# The reference manages its fabric with shell scripts
# (scripts/system_start.sh / system_stop.sh / system_reset.sh); with the
# broker in-tree this is a CLI: start/stop/status/reset.

def _system_state_path():
    import pathlib
    import tempfile

    base = os.environ.get("AIKO_STATE_DIR") or tempfile.gettempdir()
    return pathlib.Path(base) / "aiko_tpu_system.json"


@main.group()
def system():
    """Start/stop the single-host fabric: native broker + registrar."""


@system.command("start")
@click.option("--port", default=1883, help="broker port (0 = assigned)")
def system_start(port):
    """Launch the native MQTT broker and a registrar as detached
    background processes (reference scripts/system_start.sh)."""
    import subprocess
    import time

    from .transport.broker import broker_binary

    state_path = _system_state_path()
    if state_path.exists():
        raise click.ClickException(
            f"system already started ({state_path}); "
            "run 'system stop' first")
    # Children are detached AND get their own output files: inheriting
    # this CLI's stdout/stderr would keep those pipes open forever for
    # any caller capturing them.
    broker_log = open(state_path.with_suffix(".broker.log"), "w")
    registrar_log = open(state_path.with_suffix(".registrar.log"), "w")
    broker_process = subprocess.Popen(
        [str(broker_binary()), str(port)],
        stdout=subprocess.PIPE, stderr=broker_log, text=True,
        start_new_session=True)
    line = broker_process.stdout.readline().strip()
    if not line.startswith("LISTENING "):
        broker_process.terminate()
        raise click.ClickException(f"broker failed: {line!r}")
    actual_port = int(line.split()[1])
    environment = dict(os.environ)
    environment["AIKO_MQTT_HOST"] = "127.0.0.1"
    environment["AIKO_MQTT_PORT"] = str(actual_port)
    registrar_process = subprocess.Popen(
        [sys.executable, "-m", "aiko_services_tpu_torch", "registrar",
         "-t", "mqtt"], env=environment, start_new_session=True,
        stdout=registrar_log, stderr=registrar_log)
    time.sleep(0.5)                    # catch instant-exit failures
    if registrar_process.poll() is not None:
        broker_process.terminate()
        raise click.ClickException(
            f"registrar exited rc={registrar_process.returncode}; "
            f"see {registrar_log.name}")
    state_path.write_text(json.dumps(
        {"port": actual_port, "broker_pid": broker_process.pid,
         "registrar_pid": registrar_process.pid}))
    click.echo(f"broker :{actual_port} (pid {broker_process.pid}), "
               f"registrar (pid {registrar_process.pid})")


_SYSTEM_PROCESS_MARKS = {"broker_pid": "mqtt_broker",
                         "registrar_pid": "registrar"}


def _system_pid_matches(pid: int, mark: str) -> bool:
    """Identity check before signalling a pidfile PID: a crash + PID
    reuse must not let 'system stop' kill an unrelated process."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as stream:
            return mark.encode() in stream.read()
    except OSError:
        return False


@system.command("stop")
def system_stop():
    """Stop the processes started by 'system start'."""
    import signal as signal_module

    state_path = _system_state_path()
    if not state_path.exists():
        raise click.ClickException("system not started")
    state = json.loads(state_path.read_text())
    for key, mark in _SYSTEM_PROCESS_MARKS.items():
        name = key.split("_")[0]
        if not _system_pid_matches(state[key], mark):
            click.echo(f"{name} already gone (or pid reused)", err=True)
            continue
        try:
            os.kill(state[key], signal_module.SIGTERM)
            click.echo(f"stopped {name} (pid {state[key]})")
        except ProcessLookupError:
            click.echo(f"{name} already gone", err=True)
    state_path.unlink()


@system.command("status")
def system_status():
    """Report fabric liveness."""
    from .utils import mqtt_broker_reachable

    state_path = _system_state_path()
    if not state_path.exists():
        click.echo("system: not started")
        return
    state = json.loads(state_path.read_text())
    up = mqtt_broker_reachable("127.0.0.1", state["port"], timeout=1.0)
    click.echo(f"broker :{state['port']} "
               f"{'up' if up else 'DOWN'} (pid {state['broker_pid']})")
    registrar_up = _system_pid_matches(
        state["registrar_pid"], _SYSTEM_PROCESS_MARKS["registrar_pid"])
    click.echo(f"registrar {'up' if registrar_up else 'DOWN'} "
               f"(pid {state['registrar_pid']})")


@system.command("reset")
@_transport_option
def system_reset(transport):
    """Clear the retained registrar election record (reference
    scripts/system_reset.sh -- needed after a broker kept state across
    an unclean shutdown; live secondaries also self-heal via the
    stale-primary probe)."""
    runtime = _runtime(transport)
    runtime.message.publish(runtime.topic_registrar_boot, "",
                            retain=True)
    runtime.run(until=lambda: False, timeout=0.5)
    click.echo(f"cleared retained {runtime.topic_registrar_boot}")


# -- dashboard --------------------------------------------------------------

@main.command()
@_transport_option
def dashboard(transport):
    """Terminal dashboard: browse services, watch share dicts, tail logs."""
    from .dashboard import run_dashboard

    run_dashboard(transport)


if __name__ == "__main__":
    main()
