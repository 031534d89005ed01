"""Multi-process chaos driver (ISSUE 13 satellite; ISSUE 20 fleet
controller scenario): realize the ``process_kill`` / ``process_hang``
fault points as REAL signals against real OS processes.

``python -m aiko_services_tpu_torch chaos`` spawns a native MQTT broker, a
registrar, and pipeline processes sharing one journal directory, then
drives a live WebSocket session through the fleet while killing (or
draining) pipelines under it:

- ``--mode kill``     SIGKILL one pipeline mid-stream.  Its broker
  connection dies without a DISCONNECT, the broker fires the
  process-level LWT, the registrar reaps it, the gateway re-binds the
  session to a surviving peer, and the peer adopts the dead
  pipeline's journal -- the session's results resume in order with no
  duplicates.  The fleet supervisor then RESPAWNS the victim (the
  ISSUE 20 production harness), which rejoins the peer pool.
- ``--mode rolling``  drain every pipeline in sequence (respawning
  each before draining the next): the zero-frame-drop rolling
  restart, under open-loop load.
- ``--mode controller``  spawn ONE pilot pipeline running the guarded
  elastic fleet controller (``controller: act`` + its own gateway +
  a deliberately tight SLO).  Open-loop load overloads the pilot and
  burns the SLO budget; the controller must scale the fleet OUT by
  spawning a peer process.  The driver then SIGKILLs that
  controller-spawned peer mid-stream -- kill-while-scaling -- and the
  pilot's FleetSupervisor must respawn it while the gateway fails the
  bound session over; both sessions must complete in order with zero
  drops.
- ``--hang-ms N``     (with kill) SIGSTOP the victim for N ms first
  -- a wedged-but-alive process -- then SIGKILL it.

All spawning/respawning rides the production
:class:`~..orchestration.controller.FleetSupervisor` -- the driver no
longer has a private spawn harness, so every chaos walk exercises the
exact supervision path the fleet controller uses in production.

The in-process twin of this walk (same engine seams, loopback broker,
``Pipeline.kill()``) runs in tier-1: ``tests/test_failover.py`` and
``tests/test_controller.py``.  This driver is the ``slow``-marked
full-fidelity version: real processes, real signals, a real TCP
broker.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

from ..utils import get_logger

__all__ = ["run_chaos", "CHAOS_MODES"]

_logger = get_logger("aiko.chaos")

_STAGE_MODULE = "aiko_services_tpu_torch.elements.common"

CHAOS_MODES = ("kill", "rolling", "controller")


def _definition(name: str, journal_dir: str, busy_ms: float) -> dict:
    def stage(stage_name, factor):
        return {"name": stage_name, "input": [{"name": "x"}],
                "output": [{"name": "x"}],
                "parameters": {"busy_ms": busy_ms, "factor": factor},
                "placement": {"devices": 2},
                "deploy": {"local": {"module": _STAGE_MODULE,
                                     "class_name": "StageWork"}}}
    return {"version": 0, "name": name, "runtime": "torch",
            "graph": ["(work finish)"],
            "parameters": {"journal": "on", "journal_dir": journal_dir,
                           "drain_timeout_ms": 2000},
            "elements": [stage("work", 2.0), stage("finish", 3.0)]}


def _pilot_definition(name: str, journal_dir: str, busy_ms: float,
                      fleet_max: int = 2, p99_ms: float = 5.0,
                      max_inflight: int = 2,
                      cooldown_ms: float = 1500.0) -> dict:
    """The controller-mode pilot: same two-stage graph, plus its own
    gateway front door, a deliberately unmeetable SLO (p99 far below
    the stage busy time, so sustained load burns the budget
    immediately), and the fleet controller armed to scale out.
    ``bench_pipeline_controller`` reuses this with a wider
    ``fleet_max`` for the 1->3->1 ramp."""
    base = _definition(name, journal_dir, busy_ms)
    base["parameters"].update({
        "gateway": "on",
        "qos": {"max_inflight": max_inflight,
                "slo": {"standard": {"p99_ms": p99_ms,
                                     "window_s": 10.0}}},
        "controller": {"mode": "act", "interval_ms": 200,
                       "hysteresis_ticks": 2,
                       "cooldown_ms": cooldown_ms,
                       "action_budget": 8, "budget_window_s": 10,
                       "fence_s": 1.0, "fleet_max": fleet_max,
                       "spawn_burn": 1.0}})
    return base


def _peer_pids(prefix: str) -> list:
    """PIDs of ``pipeline create`` processes whose ``--name`` starts
    with ``prefix`` -- controller-spawned peers are children of the
    PILOT process, not of this driver, so signalling them means
    finding them the way an operator would."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as stream:
                argv = stream.read().split(b"\0")
        except OSError:
            continue
        if b"--name" not in argv:
            continue
        index = argv.index(b"--name")
        if index + 1 < len(argv) \
                and argv[index + 1].decode(errors="replace") \
                    .startswith(prefix):
            pids.append(int(entry))
    return pids


def run_chaos(pipelines: int = 2, frames: int = 12,
              mode: str = "kill", busy_ms: float = 60.0,
              hang_ms: float = 0.0, timeout: float = 180.0,
              echo=print) -> dict:
    """Run the multi-process chaos walk; returns a result dict with
    ``ok`` plus the delivery/failover evidence.  Raises RuntimeError
    when the fleet cannot come up (no compiler for the broker, ...)."""
    from ..gateway.client import GatewayClient
    from ..gateway.server import GatewayServer
    from ..orchestration.controller import FleetSupervisor
    from ..runtime import init_process, reset_process
    from ..transport.broker import BrokerProcess

    assert mode in CHAOS_MODES, mode
    workdir = tempfile.mkdtemp(prefix="aiko_chaos_")
    journal_dir = os.path.join(workdir, "journals")
    os.makedirs(journal_dir, exist_ok=True)
    definitions: dict[str, dict] = {}
    registrar = None
    supervisor = None
    broker = None
    runtime = None
    gateway = None
    result = {"ok": False, "mode": mode, "workdir": workdir}
    try:
        broker = BrokerProcess(port=0, export_env=True).start()
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env.setdefault(
            "XLA_FLAGS",
            "--xla_force_host_platform_device_count=8")
        env.setdefault("AIKO_CPU_DEVICES", "8")
        echo(f"broker :{broker.port}; journals in {journal_dir}")

        registrar_log = open(os.path.join(workdir, "registrar.log"),
                             "w")
        registrar = subprocess.Popen(
            [sys.executable, "-m", "aiko_services_tpu_torch", "registrar",
             "-t", "mqtt"], env=env, stdout=registrar_log,
            stderr=registrar_log, start_new_session=True)

        # The production supervision harness (ISSUE 20): the driver's
        # pipelines are spawned -- and respawned after SIGKILL -- by
        # the same FleetSupervisor the fleet controller runs.
        def spawner(name: str) -> subprocess.Popen:
            path = os.path.join(workdir, f"{name}.json")
            with open(path, "w") as stream:
                json.dump(definitions[name], stream)
            log = open(os.path.join(workdir, f"{name}.log"), "a")
            return subprocess.Popen(
                [sys.executable, "-m", "aiko_services_tpu_torch",
                 "pipeline", "create", path, "-t", "mqtt",
                 "--name", name],
                env=env, stdout=log, stderr=log,
                start_new_session=True)

        supervisor = FleetSupervisor(spawner, engine=None,
                                     backoff_s=0.5)

        runtime = init_process(transport="mqtt")
        runtime.initialize()
        deadline = time.monotonic() + timeout

        def wait_for(predicate, what):
            runtime.run(until=predicate,
                        timeout=max(1.0,
                                    deadline - time.monotonic()))
            if not predicate():
                raise RuntimeError(f"timed out waiting for {what}")

        if mode == "controller":
            return _run_controller_mode(
                result, supervisor, definitions, runtime, wait_for,
                journal_dir, frames, busy_ms, timeout, echo,
                GatewayClient)

        names = [f"chaos{index + 1}" for index in range(pipelines)]
        for name in names:
            definitions[name] = _definition(name, journal_dir,
                                            busy_ms)
            supervisor.spawn(name)

        gateway = GatewayServer(runtime=runtime)
        wait_for(lambda: len(gateway._peers) == pipelines,
                 f"{pipelines} pipeline processes (see {workdir})")
        echo(f"fleet up: {sorted(gateway._peers.values())}")

        client = GatewayClient("127.0.0.1", gateway.port,
                               timeout=timeout)
        results: list = []
        errors: list = []

        def drive():
            try:
                client.open(session="chaos", tenant="t1")
                for index in range(frames):
                    client.send_frame({"x": [float(index + 1)] * 4})
                    results.append(client.next_result(timeout=60.0))
                client.close()
            except Exception as error:       # surfaced below
                errors.append(error)

        driver = threading.Thread(target=drive, daemon=True)
        driver.start()
        wait_for(lambda: len(results) >= 2 or errors,
                 "first results")

        if mode == "kill":
            # Kill the pipeline the session is BOUND to (discovery
            # order decides the binding, so sorting by name would
            # sometimes kill the idle peer and prove nothing).
            session = gateway.sessions.get("chaos")
            bound = gateway._peers.get(session.target) \
                if session is not None and session.target else None
            victim_name = bound or sorted(gateway._peers.values())[0]
            victim = supervisor.manager.get(victim_name)
            if hang_ms > 0:
                echo(f"SIGSTOP {victim_name} (pid {victim.pid}) "
                     f"for {hang_ms:.0f} ms [process_hang]")
                victim.send_signal(signal.SIGSTOP)
                time.sleep(hang_ms / 1000.0)
                victim.send_signal(signal.SIGCONT)
            echo(f"SIGKILL {victim_name} (pid {victim.pid}) "
                 f"mid-stream [process_kill]")
            victim.kill()
            victim.wait(10.0)
            wait_for(lambda: gateway.failovers >= 1 or errors,
                     "LWT -> failover")
            echo(f"failover: sessions re-bound "
                 f"(failovers={gateway.failovers})")
            # The supervisor noticed the uncommanded exit and
            # respawns the victim with backoff: the refreshed
            # instance must rejoin the peer pool.
            wait_for(lambda: any(n == victim_name for n in
                                 gateway._peers.values()) or errors,
                     f"{victim_name} respawn to rejoin")
            echo(f"  {victim_name} respawned by the fleet "
                 f"supervisor and rejoined "
                 f"(respawns={supervisor.respawns})")
        else:                               # rolling
            for name in sorted(names):
                topic = next((t for t, n in gateway._peers.items()
                              if n == name), None)
                if topic is None:
                    echo(f"skip {name}: not in the peer pool "
                         f"(never joined or already gone)")
                    continue
                echo(f"drain {name} [rolling restart]")
                process = supervisor.manager.get(name)
                # Retire BEFORE draining: the exit is commanded, so
                # the supervisor must NOT fight the restart with a
                # respawn of its own.
                supervisor.retire(name)
                runtime.message.publish(f"{topic}/in", "(drain)")
                wait_for(lambda: topic not in gateway._peers
                         or errors, f"{name} to drain away")
                if process is not None:
                    process.wait(15.0)
                # respawn: the refreshed instance rejoins the pool
                # (its journal starts a fresh incarnation -- the
                # drained state was already adopted by a peer)
                supervisor.spawn(name)
                wait_for(lambda: any(n == name for n in
                                     gateway._peers.values())
                         or errors, f"{name} to rejoin")
                echo(f"  {name} restarted and rejoined")

        wait_for(lambda: not driver.is_alive(), "client completion")
        if errors:
            raise errors[0]
        frame_ids = [entry["frame"] for entry in results]
        ok_flags = [entry["ok"] for entry in results]
        result.update({
            "frames": frames, "delivered": len(results),
            "in_order_no_dups": frame_ids == list(range(frames)),
            "all_ok": all(ok_flags),
            "failovers": gateway.failovers,
            "respawns": supervisor.respawns,
            "dropped": frames - len(results)})
        result["ok"] = bool(result["in_order_no_dups"]
                            and result["all_ok"]
                            and result["dropped"] == 0)
        echo(f"delivered {len(results)}/{frames} in order="
             f"{result['in_order_no_dups']} ok={result['all_ok']} "
             f"dropped={result['dropped']} "
             f"failovers={gateway.failovers} "
             f"respawns={supervisor.respawns}")
        return result
    finally:
        if gateway is not None:
            gateway.stop()
        if runtime is not None:
            try:
                runtime.terminate()
            except Exception:
                pass
            reset_process()
        if supervisor is not None:
            supervisor.stop_all(5.0)
        if registrar is not None:
            if registrar.poll() is None:
                registrar.terminate()
            try:
                registrar.wait(5.0)
            except subprocess.TimeoutExpired:
                registrar.kill()
        # Controller-spawned peers are children of the PILOT process;
        # if the pilot died uncleanly they are orphans.  Sweep them.
        for pid in _peer_pids("chaospilot-peer"):
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        if broker is not None:
            broker.stop()


def _run_controller_mode(result, supervisor, definitions, runtime,
                         wait_for, journal_dir, frames, busy_ms,
                         timeout, echo, GatewayClient) -> dict:
    """The ISSUE 20 closed-loop scenario: overload the pilot until its
    controller scales the fleet out, then SIGKILL the spawned peer
    mid-stream (kill-while-scaling) and require supervised respawn
    plus zero-drop delivery on both sessions."""
    from ..pipeline.pipeline import PROTOCOL_PIPELINE
    from ..services import ServiceFilter, do_discovery

    pilot = "chaospilot"
    definitions[pilot] = _pilot_definition(pilot, journal_dir,
                                           busy_ms)

    peers: dict[str, str] = {}          # topic_path -> service name
    gateway_tags: dict[str, str] = {}   # service name -> host:port
    lock = threading.Lock()

    def on_found(record, proxy):
        with lock:
            peers[record.topic_path] = record.name
            for tag in record.tags:
                if tag.startswith("gateway="):
                    gateway_tags[record.name] = tag.split("=", 1)[1]

    def on_lost(record, proxy):
        with lock:
            peers.pop(record.topic_path, None)

    discovery = do_discovery(
        runtime, ServiceFilter(protocol=PROTOCOL_PIPELINE),
        add_handler=on_found, remove_handler=on_lost)
    try:
        supervisor.spawn(pilot)
        wait_for(lambda: pilot in gateway_tags,
                 f"pilot gateway tag (see {result['workdir']})")
        host, _, port = gateway_tags[pilot].partition(":")
        echo(f"pilot up: gateway {host}:{port}")

        client_a = GatewayClient(host, int(port), timeout=timeout)
        results_a: list = []
        sent_a = [0]
        errors: list = []
        release_a = threading.Event()

        def drive_a():
            # Open-loop pressure until released: 4 frames outstanding
            # against a QoS window of 2 (overloaded) with an
            # unmeetable p99 (burn) -- the controller's scale-out
            # condition -- sustained for the WHOLE scenario so the
            # pilot never goes idle (no mid-scenario retire) and the
            # next session binds to the spawned peer under
            # least-loaded balancing.
            try:
                client_a.open(session="chaosA")
                window = 4
                for index in range(window):
                    client_a.send_frame(
                        {"x": [float(index + 1)] * 4})
                sent = window
                while not release_a.is_set():
                    results_a.append(
                        client_a.next_result(timeout=60.0))
                    client_a.send_frame({"x": [float(sent + 1)] * 4})
                    sent += 1
                while len(results_a) < sent:
                    results_a.append(
                        client_a.next_result(timeout=60.0))
                sent_a[0] = sent
                client_a.close()
            except Exception as error:
                errors.append(error)

        driver_a = threading.Thread(target=drive_a, daemon=True)
        driver_a.start()

        # The controller must diagnose overload + burn and spawn a
        # peer process; the peer registers as its own service.
        wait_for(lambda: len(peers) >= 2 or errors,
                 "controller to scale the fleet out")
        if errors:
            raise errors[0]
        with lock:
            peer_name = next(name for name in peers.values()
                             if name != pilot)
        result["fleet_grew"] = True
        echo(f"controller scaled out: {peer_name} joined")

        # Session B: with session A still bound to the pilot, the
        # balanced gateway routes the new session to the idle peer.
        client_b = GatewayClient(host, int(port), timeout=timeout)
        results_b: list = []

        def drive_b():
            try:
                client_b.open(session="chaosB")
                for index in range(frames):
                    client_b.send_frame(
                        {"x": [float(index + 1)] * 4})
                    results_b.append(
                        client_b.next_result(timeout=60.0))
                client_b.close()
            except Exception as error:
                errors.append(error)

        driver_b = threading.Thread(target=drive_b, daemon=True)
        driver_b.start()
        wait_for(lambda: len(results_b) >= 2 or errors,
                 "session B first results")

        # Kill-while-scaling: SIGKILL the controller-spawned peer
        # (a child of the PILOT, found the way an operator would).
        pids = _peer_pids(peer_name)
        if not pids:
            raise RuntimeError(f"no process found for {peer_name}")
        echo(f"SIGKILL {peer_name} (pid {pids[0]}) mid-stream "
             f"[process_kill while scaled out]")
        os.kill(pids[0], signal.SIGKILL)

        # The pilot's gateway fails session B over; its supervisor
        # respawns the peer, which rejoins as a fresh service.
        wait_for(lambda: len(results_b) >= frames or errors,
                 "session B completion through failover")
        wait_for(lambda: any(name == peer_name for name in
                             list(peers.values())) or errors,
                 f"{peer_name} respawn to rejoin")
        result["respawned"] = True
        echo(f"  {peer_name} respawned by the pilot's fleet "
             f"supervisor and rejoined")

        release_a.set()
        wait_for(lambda: not driver_a.is_alive()
                 and not driver_b.is_alive(), "client completion")
        if errors:
            raise errors[0]

        ids_a = [entry["frame"] for entry in results_a]
        ids_b = [entry["frame"] for entry in results_b]
        result.update({
            "frames": sent_a[0] + frames,
            "delivered": len(results_a) + len(results_b),
            "in_order_no_dups":
                ids_a == list(range(sent_a[0]))
                and ids_b == list(range(frames)),
            "all_ok": all(entry["ok"] for entry in
                          results_a + results_b),
            "dropped": (sent_a[0] + frames
                        - len(results_a) - len(results_b)),
            "peer": peer_name})
        result["ok"] = bool(result.get("fleet_grew")
                            and result.get("respawned")
                            and result["in_order_no_dups"]
                            and result["all_ok"]
                            and result["dropped"] == 0)
        echo(f"delivered {result['delivered']}/{result['frames']} "
             f"in order={result['in_order_no_dups']} "
             f"ok={result['all_ok']} dropped={result['dropped']} "
             f"fleet_grew={result.get('fleet_grew', False)} "
             f"respawned={result.get('respawned', False)}")
        return result
    finally:
        discovery.terminate()
