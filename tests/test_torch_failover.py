"""The port's process-level fault domain: twins of
``tests/test_failover.py`` -- durable stream journals,
gateway failover with journal adoption, drain/rolling-restart handoff,
LLM committed-prefix resume across processes, and gateway idle-session
reaping.

The acceptance shape: two serving pipelines + a standalone gateway on
one loopback runtime; killing a pipeline (the in-process SIGKILL twin:
``Pipeline.kill`` / the ``process_kill`` fault point) fires its
per-service LWT, the registrar reaps it, the gateway re-binds the live
WebSocket sessions to the survivor, the survivor ADOPTS the dead
pipeline's journal, and results resume in order with no duplicates.
The multi-process variant (real SIGKILL over the native MQTT broker)
is twinned as the reference's is, ``slow``-marked: it spawns ``python
-m aiko_services_tpu_torch registrar`` and pipelines.  Placements
carve the eight-CPU device pool (``torch_pipeline_elements.cpu_pool``);
the ``LLM`` element and the batchers run with ``device: cpu``.
"""

import json
import queue
import threading
import time

import pytest

from conftest import run_until
from test_torch_llm_element import _port_runtime, _port_teardown
from torch_pipeline_elements import cpu_pool  # noqa: F401

from aiko_services_tpu_torch.gateway.client import GatewayClient
from aiko_services_tpu_torch.gateway.server import GatewayServer
from aiko_services_tpu_torch.pipeline import (DefinitionError, Pipeline,
                                              decode_frame_data)
from aiko_services_tpu_torch.pipeline.journal import (StreamJournal,
                                                      claim_adoption,
                                                      adopter_of,
                                                      load_journal)
from aiko_services_tpu_torch.services import Registrar
from aiko_services_tpu_torch.utils import parse

COMMON = "aiko_services_tpu_torch.elements.common"


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


@pytest.fixture(autouse=True)
def _device_pool(cpu_pool):
    """Every placement here carves the eight CPU descriptors."""
    return cpu_pool


def stage(name, busy_ms=1.0, factor=2.0, devices=2):
    return {"name": name, "input": [{"name": "x"}],
            "output": [{"name": "x"}],
            "parameters": {"busy_ms": busy_ms, "factor": factor},
            "placement": {"devices": devices},
            "deploy": {"local": {"module": COMMON,
                                 "class_name": "StageWork"}}}


def serving(runtime, name, journal_dir, busy_ms=1.0, extra=None):
    """Two placed stages (the scheduler activates: frames park at
    stage workers, so in-flight work is genuinely asynchronous).
    work*2 then finish*3 -> every result is x*6."""
    parameters = {"journal": "on", "journal_dir": str(journal_dir)}
    parameters.update(extra or {})
    return Pipeline({"version": 0, "name": name, "runtime": "torch",
                     "graph": ["(work finish)"],
                     "parameters": parameters,
                     "elements": [stage("work", busy_ms),
                                  stage("finish", busy_ms,
                                        factor=3.0)]},
                    runtime=runtime)


def llm_pipeline(runtime, name, journal_dir, fault_plan=None,
                 max_new=96):
    parameters = {"journal": "on", "journal_dir": str(journal_dir)}
    if fault_plan is not None:
        parameters["fault_plan"] = json.dumps(fault_plan)
    element = {"name": "llm", "input": [{"name": "text"}],
               "output": [{"name": "text"}],
               "parameters": {"max_new_tokens": max_new,
                              "temperature": 0.0, "max_seq": 256,
                              "decode_block_tokens": 4,
                              "device": "cpu"},
               "deploy": {"local": {
                   "module": "aiko_services_tpu_torch.elements.llm",
                   "class_name": "LLM"}}}
    return Pipeline({"version": 0, "name": name, "runtime": "torch",
                     "graph": ["(llm)"], "parameters": parameters,
                     "elements": [element]}, runtime=runtime)


def in_thread(target):
    box: dict = {}

    def body():
        try:
            box["value"] = target()
        except Exception as error:      # surfaced by the test
            box["error"] = error
    thread = threading.Thread(target=body, daemon=True)
    thread.start()
    return thread, box


def finish(runtime, thread, box, timeout=90.0):
    run_until(runtime, lambda: not thread.is_alive(), timeout=timeout)
    assert not thread.is_alive(), "client interaction hung"
    if "error" in box:
        raise box["error"]
    return box.get("value")


# -- journal unit behavior --------------------------------------------------

def test_journal_roundtrip_prune_and_llm(tmp_path):
    import numpy as np
    journal = StreamJournal(tmp_path / "p.journal", fsync_ms=0.0)
    journal.stream_open("s1", {"tenant": "t1", "qos_class": "batch"},
                        topic_response="ns/x/in")
    journal.frame_ingested("s1", 0, {"x": np.ones((2,), np.float32)})
    journal.frame_ingested("s1", 1, {"x": 2.5, "note": "hi"})
    journal.llm_token("s1", 1, 42)
    journal.llm_tokens("s1", 1, [43, 44])
    journal.frame_done("s1", 0, ok=True)
    journal.stream_open("s2", {})
    journal.stream_close("s2")
    journal.close()

    state = load_journal(journal.path)
    assert not state.drained and not state.truncated
    live = {entry.stream_id: entry for entry in state.live_streams()}
    assert set(live) == {"s1"}          # s2 closed gracefully
    entry = live["s1"]
    assert entry.parameters["tenant"] == "t1"
    assert entry.topic_response == "ns/x/in"
    assert entry.delivered == [0] and entry.undelivered == [1]
    assert 0 not in entry.frames        # pruned into the watermark
    assert entry.done_upto == 0
    assert entry.llm == {1: [42, 43, 44]}
    payload = decode_frame_data({
        key: value for key, value in entry.frames[1]["data"].items()})
    assert payload["x"] == 2.5 and payload["note"] == "hi"


def test_journal_tolerates_torn_tail(tmp_path):
    journal = StreamJournal(tmp_path / "p.journal")
    journal.stream_open("s1", {})
    journal.frame_ingested("s1", 0, {"x": 1})
    journal.close()
    with open(journal.path, "a", encoding="utf-8") as stream:
        stream.write('{"t":"done","s":"s1","f":0')     # torn mid-write
    state = load_journal(journal.path)
    assert state.truncated
    # the torn done record is ignored: frame 0 is still undelivered
    assert state.streams["s1"].undelivered == [0]


def test_journal_compacts_to_live_set(tmp_path):
    journal = StreamJournal(tmp_path / "p.journal", fsync_ms=0.0,
                            compact_records=128)
    journal.stream_open("s1", {})
    for index in range(400):
        journal.frame_ingested("s1", index, {"x": index})
        journal.frame_done("s1", index)
    assert journal.compactions >= 1
    # the file holds ~the live set, not the whole history
    with open(journal.path, "r", encoding="utf-8") as stream:
        lines = stream.readlines()
    assert len(lines) < 400
    state = load_journal(journal.path)
    entry = state.streams["s1"]
    assert entry.undelivered == []
    assert len(entry.delivered) == 400      # delivered-set intact


def test_adoption_claim_is_exclusive(tmp_path):
    path = str(tmp_path / "p.journal")
    open(path, "w").close()
    assert claim_adoption(path, "peer-a") is True
    assert claim_adoption(path, "peer-b") is False
    assert adopter_of(path) == "peer-a"


def test_journal_on_without_dir_is_create_time_error(runtime):
    with pytest.raises(DefinitionError, match="journal_dir"):
        Pipeline({"version": 0, "name": "nodir", "runtime": "torch",
                  "graph": ["(work)"],
                  "parameters": {"journal": "on"},
                  "elements": [stage("work")]}, runtime=runtime)
    # the failed create must not leak a half-bound service
    assert "nodir" not in [getattr(s, "name", "") for s in
                           runtime.services()]


# -- batcher export/import resume ------------------------------------------

def test_batcher_export_import_continues_byte_identical():
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.batching import (
        ContinuousBatcher, Request)
    config = llama.LlamaConfig.tiny()
    params = llama.init_params(0, config, device="cpu")
    prompt = [3, 5, 7, 11]
    total = 24

    def collector(sink):
        def emit(_rid, token, _finished):
            sink.append(int(token))
        return emit

    # Reference: one uninterrupted run.
    reference: list = []
    ref = ContinuousBatcher(params, config, max_slots=2,
                          device="cpu")
    ref.submit(Request("r", list(prompt), max_new_tokens=total,
                       temperature=0.0, emit=collector(reference)))
    ref.run_until_drained()

    # Interrupted: export after ~8 tokens, import into a FRESH batcher
    # (a different process, as far as device state is concerned).
    first: list = []
    b1 = ContinuousBatcher(params, config, max_slots=2,
                          device="cpu")
    b1.submit(Request("r", list(prompt), max_new_tokens=total,
                      temperature=0.0, emit=collector(first)))
    while len(first) < 8:
        b1.step()
    exported = b1.export_state()
    assert len(exported) == 1
    entry = exported[0]
    assert entry["prompt"] == prompt
    assert entry["committed"] == first[:len(entry["committed"])]

    second: list = []
    b2 = ContinuousBatcher(params, config, max_slots=2,
                          device="cpu")
    b2.import_state(exported,
                    emit_factory=lambda _entry: collector(second))
    b2.run_until_drained()
    resumed = entry["committed"] + second
    assert resumed == reference
    assert len(resumed) == len(reference)


def test_resume_request_refuses_finished_prefix():
    """A committed prefix that already finished the request (EOS tail
    or spent budget -- the process died between the final emit and
    delivery) must NOT resume decoding: the adopter completes from
    the prefix, or the client would get a spurious post-EOS tail."""
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.batching import (
        ContinuousBatcher, Request)
    config = llama.LlamaConfig.tiny()
    params = llama.init_params(0, config, device="cpu")
    batcher = ContinuousBatcher(params, config, max_slots=2,
                          device="cpu")

    spent = Request("spent", [1, 2, 3], max_new_tokens=4,
                    eos_tokens=(99,))
    batcher.submit(spent)
    assert batcher.resume_request(spent, [5, 6, 7, 8]) is False
    assert spent.done and spent not in batcher.pending

    eos_tail = Request("eos", [1, 2, 3], max_new_tokens=16,
                       eos_tokens=(99,))
    batcher.submit(eos_tail)
    assert batcher.resume_request(eos_tail, [5, 99]) is False
    assert eos_tail.done and eos_tail not in batcher.pending

    live = Request("live", [1, 2, 3], max_new_tokens=16,
                   eos_tokens=(99,))
    batcher.submit(live)
    assert batcher.resume_request(live, [5, 6]) is True
    assert not live.done and live in batcher.pending
    assert live.generated == 2 and live.rebased == 2


# -- failover acceptance (kill -> adopt -> resume) --------------------------

def test_ws_session_fails_over_on_kill(runtime, tmp_path):
    """Process fault-domain acceptance: SIGKILL (in-process twin) of
    the pipeline serving a live gateway session -> LWT detected ->
    session re-bound -> stream adopted from the journal -> in-order,
    duplicate-free delivery resumes on the SAME WebSocket."""
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    p1 = serving(runtime, "srv1", tmp_path, busy_ms=120.0)
    gateway = GatewayServer(runtime=runtime)
    run_until(runtime, lambda: len(gateway._peers) == 1)
    p2 = serving(runtime, "srv2", tmp_path, busy_ms=5.0)
    run_until(runtime, lambda: len(gateway._peers) == 2)
    assert list(gateway._peers.values())[0] == "srv1"

    client = GatewayClient("127.0.0.1", gateway.port, timeout=90.0)
    n_frames = 6

    def phase_send():
        client.open(session="s1", tenant="t1")
        for index in range(n_frames):
            client.send_frame({"x": [float(index + 1)] * 4})
        return client.next_result()     # at least one from srv1

    thread, box = in_thread(phase_send)
    first = finish(runtime, thread, box)
    assert first["frame"] == 0 and first["ok"]

    # journal durability: every ingested frame is accounted for in
    # srv1's journal (delivered watermark + undelivered payloads)
    entry = load_journal(tmp_path / "srv1.journal").streams["gw/s1"]
    assert len(entry.delivered) + len(entry.undelivered) == n_frames

    p1.kill()                           # unclean death, mid-stream
    run_until(runtime, lambda: gateway.failovers == 1, timeout=10.0)
    run_until(runtime, lambda: p2.share["streams_adopted"] == 1,
              timeout=10.0)

    def phase_recv():
        return [client.next_result() for _ in range(n_frames - 1)]

    thread, box = in_thread(phase_recv)
    rest = finish(runtime, thread, box)
    results = [first] + rest
    # in-order, duplicate-free, every frame answered exactly once
    assert [r["frame"] for r in results] == list(range(n_frames))
    for index, result in enumerate(results):
        assert result["ok"], result
        assert result["data"]["x"][0] == pytest.approx(
            6.0 * (index + 1))
    assert p2.share["frames_journal_replayed"] >= 1
    # the adopter's ring carries the adopt event
    events = [e for e in p2.recorder.snapshot()
              if e[1] == "adopt"] if p2.recorder else []
    assert events, "adopt ring event missing"

    # post-failover: NEW frames flow to the survivor on the same session
    def phase_more():
        client.send_frame({"x": [100.0] * 4})
        result = client.next_result()
        client.close()
        return result

    thread, box = in_thread(phase_more)
    more = finish(runtime, thread, box)
    assert more["frame"] == n_frames and more["ok"]
    assert more["data"]["x"][0] == pytest.approx(600.0)
    gateway.stop()
    p2.stop()


def test_refire_covers_wire_transit_loss_on_kill(runtime, tmp_path):
    """A frame in wire transit at the kill reached NO journal --
    adoption cannot replay it.  The gateway's retransmit line
    (``_Session.unanswered``) must re-fire its own copy at the
    survivor after the re-bind; before it existed these frames were
    simply gone and the session stalled a window slot forever."""
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    p1 = serving(runtime, "srv1", tmp_path, busy_ms=5.0)
    gateway = GatewayServer(runtime=runtime)
    run_until(runtime, lambda: len(gateway._peers) == 1)
    p2 = serving(runtime, "srv2", tmp_path, busy_ms=5.0)
    run_until(runtime, lambda: len(gateway._peers) == 2)
    assert list(gateway._peers.values())[0] == "srv1"

    client = GatewayClient("127.0.0.1", gateway.port, timeout=90.0)

    def phase_send():
        client.open(session="rf", tenant="t1")
        for index in range(2):
            client.send_frame({"x": [float(index + 1)] * 2})
        return [client.next_result(), client.next_result()]

    thread, box = in_thread(phase_send)
    first = finish(runtime, thread, box)
    assert [r["frame"] for r in first] == [0, 1]

    p1.kill()               # handlers gone; failover not yet begun

    def phase_transit():
        # Dispatched at srv1's now-dead topic: dropped on the floor,
        # past every journal's horizon.
        client.send_frame({"x": [3.0] * 2})
        client.send_frame({"x": [4.0] * 2})

    thread, box = in_thread(phase_transit)
    finish(runtime, thread, box)
    # the dead pipeline never saw them: its crash-time journal holds
    # only the two frames it delivered
    entry = load_journal(tmp_path / "srv1.journal").streams["gw/rf"]
    assert 2 not in entry.frames and 3 not in entry.frames

    run_until(runtime, lambda: gateway.failovers == 1, timeout=10.0)

    def phase_recv():
        results = [client.next_result(timeout=60.0) for _ in range(2)]
        client.close()
        return results

    thread, box = in_thread(phase_recv)
    rest = finish(runtime, thread, box)
    assert [r["frame"] for r in rest] == [2, 3]
    for result, x in zip(rest, (3.0, 4.0)):
        assert result["ok"], result
        assert result["data"]["x"][0] == pytest.approx(6.0 * x)
    gateway.stop()
    p2.stop()


def test_process_kill_fault_point_drives_failover(runtime, tmp_path):
    """The armed ``process_kill`` fault point IS the kill switch: the
    pipeline dies on the rule-matched ingest, deterministically."""
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    plan = [{"point": "process_kill", "target": "srv1", "after": 2}]
    p1 = serving(runtime, "srv1", tmp_path,
                 extra={"fault_plan": json.dumps(plan)})
    gateway = GatewayServer(runtime=runtime)
    run_until(runtime, lambda: len(gateway._peers) == 1)
    p2 = serving(runtime, "srv2", tmp_path)
    run_until(runtime, lambda: len(gateway._peers) == 2)

    client = GatewayClient("127.0.0.1", gateway.port, timeout=90.0)
    n_frames = 5

    def interact():
        client.open(session="sk", tenant="t1")
        results = []
        for index in range(n_frames):
            # One at a time: frames sent AFTER the kill but BEFORE
            # the failover would be lost in flight to a dead process
            # (beyond the journal horizon, by design) -- lock-step
            # keeps exactly one frame exposed, and that one is
            # journaled at ingest before the kill fires.
            client.send_frame({"x": [float(index + 1)] * 2})
            results.append(client.next_result(timeout=60.0))
        client.close()
        return results

    thread, box = in_thread(interact)
    results = finish(runtime, thread, box)
    assert [r["frame"] for r in results] == list(range(n_frames))
    assert all(r["ok"] for r in results)
    # the rule fired exactly once: frame 2's ingest killed srv1 (its
    # journaled frame replayed on srv2); 2 frames ran on srv1
    assert p1._faults.fired("process_kill") == 1
    assert gateway.failovers == 1
    assert p2.share["frames_journal_replayed"] >= 1
    gateway.stop()
    p2.stop()


def test_failover_waits_for_a_survivor_to_appear(runtime, tmp_path):
    """A death with NO surviving peer must not strand the sessions
    forever: the failover parks pending and replays when the next
    peer registers."""
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    p1 = serving(runtime, "solo", tmp_path, busy_ms=60.0)
    gateway = GatewayServer(runtime=runtime)
    run_until(runtime, lambda: len(gateway._peers) == 1)

    client = GatewayClient("127.0.0.1", gateway.port, timeout=90.0)
    n_frames = 3

    def phase_send():
        client.open(session="w1", tenant="t1")
        for index in range(n_frames):
            client.send_frame({"x": [float(index + 1)] * 2})

    thread, box = in_thread(phase_send)
    finish(runtime, thread, box)
    run_until(runtime, lambda: len(load_journal(
        tmp_path / "solo.journal").streams.get(
        "gw/w1", type("E", (), {"frames": {}})).frames) == n_frames,
        timeout=10.0)
    p1.kill()                           # ... and no peer exists
    runtime.run(timeout=0.4)
    assert gateway.failovers == 0       # nothing to fail over TO
    assert gateway._pending_failovers   # parked, not forgotten

    late = serving(runtime, "late", tmp_path, busy_ms=5.0)
    run_until(runtime, lambda: gateway.failovers == 1, timeout=10.0)

    def phase_recv():
        results = [client.next_result(timeout=60.0)
                   for _ in range(n_frames)]
        client.close()
        return results

    thread, box = in_thread(phase_recv)
    results = finish(runtime, thread, box)
    assert [r["frame"] for r in results] == list(range(n_frames))
    assert all(r["ok"] for r in results)
    assert late.share["streams_adopted"] == 1
    gateway.stop()
    late.stop()


def test_kill_during_llm_generation_resumes_committed_prefix(
        runtime, tmp_path):
    """Kill mid-generation: the survivor resumes at the journaled
    committed prefix and the final text is BYTE-IDENTICAL to an
    uninterrupted run at temperature 0 -- nothing re-emitted, nothing
    lost."""
    prompt = "tell me about tpus"
    # Reference text from an uninterrupted pipeline, stopped before
    # the gateway exists so it never joins the peer pool.
    ref = llm_pipeline(runtime, "ref", tmp_path / "ref")
    responses = queue.Queue()
    ref.create_stream_local("r", queue_response=responses)
    ref.process_frame_local({"text": prompt}, stream_id="r")
    assert run_until(runtime, lambda: not responses.empty(),
                     timeout=120.0)
    (_, _, swag, _, okay, diagnostic) = responses.get()
    assert okay, diagnostic
    expected = swag["text"]
    assert expected
    ref.stop()
    # forget the reference service entirely: it must not register as
    # a pipeline peer when the registrar promotes below
    runtime.remove_service(ref.service_id)

    Registrar(runtime=runtime, primary_search_timeout=0.05)
    # Pace generation (30 ms per 4-token block) so the kill lands
    # mid-generation deterministically.
    pace = [{"point": "decode_block", "target": "llm",
             "delay_ms": 30, "count": "forever"}]
    p1 = llm_pipeline(runtime, "llm1", tmp_path, fault_plan=pace)
    gateway = GatewayServer(runtime=runtime)
    run_until(runtime, lambda: len(gateway._peers) == 1)
    p2 = llm_pipeline(runtime, "llm2", tmp_path)
    run_until(runtime, lambda: len(gateway._peers) == 2)

    client = GatewayClient("127.0.0.1", gateway.port, timeout=180.0)

    def phase_send():
        client.open(session="gen", tenant="t1")
        client.send_frame({"text": prompt})

    thread, box = in_thread(phase_send)
    finish(runtime, thread, box)

    journal_path = tmp_path / "llm1.journal"

    def tokens_committed():
        state = load_journal(journal_path)
        entry = state.streams.get("gw/gen")
        return sum(len(tokens) for tokens in entry.llm.values()) \
            if entry else 0

    run_until(runtime, lambda: tokens_committed() >= 4, timeout=120.0)
    committed_at_kill = tokens_committed()
    p1.kill()
    run_until(runtime, lambda: gateway.failovers == 1, timeout=10.0)

    def phase_recv():
        result = client.next_result(timeout=180.0)
        client.close()
        return result

    thread, box = in_thread(phase_recv)
    result = finish(runtime, thread, box, timeout=180.0)
    assert result["ok"], result
    assert result["data"]["text"] == expected     # byte-identical
    if committed_at_kill < len(expected):
        # the interesting case actually happened: generation was cut
        # mid-flight and the survivor continued it
        assert p2.share["streams_adopted"] == 1
    gateway.stop()
    p2.stop()


# -- drain / rolling restart ------------------------------------------------

def test_drain_hands_off_with_zero_drop(runtime, tmp_path):
    """Cooperative drain under load: in-flight frames finish or park,
    held frames journal, the survivor adopts -- the client sees every
    frame exactly once, in order (the rolling-restart contract)."""
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    p1 = serving(runtime, "srv1", tmp_path, busy_ms=80.0,
                 extra={"drain_timeout_ms": 400})
    gateway = GatewayServer(runtime=runtime)
    run_until(runtime, lambda: len(gateway._peers) == 1)
    p2 = serving(runtime, "srv2", tmp_path, busy_ms=5.0)
    run_until(runtime, lambda: len(gateway._peers) == 2)

    client = GatewayClient("127.0.0.1", gateway.port, timeout=90.0)
    n_frames = 6

    def phase_send():
        client.open(session="d1", tenant="t1")
        for index in range(n_frames):
            client.send_frame({"x": [float(index + 1)] * 2})
        return client.next_result()

    thread, box = in_thread(phase_send)
    first = finish(runtime, thread, box)
    assert first["ok"]

    p1.drain()                          # mid-stream, frames in flight
    run_until(runtime, lambda: p1.share.get("drained"), timeout=10.0)
    run_until(runtime, lambda: gateway.failovers == 1, timeout=10.0)

    def phase_recv():
        results = [client.next_result() for _ in range(n_frames - 1)]
        client.close()
        return results

    thread, box = in_thread(phase_recv)
    rest = finish(runtime, thread, box)
    results = [first] + rest
    assert [r["frame"] for r in results] == list(range(n_frames))
    assert all(r["ok"] for r in results)
    # clean drain: journal carries the drained marker
    assert load_journal(tmp_path / "srv1.journal").drained
    gateway.stop()
    p2.stop()


def test_kill_during_drain_completes_on_survivor(runtime, tmp_path):
    """A drain that never finishes (process dies mid-drain) degrades
    to the unclean path: everything journaled so far -- including
    frames held by the drain -- is adopted and completed by the
    survivor."""
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    p1 = serving(runtime, "srv1", tmp_path, busy_ms=150.0,
                 extra={"drain_timeout_ms": 60000})
    gateway = GatewayServer(runtime=runtime)
    run_until(runtime, lambda: len(gateway._peers) == 1)
    p2 = serving(runtime, "srv2", tmp_path, busy_ms=5.0)
    run_until(runtime, lambda: len(gateway._peers) == 2)

    client = GatewayClient("127.0.0.1", gateway.port, timeout=90.0)
    n_frames = 4

    def phase_send():
        client.open(session="dk", tenant="t1")
        for index in range(n_frames):
            client.send_frame({"x": [float(index + 1)] * 2})

    thread, box = in_thread(phase_send)
    finish(runtime, thread, box)
    run_until(runtime, lambda: len(load_journal(
        tmp_path / "srv1.journal").streams.get(
        "gw/dk", type("E", (), {"frames": {}})).frames) == n_frames,
        timeout=10.0)

    p1.drain()
    runtime.run(timeout=0.1)            # drain starts, nowhere near done
    assert not p1.share.get("drained")
    p1.kill()                           # die mid-drain
    run_until(runtime, lambda: gateway.failovers == 1, timeout=10.0)

    def phase_recv():
        results = [client.next_result() for _ in range(n_frames)]
        client.close()
        return results

    thread, box = in_thread(phase_recv)
    results = finish(runtime, thread, box)
    assert [r["frame"] for r in results] == list(range(n_frames))
    assert all(r["ok"] for r in results)
    gateway.stop()
    p2.stop()


# -- adoption refusal -------------------------------------------------------

def test_double_adoption_refused(runtime, tmp_path):
    """One journal, one adopter: the claim file fences the second
    claimant, and a stream id already live locally is refused
    individually."""
    journal = StreamJournal(tmp_path / "dead.journal", fsync_ms=0.0)
    journal.stream_open("s1", {"tenant": "t1"})
    journal.frame_ingested("s1", 0, {"x": 1.0})
    journal.frame_done("s1", 0)
    journal.frame_ingested("s1", 1, {"x": 2.0})
    journal.close()

    p2 = serving(runtime, "peer2", tmp_path)
    p3 = serving(runtime, "peer3", tmp_path)
    got = []
    topic = f"{runtime.topic_path_process}/test/adopt"
    runtime.add_message_handler(
        lambda _topic, payload: got.append(payload), topic)

    assert p2.adopt("dead", topic) == 1
    run_until(runtime, lambda: len(got) == 1, timeout=10.0)
    command, parameters = parse(got[0])
    assert command == "process_frame_response"
    header = dict(parameters[0])
    # ONLY the undelivered frame replayed -- the delivered seq is
    # dropped, not duplicated
    assert int(header["frame_id"]) == 1
    assert str(header["okay"]).lower() != "false"

    # second adopter: refused by the claim file
    assert p3.adopt("dead", topic) == 0
    # same adopter again: the claim file fences replays too
    assert p2.adopt("dead", topic) == 0
    runtime.run(timeout=0.3)
    assert len(got) == 1                # no duplicate delivery, ever
    p2.stop()
    p3.stop()


def test_unclean_shutdown_replay_no_drop_no_dup(runtime, tmp_path):
    """Journal replay after an unclean shutdown: every undelivered
    frame replays exactly once, every delivered seq stays delivered."""
    import numpy as np
    p1 = serving(runtime, "crashy", tmp_path, busy_ms=1.0)
    responses = queue.Queue()
    p1.create_stream_local("s", queue_response=responses)
    for index in range(3):
        p1.process_frame_local(
            {"x": np.asarray([1.0 * index], np.float32)},
            stream_id="s")
    run_until(runtime, lambda: responses.qsize() == 3, timeout=30.0)
    # two more ingests that never complete: kill before processing by
    # posting the kill between them on the mailbox
    p1.process_frame_local({"x": np.asarray([100.0], np.float32)},
                           stream_id="s")
    p1.process_frame_local({"x": np.asarray([200.0], np.float32)},
                           stream_id="s")
    p1.post_self("kill")
    run_until(runtime, lambda: getattr(p1, "_killed", False),
              timeout=10.0)

    state = load_journal(tmp_path / "crashy.journal")
    entry = state.streams["s"]
    assert entry.delivered == [0, 1, 2]
    assert entry.undelivered == [3, 4]

    p2 = serving(runtime, "survivor", tmp_path, busy_ms=1.0)
    got = []
    topic = f"{runtime.topic_path_process}/test/replay"
    runtime.add_message_handler(
        lambda _topic, payload: got.append(payload), topic)
    assert p2.adopt("crashy", topic) == 1
    run_until(runtime, lambda: len(got) == 2, timeout=10.0)
    frame_ids = sorted(int(dict(parse(payload)[1][0])["frame_id"])
                       for payload in got)
    assert frame_ids == [3, 4]          # exactly the undelivered set
    p2.stop()


# -- gateway idle-session reaping -------------------------------------------

@pytest.mark.slow
def test_multi_process_chaos_driver_kill():
    """Full-fidelity chaos walk: real processes of the port's command
    line, a real SIGKILL, the native TCP MQTT broker -- the
    LWT/adoption path with no loopback shortcuts."""
    from aiko_services_tpu_torch.faults.chaos import run_chaos
    result = run_chaos(frames=8, busy_ms=40.0,
                       echo=lambda *_args: None)
    assert result["ok"], result
    assert result["failovers"] >= 1
    assert result["dropped"] == 0


@pytest.mark.slow
def test_multi_process_chaos_driver_rolling():
    from aiko_services_tpu_torch.faults.chaos import run_chaos
    result = run_chaos(frames=12, mode="rolling", busy_ms=40.0,
                       echo=lambda *_args: None)
    assert result["ok"], result
    assert result["dropped"] == 0


def test_idle_session_reaped_frees_stream_and_budget(runtime):
    """A client that vanishes without a FIN (no frames, no pongs) is
    reaped after ``session_idle_ms``: its stream, window slots and
    QoS in-flight budget come back instead of leaking to process
    exit."""
    pipeline = Pipeline(
        {"version": 0, "name": "gwidle", "runtime": "torch",
         "graph": ["(work)"],
         "parameters": {"gateway": "on", "session_idle_ms": 250},
         "elements": [stage("work")]}, runtime=runtime)
    gateway = pipeline.gateway
    assert gateway.session_idle_ms == 250.0

    client = GatewayClient("127.0.0.1", gateway.port, timeout=30.0)

    def open_then_vanish():
        client.open(session="ghost", tenant="t1")
        # ... and never read again: no pong ever answers the ping

    thread, box = in_thread(open_then_vanish)
    finish(runtime, thread, box)
    run_until(runtime, lambda: len(pipeline.streams) == 1,
              timeout=10.0)
    assert gateway.session_count() == 1

    run_until(runtime,
              lambda: gateway.sessions_reaped == 1
              and len(pipeline.streams) == 0, timeout=10.0)
    assert gateway.session_count() == 0
    # a LIVE client (pongs answered by the codec in recv) is NOT
    # reaped across the same window
    live = GatewayClient("127.0.0.1", gateway.port, timeout=30.0)

    def stay_alive():
        live.open(session="alive", tenant="t1")
        deadline = time.monotonic() + 0.6
        while time.monotonic() < deadline:
            try:
                live.recv(timeout=0.1)  # answers pings in line
            except Exception:
                pass
        live.close()

    thread, box = in_thread(stay_alive)
    finish(runtime, thread, box)
    assert gateway.sessions_reaped == 1     # still only the ghost
    pipeline.stop()
