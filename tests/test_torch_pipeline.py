"""The PyTorch port's pipeline engine: twins of ``tests/test_pipeline.py``
(definitions, graph name mapping, stream events, loops, remote
two-pipeline chaining) on ``aiko_services_tpu_torch.pipeline``, plus the
port's own: a ``placement`` block on the eight-CPU device pool, and its
refusals: ``"runtime": "jax"`` and a stage over two CUDA cards."""

import json
import queue

import pytest
import torch

from conftest import run_until
from torch_pipeline_elements import cpu_pool  # noqa: F401
from aiko_services_tpu_torch.pipeline import (
    Pipeline, parse_pipeline_definition, DefinitionError, StreamState)

ELEMENTS = "tests/torch_pipeline_elements.py"


@pytest.fixture
def runtime():
    """Fresh isolated process runtime of the port on its in-memory
    loopback broker."""
    from aiko_services_tpu_torch.transport import reset_broker
    from aiko_services_tpu_torch.runtime import init_process, reset_process
    from aiko_services_tpu_torch.services.share import reset_services_cache

    reset_broker()
    reset_services_cache()
    rt = init_process(transport="loopback")
    rt.initialize()
    yield rt
    rt.engine.terminate()
    reset_process()
    reset_services_cache()
    reset_broker()


def element(name, cls, inputs, outputs, parameters=None):
    return {"name": name,
            "input": [{"name": n} for n in inputs],
            "output": [{"name": n} for n in outputs],
            "deploy": {"local": {"module": ELEMENTS, "class_name": cls}},
            "parameters": parameters or {}}


def definition(graph, elements, name="p_test", parameters=None):
    return {"version": 0, "name": name, "runtime": "torch", "graph": graph,
            "parameters": parameters or {}, "elements": elements}


def run_frame(runtime, pipeline, frame_data, timeout=5.0):
    responses = queue.Queue()
    pipeline.process_frame_local(frame_data, queue_response=responses)
    run_until(runtime, lambda: not responses.empty(), timeout=timeout)
    assert not responses.empty(), "no response (frame lost?)"
    stream_id, frame_id, swag, metrics, okay, diagnostic = responses.get()
    return swag, okay, diagnostic


# -- definition validation --------------------------------------------------

def test_definition_validation_errors():
    with pytest.raises(DefinitionError, match="missing required"):
        parse_pipeline_definition({"version": 0})
    with pytest.raises(DefinitionError, match="runtime"):
        parse_pipeline_definition(
            {"name": "x", "runtime": "cuda", "graph": ["(a)"],
             "elements": []})
    with pytest.raises(DefinitionError, match="duplicate"):
        parse_pipeline_definition(definition(
            ["(A A)"], [element("A", "ElementA", ["a"], ["a"]),
                        element("A", "ElementA", ["a"], ["a"])]))
    with pytest.raises(DefinitionError, match="deploy"):
        parse_pipeline_definition(definition(
            ["(A)"], [{"name": "A", "input": [], "output": []}]))


def test_unknown_graph_element_rejected():
    with pytest.raises(DefinitionError, match="no element definition"):
        Pipeline(definition(["(A B)"],
                            [element("A", "ElementA", ["a"], ["a"])]))


# -- graph name-mapping matrix (reference test_pipeline_graph.py) -----------

def test_linear_positional_mapping(runtime):
    """B consumes A's output by bare name."""
    p = Pipeline(definition(
        ["(A B C)"],
        [element("A", "ElementA", ["a"], ["a"]),
         element("B", "ElementB", ["a"], ["b"]),
         element("C", "ElementC", ["b"], ["c"])]), runtime=runtime)
    swag, okay, _ = run_frame(runtime, p, {"a": 1})
    assert okay
    assert swag["a"] == 1 and swag["b"] == 2 and swag["c"] == 4
    assert swag["B.b"] == 2 and swag["C.c"] == 4


def test_qualified_mapping(runtime):
    """C's input b mapped from qualified A.a: c = a*2, ignoring B."""
    p = Pipeline(definition(
        ["(A B (C (b: A.a)))"],
        [element("A", "ElementA", ["a"], ["a"]),
         element("B", "ElementB", ["a"], ["b"]),
         element("C", "ElementC", ["b"], ["c"])]), runtime=runtime)
    swag, okay, _ = run_frame(runtime, p, {"a": 10})
    assert okay
    assert swag["c"] == 20          # from a=10, not b=11


def test_renamed_input_mapping(runtime):
    """Doubler input x mapped from swag value a."""
    p = Pipeline(definition(
        ["(A (D (x: a)))"],
        [element("A", "ElementA", ["a"], ["a"]),
         element("D", "Doubler", ["x"], ["x"])]), runtime=runtime)
    swag, okay, _ = run_frame(runtime, p, {"a": 7})
    assert okay and swag["x"] == 14


def test_fanout_fanin_diamond(runtime):
    """(A (B D) (C D)): DFS order A B D C; D runs once after B."""
    p = Pipeline(definition(
        ["(A (B D) (C (b: a) D))"],
        [element("A", "ElementA", ["a"], ["a"]),
         element("B", "ElementB", ["a"], ["b"]),
         element("C", "ElementC", ["b"], ["c"]),
         element("D", "AddOne", ["x"], ["x"],)]),
        runtime=runtime)
    # D needs input x; map from b via graph properties
    p2 = Pipeline(definition(
        ["(A (B (D (x: b))) (C (b: a)))"],
        [element("A", "ElementA", ["a"], ["a"]),
         element("B", "ElementB", ["a"], ["b"]),
         element("C", "ElementC", ["b"], ["c"]),
         element("D", "AddOne", ["x"], ["x"])]), name="p2",
        runtime=runtime)
    swag, okay, _ = run_frame(runtime, p2, {"a": 1})
    assert okay
    assert swag["b"] == 2           # B
    assert swag["x"] == 3           # D = b+1
    assert swag["c"] == 2           # C from mapped a=1


def test_missing_input_is_frame_error(runtime):
    p = Pipeline(definition(
        ["(B)"], [element("B", "ElementB", ["a"], ["b"])]),
        runtime=runtime)
    swag, okay, diagnostic = run_frame(runtime, p, {"zzz": 1})
    assert not okay and "missing inputs" in diagnostic


# -- stream events ----------------------------------------------------------

def test_error_event_destroys_stream_no_deadlock(runtime):
    """Reference regression PR #32: ERROR must not deadlock the stream."""
    p = Pipeline(definition(
        ["(A F)"],
        [element("A", "ElementA", ["a"], ["a"]),
         element("F", "Failer", [], [])]), runtime=runtime)
    swag, okay, diagnostic = run_frame(runtime, p, {"a": 1})
    assert not okay and "deliberate failure" in diagnostic
    # Stream destroyed; a new frame starts a fresh stream and also errors.
    swag, okay, _ = run_frame(runtime, p, {"a": 2})
    assert not okay


def test_element_exception_is_frame_error(runtime):
    p = Pipeline(definition(
        ["(R)"], [element("R", "Raiser", [], [])]), runtime=runtime)
    swag, okay, diagnostic = run_frame(runtime, p, {})
    assert not okay and "exploded" in diagnostic


def test_stop_event_ends_stream(runtime):
    p = Pipeline(definition(
        ["(A S)"],
        [element("A", "ElementA", ["a"], ["a"]),
         element("S", "Stopper", [], [])]), runtime=runtime)
    swag, okay, _ = run_frame(runtime, p, {"a": 1})
    assert okay
    run_until(runtime, lambda: not p.streams, timeout=5.0)
    assert not p.streams


# -- loops ------------------------------------------------------------------

def test_loop_element(runtime):
    p = Pipeline(definition(
        ["(CNT LOOP)"],
        [element("CNT", "Counter", ["n"], ["n"]),
         {"name": "LOOP", "input": [], "output": [],
          "deploy": {"local": {
              "module": "aiko_services_tpu_torch.elements.control",
              "class_name": "Loop"}},
          "parameters": {"condition": "n < 5", "loop_start": "CNT"}}]),
        runtime=runtime)
    swag, okay, _ = run_frame(runtime, p, {"n": 0})
    assert okay
    assert swag["n"] == 5


# -- remote two-pipeline chaining (reference multitude, in one process) -----

def test_remote_stage_chaining(runtime):
    from aiko_services_tpu_torch.services import Registrar
    registrar = Registrar(runtime=runtime, primary_search_timeout=0.05)

    child = Pipeline(definition(
        ["(D2)"], [element("D2", "Doubler", ["x"], ["x"])],
        name="p_child"), runtime=runtime)

    parent_def = definition(
        ["(A (REMOTE (x: a)) (INC (x: REMOTE.x)))"],
        [element("A", "ElementA", ["a"], ["a"]),
         {"name": "REMOTE",
          "input": [{"name": "x"}], "output": [{"name": "x"}],
          "deploy": {"remote": {"name": "p_child"}}},
         element("INC", "AddOne", ["x"], ["x"])],
        name="p_parent")
    parent = Pipeline(parent_def, runtime=runtime)

    remote_stage = parent.graph.get_node("REMOTE").element
    run_until(runtime,
              lambda: remote_stage.remote_topic_path is not None,
              timeout=5.0)
    assert remote_stage.remote_topic_path == child.topic_path

    swag, okay, diagnostic = run_frame(runtime, parent, {"a": 3},
                                       timeout=10.0)
    assert okay, diagnostic
    assert int(swag["REMOTE.x"]) == 6   # doubled remotely
    assert int(swag["x"]) == 7          # then incremented locally


def test_wire_process_frame(runtime):
    """Frames can be injected over the fabric as S-expressions."""
    p = Pipeline(definition(
        ["(A B)"],
        [element("A", "ElementA", ["a"], ["a"]),
         element("B", "ElementB", ["a"], ["b"])],
        name="p_wire"), runtime=runtime)
    got = []
    response_topic = f"{runtime.topic_path_process}/resp"
    runtime.add_message_handler(lambda t, payload: got.append(payload),
                                response_topic)
    runtime.message.publish(
        f"{p.topic_path}/in",
        f"(process_frame (stream_id: 7 response_topic: {response_topic})"
        f" (a: 5))")
    run_until(runtime, lambda: bool(got), timeout=5.0)
    assert got and "process_frame_response" in got[0]
    assert "(b 6)" in got[0] or "b: 6" in got[0]


def test_set_parameter_routing(runtime):
    """(set_parameter ...) wire command: qualified Element.param targets
    the element's own parameters; bare names become pipeline-level
    (reference pipeline.py:1585-1603)."""
    p = Pipeline(definition(
        ["(A)"], [element("A", "ElementA", ["a"], ["a"])]),
        runtime=runtime)
    node = p.graph.get_node("A")

    p.set_parameter("A.gain", 5)
    assert node.element.get_parameter("gain") == (5, True)
    assert p.get_pipeline_parameter("gain") is None   # element-scoped

    p.set_parameter("threshold", 0.5)
    assert node.element.get_parameter("threshold") == (0.5, True)
    assert p.get_pipeline_parameter("threshold") == 0.5

    # Unknown element prefix falls through to a pipeline parameter.
    p.set_parameter("NoSuch.param", 1)
    assert p.get_pipeline_parameter("NoSuch.param") == 1


# -- the port's refusals ----------------------------------------------------

def test_runtime_jax_rejected_and_torch_is_the_default():
    body = definition(["(A)"], [element("A", "ElementA", ["a"], ["a"])])
    body["runtime"] = "jax"
    with pytest.raises(DefinitionError, match="torch"):
        parse_pipeline_definition(body)
    del body["runtime"]
    assert parse_pipeline_definition(body).runtime == "torch"


def test_placement_block_places_stage(runtime, cpu_pool):
    """A ``placement`` block places its stage on a group of the device
    pool (the eight-CPU pool here), and frames hop onto it."""
    elements = [element("A", "ElementA", ["a"], ["a"]),
                element("B", "ElementB", ["a"], ["b"])]
    elements[1]["placement"] = {"devices": 2}
    p = Pipeline(definition(["(A B)"], elements), runtime=runtime)
    plan = p.stage_placement.plan("B")
    assert list(plan.mesh.devices.flat) == cpu_pool[:2]
    assert plan.device == cpu_pool[0]
    swag, okay, diagnostic = run_frame(runtime, p, {"a": 1})
    assert okay, diagnostic
    assert swag["b"] == 2
    assert p.stage_placement.stats["stages"] == {"B": 2}


def test_placement_block_rejected(runtime, monkeypatch):
    """A placement block over two CUDA cards resolves (the stage's lead
    card is the first, where a frame's claimed pipe arrays go: the card
    run of ``chip_smoke.py`` phase 16a holds that upload), and over CPU
    descriptors the claimed arrays land on the stage -- a host array put
    there and counted, a tensor already there as it is -- without
    reaching the handler that leaves them host-side.  (The name is kept
    from when such a block was refused.)"""
    import numpy as np
    import torch
    from aiko_services_tpu_torch import device as device_rule
    from aiko_services_tpu_torch.pipeline.tensor import resident

    def placed_head(pool, name):
        monkeypatch.setattr(device_rule, "local_devices", lambda: list(pool))
        elements = [element("A", "ElementA", ["a"], ["a"]),
                    element("B", "ElementB", ["a"], ["b"])]
        elements[0]["placement"] = {"devices": 2}
        p = Pipeline(definition(["(A B)"], elements, name=name,
                                parameters={"preflight": "off"}),
                     runtime=runtime)
        monkeypatch.setattr(p.logger, "exception",
                            lambda *args, **kwargs: logged.append(args))
        assert list(p.stage_placement.plan("A").mesh.devices.flat) == pool
        return p

    logged = []
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    p = placed_head(cards, "p_cards")
    assert p.stage_placement.stage_sharding("A") == cards[0]
    pool = [torch.device("cpu", 0), torch.device("cpu", 1)]
    p = placed_head(pool, "p_pool")
    tensor = torch.ones(2)
    landed = p._upload_claimed("s", {"a": tensor,
                                     "b": np.ones(2, np.float32)})
    assert landed["a"] is tensor
    assert isinstance(landed["b"], torch.Tensor)
    torch.testing.assert_close(landed["b"], torch.ones(2))
    for value in landed.values():
        assert resident(value, p.stage_placement.plan("A").device)
    assert p.stage_placement.uploads == 1
    assert logged == []


def test_multi_host_mesh_rejected(runtime):
    """A one-host mesh request needs no bring-up; a multi-host one
    brings up ``torch.distributed``, and a bring-up that fails (here:
    this process has no device to list) is a ``DefinitionError`` naming
    torch.distributed and the coordinator."""
    body = definition(["(A)"], [element("A", "ElementA", ["a"], ["a"])],
                      parameters={"mesh": {"hosts": 1}})
    Pipeline(body, runtime=runtime)
    body = definition(["(A)"], [element("A", "ElementA", ["a"], ["a"])],
                      name="p_mesh",
                      parameters={"mesh": {"hosts": 2,
                                           "coordinator": "localhost:1"},
                                  "preflight": "off"})
    with pytest.raises(DefinitionError,
                       match="torch.distributed bring-up at coordinator "
                             "localhost:1 failed"):
        Pipeline(body, runtime=runtime)


# -- the rewritten fusion and tensor modules -----------------------------

def test_fused_segment_raises_until_ported(runtime):
    """A chain of two elements that declare a ``device_fn`` forms a
    segment on the one device its members name (ported: one captured
    CUDA graph a signature on the card, eager on the CPU).  With no card
    and no ``device: cpu``, forming it raises by the device rule: the
    chain never runs on the host in silence."""
    from aiko_services_tpu_torch.pipeline.fusion import (
        DeviceFn, FusedSegment, partition)
    p = Pipeline(definition(
        ["(A B)"], [element("A", "ElementA", ["a"], ["a"]),
                    element("B", "ElementB", ["a"], ["b"])]),
        runtime=runtime)
    nodes = [p.graph.get_node(name) for name in ("A", "B")]
    for node, out in zip(nodes, ("a", "b")):
        node.element.device_resident = True
        node.element.device_fn = lambda stream, out=out: DeviceFn(
            fn=lambda a: {out: a}, inputs=("a",), outputs=(out,))
    stream = p.create_stream_local("s")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            partition(p, nodes, stream)
    for node in nodes:
        node.element.set_parameter("device", "cpu")
    stream = p.create_stream_local("s2")
    segment, = partition(p, nodes, stream)
    assert isinstance(segment, FusedSegment) and segment.name == "A+B"
    assert segment.device == torch.device("cpu")
    assert partition(p, nodes[:1], stream) == nodes[:1]


def test_compile_cache_dir_is_the_kernel_build_dir(monkeypatch, tmp_path):
    from aiko_services_tpu_torch.ops import _build
    from aiko_services_tpu_torch.pipeline import fusion
    monkeypatch.setattr(fusion, "_CACHE_DIR_CONFIGURED", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("AIKO_COMPILE_CACHE_DIR", raising=False)
    assert fusion.setup_compilation_cache({}) is None
    assert fusion.setup_compilation_cache(None) is None
    wanted = tmp_path / "kernels"
    assert fusion.setup_compilation_cache(
        {"compile_cache_dir": str(wanted)}) == str(wanted)
    assert _build.BUILD_DIR == wanted and wanted.is_dir()
    # the first directory stays for the process
    assert fusion.setup_compilation_cache(
        {"compile_cache_dir": str(tmp_path / "other")}) == str(wanted)
    monkeypatch.setattr(fusion, "_CACHE_DIR_CONFIGURED", None)
    monkeypatch.setenv("AIKO_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert fusion.setup_compilation_cache(
        {"compile_cache_dir": str(wanted)}) == str(tmp_path / "env")


def test_shape_bucketer_and_array_codec():
    import numpy as np
    import torch
    from aiko_services_tpu_torch.pipeline.tensor import (
        ShapeBucketer, decode_array, encode_array, ensure_distributed)
    bucketer = ShapeBucketer()
    assert [bucketer.bucket(n) for n in (1, 16, 17, 100)] == \
        [16, 16, 32, 128]
    padded, size = bucketer.pad(torch.ones((3, 20)), axis=1, fill=-1)
    assert size == 20 and padded.shape == (3, 32)
    assert (padded[:, 20:] == -1).all() and (padded[:, :20] == 1).all()
    same, size = bucketer.pad(torch.ones((16, 2)))
    assert size == 16 and same.shape == (16, 2)
    with pytest.raises(ValueError, match="exceeds"):
        ShapeBucketer([4, 8]).bucket(9)
    for value in (np.arange(6).reshape(2, 3), torch.arange(4.0)):
        decoded = decode_array(encode_array(value))
        assert isinstance(decoded, torch.Tensor)
        np.testing.assert_array_equal(decoded.numpy(), np.asarray(value))
    assert ensure_distributed(None) == (0, 1)
    assert ensure_distributed({"hosts": 1}) == (0, 1)
