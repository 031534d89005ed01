"""The data plane in the port: twins of the remote-stage runtime cases of
``tests/test_data_plane.py`` -- the pipe hop, the byte ratio, MQTT
negotiation, MQTT mode, pipe death and trace spans -- with uint8,
float32 and bfloat16 torch tensors, each held to the JAX package's run of
the same frames (made by numpy): the returned arrays bit for bit, and
the same ``pipe_frames``, ``mqtt_frames`` and ``fallbacks``.  Pipe death
splits its frames between the pipe and MQTT by when the dead socket
reports, which no run controls; both packages are held to the JAX
test's bounds there.  Elsewhere both sides wait up to CLAIM_TIMEOUT_MS
for a frame's pipe tensors (the default is 5 s), so a process slowed by
other work never re-forwards over MQTT on a live pipe.

Then BASELINE config 4 split over the data plane, as ``chip_smoke.py``'s
phase 16b runs it: ``(DET (fwd))`` in front, the remote ``(CAP (LLM))``
behind, the detector's image and detections crossing the pipe, reply for
reply against the same split in the JAX package (float32 at tiny widths,
the JAX weights carried over through ``models/bridge.py``, as
``tests/test_torch_config4.py`` holds the unsplit pipeline)."""

import contextlib
import importlib
import queue

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_config4 import _float32_detector
from test_torch_llm_element import _float32_tiny, _recording_collector
from torch_pipeline_elements import cpu_pool  # noqa: F401

ROOTS = {"jax": "aiko_services_tpu", "torch": "aiko_services_tpu_torch"}
DTYPES = ("uint8", "float32", "bfloat16")
CLAIM_TIMEOUT_MS = 60000
PATIENT = {"pipe_claim_timeout_ms": CLAIM_TIMEOUT_MS}


@contextlib.contextmanager
def package_runtime(kind: str):
    """A fresh process runtime of the JAX package or the port on its
    in-memory loopback broker, torn down on exit."""
    root = ROOTS[kind]
    transport = importlib.import_module(f"{root}.transport")
    process = importlib.import_module(f"{root}.runtime")
    share = importlib.import_module(f"{root}.services.share")
    transport.reset_broker()
    share.reset_services_cache()
    runtime = process.init_process(transport="loopback")
    runtime.initialize()
    try:
        yield runtime
    finally:
        runtime.engine.terminate()
        process.reset_process()
        share.reset_services_cache()
        transport.reset_broker()


def frame_value(kind: str, array: np.ndarray, dtype: str):
    """``array`` as a frame carries it: numpy (an ml_dtypes bfloat16 array
    for bf16) in the JAX package, a torch tensor in the port."""
    if kind == "jax":
        if dtype == "bfloat16":
            return np.asarray(jnp.asarray(array, jnp.bfloat16))
        return array.astype(dtype)
    if dtype == "bfloat16":
        return torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(array.astype(dtype))


def bits(value) -> tuple:
    """(dtype name, shape, raw bytes) of a returned array."""
    if isinstance(value, torch.Tensor):
        name = str(value.dtype).removeprefix("torch.")
        if value.dtype == torch.bfloat16:
            value = value.view(torch.int16)
        return name, tuple(value.shape), value.numpy().tobytes()
    value = np.asarray(value)
    return str(value.dtype), value.shape, value.tobytes()


def element(root: str, name: str, cls: str) -> dict:
    return {"name": name, "input": [{"name": "x"}],
            "output": [{"name": "x"}],
            "deploy": {"local": {"module": f"{root}.elements.common",
                                 "class_name": cls}}}


def remote(name: str, target: str) -> dict:
    return {"name": name, "input": [{"name": "x"}],
            "output": [{"name": "x"}],
            "deploy": {"remote": {"name": target}}}


def remote_pair(kind: str, runtime, front_params=None, back_params=None,
                suffix: str = "", registrar: bool = True):
    """``front (fwd)`` forwarding to ``back (inc)`` (an Identity), as the
    JAX test builds it."""
    root = ROOTS[kind]
    Pipeline = importlib.import_module(f"{root}.pipeline").Pipeline
    if registrar:
        importlib.import_module(f"{root}.services").Registrar(
            runtime=runtime, primary_search_timeout=0.05)
    back = Pipeline({"version": 0, "name": f"back{suffix}", "runtime": kind,
                     "graph": ["(inc)"],
                     "parameters": dict(back_params or PATIENT),
                     "elements": [element(root, "inc", "Identity")]},
                    runtime=runtime)
    front = Pipeline({"version": 0, "name": f"front{suffix}",
                      "runtime": kind, "graph": ["(fwd)"],
                      "parameters": dict(front_params or PATIENT),
                      "elements": [remote("fwd", f"back{suffix}")]},
                     runtime=runtime)
    stage = front.graph.get_node("fwd").element
    runtime.run(until=lambda: stage.remote_topic_path is not None,
                timeout=10.0)
    assert stage.remote_topic_path is not None, "remote never discovered"
    return front, back, stage


def collect(runtime, responses, count: int, timeout: float = 30.0) -> list:
    rows = []

    def drained():
        while not responses.empty():
            rows.append(responses.get())
        return len(rows) >= count

    runtime.run(until=drained, timeout=timeout)
    return rows


def plane(pipeline) -> dict:
    stats = pipeline.data_plane_stats()
    return {key: stats[key]
            for key in ("pipe_frames", "mqtt_frames", "fallbacks")}


# -- the six runtime cases, as functions of the package ----------------------

def pipe_hop(kind: str, dtype: str) -> dict:
    x = np.arange(256 * 256).reshape(256, 256) % 251
    with package_runtime(kind) as runtime:
        front, back, stage = remote_pair(kind, runtime)
        piped = stage.remote_pipe is not None
        responses = queue.Queue()
        for _ in range(3):
            front.process_frame_local({"x": frame_value(kind, x, dtype)},
                                      stream_id="s",
                                      queue_response=responses)
        rows = collect(runtime, responses, 3)
        out = {"piped": piped, "okay": [row[4] for row in rows],
               "x": [bits(row[2]["x"]) for row in rows],
               "front": plane(front), "back": plane(back),
               "frames": front.share["data_plane_frames"]}
        front.stop()
        back.stop()
    return out


def byte_ratio(kind: str, dtype: str) -> dict:
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (512, 2048)) if dtype == "uint8" \
        else rng.standard_normal((512, 2048))
    value = frame_value(kind, x, dtype)
    nbytes = value.nbytes if kind == "jax" \
        else value.numel() * value.element_size()
    out = {}
    with package_runtime(kind) as runtime:
        for mode, params in (("pipe", PATIENT),
                             ("mqtt", {"data_plane": "mqtt", **PATIENT})):
            front, back, _ = remote_pair(kind, runtime, front_params=params,
                                         back_params=params,
                                         suffix=f"_{mode}",
                                         registrar=mode == "pipe")
            responses = queue.Queue()
            front.process_frame_local({"x": value}, stream_id="s",
                                      queue_response=responses)
            rows = collect(runtime, responses, 1)
            fs, bs = front.data_plane_stats(), back.data_plane_stats()
            wire = fs["pipe_bytes"] + fs["mqtt_bytes"] \
                + bs["pipe_bytes"] + bs["mqtt_bytes"]
            out[mode] = {"okay": [row[4] for row in rows],
                         "x": [bits(row[2]["x"]) for row in rows],
                         "front": plane(front), "back": plane(back),
                         "ratio": wire / (2 * nbytes)}
            front.stop()
            back.stop()
    return out


def mqtt_negotiation(kind: str, dtype: str) -> dict:
    x = np.arange(64)
    with package_runtime(kind) as runtime:
        front, back, stage = remote_pair(
            kind, runtime, back_params={"data_plane": "mqtt", **PATIENT})
        responses = queue.Queue()
        front.process_frame_local({"x": frame_value(kind, x, dtype)},
                                  stream_id="s", queue_response=responses)
        rows = collect(runtime, responses, 1)
        out = {"piped": stage.remote_pipe is not None,
               "okay": [row[4] for row in rows],
               "x": [bits(row[2]["x"]) for row in rows],
               "front": plane(front), "back": plane(back),
               "shared_fallbacks": front.share["data_plane_fallbacks"]}
        front.stop()
        back.stop()
    return out


def mqtt_mode(kind: str, dtype: str) -> dict:
    root = ROOTS[kind]
    Pipeline = importlib.import_module(f"{root}.pipeline").Pipeline
    with package_runtime(kind) as runtime:
        pipeline = Pipeline({"version": 0, "name": "p_mqtt",
                             "runtime": kind, "graph": ["(inc)"],
                             "parameters": {"data_plane": "mqtt"},
                             "elements": [element(root, "inc",
                                                  "Increment")]},
                            runtime=runtime)
        responses = queue.Queue()
        pipeline.process_frame_local(
            {"x": frame_value(kind, np.asarray(1), dtype)}, stream_id="s",
            queue_response=responses)
        rows = collect(runtime, responses, 1)
        out = {"endpoint": pipeline._data_endpoint is not None,
               "tags": [tag for tag in pipeline.tags
                        if tag.startswith("tensor_pipe=")],
               "okay": [row[4] for row in rows],
               "x": [int(row[2]["x"]) for row in rows],
               "plane": plane(pipeline)}
        pipeline.stop()
    return out


def pipe_death(kind: str, dtype: str) -> dict:
    x = np.arange(64 * 1024) % 199
    with package_runtime(kind) as runtime:
        front, back, _ = remote_pair(
            kind, runtime, back_params={"pipe_claim_timeout_ms": 400})
        responses = queue.Queue()
        front.process_frame_local({"x": frame_value(kind, x, dtype)},
                                  stream_id="s", queue_response=responses)
        warm = collect(runtime, responses, 1)
        warm_pipe = front.data_plane_stats()["pipe_frames"]
        back._data_endpoint.close()                   # the pipe dies
        for i in range(4):
            front.process_frame_local(
                {"x": frame_value(kind, x + (i % 7), dtype)},
                stream_id="s", queue_response=responses)
        rows = collect(runtime, responses, 4, timeout=60.0)
        out = {"warm": [row[4] for row in warm], "warm_pipe": warm_pipe,
               "okay": [row[4] for row in rows],
               "order": [row[1] for row in rows],
               "x": [bits(row[2]["x"]) for row in rows],
               "front": plane(front), "alive": "s" in front.streams}
        front.stop()
        back.stop()
    return out


def trace_spans(kind: str, dtype: str) -> dict:
    with package_runtime(kind) as runtime:
        front, back, stage = remote_pair(kind, runtime)
        responses = queue.Queue()
        front.process_frame_local(
            {"x": frame_value(kind, np.arange(16), dtype)}, stream_id="s",
            queue_response=responses)
        rows = collect(runtime, responses, 1)
        trace = front.telemetry.traces.recent(1)[0]
        spans = trace["spans"]
        hop = next(s for s in spans if s["name"] == "remote:fwd")
        remote_root = next(s for s in spans if s["kind"] == "frame"
                           and s["process"] == "back")
        out = {"okay": [row[4] for row in rows],
               "x": [bits(row[2]["x"]) for row in rows],
               "front": plane(front),
               "trace_ids": len({s["trace_id"] for s in spans}),
               "one_trace": {s["trace_id"] for s in spans}
               == {trace["trace_id"]},
               "spans": sorted((s["process"], s["kind"], s["name"])
                               for s in spans),
               "hop_parent": remote_root["parent_id"] == hop["span_id"]}
        front.stop()
        back.stop()
    return out


@pytest.fixture(params=DTYPES)
def dtype(request) -> str:
    return request.param


def test_remote_hop_rides_pipe_and_counts(dtype):
    ours, theirs = pipe_hop("torch", dtype), pipe_hop("jax", dtype)
    assert ours == theirs
    assert ours["piped"] and all(ours["okay"]) and len(ours["okay"]) == 3
    assert ours["front"]["pipe_frames"] == 3      # forwards
    assert ours["back"]["pipe_frames"] == 3       # responses
    assert ours["front"]["fallbacks"] == 0 and ours["frames"] == 3


def test_pipe_payload_byte_ratio_beats_base64(dtype):
    ours, theirs = byte_ratio("torch", dtype), byte_ratio("jax", dtype)
    for mode in ("pipe", "mqtt"):
        assert all(ours[mode]["okay"]) and ours[mode]["okay"]
        for key in ("okay", "x", "front", "back"):
            assert ours[mode][key] == theirs[mode][key], (mode, key)
    assert ours["pipe"]["ratio"] <= 1.05, ours["pipe"]["ratio"]
    assert ours["mqtt"]["ratio"] >= 1.2, ours["mqtt"]["ratio"]


def test_peer_without_pipe_negotiates_mqtt_counted(dtype):
    ours = mqtt_negotiation("torch", dtype)
    assert ours == mqtt_negotiation("jax", dtype)
    assert not ours["piped"] and ours["okay"] == [True]
    assert ours["front"]["pipe_frames"] == 0
    assert ours["front"]["fallbacks"] >= 1 and ours["shared_fallbacks"] >= 1


def test_data_plane_mqtt_mode_binds_nothing(dtype):
    ours = mqtt_mode("torch", dtype)
    assert ours == mqtt_mode("jax", dtype)
    assert not ours["endpoint"] and not ours["tags"]
    assert ours["okay"] == [True] and ours["x"] == [2]


def test_pipe_death_midstream_falls_back_and_completes_in_order(dtype):
    ours, theirs = pipe_death("torch", dtype), pipe_death("jax", dtype)
    for got in (ours, theirs):
        assert got["warm"] == [True] and got["warm_pipe"] == 1
        assert got["okay"] == [True] * 4, got
        assert got["order"] == sorted(got["order"])
        assert got["front"]["fallbacks"] >= 1 and got["alive"]
    assert ours["x"] == theirs["x"]


def test_trace_spans_both_processes_on_pipe_path(dtype):
    ours = trace_spans("torch", dtype)
    assert ours == trace_spans("jax", dtype)
    assert ours["okay"] == [True] and ours["front"]["pipe_frames"] == 1
    assert ours["one_trace"] and ours["hop_parent"]
    assert {process for process, _, _ in ours["spans"]} == {"front", "back"}


def test_split_arrays_refuses_a_device_tensor_it_cannot_fetch():
    """A tensor that is not on the host never reaches ``__array__`` on
    the wire: the engine fetches a frame's device leaves before the data
    plane, and the codec refuses one that skipped the fetch."""
    from aiko_services_tpu_torch.pipeline import codec
    from aiko_services_tpu_torch.pipeline.data_plane import split_arrays
    host = {"x": torch.ones(2), "y": np.zeros(2), "text": "hi"}
    assert sorted(split_arrays(host)) == ["x", "y"]
    meta = torch.ones(2, device="meta")
    for call in (lambda: split_arrays({"x": meta}),
                 lambda: codec.encode_value(meta),
                 lambda: codec.tag_view(meta)):
        with pytest.raises(ValueError, match="fetch"):
            call()


# -- config 4 split over the data plane ---------------------------------------

N_FRAMES = 8
MAX_NEW = 8


def config4_split(kind: str, images: list, llm: dict) -> dict:
    """``(DET (fwd))`` forwarding the detector's image and detections to
    ``(CAP (LLM))`` over the data plane: frame id -> (detections, text),
    with the front's plane counters."""
    root = ROOTS[kind]
    pipeline_module = importlib.import_module(f"{root}.pipeline")
    with package_runtime(kind) as runtime:
        importlib.import_module(f"{root}.services").Registrar(
            runtime=runtime, primary_search_timeout=0.05)
        back = pipeline_module.Pipeline({
            "version": 0, "name": "config4_back", "runtime": kind,
            "graph": ["(CAP (LLM))"], "parameters": dict(PATIENT),
            "elements": [
                {"name": "CAP", "input": [{"name": "detections"}],
                 "output": [{"name": "text"}],
                 "deploy": {"local": {"module": f"{root}.elements.llm",
                                      "class_name": "DetectionCaption"}}},
                {"name": "LLM", "input": [{"name": "text"}],
                 "output": [{"name": "text"}],
                 "parameters": {"max_new_tokens": MAX_NEW, "max_seq": 64,
                                **llm},
                 "deploy": {"local": {"module": f"{root}.elements.llm",
                                      "class_name": "LLM"}}}]},
            runtime=runtime)
        front = pipeline_module.Pipeline({
            "version": 0, "name": "config4_front", "runtime": kind,
            "graph": ["(DET (fwd))"], "parameters": dict(PATIENT),
            "elements": [
                {"name": "DET", "input": [{"name": "image"}],
                 "output": [{"name": "image"}, {"name": "overlay"},
                            {"name": "detections"}],
                 "parameters": {"width": 4, "max_batch": 8},
                 "placement": {"mesh": {"dp": 1}},
                 "deploy": {"local": {"module": f"{root}.elements.detect",
                                      "class_name": "Detector"}}},
                {"name": "fwd", "input": [{"name": "image"},
                                          {"name": "detections"}],
                 "output": [{"name": "text"}],
                 "deploy": {"remote": {"name": "config4_back"}}}]},
            runtime=runtime)
        stage = front.graph.get_node("fwd").element
        runtime.run(until=lambda: stage.remote_topic_path is not None,
                    timeout=10.0)
        responses = queue.Queue()
        stream = front.create_stream_local("s", queue_response=responses)
        for image in images:
            front.create_frame_local(stream, {"image": image})
        rows = collect(runtime, responses, N_FRAMES, timeout=300.0)
        out = {"replies": {}, "front": plane(front), "back": plane(back),
               "weights": {
                   "det": front.graph.get_node("DET").element._params,
                   "llm": back.graph.get_node("LLM").element._batcher.params}}
        for _, frame_id, swag, _, okay, diagnostic in rows:
            assert okay, diagnostic
            # The remote's reply re-encodes the detections it was sent;
            # the detector's own are DET's output.
            out["replies"][frame_id] = (swag["DET.detections"],
                                        swag["text"])
        element = back.graph.get_node("LLM").element
        front.stop()
        back.stop()
        if hasattr(element, "close"):
            element.close()
    return out


@pytest.fixture(scope="module")
def jax_config4_split():
    """The JAX package's split on the frames, once for the module: its
    replies, emitted ids and both elements' weights as numpy."""
    import jax
    from aiko_services_tpu.elements import llm as jax_llm
    from aiko_services_tpu.models import detector as jax_detector
    from aiko_services_tpu.models import llama as jax_llama

    patch = pytest.MonkeyPatch()
    tokens: dict = {}
    patch.setattr(jax_llama.LlamaConfig, "tiny", _float32_tiny(jax_llama))
    patch.setattr(jax_detector, "DetectorConfig",
                  _float32_detector(jax_detector))
    patch.setattr(jax_llm, "_collector",
                  _recording_collector(jax_llm, tokens))
    try:
        out = config4_split("jax", config4_frames(),
                            {"decode_block": 1})
    finally:
        patch.undo()
    weights = {name: jax.tree_util.tree_map(np.asarray, tree)
               for name, tree in out.pop("weights").items()}
    return out, tokens, weights


def config4_frames() -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
            for _ in range(N_FRAMES)]


def test_config4_split_over_data_plane_matches_jax(jax_config4_split,
                                                   cpu_pool, monkeypatch):
    """Every reply of the split config 4 (detections and greedy text, and
    the LLM's emitted ids) equal to the JAX package's split, the images
    crossing the pipe as torch tensors, none falling back to MQTT."""
    from aiko_services_tpu_torch.elements import llm as port_llm
    from aiko_services_tpu_torch.models import bridge
    from aiko_services_tpu_torch.models import detector as port_detector
    from aiko_services_tpu_torch.models import llama

    theirs, their_tokens, weights = jax_config4_split
    ours_tokens: dict = {}
    monkeypatch.setattr(llama.LlamaConfig, "tiny", _float32_tiny(llama))
    monkeypatch.setattr(port_detector, "DetectorConfig",
                        _float32_detector(port_detector))
    monkeypatch.setattr(port_llm, "_collector",
                        _recording_collector(port_llm, ours_tokens))
    monkeypatch.setattr(
        port_llm.llama, "init_params",
        lambda seed, config, device: bridge.params_from_numpy(
            weights["llm"], config, device=device))
    monkeypatch.setattr(
        port_detector, "init_params",
        lambda seed, config, device: bridge.detector_params_from_numpy(
            weights["det"], config, device=device))
    ours = config4_split("torch", [torch.from_numpy(image)
                                   for image in config4_frames()],
                         {"device": "cpu"})
    assert sorted(ours["replies"]) == sorted(theirs["replies"])
    detected = 0
    for frame_id, (detections, text) in ours["replies"].items():
        want_detections, want_text = theirs["replies"][frame_id]
        assert [d["class"] for d in detections] \
            == [d["class"] for d in want_detections]
        for got, expected in zip(detections, want_detections):
            np.testing.assert_allclose(got["box"], expected["box"],
                                       rtol=0, atol=1e-4)
            assert abs(got["score"] - expected["score"]) <= 1e-4
        detected += len(detections)
        assert text == want_text
    assert detected > 0
    assert ours_tokens == their_tokens and len(ours_tokens) == N_FRAMES
    assert ours["front"] == theirs["front"]
    assert ours["front"]["pipe_frames"] == N_FRAMES
    assert ours["front"]["fallbacks"] == 0 and ours["back"]["fallbacks"] == 0
