"""The PyTorch port's overlapped frame execution: twins of the
ledger-only cases of ``tests/test_overlap.py`` (device-resident swag
between device elements, the transfer-guard ledger, the bounded dispatch
window, codec round trips) on ``aiko_services_tpu_torch`` with CPU
tensors, and the port's own pieces: ``TransferLedger`` and
``DeviceWindow`` as units, the journal's horizon at torch leaves, and
the residency rule's torch host copies.

On the CPU nothing waits for a card, so the CUDA synchronisation guard
never fires here; the software residency check does, as it does for the
JAX package on its CPU backend (``tests/test_torch_cuda.py`` holds the
guard itself on the card)."""

import json
import queue
import threading

import numpy as np
import pytest
import torch

from conftest import run_until

from aiko_services_tpu_torch.analysis.residency import \
    analyze_element_sources
from aiko_services_tpu_torch.pipeline import (PipelineElement, StreamEvent,
                                              create_pipeline)
from aiko_services_tpu_torch.pipeline.codec import (decode_frame_data,
                                                    decode_value,
                                                    encode_frame_data,
                                                    encode_value, tag_view,
                                                    untag_view)
from aiko_services_tpu_torch.pipeline.journal import StreamJournal, _encodable
from aiko_services_tpu_torch.pipeline.overlap import (DeviceWindow,
                                                      TransferLedger,
                                                      device_leaves,
                                                      touches_devices)

DELAY = 0.05

# (element name, arrived-as-tensor) per process_frame call, so tests can
# assert values stayed device-resident BETWEEN elements.
ARRIVALS: list = []


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


class DeviceUpload(PipelineElement):
    """Head element: host value -> tensor (one explicit upload)."""

    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": torch.as_tensor(x)}


class DeviceDouble(PipelineElement):
    """Device stage: consumes and produces tensors, never syncing."""

    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        ARRIVALS.append((self.name, isinstance(x, torch.Tensor)))
        return StreamEvent.OKAY, {"x": torch.as_tensor(x) * 2}


class HostSink(PipelineElement):
    """Host stage (``host_inputs``): the engine fetches explicitly."""

    host_inputs = ("x",)

    def process_frame(self, stream, x=None, **inputs):
        ARRIVALS.append((self.name, isinstance(x, torch.Tensor)))
        return StreamEvent.OKAY, {"total": float(np.asarray(x).sum())}


class LeakyDevice(PipelineElement):
    """Regression stand-in: a device element that fetches its declared
    device output to host."""

    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": (torch.as_tensor(x) * 2).numpy()}


class AsyncDevice(PipelineElement):
    """Async device stage with a fixed service delay: hands its output
    tensor over at once and completes ``delay`` seconds later."""

    device_resident = True
    is_async = True

    def process_frame_start(self, stream, complete, x=None, **inputs):
        y = torch.as_tensor(x) + 1
        delay, _ = self.get_parameter("delay", DELAY)
        threading.Timer(float(delay),
                        lambda: complete(StreamEvent.OKAY, {"x": y})).start()


def _definition(tmp_path, elements, graph, parameters=None, types=None):
    """elements: [(name, class_name, element_params)]; all single
    input/output ``x`` unless ``types`` overrides the output type."""
    body = {
        "version": 0, "name": "overlap", "runtime": "torch",
        "graph": graph, "parameters": parameters or {},
        "elements": [
            {"name": name,
             "input": [{"name": "x"}],
             "output": [{"name": "x",
                         "type": (types or {}).get(name, "any")}],
             "parameters": params or {},
             "deploy": {"local": {"module": "test_torch_overlap",
                                  "class_name": cls}}}
            for name, cls, params in elements]}
    path = tmp_path / "overlap.json"
    path.write_text(json.dumps(body))
    return str(path)


def _pump(pipeline, stream, values):
    for value in values:
        pipeline.create_frame_local(stream, {"x": value})


# -- device-resident swag between consecutive device elements -----------

def test_swag_stays_device_resident_between_device_elements(
        tmp_path, runtime):
    ARRIVALS.clear()
    responses = queue.Queue()
    pipeline = create_pipeline(
        _definition(tmp_path,
                    [("up", "DeviceUpload", {}),
                     ("d1", "DeviceDouble", {}),
                     ("d2", "DeviceDouble", {})],
                    ["(up d1 d2)"],
                    parameters={"transfer_guard": "disallow"}),
        runtime=runtime)
    stream = pipeline.create_stream_local("s", queue_response=responses)
    _pump(pipeline, stream, [np.arange(4, dtype=np.float32)])
    assert run_until(runtime, lambda: not responses.empty(), timeout=10.0)
    _, _, swag, _, okay, diagnostic = responses.get()
    assert okay, diagnostic
    assert ARRIVALS == [("d1", True), ("d2", True)]
    assert isinstance(swag["x"], torch.Tensor)
    np.testing.assert_allclose(swag["x"].numpy(),
                               np.arange(4, dtype=np.float32) * 4)
    stats = pipeline.transfer_stats()
    assert stats["implicit"] == 0
    assert stats["explicit"] == 0
    pipeline.stop()


def test_host_typed_input_is_fetched_explicitly(tmp_path, runtime):
    ARRIVALS.clear()
    responses = queue.Queue()
    pipeline = create_pipeline(
        _definition(tmp_path,
                    [("up", "DeviceUpload", {}),
                     ("sink", "HostSink", {})],
                    ["(up sink)"],
                    parameters={"transfer_guard": "disallow"}),
        runtime=runtime)
    stream = pipeline.create_stream_local("s", queue_response=responses)
    _pump(pipeline, stream, [np.arange(4, dtype=np.float32)])
    assert run_until(runtime, lambda: not responses.empty(), timeout=10.0)
    _, _, swag, _, okay, diagnostic = responses.get()
    assert okay, diagnostic
    assert swag["total"] == 6.0
    assert ARRIVALS == [("sink", False)]    # materialized host-side
    stats = pipeline.transfer_stats()
    assert stats["explicit"] == 1           # ONE counted engine fetch
    assert stats["implicit"] == 0
    pipeline.stop()


def test_transfer_guard_disallow_fails_host_sync_fast(tmp_path, runtime):
    responses = queue.Queue()
    pipeline = create_pipeline(
        _definition(tmp_path,
                    [("up", "DeviceUpload", {}),
                     ("leak", "LeakyDevice", {})],
                    ["(up leak)"],
                    parameters={"transfer_guard": "disallow"},
                    types={"leak": "tensor"}),
        runtime=runtime)
    stream = pipeline.create_stream_local("s", queue_response=responses)
    _pump(pipeline, stream, [np.arange(4, dtype=np.float32)])
    assert run_until(runtime, lambda: not responses.empty(), timeout=10.0)
    _, _, _, _, okay, diagnostic = responses.get()
    assert not okay
    assert "transfer_guard" in diagnostic
    assert pipeline.transfer_stats()["implicit"] == 1
    pipeline.stop()


def test_transfer_guard_log_records_without_failing(tmp_path, runtime):
    responses = queue.Queue()
    pipeline = create_pipeline(
        _definition(tmp_path,
                    [("up", "DeviceUpload", {}),
                     ("leak", "LeakyDevice", {})],
                    ["(up leak)"],
                    parameters={"transfer_guard": "log"},
                    types={"leak": "tensor"}),
        runtime=runtime)
    stream = pipeline.create_stream_local("s", queue_response=responses)
    _pump(pipeline, stream, [np.arange(4, dtype=np.float32)])
    assert run_until(runtime, lambda: not responses.empty(), timeout=10.0)
    *_, okay, diagnostic = responses.get()
    assert okay, diagnostic
    assert pipeline.transfer_stats()["implicit"] == 1
    pipeline.stop()


def test_frames_overlap_across_device_stages_two_streams(
        tmp_path, runtime):
    """Frame k+1's first element STARTS before frame k's last element
    COMPLETES, on two streams, with nothing transferred implicitly."""
    frames_per_stream = 3
    pipeline = create_pipeline(
        _definition(tmp_path,
                    [("a", "AsyncDevice", {}), ("b", "AsyncDevice", {})],
                    ["(a b)"],
                    parameters={"transfer_guard": "disallow"}),
        runtime=runtime)
    collected: dict = {"s1": [], "s2": []}
    queues = {}
    for stream_id in collected:
        queues[stream_id] = queue.Queue()
        stream = pipeline.create_stream_local(
            stream_id, queue_response=queues[stream_id])
        _pump(pipeline, stream,
              [np.full((8,), i, dtype=np.float32)
               for i in range(frames_per_stream)])
    assert run_until(
        runtime,
        lambda: all(queues[s].qsize() >= frames_per_stream
                    for s in queues),
        timeout=30.0)
    for stream_id, rows in collected.items():
        while not queues[stream_id].empty():
            _, frame_id, swag, metrics, okay, diagnostic = \
                queues[stream_id].get()
            assert okay, diagnostic
            assert isinstance(swag["x"], torch.Tensor)
            rows.append((frame_id, metrics))
        rows.sort()
        assert len(rows) == frames_per_stream
        for (_, earlier), (_, later) in zip(rows, rows[1:]):
            k_last_done = earlier["b_time_start"] + earlier["b_time"]
            assert later["a_time_start"] < k_last_done
    assert pipeline.transfer_stats()["implicit"] == 0
    pipeline.stop()


def test_device_window_bounds_inflight_dispatch(tmp_path, runtime):
    frames = 6
    limit = 2
    responses = queue.Queue()
    pipeline = create_pipeline(
        _definition(tmp_path,
                    [("up", "DeviceUpload", {}),
                     ("d1", "DeviceDouble", {})],
                    ["(up d1)"],
                    parameters={"device_inflight": limit}),
        runtime=runtime)
    stream = pipeline.create_stream_local("s", queue_response=responses)
    _pump(pipeline, stream, [np.arange(4, dtype=np.float32)] * frames)
    assert run_until(runtime, lambda: responses.qsize() >= frames,
                     timeout=15.0)
    window = stream.device_window
    assert window.noted == frames
    assert window.outstanding <= limit
    assert window.synced >= frames - limit
    pipeline.stop()


def test_device_window_disabled_never_paces(tmp_path, runtime):
    responses = queue.Queue()
    pipeline = create_pipeline(
        _definition(tmp_path,
                    [("up", "DeviceUpload", {}),
                     ("d1", "DeviceDouble", {})],
                    ["(up d1)"],
                    parameters={"device_inflight": 0}),
        runtime=runtime)
    stream = pipeline.create_stream_local("s", queue_response=responses)
    _pump(pipeline, stream, [np.arange(4, dtype=np.float32)] * 4)
    assert run_until(runtime, lambda: responses.qsize() >= 4,
                     timeout=15.0)
    assert stream.device_window.synced == 0
    pipeline.stop()


# -- TransferLedger and DeviceWindow as units -----------------------------

def test_transfer_ledger_policies():
    assert TransferLedger().policy == "allow"
    assert not TransferLedger().active
    for policy in ("log", " Disallow "):
        assert TransferLedger(policy).active
    with pytest.raises(ValueError, match="transfer_guard"):
        TransferLedger("forbid")
    with TransferLedger("disallow").guard():   # no card: nothing to wait
        torch.ones(2).sum().item()


def test_transfer_ledger_fetch_counts_once_per_tree():
    ledger = TransferLedger("disallow")
    tree = {"a": torch.arange(3), "b": [torch.ones(2), "text"],
            "c": {"d": torch.zeros((), dtype=torch.bfloat16)}, "e": 5}
    fetched = ledger.fetch(tree, label="sink")
    assert isinstance(fetched["a"], np.ndarray)
    np.testing.assert_array_equal(fetched["a"], [0, 1, 2])
    assert fetched["b"][1] == "text" and fetched["e"] == 5
    assert fetched["c"]["d"].dtype == torch.bfloat16   # numpy has no bf16
    host = {"host": np.ones(2), "n": 1}
    assert ledger.fetch(host) is host       # nothing to fetch: uncounted

    class InFlight:                   # a host copy already enqueued
        def numpy(self):
            return {"emitted": np.ones((2, 4), np.int32)}
    assert ledger.fetch(InFlight(), label="llm_block")["emitted"].shape \
        == (2, 4)
    ledger.record_implicit(2)
    assert ledger.stats == {"policy": "disallow", "implicit": 2,
                            "explicit": 2,
                            "explicit_by_label": {"sink": 1,
                                                  "llm_block": 1}}


def test_transfer_ledger_guard_error_test():
    assert TransferLedger.is_guard_error(
        RuntimeError("called a synchronizing CUDA operation"))
    assert not TransferLedger.is_guard_error(RuntimeError("out of memory"))


def test_device_window_on_cpu_tensors():
    window = DeviceWindow()
    window.note(0, {"text": "no tensors"})
    assert window.noted == 0
    for frame_id in range(4):
        window.note(frame_id, {"x": torch.ones(2), "meta": [1, "a"]})
    assert window.outstanding == 4
    assert window.pace(0) == 0.0 and window.pace(None) == 0.0
    assert window.pace(2) >= 0.0
    assert window.outstanding == 1 and window.synced == 3
    assert window.invalidate({torch.device("cuda", 0)}) == 0
    assert window.invalidate({torch.device("cpu")}) == 1
    window.note(9, [torch.ones(1)])
    window.drain()
    assert window.stats == {"outstanding": 0, "noted": 5, "synced": 4,
                            "invalidated": 1}
    window.note(10, (torch.ones(1),))
    window.clear()
    assert window.outstanding == 0


def test_device_leaves_and_touches_devices():
    tree = {"a": torch.ones(1), "b": [np.ones(1), (torch.zeros(2), "s")]}
    assert len(device_leaves(tree)) == 2
    assert touches_devices(tree, {torch.device("cpu")})
    assert not touches_devices(tree, {torch.device("cuda", 0)})
    assert not touches_devices({"a": np.ones(1)}, {torch.device("cpu")})


# -- the journal's horizon and the residency rule --------------------------

def test_journal_skips_torch_leaves(tmp_path):
    assert not _encodable(torch.ones(2))
    assert not _encodable(torch.ones(2, dtype=torch.bfloat16))
    assert _encodable(np.ones(2)) and _encodable("text") and _encodable(3)
    data, partial = StreamJournal._encode_swag(
        {"x": torch.ones(2), "n": 3, "A.n": 3, "host": np.arange(2)})
    assert partial and set(data) == {"n", "host"}


RESIDENCY_SOURCE = '''
import torch
from aiko_services_tpu_torch.pipeline import PipelineElement
from aiko_services_tpu_torch.pipeline.fusion import DeviceFn


class CpuCopy(PipelineElement):
    def process_frame(self, stream, x=None):
        return True, {"y": x.cpu()}


class NumpyCopy(PipelineElement):
    def process_frame(self, stream, x=None):
        return True, {"y": x.numpy()}


class ListCopy(PipelineElement):
    def process_frame(self, stream, x=None):
        return True, {"y": x.tolist()}


class ToCpu(PipelineElement):
    def process_frame(self, stream, x=None):
        return True, {"y": x.to("cpu"), "z": x.to(device="cpu:0")}


class StaysOnCard(PipelineElement):
    def process_frame(self, stream, x=None):
        return True, {"y": x.to("cuda") * 2, "n": x.to(torch.float32)}


class Declared(PipelineElement):
    host_inputs = ("x",)

    def process_frame(self, stream, x=None):
        return True, {"y": x.cpu()}


class TracedCopy(PipelineElement):
    def device_fn(self, stream):
        return DeviceFn(fn=lambda x: {"y": x.cpu() * 2}, inputs=("x",),
                        outputs=("y",))
'''


def test_residency_flags_torch_host_copies(tmp_path):
    source = tmp_path / "port_elements.py"
    source.write_text(RESIDENCY_SOURCE)
    findings = analyze_element_sources([source])
    undeclared = sorted(f.message for f in findings
                        if f.rule == "undeclared-host-input")
    flagged = {name for name in ("CpuCopy", "NumpyCopy", "ListCopy",
                                 "ToCpu", "StaysOnCard", "Declared")
               if any(name in message for message in undeclared)}
    assert flagged == {"CpuCopy", "NumpyCopy", "ListCopy", "ToCpu"}
    for call in ('.cpu()', '.numpy()', '.tolist()', '.to("cpu")'):
        assert any(call in message for message in undeclared), call
    traced = [f for f in findings if f.rule == "device-fn-host-call"]
    assert len(traced) == 1 and ".cpu()" in traced[0].message


# -- codec round trips (process-boundary satellite) ----------------------

def test_codec_roundtrip_zero_dim_scalars():
    for value in (np.float32(3.5), np.int32(-7), np.float64(2.25),
                  torch.tensor(1.5, dtype=torch.float32)):
        decoded = decode_value(encode_value(value))
        assert decoded.shape == ()
        np.testing.assert_allclose(np.asarray(decoded, dtype=np.float64),
                                   float(value))
    decoded = decode_value(encode_value(torch.tensor(1.5,
                                                     dtype=torch.bfloat16)))
    assert decoded.shape == () and decoded.dtype == torch.bfloat16
    assert float(decoded) == 1.5


def test_codec_roundtrip_bf16_tensors():
    tensor = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 4
    tensor = tensor.to(torch.bfloat16)
    decoded = decode_value(encode_value(tensor))
    assert decoded.dtype == torch.bfloat16          # bfloat16 kept
    assert decoded.shape == (2, 3)
    assert torch.equal(decoded, tensor)
    wire, tag = tag_view(tensor)
    assert tag == "bfloat16" and wire.dtype == np.int16
    assert torch.equal(untag_view(wire, tag), tensor)
    wire, tag = tag_view(np.ones(3, np.float32))
    assert tag is None and untag_view(wire, tag) is wire
    with pytest.raises(ValueError, match="extension dtype"):
        decode_value("npyt:no_such_dtype:AAAA")


def test_codec_plain_void_dtype_falls_back_to_npy():
    value = np.zeros(4, dtype="V3")
    encoded = encode_value(value)
    assert isinstance(encoded, str) and encoded.startswith("npy64:")


def test_codec_roundtrip_nested_frame_data():
    frame = {"image": np.zeros((2, 2, 3), dtype=np.uint8),
             "logits": torch.ones((4,), dtype=torch.bfloat16),
             "meta": {"names": ["a", "b"], "score": 0.5},
             "rows": [torch.tensor(1.0), "text"]}
    decoded = decode_frame_data(encode_frame_data(frame))
    assert decoded["meta"] == {"names": ["a", "b"], "score": 0.5}
    assert decoded["rows"][1] == "text"
    assert decoded["logits"].dtype == torch.bfloat16
    np.testing.assert_array_equal(decoded["image"], frame["image"])
    np.testing.assert_array_equal(decoded["rows"][0], 1.0)
