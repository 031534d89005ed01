"""The port's command line and dashboard (``aiko_services_tpu_torch/
cli.py``, ``dashboard.py``; copies of the JAX package's held by
``tests/test_torch_engine_drift.py``): twins of
``tests/test_dashboard_cli.py`` on the port's runtime, plus ``convert
llama`` and ``convert detector`` through click's ``CliRunner``, their
checkpoints equal to the port's ``convert`` functions' and their leaves
to the JAX package's conversion of the same file."""

import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from conftest import run_until
from test_convert import _fabricate_hf_llama
from test_torch_llm_element import _port_runtime, _port_teardown

from aiko_services_tpu_torch.dashboard import DashboardModel
from aiko_services_tpu_torch.models import convert, detector, llama
from aiko_services_tpu_torch.models.checkpoint import flatten, maybe_restore
from aiko_services_tpu_torch.services import Actor, Registrar


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


class Worker(Actor):
    def __init__(self, name, runtime=None):
        super().__init__(name, "test/worker:0", runtime=runtime)
        self.share["temperature"] = 20

    def warm_up(self):
        self.ec_producer.update("temperature", 99)


def test_dashboard_model_directory_and_share(runtime):
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    worker = Worker("worker_a", runtime=runtime)
    model = DashboardModel(runtime)

    assert run_until(
        runtime,
        lambda: any(r.name == "worker_a" for r in model.services()),
        timeout=5.0)

    model.select(worker.topic_path)
    assert run_until(runtime,
                     lambda: model.share_view.get("temperature") == "20",
                     timeout=5.0)
    items = dict(model.share_items())
    assert items["lifecycle"] == "ready"

    worker.warm_up()
    assert run_until(runtime,
                     lambda: model.share_view.get("temperature") == "99",
                     timeout=5.0)

    model.update_share("log_level", "DEBUG")
    assert run_until(runtime,
                     lambda: worker.share["log_level"] == "DEBUG",
                     timeout=5.0)

    worker.logger.info("dashboard sees this")
    assert run_until(
        runtime,
        lambda: any("dashboard sees this" in line
                    for line in model.log_lines),
        timeout=5.0)

    model.terminate()
    assert model.selected is None and not model.share_view


def _definition(tmp_path):
    definition = {
        "version": 0, "name": "cli_pipe", "runtime": "torch",
        "graph": ["(echo)"],
        "elements": [{
            "name": "echo",
            "input": [{"name": "text"}],
            "output": [{"name": "text"}],
            "deploy": {"local": {
                "module": "aiko_services_tpu_torch.elements.common",
                "class_name": "Identity"}}}]}
    path = tmp_path / "pipe.json"
    path.write_text(json.dumps(definition))
    return str(path)


def test_cli_pipeline_validate(tmp_path):
    from aiko_services_tpu_torch.cli import main

    result = CliRunner().invoke(
        main, ["pipeline", "validate", _definition(tmp_path)])
    assert result.exit_code == 0, result.output
    data = json.loads(result.output)
    assert data["name"] == "cli_pipe"
    assert data["elements"] == ["echo"]


def test_cli_pipeline_validate_rejects_bad(tmp_path):
    from aiko_services_tpu_torch.cli import main

    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"version": 0, "name": "x"}))
    result = CliRunner().invoke(main, ["pipeline", "validate", str(path)])
    assert result.exit_code != 0


def test_dashboard_plugin_registry_and_registrar_view(runtime):
    from aiko_services_tpu_torch.dashboard import (
        RegistrarPlugin, ServicePlugin, plugin_for, register_plugin,
        _PLUGINS)
    from aiko_services_tpu_torch.pipeline import PROTOCOL_PIPELINE

    assert PROTOCOL_PIPELINE in _PLUGINS

    registrar = Registrar(runtime=runtime, primary_search_timeout=0.05)
    Worker("worker_b", runtime=runtime)
    model = DashboardModel(runtime)
    assert run_until(
        runtime, lambda: len(model.services()) >= 2, timeout=5.0)

    registrar_record = next(r for r in model.services()
                            if r.topic_path == registrar.topic_path)
    assert isinstance(plugin_for(registrar_record), RegistrarPlugin)
    worker_record = next(r for r in model.services()
                         if r.name == "worker_b")
    assert plugin_for(worker_record) is None

    model.select(registrar.topic_path)
    assert run_until(
        runtime,
        lambda: model.share_view.get("service_count") is not None,
        timeout=5.0)
    title, lines = model.plugin_view()
    assert title == "registrar"
    assert any("service_count" in line for line in lines)
    assert any("registrar" in line for line in lines)

    class NamePlugin(ServicePlugin):
        title = "named"

        def render(self, model, record):
            return ["custom"]

    register_plugin("worker_b", NamePlugin)
    try:
        assert isinstance(plugin_for(worker_record), NamePlugin)
        model.select(worker_record.topic_path)
        assert model.plugin_view() == ("named", ["custom"])
    finally:
        _PLUGINS.pop("worker_b", None)
    model.terminate()


def test_dashboard_kill_and_copy_actions(runtime):
    Registrar(runtime=runtime, primary_search_timeout=0.05)
    worker = Worker("worker_k", runtime=runtime)
    model = DashboardModel(runtime)
    assert run_until(
        runtime,
        lambda: any(r.name == "worker_k" for r in model.services()),
        timeout=5.0)

    killed, copied = [], []
    assert model.kill_selected(kill=lambda *a: killed.append(a)) is False
    assert model.copy_selected_topic(copier=copied.append) is None

    model.select(worker.topic_path)
    assert model.copy_selected_topic(copier=copied.append) \
        == (worker.topic_path, True)
    assert copied == [worker.topic_path]

    assert model.kill_selected(kill=lambda *a: killed.append(a)) is False
    assert killed == []

    import signal
    parts = worker.topic_path.split("/")
    other = "/".join(parts[:-2] + [str(int(parts[-2]) + 1), "1"])
    model.selected = other
    assert model.kill_selected(kill=lambda *a: killed.append(a)) is True
    assert killed == [(int(parts[-2]) + 1, signal.SIGKILL)]

    model.selected = f"{parts[0]}/elsewhere/12345/1"
    assert model.kill_selected(kill=lambda *a: killed.append(a)) is False
    assert len(killed) == 1


def test_dashboard_pipeline_plugin_renders_telemetry():
    from aiko_services_tpu_torch.dashboard import PipelinePlugin

    class FakeModel:
        share_view = {
            "element_count": 2, "streams": 1, "frames_processed": 6,
            "telemetry": {
                "frame": {"count": "6", "p50_ms": "2.1",
                          "p90_ms": "3.0", "p99_ms": "3.2"},
                "element": {"A": {"count": "6", "p50_ms": "0.4",
                                  "p99_ms": "0.9"}},
                "stage": {}, "segment": {}, "hop": {}, "queue": {},
                "traces": {"buffered": "6", "completed": "6"}}}

        def share_items(self):
            return []

    lines = PipelinePlugin().render(FakeModel(), record=None)
    joined = "\n".join(lines)
    assert "[telemetry]" in joined
    assert "frame latency ms p50/p90/p99: 2.1/3.0/3.2 n=6" in joined
    assert any("A" in line and "0.4/0.9" in line for line in lines)
    assert "traces: 6 buffered / 6 completed" in joined

    class BareModel(FakeModel):
        share_view = {"element_count": 2, "streams": 0,
                      "frames_processed": 0}

    assert "[telemetry]" not in "\n".join(
        PipelinePlugin().render(BareModel(), record=None))


# -- convert llama / convert detector ----------------------------------------


def test_cli_convert_llama(tmp_path):
    """``convert llama SRC DST --max-seq N``: exit 0, the inferred config
    printed as JSON, and a checkpoint equal to ``convert_llama``'s and
    to the JAX package's leaves."""
    from aiko_services_tpu.models import convert as jax_convert
    from aiko_services_tpu_torch.cli import main
    from safetensors.numpy import save_file
    from test_torch_convert import assert_leaves_bitwise

    config = llama.LlamaConfig.tiny(vocab_size=64, max_seq=32)
    src = tmp_path / "snapshot"
    src.mkdir()
    save_file(_fabricate_hf_llama(config), str(src / "model.safetensors"))
    (src / "config.json").write_text(json.dumps(
        {"num_attention_heads": config.n_heads,
         "num_key_value_heads": config.n_kv_heads,
         "rope_theta": config.rope_theta}))
    dst = tmp_path / "converted"
    result = CliRunner().invoke(main, ["convert", "llama", str(src),
                                       str(dst), "--max-seq", "48"])
    assert result.exit_code == 0, result.output
    report = json.loads(result.output)
    assert report["destination"] == str(dst)
    assert report["config"]["max_seq"] == 48
    assert report["config"]["n_heads"] == config.n_heads
    inferred = llama.LlamaConfig(**report["config"])
    restored = maybe_restore(llama.abstract_params(inferred), str(dst),
                             device="cpu")
    direct = convert.llama_params_from_hf(convert.load_safetensors(src),
                                          inferred)
    for name, leaf in flatten(direct).items():
        assert torch.equal(flatten(restored)[name], leaf), name
    assert_leaves_bitwise(restored, jax_convert.llama_params_from_hf(
        jax_convert.load_safetensors(src),
        jax_convert.infer_llama_config(
            jax_convert.load_safetensors(src), max_seq=48,
            hf_config=json.loads((src / "config.json").read_text()))))


def test_cli_convert_detector(tmp_path):
    import jax
    from aiko_services_tpu.models import detector as jax_detector
    from aiko_services_tpu_torch.cli import main
    from safetensors.numpy import save_file

    config = detector.DetectorConfig.tiny()
    reference = jax_detector.init_params(jax.random.PRNGKey(3),
                                         jax_detector.DetectorConfig.tiny())
    flat = {name: np.asarray(leaf, np.float32)
            for name, leaf in flatten(reference).items()}
    save_file(flat, str(tmp_path / "det.safetensors"))
    dst = tmp_path / "det_ckpt"
    result = CliRunner().invoke(main, ["convert", "detector",
                                       str(tmp_path / "det.safetensors"),
                                       str(dst)])
    assert result.exit_code == 0, result.output
    assert json.loads(result.output) == {"destination": str(dst)}
    restored = maybe_restore(detector.abstract_params(config), str(dst),
                             device="cpu")
    for name, leaf in flatten(restored).items():
        want = torch.from_numpy(flat[name]).to(leaf.dtype)
        if leaf.dim() == 4:
            want = want.permute(3, 2, 0, 1)
        assert torch.equal(leaf, want), name


def test_cli_convert_llama_missing_source_fails(tmp_path):
    from aiko_services_tpu_torch.cli import main
    result = CliRunner().invoke(main, ["convert", "llama",
                                       str(tmp_path / "absent"),
                                       str(tmp_path / "dst")])
    assert result.exit_code != 0
    assert isinstance(result.exception, FileNotFoundError)


def test_chaos_fleet_definition_and_cpu_pool_by_name(monkeypatch):
    """The chaos driver's spawned pipelines: a torch-runtime definition
    that ``create_pipeline`` accepts, placed on the CPU descriptors that
    ``AIKO_CPU_DEVICES`` names (the driver sets it for its children)."""
    import torch
    from aiko_services_tpu_torch import device as device_rule
    from aiko_services_tpu_torch.faults import chaos
    from aiko_services_tpu_torch.pipeline import parse_pipeline_definition
    definition = chaos._definition("chaos1", "/tmp/journals", 5.0)
    assert definition["runtime"] == "torch"
    parse_pipeline_definition(json.dumps(definition))
    monkeypatch.setenv("AIKO_CPU_DEVICES", "3")
    assert device_rule.local_devices() == [torch.device("cpu", index)
                                           for index in range(3)]
