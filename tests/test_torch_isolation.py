"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points never fall back to the CPU silently."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.models import batching, bridge, llama, paged
from aiko_services_tpu_torch.ops import rope_frequencies

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "aiko_services_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "aiko_services_tpu")


def _forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".")
               for name in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests/test_torch_cuda.py",
        ROOT / "tests/torch_multihost_worker.py",
        ROOT / "tests/test_torch_multihost_cuda.py"],
    ids=lambda path: str(path.relative_to(ROOT)))
def test_no_jax_import_in_port_sources(path):
    bad = [module for module in _imports(path) if _forbidden(module)]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_no_jax_in_sys_modules():
    modules = sorted(
        "aiko_services_tpu_torch." + ".".join(
            path.relative_to(PORT).with_suffix("").parts)
        # __main__ runs the command line when imported; it imports
        # nothing but cli, which the sweep imports.
        for path in PORT.rglob("*.py")
        if path.name not in ("__init__.py", "__main__.py"))
    code = ("import sys, importlib\n"
            "import aiko_services_tpu_torch\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib') or "
            "m.startswith(('jax.', 'jaxlib.', 'aiko_services_tpu.')) or "
            "m == 'aiko_services_tpu']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    result = subprocess.run([sys.executable, "-c", code], env=env,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


PIPELINE_RUN = """
import json, queue, sys
from aiko_services_tpu_torch.pipeline import create_pipeline
from aiko_services_tpu_torch.runtime import init_process
module = "aiko_services_tpu_torch.elements.llm"
definition = {"version": 0, "name": "cap_llm", "graph": ["(CAP (LLM))"],
              "parameters": {"transfer_guard": "disallow"},
              "elements": [
    {"name": "CAP", "input": [{"name": "detections"}],
     "output": [{"name": "text"}],
     "deploy": {"local": {"module": module,
                          "class_name": "DetectionCaption"}}},
    {"name": "LLM", "input": [{"name": "text"}],
     "output": [{"name": "text"}],
     "parameters": {"device": "cpu", "max_new_tokens": 4, "max_seq": 64,
                    "decode_block_tokens": 4},
     "deploy": {"local": {"module": module, "class_name": "LLM"}}}]}
path = sys.argv[1]
with open(path, "w") as handle:
    json.dump(definition, handle)
runtime = init_process(transport="loopback")
runtime.initialize()
pipeline = create_pipeline(path, runtime=runtime)
responses = queue.Queue()
stream = pipeline.create_stream_local("1", queue_response=responses)
for detections in ([{"class": "cat"}], []):
    pipeline.create_frame_local(stream, {"detections": detections})
runtime.run(until=lambda: responses.qsize() >= 2, timeout=60.0)
assert responses.qsize() == 2
while not responses.empty():
    *_, okay, diagnostic = responses.get()
    assert okay, diagnostic
pipeline.stop()
pipeline.graph.get_node("LLM").element.close()
runtime.engine.terminate()
bad = [m for m in sys.modules if m in ("jax", "jaxlib", "ml_dtypes",
                                       "aiko_services_tpu")
       or m.startswith(("jax.", "jaxlib.", "ml_dtypes.",
                        "aiko_services_tpu."))]
assert not bad, bad
print("frames ok")
"""


def test_port_pipeline_run_leaves_no_jax_in_sys_modules(tmp_path):
    """A tiny ``(CAP (LLM))`` pipeline through the port's
    ``create_pipeline`` on the CPU, in a fresh interpreter: the frames
    complete and no jax, jaxlib, ml_dtypes or JAX package module was
    loaded on the way."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    result = subprocess.run(
        [sys.executable, "-c", PIPELINE_RUN, str(tmp_path / "cap.json")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert "frames ok" in result.stdout


def _tiny():
    return llama.LlamaConfig.tiny(vocab_size=64, max_seq=32)


def _entry_points():
    config = _tiny()
    params = llama.init_params(0, config, device="cpu")
    tree = {"embed": np.zeros((64, 64), np.float32)}
    return {
        "init_params": lambda: llama.init_params(0, config),
        "init_cache": lambda: llama.init_cache(config, 2),
        "ContinuousBatcher": lambda: batching.ContinuousBatcher(
            params, config, max_slots=2),
        "params_from_numpy": lambda: bridge.params_from_numpy(tree, config),
        "rope_frequencies": lambda: rope_frequencies(16, 8),
        "init_paged_cache": lambda: paged.init_paged_cache(config, 2, 32,
                                                           16),
        "ContinuousBatcher_paged": lambda: batching.ContinuousBatcher(
            params, config, max_slots=2, prefill_chunk=16,
            kv_page_tokens=16),
    }


@pytest.mark.parametrize("entry", ["init_params", "init_cache",
                                   "ContinuousBatcher",
                                   "params_from_numpy", "rope_frequencies",
                                   "init_paged_cache",
                                   "ContinuousBatcher_paged"])
def test_entry_point_without_card_raises(entry, monkeypatch):
    call = _entry_points()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("entry", ["init_params", "init_cache",
                                   "rope_frequencies", "init_paged_cache"])
def test_entry_point_runs_on_cpu_when_asked(entry):
    config = _tiny()
    if entry == "init_params":
        out = llama.init_params(0, config, device="cpu")["embed"]
    elif entry == "init_cache":
        out = llama.init_cache(config, 2, device="cpu")["k"]
    elif entry == "rope_frequencies":
        out = rope_frequencies(16, 8, device="cpu")
    else:
        out = paged.init_paged_cache(config, 2, 32, 16,
                                     device="cpu")["page_table"]
    assert out.device.type == "cpu"


def _smoke(cwd: Path, script: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_card():
    result = _smoke(ROOT, ROOT / "chip_smoke.py")
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", script)
    result = _smoke(tmp_path, script)
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout
