"""Every file a cell is made of loads by name; the benchmark's sources
import neither JAX nor the JAX package, and its references nothing of
the program."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "torch_bench"
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_config_mix_and_metric_loads_by_name():
    from torch_bench import harness
    for cell in BENCHMARK["workloads"]:
        files = harness.cell_files(BENCHMARK, cell["name"])
        assert files.config["family"] and files.config["system"]
        assert "limits" in files.config and files.mix["kind"]
    for metric in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert callable(harness.reader(metric["name"]))


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    names = [entry["name"] for group in ("configs", "workloads",
                                         "end_to_end", "per_layer")
             for entry in BENCHMARK[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(name) for name in names)
    ends = {m["name"] for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in ends
    for metric in BENCHMARK["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in BENCHMARK["per_layer"]:
        assert metric["moves"] in ends and metric["layer"]
    for cell in BENCHMARK["workloads"]:
        assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
        reported = [m for m in BENCHMARK["per_layer"]
                    if cell["name"] in m.get("workloads", [cell["name"]])]
        assert reported


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            found.add(str(node.args[0].value).split(".")[0])
    return found


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    banned = {"jax", "jaxlib", "flax", "aiko_services_tpu", "bench"}
    assert not _imports(path) & banned, path


@pytest.mark.parametrize("path", sorted((BENCH / "models").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    assert "aiko_services_tpu_torch" not in _imports(path)
    assert "aiko_services_tpu_torch" not in path.read_text()


def test_the_whole_name_is_compared():
    from torch_bench.harness import BANNED
    assert "aiko_services_tpu_torch".split(".")[0] not in BANNED
