"""A tiny run of each cell on the CPU prints a last line of the
contract's shape; off a card the command refuses; a stall inside the
window shows in the rate and the tail."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [cell["name"] for cell in BENCHMARK["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_prints_the_contract_line(run_tiny, workload, capsys):
    from torch_bench import harness
    line, _ = run_tiny(workload)
    harness.report(line)
    out, err = capsys.readouterr()
    printed = json.loads(out.strip().splitlines()[-1])
    assert list(printed)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(printed)
    assert printed["correct"] is True and printed["failed"] == 0
    wanted = {m["name"] for m in harness.metric_names(BENCHMARK, workload,
                                                      False)}
    assert set(printed["metrics"]) == wanted
    for metric in printed["metrics"].values():
        assert metric["value"] > 0 and metric["unit"]
    assert set(printed["device"]) >= {"platform", "kind", "count",
                                      "memory_peak_bytes"}
    lines = err.strip().splitlines()[-len(printed["checks"]):]
    assert all(text.startswith("check ") and " limit " in text
               for text in lines)


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_tiny_run_reads_per_layer_metrics(run_tiny, workload):
    from torch_bench import harness
    line, _ = run_tiny(workload, seconds=4.0, trace=True)
    allowed = {m["name"] for m in harness.metric_names(BENCHMARK, workload,
                                                       True)}
    assert set(line["metrics"]) <= allowed and line["metrics"]
    assert "window_s" in line["device"] and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_off_a_card_the_command_prints_no_result(tmp_path):
    result = subprocess.run(
        [sys.executable, str(ROOT / "torch_bench" / "run.py"),
         "--workload", CELLS[0], "--seed", str(2 ** 31 + 9),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode != 0
    assert result.stdout.strip() == ""


def test_a_stall_in_the_window_moves_the_rate_and_the_tail(run_tiny):
    """The same seed twice; the second time every step of two seconds
    inside the window sleeps half a second: fewer tokens a second, a
    longer p95 first-token time."""
    from aiko_services_tpu_torch.models.batching import ContinuousBatcher
    from torch_bench import harness
    workload = "mistral7b.chat"
    plain, _ = run_tiny(workload, seconds=4.0)
    step = ContinuousBatcher.step
    state = {}

    def stalled(self):
        now = time.perf_counter()
        begin = state.setdefault("begin", now)
        if begin + 1.5 < now < begin + 3.5:
            time.sleep(0.5)
        return step(self)
    ContinuousBatcher.step = stalled
    try:
        slow, _ = run_tiny(workload, seconds=4.0)
    finally:
        ContinuousBatcher.step = step
    rate, tail = ("tokens_per_s", "ttft_p95_ms")
    metrics, slowed = plain["metrics"], slow["metrics"]
    assert slowed[rate]["value"] < 0.9 * metrics[rate]["value"]
    assert slowed[tail]["value"] > metrics[tail]["value"]
    assert harness.loaded_banned() == []
