"""One run of one cell: find the cell's files by name, drive its system
through set-up and the measured window, read its metrics, judge its
outputs against the plain reference, and print the result.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

- the workload's ``config`` -> the ``configs`` entry's ``file``; its
  ``family`` names ``models/<family>.py`` (weights, reference, counts)
  and its ``system`` names ``systems/<system>.py`` (what drives it);
- the workload's ``traffic`` -> ``mixes/<traffic>.json``;
- each metric's ``name`` -> ``metrics/<name>.py``, whose ``read(run)``
  returns the number or None (nothing to read in this run).

The configuration's ``limits`` give each compared number's limit.
"""

from __future__ import annotations

import faulthandler
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from .trace import Slice

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BANNED = {"jax", "jaxlib", "flax", "aiko_services_tpu"}
#: the longest a run's set-up and window may take before it gives up
LIMIT_S = 300.0
#: past this, a run that still goes on prints every thread's stack and
#: exits non-zero (a run must end within 360 s)
WATCHDOG_S = 340.0


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as stream:
        return json.load(stream)


def cell_files(benchmark: dict, workload: str,
               mixes: Path = BENCH / "mixes") -> SimpleNamespace:
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in benchmark["configs"]}
    with open(ROOT / configs[cell["config"]]["file"]) as stream:
        config = json.load(stream)
    with open(mixes / f"{cell['traffic']}.json") as stream:
        mix = json.load(stream)
    return SimpleNamespace(cell=cell, config=config, mix=mix)


def metric_names(benchmark: dict, workload: str, trace: bool) -> list:
    """The cell's metrics: its end-to-end ones, or with ``trace`` its
    per-layer ones (a metric without ``workloads`` belongs to every
    cell)."""
    group = benchmark["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"torch_bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def loaded_banned() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & BANNED)


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: str, started: float, benchmark: dict | None = None,
            keep_inputs: bool = False, mixes: Path = BENCH / "mixes",
            mix_changes: dict | None = None) -> tuple[dict, dict]:
    """Run the cell once -> (the result line, the run's record).
    ``mix_changes`` replaces keys of the mix (a rate sweep's)."""
    benchmark = benchmark or load_benchmark()
    files = cell_files(benchmark, workload, mixes)
    files.mix.update(mix_changes or {})
    family = importlib.import_module(
        f"torch_bench.models.{files.config['family']}")
    system = importlib.import_module(
        f"torch_bench.systems.{files.config['system']}")
    trace_s = min(float(files.mix.get("trace_s", 1.5)), seconds / 2)

    def slice_for(opened: float):
        if not trace:
            return None
        return Slice(opened + (seconds - trace_s) / 2, trace_s)

    ctx = SimpleNamespace(config=files.config, mix=files.mix, family=family,
                          seed=seed, seconds=seconds, device=device,
                          started=started, limit_s=LIMIT_S,
                          keep_inputs=keep_inputs, slice_for=slice_for)
    run = system.run(ctx)
    run["family"] = family
    metrics = {}
    for metric in metric_names(benchmark, workload, trace):
        value = reader(metric["name"])(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"{workload}: no {metric['name']}")
            print(f"torch_bench: {metric['name']} found nothing to read",
                  file=sys.stderr, flush=True)
            continue
        metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    limits = files.config["limits"]
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in run["checks"].items()}
    correct = run["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": run["attempted"],
            "failed": run["failed"], "metrics": metrics,
            "device": device_record(device, run, trace)}
    if trace and run["trace"] is not None:
        line["breakdown"] = run["trace"].breakdown()
    line["judged"] = run["judged"]
    line["checks"] = checks
    return line, run


def device_record(device: str, run: dict, trace: bool) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        record = {"platform": "gpu",
                  "kind": torch.cuda.get_device_name(device), "count": 1}
    else:
        record = {"platform": "cpu", "kind": "cpu", "count": 1}
    record["memory_peak_bytes"] = run["memory_peak_bytes"]
    if trace and run["trace"] is not None:
        record["busy_s"] = run["trace"].busy_s()
        record["window_s"] = run["trace"].window_s
    return record


def report(line: dict) -> None:
    """The compared numbers on standard error, then the line."""
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def main(argv=None, started: float | None = None) -> int:
    import argparse
    started = time.perf_counter() if started is None else started
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    benchmark = load_benchmark()
    cells = {w["name"]: w for w in benchmark["workloads"]}
    chips = cells.get(args.workload, {}).get("chips", 1)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"torch_bench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    line, _ = execute(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", started, benchmark)
    banned = loaded_banned()
    if banned:
        print(f"torch_bench: the process loaded {banned}", file=sys.stderr)
        return 3
    report(line)
    return 0
