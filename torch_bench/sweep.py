#!/usr/bin/env python3
"""The highest rate a cell's system sustains, found once by a sweep on
the card: the cell runs once at each total rate given (its mix's
``fps_per_stream`` set to the rate over its ``streams``), all in one
process, and each run prints what it offered, what it answered and its
latency.  A rate is sustained where the answers keep up with the
offer and the latency does not grow through the window.

    python3 torch_bench/sweep.py --workload config4.cameras \\
        --rates 3 4 5 6 --seconds 30 --seed 11

One JSON line a rate.  The benchmark's own runs never run this.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import json                                              # noqa: E402

import numpy as np                                       # noqa: E402

from torch_bench import harness                          # noqa: E402
from torch_bench.systems import common                   # noqa: E402


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args()
    benchmark = harness.load_benchmark()
    streams = harness.cell_files(benchmark, args.workload).mix["streams"]
    for rate in args.rates:
        line, run = harness.execute(
            args.workload, args.seed, args.seconds, False, "cuda:0",
            time.perf_counter(), benchmark,
            mix_changes={"fps_per_stream": rate / streams})
        latency = run["latency_ms"]
        half = len(latency) // 2
        answered = run["steady_frames"]     # untraced: the whole window
        print(json.dumps({
            "rate": rate, "answered_per_s": answered / run["window_s"],
            "p50_ms": float(np.percentile(latency, 50)),
            "p95_ms": float(np.percentile(latency, 95)),
            "first_half_p50_ms": float(np.median(latency[:half])),
            "second_half_p50_ms": float(np.median(latency[half:])),
            "failed": run["failed"], "correct": line["correct"]}),
            flush=True)
        del run
        common.free("cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
