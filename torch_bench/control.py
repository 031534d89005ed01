#!/usr/bin/env python3
"""The readings that set each compared number's limit, on the card, at
the cell's own size: for every seed, one run of the cell (a short
window at the cell's own load), the numbers the run compares (the
program's readings), and the same numbers for the CONTROL -- the plain
reference put in the program's place at the nearest precision below
the configuration's bf16: every product's operands rounded to float8
e4m3 (``fp8``), read on the same prompts, tokens and frames:

- served tokens: the gap, under the float32 reference, of the token the
  control puts first (greedy) or of the worst token in the control's
  top k (sampled);
- detections: the control's slate judged as the program's is.

    python3 torch_bench/control.py --workload mistral7b.chat \
        --seeds 101 102 103 --control-seeds 101 102 103 --seconds 10

One JSON line a seed.  The benchmark's own runs never run this.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import json                                              # noqa: E402

from torch_bench import harness                          # noqa: E402
from torch_bench.models import detector as det_ref       # noqa: E402
from torch_bench.systems import common, pipeline         # noqa: E402


def control_readings(run: dict, family) -> dict:
    """The control's reading of each number the run compares."""
    inputs = run["control_inputs"]
    common.reference_precision()
    if "detector" not in run:
        weights, sizes, requests, n_greedy, k = inputs
        reference = family.served_logits(weights, sizes, requests)
        lower = family.served_logits(weights, sizes, requests, fp8=True)
        greedy = [family.control_greedy_gap(r, c)
                  for r, c in zip(reference[:n_greedy], lower[:n_greedy])]
        sampled = [family.control_topk_gap(r, c, k)
                   for r, c in zip(reference[n_greedy:], lower[n_greedy:])]
        return {"greedy_gap": max(greedy or [0.0]),
                "topk_gap": max(sampled or [0.0])}
    trees, sizes, requests, det, images = inputs
    reference = family.served_logits(trees["llama"], sizes, requests)
    lower = family.served_logits(trees["llama"], sizes, requests, fp8=True)
    out = {"greedy_gap": max([family.control_greedy_gap(r, c)
                              for r, c in zip(reference, lower)] or [0.0])}
    import torch
    batch = torch.from_numpy(images).to(
        trees["detector"]["stem"]["w"].device).float() / 255.0
    exact = det_ref.slate(trees["detector"], det, batch)
    rounded = det_ref.slate(trees["detector"], det, batch, fp8=True)
    for (boxes, _, kept), ref in zip(rounded, exact):
        served = [{"class": pipeline.COCO_CLASSES[cls], "score": score,
                   "box": boxes[index].tolist()}
                  for index, cls, score in kept]
        for name, value in det_ref.judge(det, ref, served,
                                         pipeline.COCO_CLASSES).items():
            out[name] = max(out.get(name, 0.0), value)
    return out


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--dump", default=None,
                        help="a directory for each run's frame timeline "
                             "and admission chunks (JSON)")
    args = parser.parse_args()
    benchmark = harness.load_benchmark()
    for seed in args.seeds:
        started = time.perf_counter()
        line, run = harness.execute(args.workload, seed, args.seconds,
                                    False, "cuda:0", started, benchmark,
                                    keep_inputs=True)
        record = {"seed": seed, "correct": line["correct"],
                  "program": {n: c["value"]
                              for n, c in line["checks"].items()},
                  "judged": line["judged"], "metrics": line["metrics"]}
        if seed in args.control_seeds:
            begin = time.perf_counter()
            record["control"] = control_readings(run, run["family"])
            record["control_s"] = time.perf_counter() - begin
        record["seconds"] = time.perf_counter() - started
        if args.dump:
            with open(Path(args.dump) / f"{seed}.json", "w") as stream:
                json.dump({"timeline": run.get("timeline"),
                           "chunks": run["tape"].chunks,
                           "retires": run["tape"].retires,
                           "window": run["window"]}, stream)
        del run
        common.free("cuda:0")
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
