"""The benchmark's tests: on the CPU, at a tiny size.

``tiny_bench`` writes a copy of ``BENCHMARK.json`` whose configurations
keep their files' keys, limits and systems but shrink every size to a
2-layer, 64-wide model (and an 8-wide detector on 64x64 frames), and
whose mixes keep their kinds at a handful of clients and streams.
"""

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TINY_MODEL = {"hidden_size": 64, "intermediate_size": 128,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "vocab_size": 512,
              "max_position_embeddings": 256}


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    out = tmp_path_factory.mktemp("tiny_bench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        config.update(TINY_MODEL)
        if "serving" in config:
            config["serving"]["prefill_chunk"] = 64
        if "detector" in config:
            config["rope_theta"] = 10000.0     # the element's tiny base
            config["detector"].update({"width": 8, "image_size": 64})
            config["pipeline"]["detector"]["width"] = 8
            config["pipeline"]["llm"].update(
                {"model": "tiny", "vocab_size": 512, "max_seq": 256,
                 "max_slots": 4, "max_new_tokens": 8,
                 "system_prompt": "Say: "})
        path = out / f"{entry['name']}.json"
        path.write_text(json.dumps(config))
        entry["file"] = str(path)
    (out / "mixes").mkdir()
    for mix_path in (ROOT / "torch_bench" / "mixes").glob("*.json"):
        mix = json.loads(mix_path.read_text())
        if mix["kind"] == "closed_loop_requests":
            mix.update({"clients": 4, "pool": 64, "ramp_s": 0.5,
                        "prompt_tokens": {"lognormal_median": 40,
                                          "sigma": 0.8, "min": 8,
                                          "max": 120},
                        "output_tokens": {"uniform_min": 8,
                                          "uniform_max": 40}})
            mix["serving"]["max_slots"] = 4
        else:
            mix.update({"streams": 2, "pool": 4, "ramp_s": 0.5,
                        "fps_per_stream": 4.0, "drain_s": 20.0,
                        "frame": {"height": 64, "width": 64,
                                  "channels": 3, "dtype": "uint8"},
                        "judge": {"frames": 3}})
        (out / "mixes" / mix_path.name).write_text(json.dumps(mix))
    return SimpleNamespace(benchmark=bench, mixes=out / "mixes")


@pytest.fixture
def run_tiny(tiny_bench):
    """run_tiny(workload, seconds=2.0, trace=False) -> (line, run)."""
    import torch
    from torch_bench import harness
    torch.set_num_threads(4)

    def run(workload, seconds=2.0, trace=False, seed=2 ** 31 + 5,
            keep_inputs=False):
        return harness.execute(workload, seed, seconds, trace, "cpu",
                               time.perf_counter(), tiny_bench.benchmark,
                               keep_inputs=keep_inputs,
                               mixes=tiny_bench.mixes)
    return run
