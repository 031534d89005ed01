"""The readers see every admission path and leave out a traced run's
profiler stall: the batched admission pass is taped, an admission the
taps do not see fails the run, a prefill kernel launch that no taped
chunk explains fails its roofline, and the steady readings stop where
the profiler began to start."""

import json
import time
import types
from pathlib import Path

import pytest

from torch_bench import readers, taps
from torch_bench.models import llama as llama_ref
from torch_bench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
SIZES = llama_ref.Sizes.of(json.loads(
    (ROOT / "torch_bench/configs/mistral-7b-v0.3.json").read_text()))


def run_chat(tiny_bench, **serving):
    import torch
    from torch_bench import harness
    torch.set_num_threads(4)
    mix = json.loads((tiny_bench.mixes / "chat.json").read_text())
    return harness.execute(
        "mistral7b.chat", 2 ** 31 + 7, 2.0, False, "cpu",
        time.perf_counter(), tiny_bench.benchmark, mixes=tiny_bench.mixes,
        mix_changes={"serving": {**mix["serving"], **serving}})


def test_the_batched_admission_pass_is_taped(tiny_bench):
    line, run = run_chat(tiny_bench, attention="dense")
    spans = [tuple(chunk[:2]) for chunk in run["tape"].chunks]
    assert len(spans) > len(set(spans)), "no batched pass ran"
    assert run["tape"].unmatched == 0 and line["correct"] is True


def test_an_admission_the_taps_do_not_see_fails_the_run(tiny_bench):
    from aiko_services_tpu_torch.models import batching, llama
    unseen = types.SimpleNamespace(**vars(llama))   # calls bypass the taps
    batching.llama = unseen
    try:
        with pytest.raises(RuntimeError, match="taps:"):
            run_chat(tiny_bench)
    finally:
        batching.llama = llama


def test_the_tape_is_held_to_the_batchers_count():
    tape = taps.Tape(prefilled=100)
    taps.check_admissions(tape, 100)
    with pytest.raises(RuntimeError):
        taps.check_admissions(tape, 164)
    tape.unmatched = 1
    with pytest.raises(RuntimeError):
        taps.check_admissions(tape, 100)


def prefill_run(chunks):
    trace = Trace(begin_us=0.0, end_us=1e6, perf_offset_us=0.0,
                  device=[("flash_attention_kernel", 10.0, 50.0, 7,
                           "kernel")],
                  runtime=[("cudaLaunchKernel", 5.0, 1.0, 7)])
    return {"trace": trace, "sizes": SIZES, "family": llama_ref,
            "tape": taps.Tape(chunks=chunks)}


def test_a_prefill_launch_no_chunk_explains_fails_its_roofline():
    from torch_bench import harness
    read = harness.reader("flash_attention_roofline.config4")
    assert read(prefill_run([[0.0, 1e-3, 0, 512]])) > 0
    with pytest.raises(RuntimeError, match="no taped admission chunk"):
        read(prefill_run([[1.0, 2.0, 0, 512]]))


def test_one_batched_launch_counts_every_row():
    from torch_bench import harness
    read = harness.reader("flash_attention_roofline.config4")
    one = read(prefill_run([[0.0, 1e-3, 0, 512]]))
    two = read(prefill_run([[0.0, 1e-3, 0, 512], [0.0, 1e-3, 512, 512]]))
    assert two > 2 * one


def test_the_steady_readings_stop_where_the_profiler_began():
    from torch_bench import harness
    run = {"window": (10.0, 60.0), "paused": (35.0, 55.0),
           "engine_gap_ms": [(20.0, 50.0), (34.0, 70.0), (40.0, 3000.0)]}
    inside, seconds = readers.steady(run)
    assert seconds == 25.0 and inside(35.0) and not inside(35.5)
    assert harness.reader("engine_gap_ms.config4")(run) == 60.0
    run["paused"] = None
    assert readers.steady(run)[1] == 50.0
    assert harness.reader("engine_gap_ms.config4")(run) == 1040.0
