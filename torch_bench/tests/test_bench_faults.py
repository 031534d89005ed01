"""The comparison that decides ``correct``, held to a control and to
faults planted in the timed path, at a tiny size on the CPU (the card
runs ``torch_bench/control.py`` at each cell's own size).

- the control (the plain reference at float8 in the program's place)
  reads well above the program on the same prompts, tokens and frames;
- a run whose path is broken underneath comes out not correct: a token
  altered where it is emitted, the cache never written (each step
  leaves the model's state unchanged), a detection altered where the
  detector's slate becomes detections.
"""

import contextlib

import pytest

from torch_bench import control


def test_the_control_reads_above_the_program(run_tiny):
    line, run = run_tiny("mistral7b.chat", keep_inputs=True)
    program = {name: check["value"] for name, check in line["checks"].items()}
    lower = control.control_readings(run, run["family"])
    assert lower["greedy_gap"] >= 3 * program["greedy_gap"] > 0
    assert lower["topk_gap"] > program["topk_gap"]
    line, run = run_tiny("config4.cameras", keep_inputs=True)
    program = {name: check["value"] for name, check in line["checks"].items()}
    lower = control.control_readings(run, run["family"])
    assert lower["det_err"] >= 3 * program["det_err"] > 0
    assert any(lower[name] > line["checks"][name]["limit"]
               for name in lower)


@contextlib.contextmanager
def altered_tokens():
    from aiko_services_tpu_torch.models.batching import ContinuousBatcher
    emit = ContinuousBatcher._emit

    def altered(self, request, token):
        token = (int(token) + 1) % self.config.vocab_size
        return emit(self, request, token)
    ContinuousBatcher._emit = altered
    try:
        yield
    finally:
        ContinuousBatcher._emit = emit


@contextlib.contextmanager
def unchanged_cache():
    from aiko_services_tpu_torch.models import llama
    write = llama._kv_write
    llama._kv_write = lambda leaf, new, where: None
    try:
        yield
    finally:
        llama._kv_write = write


@contextlib.contextmanager
def altered_detections():
    from aiko_services_tpu_torch.elements.detect import Detector
    slate = Detector._slate_outputs

    def altered(self, fetched, row=0):
        out = slate(self, fetched, row)
        if out["detections"]:
            out["detections"][0]["score"] += 0.05
        return out
    Detector._slate_outputs = altered
    try:
        yield
    finally:
        Detector._slate_outputs = slate


@pytest.mark.parametrize("workload,fault", [
    ("mistral7b.chat", altered_tokens),
    ("mistral7b.chat", unchanged_cache),
    ("config4.cameras", altered_tokens),
    ("config4.cameras", altered_detections),
], ids=["chat-token", "chat-state", "cameras-token", "cameras-detection"])
def test_a_broken_path_comes_out_not_correct(run_tiny, workload, fault):
    with fault():
        line, _ = run_tiny(workload)
    assert line["correct"] is False, line["checks"]
