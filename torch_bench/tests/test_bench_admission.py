"""The captured admission's share (``torch_bench/admission.py``): read
from the ``batcher.prefill`` spans of the steady stretch, silent where
they do not say."""

import pytest

from torch_bench import admission


def _run(paused=None):
    return {"window": (100.0, 150.0), "setup_s": 10.0, "paused": paused,
            "trace": None}


@pytest.fixture
def ring(monkeypatch):
    from aiko_services_tpu_torch.observability import recorder
    small = recorder.SpanRecorder(64)
    monkeypatch.setattr(recorder, "process_recorder", lambda: small)
    return small


def test_share_of_the_steady_stretchs_passes(ring):
    for t, graph in ((95.0, False),         # set-up: not counted
                     (101.0, True), (102.0, True), (103.0, True),
                     (104.0, False), (125.0, False)):
        ring.record_at(t, "batcher.prefill", ms=3.0,
                       info={"rows": ((0, 0, 512),), "graph": graph})
    ring.record_at(102.5, "batcher.dispatch", ms=1.0)
    assert admission.graph_share(_run()) == 60.0
    # the stretch ends where the profiler began to start
    assert admission.graph_share(_run(paused=(120.0, 130.0))) == 75.0


def test_silent_where_the_spans_do_not_say(ring, monkeypatch):
    ring.record_at(101.0, "batcher.prefill", ms=3.0,
                   info={"rows": ((0, 0, 512),)})
    assert admission.graph_share(_run()) is None
    from aiko_services_tpu_torch.observability import recorder
    monkeypatch.delattr(recorder, "process_recorder")
    assert admission.graph_share(_run()) is None


@pytest.mark.parametrize("workload", ["mistral7b.chat", "config4.cameras"])
def test_tiny_runs_read_no_replay_on_the_cpu(run_tiny, workload):
    """On the CPU every chunk is eager: the share reads 0."""
    from torch_bench import harness
    name = {"mistral7b.chat": "admission_graph_share.chat",
            "config4.cameras": "admission_graph_share.config4"}[workload]
    _, run = run_tiny(workload, seconds=3.0)
    assert harness.reader(name)(run) == 0.0
