"""The 95th percentile of a frame's latency, from ``create_frame_local``
to its answer, over every frame answered in the window."""

from torch_bench.readers import percentile


def read(run):
    return percentile(run.get("latency_ms"), 95)
