"""The pipeline engine's own share of a frame: its latency minus the
elements' ``DET_time``, ``CAP_time`` and ``LLM_time`` stamps, the mean
over the frames due in the window and answered in its steady stretch
(``readers.steady``: a traced run's profiler start stalls the engine,
and the queue it leaves would read as the engine's)."""

from torch_bench.readers import mean, steady


def read(run):
    inside, _ = steady(run)
    return mean([gap for answered, gap in run.get("engine_gap_ms", [])
                 if inside(answered)])
