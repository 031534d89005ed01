"""Occupied batcher slots as each ``step()`` of the steady stretch
starts (``readers.steady``), the mean over the steps."""

from torch_bench.readers import mean, steady


def read(run):
    inside, _ = steady(run)
    return mean([active for t, active in run["tape"].steps if inside(t)])
