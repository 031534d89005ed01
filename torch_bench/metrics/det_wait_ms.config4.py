"""A frame's wait in the detector's micro-batcher, from its submit to
the start of its group's batched run (``microbatch.wait``), the mean
over the waits that ended in the steady stretch (``readers.steady``;
``torch_bench/spans.py``)."""

from torch_bench import spans


def read(run):
    return spans.span_mean(run, "microbatch.wait")
