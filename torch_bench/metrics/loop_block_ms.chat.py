"""The device span of a replayed loop block (first kernel's start to
last kernel's end of one ``cudaGraphLaunch``), the mean over the blocks
whose kernels all lie in the traced slice."""

from torch_bench.readers import block_spans, mean


def read(run):
    trace = run.get("trace")
    if trace is None:
        return None
    return mean([(end - start) / 1e3
                 for start, end, _ in block_spans(trace).values()])
