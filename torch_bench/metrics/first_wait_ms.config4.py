"""A frame's LLM request from its admission to its first token
(``request.first``: the blocks in flight ahead of the one its first
token joins), the mean over the requests finished in the steady
stretch (``readers.steady``; ``torch_bench/spans.py``)."""

from torch_bench import spans


def read(run):
    return spans.request_mean(run, ("request.first",), "request.decode")
