"""A frame's LLM request from its first token to its finish
(``request.decode``), the mean over the requests finished in the
steady stretch (``readers.steady``; ``torch_bench/spans.py``)."""

from torch_bench import spans


def read(run):
    return spans.request_mean(run, ("request.decode",), "request.decode")
