"""A request from its slot to its last admission chunk written
(``request.admission``), the mean over the requests whose first token
came in the steady stretch (``readers.steady``;
``torch_bench/spans.py``)."""

from torch_bench import spans


def read(run):
    return spans.request_mean(run, ("request.admission",), "request.first")
