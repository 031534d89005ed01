"""A frame's LLM request before its slot: the LLM worker's inbox
(``llm.inbox``: the frame's put to the batcher's submit, the
tokenizing included) and the batcher's queue (``request.queue``: submit
to slot), the mean over the requests finished in the steady stretch
(``readers.steady``; the program's spans, ``torch_bench/spans.py``)."""

from torch_bench import spans


def read(run):
    return spans.request_mean(run, ("llm.inbox", "request.queue"),
                              "request.decode")
