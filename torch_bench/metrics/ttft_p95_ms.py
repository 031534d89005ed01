"""The 95th percentile of time to first token, from the client's send,
over every request whose first token came in the window."""

from torch_bench.readers import percentile


def read(run):
    return percentile(run.get("ttft_ms"), 95)
