"""The traced slice's share in which no device operation ran while a
``batcher.prefill`` span was open (``spans.idle_prefill``, which also
prints the slice's idle time split by span on standard error)."""

from torch_bench import spans

read = spans.idle_prefill
