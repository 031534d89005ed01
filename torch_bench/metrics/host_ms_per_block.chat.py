"""The batcher's host work a retired block: the milliseconds of its
``batcher.prefill``, ``batcher.dispatch`` and ``batcher.emit`` spans
that ended in the steady stretch (``readers.steady``), over the blocks
retired in it (``spans.host_ms_per_block``)."""

from torch_bench import spans

read = spans.host_ms_per_block
