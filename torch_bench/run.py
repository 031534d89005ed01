#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on this machine's card:

    python3 torch_bench/run.py --workload mistral7b.chat --seed 7 \
        --seconds 30 --trace 0

It prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones) and
``device``, and before it, on standard error, each compared number
beside its limit.  It exits non-zero, printing no result, where the
card is missing or a run fails.  See ``torch_bench/harness.py``.
"""

import time

STARTED = time.perf_counter()

import sys                                               # noqa: E402
from pathlib import Path                                 # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch_bench.harness import main                     # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
