"""How the program wrote its admission chunks, read from its spans
(``torch_bench/spans.py``): each ``batcher.prefill`` span's ``info``
says whether the pass replayed a captured chunk (``graph``)."""

from __future__ import annotations

from . import readers, spans


def graph_share(run: dict):
    """The share, in %, of the ``batcher.prefill`` spans that ended in
    the steady stretch (``readers.steady``) whose pass replayed a
    captured chunk.  None where the program keeps no ring, or its spans
    do not say (a program from before the captured admission), or no
    pass ended in the stretch."""
    found = spans.events(run)
    if found is None:
        return None
    inside, _ = readers.steady(run)
    said = [info["graph"] for t, etype, _, _, _, _, info in found
            if etype == "batcher.prefill" and inside(t)
            and isinstance(info, dict) and "graph" in info]
    return 100.0 * sum(map(bool, said)) / len(said) if said else None
