"""The detector's ``JitCache`` calls (hits + misses) in the steady
stretch (``readers.steady``), a frame answered in it: how well the
micro-batcher groups frames."""


def read(run):
    counters = run.get("steady_counters", {})
    if not run.get("steady_frames") or "det_dispatches" not in counters:
        return None
    return counters["det_dispatches"] / run["steady_frames"]
