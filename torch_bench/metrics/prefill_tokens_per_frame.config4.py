"""The batcher's ``prefill_tokens`` in the steady stretch
(``readers.steady``), a frame answered in it."""


def read(run):
    counters = run.get("steady_counters", {})
    if not run.get("steady_frames") or "prefill_tokens" not in counters:
        return None
    return counters["prefill_tokens"] / run["steady_frames"]
