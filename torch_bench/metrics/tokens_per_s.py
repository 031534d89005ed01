"""Tokens emitted in the window over the window (whole loop blocks)."""


def read(run):
    if "tokens" not in run:
        return None
    return run["tokens"] / run["window_s"]
