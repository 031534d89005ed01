"""Trivial/test elements (reference: src/aiko_services/elements/media/
elements.py:19-37 Mock/NoOp, and tests/unit/common.py:14-21 Terminate)."""

from __future__ import annotations

from ..pipeline import PipelineElement, StreamEvent

__all__ = ["Mock", "NoOp", "Identity", "Increment", "Terminate"]


class Mock(PipelineElement):
    """Passes inputs straight through as outputs."""

    def process_frame(self, stream, **inputs):
        return StreamEvent.OKAY, dict(inputs)


class NoOp(PipelineElement):
    def process_frame(self, stream, **inputs):
        return StreamEvent.OKAY, {}


class Identity(Mock):
    pass


class Increment(PipelineElement):
    """x -> x + 1 (the multitude benchmark's per-stage work)."""

    def process_frame(self, stream, x):
        return StreamEvent.OKAY, {"x": int(x) + 1}


class Terminate(PipelineElement):
    """Ends the hosting process's event loop -- lets offline tests drive
    the genuine runtime and stop from inside the graph."""

    def process_frame(self, stream, **inputs):
        self.pipeline.runtime.engine.terminate()
        return StreamEvent.OKAY, {}

