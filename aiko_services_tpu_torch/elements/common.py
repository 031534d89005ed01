"""Trivial/test elements (reference: src/aiko_services/elements/media/
elements.py:19-37 Mock/NoOp, and tests/unit/common.py:14-21 Terminate)."""

from __future__ import annotations

import time

from ..pipeline import PipelineElement, StreamEvent
from ..pipeline.tensor import TPUElement

__all__ = ["Mock", "NoOp", "Identity", "Increment", "Terminate",
           "StageWork"]


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


class StageWork(TPUElement):
    """Synthetic placed-stage workload (stage-pipelining benches,
    dryruns, tests): a jitted multiply on the element's (placed) mesh
    plus a host-blocking wait (``busy_ms``) standing in for a stage
    whose wall time is dominated by waiting on its chips.  Synchronous
    by design -- exactly the shape that serializes the classic
    stage-by-stage walk and that per-stage workers
    (pipeline/stages.py) overlap."""

    def __init__(self, context):
        super().__init__(context)
        self._scale = self.jit(lambda x, f: x * f)

    def process_frame(self, stream, x):
        factor, _ = self.get_parameter("factor", 1.0)
        busy_ms, _ = self.get_parameter("busy_ms", 0.0)
        # The engine's stage hop already resharded x onto this stage's
        # submesh; the jitted compute follows the input's placement.
        y = self._scale(x, float(factor))
        if busy_ms:
            time.sleep(float(busy_ms) / 1000.0)
        return StreamEvent.OKAY, {"x": y}
