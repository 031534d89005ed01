"""Control-flow elements (reference: src/aiko_services/elements/control/
elements.py:20-57)."""

from __future__ import annotations

from ..pipeline import PipelineElementLoop, StreamEvent
from .expression import evaluate_expression

__all__ = ["Loop"]


class Loop(PipelineElementLoop):
    """Re-runs the graph from ``loop_start`` while the ``condition``
    expression holds (evaluated over bare swag names).  Returns OKAY to
    loop again, LOOP_END to fall through."""

    def process_frame(self, stream, **inputs):
        condition, found = self.get_parameter("condition")
        if not found:
            return StreamEvent.LOOP_END, {}
        frame = stream.frames.get(max(stream.frames)) \
            if stream.frames else None
        swag = {k: v for k, v in (frame.swag if frame else inputs).items()
                if "." not in k}
        limit, _ = self.get_parameter("max_iterations", 1000)
        count_key = f"{self.name}.iterations"
        count = stream.variables.get(count_key, 0) + 1
        stream.variables[count_key] = count
        if count >= int(limit):
            return StreamEvent.LOOP_END, {}
        try:
            keep_looping = bool(evaluate_expression(condition, swag))
        except Exception as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"condition {condition!r}: {error}"}
        return (StreamEvent.OKAY if keep_looping
                else StreamEvent.LOOP_END), {}
