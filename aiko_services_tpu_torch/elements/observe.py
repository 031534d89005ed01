"""Observability elements (reference: src/aiko_services/elements/observe/
elements.py): Inspect dumps selected swag values; Metrics reports
per-element times from frame.metrics."""

from __future__ import annotations

from ..pipeline import PipelineElement, StreamEvent

__all__ = ["Inspect", "Metrics"]


class Inspect(PipelineElement):
    """Dumps chosen swag values to log/print/file per the ``inspect``
    parameter (reference observe/elements.py:21-86)."""

    def process_frame(self, stream, **inputs):
        names, _ = self.get_parameter("inspect", "*")
        target, _ = self.get_parameter("target", "log")
        frame = stream.frames.get(max(stream.frames)) \
            if stream.frames else None
        swag = frame.swag if frame else dict(inputs)
        if names == "*":
            selected = {k: v for k, v in swag.items() if "." not in k}
        else:
            wanted = names if isinstance(names, list) else \
                str(names).split(",")
            selected = {name: swag.get(name) for name in wanted}
        line = f"inspect {self.name}: {selected}"
        if target == "print":
            print(line)
        elif str(target).startswith("file:"):
            with open(str(target)[5:], "a") as fh:
                fh.write(line + "\n")
        else:
            self.logger.info("%s", line)
        return StreamEvent.OKAY, {}


class Metrics(PipelineElement):
    """Tail element reporting per-element wall time in ms (reference
    observe/elements.py:85-126)."""

    def process_frame(self, stream, **inputs):
        frame = stream.frames.get(max(stream.frames)) \
            if stream.frames else None
        if frame is None:
            return StreamEvent.OKAY, {}
        rate, _ = self.get_parameter("metrics_rate", 1)
        count = stream.variables.setdefault(f"{self.name}.count", 0)
        stream.variables[f"{self.name}.count"] = count + 1
        if count % int(rate):
            return StreamEvent.OKAY, {}
        times = {name[:-5]: f"{value * 1000:.2f} ms"
                 for name, value in frame.metrics.items()
                 if name.endswith("_time")}
        self.logger.info("metrics frame %s: %s", frame.frame_id, times)
        return StreamEvent.OKAY, {"metrics": dict(frame.metrics)}
