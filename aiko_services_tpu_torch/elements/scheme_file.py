"""``file://`` DataScheme (reference: src/aiko_services/elements/media/
scheme_file.py:25-107): glob templating with ``{}``, batch frame
generation, single-file fast path."""

from __future__ import annotations

import glob
import os

from ..pipeline import DataScheme, StreamEvent
from ..pipeline.stream import Stream

__all__ = ["DataSchemeFile"]


@DataScheme.register("file")
class DataSchemeFile(DataScheme):
    def create_sources(self, stream: Stream, data_sources,
                       frame_generator=None, rate=None):
        paths: list[str] = []
        for url in data_sources:
            path = DataScheme.parse_data_url_path(url)
            if "{}" in path or "*" in path:
                pattern = path.replace("{}", "*")
                paths.extend(sorted(glob.glob(pattern)))
            else:
                paths.append(path)
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            return StreamEvent.ERROR, {
                "diagnostic": f"missing files: {missing}"}
        stream.variables["source_paths"] = paths
        stream.variables["source_index"] = 0

        if len(paths) == 1 and frame_generator is None:
            self.element.create_frame(stream, {"path": paths[0]})
            return StreamEvent.OKAY, {}

        def path_generator(stream_):
            index = stream_.variables["source_index"]
            if index >= len(stream_.variables["source_paths"]):
                return StreamEvent.STOP, {}
            stream_.variables["source_index"] = index + 1
            return (StreamEvent.OKAY,
                    {"path": stream_.variables["source_paths"][index]})

        generator = frame_generator or path_generator
        self.element.create_frames(stream, generator, rate=rate)
        return StreamEvent.OKAY, {}

    def create_targets(self, stream: Stream, data_targets):
        path = DataScheme.parse_data_url_path(data_targets[0])
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        stream.variables["target_path"] = path
        stream.variables["target_index"] = 0
        return StreamEvent.OKAY, {}

    def target_path(self, stream: Stream) -> str:
        """Next output path; ``{}`` templates get the frame index."""
        path = stream.variables["target_path"]
        if "{}" in path:
            index = stream.variables["target_index"]
            stream.variables["target_index"] = index + 1
            return path.replace("{}", str(index))
        return path
