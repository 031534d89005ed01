"""Media conversion utilities: images <-> video, run as REAL pipelines
through the engine.

Reference equivalents:
``src/aiko_services/elements/media/images_to_video.py:1-33`` and
``video_to_images.py:1-42`` -- tiny scripts wiring
ImageReadFile -> VideoWriteFile / VideoReadFile -> ImageWriteFile
pipeline definitions.  Here the same conversions are library functions
(and ``python -m aiko_services_tpu_torch media ...`` commands, cli.py) built
on this framework's element library and file scheme.
"""

from __future__ import annotations

import queue

__all__ = ["images_to_video", "video_to_images"]

_ELEMENTS = "aiko_services_tpu_torch.elements"


def _run_conversion(definition: dict, runtime=None,
                    timeout: float = 600.0) -> int:
    """Run a conversion pipeline to stream completion; returns the
    number of frames processed, raises on any frame error."""
    from .pipeline import Pipeline
    from .runtime import init_process

    own_runtime = runtime is None
    if own_runtime:
        runtime = init_process(transport="loopback")
        runtime.initialize()
    pipeline = Pipeline(definition, runtime=runtime)
    responses: queue.Queue = queue.Queue()
    pipeline.create_stream_local("convert", queue_response=responses)
    done = {"frames": 0, "errors": []}

    def finished():
        while not responses.empty():
            *_, okay, diagnostic = responses.get()
            done["frames"] += 1
            if not okay:
                done["errors"].append(diagnostic)
        # The file scheme's generator STOPs the stream at the last
        # frame; the engine then destroys it.
        return "convert" not in pipeline.streams and responses.empty()

    runtime.run(until=finished, timeout=timeout)
    if own_runtime:
        runtime.terminate()
    if done["errors"]:
        raise RuntimeError(
            f"conversion failed: {done['errors'][0]}")
    if "convert" in pipeline.streams:
        raise RuntimeError("conversion timed out")
    return done["frames"]


def images_to_video(pattern: str, output: str, rate: float = 29.97,
                    codec: str = "MJPG", runtime=None) -> int:
    """Encode the images matching ``pattern`` (a glob, or a ``{}``
    template like the reference's ``image_{:06d}.jpg``) into the video
    file ``output``; returns the number of frames written."""
    definition = {
        "version": 0, "name": "images_to_video", "runtime": "torch",
        "graph": ["(Read Write)"], "parameters": {},
        "elements": [
            {"name": "Read",
             "input": [{"name": "path"}],
             "output": [{"name": "image"}],
             "parameters": {"data_sources": f"file://{pattern}"},
             "deploy": {"local": {"module": _ELEMENTS,
                                  "class_name": "ImageReadFile"}}},
            {"name": "Write",
             "input": [{"name": "image"}],
             "output": [{"name": "path"}],
             "parameters": {"data_targets": f"file://{output}",
                            "rate": float(rate), "codec": str(codec)},
             "deploy": {"local": {"module": _ELEMENTS,
                                  "class_name": "VideoWriteFile"}}},
        ]}
    return _run_conversion(definition, runtime)


def video_to_images(video: str, pattern: str, runtime=None) -> int:
    """Decode the video file ``video`` into per-frame images at
    ``pattern`` (a ``{}`` template, e.g. ``out/frame_{}.png``); returns
    the number of frames written."""
    definition = {
        "version": 0, "name": "video_to_images", "runtime": "torch",
        "graph": ["(Read Write)"], "parameters": {},
        "elements": [
            {"name": "Read",
             "input": [{"name": "image"}],
             "output": [{"name": "image"}],
             "parameters": {"data_sources": f"file://{video}"},
             "deploy": {"local": {"module": _ELEMENTS,
                                  "class_name": "VideoReadFile"}}},
            {"name": "Write",
             "input": [{"name": "image"}],
             "output": [{"name": "path"}],
             "parameters": {"data_targets": f"file://{pattern}"},
             "deploy": {"local": {"module": _ELEMENTS,
                                  "class_name": "ImageWriteFile"}}},
        ]}
    return _run_conversion(definition, runtime)
