"""DataScheme registry + DataSource/DataTarget element bases (reference:
src/aiko_services/main/scheme.py:12-62, source_target.py:30-108).

A DataScheme handles a URL scheme (``file://``, ``tty://``, ``tcp://``...)
for source/target elements: ``create_sources`` turns ``data_sources``
parameters into frames (one-shot or generator), ``create_targets``
prepares writers.
"""

from __future__ import annotations

from typing import Callable

from .element import PipelineElement
from .stream import Stream, StreamEvent
from ..utils import get_logger

__all__ = ["DataScheme", "DataSource", "DataTarget", "contains_all"]

_logger = get_logger("aiko.scheme")


def contains_all(source: str, fragments) -> bool:
    return all(fragment in source for fragment in fragments)


class DataScheme:
    _registry: dict[str, type] = {}

    def __init__(self, element: PipelineElement):
        self.element = element

    @classmethod
    def register(cls, scheme_name: str):
        def decorator(scheme_cls):
            cls._registry[scheme_name] = scheme_cls
            return scheme_cls
        return decorator

    @classmethod
    def lookup(cls, scheme_name: str) -> type | None:
        return cls._registry.get(scheme_name)

    @staticmethod
    def parse_data_url_scheme(data_url: str) -> str:
        if "://" not in data_url:
            return "file"
        return data_url.split("://", 1)[0].lower()

    @staticmethod
    def parse_data_url_path(data_url: str) -> str:
        if "://" not in data_url:
            return data_url
        return data_url.split("://", 1)[1]

    # -- to implement ------------------------------------------------------

    def create_sources(self, stream: Stream, data_sources: list[str],
                       frame_generator: Callable | None = None,
                       rate: float | None = None):
        raise NotImplementedError

    def create_targets(self, stream: Stream, data_targets: list[str]):
        raise NotImplementedError

    def destroy_sources(self, stream: Stream):
        pass

    def destroy_targets(self, stream: Stream):
        pass


class _SchemeBound(PipelineElement):
    PARAMETER: str = ""
    CREATE: str = ""
    DESTROY: str = ""

    def __init__(self, context):
        super().__init__(context)
        self._schemes: dict[str, DataScheme] = {}

    def _resolve(self, stream: Stream) -> tuple[list[str], DataScheme]:
        value, found = self.get_parameter(self.PARAMETER)
        if not found or not value:
            raise ValueError(f"{self.name}: parameter "
                             f"{self.PARAMETER!r} not set")
        urls = value if isinstance(value, list) else [value]
        scheme_name = DataScheme.parse_data_url_scheme(urls[0])
        scheme_cls = DataScheme.lookup(scheme_name)
        if scheme_cls is None:
            raise ValueError(f"{self.name}: no DataScheme for "
                             f"{scheme_name!r}")
        scheme = scheme_cls(self)
        self._schemes[stream.stream_id] = scheme
        return urls, scheme

    def stop_stream(self, stream: Stream, stream_id):
        scheme = self._schemes.pop(stream.stream_id, None)
        if scheme is not None:
            getattr(scheme, self.DESTROY)(stream)
        return StreamEvent.OKAY, {}


class DataSource(_SchemeBound):
    """Element base: resolves ``data_sources`` to a scheme at stream start
    and pumps frames (reference source_target.py:30-72)."""

    PARAMETER = "data_sources"
    DESTROY = "destroy_sources"

    def start_stream(self, stream: Stream, stream_id):
        try:
            urls, scheme = self._resolve(stream)
        except ValueError as error:
            return StreamEvent.ERROR, {"diagnostic": str(error)}
        rate, _ = self.get_parameter("rate", None)
        rate = float(rate) if rate else None
        # Pass a generator only when the subclass provides one; otherwise
        # the scheme supplies its own (e.g. one frame per matched file).
        generator = None
        if type(self).frame_generator is not DataSource.frame_generator:
            generator = self.frame_generator
        return scheme.create_sources(
            stream, urls, frame_generator=generator, rate=rate) \
            or (StreamEvent.OKAY, {})

    def frame_generator(self, stream: Stream):
        """Subclasses may override: produce (StreamEvent, frame_data)."""
        return StreamEvent.STOP, {}

    def process_frame(self, stream: Stream, **inputs):
        # Sources pass data through once frames are created by the scheme.
        return StreamEvent.OKAY, inputs


class DataTarget(_SchemeBound):
    """Element base: resolves ``data_targets`` at stream start (reference
    source_target.py:74-108)."""

    PARAMETER = "data_targets"
    DESTROY = "destroy_targets"

    def start_stream(self, stream: Stream, stream_id):
        try:
            urls, scheme = self._resolve(stream)
        except ValueError as error:
            return StreamEvent.ERROR, {"diagnostic": str(error)}
        return scheme.create_targets(stream, urls) \
            or (StreamEvent.OKAY, {})

    def scheme_for(self, stream: Stream) -> DataScheme | None:
        return self._schemes.get(stream.stream_id)
