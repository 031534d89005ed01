"""Local method-call tracing: wrap every public method of an object
with an enter/exit interceptor.

Reference equivalent: ``src/aiko_services/main/proxy.py:36-75``
(``ProxyAllMethods`` + ``proxy_trace``, built on the wrapt package).
Here it is a plain delegation proxy -- no dependency -- and the default
interceptor logs through the framework logger (so traced calls land on
the log fabric like everything else) with per-call wall time.  For
PIPELINE tracing prefer the hook system (``runtime/hooks.py`` +
``--hooks`` on the CLI) and the profiler spans (``tpu/profiling.py``);
this utility covers the reference's remaining use: tracing an arbitrary
object's method calls during diagnosis.

Usage::

    actor = trace_methods(MyActor(...))          # logs enter/exit
    actor.do_something(1, x=2)                   # runs + logs

    calls = []
    actor = trace_methods(MyActor(...), interceptor=record_calls(calls))
"""

from __future__ import annotations

import time
from typing import Any, Callable

from .logger import get_logger

__all__ = ["MethodTrace", "trace_methods", "log_trace", "record_calls"]

_logger = get_logger("aiko.trace")


def log_trace(name: str, method_name: str, method: Callable,
              args: tuple, kwargs: dict):
    """Default interceptor: DEBUG-log enter/exit (with wall time and
    errors) around the call."""
    _logger.debug("enter %s.%s args=%r kwargs=%r", name, method_name,
                  args, kwargs)
    start = time.perf_counter()
    try:
        result = method(*args, **kwargs)
    except Exception as error:
        _logger.debug("error %s.%s after %.3f ms: %r", name, method_name,
                      (time.perf_counter() - start) * 1000, error)
        raise
    _logger.debug("exit  %s.%s in %.3f ms", name, method_name,
                  (time.perf_counter() - start) * 1000)
    return result


def record_calls(into: list) -> Callable:
    """Interceptor factory: append ``(method_name, args, kwargs,
    result)`` tuples to ``into`` (tests, flight recording)."""
    def interceptor(name, method_name, method, args, kwargs):
        result = method(*args, **kwargs)
        into.append((method_name, args, kwargs, result))
        return result
    return interceptor


class MethodTrace:
    """Delegation proxy wrapping the target's public callables.

    Attribute reads resolve on the TARGET (state stays shared, unlike a
    copy); callable public attributes come back wrapped so every
    invocation routes through ``interceptor(name, method_name, method,
    args, kwargs)``, which decides how (and whether) to call through.
    Methods are looked up per access, so monkeypatched or dynamically
    added methods trace too.
    """

    def __init__(self, target: Any, name: str | None = None,
                 interceptor: Callable = log_trace,
                 ignore_prefix: str = "_"):
        # Avoid __setattr__ recursion: write through object.
        object.__setattr__(self, "_trace_target", target)
        object.__setattr__(self, "_trace_name",
                           name or type(target).__name__)
        object.__setattr__(self, "_trace_interceptor", interceptor)
        object.__setattr__(self, "_trace_ignore", ignore_prefix)

    def __getattr__(self, attribute: str):
        target = object.__getattribute__(self, "_trace_target")
        value = getattr(target, attribute)
        ignore = object.__getattribute__(self, "_trace_ignore")
        if not callable(value) or (ignore and attribute.startswith(ignore)):
            return value
        name = object.__getattribute__(self, "_trace_name")
        interceptor = object.__getattribute__(self, "_trace_interceptor")

        def traced(*args, **kwargs):
            return interceptor(name, attribute, value, args, kwargs)
        traced.__name__ = attribute
        return traced

    def __setattr__(self, attribute: str, value):
        setattr(object.__getattribute__(self, "_trace_target"),
                attribute, value)

    def __repr__(self):
        return (f"MethodTrace({object.__getattribute__(self, '_trace_name')}"
                f" -> {object.__getattribute__(self, '_trace_target')!r})")


def trace_methods(target: Any, name: str | None = None,
                  interceptor: Callable = log_trace,
                  ignore_prefix: str = "_") -> MethodTrace:
    """Wrap ``target`` so every public method call is intercepted (see
    :class:`MethodTrace`)."""
    return MethodTrace(target, name=name, interceptor=interceptor,
                       ignore_prefix=ignore_prefix)
