"""Named instrumentation hooks (reference: src/aiko_services/main/
hook.py:64-195).

A hook is a named, versioned point (``"actor.message_in:0"``) carrying a
list of handlers, an enable flag and an invocation counter.  ``run_hook``
takes a *lazily evaluated* closure producing the variables dict, so a
disabled hook costs one dict lookup and a boolean test -- nothing is
computed unless a handler is attached.  The TPU build also routes
``jax.profiler`` trace annotations through hooks: see
:mod:`aiko_services_tpu_torch.tpu.profiling` (``Profiler.attach`` registers on
``pipeline.process_element:0`` / ``pipeline.process_element_post:0``)."""

from __future__ import annotations

from typing import Callable

from ..utils import get_logger

__all__ = ["Hook", "Hooks", "default_hook_handler"]

_logger = get_logger("aiko.hook")


class Hook:
    __slots__ = ("name", "handlers", "enabled", "count")

    def __init__(self, name: str):
        self.name = name                  # "component.hook_name:version"
        self.handlers: list[Callable] = []
        self.enabled = True
        self.count = 0


class Hooks:
    """Mixin providing the hook registry for services/pipelines."""

    def __init__(self):
        self._hooks: dict[str, Hook] = {}

    def add_hook(self, hook_name: str) -> Hook:
        hook = self._hooks.get(hook_name)
        if hook is None:
            hook = Hook(hook_name)
            self._hooks[hook_name] = hook
        return hook

    def remove_hook(self, hook_name: str):
        self._hooks.pop(hook_name, None)

    def get_hooks(self) -> list[str]:
        return list(self._hooks)

    def add_hook_handler(self, hook_name: str, handler: Callable):
        self.add_hook(hook_name).handlers.append(handler)

    def remove_hook_handler(self, hook_name: str, handler: Callable):
        hook = self._hooks.get(hook_name)
        if hook and handler in hook.handlers:
            hook.handlers.remove(handler)

    def enable_hook(self, hook_name: str, enabled: bool = True):
        hook = self._hooks.get(hook_name)
        if hook:
            hook.enabled = enabled

    def run_hook(self, hook_name: str,
                 variables_fn: Callable[[], dict] | None = None):
        hook = self._hooks.get(hook_name)
        if hook is None or not hook.enabled or not hook.handlers:
            return
        hook.count += 1
        variables = variables_fn() if variables_fn else {}
        for handler in hook.handlers:
            try:
                handler(self, hook, variables)
            except Exception:
                _logger.exception("hook %s handler failed", hook_name)


def default_hook_handler(component, hook: Hook, variables: dict):
    name = getattr(component, "name", type(component).__name__)
    _logger.info("HOOK %s #%d %s: %s",
                 hook.name, hook.count, name,
                 {k: _brief(v) for k, v in variables.items()})


def _brief(value, limit: int = 96):
    text = repr(value)
    return text if len(text) <= limit else text[:limit] + "..."
