"""The port's device rule: entry points run on ``cuda`` unless the caller
asks for the CPU by name.

There is no silent fallback.  With no card present and no explicit
``device="cpu"``, :func:`resolve_device` raises, so a serving process
that lost its GPU fails loudly instead of decoding on the host.

:func:`sync_guard` and :func:`sync_allowed` hold the process's CUDA
synchronisation guard (``torch.cuda.set_sync_debug_mode``): a guard
makes every call that waits for the card warn or raise, and an
``allowed`` scope lifts it for a planned wait (a counted fetch, a graph
capture).  The mode is process-wide, not per thread, so the guards of
all threads share one state here: the strictest guard entered wins,
and any ``allowed`` scope lifts it for every thread until it exits.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["resolve_device", "sync_guard", "sync_allowed"]

_SYNC_LEVELS = {"warn": 1, "error": 2}
_sync_lock = threading.Lock()
_sync_state = {"guards": [], "allowed": 0}


def resolve_device(device: str | torch.device | None = None) \
        -> torch.device:
    """``None`` means the default card (``cuda``).  A CUDA device is
    returned only when ``torch.cuda.is_available()``; otherwise this
    raises.  ``"cpu"`` is honoured as given (the tests' setting)."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "aiko_services_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch path")
    return resolved


def _apply_sync_mode() -> None:
    state = _sync_state
    level = 0 if state["allowed"] else max(state["guards"], default=0)
    torch.cuda.set_sync_debug_mode(level)


@contextlib.contextmanager
def sync_guard(mode: str):
    """Warn (``"warn"``) or raise (``"error"``) on every CUDA call that
    waits for the card while the scope is open.  Without a card there is
    nothing to wait for and the scope does nothing."""
    if not torch.cuda.is_available():
        yield
        return
    level = _SYNC_LEVELS[mode]
    with _sync_lock:
        _sync_state["guards"].append(level)
        _apply_sync_mode()
    try:
        yield
    finally:
        with _sync_lock:
            _sync_state["guards"].remove(level)
            _apply_sync_mode()


@contextlib.contextmanager
def sync_allowed():
    """Lift every open :func:`sync_guard` for a planned wait."""
    if not torch.cuda.is_available():
        yield
        return
    with _sync_lock:
        _sync_state["allowed"] += 1
        _apply_sync_mode()
    try:
        yield
    finally:
        with _sync_lock:
            _sync_state["allowed"] -= 1
            _apply_sync_mode()
