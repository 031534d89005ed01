"""The port's device rule: entry points run on ``cuda`` unless the caller
asks for the CPU by name.

There is no silent fallback.  With no card present and no explicit
``device="cpu"``, :func:`resolve_device` raises, so a serving process
that lost its GPU fails loudly instead of decoding on the host.
:func:`local_devices` (the port's ``jax.devices()``: the pool stage
placement carves) raises the same way.

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
import os
import threading

import torch

__all__ = ["resolve_device", "local_devices", "sync_guard",
           "sync_allowed"]

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


def local_devices() -> list[torch.device]:
    """Every card of this process, ``[cuda:0 ... cuda:n-1]``.  With no
    card this raises, as :func:`resolve_device` does -- unless the
    environment asks for CPU descriptors by name: ``AIKO_CPU_DEVICES=N``
    gives ``[cpu:0 ... cpu:N-1]`` (the counterpart of the JAX package's
    forced host device count, which the multi-process chaos driver sets
    for the pipelines it spawns)."""
    count = os.environ.get("AIKO_CPU_DEVICES")
    if count:
        return [torch.device("cpu", index) for index in range(int(count))]
    resolve_device("cuda")
    return [torch.device("cuda", index)
            for index in range(torch.cuda.device_count())]


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
