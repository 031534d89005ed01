"""The port's device rule: entry points run on ``cuda`` unless the caller
asks for the CPU by name.

There is no silent fallback.  With no card present and no explicit
``device="cpu"``, :func:`resolve_device` raises, so a serving process
that lost its GPU fails loudly instead of decoding on the host.
:func:`local_devices` (the port's ``jax.local_devices()``: this
process's cards) raises the same way.

:func:`devices` is the port's ``jax.devices()``: the GLOBAL pool that
stage placement carves and meshes default to.  Before a multi-host
bring-up (``parallel/distributed.py``) it is :func:`local_devices`;
after one it lists every process's devices in process order, the same
list in every process: this process's as plain ``torch.device``\\ s,
another process's as :class:`RemoteDevice` descriptors, on which no
tensor can be placed.  :func:`process_index` reads the process that
holds any of them.

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

__all__ = ["resolve_device", "local_devices", "devices", "RemoteDevice",
           "process_index", "is_local", "upload", "sync_guard",
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


class RemoteDevice:
    """A device of another process of a multi-host mesh: its process,
    type (``cuda`` or ``cpu``) and index there.  Equal descriptors name
    the same device; no tensor can be placed on one."""

    __slots__ = ("process_index", "type", "index")

    def __init__(self, process_index: int, type: str, index: int | None):
        self.process_index = int(process_index)
        self.type = type
        self.index = index

    def _key(self) -> tuple:
        return (self.process_index, self.type, self.index)

    def __eq__(self, other) -> bool:
        return isinstance(other, RemoteDevice) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(("remote",) + self._key())

    def __repr__(self) -> str:
        index = "" if self.index is None else f":{self.index}"
        return f"RemoteDevice(process {self.process_index}, " \
            f"{self.type}{index})"


#: The bring-up's record: this process's index, the process count and
#: the global pool (None before a bring-up).  Written once, by
#: ``parallel.distributed.ensure``.
_process = {"index": 0, "count": 1, "pool": None}


def devices() -> list:
    """The global device pool (``jax.devices()``): :func:`local_devices`
    before a multi-host bring-up, every process's devices in process
    order after one."""
    pool = _process["pool"]
    return list(pool) if pool is not None else local_devices()


def process_index(device=None) -> int:
    """The process that holds ``device``: a :class:`RemoteDevice`'s own,
    this process's index for a plain ``torch.device`` (and for None)."""
    if isinstance(device, RemoteDevice):
        return device.process_index
    return _process["index"]


def is_local(device) -> bool:
    """True for a device of this process (not a :class:`RemoteDevice`)."""
    return not isinstance(device, RemoteDevice)


def upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without waiting for the card: through
    pinned staging and an asynchronous copy on a CUDA device (a pageable
    upload waits for the card and trips the sync guard).  On the CPU it
    is a copy the caller owns (``host`` may share a numpy buffer)."""
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.clone()


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
