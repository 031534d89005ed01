"""Overlapped frame execution on the card: device-resident swag
accounting and the bounded per-stream dispatch window.

Counterpart of ``aiko_services_tpu/pipeline/overlap.py``.  Two small
engine-side mechanisms:

- :class:`TransferLedger` enforces and accounts the **device-resident
  swag contract**: between consecutive device elements swag values stay
  ``torch.Tensor``\\ s on the card; the host only sees them at a sink
  (wire response, process boundary) or at an input explicitly declared
  host-typed.  Device elements run under the CUDA synchronisation guard
  (``torch.cuda.set_sync_debug_mode``) with the configured policy
  (pipeline parameter ``transfer_guard``: ``allow`` | ``log`` (warn) |
  ``disallow`` (raise)), every engine-initiated fetch is ONE counted
  call for the whole tree, and a software residency check catches
  declared-``tensor`` outputs that come back as host arrays -- on the
  CPU (``device: cpu``) nothing waits for a card and the guard never
  fires, but the residency check does, which is what lets tier-1 tests
  fail fast on host-sync regressions without a card.

  The guard is PROCESS-WIDE (``device.sync_guard``): CUDA's sync debug
  mode has no per-thread setting.  While one thread runs under it,
  a wait on the card from any other thread warns or raises too, unless
  it goes through :meth:`TransferLedger.fetch` (or another
  ``device.sync_allowed`` scope), which lifts the guard for every
  thread while it waits.

- :class:`DeviceWindow` bounds how far dispatch runs ahead of compute:
  elements return tensors whose kernels may still be running and
  frames complete without a host sync, so a fast source could otherwise
  enqueue unbounded device work.  Each completed frame's device leaves
  are noted with a CUDA event recorded behind them; ingesting a new
  frame paces the window by synchronising the OLDEST noted frame's
  event until at most ``device_inflight`` frames (default triple
  buffering) are outstanding.  CPU tensors are complete when returned,
  so their frames pace without waiting.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

import numpy as np
import torch

from ..device import sync_allowed, sync_guard

__all__ = ["TransferLedger", "DeviceWindow", "device_leaves",
           "touches_devices", "DEVICE_INFLIGHT_DEFAULT"]

TRANSFER_POLICIES = ("allow", "log", "disallow")
_SYNC_MODES = {"log": "warn", "disallow": "error"}

# Default bounded async-dispatch window per stream (triple buffering);
# override with the ``device_inflight`` pipeline/stream parameter
# (0 disables pacing).
DEVICE_INFLIGHT_DEFAULT = 3


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    else:
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, value) for value in tree]
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, value) for value in tree)
    return fn(tree)


def device_leaves(tree) -> list:
    """Every ``torch.Tensor`` leaf of a swag tree (dicts, lists and
    tuples; host values skipped)."""
    return [leaf for leaf in _leaves(tree)
            if isinstance(leaf, torch.Tensor)]


def touches_devices(tree, devices: set) -> bool:
    """True when any tensor leaf of ``tree`` lives on one of
    ``devices`` (``torch.device``\\ s) -- the replay path's test for
    swag values stranded on a lost card.  A leaf whose device cannot be
    read counts as touching."""
    for leaf in device_leaves(tree):
        try:
            if leaf.device in devices:
                return True
        except Exception:
            return True
    return False


def _to_host(leaf):
    """A tensor leaf as a host value: a numpy array where numpy holds
    its dtype, else a CPU tensor (bf16, float8: the codec tags those)."""
    host = leaf.detach().cpu()
    try:
        return host.numpy()
    except TypeError:
        return host


class TransferLedger:
    """Counts (and can forbid) host transfers on the frame path.

    ``implicit`` counts contract violations: transfers the engine did
    not initiate -- a synchronising CUDA call raised inside a guarded
    device element (policy ``disallow`` on the card), or a
    declared-``tensor`` output arriving as a host ``np.ndarray`` (any
    policy except ``allow``, any device).  Under ``log`` the guard only
    warns (nothing raises, so nothing can be counted from it); the
    residency check is what increments the counter there.  ``explicit``
    counts engine-initiated fetches (host-typed inputs,
    process-boundary encodes), each ONE call for the whole tree
    regardless of leaf count.  Healthy pipelines keep ``implicit`` at 0.
    """

    def __init__(self, policy: str = "allow"):
        policy = str(policy or "allow").strip().lower()
        if policy not in TRANSFER_POLICIES:
            raise ValueError(f"transfer_guard={policy!r}: one of "
                             f"{TRANSFER_POLICIES}")
        self.policy = policy
        self.implicit = 0
        self.explicit = 0
        # Labeled sub-counts of ``explicit`` (e.g. the LLM element's
        # per-decode-block fetch, label "llm_block"): lets tests and
        # the bench assert a path pays EXACTLY one fetch per unit of
        # work, not merely "some" fetches.
        self.explicit_by_label: dict = {}
        # Counters are bumped from the event loop AND worker threads.
        self._count_lock = threading.Lock()

    @property
    def active(self) -> bool:
        return self.policy != "allow"

    def guard(self):
        """Wrap one device element's execution (or one LLM decode tick)
        in the CUDA synchronisation guard.  Process-wide: see the
        module docstring."""
        return sync_guard(_SYNC_MODES[self.policy]) if self.active \
            else contextlib.nullcontext()

    def record_implicit(self, count: int = 1):
        with self._count_lock:
            self.implicit += count

    @staticmethod
    def is_guard_error(error: BaseException) -> bool:
        return "synchronizing cuda operation" in str(error).lower()

    def _count(self, label: str | None) -> None:
        with self._count_lock:
            self.explicit += 1
            if label:
                self.explicit_by_label[label] = \
                    self.explicit_by_label.get(label, 0) + 1

    def fetch(self, tree, label: str | None = None):
        """ONE explicit host fetch of every tensor leaf in ``tree``
        (non-tensor leaves pass through untouched -- strings/lists/dicts
        in a swag must not become numpy).  Counted once per call, not
        per leaf -- under ``label`` too when given (the device-loop
        serving contract: one "llm_block" fetch per retired block).
        ``tree`` may also be a host copy already in flight (an object
        with a ``numpy()`` method, such as the batcher's block result,
        whose copies were enqueued at dispatch): the fetch then waits
        for it.  Runs with the guard lifted, so the engine's own sinks
        never trip the guard they enforce."""
        if hasattr(tree, "numpy") and not isinstance(tree, torch.Tensor):
            self._count(label)
            with sync_allowed():
                return tree.numpy()
        if not device_leaves(tree):
            return tree
        self._count(label)
        with sync_allowed():
            return _tree_map(
                lambda leaf: _to_host(leaf)
                if isinstance(leaf, torch.Tensor) else leaf, tree)

    def residency_violations(self, element, outputs: dict) -> list[str]:
        """Declared device outputs (definition ``"type": "tensor"`` /
        ``"device"``) that came back host-resident: the software twin of
        the guard, effective on every device."""
        declared = element.definition.output if element.definition else []
        violations = []
        for io in declared:
            io_type = str(io.get("type", "")).rstrip("?")
            if io_type not in ("tensor", "device"):
                continue
            value = outputs.get(io["name"])
            if value is not None and isinstance(value, np.ndarray):
                violations.append(io["name"])
        return violations

    @property
    def stats(self) -> dict:
        return {"policy": self.policy, "implicit": self.implicit,
                "explicit": self.explicit,
                "explicit_by_label": dict(self.explicit_by_label)}


class DeviceWindow:
    """Per-stream bounded in-flight accounting of dispatched-but-unsynced
    frames (double/triple buffering), paced on CUDA events.  Owned by
    the event loop; no locking."""

    def __init__(self):
        # (frame_id, device leaves, CUDA event or None)
        self._inflight: deque = deque()
        self.noted = 0                       # frames entering the window
        self.synced = 0                      # frames paced to completion
        self.invalidated = 0                 # entries dropped on lost cards

    def note(self, frame_id: int, swag) -> None:
        """Register a completed frame's outstanding device work: one
        event recorded on the current stream of each card it touches."""
        leaves = device_leaves(swag)
        if leaves:
            events = []
            for device in {leaf.device for leaf in leaves
                           if leaf.device.type == "cuda"}:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
                events.append(event)
            self._inflight.append((frame_id, leaves, events))
            self.noted += 1

    def pace(self, limit) -> float:
        """Block (oldest-first) until at most ``limit - 1`` frames stay
        outstanding, so the frame about to dispatch makes ``limit``.
        ``limit`` <= 0 or None disables pacing (unbounded dispatch).
        Returns the seconds spent blocked (0.0 when nothing synced)."""
        if not limit or limit <= 0:
            return 0.0
        if len(self._inflight) < limit:
            return 0.0
        start = time.perf_counter()
        while len(self._inflight) >= limit:
            _, _, events = self._inflight.popleft()
            for event in events:
                event.synchronize()
            self.synced += 1
        return time.perf_counter() - start

    def drain(self) -> None:
        """Sync everything outstanding (stream flush, tests)."""
        self.pace(1)

    def clear(self) -> None:
        """Drop bookkeeping without blocking (stream destroy)."""
        self._inflight.clear()

    def invalidate(self, failed: set) -> int:
        """Forget noted frames whose outstanding leaves sit on lost
        cards: ``pace`` would otherwise wait on an event of a device that
        no longer answers.  Returns how many noted frames were
        dropped."""
        keep, dropped = [], 0
        for entry in self._inflight:
            if touches_devices(entry[1], failed):
                dropped += 1
            else:
                keep.append(entry)
        if dropped:
            self._inflight = deque(keep)
            self.invalidated += dropped
        return dropped

    @property
    def outstanding(self) -> int:
        return len(self._inflight)

    @property
    def stats(self) -> dict:
        return {"outstanding": self.outstanding, "noted": self.noted,
                "synced": self.synced, "invalidated": self.invalidated}
