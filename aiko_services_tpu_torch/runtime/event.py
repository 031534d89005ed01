"""Event engine: timers, priority mailboxes, work queue.

The reference funnels all framework work through a single-threaded
cooperative loop with a 10 ms tick (reference: src/aiko_services/main/
event.py:266-327) -- that tick is the latency floor for every message and
timer.  This engine keeps the same programming model (everything runs on one
event thread; mailboxes drained in priority order, first-registered mailbox
preempts later ones) but is asyncio-native: wake-ups are immediate, so
message latency is bounded by scheduling, not by a tick constant.

Handlers may be plain functions or coroutines.  Producers on foreign
threads (e.g. an MQTT network thread) use the thread-safe ``post`` /
``mailbox_put`` entry points.
"""

from __future__ import annotations

import asyncio
import collections
import heapq
import inspect
import itertools
import threading
import time
from typing import Any, Callable

from ..utils import get_logger

__all__ = ["EventEngine"]

_logger = get_logger("aiko.event")


class _Timer:
    __slots__ = ("handler", "period", "deadline", "cancelled", "once")

    def __init__(self, handler, period, deadline, once):
        self.handler = handler
        self.period = period
        self.deadline = deadline
        self.once = once
        self.cancelled = False


class _Mailbox:
    __slots__ = ("name", "handler", "queue", "priority")

    def __init__(self, name, handler, priority):
        self.name = name
        self.handler = handler
        # drained on the loop thread only; deque for O(1) popleft
        self.queue: collections.deque = collections.deque()
        self.priority = priority


class EventEngine:
    """One engine per process; owns the asyncio loop all services run on."""

    def __init__(self):
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread_id: int | None = None
        self._mailboxes: dict[str, _Mailbox] = {}
        self._mailbox_order = itertools.count()
        self._wake: asyncio.Event | None = None
        self._timers: list[tuple[float, int, _Timer]] = []
        self._timer_seq = itertools.count()
        self._terminated = False
        self._running = False
        self._pending_pre_loop: list[Callable] = []
        self._lock = threading.Lock()
        self._current_timer: _Timer | None = None
        self._idle_waiters: list[asyncio.Future] = []
        self._drained_callbacks: list[tuple] = []

    # -- loop lifecycle ----------------------------------------------------

    @property
    def loop(self) -> asyncio.AbstractEventLoop | None:
        return self._loop

    def run(self, until: Callable[[], bool] | None = None,
            timeout: float | None = None):
        """Blocking: run the engine until ``terminate()`` (or the optional
        ``until`` predicate turns true / timeout expires)."""
        asyncio.run(self._main(until, timeout))

    async def run_async(self, until=None, timeout=None):
        await self._main(until, timeout)

    async def _main(self, until, timeout):
        self._loop = asyncio.get_running_loop()
        self._loop_thread_id = threading.get_ident()
        self._wake = asyncio.Event()
        self._terminated = False
        self._running = True
        with self._lock:
            pre, self._pending_pre_loop = self._pending_pre_loop, []
        for fn in pre:
            self._call(fn)
        deadline = (time.monotonic() + timeout) \
            if timeout is not None else None
        try:
            while not self._terminated:
                if until is not None and until():
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    break
                next_timer = self._run_due_timers()
                progressed = self._drain_one_mailbox_item()
                if progressed:
                    # Yield so coroutines/tasks scheduled by handlers run,
                    # then immediately continue draining.
                    await asyncio.sleep(0)
                    continue
                if self._run_drained_callbacks():
                    await asyncio.sleep(0)
                    continue
                self._notify_idle()
                wait = None
                if next_timer is not None:
                    wait = max(0.0, next_timer - time.monotonic())
                if deadline is not None:
                    until_deadline = max(0.0, deadline - time.monotonic())
                    wait = until_deadline if wait is None else min(
                        wait, until_deadline)
                if until is not None:
                    wait = 0.01 if wait is None else min(wait, 0.01)
                try:
                    await asyncio.wait_for(self._wake.wait(), wait)
                except asyncio.TimeoutError:
                    pass
                self._wake.clear()
        finally:
            self._running = False
            self._notify_idle()

    def terminate(self):
        self._terminated = True
        self._signal()

    @property
    def running(self) -> bool:
        return self._running

    def _signal(self):
        loop, wake = self._loop, self._wake
        if loop is None or wake is None:
            return
        if threading.get_ident() == self._loop_thread_id:
            wake.set()
        else:
            try:
                loop.call_soon_threadsafe(wake.set)
            except RuntimeError:
                pass

    def _call(self, fn, *args):
        try:
            result = fn(*args)
            if inspect.iscoroutine(result):
                asyncio.ensure_future(result)
        except Exception:
            _logger.exception("handler %s raised", getattr(
                fn, "__qualname__", fn))

    def post(self, fn: Callable, *args):
        """Thread-safe: run ``fn(*args)`` on the event loop ASAP.  From
        the loop thread itself this is a SYNCHRONOUS call."""
        loop = self._loop
        if loop is not None and self._running:
            if threading.get_ident() == self._loop_thread_id:
                self._call(fn, *args)
                self._signal()
            else:
                loop.call_soon_threadsafe(self._call, fn, *args)
        else:
            with self._lock:
                self._pending_pre_loop.append(lambda: self._call(fn, *args))

    def post_deferred(self, fn: Callable, *args):
        """Thread-safe: run ``fn(*args)`` on the event loop on a FUTURE
        loop iteration -- never synchronously, even from the loop thread.
        Pump-style handlers that re-post themselves use this so queued
        mailbox work (new requests, frame ingests) interleaves between
        invocations instead of the pump recursing to completion."""
        loop = self._loop
        if loop is not None and self._running:
            if threading.get_ident() == self._loop_thread_id:
                loop.call_soon(self._call, fn, *args)
                self._signal()
            else:
                loop.call_soon_threadsafe(self._call, fn, *args)
        else:
            with self._lock:
                self._pending_pre_loop.append(lambda: self._call(fn, *args))

    def post_when_drained(self, fn: Callable, *args):
        """Thread-safe: run ``fn(*args)`` on the event loop once every
        mailbox has drained -- i.e. after the CURRENT BURST of queued
        work (frame ingests, messages) has all been handled, but before
        the loop sleeps.  Micro-batching elements (elements/detect.py)
        use this to flush exactly when no more same-burst frames can
        arrive; ``post_deferred`` is unsuitable there because its
        callback interleaves after ONE mailbox item, not after the
        burst."""
        with self._lock:
            self._drained_callbacks.append((fn, args))
        self._signal()

    def _run_drained_callbacks(self) -> bool:
        with self._lock:
            callbacks, self._drained_callbacks = \
                self._drained_callbacks, []
        for fn, args in callbacks:
            self._call(fn, *args)
        return bool(callbacks)

    # -- timers ------------------------------------------------------------

    def add_timer_handler(self, handler, period: float,
                          immediate: bool = False) -> Any:
        timer = _Timer(handler, period,
                       time.monotonic() + (0.0 if immediate else period),
                       once=False)
        self._push_timer(timer)
        return timer

    def add_oneshot_timer(self, handler, delay: float) -> Any:
        timer = _Timer(handler, delay, time.monotonic() + delay, once=True)
        self._push_timer(timer)
        return timer

    def remove_timer_handler(self, handler_or_timer):
        if isinstance(handler_or_timer, _Timer):
            handler_or_timer.cancelled = True
            return
        # A periodic timer being executed right now is off the heap; mark
        # it too so it is not re-armed (cancel-from-own-handler case).
        current = self._current_timer
        if current is not None and current.handler == handler_or_timer:
            current.cancelled = True
        with self._lock:
            for _, _, timer in self._timers:
                if timer.handler == handler_or_timer:
                    timer.cancelled = True

    def _push_timer(self, timer: _Timer):
        with self._lock:
            heapq.heappush(self._timers,
                           (timer.deadline, next(self._timer_seq), timer))
        self._signal()

    def _run_due_timers(self) -> float | None:
        """Run all due timers; return the next deadline or None."""
        now = time.monotonic()
        while True:
            with self._lock:
                if not self._timers:
                    return None
                deadline, seq, timer = self._timers[0]
                if timer.cancelled:
                    heapq.heappop(self._timers)
                    continue
                if deadline > now:
                    return deadline
                heapq.heappop(self._timers)
            self._current_timer = timer
            try:
                self._call(timer.handler)
            finally:
                self._current_timer = None
            if not timer.once and not timer.cancelled:
                timer.deadline = now + timer.period
                self._push_timer(timer)

    # -- mailboxes ---------------------------------------------------------

    def add_mailbox_handler(self, handler, name: str,
                            priority: int | None = None):
        """Register a mailbox.  Lower ``priority`` drains first; default is
        registration order (first mailbox added = highest priority, matching
        the reference's preemption rule)."""
        if priority is None:
            priority = next(self._mailbox_order)
        self._mailboxes[name] = _Mailbox(name, handler, priority)

    def remove_mailbox_handler(self, name: str):
        self._mailboxes.pop(name, None)

    def mailbox_put(self, name: str, item):
        """Thread-safe enqueue."""
        mailbox = self._mailboxes.get(name)
        if mailbox is None:
            _logger.warning("mailbox_put: unknown mailbox %s", name)
            return
        if (self._running
                and threading.get_ident() != self._loop_thread_id):
            self._loop.call_soon_threadsafe(self._mailbox_append,
                                            mailbox, item)
        else:
            self._mailbox_append(mailbox, item)

    def _mailbox_append(self, mailbox: _Mailbox, item):
        mailbox.queue.append(item)
        self._signal()

    def mailbox_size(self, name: str) -> int:
        mailbox = self._mailboxes.get(name)
        return len(mailbox.queue) if mailbox else 0

    def _drain_one_mailbox_item(self) -> bool:
        """Process exactly one item from the highest-priority non-empty
        mailbox.  One-at-a-time keeps control mailboxes preemptive."""
        best: _Mailbox | None = None
        for mailbox in self._mailboxes.values():
            if mailbox.queue and (best is None
                                  or mailbox.priority < best.priority):
                best = mailbox
        if best is None:
            return False
        item = best.queue.popleft()
        self._call(best.handler, item)
        return True

    # -- idle synchronisation (tests, graceful shutdown) -------------------

    def _notify_idle(self):
        if not self._idle_waiters:
            return
        if any(m.queue for m in self._mailboxes.values()):
            return
        waiters, self._idle_waiters = self._idle_waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(True)

    async def wait_idle(self):
        """Await until all mailboxes are empty (timers may still be armed)."""
        if not any(m.queue for m in self._mailboxes.values()):
            return
        fut = self._loop.create_future()
        self._idle_waiters.append(fut)
        await fut
