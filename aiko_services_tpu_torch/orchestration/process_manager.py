"""Child OS-process create/destroy/poll (reference:
src/aiko_services/main/process_manager.py:44-110).

The reference polls children on a dedicated thread; here the poll rides the
owning :class:`EventEngine` as a periodic timer so exit handlers run on the
event loop alongside every other framework callback (no cross-thread state).
A detached thread mode is kept for engine-less embedding.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import threading
import time
from typing import Callable

from ..utils import get_logger

__all__ = ["ProcessManager"]

_logger = get_logger("aiko.process_manager")


class ProcessManager:
    """Tracks child processes by caller-chosen id.

    ``exit_handler(id, process, return_code)`` fires (on the event loop when
    an engine is supplied) whenever a child exits, including forced kills.
    """

    def __init__(self, engine=None,
                 exit_handler: Callable | None = None,
                 poll_period: float = 0.2):
        self.engine = engine
        self.exit_handler = exit_handler
        self.poll_period = poll_period
        self.processes: dict = {}          # id -> Popen
        self._commands: dict = {}          # id -> [argv]
        self._lock = threading.Lock()
        self._timer = None
        self._thread = None
        self._terminated = False

    # -- spawning ----------------------------------------------------------

    def spawn(self, id, command: str, arguments: list | None = None,
              env: dict | None = None, **popen_kwargs) -> subprocess.Popen:
        argv = [command] + [str(a) for a in (arguments or [])]
        process = subprocess.Popen(argv, env=env, **popen_kwargs)
        with self._lock:
            self.processes[id] = process
            self._commands[id] = argv
        _logger.debug("spawned %s: pid=%s %s", id, process.pid, argv)
        self._ensure_polling()
        return process

    def spawn_python(self, id, module: str, arguments: list | None = None,
                     **kwargs) -> subprocess.Popen:
        """Run ``python -m module arguments...`` (the reference resolves
        module names to file paths; ``-m`` does that natively)."""
        return self.spawn(id, sys.executable, ["-m", module]
                          + [str(a) for a in (arguments or [])], **kwargs)

    def adopt(self, id, process: subprocess.Popen) -> subprocess.Popen:
        """Track an externally created Popen (FleetSupervisor spawns
        through its injectable ``spawner``): same polling, same exit
        handler as a spawn of our own."""
        with self._lock:
            self.processes[id] = process
            self._commands[id] = list(getattr(process, "args", []) or [])
        self._ensure_polling()
        return process

    # -- destruction -------------------------------------------------------

    def destroy(self, id, kill_signal=signal.SIGTERM,
                force_after: float | None = 5.0):
        with self._lock:
            process = self.processes.get(id)
        if process is None:
            return
        if process.poll() is None:
            try:
                process.send_signal(kill_signal)
            except ProcessLookupError:
                pass
            if force_after is not None:
                if self.engine is not None:
                    self.engine.add_oneshot_timer(
                        lambda: self._force_kill(id), force_after)
                else:
                    timer = threading.Timer(force_after,
                                            self._force_kill, [id])
                    timer.daemon = True
                    timer.start()

    def _force_kill(self, id):
        with self._lock:
            process = self.processes.get(id)
        if process is not None and process.poll() is None:
            _logger.warning("force-killing %s (pid=%s)", id, process.pid)
            try:
                process.kill()
            except ProcessLookupError:
                pass

    def destroy_all(self, timeout: float = 5.0):
        with self._lock:
            items = list(self.processes.items())
        for id, process in items:
            if process.poll() is None:
                try:
                    process.terminate()
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + timeout
        for id, process in items:
            remaining = max(0.0, deadline - time.monotonic())
            try:
                process.wait(remaining)
            except subprocess.TimeoutExpired:
                process.kill()
                # SIGKILL is asynchronous: reap, or the entry (and its
                # exit handler) would be stranded once polling stops.
                try:
                    process.wait(1.0)
                except subprocess.TimeoutExpired:
                    _logger.error("process %s did not die after SIGKILL",
                                  id)
        self.poll()

    # -- polling -----------------------------------------------------------

    def poll(self):
        """Reap exited children; fire exit handlers."""
        exited = []
        with self._lock:
            for id, process in list(self.processes.items()):
                return_code = process.poll()
                if return_code is not None:
                    del self.processes[id]
                    self._commands.pop(id, None)
                    exited.append((id, process, return_code))
        for id, process, return_code in exited:
            _logger.debug("process %s exited rc=%s", id, return_code)
            if self.exit_handler:
                try:
                    self.exit_handler(id, process, return_code)
                except Exception:
                    _logger.exception("exit handler failed for %s", id)

    def _ensure_polling(self):
        if self.engine is not None:
            if self._timer is None:
                self._timer = self.engine.add_timer_handler(
                    self.poll, self.poll_period)
        elif self._thread is None:
            self._thread = threading.Thread(
                target=self._poll_loop, daemon=True,
                name="aiko.process_manager")
            self._thread.start()

    def _poll_loop(self):
        while not self._terminated:
            self.poll()
            time.sleep(self.poll_period)

    # -- introspection -----------------------------------------------------

    def get(self, id) -> subprocess.Popen | None:
        with self._lock:
            return self.processes.get(id)

    def __len__(self):
        with self._lock:
            return len(self.processes)

    def terminate(self):
        self._terminated = True
        if self._timer is not None and self.engine is not None:
            self.engine.remove_timer_handler(self._timer)
            self._timer = None
        self.destroy_all()
