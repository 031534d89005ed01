"""Small utilities: LRU cache, dynamic importer, free-port finder, time
helpers, process stats (reference: src/aiko_services/main/utilities/
{lru_cache.py,importer.py,network.py,system.py,utc_iso8601.py}).
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import socket
import sys
import time
from collections import OrderedDict
from datetime import datetime, timezone

__all__ = ["LRUCache", "load_module", "load_class", "find_free_port",
           "utc_iso8601", "epoch_to_iso8601", "process_memory_rss",
           "next_power_of_two"]


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (compile-shape bucketing: batched
    dispatch sites pad ragged batches up to one of log2(N) buckets so
    XLA compiles once per bucket, not once per batch size)."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return bucket


class LRUCache:
    def __init__(self, size: int):
        self.size = size
        self._data: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        if key in self._data:
            self._data.move_to_end(key)
            return self._data[key]
        return default

    def put(self, key, value):
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.size:
            self._data.popitem(last=False)

    def items(self):
        return list(self._data.items())

    def __contains__(self, key):
        return key in self._data

    def __len__(self):
        return len(self._data)


_MODULE_CACHE: dict = {}


def load_module(name_or_path: str):
    """Import a module by dotted name or ``.py`` pathname (cached)."""
    if name_or_path in _MODULE_CACHE:
        return _MODULE_CACHE[name_or_path]
    if name_or_path.endswith(".py") or os.sep in name_or_path:
        path = os.path.abspath(name_or_path)
        module_name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules.setdefault(module_name, module)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(name_or_path)
    _MODULE_CACHE[name_or_path] = module
    return module


def load_class(qualified_name: str):
    """Load ``package.module.ClassName`` or ``path/to/file.py:ClassName``."""
    if ":" in qualified_name and qualified_name.count(":") == 1:
        module_part, class_name = qualified_name.split(":")
    else:
        module_part, _, class_name = qualified_name.rpartition(".")
    module = load_module(module_part)
    return getattr(module, class_name)


def find_free_port(start: int = 0, kind: str = "tcp") -> int:
    """Kernel-assigned free port; ``kind`` is tcp or udp (reference
    utilities/network.py:10-44 scans both families)."""
    socket_type = socket.SOCK_DGRAM if kind == "udp" else socket.SOCK_STREAM
    with socket.socket(socket.AF_INET, socket_type) as sock:
        sock.bind(("", start))
        return sock.getsockname()[1]


def utc_iso8601() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3]


def epoch_to_iso8601(epoch: float) -> str:
    return datetime.fromtimestamp(
        epoch, tz=timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3]


def process_memory_rss() -> int:
    """Resident set size in bytes (Linux; 0 elsewhere). No psutil needed."""
    try:
        with open(f"/proc/{os.getpid()}/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def monotonic_ms() -> float:
    return time.monotonic() * 1000.0
