"""Storage actor: sqlite-backed persistent key/value state (reference:
src/aiko_services/main/storage.py:33-57 — a command/request demo stub; this
implementation completes it into a usable service).

Commands (wire-invocable over ``topic/in``):
- ``(store key value)`` — upsert
- ``(fetch response_topic key)`` — request/response: ``(item_count 1)``
  then ``(item key value)`` (or ``item_count 0`` when absent)
- ``(erase key)``
- ``(keys response_topic)`` — list all keys

Values are stored as the S-expression text the wire delivered, so any
structure the codec can carry round-trips.
"""

from __future__ import annotations

import sqlite3

from .actor import Actor
from ..utils import generate, generate_value, get_logger

__all__ = ["Storage", "PROTOCOL_STORAGE"]

_logger = get_logger("aiko.storage")

PROTOCOL_STORAGE = "storage:0"


class Storage(Actor):
    def __init__(self, name: str = "storage", database_path: str =
                 "aiko_storage.db", runtime=None):
        super().__init__(name, PROTOCOL_STORAGE, tags=["ec=true"],
                         runtime=runtime)
        self.database_path = database_path
        # The event engine serializes all access: one connection is safe.
        self._db = sqlite3.connect(database_path,
                                   check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS storage "
            "(key TEXT PRIMARY KEY, value TEXT)")
        self._db.commit()
        self.share["item_count"] = self._count()

    def _count(self) -> int:
        return self._db.execute(
            "SELECT COUNT(*) FROM storage").fetchone()[0]

    # -- commands ----------------------------------------------------------

    def store(self, key, value):
        self._db.execute(
            "INSERT INTO storage (key, value) VALUES (?, ?) "
            "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
            (str(key), generate_value(value)))
        self._db.commit()
        self.ec_producer.update("item_count", self._count())

    def fetch(self, response_topic, key):
        row = self._db.execute(
            "SELECT value FROM storage WHERE key = ?",
            (str(key),)).fetchone()
        publish = self.runtime.message.publish
        if row is None:
            publish(response_topic, generate("item_count", [0]))
            return
        publish(response_topic, generate("item_count", [1]))
        # row[0] is already codec text (stored via generate_value); the key
        # must go through the codec too or spaces/parens/quotes in it would
        # produce an unparseable S-expression.
        publish(response_topic,
                f"(item {generate_value(key)} {row[0]})")

    def erase(self, key):
        self._db.execute("DELETE FROM storage WHERE key = ?", (str(key),))
        self._db.commit()
        self.ec_producer.update("item_count", self._count())

    def keys(self, response_topic):
        rows = self._db.execute(
            "SELECT key FROM storage ORDER BY key").fetchall()
        publish = self.runtime.message.publish
        publish(response_topic, generate("item_count", [len(rows)]))
        for (key,) in rows:
            publish(response_topic, generate("item", [key]))

    # -- local API ---------------------------------------------------------

    def get_local(self, key, default=None):
        row = self._db.execute(
            "SELECT value FROM storage WHERE key = ?",
            (str(key),)).fetchone()
        if row is None:
            return default
        from ..utils import parse_value
        return parse_value(row[0])

    def stop(self):
        self._db.close()
        super().stop()
