"""Durable per-pipeline stream journal (ISSUE 13 tentpole, layer 1).

Every fault the engine survives today is scoped to a single living
process: chip death replays in-flight frames (PR 5), replica loss
sheds to peers (PR 7), wire faults breaker-and-fallback (PR 9) -- but
SIGKILL the process and every live stream, parked frame and
mid-generation LLM request dies with it.  This module is the
process-boundary half of that story: a lightweight append-only journal
records each stream's *recoverable* state at its natural commit
points, so a surviving peer can reconstruct any live stream at its
last host-visible boundary.

What is journaled (and when):

- ``open``   stream creation: parameters (tenant/class/deadline),
  graph path and the response topic -- enough to recreate the stream
  with identical admission semantics on a peer.
- ``frame``  frame ingest: the frame id plus its HOST-VISIBLE input
  swag, wire-encoded by the frame codec.  Device-resident leaves are
  never fetched here (that would be a hidden sync on the hot path);
  they are skipped and the record is marked ``partial`` -- state past
  the journal horizon, honestly lost on failover.
- ``done``   response delivery: the commit point that PRUNES the
  frame from the live set.  A frame with no ``done`` record is
  *undelivered* and will be replayed by an adopter.
- ``llm``    per emitted token of an LLM stream: the committed prefix
  the ``_rebase`` machinery maintains, so an adopter resumes
  generation at the last emitted token instead of re-running (and
  re-streaming) the whole request.
- ``close``  graceful stream destroy: the whole stream leaves the
  live set (an adopter ignores it).
- ``drained``  clean cooperative shutdown marker (``drain`` command):
  everything undelivered above it is intentionally parked for
  adoption, nothing was lost mid-write.

Durability discipline: every record is WRITTEN (buffered + flushed to
the OS) immediately -- a crashed process's journal is complete up to
its last append on the same host -- while ``fsync`` is batched on a
time interval so the hot path never pays a disk sync per frame.  The
file is bounded: once the append count outgrows the live set a
compaction rewrites the journal from the in-memory mirror (tmp file +
atomic rename).

Adoption claims: :func:`claim_adoption` creates ``<path>.adopted``
with ``O_EXCL`` -- exactly one peer may adopt a dead pipeline's
journal; the second claimant is refused (double-adoption of a stream
would double-replay its undelivered frames).

jax-free by design, like faults/ and observability/: journaling and
recovery must work on a host whose accelerator just died.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .codec import encode_value, decode_value
from ..utils import get_logger

__all__ = ["StreamJournal", "JournalState", "StreamEntry",
           "load_journal", "claim_adoption", "adopter_of",
           "JOURNAL_FSYNC_MS_DEFAULT", "JOURNAL_COMPACT_RECORDS",
           "ADOPT_LIMIT_DEFAULT", "DRAIN_TIMEOUT_MS_DEFAULT"]

_logger = get_logger("aiko.journal")

JOURNAL_FSYNC_MS_DEFAULT = 50.0
#: appended records beyond the live set before a compaction rewrite.
JOURNAL_COMPACT_RECORDS = 4096
#: streams one ``adopt`` command will reconstruct (the ``adopt_limit``
#: parameter) -- bounded like ``replay_limit`` bounds chip-death
#: replays, so a pathological journal cannot wedge the adopter.
ADOPT_LIMIT_DEFAULT = 64
#: how long ``drain`` waits for in-flight frames before parking the
#: leftovers in the journal for adoption (``drain_timeout_ms``).
DRAIN_TIMEOUT_MS_DEFAULT = 5000.0


def _encodable(value) -> bool:
    """Host-visible leaf test WITHOUT importing torch: tensors
    identify by their type's module.  Anything torch-typed is skipped
    (journal horizon), never fetched."""
    module = type(value).__module__ or ""
    return not module.startswith("torch")


class StreamEntry:
    """One stream's state -- shared by the journal's in-memory mirror
    (compaction source) and the reader's reconstruction.

    The delivered set is kept BOUNDED by a contiguous-frontier
    watermark: delivery is in ingest order (the engine's reorder
    buffer), so delivered frames collapse into ``done_upto`` as the
    frontier advances, and only out-of-order stragglers (rare: a
    dropped frame's skipped slot) stay as explicit entries."""

    __slots__ = ("stream_id", "parameters", "graph_path",
                 "topic_response", "frames", "llm", "closed",
                 "done_upto")

    def __init__(self, stream_id: str):
        self.stream_id = stream_id
        self.parameters: dict = {}
        self.graph_path = None
        self.topic_response = None
        # frame_id -> {"data": encoded swag, "partial": bool,
        #              "delivered": bool, "ok": bool | None}; frames
        # at or below ``done_upto`` are popped (delivered, pruned).
        self.frames: dict = {}
        self.llm: dict = {}             # frame_id -> [committed tokens]
        self.closed = False
        self.done_upto = -1             # all ids <= this are delivered

    def mark_done(self, frame_id: int, ok) -> None:
        frame = self.frames.setdefault(
            int(frame_id), {"data": {}, "partial": False,
                            "delivered": False, "ok": None})
        frame["delivered"] = True
        frame["ok"] = None if ok is None else bool(ok)
        frame["data"] = {}
        self.llm.pop(int(frame_id), None)
        while True:
            frontier = self.frames.get(self.done_upto + 1)
            if frontier is None or not frontier.get("delivered"):
                break
            self.frames.pop(self.done_upto + 1)
            self.done_upto += 1

    def set_upto(self, frame_id: int) -> None:
        frame_id = int(frame_id)
        if frame_id <= self.done_upto:
            return
        for fid in [fid for fid in self.frames if fid <= frame_id]:
            self.frames.pop(fid)
        for fid in [fid for fid in self.llm if fid <= frame_id]:
            self.llm.pop(fid)
        self.done_upto = frame_id

    @property
    def undelivered(self) -> list:
        """Frame ids ingested but never delivered, in ingest order."""
        return sorted(fid for fid, entry in self.frames.items()
                      if not entry.get("delivered"))

    @property
    def delivered(self) -> list:
        explicit = {fid for fid, entry in self.frames.items()
                    if entry.get("delivered")}
        return sorted(set(range(self.done_upto + 1)) | explicit)


class JournalState:
    """Result of :func:`load_journal`."""

    __slots__ = ("streams", "drained", "records", "truncated")

    def __init__(self):
        self.streams: dict[str, StreamEntry] = {}
        self.drained = False
        self.records = 0
        self.truncated = False

    def live_streams(self) -> list:
        """Open (never gracefully closed) streams, creation-ordered."""
        return [entry for entry in self.streams.values()
                if not entry.closed]


class StreamJournal:
    """Append-only, fsync-batched journal for one pipeline.

    Thread-safe: the event loop appends ingest/delivery records while
    LLM device workers append token commits."""

    def __init__(self, path: str,
                 fsync_ms: float = JOURNAL_FSYNC_MS_DEFAULT,
                 compact_records: int = JOURNAL_COMPACT_RECORDS):
        self.path = str(path)
        self.fsync_ms = max(0.0, float(fsync_ms))
        self.compact_records = max(64, int(compact_records))
        self._lock = threading.Lock()
        self._live: dict[str, StreamEntry] = {}
        self._appended = 0              # records since last compaction
        self._pending_sync = 0          # records written, not fsynced
        self._last_sync = time.monotonic()
        self._sync_timer: threading.Timer | None = None
        self.appends = 0                # lifetime record count
        self.compactions = 0
        self.synced = 0                 # fsync calls
        self.partial_frames = 0         # device leaves past the horizon
        # Fresh incarnation: a restarting pipeline starts an empty
        # journal and clears any stale adoption claim, or its NEXT
        # death could never be adopted (the claim file fences by
        # path).  A previous incarnation that was adopted or cleanly
        # drained is discarded; one that was NEITHER (unclean death,
        # supervisor respawned faster than the LWT + adoption ran) is
        # preserved as ``<path>.orphaned`` -- an adopter that loses
        # the race reads the fresh (empty) file instead of state
        # vanishing mid-read, and the orphan stays recoverable by
        # hand: ``(adopt <path>.orphaned)``.
        try:
            if os.path.getsize(self.path) > 0 \
                    and not os.path.exists(f"{self.path}.adopted") \
                    and not load_journal(self.path).drained:
                os.replace(self.path, f"{self.path}.orphaned")
                _logger.warning(
                    "journal %s from the previous incarnation was "
                    "never adopted; preserved as %s.orphaned",
                    self.path, self.path)
        except OSError:
            pass
        try:
            os.unlink(f"{self.path}.adopted")
        except OSError:
            pass
        self._file = open(self.path, "w", encoding="utf-8")

    # -- record emission ---------------------------------------------------

    def _append(self, record: dict) -> int:
        """Write one record (flushed, fsync batched); returns the
        unsynced backlog AFTER the append -- the ``journal_lag``
        signal."""
        line = json.dumps(record, separators=(",", ":"))
        now = time.monotonic()
        with self._lock:
            self._file.write(line + "\n")
            self._file.flush()
            self.appends += 1
            self._appended += 1
            self._pending_sync += 1
            lag = self._pending_sync
            due = self.fsync_ms == 0.0 or \
                (now - self._last_sync) * 1000.0 >= self.fsync_ms
            if due:
                self._sync_locked()
                lag = 0
            else:
                # The batch must fsync even if NO further append ever
                # comes (a low-rate stream's last frame would
                # otherwise sit un-fsynced indefinitely -- far past
                # the journal_fsync_ms horizon the docs promise).
                self._arm_sync_timer_locked()
        return lag

    def _arm_sync_timer_locked(self) -> None:
        if self._sync_timer is not None:
            return
        timer = threading.Timer(self.fsync_ms / 1000.0,
                                self._timer_sync)
        timer.daemon = True
        self._sync_timer = timer
        timer.start()

    def _timer_sync(self) -> None:
        with self._lock:
            self._sync_timer = None
            if self._pending_sync:
                try:
                    self._file.flush()
                    self._sync_locked()
                except (OSError, ValueError):
                    pass                # closed mid-flight: no-op

    def _sync_locked(self) -> None:
        try:
            os.fsync(self._file.fileno())
        except OSError:
            pass
        self._pending_sync = 0
        self._last_sync = time.monotonic()
        self.synced += 1

    def sync(self) -> None:
        """Force the batched fsync (drain/shutdown commit point)."""
        with self._lock:
            self._file.flush()
            self._sync_locked()

    @property
    def lag(self) -> int:
        """Records written but not yet fsynced."""
        with self._lock:
            return self._pending_sync

    # -- commit points -----------------------------------------------------

    def stream_open(self, stream_id: str, parameters: dict,
                    graph_path=None, topic_response=None) -> int:
        stream_id = str(stream_id)
        entry = StreamEntry(stream_id)
        entry.parameters = self._safe_parameters(parameters)
        entry.graph_path = graph_path
        entry.topic_response = topic_response
        with self._lock:
            self._live[stream_id] = entry
        return self._append({"t": "open", "s": stream_id,
                             "params": entry.parameters,
                             "path": graph_path,
                             "topic": topic_response})

    def frame_ingested(self, stream_id: str, frame_id: int,
                       swag: dict, trace_id=None) -> int:
        stream_id = str(stream_id)
        data, partial = self._encode_swag(swag)
        if partial:
            self.partial_frames += 1
        with self._lock:
            entry = self._live.get(stream_id)
            if entry is not None:
                mirror = {"data": data, "partial": partial,
                          "delivered": False, "ok": None}
                if trace_id:
                    mirror["tid"] = str(trace_id)
                entry.frames[int(frame_id)] = mirror
        record = {"t": "frame", "s": stream_id, "f": int(frame_id),
                  "data": data}
        if partial:
            record["partial"] = True
        if trace_id:
            # A replay after adoption re-ingests with this trace_id:
            # the frame's spans keep joining its ORIGINAL door-to-
            # decode trace across the process kill.
            record["tid"] = str(trace_id)
        return self._append(record)

    def frame_done(self, stream_id: str, frame_id: int,
                   ok: bool = True) -> int:
        stream_id = str(stream_id)
        with self._lock:
            entry = self._live.get(stream_id)
            if entry is not None:
                # Delivered: the payload prunes and the frame folds
                # into the contiguous done_upto watermark.
                entry.mark_done(frame_id, ok)
        lag = self._append({"t": "done", "s": stream_id,
                            "f": int(frame_id), "ok": bool(ok)})
        self._maybe_compact()
        return lag

    def llm_token(self, stream_id: str, frame_id: int,
                  token: int) -> int:
        stream_id = str(stream_id)
        with self._lock:
            entry = self._live.get(stream_id)
            if entry is not None:
                entry.llm.setdefault(int(frame_id), []).append(int(token))
        return self._append({"t": "llm", "s": stream_id,
                             "f": int(frame_id), "tok": int(token)})

    def llm_tokens(self, stream_id: str, frame_id: int,
                   tokens: list) -> int:
        """Bulk commit (adoption re-journals an inherited prefix; the
        batcher's export path commits a whole request at once)."""
        stream_id = str(stream_id)
        tokens = [int(token) for token in tokens]
        if not tokens:
            return self.lag
        with self._lock:
            entry = self._live.get(stream_id)
            if entry is not None:
                entry.llm.setdefault(int(frame_id), []).extend(tokens)
        return self._append({"t": "llm", "s": stream_id,
                             "f": int(frame_id), "toks": tokens})

    def stream_close(self, stream_id: str) -> int:
        stream_id = str(stream_id)
        with self._lock:
            self._live.pop(stream_id, None)
        lag = self._append({"t": "close", "s": stream_id})
        self._maybe_compact()
        return lag

    def mark_drained(self) -> None:
        """Clean cooperative shutdown: everything undelivered is
        intentionally parked for adoption."""
        self._append({"t": "drained"})
        self.sync()

    # -- bounding ----------------------------------------------------------

    def _live_records(self) -> int:
        count = 0
        for entry in self._live.values():
            count += 1 + len(entry.frames) + len(entry.llm)
        return count

    def _maybe_compact(self) -> None:
        with self._lock:
            live = self._live_records()
            if self._appended < self.compact_records \
                    or self._appended < 2 * max(1, live):
                return
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Rewrite the file from the live mirror (tmp + atomic
        rename): the delivered history collapses into one ``upto``
        watermark per stream, closed streams vanish."""
        tmp = f"{self.path}.compact"
        written = 0
        try:
            with open(tmp, "w", encoding="utf-8") as out:
                for entry in self._live.values():
                    records = [{"t": "open", "s": entry.stream_id,
                                "params": entry.parameters,
                                "path": entry.graph_path,
                                "topic": entry.topic_response}]
                    if entry.done_upto >= 0:
                        records.append({"t": "upto",
                                        "s": entry.stream_id,
                                        "f": entry.done_upto})
                    for fid in sorted(entry.frames):
                        frame = entry.frames[fid]
                        if frame.get("delivered"):
                            # an out-of-order straggler past the
                            # watermark
                            records.append({"t": "done",
                                            "s": entry.stream_id,
                                            "f": fid,
                                            "ok": frame.get("ok", True)})
                            continue
                        record = {"t": "frame", "s": entry.stream_id,
                                  "f": fid, "data": frame["data"]}
                        if frame.get("partial"):
                            record["partial"] = True
                        if frame.get("tid"):
                            record["tid"] = frame["tid"]
                        records.append(record)
                    for fid in sorted(entry.llm):
                        records.append({"t": "llm",
                                        "s": entry.stream_id, "f": fid,
                                        "toks": entry.llm[fid]})
                    for record in records:
                        out.write(json.dumps(
                            record, separators=(",", ":")) + "\n")
                        written += 1
                out.flush()
                os.fsync(out.fileno())
            self._file.close()
            os.replace(tmp, self.path)
            self._file = open(self.path, "a", encoding="utf-8")
            self._appended = written
            self._pending_sync = 0
            self._last_sync = time.monotonic()
            self.compactions += 1
        except OSError:
            _logger.exception("journal compaction failed; journal "
                              "keeps growing until the next attempt")
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _safe_parameters(parameters: dict) -> dict:
        """Stream parameters are JSON-encodable by construction
        (wire/gateway provenance); anything else degrades to str."""
        safe = {}
        for key, value in (parameters or {}).items():
            try:
                json.dumps(value)
                safe[str(key)] = value
            except (TypeError, ValueError):
                safe[str(key)] = str(value)
        return safe

    @staticmethod
    def _encode_swag(swag: dict) -> tuple[dict, bool]:
        """Host-visible swag -> wire-encoded payload.  Device leaves
        (jax-typed) are past the journal horizon: skipped, flagged."""
        data: dict = {}
        partial = False
        for key, value in (swag or {}).items():
            if "." in str(key):
                continue            # producer-qualified aliases rebuild
            if not _encodable(value):
                partial = True
                continue
            try:
                data[str(key)] = encode_value(value)
            except Exception:
                partial = True
        return data, partial

    def stats(self) -> dict:
        with self._lock:
            return {"path": self.path, "appends": self.appends,
                    "pending_sync": self._pending_sync,
                    "live_streams": len(self._live),
                    "live_records": self._live_records(),
                    "compactions": self.compactions,
                    "synced": self.synced,
                    "partial_frames": self.partial_frames}

    def close(self) -> None:
        with self._lock:
            if self._sync_timer is not None:
                self._sync_timer.cancel()
                self._sync_timer = None
            try:
                self._file.flush()
                self._sync_locked()
                self._file.close()
            except (OSError, ValueError):
                pass


# ---------------------------------------------------------------------------
# Recovery side: read a (possibly unclean) journal.

def load_journal(path: str) -> JournalState:
    """Reconstruct the live-stream state from a journal file.  A
    truncated final line (the process died mid-write) is tolerated:
    everything before it is intact -- records are flushed whole and
    newline-terminated."""
    state = JournalState()
    try:
        with open(path, "r", encoding="utf-8") as stream:
            for line in stream:
                if not line.endswith("\n"):
                    state.truncated = True
                    break           # torn tail: stop, keep the prefix
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except json.JSONDecodeError:
                    state.truncated = True
                    break
                state.records += 1
                _apply(state, record)
    except OSError as error:
        _logger.warning("journal %s unreadable: %s", path, error)
    return state


def _apply(state: JournalState, record: dict) -> None:
    kind = record.get("t")
    if kind == "drained":
        state.drained = True
        return
    stream_id = str(record.get("s", ""))
    if not stream_id:
        return
    if kind == "open":
        entry = StreamEntry(stream_id)
        entry.parameters = dict(record.get("params") or {})
        entry.graph_path = record.get("path")
        entry.topic_response = record.get("topic")
        state.streams[stream_id] = entry
        return
    entry = state.streams.get(stream_id)
    if entry is None:
        entry = StreamEntry(stream_id)
        state.streams[stream_id] = entry
    if kind == "frame":
        mirror = {"data": dict(record.get("data") or {}),
                  "partial": bool(record.get("partial", False)),
                  "delivered": False, "ok": None}
        if record.get("tid"):
            mirror["tid"] = str(record["tid"])
        entry.frames[int(record.get("f", 0))] = mirror
    elif kind == "done":
        entry.mark_done(int(record.get("f", 0)),
                        record.get("ok", True))
    elif kind == "upto":
        entry.set_upto(int(record.get("f", -1)))
    elif kind == "llm":
        tokens = entry.llm.setdefault(int(record.get("f", 0)), [])
        if "toks" in record:
            tokens.extend(int(token) for token in record["toks"])
        else:
            tokens.append(int(record.get("tok", 0)))
    elif kind == "close":
        entry.closed = True


def decode_payload(data: dict) -> dict:
    """Journaled frame payload -> ingestable swag (codec twin of the
    encode in ``frame_ingested``)."""
    return {key: decode_value(value) for key, value in
            (data or {}).items()}


# ---------------------------------------------------------------------------
# Adoption claims.

def claim_adoption(path: str, adopter: str) -> bool:
    """Claim a dead pipeline's journal for ``adopter``.  Exactly one
    claimant wins (``O_EXCL`` create of ``<path>.adopted``); everyone
    else is refused -- a stream adopted twice would double-replay its
    undelivered frames to the client."""
    try:
        fd = os.open(f"{path}.adopted",
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    except FileExistsError:
        return False
    except OSError as error:
        _logger.warning("adoption claim on %s failed: %s", path, error)
        return False
    with os.fdopen(fd, "w") as stream:
        stream.write(json.dumps({"adopter": str(adopter),
                                 "time": time.time()}))
    return True


def adopter_of(path: str) -> str | None:
    """Who claimed this journal, or None."""
    try:
        with open(f"{path}.adopted", "r", encoding="utf-8") as stream:
            return str(json.load(stream).get("adopter"))
    except (OSError, ValueError):
        return None
