"""Binary multi-host data plane for remote-stage frames (ISSUE 9).

The source paper's architecture splits control from data: MQTT carries
discovery, commands and the small per-frame envelope; bulk tensors
must not.  Before this module, every remote-stage hop shipped its
tensors base64'd inside the S-expression ``process_frame`` message --
a ~33% byte tax plus a full host copy per tensor per hop.  Now each
Pipeline binds one :class:`TensorPipeEndpoint` (the length-prefixed
raw-bytes TCP framing from ``transport/tensor_pipe.py``, native or
pure-Python) advertised in its registrar record as a
``tensor_pipe=host:port`` tag, and remote hops ship:

- **pipe**: every array-valued swag entry as raw bytes (dtype-tagged
  integer views for bf16/float8, reusing the codec's tagging), keyed
  by a per-forward ``token``;
- **MQTT**: the control envelope -- frame id, stream id, trace
  context, the token and the key list -- exactly the traffic the
  control fabric is for.

The receiver pairs the two: the envelope *claims* the token's tensors
from the endpoint; tensors still in flight defer the envelope (a
watch fires when they land), and a token whose tensors never arrive
expires -- the same blast radius as a dropped wire frame, recovered by
the sender's deadline/breaker machinery.  Negotiation is automatic:
a peer advertising no pipe rides MQTT (counted, never silent), and a
pipe send failure falls back to MQTT for that frame while the
sender's per-peer :class:`~..faults.CircuitBreaker` paces reconnects
(PR-5 machinery, reused).

Everything here is jax-free; ``device_put`` into the target submesh
happens in the engine (pipeline.py) where the placement lives.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict

import numpy as np

from .codec import tag_view, untag_view
from ..faults import CircuitBreaker
from ..transport.tensor_pipe import (create_pipe_client,
                                     create_pipe_server)
from ..utils import get_logger

__all__ = ["DATA_PLANE_MODES", "PIPE_TAG", "PipeSender",
           "TensorPipeEndpoint", "split_arrays",
           "PIPE_CLAIM_TIMEOUT_MS_DEFAULT",
           "PIPE_TOKEN_CAPACITY_DEFAULT"]

_logger = get_logger("aiko.data_plane")

DATA_PLANE_MODES = ("auto", "tensor_pipe", "mqtt")
#: registrar-record tag key advertising a pipeline's pipe endpoint.
PIPE_TAG = "tensor_pipe"

PIPE_CLAIM_TIMEOUT_MS_DEFAULT = 5000.0
#: tokens whose tensors were claimed stay briefly for duplicate
#: envelopes (MQTT QoS1 redelivery / wire_dup chaos: the duplicate
#: re-claims and re-executes, matching the MQTT path's blast radius),
#: then sweep.
_CLAIMED_TTL_S = 2.0
#: token-store hard cap (``pipe_token_capacity`` parameter): a flood
#: control against pathological senders, NOT the working-set bound --
#: steady-state memory is arrival-rate x TTL, since claimed tokens
#: sweep after _CLAIMED_TTL_S and unclaimed after the claim timeout.
#: Must exceed the realistic in-flight forward count to this endpoint
#: or evicted frames pay the claim timeout (counted, tokens_evicted).
PIPE_TOKEN_CAPACITY_DEFAULT = 128
_PIPE_CONNECT_TIMEOUT_S = 2.0
_PIPE_BREAKER_THRESHOLD = 3
_PIPE_BREAKER_COOLDOWN_S = 1.0


def split_arrays(frame_data: dict) -> dict:
    """The array-valued entries of a host-side frame dict -- exactly
    the values the MQTT codec would base64 (same predicate), i.e. the
    ones that belong on the pipe."""
    return {key: value for key, value in frame_data.items()
            if hasattr(value, "__array__")
            and not isinstance(value, (str, bytes, list, tuple, dict))}


class _Token:
    __slots__ = ("arrays", "arrived", "claimed_at")

    def __init__(self):
        self.arrays: dict = {}
        self.arrived = time.monotonic()
        self.claimed_at: float | None = None


class TensorPipeEndpoint:
    """One pipeline's receive side of the data plane: the pipe server,
    the token store pairing tensors with their MQTT envelopes, and the
    watch/expiry machinery for envelopes that outran their tensors.

    Thread model: a collector thread drains the server queue into the
    token store and fires watch callbacks (which ``post_self`` back
    onto the pipeline's event loop); ``claim``/``watch`` are called
    from the event loop.  All state behind one lock."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 claim_timeout_s: float =
                 PIPE_CLAIM_TIMEOUT_MS_DEFAULT / 1000.0,
                 capacity: int = PIPE_TOKEN_CAPACITY_DEFAULT):
        self.server = create_pipe_server(host, port)
        self.host = host
        self.port = self.server.port
        self.location = f"{host}:{self.port}"
        self.claim_timeout_s = float(claim_timeout_s)
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        self._tokens: OrderedDict[str, _Token] = OrderedDict()
        # token -> (frozenset(keys), callback, monotonic deadline)
        self._watches: dict[str, tuple] = {}
        self.claims_expired = 0
        self.tokens_evicted = 0
        self._evict_logged = False
        self._closing = threading.Event()
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True,
            name="aiko.data_plane.collect")
        self._collector.start()

    # -- receive side ------------------------------------------------------

    def _collect_loop(self):
        while not self._closing.is_set():
            frame = self.server.recv(timeout=0.1)
            fired = []
            now = time.monotonic()
            with self._lock:
                if frame is not None:
                    self._store(frame, fired)
                self._sweep(now, fired)
            for callback in fired:
                try:
                    callback()
                except Exception:
                    _logger.exception("data plane watch callback "
                                      "failed")

    def _store(self, frame, fired: list) -> None:
        name, array = frame
        try:
            meta = json.loads(name)
            token_id = str(meta["t"])
            key = str(meta["k"])
        except (ValueError, KeyError, TypeError):
            _logger.debug("tensor pipe frame with non-data-plane "
                          "name %r ignored", name)
            return
        token = self._tokens.get(token_id)
        if token is None:
            token = self._tokens[token_id] = _Token()
        self._tokens.move_to_end(token_id)
        token.arrays[key] = untag_view(array, meta.get("v"))
        while len(self._tokens) > self._capacity:
            evicted_id, evicted = self._tokens.popitem(last=False)
            if evicted.claimed_at is None:
                # An UNCLAIMED token squeezed out by capacity pressure
                # (>capacity forwards in flight to this endpoint): its
                # envelope will wait out the claim timeout and take the
                # MQTT re-forward -- a latency cliff that must be
                # counted and visible, never silent.
                self.tokens_evicted += 1
                if not self._evict_logged:
                    self._evict_logged = True
                    _logger.warning(
                        "data plane endpoint %s: token store over "
                        "capacity (%d) -- evicting unclaimed token %s; "
                        "its envelope pays the claim timeout + MQTT "
                        "re-forward (see tokens_evicted)",
                        self.location, self._capacity, evicted_id)
        watch = self._watches.get(token_id)
        if watch is not None and watch[0] <= set(token.arrays):
            fired.append(watch[1])
            del self._watches[token_id]

    def _sweep(self, now: float, fired: list) -> None:
        # Expired watches fire their callback anyway: the claimer
        # re-claims, finds the keys still missing, and gives up with a
        # counted log -- the wire-drop blast radius, never a silent
        # hang of the envelope.
        for token_id in [token_id for token_id, (_, _, deadline)
                         in self._watches.items() if now > deadline]:
            self.claims_expired += 1
            fired.append(self._watches.pop(token_id)[1])
        for token_id in [token_id for token_id, token
                         in self._tokens.items()
                         if (token.claimed_at is not None
                             and now - token.claimed_at > _CLAIMED_TTL_S)
                         or now - token.arrived
                         > self.claim_timeout_s + _CLAIMED_TTL_S]:
            del self._tokens[token_id]

    # -- event-loop API ----------------------------------------------------

    def claim(self, token_id: str, keys) -> dict | None:
        """All of ``keys`` present under ``token_id`` -> the arrays
        (the entry stays briefly for duplicate envelopes); else None --
        the caller should ``watch``."""
        with self._lock:
            token = self._tokens.get(str(token_id))
            if token is None or not set(keys) <= set(token.arrays):
                return None
            token.claimed_at = time.monotonic()
            return dict(token.arrays)

    def watch(self, token_id: str, keys, callback) -> None:
        """Fire ``callback`` (from the collector thread; use post_self)
        once every key arrived -- or at the claim timeout, whichever is
        first.  A token already complete fires inline.  A CLOSED
        endpoint fires the timeout path inline too: its collector
        thread is gone, so no deadline would ever be serviced and the
        deferred envelope (plus everything ordered behind it) would
        hang forever instead of taking the counted MQTT re-forward."""
        with self._lock:
            if self._closing.is_set():
                self.claims_expired += 1
                complete = True          # fire below, outside the lock
            else:
                token = self._tokens.get(str(token_id))
                complete = token is not None \
                    and set(keys) <= set(token.arrays)
                if not complete:
                    self._watches[str(token_id)] = (
                        frozenset(str(key) for key in keys), callback,
                        time.monotonic() + self.claim_timeout_s)
        if complete:
            callback()

    @property
    def dropped(self) -> int:
        return self.server.dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._tokens)

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"location": self.location,
                    "tokens": len(self._tokens),
                    "watches": len(self._watches),
                    "claims_expired": self.claims_expired,
                    "tokens_evicted": self.tokens_evicted,
                    "dropped_frames": self.server.dropped}

    def close(self) -> None:
        # _closing is set UNDER the lock so a racing watch() either
        # registers before the drain below (and is fired here) or sees
        # the flag and fires inline -- never a watch stranded on a dead
        # collector.
        with self._lock:
            self._closing.set()
            pending = [watch[1] for watch in self._watches.values()]
            self._watches.clear()
            self.claims_expired += len(pending)
        # join=False: teardown over many pipelines must not pay a
        # thread-join timeout per endpoint; the daemon threads exit on
        # their next poll tick.
        self.server.close(join=False)
        for callback in pending:
            try:
                callback()
            except Exception:
                _logger.exception("data plane watch callback failed "
                                  "during endpoint close")


class PipeSender:
    """One peer endpoint's send side: a lazily-connected pipe client
    behind a :class:`CircuitBreaker` -- the PR-5 reconnect discipline.
    Consecutive send/connect failures open the breaker (frames ride
    MQTT without paying a connect timeout each); the half-open probe is
    simply the next frame's reconnect attempt."""

    def __init__(self, location: str,
                 connect_timeout_s: float = _PIPE_CONNECT_TIMEOUT_S,
                 threshold: int = _PIPE_BREAKER_THRESHOLD,
                 cooldown_s: float = _PIPE_BREAKER_COOLDOWN_S):
        host, _, port = str(location).rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"tensor pipe endpoint {location!r}: "
                             f"expected host:port")
        self.location = str(location)
        self.host, self.port = host, int(port)
        self._connect_timeout_s = float(connect_timeout_s)
        self.breaker = CircuitBreaker(threshold, cooldown_s)
        self._client = None
        self._lock = threading.Lock()
        self.frames_sent = 0
        self.bytes_sent = 0

    def send(self, token_id: str, arrays: dict) -> int | None:
        """Ship ``arrays`` under ``token_id``; returns the wire bytes
        sent, or None on failure / open breaker (the caller falls back
        to the MQTT payload path for this frame -- frames are never
        lost to a data-plane failure)."""
        if not self.breaker.allow():
            return None
        with self._lock:
            try:
                if self._client is None:
                    self._client = create_pipe_client(
                        self.host, self.port,
                        timeout=self._connect_timeout_s)
                total = 0
                for key in sorted(arrays):
                    view, tag = tag_view(np.asarray(arrays[key]))
                    meta = {"t": str(token_id), "k": str(key)}
                    if tag:
                        meta["v"] = tag
                    # send() reports the exact wire bytes (prefix +
                    # header + payload) -- the bench's byte accounting.
                    total += self._client.send(view,
                                               name=json.dumps(meta))
            except (ConnectionError, OSError) as error:
                self._drop_client()
                self.breaker.record_failure()
                _logger.warning("tensor pipe send to %s failed (%s); "
                                "frame falls back to MQTT",
                                self.location, error)
                return None
            self.breaker.record_success()
            self.frames_sent += 1
            self.bytes_sent += total
            return total

    def _drop_client(self) -> None:
        client, self._client = self._client, None
        if client is not None:
            try:
                client.close()
            except Exception:
                pass

    @property
    def stats(self) -> dict:
        return {"location": self.location,
                "frames_sent": self.frames_sent,
                "bytes_sent": self.bytes_sent,
                "breaker": self.breaker.state}

    def close(self) -> None:
        with self._lock:
            self._drop_client()
