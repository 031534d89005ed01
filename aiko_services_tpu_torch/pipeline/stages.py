"""Stage-parallel execution over placed submeshes (ISSUE 3 tentpole).

PR 1 overlapped frames within a stream and PR 2 fused device chains into
single dispatches, but a multi-stage *placed* pipeline (``placement:``
blocks -> :class:`~.tensor.StagePlacement` submeshes) still walked every
frame stage-by-stage on one event-loop turn: while frame k occupied the
LLM stage's chips, the detect stage's chips idled.  Profiled model
segmentation across multi-TPU systems (arXiv:2503.01025) and
topology-aware auto-parallel placement (AoiZora, arXiv:2606.17566) both
identify stage balance + inter-stage hop locality as where the remaining
end-to-end throughput lives.  This module makes placed stages execute
like a hardware pipeline:

- :class:`StageScheduler` keeps a **credit-based admission window per
  placed stage** (the stage-keyed analogue of PR 1's per-stream
  ``DeviceWindow``; ``stage_inflight`` pipeline parameter, default
  depth 2).  A frame admits into a stage before running its head
  element, holds the credit until the NEXT stage admits it (so a full
  downstream window backpressures upstream admissions, exactly like
  pipeline stall propagation in hardware), and frames denied admission
  queue FIFO and resume when a credit frees.  Admission happens on a
  fresh mailbox turn, so frame k+1's upstream stage work interleaves
  with frame k's downstream stage on the same event loop.
- :class:`StageExecutor` gives each placed stage **one FIFO worker
  thread**: synchronous stage-head elements (and stage-local fused
  segments) execute there instead of on the event loop, parking the
  frame like an async element and resuming through the mailbox.  While
  frame k blocks on the LLM submesh's result, the event loop is free to
  walk frame k+1 onto the detect submesh -- cross-stage pipelining of
  plain synchronous elements, with per-stream order preserved by the
  FIFO queue.  Async elements keep their own admission discipline
  (MicroBatcher/ContinuousBatcher); the engine releases the stage
  credit when a frame parks at one.
- Per-stage **occupancy accounting** (busy-time integration over a
  resettable window) feeds the ``stage_occupancy_*`` bench keys and the
  profiler's ``stage:`` spans -- the direct evidence that two stages
  ran concurrently.
- :class:`ReplicaGroup` (ISSUE 7) generalizes the admission window for
  **replicated stages** (``placement: {..., replicas: N}``): N
  data-parallel replica submeshes each get their own credit window and
  FIFO worker, frames round-robin across the live replicas, and the
  reorder buffer merges completions back to ingest order.  A dead
  replica stops admitting and its in-flight frames shed to the peers
  (the engine's ``fail_replica`` replay path); a rebuilt replica
  re-admits half-open behind a single canary frame, breaker-style.

Scope note: stage credits are held in graph-path order and released
forward, so admission is deadlock-free on acyclic paths.  A Loop element
that jumps BACK across two placed stages while both windows are full
could stall; placed stages inside loop bodies should size
``stage_inflight`` above the loop's frame concurrency.

In-order delivery: stage-parallel frames complete out of walk order
(async stages, per-stage workers), so the engine assigns every ingested
frame a per-stream delivery sequence and buffers responses until all
predecessors responded (``Pipeline._deliver``) -- callers see ingest
order, always.
"""

from __future__ import annotations

import time

from collections import deque
from concurrent.futures import ThreadPoolExecutor

from ..utils import get_logger

__all__ = ["ReplicaGroup", "StageScheduler", "StageExecutor",
           "STAGE_INFLIGHT_DEFAULT", "STAGE_PIPELINE_MODES",
           "REPLICA_LIVE", "REPLICA_DEAD", "REPLICA_HALF_OPEN"]

_logger = get_logger("aiko.stages")

# Replica slot states (ISSUE 7).  ``half_open`` is the breaker-style
# canary state a rebuilt replica re-admits through: exactly ONE frame
# is admitted; its success closes the slot to ``live``, its failure
# re-kills it.
REPLICA_LIVE = "live"
REPLICA_DEAD = "dead"
REPLICA_HALF_OPEN = "half_open"

# Default per-stage admission window (double buffering: one frame
# executing on the stage's submesh, one hopping/queued behind it).
# Override with the ``stage_inflight`` pipeline parameter.
STAGE_INFLIGHT_DEFAULT = 2

STAGE_PIPELINE_MODES = ("auto", "off")


class StageExecutor:
    """One FIFO worker thread for one placed stage (a thin wrapper over
    ``ThreadPoolExecutor(max_workers=1)``).

    Jobs are closures the engine builds (element call or fused-segment
    dispatch + a mailbox post of the continuation); the single thread
    serializes a stage's execution -- per-stream order through the stage
    is the queue order -- while different stages' threads run
    concurrently, which is what lets synchronous placed stages overlap
    in wall time."""

    def __init__(self, name: str):
        self.name = name
        self.executed = 0
        self._stopped = False
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"stage-{name}")

    def submit(self, job) -> None:
        if self._stopped:       # teardown: streams are already gone
            return
        self._pool.submit(self._run, job)

    def _run(self, job) -> None:
        try:
            job()
        except Exception:           # jobs carry their own error path;
            _logger.exception(      # this is the backstop
                "stage %s: worker job raised", self.name)
        self.executed += 1

    def stall(self, seconds: float) -> None:
        """Chaos harness (``stage_stall`` fault point): occupy the FIFO
        worker for ``seconds`` -- every job queued behind it waits,
        exactly like a stage whose chips went quiet mid-stream.  Rides
        the normal queue, so ordering invariants still hold."""
        delay = float(seconds)
        _logger.warning("stage %s: injected %.0f ms worker stall",
                        self.name, delay * 1000.0)
        self.submit(lambda: time.sleep(delay))

    def stop(self):
        self._stopped = True
        self._pool.shutdown(wait=False)


class ReplicaGroup:
    """Admission state for one replicated stage (ISSUE 7): a credit
    window PER replica, round-robin admission across the live slots,
    and the dead / half-open (canary) lifecycle the failover and
    rebuild paths drive.

    Owned by the event loop like the scheduler -- no locking.  The
    group only decides WHICH replica admits a frame; the stage-level
    FIFO wait queue, reservations and backpressure stay in
    :class:`StageScheduler` (a queued frame wakes when ANY replica
    frees a credit, so the queue cannot strand behind a dead slot)."""

    def __init__(self, stage: str, count: int,
                 depth: int = STAGE_INFLIGHT_DEFAULT):
        self.stage = stage
        self.depth = max(1, int(depth))
        self.states: list[str] = [REPLICA_LIVE] * max(1, int(count))
        self.active: list[int] = [0] * len(self.states)
        self.admitted: list[int] = [0] * len(self.states)
        self._rr = 0                    # round-robin cursor
        self.failovers = 0
        self.rebuilds = 0
        self.canary_inflight: list[bool] = [False] * len(self.states)
        # Per-replica busy-time integration (same windowed discipline
        # as the scheduler's per-stage occupancy).
        self._busy: list[float] = [0.0] * len(self.states)
        self._busy_since: list[float | None] = [None] * len(self.states)
        self._window_start = time.monotonic()
        self.transitions: list[tuple] = []   # (slot, state, monotonic)

    # -- admission ---------------------------------------------------------

    def free_slots(self) -> int:
        """Credits currently grantable across live slots (a half-open
        slot counts at most its single canary)."""
        free = 0
        for index, state in enumerate(self.states):
            if state == REPLICA_LIVE:
                free += max(0, self.depth - self.active[index])
            elif state == REPLICA_HALF_OPEN \
                    and not self.canary_inflight[index] \
                    and self.active[index] == 0:
                free += 1
        return free

    def pick(self, least_loaded: bool = False) -> int | None:
        """Next replica to admit into (round-robin over live slots with
        a free credit; a half-open slot admits exactly one canary), or
        None when every slot is full/dead.  ``least_loaded`` (the QoS
        plane, ISSUE 12: latency-sensitive classes) picks the live
        slot with the fewest in-flight frames instead of the cursor's
        next -- head-of-line latency over round-robin fairness; the
        canary discipline is unchanged (a half-open slot only ever
        admits through the round-robin walk below)."""
        count = len(self.states)
        if least_loaded:
            # A canary-ready half-open slot is probed FIRST: under
            # pure latency-sensitive traffic the least-loaded branch
            # would otherwise always find a free live credit and the
            # rebuilt replica would stay half-open (N-1 capacity)
            # until a saturation burst -- closing it back to live is
            # what latency-sensitive traffic needs most.
            for index in range(count):
                if self.states[index] == REPLICA_HALF_OPEN \
                        and not self.canary_inflight[index] \
                        and self.active[index] == 0:
                    self._rr = index + 1
                    return index
            best = None
            for index in range(count):
                if self.states[index] == REPLICA_LIVE \
                        and self.active[index] < self.depth \
                        and (best is None
                             or self.active[index] < self.active[best]):
                    best = index
            if best is not None:
                self._rr = best + 1
                return best
        for offset in range(count):
            index = (self._rr + offset) % count
            state = self.states[index]
            if state == REPLICA_LIVE \
                    and self.active[index] < self.depth:
                self._rr = index + 1
                return index
            if state == REPLICA_HALF_OPEN \
                    and not self.canary_inflight[index] \
                    and self.active[index] == 0:
                self._rr = index + 1
                return index
        return None

    def admit(self, index: int) -> None:
        if self.states[index] == REPLICA_HALF_OPEN:
            self.canary_inflight[index] = True
        self.active[index] += 1
        self.admitted[index] += 1
        if self.active[index] == 1:
            self._busy_since[index] = time.monotonic()

    def release(self, index: int, ok: bool | None = True) -> None:
        """Return a replica credit.  A half-open slot's canary outcome
        decides its fate: success closes it live (full re-admission),
        failure re-kills it.  ``ok=None`` is NO verdict (the canary
        frame was yanked administratively -- replayed off a different
        stage's failure -- before this stage could prove anything): the
        slot stays half-open and the next admission is its canary."""
        if index >= len(self.states):
            return
        if self.active[index] > 0:
            self.active[index] -= 1
            if self.active[index] == 0 \
                    and self._busy_since[index] is not None:
                self._busy[index] += \
                    time.monotonic() - self._busy_since[index]
                self._busy_since[index] = None
        if self.states[index] == REPLICA_HALF_OPEN \
                and self.canary_inflight[index]:
            self.canary_inflight[index] = False
            if ok is not None:
                self._transition(index,
                                 REPLICA_LIVE if ok else REPLICA_DEAD)

    # -- lifecycle ---------------------------------------------------------

    def _transition(self, index: int, state: str) -> None:
        self.states[index] = state
        self.transitions.append((index, state, time.monotonic()))

    def fail(self, index: int) -> None:
        if index < len(self.states) \
                and self.states[index] != REPLICA_DEAD:
            self.failovers += 1
            self.canary_inflight[index] = False
            self._transition(index, REPLICA_DEAD)

    def rebuild(self, count: int, half_open=()) -> None:
        """Reset the group after a placement rebuild/re-split: every
        slot becomes live except the ``half_open`` indices, which
        re-admit behind a single canary frame each."""
        half_open = set(half_open)
        self.rebuilds += 1
        self.states = [REPLICA_HALF_OPEN if index in half_open
                       else REPLICA_LIVE
                       for index in range(max(1, int(count)))]
        self.active = [0] * len(self.states)
        self.admitted = [0] * len(self.states)
        self.canary_inflight = [False] * len(self.states)
        self._busy = [0.0] * len(self.states)
        self._busy_since = [None] * len(self.states)
        self._rr = 0
        for index in range(len(self.states)):
            self.transitions.append(
                (index, self.states[index], time.monotonic()))

    def set_depth(self, depth: int) -> None:
        """Live re-tune of the per-replica credit window (the fleet
        controller's queue-dominated actuator, ISSUE 20).  Shrinking
        never yanks an in-flight frame -- admission just stalls until
        the slot drains below the new window."""
        self.depth = max(1, int(depth))

    def reopen(self, index: int) -> bool:
        """Demote a LIVE slot back to half-open so its next admission
        is a single canary frame (the controller's canary-gated
        version swap, ISSUE 20: swap the element parameter, then prove
        the new version on one frame before full re-admission).  Dead
        and already-half-open slots are left alone; returns whether
        the transition happened."""
        if index >= len(self.states) \
                or self.states[index] != REPLICA_LIVE:
            return False
        self.canary_inflight[index] = False
        self._transition(index, REPLICA_HALF_OPEN)
        return True

    def live(self) -> int:
        return sum(1 for state in self.states if state == REPLICA_LIVE)

    def all_dead(self) -> bool:
        return all(state == REPLICA_DEAD for state in self.states)

    # -- occupancy ---------------------------------------------------------

    def reset_window(self) -> None:
        now = time.monotonic()
        for index in range(len(self.states)):
            self._busy[index] = 0.0
            if self._busy_since[index] is not None:
                self._busy_since[index] = now
        self._window_start = now

    def occupancy(self, index: int) -> float:
        wall = time.monotonic() - self._window_start
        if wall <= 0 or index >= len(self._busy):
            return 0.0
        busy = self._busy[index]
        if self._busy_since[index] is not None:
            busy += time.monotonic() - self._busy_since[index]
        return min(1.0, busy / wall)

    @property
    def stats(self) -> dict:
        return {"states": list(self.states),
                "active": list(self.active),
                "admitted": list(self.admitted),
                "live": self.live(),
                "depth": self.depth,
                "failovers": self.failovers,
                "rebuilds": self.rebuilds,
                "occupancy": [round(self.occupancy(index), 4)
                              for index in range(len(self.states))]}


class StageScheduler:
    """Credit-based per-stage admission + occupancy accounting.

    Owned by the event loop: every method except the workers' own job
    bodies runs on the pipeline's actor thread, so no locking.  The
    waiter tokens are opaque ``(stream_id, frame_id, node_name)``
    triples the engine re-posts as ``enter_stage_frame`` continuations.
    """

    def __init__(self, stages, depth: int = STAGE_INFLIGHT_DEFAULT,
                 replicas: dict | None = None, qos=None,
                 on_promote=None):
        self.depth = max(1, int(depth))
        self.stages = list(stages)
        # Unified QoS admission (ISSUE 12): when the pipeline carries a
        # QosScheduler, waiter pops rank by (class, ingest seq) instead
        # of FIFO -- an interactive frame overtakes queued batch frames
        # at the credit window, the second of the four former admission
        # planes.  ``on_promote(stream_id, frame)`` fires the first
        # time a frame's near-deadline promotion decides a pop (the
        # engine records/counts it).
        self._qos = qos
        self._on_promote = on_promote
        # Replicated stages (ISSUE 7): stage -> ReplicaGroup.  The
        # group owns per-replica credits; the per-stage counters below
        # keep tracking the TOTAL so occupancy/stats stay uniform.
        self.groups: dict[str, ReplicaGroup] = {
            stage: ReplicaGroup(stage, count, self.depth)
            for stage, count in (replicas or {}).items()}
        self._active: dict[str, int] = {s: 0 for s in self.stages}
        self._waiters: dict[str, deque] = {s: deque() for s in self.stages}
        # Credits promised to POPPED waiter tokens whose resume posts
        # are still in the mailbox: fresh admissions must not steal
        # them, or a later frame overtakes an earlier one through the
        # stage (the reorder buffer would still order the RESPONSES,
        # but a stateful stage element would see frames out of order).
        self._reserved: dict[str, int] = {s: 0 for s in self.stages}
        self._executors: dict[str, StageExecutor] = {}
        # Occupancy: integrate the time each stage has >= 1 admitted
        # frame, over a resettable window (bench resets at the start of
        # its timed pass).
        self._busy: dict[str, float] = {s: 0.0 for s in self.stages}
        self._busy_since: dict[str, float | None] = \
            {s: None for s in self.stages}
        self._window_start = time.monotonic()
        self.admitted: dict[str, int] = {s: 0 for s in self.stages}
        self.queued: dict[str, int] = {s: 0 for s in self.stages}

    # -- workers -----------------------------------------------------------

    def executor(self, stage: str,
                 replica: int | None = None) -> StageExecutor:
        """The stage's FIFO worker -- or, for a replicated stage, the
        worker of ONE replica (each replica serializes its own submesh
        while peers run concurrently: that concurrency IS the dp-N
        speedup)."""
        key = stage if replica is None else (stage, replica)
        worker = self._executors.get(key)
        if worker is None:
            name = stage if replica is None else f"{stage}#{replica}"
            worker = self._executors[key] = StageExecutor(name)
        return worker

    # -- admission window --------------------------------------------------

    def set_depth(self, depth: int) -> None:
        """Live re-tune of the stage credit window (fleet controller,
        ISSUE 20).  Growing frees credits immediately -- the caller
        must walk ``_pump_stage`` to wake queued waiters into them;
        shrinking stops admitting until in-flight frames drain below
        the new window (nothing is yanked)."""
        self.depth = max(1, int(depth))
        for group in self.groups.values():
            group.set_depth(self.depth)

    def try_admit(self, stage: str, reserved: bool = False) -> bool:
        """``reserved`` marks the admission attempt of a popped waiter
        token, which consumes its reservation; a fresh attempt may only
        take capacity BEYOND the outstanding reservations (the reserved
        credits belong to earlier queued frames), but genuinely free
        surplus stays usable."""
        if reserved:
            self.cancel_reservation(stage)
        elif self._active.get(stage, 0) \
                + self._reserved.get(stage, 0) >= self.depth:
            return False
        if self._active.get(stage, 0) >= self.depth:
            return False
        self._count_admit(stage)
        return True

    def _count_admit(self, stage: str) -> None:
        self._active[stage] = self._active.get(stage, 0) + 1
        self.admitted[stage] = self.admitted.get(stage, 0) + 1
        if self._active[stage] == 1:
            self._busy_since[stage] = time.monotonic()

    def admit_replica(self, stage: str, reserved: bool = False,
                      least_loaded: bool = False) -> int | None:
        """Replicated-stage admission: returns the replica index the
        frame admits into (round-robin over live slots with a free
        per-replica credit; ``least_loaded`` for latency-sensitive QoS
        classes), or None when the group is full.  The reservation
        discipline mirrors ``try_admit`` -- a fresh attempt may only
        take capacity beyond the credits promised to popped waiter
        tokens."""
        group = self.groups[stage]
        if reserved:
            self.cancel_reservation(stage)
        elif group.free_slots() <= self._reserved.get(stage, 0):
            return None
        index = group.pick(least_loaded=least_loaded)
        if index is None:
            return None
        group.admit(index)
        self._count_admit(stage)
        return index

    def cancel_reservation(self, stage: str) -> None:
        if self._reserved.get(stage, 0) > 0:
            self._reserved[stage] -= 1

    def enqueue(self, stage: str, token, front: bool = False) -> None:
        """FIFO wait queue for a full stage; ``front`` requeues a token
        whose freed credit was stolen by an interleaving admission, so
        queue order (and per-stream frame order) is preserved."""
        waiters = self._waiters.setdefault(stage, deque())
        if front:
            waiters.appendleft(token)
        else:
            self.queued[stage] = self.queued.get(stage, 0) + 1
            waiters.append(token)

    def release(self, stage: str, replica: int | None = None,
                ok: bool | None = True):
        """Return one credit (the given replica's, for a replicated
        stage -- ``ok`` carries the canary verdict for a half-open
        slot); returns the next waiter token to resume (or None)."""
        group = self.groups.get(stage)
        if group is not None and replica is not None:
            group.release(replica, ok=ok)
        if self._active.get(stage, 0) > 0:
            self._active[stage] -= 1
            if self._active[stage] == 0 \
                    and self._busy_since.get(stage) is not None:
                self._busy[stage] = self._busy.get(stage, 0.0) + \
                    time.monotonic() - self._busy_since[stage]
                self._busy_since[stage] = None
        return self.next_waiter(stage)

    def _has_capacity(self, stage: str) -> bool:
        group = self.groups.get(stage)
        if group is not None:
            return group.free_slots() > self._reserved.get(stage, 0)
        return self._active.get(stage, 0) \
            + self._reserved.get(stage, 0) < self.depth

    def next_waiter(self, stage: str):
        """Pop the next waiter when an unreserved credit is available
        (used both on release and when a popped waiter turned out
        dead); the popped token takes a reservation on that credit
        until its admission post lands.  Without a QosScheduler the
        pop is FIFO exactly as before; with one it picks the
        best-ranked waiter -- (effective class, ingest seq), so
        priority reorders across streams while same-class tokens keep
        arrival order and a front-requeued token (stolen credit) still
        wins its class on the seq tiebreak."""
        waiters = self._waiters.get(stage)
        if waiters and self._has_capacity(stage):
            self._reserved[stage] = self._reserved.get(stage, 0) + 1
            if self._qos is not None and len(waiters) > 1:
                return self._pop_ranked(waiters)
            return waiters.popleft()
        return None

    def _pop_ranked(self, waiters: deque):
        """Remove and return the best-ranked waiter token (tokens are
        ``[stream_id, frame_id, node_name, True, frame]`` lists; the
        Frame rides last).  Promotion decisions surface through
        ``on_promote`` exactly once per frame."""
        now = time.monotonic()
        best_index, best_rank = 0, None
        for index, token in enumerate(waiters):
            frame = token[-1]
            promoted_before = getattr(frame, "qos_promoted", False)
            rank = self._qos.rank_frame(frame, now)
            if not promoted_before \
                    and getattr(frame, "qos_promoted", False) \
                    and self._on_promote is not None:
                self._on_promote(token[0], frame)
            if best_rank is None or rank < best_rank:
                best_index, best_rank = index, rank
        token = waiters[best_index]
        del waiters[best_index]
        return token

    def waiting(self, stage: str) -> int:
        return len(self._waiters.get(stage, ()))

    def active(self, stage: str) -> int:
        return self._active.get(stage, 0)

    # -- occupancy ---------------------------------------------------------

    def reset_window(self) -> None:
        now = time.monotonic()
        for stage in self.stages:
            self._busy[stage] = 0.0
            if self._busy_since.get(stage) is not None:
                self._busy_since[stage] = now
        for group in self.groups.values():
            group.reset_window()
        self._window_start = now

    def occupancy(self, stage: str) -> float:
        wall = time.monotonic() - self._window_start
        if wall <= 0:
            return 0.0
        busy = self._busy.get(stage, 0.0)
        if self._busy_since.get(stage) is not None:
            busy += time.monotonic() - self._busy_since[stage]
        return min(1.0, busy / wall)

    # -- reporting ---------------------------------------------------------

    def _executed(self, stage: str) -> int:
        """Worker jobs completed for a stage, summed over its replica
        workers when replicated."""
        return sum(worker.executed
                   for key, worker in self._executors.items()
                   if key == stage
                   or (isinstance(key, tuple) and key[0] == stage))

    @property
    def stats(self) -> dict:
        result = {}
        for stage in self.stages:
            entry = {"active": self._active.get(stage, 0),
                     "admitted": self.admitted.get(stage, 0),
                     "queued": self.queued.get(stage, 0),
                     "waiting": self.waiting(stage),
                     "reserved": self._reserved.get(stage, 0),
                     "depth": self.depth,
                     # Worker jobs the stage's executor completed --
                     # with "admitted" this localizes a stall to
                     # admission (credits) vs execution (worker).
                     "executed": self._executed(stage),
                     "occupancy": round(self.occupancy(stage), 4)}
            group = self.groups.get(stage)
            if group is not None:
                entry["replicas"] = group.stats
            result[stage] = entry
        return result

    def stop(self):
        for worker in self._executors.values():
            worker.stop()
        self._executors.clear()
