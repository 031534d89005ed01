"""Device-loop blocks, run eagerly on the CPU and through one captured
CUDA graph on the card.

The JAX package jits its device-resident loop (``_decode_loop_jit``, a
``lax.while_loop``) and dispatches one compiled program per block.  The
port's ``llama.decode_loop`` is the same block as a fixed number of
masked iterations with no host synchronisation -- a few thousand kernel
launches at llama3-8b widths, which eager PyTorch would enqueue one by
one from the host for every block.  :class:`LoopRunner` captures that
launch sequence once as a ``torch.cuda.CUDAGraph`` and replays it:

- one runner per batcher, which fixes the speculative mode, the cache
  layout and payload, the ring and top-k: it captures once, and again
  only after :meth:`LoopRunner.reset` (``recover()`` rebuilds the cache)
  or when the stop-token table grows wider;
- the graph reads STATIC input buffers that the runner owns
  (``inputs``: tokens, lengths, active, budget, temperatures, eos rows
  and history).  The caller edits them in place between blocks (a
  joining request's first token and budget, a finished row's active
  flag) and uploads host mirrors through pinned memory (:meth:`upload`);
- the cache and the page table keep their storage: the runner records
  their addresses at capture and raises if a replay finds one moved
  (the batcher's page-table sync copies into the table in place);
- right after each replay the carries are copied into the inputs on
  the device, so the next block chains off this one with no host round
  trip; the outputs stay valid until the next replay, so a caller that
  needs them later enqueues their copy first (the batcher's
  ``_HostCopy``);
- the batcher's generator is registered with the graph, so every replay
  draws fresh numbers (a captured generator state replayed as it is
  would repeat the same draws every block);
- after the first replay, which is torch's, each replay launches the
  graph's exec through the CUDA runtime's ``cudaGraphLaunch`` with the
  GIL held (:func:`runtime_launch`; torch's ``replay`` releases it).  A
  profiler's stop (``torch.profiler``, which holds the GIL while it
  disables its CUDA tracing) then never meets a launch in progress on
  another thread: with the tracing on, a block's launch takes ~0.1 s,
  and a stop that began inside one deadlocked both threads.  A graph
  that draws from the batcher's generator first replays a one-draw
  ``prologue`` graph on the same generator, which writes the
  generator's seed and offset where the captured kernels read them (as
  torch's replay does), and the offset then advances by what the first
  replay took;
- the kernel wrappers count launches as Python runs them, which during
  a capture reaches no card: the runner takes the capture's counts back
  and adds them again at every replay, so the counters count launches
  that ran;
- the capture runs on whatever thread steps the batcher (the ``LLM``
  element's worker, while the pipeline's event loop goes on) in
  ``thread_local`` capture mode: a CUDA call that another thread makes
  meanwhile (an allocation, an event) neither fails nor breaks the
  capture.  Its own waits (``torch.cuda.graph`` synchronises the card
  first) are planned, so it lifts the process's synchronisation guard
  (``device.sync_allowed``) while it runs.

A PLACED tree and cache (``parallel.Placed``) capture the same way.
``decode_loop`` then runs each iteration's model work at every mesh
position, one thread a position (``parallel.shard_map``), and each
thread makes the capturing thread's current stream on every card of
the mesh its own: its kernels go to its card's stream, and a copy
between cards to the streams of both cards.  :class:`GraphCards` lays
the capture over the cards.  The runner's device is the capture card:
its capture stream (made once a runner) records the graph, and the
capture makes it current there.  Every other card of the mesh is a
FORKED card, with a stream of its own for the runner's life, made
current on that card for the capturing thread during the warm-up and
the capture; inside the capture it waits on an event of the capture
stream (the fork) and the capture stream waits on an event of it
before the capture ends (the join).  One ``torch.cuda.CUDAGraph`` then
holds every card's kernels and the copies between cards, in the order
the exchanges between positions impose, and a replay from the capture
card runs the whole block.  Allocations on a forked card during the
capture go to a graph pool on that card, which the runner holds while
its graph lives and releases at :meth:`LoopRunner.reset`: without it
the capture's blocks would return to the card's caching allocator, and
a later replay would write into memory that other tensors own.  The
warm-up runs on the same streams, so cuBLAS's workspace for each
stream, the kernels' shared-memory limits on each card and the peer
access between the cards exist before the capture; every card of the
mesh is synchronised before it begins.  A replay waits on every forked
card's current stream, and they wait on it, so the block is ordered
with the host's work on each card (admission, the page-table copies).
The ``thread_local`` mode restricts only the capturing thread, so the
position threads may make the calls a capture forbids it (the caching
allocator's, which routes their allocations to the graph's pools).

A placed tree whose mesh SPANS PROCESSES (``parallel/distributed.py``)
captures this process's positions only: :class:`GraphCards` takes this
process's cards, and no stream, event or pool is made for another's.
Each exchange with the other processes in the block takes the capture
path (``distributed.capturing``): its layout comes from the same
exchange in the warm-up, and the graph holds one
``all_gather_into_tensor`` over NCCL for it, on the current stream of
the card that sends it.  Every process replays its graph once a block,
in the order the batcher's identical schedule gives them, so each
replay's collectives pair with the peer's; after each replay the
groups' sequences are checked across the processes over gloo
(``distributed.replayed``).  Over gloo no graph can hold an exchange of
card tensors, and the capture raises.

On the CPU the same ``decode_loop`` runs eagerly on the same buffers.
On the card a capture that fails raises: there is no eager fallback.

:class:`AdmissionRunner` does the same for one admission chunk
(``llama.prefill_into_slot_at``) of an unplaced tree over a dense
cache: about a thousand launches a 512-token chunk at 7-8 B widths,
which the stepping thread would otherwise enqueue one by one for every
chunk.  Its static inputs are the chunk's tokens and ``(slot, start)``,
which the captured kernels read on the card (kernel #4 takes both from
device memory), so one graph a batcher serves every slot and every
offset.  It captures on the stepping thread as the loop does (a
``compile:admission`` span), checks the cache's addresses at each
replay, gives back the capture's launch counts and adds them at every
replay; ``reset`` drops it with the cache.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import time

import numpy as np
import torch

from . import llama
from ..device import is_local, sync_allowed
from ..ops import launch_counters
from ..parallel import distributed
from ..parallel.mesh import Placed
from ..tpu.profiling import span

__all__ = ["GraphCards", "LoopRunner", "AdmissionRunner", "runtime_launch"]

#: decode_loop's return tuple, by name (None: the generator).
OUTPUTS = ("emitted", "counts", "tokens", "lengths", "active", "budget",
           "history", None, "accepted", "drafted", "steps")
#: the outputs that chain into the next block's inputs.
CARRIES = ("tokens", "lengths", "active", "budget", "history")


def _tensors(tree):
    """Every tensor of a cache dict, int8 leaves included (every distinct
    tensor of every position of a placed cache)."""
    if isinstance(tree, Placed):
        yield from tree.tensors()
        return
    for value in tree.values():
        if isinstance(value, dict):
            yield from _tensors(value)
        else:
            yield value


@functools.cache
def runtime_launch():
    """``launch(exec, stream)``: ``cudaGraphLaunch`` of the CUDA runtime
    that torch loaded, called with the GIL held (``ctypes.PyDLL``), that
    raises on an error; None where that runtime is no loaded shared
    library (a CPU build), and the runners replay through torch."""
    major = (torch.version.cuda or "").split(".")[0]
    if not major:
        return None
    try:
        runtime = ctypes.PyDLL(f"libcudart.so.{major}",
                               mode=os.RTLD_NOLOAD | os.RTLD_LAZY)
    except OSError:
        return None
    launch = runtime.cudaGraphLaunch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    describe = runtime.cudaGetErrorString
    describe.argtypes = [ctypes.c_int]
    describe.restype = ctypes.c_char_p

    def checked(graph_exec: int, stream: int) -> None:
        code = launch(graph_exec, stream)
        if code:
            raise RuntimeError(f"cudaGraphLaunch: "
                               f"{describe(code).decode()} ({code})")
    return checked


def _card(device: torch.device) -> torch.device:
    return torch.device("cuda", device.index or 0)


class GraphCards:
    """Where a runner's graph lives, given its device and the devices of
    its tree's mesh positions (``torch.device`` descriptors; none for an
    unplaced tree): ``capture`` is the card that records and replays the
    graph (None on the CPU: no capture), ``forked`` the other cards of
    the positions, each forked from the capture stream on a stream of
    its own (made at the first :meth:`current`, kept for the runner's
    life), with a graph pool of its own.  The constructor makes no CUDA
    call."""

    def __init__(self, device: torch.device, positions=()):
        self.capture = _card(device) if device.type == "cuda" else None
        self.forked = tuple(dict.fromkeys(
            _card(d) for d in positions
            if d.type == "cuda" and _card(d) != self.capture))
        self.streams: dict | None = None
        self.pools: dict = {}

    @contextlib.contextmanager
    def current(self):
        """The capture stream (yielded) current on the capture card, each
        forked card's stream on its card (for this thread), ordered after
        the work already on those cards' current streams, and the work
        enqueued there next after them; the capture card stays the
        current device.  Inside, :meth:`fork` and :meth:`join` tie the
        forked streams to the capture stream."""
        if self.streams is None:
            self.streams = {card: torch.cuda.Stream(card)
                            for card in (self.capture, *self.forked)}
        previous = {card: torch.cuda.current_stream(card)
                    for card in self.streams}
        for card, stream in self.streams.items():
            stream.wait_stream(previous[card])
        try:
            with torch.cuda.stream(self.streams[self.capture]):
                for card in self.forked:
                    torch.cuda.set_stream(self.streams[card])
                torch.cuda.set_device(self.capture)
                try:
                    yield self.streams[self.capture]
                finally:
                    for card in self.forked:
                        torch.cuda.set_stream(previous[card])
                    torch.cuda.set_device(self.capture)
        finally:
            for card, stream in self.streams.items():
                previous[card].wait_stream(stream)

    def fork(self) -> None:
        capture = self.streams[self.capture]
        for card in self.forked:
            self.streams[card].wait_stream(capture)

    def join(self) -> None:
        capture = self.streams[self.capture]
        for card in self.forked:
            capture.wait_stream(self.streams[card])

    def synchronize(self) -> None:
        for card in (self.capture, *self.forked):
            torch.cuda.synchronize(card)

    def begin_pools(self) -> None:
        """Every forked card's allocations into a new graph pool of its
        own until :meth:`end_pools` (the capture card's go to the
        graph's own pool)."""
        for card in self.forked:
            pool = torch.cuda.graph_pool_handle()
            torch._C._cuda_beginAllocateToPool(card.index, pool)
            self.pools[card] = pool

    def end_pools(self) -> None:
        for card, pool in self.pools.items():
            torch._C._cuda_endAllocateToPool(card.index, pool)

    def release_pools(self) -> None:
        """Give the pools back (their blocks free once no tensor holds
        them)."""
        for card, pool in self.pools.items():
            torch._C._cuda_releasePool(card.index, pool)
        self.pools = {}

    @contextlib.contextmanager
    def ordered(self):
        """A replay on the capture card's current stream, ordered after
        the work on every forked card's current stream and before the
        work enqueued there next."""
        launch = torch.cuda.current_stream(self.capture)
        for card in self.forked:
            launch.wait_stream(torch.cuda.current_stream(card))
        yield
        for card in self.forked:
            torch.cuda.current_stream(card).wait_stream(launch)


class _GraphRunner:
    """What both runners share: static ``inputs`` the caller fills in
    place, one graph over a cache whose addresses it records, and the
    launch counters' take-back."""

    def __init__(self, device: torch.device, positions=()):
        self.device = device
        self.cards = GraphCards(device, positions)
        self.inputs: dict = {}
        self._graph = None
        self._outputs = None
        self._bound: tuple = ()
        self._launch_delta: dict = {}
        # the generator the graph draws from (a loop's), and how a
        # replay launches: None until the first replay, then the exec
        # and, for a graph that draws, the prologue and the offset a
        # replay takes (see _first_replay)
        self.generator: torch.Generator | None = None
        self._direct: bool | None = None
        self._exec = 0
        self._prologue = None
        self._increment = 0
        # what a serving run reports: captures, replays, capture time
        # (each capture is also a ``compile`` span)
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def upload(self, name: str, array: np.ndarray) -> None:
        """A host mirror into input ``name``, in place (pinned and
        asynchronous on the card).  A new shape (a wider eos table)
        reallocates the buffer and drops the captured graph."""
        source = torch.from_numpy(np.ascontiguousarray(array))
        target = self.inputs[name]
        if tuple(source.shape) != tuple(target.shape):
            self.inputs[name] = target = torch.empty(
                source.shape, dtype=target.dtype, device=self.device)
            self.reset()
        if self.device.type == "cuda":
            source = source.pin_memory()
        target.copy_(source, non_blocking=self.device.type == "cuda")

    def reset(self) -> None:
        """Drop the captured graph and release its pools on the forked
        cards (the cache was rebuilt, or an input buffer reallocated);
        the next :meth:`run` captures anew."""
        self._graph = None
        self._outputs = None
        self._bound = ()
        self._launch_delta = {}
        self._direct, self._exec = None, 0
        self._prologue, self._increment = None, 0
        self.cards.release_pools()

    @staticmethod
    def _pointers(cache: dict) -> tuple:
        return tuple(tensor.data_ptr() for tensor in _tensors(cache))

    @contextlib.contextmanager
    def _launches_taken_back(self):
        """The kernel wrappers' counts made inside (a capture, which
        launches nothing) taken back, to be added at every replay."""
        counters = list(launch_counters().values())
        before = [getattr(wrapper, attr) for wrapper, attr in counters]
        yield
        self._launch_delta = {}
        for (wrapper, attr), start in zip(counters, before):
            captured = getattr(wrapper, attr) - start
            setattr(wrapper, attr, start)
            if captured:
                self._launch_delta[wrapper, attr] = captured

    def _replay(self, cache: dict) -> None:
        """One replay, ordered with every card's work, its launches
        counted; a cache that moved since the capture raises."""
        if self._pointers(cache) != self._bound:
            raise RuntimeError(
                f"{type(self).__name__}: the cache or page table moved "
                f"since the graph was captured; reset() the runner after "
                f"rebuilding the cache")
        with self.cards.ordered():
            if self._direct is None:
                with sync_allowed():        # the prologue's capture
                    self._direct = self._first_replay()
            elif self._direct:
                self._launch()
            else:
                self._graph.replay()
        for (wrapper, attr), count in self._launch_delta.items():
            setattr(wrapper, attr, getattr(wrapper, attr) + count)
        self.replays += 1

    def _first_replay(self) -> bool:
        """Torch's replay, and whether the later ones launch the exec
        themselves: yes where the runtime is a loaded library and the
        only offset this replay took from a generator is the runner's
        own generator's (none from the card's default generator), which
        the prologue graph and an advance re-create."""
        generators = [torch.cuda.default_generators[self.cards.capture.index]]
        if self.generator is not None:
            generators.append(self.generator)
        before = [generator.get_offset() for generator in generators]
        self._graph.replay()
        taken = [generator.get_offset() - offset
                 for generator, offset in zip(generators, before)]
        exec_of = getattr(self._graph, "raw_cuda_graph_exec", None)
        if runtime_launch() is None or exec_of is None or taken[0]:
            return False
        self._exec = exec_of()
        self._increment = sum(taken[1:])
        if self._increment:
            self._prologue = torch.cuda.CUDAGraph()
            self._prologue.register_generator_state(self.generator)
            with self.cards.current() as stream, torch.cuda.graph(
                    self._prologue, stream=stream,
                    capture_error_mode="thread_local"):
                torch.rand(1, generator=self.generator,
                           device=self.cards.capture)
        return True

    def _launch(self) -> None:
        """The exec onto the capture card's current stream, with the GIL
        held; a graph that draws gets the generator's seed and offset
        written first (the prologue's replay), then the offset advanced
        by a replay's draws."""
        stream = torch.cuda.current_stream(self.cards.capture).cuda_stream
        if self._prologue is not None:
            offset = self.generator.get_offset()
            self._prologue.replay()
        runtime_launch()(self._exec, stream)
        if self._prologue is not None:
            self.generator.set_offset(offset + self._increment)


class LoopRunner(_GraphRunner):
    """``decode_loop`` blocks for one batch of ``batch`` rows: see the
    module docstring.  ``history_width`` is the ngram window (1 for the
    other modes); ``generator`` draws every sample."""

    def __init__(self, params: dict, config: llama.LlamaConfig, *,
                 batch: int, ring: int, speculative: str, spec_tokens: int,
                 spec_window: int, draft: dict | None, top_k: int,
                 generator: torch.Generator, history_width: int,
                 device: torch.device):
        placed = isinstance(params, Placed)
        super().__init__(device, [
            d for d in params.mesh.devices.flat if is_local(d)]
            if placed else ())
        self.params, self.config, self.draft = params, config, draft
        self.options = dict(ring=int(ring), speculative=speculative,
                            spec_tokens=int(spec_tokens),
                            spec_window=int(spec_window), top_k=int(top_k))
        self.generator = generator
        # A mesh over processes: its exchanges in the graph, their count.
        self.spans = placed and distributed.spans_processes(params.mesh)
        self._exchanges: distributed.Captured | None = None

        def zeros(dtype, *shape):
            return torch.zeros((batch, *shape), dtype=dtype, device=device)
        self.inputs = {
            "tokens": zeros(torch.int32), "lengths": zeros(torch.int32),
            "active": zeros(torch.bool), "budget": zeros(torch.int32),
            "temperatures": zeros(torch.float32),
            "eos": zeros(torch.int32, 1) - 1,
            "history": zeros(torch.int32, history_width) - 1}

    def reset(self) -> None:
        super().reset()
        self._exchanges = None

    def _loop(self, cache: dict, inputs: dict, **overrides) -> dict:
        out = llama.decode_loop(
            self.params, self.config, inputs["tokens"], cache,
            inputs["lengths"], inputs["active"], inputs["budget"],
            inputs["temperatures"], inputs["eos"], inputs["history"],
            self.generator, draft=self.draft,
            **{**self.options, **overrides})
        return {name: value for name, value in zip(OUTPUTS, out) if name}

    def run(self, cache: dict) -> dict:
        """One block from the current inputs: the outputs by name
        (``emitted``, ``counts``, the carries, ``accepted``, ``drafted``,
        ``steps``), the carries already copied into the inputs.  On the
        card the outputs are the graph's buffers, valid until the next
        run."""
        if self.device.type != "cuda":
            outputs = self._loop(cache, self.inputs)
        else:
            if self._graph is None:
                with sync_allowed(), span("compile", name="loop"):
                    self._capture(cache)    # its waits are planned
            self._replay(cache)
            if self._exchanges is not None:
                distributed.replayed(self._exchanges)
            outputs = self._outputs
        for name in CARRIES:
            if outputs[name] is not self.inputs[name]:
                self.inputs[name].copy_(outputs[name])
        return outputs

    def _capture(self, cache: dict) -> None:
        """Warm up, then capture one block on the current inputs, every
        card's work forked from the capture stream and joined back."""
        begin = time.perf_counter()
        cards = self.cards
        if self.spans and distributed.transport() != "nccl":
            raise RuntimeError(
                "LoopRunner: a capture over a mesh that spans processes "
                "needs NCCL; the transport is gloo (the processes share a "
                "card), and no graph can hold a gloo exchange of card "
                "tensors")
        # Warm-up outside the capture, on the capture's own streams: one
        # iteration with every row inactive (writes only the trash
        # position) loads the kernel library, sets the kernels'
        # shared-memory limits on each card, enables peer access and
        # initialises cuBLAS for each stream before the capture records
        # anything.
        warm = {name: tensor.clone() for name, tensor in self.inputs.items()}
        warm["active"].zero_()
        spec = self.options["speculative"] != "off"
        with cards.current():
            cards.fork()
            self._loop(cache, warm,
                       ring=self.options["spec_tokens"] + 1 if spec else 1)
            cards.join()
        cards.synchronize()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        exchanges = distributed.capturing() if self.spans \
            else contextlib.nullcontext()
        with self._launches_taken_back():
            cards.begin_pools()
            try:
                with cards.current() as stream, torch.cuda.graph(
                        graph, stream=stream,
                        capture_error_mode="thread_local"), \
                        exchanges as record:
                    cards.fork()
                    outputs = self._loop(cache, self.inputs)
                    cards.join()
            except BaseException:
                cards.end_pools()
                cards.release_pools()
                raise
            cards.end_pools()
        self._graph, self._outputs = graph, outputs
        self._exchanges = record
        self._bound = self._pointers(cache)
        self.captures += 1
        self.capture_s += time.perf_counter() - begin


class AdmissionRunner(_GraphRunner):
    """One admission chunk of ``chunk`` tokens
    (``llama.prefill_into_slot_at``) for an unplaced tree over a dense
    cache, captured once and replayed for any slot and start: see the
    module docstring.  Its inputs are ``tokens`` [1, chunk] int64 and
    ``at`` [2] int32 (slot, start); its output the logits buffer."""

    def __init__(self, params: dict, config: llama.LlamaConfig, *,
                 chunk: int, device: torch.device):
        super().__init__(device)
        self.params, self.config = params, config
        self.inputs = {
            "tokens": torch.zeros((1, chunk), dtype=torch.int64,
                                  device=device),
            "at": torch.zeros(2, dtype=torch.int32, device=device)}

    def _chunk(self, cache: dict) -> torch.Tensor:
        return llama.prefill_into_slot_at(
            self.params, self.config, self.inputs["tokens"], cache,
            self.inputs["at"])[0]

    def run(self, cache: dict, tokens, slot: int, start: int) \
            -> torch.Tensor:
        """The chunk ``tokens`` ([1, chunk] on the host) at ``(slot,
        start)`` -> its logits [1, chunk, vocab] (the graph's buffer,
        valid until the next run), the cache written.  A card only: off
        one, call ``llama.prefill_into_slot_at`` itself."""
        if self.device.type != "cuda":
            raise RuntimeError(f"AdmissionRunner captures on a CUDA card, "
                               f"not on {self.device}")
        self.upload("tokens", np.asarray(tokens, dtype=np.int64))
        self.upload("at", np.array([slot, start], dtype=np.int32))
        if self._graph is None:
            with sync_allowed(), span("compile", name="admission"):
                self._capture(cache)        # its waits are planned
        self._replay(cache)
        return self._outputs

    def _capture(self, cache: dict) -> None:
        """Warm up on the capture stream (the chunk in the inputs, whose
        cache writes the replay repeats bit for bit), then capture it."""
        begin = time.perf_counter()
        cards = self.cards
        with cards.current():
            self._chunk(cache)
        cards.synchronize()
        graph = torch.cuda.CUDAGraph()
        with self._launches_taken_back(), cards.current() as stream, \
                torch.cuda.graph(graph, stream=stream,
                                 capture_error_mode="thread_local"):
            outputs = self._chunk(cache)
        self._graph, self._outputs = graph, outputs
        self._bound = self._pointers(cache)
        self.captures += 1
        self.capture_s += time.perf_counter() - begin
