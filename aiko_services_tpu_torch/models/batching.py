"""Continuous batching for LLM serving (BASELINE config 3) on PyTorch.

Counterpart of ``ContinuousBatcher`` in
``aiko_services_tpu/models/batching.py``; the host scheduling is the
same code:

- ``max_slots`` sequences decode together as one [B] ``decode_step``;
- admission is chunked and interleaved: prompt tokens are written one
  ``prefill_chunk`` at a time straight into the admitted slot's row of
  the batched cache (``llama.prefill_into_slot``).  With
  ``decode_block == 1`` each ``step()`` prefills at most one chunk;
  with ``decode_block > 1`` every admitting slot advances one chunk per
  step (dense attention batches the burst through
  ``llama.prefill_into_slots``).  On a card, for an unplaced tree over
  a dense cache of raw k/v, a single-slot chunk replays one captured
  CUDA graph (``loop_graph.AdmissionRunner``) that reads the slot and
  the start on the card, so the stepping thread enqueues one launch a
  chunk instead of about a thousand;
- finished sequences (EOS, token budget or cache boundary) free their
  slot immediately;
- with ``decode_block > 1`` decode is pipelined: ``inflight`` fused
  blocks are enqueued back to back on the device's current CUDA stream,
  each chained off the previous block's device-side tokens and lengths,
  and the emitted tokens come back by an asynchronous copy into pinned
  host memory that the retire waits on through a CUDA event.  Tokens a
  request emits past its EOS or budget inside an in-flight block are
  discarded host-side;
- with ``kv_page_tokens > 0`` the KV cache is PAGED (models/paged.py):
  slots borrow fixed-size pages from a shared pool as their sequences
  grow, a finished or evicted slot returns them, and a pool smaller
  than full provisioning (``kv_pages``) preempts the youngest occupant
  under pressure (it resumes later from its committed tokens).  Dirty
  page-table rows reach the device as one copy enqueued on the current
  stream, after the blocks already in flight; with blocks in flight an
  allocation that needs an eviction waits for them to retire;
- ``prefix_cache`` (paged only) lets a request whose prompt starts with
  indexed whole pages adopt them read-only and skip their prefill;
- with ``decode_block_tokens > 0`` generation is DEVICE RESIDENT:
  ``step()`` dispatches ``llama.decode_loop`` blocks -- sampling,
  per-slot stop detection (EOS, budget, cache boundary) and an
  emitted-token ring on the device, captured once as a CUDA graph and
  replayed (``models/loop_graph.py``) -- and the host pays one fetch per
  retired block (the ``fetch`` hook) instead of one round trip per
  token.  Admission and eviction happen at block boundaries;
  ``speculative: ngram|draft`` adds multi-token decoding on the chunk
  verify kernel, with acceptance counted on the device;
- ``recover()`` rebuilds the device state after a failed block and
  resumes every live request from its committed tokens;
  ``export_state()``/``import_state()`` hand live requests to another
  batcher at their committed prefix;
- ``params`` may be a tree placed on a mesh (``plan.put(params,
  quantize_specs(partition_specs(config)))``, a ``parallel.Placed``):
  ``cache_put`` then places every cache the batcher builds -- the
  serving cache, the speculation probe's and ``recover()``'s -- as the
  JAX package's ``cache_put`` does (without one, by
  ``llama.cache_specs`` or ``llama.paged_cache_specs``), and every
  loop runs the model's placed entry points: admission writes each
  slot where its dp group holds it, the decode steps run at every
  position on its shards, the page table is written at every position,
  and the device loop is captured with every position's work.  The mesh
  may span processes (``parallel/distributed.py``): every process then
  builds the same batcher, submits the same requests in the same order
  and steps it as often; each runs its own positions, samples the whole
  rows from the whole logits on its home device (its first device of
  the mesh) with its own generator, seeded alike, and ends with the
  same host state.  The one decision read from a clock, ``speculative:
  auto``'s probe, is agreed over the processes.  The captured loop
  needs NCCL: over gloo (processes sharing a card) it raises.

Spans (``tpu/profiling.py``, into the process ring
``observability.recorder.process_recorder``): a request's lifecycle,
one of each, each starting where the last ended -- ``request.queue``
(submit to its slot), ``request.admission`` (to its last chunk
written), ``request.first`` (to its first token) and
``request.decode`` (to its finish), with the same stamps in
:meth:`ContinuousBatcher.take_request_stats`; and the step's leaves:
``batcher.prefill`` (one admission pass, info ``rows``: slot, start and
real length a row, and ``graph``: whether a captured chunk was replayed,
:func:`captures_admission`), ``batcher.dispatch`` (one block launched, info
``slots``), ``batcher.fetch`` (a retire's wait for the block's host
copy) and ``batcher.emit`` (its de-multiplexing).

:class:`MicroBatcher` and :class:`MicroBatchElement` (cross-stream
micro-batching for async pipeline elements, the ``Detector``'s) are the
JAX package's code, with the micro-batcher's spans added:
``microbatch.wait`` an entry (submit to its group's run),
``microbatch.run`` and ``microbatch.finish`` a group.  They hold no
device work of their own.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from . import llama
from .loop_graph import AdmissionRunner, LoopRunner
from .paged import PageAllocator, init_paged_cache, pages_per_slot
from .quant import draft_params
from ..device import resolve_device, upload
from ..parallel import distributed
from ..parallel.mesh import MeshPlan, Placed, home_device
from ..tpu.profiling import record_span, span
from ..utils.misc import next_power_of_two

__all__ = ["Request", "ContinuousBatcher", "MicroBatcher",
           "MicroBatchElement", "captures_admission", "pad_to_bucket"]

# Batched admission advances at most this many slots per tick (buckets
# stay {1, 2, 4, 8} whatever max_slots is).
_ADMISSION_BURST_MAX = 8

# ``speculative: auto`` enables draft speculation only when the startup
# micro-probe measures at least this tokens/s ratio over plain decode.
SPEC_AUTO_MIN_RATIO = 1.2
# Probe shape: one warm-up block (capture, off the clock) and timed blocks
# per arm, best-of, so one host hiccup cannot flip the verdict.
_SPEC_PROBE_BLOCKS = 3


def _knob_on(value, default: bool) -> bool:
    """on/off|true/false|bool -> bool."""
    if isinstance(value, bool):
        return value
    text = str(value).strip().lower()
    if not text:
        return default
    return text in ("on", "true", "1", "yes")


def captures_admission(device: torch.device, params, config,
                       kv_page_tokens: int) -> bool:
    """Whether a batcher replays one captured graph for its single-slot
    admission chunks (``loop_graph.AdmissionRunner``): on a card, for an
    unplaced tree over a dense cache of raw k/v.  Placed trees, paged or
    int8 caches and the batched dense-attention burst enqueue their
    chunks eagerly."""
    return (device.type == "cuda" and not isinstance(params, Placed)
            and not kv_page_tokens and config.kv_dtype != "int8")


def pad_to_bucket(rows: list, multiple: int = 1) -> list:
    """Pad a ragged admission burst to its power-of-two bucket, rounded
    up to a multiple of ``multiple`` (the dp cards a batch splits over:
    a lone frame still gives each card a row), by repeating the first
    row (idempotent device work)."""
    bucket = -(-next_power_of_two(len(rows)) // multiple) * multiple
    return list(rows) + [rows[0]] * (bucket - len(rows))


def _ms(begin: float, end: float) -> float:
    """Milliseconds between two stamps, 0 where either is missing."""
    return (end - begin) * 1e3 if begin and end else 0.0


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_tokens: list[int]
    max_new_tokens: int = 128
    temperature: float = 0.0
    eos_tokens: tuple = ()
    emit: Callable | None = None     # fn(request_id, token_id, finished)
    # runtime state
    slot: int = -1
    prefill_pos: int = 0             # prompt tokens already written
    generated: int = 0
    done: bool = False
    # resume state (see ContinuousBatcher.resume_request)
    base_prompt: list = dataclasses.field(default_factory=list)
    committed: list = dataclasses.field(default_factory=list)
    rebased: int = 0
    admit_seq: int = -1
    submit_time: float = 0.0         # ttft / tpot stamps
    slot_time: float = 0.0           # first slot assigned
    admitted_time: float = 0.0       # last admission chunk written
    first_time: float = 0.0
    # QoS admission: lower rank admits first, ties keep submission order.
    tenant: str | None = None
    qos_class: str | None = None
    qos_rank: int = 0


class _HostCopy:
    """A device tensor on its way to the host: on CUDA an asynchronous
    copy into pinned memory, completed by an event; on the CPU the
    tensor itself."""
    __slots__ = ("host", "event")

    def __init__(self, tensor: torch.Tensor):
        if tensor.device.type == "cuda":
            self.host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                    pin_memory=True)
            self.host.copy_(tensor, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(tensor.device))
        else:
            self.host = tensor
            self.event = None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _HostTree:
    """A device-loop block's result tree on its way to the host: every
    tensor's asynchronous copy is enqueued at dispatch, right after the
    block (before the next block can overwrite a captured graph's
    outputs).  ``numpy()`` waits for them and returns name -> array."""
    __slots__ = ("copies",)

    def __init__(self, tree: dict):
        self.copies = {name: _HostCopy(tensor)
                       for name, tensor in tree.items()}

    def numpy(self) -> dict:
        return {name: copy.numpy() for name, copy in self.copies.items()}


class _InflightBlock:
    """One dispatched-but-unretired fused decode block."""
    __slots__ = ("emitted", "snapshot", "firsts", "steps")

    def __init__(self, emitted, snapshot, firsts, steps):
        self.emitted = emitted        # _HostCopy of [steps, B]
        self.snapshot = snapshot      # [(slot, request)] active at dispatch
        self.firsts = firsts          # ([(slot, request)], _HostCopy) | None
        self.steps = steps


class _LoopBlock:
    """One dispatched-but-unretired device-loop block
    (``llama.decode_loop``): ``tree`` holds everything the retire reads --
    emitted ring, counts, lengths, acceptance counters, folded first
    tokens -- fetched with ONE call of the ``fetch`` hook."""
    __slots__ = ("tree", "snapshot", "firsts_meta")

    def __init__(self, tree, snapshot, firsts_meta):
        self.tree = tree              # _HostTree
        self.snapshot = snapshot      # [(slot, request)] in the block
        self.firsts_meta = firsts_meta  # [(slot, request)] admissions


class ContinuousBatcher:
    def __init__(self, params, config: llama.LlamaConfig,
                 max_slots: int = 8, max_seq: int | None = None,
                 prefill_chunk: int = 512, rng_seed: int = 0,
                 decode_block: int = 1, inflight: int = 2,
                 decode_block_tokens: int = 0, speculative: str = "off",
                 spec_tokens: int = 4, spec_window: int = 32,
                 kv_page_tokens: int = 0, kv_pages: int | None = None,
                 fetch: Callable | None = None,
                 fault_probe: Callable | None = None,
                 sample_top_k: int = 0,
                 prefix_cache: bool | str = False,
                 prefix_min_tokens: int = 64,
                 spec_autoprobe: bool | str = True,
                 on_block: Callable | None = None,
                 cache_put: Callable | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        placed = isinstance(params, Placed)
        where = home_device(params.mesh) if placed \
            else params["embed"].device
        if where.type != self.device.type:
            raise ValueError(
                f"ContinuousBatcher: params live on {where}, the batcher "
                f"on {self.device}")
        if placed:
            # Every upload, host mirror, the generator and the outputs
            # live where this process's whole logits land.
            self.device = where
        spans = placed and distributed.spans_processes(params.mesh)
        if spans and int(decode_block_tokens) > 0 \
                and self.device.type == "cuda" \
                and distributed.transport() == "gloo":
            raise RuntimeError(
                "ContinuousBatcher: decode_block_tokens > 0 captures the "
                "device loop as one CUDA graph, and the mesh spans "
                "processes over gloo -- they share a card, which NCCL "
                "refuses -- and gloo moves card tensors through host "
                "memory after a wait no graph can hold; serve these "
                "processes with decode_block_tokens=0, or give each its "
                "own cards (NCCL)")
        self.params = params
        # Multichip serving: ``cache_put`` places every cache this
        # batcher builds (the serving cache, the probe's, recover()'s).
        self._cache_put = cache_put
        self.config = config
        self.max_slots = max_slots
        self.max_seq = max_seq or config.max_seq
        self.prefill_chunk = min(prefill_chunk, self.max_seq)
        self.decode_block = max(1, int(decode_block))
        self.inflight = max(1, int(inflight))
        # Device-resident generation: > 0 sizes the emitted ring of
        # llama.decode_loop blocks (supersedes decode_block).
        self.decode_block_tokens = max(0, int(decode_block_tokens))
        self.device_loop = self.decode_block_tokens > 0
        self.speculative = str(speculative or "off").strip().lower()
        if self.speculative not in ("off", "ngram", "draft", "auto"):
            raise ValueError(f"speculative={speculative!r}: one of "
                             f"off|ngram|draft|auto")
        # ``auto`` measures draft speculation against plain decode in a
        # startup probe and enables it only on a >= SPEC_AUTO_MIN_RATIO
        # win; configs explicit ``draft`` would refuse resolve to off.
        self.spec_autoprobe = _knob_on(spec_autoprobe, default=True)
        self.spec_probe_ratio = 0.0
        if self.speculative == "auto" and (
                not self.device_loop
                or self.decode_block_tokens < max(1, int(spec_tokens)) + 1
                or not self.spec_autoprobe):
            self.speculative = "off"
        if self.speculative != "off" and not self.device_loop:
            raise ValueError(
                "speculative decoding rides the device loop: set "
                "decode_block_tokens > 0")
        self.spec_tokens = max(1, int(spec_tokens))
        if self.speculative != "off" \
                and self.decode_block_tokens < self.spec_tokens + 1:
            # The loop's room test needs one worst-case speculative
            # emission (spec_tokens + 1) to fit the ring; a smaller ring
            # would dispatch blocks that run ZERO iterations.
            raise ValueError(
                f"decode_block_tokens={self.decode_block_tokens} "
                f"cannot hold one speculative emission (spec_tokens + "
                f"1 = {self.spec_tokens + 1}); raise the ring or "
                f"lower spec_tokens")
        self.spec_window = max(4, int(spec_window))
        self.sample_top_k = max(0, int(sample_top_k))
        if self.sample_top_k > 128:
            raise ValueError(
                f"sample_top_k={self.sample_top_k}: the top-k kernel "
                f"holds at most 128 candidates; use k <= 128 (0 = "
                f"full-vocab categorical)")
        self._draft = draft_params(params) \
            if self.speculative == "draft" else None
        # Paged KV cache: fixed-size pages + per-slot page table; 0 keeps
        # the monolithic [slots, max_seq] cache.
        self.kv_page_tokens = max(0, int(kv_page_tokens))
        # Shared-prefix page cache: requests whose prompts share leading
        # pages map ONE physical copy, refcounted, and skip prefill over
        # the shared span.  Rides the page table, so it needs paging.
        self.prefix_cache = _knob_on(prefix_cache, default=False)
        self.prefix_min_tokens = max(1, int(prefix_min_tokens))
        if self.prefix_cache and not self.kv_page_tokens:
            raise ValueError(
                "prefix_cache: on shares KV at page granularity: set "
                "kv_page_tokens > 0")
        self._pages: PageAllocator | None = None
        if self.kv_page_tokens:
            pps = pages_per_slot(self.max_seq, self.kv_page_tokens)
            if self.prefill_chunk % self.kv_page_tokens:
                raise ValueError(
                    f"kv_page_tokens={self.kv_page_tokens} must divide "
                    f"prefill_chunk ({self.prefill_chunk}) so admission "
                    f"chunks stay page-aligned")
            self.cache = self._place(init_paged_cache(
                config, max_slots, self.max_seq, self.kv_page_tokens,
                kv_pages, device=self.device))
            self._pages = PageAllocator(
                llama.cache_array(self.cache).shape[1], pps, max_slots,
                prefix_cache=self.prefix_cache,
                prefix_min_tokens=self.prefix_min_tokens)
            # Host mirror of the device page table (dirty rows fold in).
            self._table_host = np.zeros((max_slots, pps), dtype=np.int32)
        else:
            self.cache = self._place(llama.init_cache(
                config, max_slots, self.max_seq, device=self.device))
        # Single-slot admission chunks replay one captured graph where
        # the path applies (:func:`captures_admission`).
        self._admission = AdmissionRunner(
            params, config, chunk=self.prefill_chunk, device=self.device) \
            if captures_admission(self.device, params, config,
                                  self.kv_page_tokens) else None
        # One fetch per retired device-loop block: ``fetch(tree)`` gets
        # the block's _HostTree and returns name -> numpy array.
        self._fetch = fetch if fetch is not None else _HostTree.numpy
        # Called before every device-loop dispatch (the "decode_block"
        # fault injection point); None = cold.
        self._fault_probe = fault_probe
        self.on_block = on_block
        self.lengths = np.zeros(max_slots, dtype=np.int32)
        self.current = np.zeros(max_slots, dtype=np.int32)
        self.temperatures = np.zeros(max_slots, dtype=np.float32)
        self.decoding = np.zeros(max_slots, dtype=bool)
        self.slots: list[Request | None] = [None] * max_slots
        self.pending: list[Request] = []
        self._prefilling: list[int] = []      # slot FIFO, round-robin
        self._generator = torch.Generator(device=self.device) \
            .manual_seed(int(rng_seed))
        # Pipelining state (decode_block > 1): device-side carries of the
        # latest dispatched block, device mirrors of the active and
        # temperature rows (re-uploaded only when they change),
        # first-token samples not yet folded into a dispatch, and the
        # in-flight block queue.
        self._chain: tuple | None = None      # (tokens_dev, lengths_dev)
        self._active_dev = None
        self._temps_dev = None
        self._pending_first: dict[int, tuple] = {}   # slot -> (req, dev)
        self._inflight: deque[_InflightBlock] = deque()
        # Device-loop state: whether the runner's inputs hold the chained
        # carries of the latest block, the in-flight loop blocks, host
        # mirrors of the per-slot stop tokens, and slots whose chained
        # active flag must drop at the next dispatch (a host-side finish,
        # cancel or eviction the device has not seen).
        self._loop: LoopRunner | None = None
        self._loop_chained = False
        self._loop_inflight: deque[_LoopBlock] = deque()
        self._eos_width = 1
        self._eos_rows = np.full((max_slots, 1), -1, dtype=np.int32)
        self._force_inactive: set[int] = set()
        # Conservative per-slot length bound for page allocation while
        # blocks are in flight.
        self._lengths_upper = np.zeros(max_slots, dtype=np.int32)
        self._admit_seq = 0
        # perf counters
        self.tokens_emitted = 0
        self.steps = 0
        self.prefill_tokens = 0
        self.blocks_dispatched = 0
        self.blocks_retired = 0
        self.accepted_tokens = 0
        self.draft_tokens = 0
        self.evictions = 0
        self.recoveries = 0
        # admission chunks written eagerly (the replays: a property)
        self.admission_eager = 0
        # Prompt tokens admission skipped because their pages were
        # adopted from the prefix index.
        self.prefix_shared_tokens = 0
        self._request_stats: list[dict] = []
        if self.speculative == "auto":
            self.spec_probe_ratio = self._spec_probe()
            if self.spec_probe_ratio >= SPEC_AUTO_MIN_RATIO:
                self.speculative = "draft"
                self._draft = draft_params(params)
            else:
                self.speculative = "off"
        if self.device_loop:
            self._loop = self._runner(self.speculative, self._draft,
                                      self._generator)

    def _place(self, cache: dict):
        """A cache the batcher built, placed by ``cache_put`` -- or, for a
        placed tree given none, on the tree's mesh by the cache's specs."""
        if self._cache_put is not None:
            return self._cache_put(cache)
        if isinstance(self.params, Placed):
            specs = llama.paged_cache_specs(self.config) \
                if self.kv_page_tokens else llama.cache_specs(self.config)
            return MeshPlan(self.params.mesh).put(cache, specs)
        return cache

    def _write_page_table(self, cache, table: np.ndarray) -> None:
        """``table`` into the cache's device page table, as one copy
        enqueued on the current stream -- into every distinct table of a
        placed cache (each position walks its own; over processes, this
        process's positions' only: every process writes the same rows)."""
        source = self._upload(table)
        if isinstance(cache, Placed):
            tables = {id(shard["page_table"]): shard["page_table"]
                      for shard in cache.shards
                      if shard is not None}.values()
        else:
            tables = [cache["page_table"]]
        for target in tables:
            target.copy_(source)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the stream
        (pinned staging, asynchronous copy)."""
        return upload(torch.from_numpy(np.ascontiguousarray(array)),
                      self.device)

    # -- admission ---------------------------------------------------------

    def submit(self, request: Request):
        if len(request.prompt_tokens) >= self.max_seq:
            request.prompt_tokens = \
                request.prompt_tokens[-(self.max_seq // 2):]
        # An empty prompt still needs one position of context.
        if not request.prompt_tokens:
            request.prompt_tokens = [0]
        request.base_prompt = list(request.prompt_tokens)
        request.submit_time = time.perf_counter()
        self.pending.append(request)

    def _next_pending(self) -> Request:
        """Pop the best ``qos_rank``; queue position breaks ties, so the
        all-default case is FIFO."""
        best = min(range(len(self.pending)),
                   key=lambda index: (self.pending[index].qos_rank,
                                      index))
        return self.pending.pop(best)

    def _admit(self):
        """Assign free slots to pending requests (no device work: the
        prompt is written chunk by chunk by ``_prefill_tick``)."""
        for slot, occupant in enumerate(self.slots):
            if occupant is not None or not self.pending:
                continue
            request = self._next_pending()
            request.slot = slot
            request.prefill_pos = 0
            if request.submit_time and not request.slot_time:
                request.slot_time = time.perf_counter()
                record_span("request.queue", request.submit_time,
                            request.slot_time, request.request_id)
            if self._pages is not None and self.prefix_cache:
                # Map the longest indexed page chain matching this prompt
                # read-only and start prefill past it.
                shared = self._pages.adopt_prefix(
                    slot, request.prompt_tokens, self.kv_page_tokens)
                if shared:
                    request.prefill_pos = shared
                    self.prefix_shared_tokens += shared
            request.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.slots[slot] = request
            self.lengths[slot] = 0
            self._lengths_upper[slot] = 0
            self.current[slot] = 0
            self.temperatures[slot] = request.temperature
            self._temps_dev = None
            self.decoding[slot] = False
            self._set_eos_row(slot, request.eos_tokens)
            self._prefilling.append(slot)

    def _set_eos_row(self, slot: int, eos_tokens) -> None:
        """Mirror one slot's stop tokens into the host eos table (uploaded
        with every device-loop dispatch; -1 pads never match a token).  A
        wider set than any seen before grows the table, and with it the
        runner's buffer (a new capture, once per width)."""
        width = max(1, len(eos_tokens or ()))
        if width > self._eos_width:
            grown = np.full((self.max_slots, width), -1, dtype=np.int32)
            grown[:, :self._eos_width] = self._eos_rows
            self._eos_rows = grown
            self._eos_width = width
        self._eos_rows[slot] = -1
        for column, token in enumerate(eos_tokens or ()):
            self._eos_rows[slot, column] = int(token)

    def _prefill_tick(self):
        """Advance admissions by one chunk each.  Pipelined path: every
        admitting slot advances (one batched pass for dense attention,
        per-slot passes for flash).  Synchronous path: at most ONE
        chunk in total, which bounds the decode stall to one chunk."""
        pipelined = self.decode_block > 1 or self.device_loop
        if (pipelined and len(self._prefilling) > 1
                and self.config.attention != "flash"):
            self._prefill_tick_batched()
            return
        budget = len(self._prefilling) if pipelined \
            else min(1, len(self._prefilling))
        for _ in range(budget):
            if not self._prefilling:
                break           # shrunk by a pressure eviction below
            slot = self._prefilling.pop(0)
            request = self.slots[slot]
            if request is None:     # cancelled or evicted while waiting
                continue
            start, chunk_tokens = self._admission_chunk(request)
            if not self._ensure_pages(slot, start + self.prefill_chunk):
                self._prefilling.append(slot)   # pool pressure: wait
                continue
            rows = ((slot, start, len(chunk_tokens)),)
            graph = self._admission is not None
            with span("batcher.prefill", info={"rows": rows,
                                               "graph": graph}):
                self._sync_page_table()
                padded = np.zeros((1, self.prefill_chunk), dtype=np.int64)
                padded[0, :len(chunk_tokens)] = chunk_tokens
                logits, self.cache = llama.prefill_into_slot(
                    self.params, self.config,
                    padded if graph else self._upload(padded), self.cache,
                    slot, start, runner=self._admission)
                if not graph:
                    self.admission_eager += 1
                self._admission_advance(slot, request, start,
                                        len(chunk_tokens), logits)

    def _prefill_tick_batched(self):
        """One chunk for every admitting slot in one batched pass, N
        padded to a power of two by repeating the first row."""
        admitting = []
        for _ in range(len(self._prefilling)):
            if not self._prefilling:
                break           # shrunk by a pressure eviction below
            slot = self._prefilling.pop(0)
            if self.slots[slot] is None:    # cancelled or evicted
                continue
            start, _ = self._admission_chunk(self.slots[slot])
            if not self._ensure_pages(slot, start + self.prefill_chunk):
                self._prefilling.append(slot)   # pool pressure: wait
                continue
            admitting.append(slot)
        # A LATER slot's ensure may have preempted an EARLIER admitted
        # one for its pages: drop evicted slots before dispatching.
        admitting = [slot for slot in admitting
                     if self.slots[slot] is not None]
        self._prefilling.extend(admitting[_ADMISSION_BURST_MAX:])
        admitting = admitting[:_ADMISSION_BURST_MAX]
        if not admitting:
            return
        with span("batcher.prefill") as prefill:
            self._sync_page_table()
            n = len(admitting)
            rows = pad_to_bucket(admitting)
            tokens = np.zeros((len(rows), self.prefill_chunk),
                              dtype=np.int64)
            starts = []
            metas = []
            for i, slot in enumerate(rows):
                request = self.slots[slot]
                start, chunk_tokens = self._admission_chunk(request)
                tokens[i, :len(chunk_tokens)] = chunk_tokens
                starts.append(start)
                metas.append((slot, request, start, len(chunk_tokens)))
            prefill.info = {"rows": tuple(
                (slot, start, chunk_len)
                for slot, _, start, chunk_len in metas[:n]), "graph": False}
            logits, self.cache = llama.prefill_into_slots(
                self.params, self.config, self._upload(tokens), self.cache,
                rows, starts)
            self.admission_eager += n
            for i, (slot, request, start, chunk_len) in enumerate(
                    metas[:n]):
                self._admission_advance(slot, request, start, chunk_len,
                                        logits[i:i + 1])

    def _admission_chunk(self, request: Request):
        """(start, chunk tokens) of the request's next prefill chunk.
        The start clamps so a full chunk always fits inside the cache; a
        clamped start rewrites the overlap with identical k/v.  Pad
        positions hold garbage k/v that decode overwrites before any
        length mask admits them."""
        start = min(request.prefill_pos,
                    self.max_seq - self.prefill_chunk)
        return start, request.prompt_tokens[
            start:start + self.prefill_chunk]

    def _admission_advance(self, slot: int, request: Request,
                           start: int, chunk_len: int, logits):
        """Account one written chunk; on the final chunk, sample the
        first generated token from the last prompt position's logits and
        hand the slot to decode (pipelined: without a host copy -- the
        sample folds into the next block dispatch)."""
        prompt = request.prompt_tokens
        self.prefill_tokens += start + chunk_len - request.prefill_pos
        request.prefill_pos = start + chunk_len
        if self._pages is not None and self.prefix_cache:
            # Index every whole prompt page now written, as admission
            # goes: even a mid-admission chain is adoptable.
            self._pages.register_prefix(slot, prompt, request.prefill_pos,
                                        self.kv_page_tokens)
        if request.prefill_pos < len(prompt):
            self._prefilling.append(slot)       # more chunks to go
            return
        last = len(prompt) - start - 1
        first = self._sample(logits[:, last, :], request.temperature)
        if request.slot_time and not request.admitted_time:
            request.admitted_time = time.perf_counter()
            record_span("request.admission", request.slot_time,
                        request.admitted_time, request.request_id)
        self.lengths[slot] = len(prompt)
        self._lengths_upper[slot] = len(prompt)
        self.decoding[slot] = True
        self._active_dev = None
        if self.device_loop or self.decode_block > 1:
            self._pending_first[slot] = (request, first)
        else:
            first_token = int(first.cpu()[0])
            self.current[slot] = first_token
            self._emit(request, first_token)

    # -- decode ------------------------------------------------------------

    def _sample(self, logits, temperature: float):
        """The first token after admission, drawn under the same
        ``sample_top_k`` restriction as every later token.  (The JAX
        package draws it from the full vocabulary, which breaks its own
        top-1 == greedy contract; ROADMAP Queue 3.)"""
        if temperature and temperature > 0:
            temps = torch.full((logits.shape[0],), float(temperature),
                               device=logits.device)
            return llama.select_tokens(self._generator, logits, temps,
                                       top_k=self.sample_top_k)
        return llama.greedy_sample(logits)

    def step(self) -> int:
        """Admit pending requests, advance prefill, dispatch/retire
        decode work, emit tokens.  Returns the number of occupied
        slots."""
        self._admit()
        self._prefill_tick()
        decoding = [i for i in range(self.max_slots) if self.decoding[i]]
        if self.device_loop:
            if decoding or self._pending_first or self._loop_inflight:
                while len(self._loop_inflight) < self.inflight:
                    if not self._dispatch_loop_block():
                        break
                if self._loop_inflight:
                    self._retire_loop_block()
            return sum(1 for r in self.slots if r is not None)
        if self.decode_block > 1:
            if decoding:
                # Top the pipeline up to `inflight` blocks, then retire
                # the oldest; stop early once the outstanding blocks
                # cover every active request's remaining budget.
                remaining = max(
                    self.slots[i].max_new_tokens - self.slots[i].generated
                    for i in decoding if self.slots[i] is not None)
                while (len(self._inflight) < self.inflight
                       and len(self._inflight) * self.decode_block
                       < remaining):
                    if not self._dispatch_block(decoding):
                        break           # retire in-flight blocks first
            if self._inflight:
                self._retire_block()
        elif decoding:
            self._decode_tick(decoding)
        return sum(1 for r in self.slots if r is not None)

    def _decode_tick(self, decoding: list[int]):
        if self._pages is not None:
            for slot in decoding:
                if self.decoding[slot] and not self._ensure_pages(
                        slot, int(self.lengths[slot]) + 2):
                    # Unreachable while the pool holds one full slot
                    # (enforced at init): preempt the slot itself rather
                    # than let its write land on the trash page.
                    self._evict_slot(slot)
            self._sync_page_table()
            # An ensure may have preempted another decoding slot.
            decoding = [i for i in decoding if self.decoding[i]]
            if not decoding:
                return
        # Rows not decoding (empty or mid-prefill) still flow through the
        # batched step; their k/v write goes to the trash position
        # max_seq-1, which real content never occupies.
        write_positions = np.where(self.decoding, self.lengths,
                                   self.max_seq - 1).astype(np.int32)
        logits, self.cache = llama.decode_step(
            self.params, self.config, self._upload(self.current),
            self.cache, self._upload(write_positions))
        next_tokens = llama.select_tokens(
            self._generator, logits, self._upload(self.temperatures),
            top_k=self.sample_top_k).cpu().numpy()
        self.steps += 1
        for i in decoding:
            request = self.slots[i]
            if request is None:
                continue
            self.lengths[i] += 1
            token = int(next_tokens[i])
            self.current[i] = token
            self._emit(request, token)

    def _dispatch_block(self, decoding: list[int]) -> bool:
        """Enqueue one fused decode block chained off the previous
        block's device carries, with no host synchronisation: completed
        admissions fold their first token and length in on the device,
        and the emitted tokens start their copy to the host.  Returns
        False (nothing dispatched) when the page pool cannot cover the
        block until the in-flight blocks retire."""
        if self._pages is not None:
            for slot in decoding:
                if self.decoding[slot] and not self._ensure_pages(
                        slot, int(self._lengths_upper[slot])
                        + self.decode_block + 1):
                    return False
            self._sync_page_table()
            # An ensure may have preempted another decoding slot.
            decoding = [i for i in decoding if self.decoding[i]]
            if not decoding:
                return False
        with span("batcher.dispatch", info={"slots": tuple(decoding)}):
            self._launch_block(decoding)
        if self.on_block is not None:
            self.on_block("dispatch", len(decoding))
        return True

    def _launch_block(self, decoding: list[int]) -> None:
        """Enqueue the block :meth:`_dispatch_block` decided on."""
        if self._chain is None:
            tokens = self._upload(self.current)
            lengths = self._upload(self.lengths)
        else:
            tokens, lengths = self._chain
        first_meta, first_vals = [], []
        for slot in sorted(self._pending_first):
            request, first = self._pending_first[slot]
            tokens[slot] = first[0]
            lengths[slot].fill_(len(request.prompt_tokens))   # no host wait
            first_meta.append((slot, request))
            first_vals.append(first)
        self._pending_first.clear()
        firsts = (first_meta, _HostCopy(torch.cat(first_vals))) \
            if first_vals else None
        if self._active_dev is None:
            self._active_dev = self._upload(self.decoding)
        if self._temps_dev is None:
            self._temps_dev = self._upload(self.temperatures)
        emitted, tokens_n, lengths_n, self.cache = llama.decode_block(
            self.params, self.config, tokens, self.cache, lengths,
            self._active_dev, self._temps_dev, self._generator,
            num_steps=self.decode_block, top_k=self.sample_top_k)
        self._chain = (tokens_n, lengths_n)
        for i in decoding:                      # host mirror (clamped)
            self.lengths[i] = min(self.lengths[i] + self.decode_block,
                                  self.max_seq - 1)
            self._lengths_upper[i] = min(
                int(self._lengths_upper[i]) + self.decode_block,
                self.max_seq)
        self._inflight.append(_InflightBlock(
            _HostCopy(emitted), [(i, self.slots[i]) for i in decoding],
            firsts, self.decode_block))

    def _retire_block(self):
        """Wait for the OLDEST in-flight block's tokens and de-multiplex
        host-side, truncating each request at its EOS or budget.  A slot
        freed and re-admitted while the block was in flight is skipped
        through the request snapshot."""
        blk = self._inflight.popleft()
        with span("batcher.fetch"):
            emitted = blk.emitted.numpy()       # [steps, B]
            firsts = None if blk.firsts is None else blk.firsts[1].numpy()
        self.steps += 1
        if self.on_block is not None:
            self.on_block("retire", len(blk.snapshot))
        with span("batcher.emit", info={"slots": len(blk.snapshot)}):
            self._emit_block(blk, emitted, firsts)

    def _emit_block(self, blk: _InflightBlock, emitted: np.ndarray,
                    firsts: np.ndarray | None) -> None:
        if firsts is not None:
            first_meta = blk.firsts[0]
            for (slot, request), token in zip(first_meta, firsts):
                if self.slots[slot] is request and not request.done:
                    token = int(token)
                    self.current[slot] = token
                    self._emit(request, token)
        for slot, request in blk.snapshot:
            if request is None or self.slots[slot] is not request:
                continue
            for block_step in range(blk.steps):
                if self.slots[slot] is not request:     # finished
                    break
                token = int(emitted[block_step, slot])
                self.current[slot] = token
                self._emit(request, token)

    # -- speculative auto-probe --------------------------------------------

    def _runner(self, speculative: str, draft, generator) -> LoopRunner:
        return LoopRunner(
            self.params, self.config, batch=self.max_slots,
            ring=self.decode_block_tokens, speculative=speculative,
            spec_tokens=self.spec_tokens, spec_window=self.spec_window,
            draft=draft, top_k=self.sample_top_k, generator=generator,
            history_width=self.spec_window if speculative == "ngram" else 1,
            device=self.device)

    def _spec_probe(self) -> float:
        """Draft speculation's tokens/s over plain decode's
        (:meth:`_probe_ratio`).  The ratio comes from this process's
        clock, so over a mesh that spans processes two processes may
        measure two ratios: one choosing draft and the other plain would
        make other exchanges and deadlock at the next.  They agree on
        the LOWEST ratio of all (draft only where every process measured
        the win), over the mesh's control group (gloo, host values)."""
        ratio = self._probe_ratio()
        if isinstance(self.params, Placed) \
                and distributed.spans_processes(self.params.mesh):
            ratio = distributed.agree_min(self.params.mesh, ratio)
        return ratio

    def _probe_ratio(self) -> float:
        """Measure draft speculation against plain decode on a SCRATCH
        cache (the serving cache's shapes; ``self.cache`` is never
        touched) and return spec tokens/s over plain tokens/s.  Each arm
        pays one warm-up block (the capture on the card), then the best
        of ``_SPEC_PROBE_BLOCKS`` timed blocks counts."""
        ring = self.decode_block_tokens
        draft = draft_params(self.params)
        rates = {}
        for mode, dparams in (("off", None), ("draft", draft)):
            cache = self._probe_cache()
            runner = self._runner(mode, dparams, torch.Generator(
                device=self.device).manual_seed(0))
            best = 0.0
            for index in range(_SPEC_PROBE_BLOCKS + 1):
                runner.inputs["lengths"].fill_(self.max_seq // 2)
                runner.inputs["active"].fill_(True)
                runner.inputs["budget"].fill_(ring)
                begin = time.perf_counter()
                emitted = int(runner.run(cache)["counts"].sum())
                elapsed = time.perf_counter() - begin
                if index and elapsed > 0:       # block 0 = warm-up
                    best = max(best, emitted / elapsed)
            rates[mode] = best
            runner.reset()              # its graph pools on other cards
            del runner, cache
        return rates["draft"] / rates["off"] if rates["off"] else 0.0

    def _probe_cache(self) -> dict:
        """A scratch serving cache for the probe.  Paged configs get a
        fully mapped table (each slot's logical pages spread over the
        pool), so the probe pays real page-table traffic."""
        if not self.kv_page_tokens:
            return self._place(llama.init_cache(
                self.config, self.max_slots, self.max_seq,
                device=self.device))
        cache = self._place(init_paged_cache(
            self.config, self.max_slots, self.max_seq, self.kv_page_tokens,
            self._pages.total, device=self.device))
        pps = self._pages.pps
        table = (np.arange(self.max_slots * pps, dtype=np.int32)
                 % max(1, self._pages.total - 1)) + 1
        self._write_page_table(cache, table.reshape(self.max_slots, pps))
        return cache

    # -- device-resident generation loop -----------------------------------

    def _host_state(self) -> None:
        """Fresh device carries from the host mirrors into the runner's
        inputs (first dispatch and post-recover; every later block
        chains on the device)."""
        inputs = self._loop.inputs
        self._loop.upload("tokens", self.current)
        self._loop.upload("lengths", self.lengths)
        inputs["active"].zero_()
        inputs["budget"].zero_()
        inputs["history"].fill_(-1)

    def _dispatch_loop_block(self) -> bool:
        """Chain one decode_loop block off the previous block's device
        carries, folding completed admissions in (their first token,
        budget, stop set and draft history land in the runner's inputs
        on the device -- no host round trip).  Returns False when there
        is nothing to decode, the outstanding blocks already cover every
        request's budget, or page-pool pressure wants the in-flight
        blocks retired before an eviction can free room."""
        ring = self.decode_block_tokens
        spec_extra = self.spec_tokens + 1 \
            if self.speculative != "off" else 1
        live = [i for i in range(self.max_slots) if self.decoding[i]]
        joining = sorted(self._pending_first)
        if not live and not joining:
            return False
        if not joining and self._loop_inflight:
            # Outstanding blocks already cover every live request's
            # remaining budget (EOS may cut a row shorter; the loop's own
            # stop detection idles it).
            remaining = max(
                (self.slots[i].max_new_tokens - self.slots[i].generated
                 for i in live if self.slots[i] is not None), default=0)
            if len(self._loop_inflight) * ring >= remaining:
                return False
        for slot in sorted({*live, *joining}):
            if self.slots[slot] is None:
                continue                # evicted by an earlier ensure
            upto = int(self._lengths_upper[slot]) + ring + spec_extra
            if not self._ensure_pages(slot, upto):
                return False            # retire in-flight blocks first
        # An ensure above may have PREEMPTED a just-admitted slot for its
        # pages: re-snapshot both lists.
        live = [i for i in range(self.max_slots) if self.decoding[i]]
        joining = sorted(self._pending_first)
        if not live and not joining:
            return False
        with span("batcher.dispatch") as dispatch:
            dispatch.info = {"slots": self._launch_loop_block(live,
                                                              joining)}
        return True

    def _launch_loop_block(self, live: list, joining: list) -> tuple:
        """Launch the block :meth:`_dispatch_loop_block` decided on;
        returns the slots it holds."""
        ring = self.decode_block_tokens
        if self._fault_probe is not None:
            self._fault_probe("decode_block")
        if not self._loop_chained:
            self._host_state()
        inputs = self._loop.inputs
        # Host values reach device rows by fill_ (a kernel argument): an
        # item assignment of a Python number copies it from pageable
        # memory, which waits for every block in flight.
        for slot in self._force_inactive:
            inputs["active"][slot].fill_(False)
        self._force_inactive.clear()
        self._loop.upload("eos", self._eos_rows)
        self._loop.upload("temperatures", self.temperatures)
        eos = inputs["eos"]
        firsts_meta, first_vals = [], []
        for slot in joining:
            request, first = self._pending_first.pop(slot)
            plen = len(request.prompt_tokens)
            inputs["tokens"][slot] = first[0]
            inputs["lengths"][slot].fill_(plen)
            inputs["budget"][slot].fill_(
                request.max_new_tokens - request.generated - 1)
            # The slot decodes on unless its FIRST token already finishes
            # it; the EOS part of that verdict folds in on the device.
            if (request.max_new_tokens - request.generated > 1
                    and plen + 1 < self.max_seq):
                inputs["active"][slot] = (first[0] != eos[slot]).all()
            else:
                inputs["active"][slot].fill_(False)
            if self.speculative == "ngram":
                tail = np.full(self.spec_window, -1, dtype=np.int32)
                recent = request.prompt_tokens[-self.spec_window:]
                tail[len(tail) - len(recent):] = recent
                inputs["history"][slot] = self._upload(tail)
            firsts_meta.append((slot, request))
            first_vals.append(first)
        self._sync_page_table()
        out = self._loop.run(self.cache)
        self._loop_chained = True
        # Only what the retire reads travels to the host; the active,
        # budget and history carries chain on the device.
        tree = {name: out[name] for name in ("emitted", "counts", "lengths",
                                             "accepted", "drafted",
                                             "steps")}
        if first_vals:
            tree["firsts"] = torch.cat(first_vals)
        snapshot = sorted({*live, *joining})
        for slot in snapshot:
            self._lengths_upper[slot] = min(
                int(self._lengths_upper[slot]) + ring, self.max_seq)
        self._loop_inflight.append(_LoopBlock(
            _HostTree(tree), [(i, self.slots[i]) for i in snapshot],
            firsts_meta))
        self.blocks_dispatched += 1
        if self.on_block is not None:
            self.on_block("dispatch", len(snapshot))
        return tuple(snapshot)

    def _retire_loop_block(self):
        """Fetch the OLDEST in-flight loop block -- ONE call of the
        ``fetch`` hook on its whole result tree, whose copies have been
        overlapping newer blocks' compute -- and de-multiplex: folded
        first tokens, then each slot's ring prefix.  The host finish
        test in ``_emit`` is the authority; the device's stop detection
        never stops a row EARLIER, so truncation here only discards
        overshoot."""
        blk = self._loop_inflight.popleft()
        if self.on_block is not None:
            self.on_block("retire", len(blk.snapshot))
        with span("batcher.fetch"):
            fetched = self._fetch(blk.tree)
        with span("batcher.emit", info={"slots": len(blk.snapshot)}):
            self._emit_loop_block(blk, fetched)

    def _emit_loop_block(self, blk: _LoopBlock, fetched: dict) -> None:
        emitted = fetched["emitted"]
        counts = fetched["counts"]
        self.steps += int(fetched["steps"])
        self.blocks_retired += 1
        self.accepted_tokens += int(fetched["accepted"].sum())
        self.draft_tokens += int(fetched["drafted"].sum())
        if "firsts" in fetched:
            for (slot, request), token in zip(blk.firsts_meta,
                                              fetched["firsts"]):
                if self.slots[slot] is request and not request.done:
                    token = int(token)
                    self.current[slot] = token
                    self._emit(request, token)
        for slot, request in blk.snapshot:
            if request is None or self.slots[slot] is not request:
                continue
            for index in range(int(counts[slot])):
                if self.slots[slot] is not request or request.done:
                    break
                token = int(emitted[slot, index])
                self.current[slot] = token
                self._emit(request, token)
        lengths = fetched["lengths"]
        for slot, request in blk.snapshot:
            if request is not None and self.slots[slot] is request \
                    and not request.done:
                self.lengths[slot] = int(lengths[slot])
        if not self._loop_inflight:
            self._lengths_upper = self.lengths.copy()

    # -- paged-cache bookkeeping -------------------------------------------

    def _ensure_pages(self, slot: int, upto_tokens: int) -> bool:
        """Cover the slot's logical positions [0, upto_tokens) with
        physical pages.  Under pool pressure: with blocks in flight the
        caller must retire them first (their writes still route through
        the table as it was when they were enqueued), otherwise the
        YOUNGEST other occupant is preempted -- its generation resumes
        later from its committed tokens."""
        if self._pages is None:
            return True
        pages = self._pages.pages_for(
            min(int(upto_tokens), self.max_seq), self.kv_page_tokens)
        if self._pages.ensure(slot, pages):
            return True
        if self._inflight or self._loop_inflight:
            return False
        while True:
            victims = [(occupant.admit_seq, index)
                       for index, occupant in enumerate(self.slots)
                       if occupant is not None and index != slot]
            if not victims:
                return False
            self._evict_slot(max(victims)[1])
            if self._pages.ensure(slot, pages):
                return True

    def _sync_page_table(self) -> None:
        """Fold the allocator's dirty rows into the device page table: the
        host mirror takes the rows, and one copy of it is enqueued on the
        current stream, so the blocks already in flight read the table
        as it was when they were enqueued.  ``_upload`` pins a fresh
        staging tensor for every call: no staging buffer is rewritten
        before its copy has run."""
        if self._pages is None or not self._pages.dirty:
            return
        for slot, row in self._pages.dirty.items():
            self._table_host[slot] = row
        self._pages.dirty.clear()
        self._write_page_table(self.cache, self._table_host)

    def _evict_slot(self, slot: int) -> None:
        """Preempt one slot for its pages: rebase the request onto its
        committed tokens and put it at the FRONT of the queue, so it
        re-admits (re-prefilling prompt + committed, emitting nothing
        twice) as soon as the pool breathes."""
        request = self.slots[slot]
        if request is None:
            return
        self._rebase(request)
        request.slot = -1
        request.prefill_pos = 0
        self._pending_first.pop(slot, None)
        self._prefilling = [s for s in self._prefilling if s != slot]
        self._free_slot(slot)
        self.pending.insert(0, request)
        self.evictions += 1

    # -- resume and failover -----------------------------------------------

    def _rebase(self, request: Request) -> None:
        """Fold the request's committed tokens into its prompt so a
        fresh admission resumes generation where it left off."""
        request.prompt_tokens = list(request.base_prompt) \
            + [int(token) for token in request.committed]
        request.rebased = len(request.committed)

    def resume_request(self, request: Request, committed) -> bool:
        """Fold an externally journaled committed prefix into a
        just-submitted request.  Returns False (and withdraws the
        request) when that prefix already finished it."""
        request.committed = [int(token) for token in committed]
        request.generated = len(request.committed)
        if request.generated:
            request.submit_time = 0.0
        self._rebase(request)
        finished = bool(request.committed) and (
            request.committed[-1] in request.eos_tokens
            or request.generated >= request.max_new_tokens
            or len(request.prompt_tokens) >= self.max_seq)
        if finished:
            request.done = True
            if request in self.pending:
                self.pending.remove(request)
        return not finished

    def recover(self) -> int:
        """Rebuild device state after a device-level failure (a raise
        mid-block, a ``decode_block`` fault): drop every in-flight block,
        chained carry and captured graph, reset the cache and page pool,
        and re-queue each live request to resume from its LAST EMITTED
        token -- prompt + committed re-prefill, generation continues
        under the remaining budget, nothing delivered is re-emitted.
        Returns how many requests were revived."""
        revived = []
        for slot in range(self.max_slots):
            request, self.slots[slot] = self.slots[slot], None
            if request is None or request.done:
                continue
            self._rebase(request)
            request.slot = -1
            request.prefill_pos = 0
            revived.append(request)
        self.pending = revived + self.pending
        self._prefilling.clear()
        self._pending_first.clear()
        self._inflight.clear()
        self._loop_inflight.clear()
        self._chain = None
        self._loop_chained = False
        self._active_dev = None
        self._temps_dev = None
        self._force_inactive.clear()
        self.lengths[:] = 0
        self._lengths_upper[:] = 0
        self.current[:] = 0
        self.temperatures[:] = 0.0
        self.decoding[:] = False
        if self._loop is not None:
            self._loop.reset()
        if self._admission is not None:
            self._admission.reset()
        self.cache = None               # free the old cache first
        if self._pages is not None:
            self._pages.reset()
            self._table_host[:] = 0
            self.cache = self._place(init_paged_cache(
                self.config, self.max_slots, self.max_seq,
                self.kv_page_tokens, self._pages.total, device=self.device))
        else:
            self.cache = self._place(llama.init_cache(
                self.config, self.max_slots, self.max_seq,
                device=self.device))
        self.recoveries += 1
        return len(revived)

    def export_state(self) -> list[dict]:
        """Committed state of every live (not finished) request -- the
        drain/migration handoff record; each entry is enough for
        :meth:`import_state` on a peer to resume the request at its
        committed prefix."""
        entries = []
        live = [request for request in self.slots
                if request is not None] + list(self.pending)
        for request in live:
            if request.done:
                continue
            entries.append({
                "request_id": request.request_id,
                "prompt": [int(t) for t in request.base_prompt],
                "committed": [int(t) for t in request.committed],
                "max_new_tokens": int(request.max_new_tokens),
                "temperature": float(request.temperature),
                "eos_tokens": [int(t) for t in request.eos_tokens]})
        return entries

    def import_state(self, entries, emit_factory=None) -> int:
        """Resume exported requests at their committed prefix.
        ``emit_factory(entry) -> emit`` wires each request's token
        callback (None = no emission).  Returns how many were queued."""
        count = 0
        for entry in entries:
            request = Request(
                request_id=str(entry["request_id"]),
                prompt_tokens=list(entry["prompt"]),
                max_new_tokens=int(entry.get("max_new_tokens", 128)),
                temperature=float(entry.get("temperature", 0.0)),
                eos_tokens=tuple(entry.get("eos_tokens", ())))
            if emit_factory is not None:
                request.emit = emit_factory(entry)
            self.submit(request)
            self.resume_request(request, entry.get("committed", ()))
            count += 1
        return count

    # -- emission and bookkeeping ------------------------------------------

    def take_request_stats(self) -> list[dict]:
        """Drain per-request latency stamps ({"ttft_ms", "tpot_ms",
        "tokens", ...}) recorded at finish; ``queue_ms``,
        ``admission_ms`` and ``first_wait_ms`` split the ttft as the
        request's spans do (0 where a stamp is missing)."""
        stats, self._request_stats = self._request_stats, []
        return stats

    def _emit(self, request: Request, token: int):
        request.generated += 1
        self.tokens_emitted += 1
        now = time.perf_counter()
        if request.generated == 1:
            request.first_time = now
            if request.admitted_time:
                record_span("request.first", request.admitted_time, now,
                            request.request_id)
        request.committed.append(token)
        # The last usable write position is max_seq - 2 (max_seq - 1 is
        # the trash row), so finish once the sequence would need to
        # write past it.
        total_len = len(request.prompt_tokens) + request.generated \
            - request.rebased
        finished = (token in request.eos_tokens
                    or request.generated >= request.max_new_tokens
                    or total_len >= self.max_seq)
        if request.emit is not None:
            request.emit(request.request_id, token, finished)
        if finished:
            request.done = True
            if request.submit_time:
                ttft_ms = (request.first_time - request.submit_time) \
                    * 1000.0
                tpot_ms = (now - request.first_time) * 1000.0 \
                    / (request.generated - 1) \
                    if request.generated > 1 else 0.0
                if request.first_time:
                    record_span("request.decode", request.first_time, now,
                                request.request_id)
                self._request_stats.append(
                    {"ttft_ms": round(ttft_ms, 3),
                     "tpot_ms": round(tpot_ms, 3),
                     "queue_ms": round(_ms(request.submit_time,
                                           request.slot_time), 3),
                     "admission_ms": round(_ms(request.slot_time,
                                               request.admitted_time), 3),
                     "first_wait_ms": round(_ms(request.admitted_time,
                                                request.first_time), 3),
                     "tokens": request.generated,
                     "tenant": request.tenant,
                     "cls": request.qos_class})
            self._free_slot(request.slot)

    def _free_slot(self, slot: int):
        """Release a slot's host-side state (finish and cancel)."""
        self.slots[slot] = None
        self.lengths[slot] = 0
        self._lengths_upper[slot] = 0
        self.current[slot] = 0
        self.temperatures[slot] = 0.0
        self._temps_dev = None
        self.decoding[slot] = False
        self._active_dev = None
        if self.device_loop:
            self._force_inactive.add(slot)
        if self._pages is not None:
            self._pages.release(slot)

    def cancel(self, request_id: str) -> bool:
        """Abandon a request by id: pending requests leave the queue; an
        admitted request frees its slot at once.  Its tokens inside
        in-flight blocks are discarded at retire.  Returns True when a
        request was found."""
        found = False
        for request in list(self.pending):
            if request.request_id == request_id:
                self.pending.remove(request)
                request.done = True
                found = True
        for slot, request in enumerate(self.slots):
            if request is None or request.request_id != request_id:
                continue
            request.done = True
            self._free_slot(slot)
            self._pending_first.pop(slot, None)
            # A slot cancelled mid-admission leaves the admission FIFO, as
            # _evict_slot does; else the next request admitted into it is
            # queued twice and runs an extra chunk.
            self._prefilling = [s for s in self._prefilling if s != slot]
            found = True
        return found

    # -- introspection -----------------------------------------------------

    @property
    def active_count(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    @property
    def queue_depth(self) -> int:
        return len(self.pending)

    @property
    def blocks_in_flight(self) -> int:
        """Dispatched-but-unretired fused or loop blocks; drive step()
        until this reaches 0 to drain them."""
        return len(self._inflight) + len(self._loop_inflight)

    @property
    def admission_replays(self) -> int:
        """Admission chunks written by a replay of the captured chunk."""
        return self._admission.replays if self._admission is not None \
            else 0

    @property
    def prefix_hits(self) -> int:
        """Prompt pages adopted from the shared-prefix index."""
        return self._pages.prefix_hits if self._pages is not None else 0

    @property
    def prefix_lookups(self) -> int:
        """Whole prompt pages the index was consulted for."""
        return self._pages.prefix_lookups \
            if self._pages is not None else 0

    def prefix_hit_rate(self) -> float:
        """Adopted fraction of looked-up prompt pages (0.0 when the
        cache is off or nothing was looked up)."""
        lookups = self.prefix_lookups
        return self.prefix_hits / lookups if lookups else 0.0

    def reset_prefix_stats(self) -> None:
        """Zero the hit/lookup counters."""
        if self._pages is not None:
            self._pages.prefix_hits = 0
            self._pages.prefix_lookups = 0

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        steps = 0
        while (self.pending or self.active_count or self._inflight
               or self._loop_inflight) and steps < max_steps:
            self.step()
            steps += 1
        return steps


# ---------------------------------------------------------------------------
# Cross-stream micro-batching for async pipeline elements.

class MicroBatcher:
    """Cross-stream micro-batching admission for async pipeline elements.

    Generalizes the Detector's parked-frame admission (r5) so ANY async
    element coalesces frames parked at its stage -- from every stream in
    the process -- into one batched device call.  It shares the
    ContinuousBatcher's admission discipline: frames submitted in one
    event-loop burst flush together (``schedule_flush`` defers to the
    engine's mailbox drain, so a lone frame pays no added latency),
    groups form per signature key (stacking float16 with float32 frames
    would silently promote; mixed shapes cannot stack at all), ragged
    groups pad to power-of-two compile buckets (:func:`pad_to_bucket`),
    and all device work runs on a single daemon worker thread -- the
    event loop never blocks on a dispatch, a fetch, or a first-use jit
    compile.

    The element supplies three callables:

    - ``run(context, key, payloads) -> result``: stack + dispatch ONE
      batched device call for a same-key group (worker thread; raising
      errors every frame of that group only);
    - ``finish(context, key, entries, result)``: fetch + complete each
      parked frame from its row (worker thread; ``entries`` is
      ``[(complete, payload), ...]`` in submission order);
    - ``context()``: model snapshot taken at flush time -- a queued
      batch must dispatch against the weights it was built with (or
      fail cleanly if their devices died), never a half-swapped model.

    The worker dispatches EVERY group of a flush before fetching any
    (device work pipelines across groups).  Submit/flush/stop run on
    the event loop; only the queue crosses threads.

    Scope note (found by the r07 bench attempt): a micro-batched
    element on a REPLICATED placed stage is not yet supported -- the
    replica hop lands each parked frame's inputs on ITS replica's
    submesh, and a cross-replica group would stack arrays from
    different device sets into one dispatch (XLA rejects the mix).
    Replicate synchronous stages; async elements already spread load
    through their own cross-stream batching.
    """

    def __init__(self, run: Callable, finish: Callable,
                 context: Callable, schedule_flush: Callable,
                 logger=None, name: str = "microbatch"):
        self._run = run
        self._finish = finish
        self._context = context
        self._schedule_flush = schedule_flush
        self._logger = logger
        self.name = name
        # (rank, seq, key, payload, complete, submitted at)
        self._pending: list[tuple] = []
        self._flush_scheduled = False
        self._queue: queue.Queue | None = None
        # perf counters (tests assert dispatches < frames)
        self.submitted = 0
        self.dispatches = 0

    def submit(self, key, payload, complete, max_batch: int = 8,
               rank: int = 0):
        """Park one frame's work.  Flushes immediately at ``max_batch``
        pending, otherwise once the engine's mailboxes drain -- every
        frame of the burst joins the same batched dispatch.  ``rank``
        is the frame's QoS class rank (ISSUE 12): a flush dispatches
        best-ranked groups first, so an interactive frame's batch hits
        the device before a batch-class group parked in the same
        burst; all-equal ranks keep submission order exactly."""
        self._ensure_worker()
        self._pending.append((int(rank), self.submitted, key, payload,
                              complete, time.perf_counter()))
        self.submitted += 1
        if len(self._pending) >= int(max_batch):
            self.flush()
        elif not self._flush_scheduled:
            self._flush_scheduled = True
            self._schedule_flush(self._flush_deferred)

    def _ensure_worker(self):
        if self._queue is None:
            self._queue = queue.Queue()
            threading.Thread(target=self._worker, args=(self._queue,),
                             daemon=True,
                             name=f"microbatch-{self.name}").start()

    def _flush_deferred(self):
        self._flush_scheduled = False
        self.flush()

    def flush(self):
        """Group pending frames by key (submission order preserved
        within a group) and hand the burst to the worker.  Groups
        dispatch in best-(rank, submission) order -- the QoS plane;
        with all-default ranks that IS first-submission order, the
        pre-QoS behavior."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        if self._queue is None:             # stopped mid-burst
            for entry in pending:
                complete_error(entry[4], f"{self.name} stopped")
            return
        pending.sort(key=lambda entry: entry[:2])
        groups: dict = {}
        for _, _, key, payload, complete, submitted in pending:
            entries, stamps = groups.setdefault(key, ([], []))
            entries.append((complete, payload))
            stamps.append(submitted)
        self.dispatches += len(groups)
        self._queue.put((self._context(),
                         [(key, *group) for key, group in groups.items()]))

    def stop(self):
        """Flush pending frames, then retire the worker (in-flight
        batches drain first).  A later submit lazily starts a fresh
        worker -- without this the thread would pin the element (and
        its device weights) forever."""
        self.flush()
        work, self._queue = self._queue, None
        if work is not None:
            work.put(None)                  # drain-then-exit sentinel

    # -- worker side -------------------------------------------------------

    def _worker(self, work: "queue.Queue"):
        while True:
            item = work.get()
            if item is None:
                return
            self._run_groups(*item)

    def _run_groups(self, context, groups):
        """Dispatch every group first, then fetch/complete each.  A
        failing dispatch errors every frame of ITS group -- anything
        not completed here would stay parked forever."""
        dispatched = []
        for key, entries, stamps in groups:
            begin = time.perf_counter()
            for submitted in stamps:
                record_span("microbatch.wait", submitted, begin, self.name)
            try:
                with span("microbatch.run", self.name,
                          {"rows": len(entries)}):
                    result = self._run(context, key,
                                       [payload for _, payload in entries])
            except Exception as error:
                if self._logger is not None:
                    self._logger.exception(
                        "%s: batched dispatch failed", self.name)
                for complete, _ in entries:
                    complete_error(complete,
                                   f"{self.name} dispatch: {error}")
                continue
            dispatched.append((key, entries, result))
        for key, entries, result in dispatched:
            try:
                with span("microbatch.finish", self.name,
                          {"rows": len(entries)}):
                    self._finish(context, key, entries, result)
            except Exception as error:      # pragma: no cover - defensive
                if self._logger is not None:
                    self._logger.exception(
                        "%s: batch finish failed", self.name)
                for complete, _ in entries:
                    complete_error(complete, str(error))


def complete_error(complete: Callable, diagnostic: str):
    """Error one parked frame (import-cycle-free StreamEvent access)."""
    from ..pipeline.stream import StreamEvent
    complete(StreamEvent.ERROR, {"diagnostic": diagnostic})


class MicroBatchElement:
    """Mixin holding the one copy of the element-side MicroBatcher glue
    (lazy creation against the engine's drain callback, key-failure
    error path, ``max_batch`` resolution on the event loop, stop/teardown)
    shared by the Detector, ImageResize, and AudioFFT.

    Subclasses implement ``batch_key(payload)`` (grouping signature,
    resolved on the event loop; raising errors ONLY that frame),
    ``batch_run(context, key, payloads)`` and
    ``batch_finish(context, key, entries, result)`` (worker thread),
    and optionally ``batch_context()`` (model snapshot at flush time).
    """

    _batcher: MicroBatcher | None = None

    def batch_context(self):
        return None

    def batch_key(self, payload):
        raise NotImplementedError

    def batch_run(self, context, key, payloads):
        raise NotImplementedError

    def batch_finish(self, context, key, entries, result):
        raise NotImplementedError

    def submit_microbatch(self, complete, payload,
                          diagnostic: str = "bad input"):
        if self._batcher is None:
            self._batcher = MicroBatcher(
                run=self.batch_run, finish=self.batch_finish,
                context=self.batch_context,
                schedule_flush=(self.pipeline.runtime.engine
                                .post_when_drained),
                logger=self.logger, name=self.name)
        max_batch, _ = self.get_parameter("max_batch", 8)
        try:
            key = self.batch_key(payload)
        except Exception as error:      # malformed frame: only ITS
            complete_error(complete,     # complete errors
                           f"{diagnostic}: {error}")
            return
        # Unified QoS admission (ISSUE 12): the parked frame's class
        # rank orders the flush, so the batcher honors the same
        # priority vocabulary as the stage credits.  Resolved on the
        # event loop where the current-stream context is intact.
        rank = 0
        qos = getattr(self.pipeline, "qos", None)
        if qos is not None:
            stream = self.pipeline.current_stream()
            if stream is not None:
                rank = qos.class_rank(getattr(stream, "qos_class",
                                              None))
        self._batcher.submit(key, payload, complete,
                             max_batch=int(max_batch), rank=rank)

    def stop_microbatcher(self):
        """Flush + retire (a later submit lazily starts a fresh one)."""
        batcher, self._batcher = self._batcher, None
        if batcher is not None:
            batcher.stop()

    def stop_stream(self, stream, stream_id):
        if self._batcher is not None:
            # The stopping stream's parked frames must not linger in a
            # half-collected burst.  The batcher itself is SHARED
            # across streams: retire the worker only when this was the
            # last live stream (the engine pops the stream before
            # stop_stream fires), so sibling streams keep their warm
            # worker and the cross-stream batching counters.
            self._batcher.flush()
            if not self.pipeline.streams:
                self.stop_microbatcher()
        return super().stop_stream(stream, stream_id)
