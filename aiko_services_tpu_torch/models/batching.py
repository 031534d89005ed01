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
  ``llama.prefill_into_slots``);
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
  batcher at their committed prefix.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from . import llama
from .loop_graph import LoopRunner
from .paged import PageAllocator, init_paged_cache, pages_per_slot
from .quant import draft_params
from ..device import resolve_device
from ..utils.misc import next_power_of_two

__all__ = ["Request", "ContinuousBatcher", "pad_to_bucket"]

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


def pad_to_bucket(rows: list) -> list:
    """Pad a ragged admission burst to its power-of-two bucket by
    repeating the first row (idempotent device work)."""
    bucket = next_power_of_two(len(rows))
    return list(rows) + [rows[0]] * (bucket - len(rows))


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
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"ContinuousBatcher: params live on "
                f"{params['embed'].device}, the batcher on {self.device}")
        self.params = params
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
            self.cache = init_paged_cache(
                config, max_slots, self.max_seq, self.kv_page_tokens,
                kv_pages, device=self.device)
            self._pages = PageAllocator(
                llama.cache_array(self.cache).shape[1], pps, max_slots,
                prefix_cache=self.prefix_cache,
                prefix_min_tokens=self.prefix_min_tokens)
            # Host mirror of the device page table (dirty rows fold in).
            self._table_host = np.zeros((max_slots, pps), dtype=np.int32)
        else:
            self.cache = llama.init_cache(config, max_slots, self.max_seq,
                                          device=self.device)
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

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the stream
        (pinned staging, asynchronous copy)."""
        tensor = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return tensor.pin_memory().to(self.device, non_blocking=True)
        return tensor.clone()

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
            self._sync_page_table()
            padded = np.zeros((1, self.prefill_chunk), dtype=np.int64)
            padded[0, :len(chunk_tokens)] = chunk_tokens
            logits, self.cache = llama.prefill_into_slot(
                self.params, self.config, self._upload(padded),
                self.cache, slot, start)
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
        self._sync_page_table()
        n = len(admitting)
        rows = pad_to_bucket(admitting)
        tokens = np.zeros((len(rows), self.prefill_chunk), dtype=np.int64)
        starts = []
        metas = []
        for i, slot in enumerate(rows):
            request = self.slots[slot]
            start, chunk_tokens = self._admission_chunk(request)
            tokens[i, :len(chunk_tokens)] = chunk_tokens
            starts.append(start)
            metas.append((slot, request, start, len(chunk_tokens)))
        logits, self.cache = llama.prefill_into_slots(
            self.params, self.config, self._upload(tokens), self.cache,
            rows, starts)
        for i, (slot, request, start, chunk_len) in enumerate(metas[:n]):
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
        if self._chain is None:
            tokens = self._upload(self.current)
            lengths = self._upload(self.lengths)
        else:
            tokens, lengths = self._chain
        first_meta, first_vals = [], []
        for slot in sorted(self._pending_first):
            request, first = self._pending_first[slot]
            tokens[slot] = first[0]
            lengths[slot] = len(request.prompt_tokens)
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
        if self.on_block is not None:
            self.on_block("dispatch", len(decoding))
        return True

    def _retire_block(self):
        """Wait for the OLDEST in-flight block's tokens and de-multiplex
        host-side, truncating each request at its EOS or budget.  A slot
        freed and re-admitted while the block was in flight is skipped
        through the request snapshot."""
        blk = self._inflight.popleft()
        emitted = blk.emitted.numpy()           # [steps, B]
        self.steps += 1
        if self.on_block is not None:
            self.on_block("retire", len(blk.snapshot))
        if blk.firsts is not None:
            first_meta, firsts = blk.firsts
            for (slot, request), token in zip(first_meta, firsts.numpy()):
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
            del runner, cache
        return rates["draft"] / rates["off"] if rates["off"] else 0.0

    def _probe_cache(self) -> dict:
        """A scratch serving cache for the probe.  Paged configs get a
        fully mapped table (each slot's logical pages spread over the
        pool), so the probe pays real page-table traffic."""
        if not self.kv_page_tokens:
            return llama.init_cache(self.config, self.max_slots,
                                    self.max_seq, device=self.device)
        cache = init_paged_cache(self.config, self.max_slots, self.max_seq,
                                 self.kv_page_tokens, self._pages.total,
                                 device=self.device)
        pps = self._pages.pps
        table = (np.arange(self.max_slots * pps, dtype=np.int32)
                 % max(1, self._pages.total - 1)) + 1
        cache["page_table"].copy_(torch.from_numpy(
            table.reshape(self.max_slots, pps)))
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
        if self._fault_probe is not None:
            self._fault_probe("decode_block")
        if not self._loop_chained:
            self._host_state()
        inputs = self._loop.inputs
        for slot in self._force_inactive:
            inputs["active"][slot] = False
        self._force_inactive.clear()
        self._loop.upload("eos", self._eos_rows)
        self._loop.upload("temperatures", self.temperatures)
        eos = inputs["eos"]
        firsts_meta, first_vals = [], []
        for slot in joining:
            request, first = self._pending_first.pop(slot)
            plen = len(request.prompt_tokens)
            inputs["tokens"][slot] = first[0]
            inputs["lengths"][slot] = plen
            inputs["budget"][slot] = \
                request.max_new_tokens - request.generated - 1
            # The slot decodes on unless its FIRST token already finishes
            # it; the EOS part of that verdict folds in on the device.
            if (request.max_new_tokens - request.generated > 1
                    and plen + 1 < self.max_seq):
                inputs["active"][slot] = (first[0] != eos[slot]).all()
            else:
                inputs["active"][slot] = False
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
        return True

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
        fetched = self._fetch(blk.tree)
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
        self.cache["page_table"].copy_(self._upload(self._table_host))

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
        self.cache = None               # free the old cache first
        if self._pages is not None:
            self._pages.reset()
            self._table_host[:] = 0
            self.cache = init_paged_cache(
                self.config, self.max_slots, self.max_seq,
                self.kv_page_tokens, self._pages.total, device=self.device)
        else:
            self.cache = llama.init_cache(self.config, self.max_slots,
                                          self.max_seq, device=self.device)
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
        "tokens", ...}) recorded at finish."""
        stats, self._request_stats = self._request_stats, []
        return stats

    def _emit(self, request: Request, token: int):
        request.generated += 1
        self.tokens_emitted += 1
        now = time.perf_counter()
        if request.generated == 1:
            request.first_time = now
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
                self._request_stats.append(
                    {"ttft_ms": round(ttft_ms, 3),
                     "tpot_ms": round(tpot_ms, 3),
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
