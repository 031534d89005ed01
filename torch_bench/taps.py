"""What the benchmark records from the program while a run goes on.

The taps wrap a few methods of the port's ``ContinuousBatcher`` for the
life of one run (:func:`installed`), whichever thread steps it, and
note host-clock stamps and counts beside each call:

- every emitted token (``_emit``): the request, the token, its index in
  the answer, the prompt's length and the number of loop blocks retired
  before it (a token belongs to the block whose retire emits it), and
  with a request's first token its prompt;
- every dispatched and every retired loop block
  (``_dispatch_loop_block``, ``_retire_loop_block``): its host time;
- every admission chunk (``llama.prefill_into_slot`` or the batched
  ``llama.prefill_into_slots``, then ``_admission_advance`` for each of
  its rows): when its enqueue began and ended, its offset and its real
  length (the pad of the chunk is not work), and the prompt tokens the
  batcher counts for it in ``prefill_tokens``;
- every ``step()``: the occupied slots as it starts.

:func:`check_admissions` holds the tape to the batcher's own counter,
so an admission path the taps do not see fails the run rather than
drop out of the work counts.

Nothing here changes what the program computes: each wrapper calls the
original with the same arguments and returns its result.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Tape:
    # (t, retires so far, request id, index in the answer, prompt
    # length, token)
    emits: list = field(default_factory=list)
    retires: list = field(default_factory=list)   # t
    dispatches: list = field(default_factory=list)  # t, after the launch
    chunks: list = field(default_factory=list)    # [t0, t1, start, length]
    #: prompt tokens counted by ``_admission_advance``, and how many of
    #: its calls followed no tapped prefill call
    prefilled: int = 0
    unmatched: int = 0
    steps: list = field(default_factory=list)     # (t, active)
    prompts: dict = field(default_factory=dict)   # rid -> prompt tokens
    lock: threading.Lock = field(default_factory=threading.Lock)


@contextlib.contextmanager
def installed(tape: Tape):
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.batching import ContinuousBatcher

    emit = ContinuousBatcher._emit
    retire = ContinuousBatcher._retire_loop_block
    dispatch = ContinuousBatcher._dispatch_loop_block
    advance = ContinuousBatcher._admission_advance
    step = ContinuousBatcher.step
    prefill = llama.prefill_into_slot
    prefill_many = llama.prefill_into_slots
    local = threading.local()

    def tapped_emit(self, request, token):
        with tape.lock:
            if request.generated == 0:
                tape.prompts[request.request_id] = \
                    list(request.prompt_tokens)
            tape.emits.append((time.perf_counter(), len(tape.retires),
                               request.request_id, request.generated,
                               len(request.prompt_tokens), int(token)))
        return emit(self, request, token)

    def tapped_retire(self):
        with tape.lock:
            tape.retires.append(time.perf_counter())
        return retire(self)

    def tapped_dispatch(self):
        launched = dispatch(self)
        if launched:
            with tape.lock:
                tape.dispatches.append(time.perf_counter())
        return launched

    def timed(fn):
        def tapped(*args, **kwargs):
            begin = time.perf_counter()
            out = fn(*args, **kwargs)
            local.span = (begin, time.perf_counter())
            return out
        return tapped

    def tapped_advance(self, slot, request, start, chunk_len, logits):
        # The rows of one batched pass share its span; the next prefill
        # call or step replaces it.
        span = getattr(local, "span", None)
        with tape.lock:
            tape.prefilled += start + chunk_len - request.prefill_pos
            if span is None:
                tape.unmatched += 1
            else:
                tape.chunks.append([*span, int(start), int(chunk_len)])
        return advance(self, slot, request, start, chunk_len, logits)

    def tapped_step(self):
        local.span = None
        with tape.lock:
            tape.steps.append((time.perf_counter(), self.active_count))
        return step(self)

    ContinuousBatcher._emit = tapped_emit
    ContinuousBatcher._retire_loop_block = tapped_retire
    ContinuousBatcher._dispatch_loop_block = tapped_dispatch
    ContinuousBatcher._admission_advance = tapped_advance
    ContinuousBatcher.step = tapped_step
    llama.prefill_into_slot = timed(prefill)
    llama.prefill_into_slots = timed(prefill_many)
    try:
        yield tape
    finally:
        ContinuousBatcher._emit = emit
        ContinuousBatcher._retire_loop_block = retire
        ContinuousBatcher._dispatch_loop_block = dispatch
        ContinuousBatcher._admission_advance = advance
        ContinuousBatcher.step = step
        llama.prefill_into_slot = prefill
        llama.prefill_into_slots = prefill_many


def check_admissions(tape: Tape, prefill_tokens: int) -> None:
    """Every prompt token the batcher counts (its ``prefill_tokens``,
    read once nothing steps it) came through a tapped chunk: else the
    work counts and the prefill roofline would miss an admission
    path."""
    if tape.unmatched or tape.prefilled != prefill_tokens:
        raise RuntimeError(
            f"taps: {prefill_tokens} prompt tokens admitted, "
            f"{tape.prefilled} taped, {tape.unmatched} chunk(s) written by "
            f"no tapped prefill call")
