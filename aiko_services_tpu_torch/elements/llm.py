"""LLM serving on the card: actor + pipeline element.

Counterpart of ``aiko_services_tpu/elements/llm.py`` on the port's
``models.llama``, ``models.quant`` and ``models.batching``: the same
parameters map to the same batcher settings, and greedy frames produce
the same text.  The port's differences:

- weights are drawn by ``llama.init_params(seed, config, device)``;
- element parameter ``device`` (the port's device rule, ``device.py``):
  the card by default, ``cpu`` for the plain PyTorch path; with no card
  and no ``device: cpu`` the first request fails its frame;
- ``checkpoint`` names a port checkpoint (``models/checkpoint.py``,
  written by ``python -m aiko_services_tpu_torch convert llama``): the
  model is built from shapes alone and each restored leaf goes to the
  card once, through pinned memory, so a build never holds two trees;
- ``tokenizer`` names a local HuggingFace directory; a path given is
  loaded or the frame fails (it never turns into ``ByteTokenizer`` in
  silence);
- decode ticks run under the pipeline TransferLedger's guard, which on
  the card is process-wide (``pipeline/overlap.py``); the device loop's
  one graph capture lifts it (``models/loop_graph.py``);
- :meth:`LLM.close` ends the element's worker and drops its model, so a
  process can free the card's memory between pipelines;
- the worker writes spans to the process ring (``tpu/profiling.py``):
  ``llm.inbox`` a request (the frame's put to the batcher's submit: the
  worker's inbox and the tokenizing; the batcher's ``request.*`` spans
  follow it) and ``llm.wait_work`` (the worker blocked on an empty
  inbox); the telemetry plane observes ``llm_queue_ms`` and
  ``llm_admission_ms`` beside ``llm_ttft_ms``.

The rest of this docstring is the JAX package's, and holds here.

Serving is native to the framework:

- :class:`LLMService` is an Actor owning a :class:`ContinuousBatcher`
  (models/batching.py): weights and the batched KV cache live in HBM;
  any number of remote callers stream generations concurrently.  Wire
  protocol on ``topic/in``::

      (generate response_topic request_id prompt max_new_tokens temp)

  replies on ``response_topic``::

      (token request_id fragment)     per decode step
      (complete request_id full_text)

  The decode loop rides the event engine: while work is pending the
  service re-posts its pump, so decode ticks interleave with message
  handling instead of blocking the process (the "batching mailbox
  between the actor layer and the device loop" flagged in SURVEY §7).

- :class:`LLM` is a PipelineElement producing ``text`` out of ``text``
  frames, hosting its own model in-process.  To share one model (one
  set of HBM weights) across many pipelines, wrap this element in a
  small pipeline and reference it from the others as a remote stage
  (``deploy: remote``) -- the framework's pause/resume continuation
  carries the frame across, exactly like any other remote element.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

from ..device import resolve_device
from ..models import llama
from ..models.batching import ContinuousBatcher, Request
from ..models.checkpoint import restore_or_init
from ..models.tokenizer import ByteTokenizer, load_tokenizer
from ..pipeline import PipelineElement, StreamEvent
from ..services import Actor
from ..tpu.profiling import record_span, span
from ..utils import generate, get_logger, parse_bool, parse_number

__all__ = ["LLMService", "LLM", "DetectionCaption", "PROTOCOL_LLM"]

_logger = get_logger("aiko.llm")

PROTOCOL_LLM = "llm:0"


def _collector(tokenizer, collected: list):
    """Emit callback appending non-EOS tokens to ``collected``."""
    eos = set(tokenizer.eos_tokens)

    def emit(request_id, token, finished):
        if token not in eos:
            collected.append(token)
    return emit


class LLMService(Actor):
    """Continuous-batching generation server."""

    def __init__(self, name: str = "llm", runtime=None,
                 config: llama.LlamaConfig | None = None,
                 params=None, tokenizer=None, max_slots: int = 8,
                 checkpoint: str | None = None, seed: int = 0,
                 decode_block: int = 1, inflight: int = 2,
                 device: str | None = None):
        super().__init__(name, PROTOCOL_LLM, tags=["ec=true"],
                         runtime=runtime)
        if config is None:
            config = llama.LlamaConfig.tiny()
        device = resolve_device(device)
        if params is None:
            params = restore_or_init(llama, config, seed, checkpoint,
                                     device)
        self.tokenizer = tokenizer or ByteTokenizer()
        # decode_block > 1 with inflight > 1 is the pipelined serving
        # path (fused multi-step blocks chained device-side) -- the same
        # configuration the bench runs; the wire-facing server defaults
        # stay at one-step dispatches so token streaming is per-step.
        self.batcher = ContinuousBatcher(params, config,
                                         max_slots=max_slots,
                                         decode_block=decode_block,
                                         inflight=inflight, device=device)
        # Keyed by (response_topic, request_id): two callers independently
        # choosing the same request_id (both starting at "1") must not
        # collide -- the response topic is the caller's identity.
        self._texts: dict[tuple[str, str], list[int]] = {}
        self._pumping = False
        self.share.update({"model_layers": config.n_layers,
                           "max_slots": max_slots,
                           "active": 0, "queued": 0,
                           "tokens_emitted": 0})

    # -- wire API ----------------------------------------------------------

    def generate(self, response_topic, request_id, prompt,
                 max_new_tokens="128", temperature="0"):
        """(generate response_topic request_id prompt max tokens temp)"""
        key = (str(response_topic), str(request_id))
        self._texts[key] = []
        self.batcher.submit(Request(
            request_id="\x00".join(key),
            prompt_tokens=self.tokenizer.encode(str(prompt)),
            max_new_tokens=int(parse_number(max_new_tokens, 128)),
            temperature=float(parse_number(temperature, 0.0)),
            eos_tokens=self.tokenizer.eos_tokens,
            emit=self._on_token))
        self._start_pump()

    # -- decode pump -------------------------------------------------------

    def _start_pump(self):
        if not self._pumping:
            self._pumping = True
            self.runtime.engine.post_deferred(self._pump)

    def _pump(self):
        active = self.batcher.step()
        self.ec_producer.update("active", self.batcher.active_count)
        self.ec_producer.update("queued", self.batcher.queue_depth)
        self.ec_producer.update("tokens_emitted",
                                self.batcher.tokens_emitted)
        if active or self.batcher.queue_depth \
                or self.batcher.blocks_in_flight:
            # Deferred, not synchronous: new (generate ...) messages
            # interleave between decode ticks and join the batch.
            self.runtime.engine.post_deferred(self._pump)
        else:
            self._pumping = False

    def _on_token(self, batcher_id: str, token: int, finished: bool):
        reply_topic, _, request_id = batcher_id.partition("\x00")
        key = (reply_topic, request_id)
        tokens = self._texts.setdefault(key, [])
        if token not in self.tokenizer.eos_tokens:
            tokens.append(token)
            fragment = self.tokenizer.decode([token])
            self.runtime.message.publish(
                reply_topic,
                generate("token", [request_id, fragment]))
        if finished:
            text = self.tokenizer.decode(tokens)
            self.runtime.message.publish(
                reply_topic, generate("complete", [request_id, text]))
            self._texts.pop(key, None)

    # -- local API ---------------------------------------------------------

    def generate_local(self, prompt: str, max_new_tokens: int = 128,
                       temperature: float = 0.0) -> str:
        """Synchronous generation (drains the batcher inline): for
        single-process callers and tests."""
        collected: list[int] = []
        self.batcher.submit(Request(
            request_id="local",
            prompt_tokens=self.tokenizer.encode(prompt),
            max_new_tokens=max_new_tokens, temperature=temperature,
            eos_tokens=self.tokenizer.eos_tokens,
            emit=_collector(self.tokenizer, collected)))
        self.batcher.run_until_drained()
        return self.tokenizer.decode(collected)


class DetectionCaption(PipelineElement):
    """``detections`` (Detector output dicts) -> ``text`` prompt for a
    downstream LLM stage -- the detect->describe bridge of the
    video->detect->caption pipeline (BASELINE config 4; reference
    equivalent: examples/llm/elements.py:204 Detection, which formats
    detections into the Ollama prompt).

    Parameter ``template`` wraps the summary (``{detections}``
    placeholder)."""

    def process_frame(self, stream, detections=None, **inputs):
        detections = detections or []
        counts: dict[str, int] = {}
        for detection in detections:
            name = str(detection.get("class", "object"))
            counts[name] = counts.get(name, 0) + 1
        summary = ", ".join(
            f"{count} {name}" if count > 1 else name
            for name, count in sorted(counts.items())) or "nothing"
        template, _ = self.get_parameter(
            "template", "Describe a scene containing: {detections}.")
        # Plain replace, not str.format: templates may legitimately
        # contain literal braces (JSON-shaped prompts).
        return StreamEvent.OKAY, {
            "text": str(template).replace("{detections}", summary)}


class LLM(PipelineElement):
    """``text`` -> generated ``text``.

    Parameters: ``max_new_tokens``, ``temperature``, ``system_prompt``,
    ``device`` (the card by default, or ``cpu``),
    ``tokenizer`` (HF directory), ``checkpoint`` (port checkpoint
    directory, ``models/checkpoint.py``),
    ``vocab_size``/``max_seq``/``seed`` (local tiny config),
    ``attention`` (``dense`` | ``flash`` -- chunked admission through
    the prefill attention kernel), ``quantize`` (weight-only
    int8: halves decode's weight stream), ``decode_block`` (fuse N decode
    steps per device dispatch: amortizes host round trips), ``inflight``
    (keep N fused/loop blocks in flight, chained device-side: hides the
    dispatch round trip behind device compute), ``max_slots`` (device
    batch width: size to the expected concurrent-frame count; decode is
    weight-bandwidth-bound at short context, so wider batches decode more
    frames' requests per block at nearly the same step time).

    Device-resident serving: ``decode_block_tokens`` > 0
    moves generation into ``llama.decode_loop`` -- on-device sampling,
    per-slot stop detection and an emitted-token ring, ONE counted
    ledger fetch per block (the batcher's ``fetch`` is wired to the
    pipeline TransferLedger, and the worker runs decode ticks under
    the ledger's transfer guard, so a stray per-token host sync FAILS
    under ``transfer_guard: disallow`` instead of silently capping
    tok/s).  ``speculative: off|ngram|draft`` layers multi-token
    decoding onto the loop (``spec_tokens`` drafts per step);
    ``kv_page_tokens`` > 0 switches the KV cache to fixed-size pages
    with a per-slot page table (``kv_pages`` caps the physical pool).
    A device loss mid-generation (or a chaos ``decode_block`` fault)
    replays every live request from its last emitted block: the
    batcher re-prefills prompt + committed tokens and generation
    continues -- nothing already streamed is re-emitted.

    ASYNC by default: each frame parks and its request hops to the
    element's device WORKER THREAD, which owns the model and the shared
    :class:`ContinuousBatcher` -- model build (weights drawn on the
    card, kernels built at first use, the loop's graph capture),
    admission, the decode loop, and the retire fetches all run OFF the
    event loop, so they never block other stages' frames (detect of
    frame k+1 proceeds while the LLM compiles or decodes).  Requests from many in-flight
    frames/streams decode together in one device batch (continuous
    batching across frames, not per-frame drains); completions post
    back through the engine's thread-safe continuation.  Set parameter
    ``synchronous: true`` for the blocking per-frame path.
    """

    is_async = True

    def __init__(self, context):
        super().__init__(context)
        self._batcher: ContinuousBatcher | None = None
        self._tokenizer = None
        self._request_seq = 0
        # request_id -> complete for parked async frames, so a failing
        # worker can error them out instead of leaving them parked.
        # Owned by the WORKER thread (cancels arrive via the queue).
        self._completes: dict = {}
        # ("request", stream_id, text, complete, request_params,
        # model_params) | ("cancel", prefix); created lazily with the
        # daemon worker thread.
        self._work: queue.Queue | None = None
        # Serializes device access between the worker and the blocking
        # process_frame path (a per-stream ``synchronous: true`` can
        # run while another stream uses the async worker).
        self._device_lock = threading.RLock()
        # Set while no synchronous frame is stepping the batcher: the
        # worker waits on it before each tick, so a synchronous frame
        # takes the lock at the worker's next tick boundary (a lock is
        # not fair -- the worker would re-acquire it first).
        self._no_sync_frame = threading.Event()
        self._no_sync_frame.set()
        self._sync_frames = 0
        self._sync_count_lock = threading.Lock()
        # Device-loss recovery bookkeeping: consecutive failed decode
        # ticks before the worker gives up replaying (reset by any
        # successful tick), and the telemetry counters' published
        # watermarks (deltas feed the registry).
        self._recover_streak = 0
        self._published_accepted = 0
        self._published_drafted = 0
        self._published_prefix_hits = 0
        self._published_prefix_lookups = 0
        # close(): the worker thread and the flag that ends it.
        self._worker_thread: threading.Thread | None = None
        self._closing = False

    # Model-config parameters, resolved ON THE EVENT LOOP (stream
    # parameter precedence reads the pipeline's current-stream context,
    # which only the loop thread maintains) and shipped to the worker.
    _MODEL_PARAMS = ("checkpoint", "tokenizer", "vocab_size", "max_seq",
                     "seed", "attention", "model", "quantize",
                     "decode_block", "inflight", "max_slots",
                     "decode_block_tokens", "speculative", "spec_tokens",
                     "spec_window", "kv_page_tokens", "kv_pages",
                     "decode_kernel", "sample_top_k", "prefix_cache",
                     "prefix_min_tokens", "spec_autoprobe", "device")

    def _resolve_model_params(self) -> dict:
        resolved = {}
        for name in self._MODEL_PARAMS:
            value, found = self.get_parameter(name, None)
            if found and value is not None:
                resolved[name] = value
        return resolved

    def _resolve_request_params(self) -> dict:
        max_new, _ = self.get_parameter("max_new_tokens", 32)
        temperature, _ = self.get_parameter("temperature", 0.0)
        system_prompt, _ = self.get_parameter("system_prompt", "")
        return {"max_new_tokens": int(max_new),
                "temperature": float(temperature),
                "system_prompt": str(system_prompt or "")}

    def _ensure_model(self, settings: dict | None = None):
        if self._batcher is not None:
            return
        if settings is None:
            settings = self._resolve_model_params()
        tokenizer_path = settings.get("tokenizer")
        device = resolve_device(settings.get("device"))
        self._tokenizer = load_tokenizer(tokenizer_path) \
            if tokenizer_path else ByteTokenizer()
        vocab = settings.get("vocab_size")
        # "flash" routes chunked admission through the prefill
        # attention kernel (ops/flash_attention.py).
        model = settings.get("model", "tiny")
        bases = {"tiny": llama.LlamaConfig.tiny,
                 "tiny-moe": llama.LlamaConfig.tiny_moe,
                 "llama3-1b": llama.LlamaConfig.llama3_1b,
                 "llama3-8b": llama.LlamaConfig.llama3_8b}
        if str(model) not in bases:
            raise ValueError(f"model={model!r}: one of {sorted(bases)}")
        base = bases[str(model)]()
        # An explicit vocab_size always wins (it must match the
        # tokenizer/checkpoint); otherwise tiny configs follow the
        # tokenizer and the llama configs keep their own vocab.
        if vocab is not None:
            base = dataclasses.replace(base, vocab_size=int(vocab))
        elif str(model).startswith("tiny"):
            base = dataclasses.replace(
                base, vocab_size=self._tokenizer.vocab_size)
        config = dataclasses.replace(
            base, max_seq=int(settings.get("max_seq", 256)),
            attention=str(settings.get("attention", "dense")))
        # ``decode_kernel`` selects the decode-attention backend in the
        # ops capability-probe vocabulary (ops.decode_backend):
        # paged-kernel / dense-flash force the decode kernels
        # (which one actually engages follows the cache's structure),
        # reference forces the dense einsum path, auto defers to the
        # extent threshold.  Domain-validated at create time
        # (analysis/params.py ELEMENT_PARAMETERS).
        decode_kernel = str(settings.get("decode_kernel",
                                         "auto")).strip().lower()
        kernel_to_attention = {"auto": "auto", "paged-kernel": "flash",
                               "dense-flash": "flash",
                               "reference": "dense"}
        if decode_kernel not in kernel_to_attention:
            raise ValueError(
                f"decode_kernel={decode_kernel!r}: one of "
                f"{'|'.join(sorted(kernel_to_attention))}")
        if decode_kernel != "auto":
            config = dataclasses.replace(
                config,
                decode_attention=kernel_to_attention[decode_kernel])
        params = restore_or_init(llama, config,
                                 int(settings.get("seed", 0)),
                                 settings.get("checkpoint"), device)
        quantize = settings.get("quantize", False)
        normalized = str(quantize).strip().lower()
        if parse_bool(quantize) or normalized == "int8":
            # Weight-only int8 (models/quant.py): halves decode's HBM
            # stream; activations/cache stay bf16.
            from ..models.quant import quantize_params
            params = quantize_params(params)
        elif normalized not in ("false", "0", "no", "off", "none", ""):
            # A typo must not silently serve bf16 at half the promised
            # decode rate.
            raise ValueError(
                f"quantize={quantize!r}: use true/false or int8")
        # Requests beyond max_slots queue (sizing rationale: class
        # docstring).  The pipeline TransferLedger counts the one
        # explicit host fetch each retired device-loop block pays; the
        # chaos probe arms the ``decode_block`` injection point.
        ledger = self._ledger()
        kv_pages = settings.get("kv_pages")
        self._batcher = ContinuousBatcher(
            params, config,
            max_slots=int(settings.get("max_slots", 8)),
            decode_block=int(settings.get("decode_block", 1)),
            inflight=int(settings.get("inflight", 2)),
            decode_block_tokens=int(
                settings.get("decode_block_tokens", 0)),
            speculative=str(settings.get("speculative", "off")),
            spec_tokens=int(settings.get("spec_tokens", 4)),
            spec_window=int(settings.get("spec_window", 32)),
            kv_page_tokens=int(settings.get("kv_page_tokens", 0)),
            kv_pages=None if kv_pages is None else int(kv_pages),
            sample_top_k=int(settings.get("sample_top_k", 0)),
            prefix_cache=settings.get("prefix_cache", False),
            prefix_min_tokens=int(settings.get("prefix_min_tokens", 64)),
            spec_autoprobe=settings.get("spec_autoprobe", True),
            fetch=None if ledger is None
            else (lambda tree: ledger.fetch(tree, label="llm_block")),
            fault_probe=self._fault_probe,
            on_block=self._note_block, device=device)

    def _note_block(self, phase: str, slots: int) -> None:
        """Flight-recorder tap: every decode-block dispatch/
        retire lands on the pipeline's event ring (global events --
        no stream/frame: one block serves many), so serving cadence is
        on the same timeline as the frames in a black-box dump.  Runs
        on the element's decode worker thread; the ring is
        thread-safe and a missing recorder costs one getattr."""
        recorder = getattr(self.pipeline, "recorder", None)
        if recorder is not None:
            recorder.record("llm_block", None, None, phase,
                            None, {"slots": slots})

    def _make_request(self, stream_id, text,
                      request_params: dict) -> tuple[Request, list[int]]:
        system_prompt = request_params["system_prompt"]
        prompt = f"{system_prompt}{text}" if system_prompt else str(text)
        self._request_seq += 1
        collected: list[int] = []
        return Request(
            request_id=f"{stream_id}/{self._request_seq}",
            prompt_tokens=self._tokenizer.encode(prompt),
            max_new_tokens=request_params["max_new_tokens"],
            temperature=request_params["temperature"],
            eos_tokens=self._tokenizer.eos_tokens,
            emit=_collector(self._tokenizer, collected)), collected

    def process_frame_start(self, stream, complete, text=None, **inputs):
        self._start_worker()
        # Parameters resolve HERE (loop thread, current-stream context
        # intact); the worker consumes pre-resolved values.  The model
        # settings ride along until the first request builds it.  The
        # stream's QoS identity rides too: the batcher's
        # slot admission is the fourth plane of the unified scheduler.
        model_params = None if self._batcher is not None \
            else self._resolve_model_params()
        qos = getattr(self.pipeline, "qos", None)
        qos_info = (getattr(stream, "tenant", None),
                    getattr(stream, "qos_class", None),
                    0 if qos is None
                    else qos.class_rank(getattr(stream, "qos_class",
                                                None)))
        # Process fault domain: the frame identity keys the
        # journal's per-token commits, and an adopted frame's journaled
        # committed prefix resumes generation instead of re-running it.
        pipeline = getattr(self, "pipeline", None)
        frame = None
        current = getattr(pipeline, "current_frame", None)
        if callable(current):
            frame = current()
        journal_key = None
        resume = None
        if frame is not None:
            if getattr(pipeline, "journal", None) is not None \
                    and getattr(stream, "journal", False):
                journal_key = (str(stream.stream_id),
                               int(frame.frame_id))
            take = getattr(pipeline, "take_journal_resume", None)
            if callable(take):
                resume = take(stream.stream_id, frame.frame_id)
        self._work.put(("request", str(stream.stream_id), text, complete,
                        self._resolve_request_params(), model_params,
                        qos_info, journal_key, resume, time.perf_counter()))

    def stop_stream(self, stream, stream_id):
        """Cancel the stream's outstanding requests: a frame parked here
        when its stream is destroyed must stop decoding (it would
        otherwise run to max_new_tokens in a device batch slot) and its
        parked ``complete`` must not fire later.  Routed through the
        worker queue -- the batcher and the completes registry are
        worker-owned."""
        if self._work is not None:
            self._work.put(("cancel", f"{stream.stream_id}/"))
        return StreamEvent.OKAY, {}

    def drain_requests(self):
        """Migrate-in-place for ``Pipeline.drain``: cancel
        every live request (committed prefixes are already journaled
        token by token) and drop the parked frames without responding,
        leaving them undelivered in the journal -- the adopting peer
        replays each frame and its LLM request resumes at the
        committed prefix via ``ContinuousBatcher.resume_request``."""
        if self._work is not None:
            self._work.put(("drain",))

    # -- device worker -----------------------------------------------------

    def _start_worker(self):
        if self._work is None:
            self._work = queue.Queue()
            self._worker_thread = threading.Thread(
                target=self._worker, args=(self._work,), daemon=True,
                name=f"llm-worker-{self.name}")
            self._worker_thread.start()

    def _handle(self, item):
        """One queue item, on the worker thread.  A failing REQUEST
        (bad model parameter, broken checkpoint) errors ITS OWN frame
        and is swallowed -- one bad frame must not strand the others."""
        if item[0] == "close":
            self._closing = True       # the worker ends after this tick
        elif item[0] == "request":
            (_, stream_id, text, complete, request_params, model_params,
             qos_info, journal_key, resume, put_time) = item
            try:
                self._ensure_model(model_params)
                request, collected = self._make_request(
                    stream_id, text, request_params)
                request.tenant, request.qos_class, request.qos_rank = \
                    qos_info
            except Exception as error:
                self.logger.exception("LLM request setup failed")
                complete(StreamEvent.ERROR,
                         {"diagnostic": f"llm: {error}"})
                return
            tokenizer, inner_emit = self._tokenizer, request.emit
            journal = getattr(self.pipeline, "journal", None) \
                if journal_key is not None else None

            def emit(request_id, token, finished):
                inner_emit(request_id, token, finished)
                if journal is not None:
                    # Committed-prefix commit point: every
                    # emitted token becomes durable, so an adopter
                    # resumes generation exactly here.  Worker-thread
                    # safe; the fsync is batched.
                    journal.llm_token(journal_key[0], journal_key[1],
                                      int(token))
                if finished:
                    self._completes.pop(request_id, None)
                    complete(StreamEvent.OKAY,
                             {"text": tokenizer.decode(collected)})

            request.emit = emit
            self._completes[request.request_id] = complete
            self._batcher.submit(request)
            record_span("llm.inbox", put_time, request.submit_time,
                        request.request_id)
            if resume:
                # Adopted frame: fold the journaled committed prefix
                # in (prompt + committed re-prefill, budget arithmetic
                # preserved) and pre-seed the collector, so the final
                # text is byte-identical to an uninterrupted run at
                # temperature 0 -- tokens already streamed are never
                # re-generated.
                eos = set(self._tokenizer.eos_tokens)
                collected.extend(int(token) for token in resume
                                 if int(token) not in eos)
                if not self._batcher.resume_request(request, resume):
                    # The prefix already finished the request (the
                    # process died between the final emit and
                    # delivery): complete from the committed tokens
                    # -- resuming would decode a spurious tail.
                    self._completes.pop(request.request_id, None)
                    complete(StreamEvent.OKAY,
                             {"text": tokenizer.decode(collected)})
        elif item[0] == "drain":
            # Cooperative drain: every live request's
            # committed prefix is already journaled per token; cancel
            # them and DROP the parked frames -- no response is sent
            # (the adopter's replay is the response), so the client
            # sees each result exactly once, from the peer.
            completes, self._completes = self._completes, {}
            for request_id, complete in completes.items():
                if self._batcher is not None:
                    self._batcher.cancel(request_id)
                complete(StreamEvent.DROP_FRAME, {})
        else:                           # ("cancel", stream prefix)
            prefix = item[1]
            for request_id in [rid for rid in self._completes
                               if str(rid).startswith(prefix)]:
                self._completes.pop(request_id, None)
                if self._batcher is not None:
                    self._batcher.cancel(request_id)

    def _drain_work(self, work: "queue.Queue"):
        while True:
            try:
                self._handle(work.get_nowait())
            except queue.Empty:
                return

    def _ledger(self):
        """The pipeline's TransferLedger (None outside a pipeline --
        direct construction in tests)."""
        return getattr(getattr(self, "pipeline", None),
                       "transfer_ledger", None)

    def _fault_probe(self, point: str):
        """Chaos injection point ``decode_block`` (faults/plan.py):
        consulted by the batcher before every device-loop block
        dispatch.  A matched rule with ``delay_ms`` hangs the
        dispatch; without, it raises FaultInjected standing in for the
        CUDA error a dying card surfaces mid-generation -- driving the
        same recovery path (``ContinuousBatcher.recover``)."""
        plan = getattr(getattr(self, "pipeline", None), "_faults", None)
        if plan is None:
            return
        rule = plan.should(point, target=self.name)
        if rule is None:
            return
        if rule.delay_ms:
            time.sleep(rule.delay_ms / 1000.0)
            return
        from ..faults import FaultInjected
        raise FaultInjected(
            f"{point} kill injected at {self.name}")

    def _tick(self, batcher):
        """One batcher step.  Device-loop ticks run under the
        transfer-ledger guard: on the card a stray per-token
        device-to-host sync then RAISES under ``transfer_guard:
        disallow`` -- the batcher's only legal host read is the ledger-
        counted per-block fetch it was built with."""
        ledger = self._ledger()
        if batcher.device_loop and ledger is not None:
            with ledger.guard():
                batcher.step()
        else:
            batcher.step()
        self._recover_streak = 0
        self._publish_serving_stats(batcher)

    def _recover(self, batcher, error) -> bool:
        """Replay-from-last-emitted-block after a device-level failure:
        rebuild the cache/page pool and re-queue every live request at
        its committed prefix (ContinuousBatcher.recover).  Gives up --
        letting the worker's error path fail the parked frames -- on
        the THIRD consecutive failed tick (a persistently dying
        device), resetting the streak so the next workload gets its
        own replay attempts.  A host sync caught by the transfer guard
        is a fault of the program, not of the card: it counts on the
        ledger as implicit and is not replayed (a replay would meet it
        again, tick after tick)."""
        ledger = self._ledger()
        if ledger is not None and ledger.is_guard_error(error):
            ledger.record_implicit()
            return False
        self._recover_streak += 1
        if self._recover_streak > 2:
            self._recover_streak = 0
            return False
        revived = batcher.recover()
        self.logger.warning(
            "LLM decode failed (%s); replaying %d request(s) from "
            "their last emitted block", error, revived)
        telemetry = getattr(self.pipeline, "telemetry", None)
        if telemetry is not None:
            telemetry.registry.count("llm_loop_recoveries")
        return True

    def _publish_serving_stats(self, batcher):
        """Per-request latency histograms + speculation counters into
        the telemetry plane (registry is thread-safe; share updates
        marshal onto the event loop)."""
        telemetry = getattr(self.pipeline, "telemetry", None)
        stats = batcher.take_request_stats()
        if telemetry is not None:
            for entry in stats:
                # Tenant/class labels: the per-tenant SLO
                # view needs decode latency split the same way the
                # gateway splits e2e.  Unlabeled when the request
                # carried no QoS context (direct element use).
                labels = {}
                if entry.get("tenant"):
                    labels["tenant"] = str(entry["tenant"])
                if entry.get("cls"):
                    labels["cls"] = str(entry["cls"])
                telemetry.registry.observe("llm_ttft_ms",
                                           entry["ttft_ms"], **labels)
                telemetry.registry.observe("llm_queue_ms",
                                           entry["queue_ms"], **labels)
                telemetry.registry.observe("llm_admission_ms",
                                           entry["admission_ms"], **labels)
                if entry["tokens"] > 1:
                    telemetry.registry.observe("llm_tpot_ms",
                                               entry["tpot_ms"],
                                               **labels)
        changed = False
        hits = batcher.prefix_hits
        lookups = batcher.prefix_lookups
        if hits != self._published_prefix_hits \
                or lookups != self._published_prefix_lookups:
            changed = True
            if telemetry is not None:
                telemetry.registry.count(
                    "llm_prefix_hits",
                    hits - self._published_prefix_hits)
                telemetry.registry.count(
                    "llm_prefix_lookups",
                    lookups - self._published_prefix_lookups)
            self._published_prefix_hits = hits
            self._published_prefix_lookups = lookups
        accepted = batcher.accepted_tokens
        drafted = batcher.draft_tokens
        if accepted != self._published_accepted \
                or drafted != self._published_drafted:
            changed = True
            if telemetry is not None:
                telemetry.registry.count(
                    "llm_accepted_tokens",
                    accepted - self._published_accepted)
                telemetry.registry.count(
                    "llm_draft_tokens",
                    drafted - self._published_drafted)
            self._published_accepted = accepted
            self._published_drafted = drafted
        if not changed:
            return
        pipeline = self.pipeline

        def update_share():
            pipeline.ec_producer.update("llm_accepted_tokens", accepted)
            pipeline.ec_producer.update("llm_draft_tokens", drafted)
            pipeline.ec_producer.update("llm_prefix_hits", hits)
            pipeline.ec_producer.update("llm_prefix_lookups", lookups)
            pipeline.ec_producer.update("llm_spec_probe_ratio",
                                        batcher.spec_probe_ratio)
        pipeline.runtime.engine.post_deferred(update_share)

    def _worker(self, work: "queue.Queue"):
        """Owns every device interaction: lazy model build, admission,
        the decode loop, retire fetches.  Blocks on the queue while
        idle; while decoding, new queue items (requests from frames
        resumed meanwhile, stream cancels) are drained BETWEEN ticks so
        they join the live device batch.  The device lock is held one
        tick at a time (and for each queue item), never for a whole
        drain, and the worker waits at each tick boundary while a
        synchronous frame (``process_frame``) is stepping the shared
        batcher: that frame waits for at most the tick in progress."""
        while not self._closing:
            with span("llm.wait_work", self.name):
                item = work.get()
            try:
                with self._device_lock:
                    self._handle(item)
                    self._drain_work(work)
                while True:
                    self._no_sync_frame.wait()
                    with self._device_lock:
                        batcher = self._batcher
                        if batcher is None or not (
                                batcher.active_count or batcher.queue_depth
                                or batcher.blocks_in_flight):
                            break
                        try:
                            self._tick(batcher)
                        except Exception as error:
                            # Device loss mid-generation: replay every
                            # live request from its last emitted block
                            # before the error path below
                            # gets to fail the parked frames.
                            if not self._recover(batcher, error):
                                raise
                        self._drain_work(work)
            except Exception as error:
                with self._device_lock:
                    # A failing decode tick must FAIL the parked frames,
                    # not leave them parked forever -- the async
                    # analogue of the engine's per-element try/except.
                    # Their requests are CANCELLED too: an errored
                    # frame's request left active would keep decoding
                    # to max_new_tokens in a device batch slot,
                    # crowding out the next frames' requests.
                    self.logger.exception("LLM worker failed")
                    completes, self._completes = self._completes, {}
                    for request_id, complete in completes.items():
                        if self._batcher is not None:
                            self._batcher.cancel(request_id)
                        complete(StreamEvent.ERROR,
                                 {"diagnostic": f"llm worker: {error}"})

    def close(self, timeout: float = 60.0) -> None:
        """End the worker thread and drop the model and its batcher, so
        the card's memory can be freed (``Pipeline.stop`` leaves
        elements as they are).  Requests still queued are dropped."""
        work, self._work = self._work, None
        if work is not None:
            work.put(("close",))
            worker = self._worker_thread
            worker.join(timeout)
            if worker.is_alive():
                raise RuntimeError(f"LLM {self.name}: the worker did not "
                                   f"stop within {timeout} s")
        with self._device_lock:
            self._batcher = None
            self._completes = {}

    def process_frame(self, stream, text=None, **inputs):
        """Blocking path (``synchronous: true`` or direct invocation):
        submits the frame's request to the shared batcher and steps it,
        one tick per hold of the device lock, until THIS request has
        finished -- the async worker's live requests advance in the same
        batch (their completions fire from whichever thread steps), and
        the frame never waits for their drain.  Blocks left in flight
        behind the request are retired here when no other request is
        live (the worker only steps while it has work)."""
        with self._sync_count_lock:
            self._sync_frames += 1
            self._no_sync_frame.clear()
        try:
            return self._process_frame_sync(stream, text)
        finally:
            with self._sync_count_lock:
                self._sync_frames -= 1
                if not self._sync_frames:
                    self._no_sync_frame.set()

    def _process_frame_sync(self, stream, text):
        with self._device_lock:
            self._ensure_model()
            request, collected = self._make_request(
                str(stream.stream_id), text, self._resolve_request_params())
            done = []
            emit = request.emit

            def finish(request_id, token, finished):
                emit(request_id, token, finished)
                if finished:
                    done.append(True)
            request.emit = finish
            batcher = self._batcher
            batcher.submit(request)
        while True:
            with self._device_lock:
                idle = not (batcher.active_count or batcher.queue_depth)
                if done and not (idle and batcher.blocks_in_flight):
                    break
                if not done and idle and not batcher.blocks_in_flight:
                    raise RuntimeError(f"llm: request {request.request_id} "
                                       f"left the batcher unfinished")
                batcher.step()
        return StreamEvent.OKAY, {"text": self._tokenizer.decode(collected)}
