#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels against
their plain PyTorch versions.

    python3 chip_smoke.py

It takes no options: every run drives the full depth and every phase.

Phases (any failure exits non-zero; no phase catches its own failure):

1. build: compile ``aiko_services_tpu_torch/csrc/*.cu`` for sm_90a (one
   nvcc per source, in parallel) and print the build time and the card;
2. kernels: each kernel against its plain version at the serving path's
   shapes, with its error against a stated tolerance, its CUDA-event
   time, its plain version's time, its bound and, where one PyTorch call
   computes the same function, that call's time (``library_ms``; timed
   here only, never used by the port).  The decode forms #1-#3 (the
   tensor-core attention body split over T at one query token, then its
   combine) are held within 1e-4 (f32 queries) and the bf16 tolerance
   (bf16 queries), length-0 rows neutral, the paged form (#3) BITWISE
   against the flat one (#1) on the gathered view at 64- and 16-token
   pages, over bf16 and over int8 caches, and the decode combine against
   the plain combine on the body's partials; top-k (#6, threshold
   select) exactly at k 1, 50 and 128; the int8
   matmul (#5) is held exactly on grid inputs and within a stated
   tolerance on random ones, at the decode and prefill unembed, the
   decode leaves wq/wo, wk, w_up and w_down (M 8, split over D), the
   admission chunk's w_up, w_down and wk (M 512) and the verify
   forward's w_up (M 40) shapes and config 5's Llama-3.2-1B ones, and
   its decode route's combine exactly against the plain combine;
   prefill attention (#4) at offsets 0 and 1536; the chunk-verify
   kernel (speculative decoding's verify step, S 5: the tensor-core
   body split over T, then its combine) stacked
   and paged, bf16 and int8, f32 and bf16 queries, the paged form
   BITWISE against the stacked form on the gathered view at 64- and
   16-token pages, and the combine against the plain combine on the
   body's partials;
3. serving: ``ContinuousBatcher`` on Llama-3-8B widths (random weights
   from a seed) with flash prefill, flash decode and top-k sampling:
   dense at decode_block 1 and 4, then paged (64-token pages) at full
   provisioning, under pool pressure (97 pages, decode_block 4, one
   block in flight) and with
   the shared-prefix cache.  Every launch counter is zeroed just before
   each run and read just after; every request must finish, every
   kernel of the run's path must have launched (the stacked decode
   kernel on the dense runs, the paged one on the paged runs, never the
   other), the greedy streams must agree as each run states, and
   kernel-path logits must agree with the dense reference settings on
   the same prefill and decode step;
4. the device-resident loop (``decode_block_tokens=16``, every block a
   replay of one captured CUDA graph), bf16 tree: plain over the dense
   cache (#2, #4, #6; greedy streams equal to dense-1's), ngram
   speculation over 64-token pages (the paged verify kernel, never a
   decode kernel), int8 self-draft speculation over the dense cache (the
   stacked verify kernel and #5 on every draft step) and a fault at the
   3rd dispatch with recover(); every request finishes, no page leaks,
   speculative runs draft tokens and the draft run accepts some.  Then
   the verify step's logits against 5 sequential decode steps on the
   same cache, one captured block replayed twice from the same inputs
   at temperature 0.8 (the draws must differ), and one block's device
   time in each mode;
5. int8 serving: the same weights quantized (``quantize_params``, the
   bf16 tree freed) with ``kv_dtype="int8"``: dense at decode_block 4,
   paged at full provisioning, decode_block 1, and the ngram device loop
   over 64-token pages -- #5 (its admission route on every run, its
   decode route on the two host-loop runs), the int8 decode or verify
   kernels, #4 and #6 must launch, no bf16 attention kernel may (#5's
   routes are counted apart); greedy streams equal
   across the first two, no leaked page; kernel-path logits within 5 %
   of the plain path on the same quantized tree;
6. the pipeline: a ``(CAP (LLM))`` definition through the port's
   ``create_pipeline`` on the loopback transport, eight frames of
   detections (one empty) captioned by ``DetectionCaption`` and served
   by the ``LLM`` element at Llama-3-8B widths (``model: llama3-8b``,
   full depth, random weights from seed 0, each element drawing its own
   tree) with a 1,127-byte system prompt: ``pipeline-loop-16`` (the
   device loop under ``transfer_guard: disallow``: #2, its combine, #4,
   #6; one ledger fetch per retired block, no guard error) and
   ``pipeline-paged-4`` (64-token pages, decode_block 4, the prefix
   cache: #3, its combine, #4, #6; prefix page hits, no leaked page).
   Every frame must complete OKAY with the text -- and the token ids --
   that the port's ``ContinuousBatcher`` gives when run directly with
   the element's settings on the element's weights and prompts.  Each
   run prints frames/s, wall per frame, the first frame's latency, the
   model build, the host time in admission and decode, the engine's
   inbound and return hops, and peak memory;
7. config 4: ``(DET (CAP (LLM)))`` through ``create_pipeline``, the
   ``Detector`` at YOLO-n scale (width 32, depth 1, 80 classes) placed
   on the card by a placement block, the ``LLM`` as in
   ``pipeline-loop-16``; 8 frames of 640x640x3 uint8 from a numpy seed,
   the first alone, then 7 at once.  Beside the pipeline runs' gates
   (every frame OKAY and equal to the direct batcher, one ledger fetch
   a retired block, no guard error, #2 + combine, #4 and #6 and no
   other kernel): fewer detect dispatches than frames, LLM decode steps
   below 0.6 x frames x new tokens, no failed card in the health probe,
   and a captured batch-8 ``detect`` replay equal to the eager call
   (``valid`` and ``classes`` exactly, boxes and scores within
   DETECT_TOL).  It prints the detect replay's, its forward's and the
   eager call's device ms (CUDA events) beside detect's bound, the
   detect captures' seconds and the ``DET_time``/``LLM_time`` medians;
8. config 5: ``(ASR (GATE (LLM)))`` through ``create_pipeline`` under
   ``transfer_guard: disallow``, as ``bench.py`` drives it: the
   streaming ``ASR`` at Whisper-base widths (1 s hops, a 0.5 s energy
   endpoint), ``TextFilter`` on ``utterance_end``, the ``LLM`` at
   Llama-3.2-1B widths with int8 weights (``max_seq`` 512,
   ``decode_block`` 16, ``inflight`` 3); numpy seed 0, 1 s hops of
   N(0, 0.3) speech or zeros: a warm-up utterance of 3 speech hops and a
   silence hop, then 3 more.  Gates: one OKAY reply an utterance and no
   other response, 4 LLM requests (12 speech hops drop at the gate), 12
   partial decodes and 4 finalised chunks, every reply equal (text,
   token ids) to the direct batcher, no guard error, ledger fetches =
   blocks retired, #5's two routes and ``int8_combine`` and no other
   kernel, a captured batch-1 ``transcribe`` replay equal to the eager
   call's token ids, streaming push/flush joined equal to whole-chunk
   transcription.  It prints the capture's seconds, the replay's and
   the eager call's device ms (CUDA events) beside ``transcribe``'s
   bound, the per-hop p50 through a gate-free ``(ASR)`` pipeline, the
   utterance -> reply p50, the peak memory and one base-width TTS
   ``synthesize`` of the first reply (finite, peak 1);
9. the fusion chain: ``bench.py``'s ``bench_pipeline_fusion``,
   ``(R1 (R2 (DET)))`` through ``create_pipeline`` -- two synchronous
   ``ImageResize`` elements (512, then 640) and a synchronous ``Detector`` at
   phase 7's YOLO-n scale -- under ``transfer_guard: disallow`` and
   ``device_inflight: 3``, 24 frames cycling through 4 frames of
   576x576x3 uint8 (numpy seed 0), with ``fuse: auto`` and then ``fuse:
   off``.  Gates: every frame OKAY; with ``auto`` one segment, none
   broken (a capture that failed would have fallen back to per-element
   execution with equal outputs), one segment and one dispatch every
   frame and the segment's cache at 1 miss and 23 hits; with ``off``
   three dispatches every frame; 24 explicit transfers (the detector's
   finalize fetch) and no implicit one with ``auto``; every frame's
   image bitwise equal and its detections and overlay equal between the
   modes; no launch of any kernel of the port (none is on this path).
   Then 8 frames from two streams at once through one ``ImageResize``
   on its async path: fewer dispatches than frames, every row equal to
   the synchronous resize.  It prints both modes' steady frames/s, the
   dispatch overhead a frame under bench.py's key names, the segment's
   capture seconds, dispatch p50/p99 and one call's device ms (with the
   share of a fused frame's wall it covers), and the peak memory above
   what the card held before each mode;
10. checkpoints and the command line (``checkpoint-cli``): a Hugging
    Face snapshot of Llama-3.2-1B at its published widths (dim 2048, 16
    layers, 32/8 heads, FFN 8192, vocab 128,256: 1.50 B parameters,
    3.0 GB) written from ``init_params(0)`` as ``config.json`` and two
    bf16 shards by the port's safetensors writer, each projection
    transposed back to [out, in]; ``python3 -m aiko_services_tpu_torch
    convert llama SRC DST --max-seq 512`` as a subprocess (exit 0, the
    inferred config equal to ``llama3_1b`` at max_seq 512); a restore
    onto the card, every leaf ``torch.equal`` to the source; ``(LLM)``
    through ``create_pipeline`` under ``transfer_guard: disallow`` with
    ``CONFIG5_LLM`` plus ``checkpoint``, then without it (seed 0): every
    reply's token ids and text equal, #5's two routes and
    ``int8_combine`` launched and no other kernel, no implicit
    transfer, the build's peak above what the card held at most 1.1 x
    the seed-0 build's; the seed-0 pipeline under ``Profiler.attach``
    for 3 frames, one at a time: one ``element:LLM`` span a frame in
    the Chrome trace, each holding #5's kernel events; the Detector at
    phase 9's scale from a checkpoint of its own ``init_params(0)``:
    detections of 4 frames bitwise equal to a seed-0 Detector's.  It
    prints the snapshot, conversion and restore seconds, the build
    seconds and peaks and the trace's size.  The temporary directory
    (6 GB) is removed at the end, also on a failure;
11. training and the mixture-of-experts (``train-moe``), every launch
    counter zeroed before each part.  (a) ``models/train.py`` on
    Llama-3.2-1B at its published widths (``max_seq`` 512, bf16,
    ``init_train_state(0)``, AdamW at 3e-4): 5 steps on one 4 x 512
    batch (numpy seed 0); every loss finite, the 5th below the 1st, the
    1st within 2e-2 (relative) of the cross-entropy of the serving
    path's logits (``prefill_into_slot``, row by row) on the same
    tokens; then ``remat=True``
    and ``accumulate_steps=2`` from the same init, 2 steps each: first
    losses within 1e-2 and 5e-2 of the plain one and the remat peak
    below the plain peak; no kernel launch.  (b) a 4-expert MoE at
    those widths (``tiny_moe``'s top-2 routing and capacity factor 2.0,
    ``max_seq`` 2048, flash prefill and decode, seed 0) serving phase
    3's 8 requests at ``sample_top_k=50``: dense at decode_block 4, the
    captured loop (``decode_block_tokens=16``), paged (64-token pages)
    at decode_block 1 and the ngram device loop over pages, each run
    launching its path's kernels and no other (``run_plan``); every
    request finishes, no page leaks, greedy streams equal across the
    first three, kernel-path logits within LOGITS_TOL of the dense path
    (``check_dense_agreement``); then ``(CAP (LLM))`` with ``model:
    tiny-moe`` through ``create_pipeline`` under ``transfer_guard:
    disallow`` on the device loop: every frame OKAY and equal to the
    direct batcher, one ledger fetch a retired block, top-k alone
    launched.  (c) the MoE at ``max_seq`` 512 with ``remat=True``, 3
    steps on 2 x 512 tokens: losses (CE + 0.01 aux) finite, the last
    below the first, the aux at init printed; no kernel launch.  (d)
    config 5's ASR (Whisper-base widths, bf16) on ``test_asr_fit.py``'s
    tone corpus (numpy seed 7), 5 ``Adam(3e-3)`` steps, and the base
    TTS, 3 steps on ``tts_loss``: losses finite, the last below the
    first; no kernel launch.  It prints each mode's step ms (CUDA
    events, steps 2 on), tokens/s, peak above what the card held and,
    for 11a, 6 N tokens / step time as a share of 989 TF/s; 11b's runs
    as phase 3's and the MoE decode step's ms;
12. context parallelism (``context-parallel``): ONE card stands for
    every position of a mesh (``make_mesh`` lists it once a position),
    so every hop, mask and reduction runs at full width and no copy
    between cards is measured.  (a) ``make_long_context_forward`` on
    Llama-3-8B (its published widths and 8,192-token context, bf16,
    ``init_params(0)``), tokens from numpy seed 0: ring and Ulysses
    over ``{"sp": 4}`` at B 1, S 8,192, and ring over ``{"dp": 2, "sp":
    2, "tp": 2}`` at B 2, S 4,096 (Megatron blocks, a ``psum`` over tp);
    each forward's logits finite, whole, on the card and within
    LOGITS_TOL of ``llama.prefill`` of the same tokens (plain attention:
    it launches no kernel either).  (b) one backward of
    ``make_long_context_loss`` (ring, ``{"sp": 4}``) on Llama-3.2-1B at
    its published widths, B 1, S 2,048: the loss within CP_LOSS_TOL of
    ``train.language_model_loss`` on the same tokens and the whole
    gradient's relative L2 to that loss's gradient within CP_GRAD_TOL.
    No kernel of the port is on this path (the JAX package computes its
    blocks with einsums): every counter, zeroed before each sharded run,
    must read 0 after it.  It prints each run's CUDA-event ms (a first
    and a second call) and peak above what the card held, the dense
    reference's, and the errors;
13. the sharded model step on placed trees (``sharded-step``): ONE card
    stands for every position of each mesh, so a replica is stored
    once and no copy between cards is measured; each one-position
    reference runs first and is freed before its sharded run.  (a)
    ``models/train.py`` on Llama-3.2-1B at its published widths
    (``max_seq`` 512, bf16, seed 0) over SHARDED_MESH, ``{"dp": 1,
    "fsdp": 2, "tp": 4}`` (``_factor_axes(8)``), on phase 11a's 4 x 512
    batch: the first loss within SHARDED_LOSS_TOL of the one-position
    step's, each gradient leaf's relative L2 to the one-position
    gradient within SHARDED_GRAD_TOL, the placed tree holding the
    parameter count exactly (each replica stored, and stepped, once)
    with every replica group equal, losses finite and falling over 3
    steps; then ``remat=True`` and ``accumulate_steps=2``, 2 steps each
    (first losses within 1e-2 and 5e-2); one more step of the plain
    sharded and one-position runs profiled for the device's busy share,
    and one forward and its backward timed apart.  (b) phase 11c's MoE (4
    experts, top-2, capacity factor 2.0, remat, 2 x 512) over
    ``{"dp": 2, "ep": 2, "tp": 2}``: the first loss within
    SHARDED_LOSS_TOL of the one-position step's, the routes dropped
    (``llama.record_route_drops``) equal to the one-position path's,
    losses falling.  (a) and (b) launch no kernel.  (c) Llama-3-8B
    (published widths, seed 0) through ``quantize_params`` with
    ``kv_dtype="int8"``, ``max_seq`` 2048, flash attention, placed by
    ``quantize_specs`` over ``{"tp": 2}``: phase 3's 8 prompts through
    ``prefill_into_slot`` one at a time into one 8-row cache placed by
    ``cache_specs``, then 8 ``decode_step`` calls of every row, fed the
    one-position path's greedy tokens: logits within LOGITS_TOL of the
    one-position int8 path's at each prefill and each step, the steps
    whose argmax agrees printed; #2 (int8), ``decode_combine``, #4 and
    both routes of #5 launched exactly twice the one-position run's
    counts (``int8_combine`` printed) and no other kernel.  It prints
    each run's step ms (CUDA events, steps 2 on), peak above what the
    card held, the one-position run's beside it, and 13c's prefill and
    decode-step ms.  (d) ``serving-tp-int8``: 13c's tree served by
    ``ContinuousBatcher`` with ``cache_put`` placing its cache
    (``cache_specs``, or ``paged_cache_specs`` for pages), phase 3's 8
    requests at SERVING_TP_TOKENS new tokens (top-k 50, 8 slots,
    512-token chunks): dense at decode_block 4 (``inflight`` 2), paged
    (64-token pages) at decode_block 1, the captured device loop
    (``decode_block_tokens=16``) and the ngram loop over pages (4 draft
    tokens), each first on the unplaced tree, every launch counter
    zeroed before each run.  Gates: every request finishes; the greedy
    streams of the three plain runs equal those of the placed
    ``prefill_into_slot`` / ``decode_step`` driven by hand on the same
    tree (same slots, chunks and positions; the ngram run's agreement
    is printed); the loops capture once and replay every block (none
    eager); each run launches its path's kernels and no other -- #2 or
    #3 (int8), ``decode_combine``, #4, #5's two routes and
    ``int8_combine``, #6; the ngram run the paged int8 verify,
    ``verify_combine``, #4, #5's M > 16 route and #6 -- the model's
    kernels exactly twice the one-position run's counts (top-k, which
    samples the whole logits, once; ``int8_combine`` printed), the
    ngram run's verify kernel and combine exactly twice 32 layers x (12
    iterations x replays + 1).  It prints each run's tokens/s, the
    hand-driven decode-step and admission-chunk ms (CUDA events) and
    the one-position run's beside each.  (e) ``moe-dp2-burst``: phase
    11b's MoE (4 experts, top-2, capacity factor 2.0, bf16, flash, seed
    0) placed over ``{"dp": 2, "tp": 2}``: a burst of 4 chunk rows of
    512 tokens (numpy seed 11) into slots 3, 0, 2, 1 of a 4-row cache
    split over dp (both groups, out of order) through one
    ``prefill_into_slots`` (dense: the batched admission is dense-only),
    at capacity factor 2.0 and at MOE_DP_DROPPING (routes drop): its
    logits within LOGITS_TOL of max |logit| of the same burst on ``{"tp":
    2}`` (one group holds every row, so it routes the burst whole, with
    the same tp arithmetic) and its routes dropped
    (``llama.record_route_drops``) equal to that burst's, some dropped
    at MOE_DP_DROPPING, no kernel launched; the unplaced call's error
    and drops are printed beside (its bf16 sums differ from tp's, which
    flips router near-ties); then ``ContinuousBatcher``
    over the placed tree (4 slots, 512-token chunks, top-k 50) serving
    4 greedy prompts of 100-500 tokens (numpy seed 12) at MOE_DP_TOKENS
    new tokens, at decode_block 4 (``inflight`` 2) and through the
    captured device loop (``decode_block_tokens=16``, every block a
    replay): the two runs' streams equal, each launching #2, its
    combine, #4 and #6 and no other kernel.  It prints the burst's
    error and drops, each run's tokens/s and launches, the phase's
    seconds and its peak above what the card held;
14. config 4 with DET over two dp positions (``config4-dp2-loop-16``):
    phase 7's definition, frames and LLM with DET placed by
    ``placement: {mesh: {dp: 2}}``.  For the run the device pool
    (``device.local_devices``) lists the one card twice, as the CPU
    tests stand CPU descriptors in for cards, so DET's stage has two
    positions on it: the ``Detector`` puts its weights once, pads each
    micro-batch to a multiple of 2 (the first frame alone too) and runs
    each position's rows in turn on the card's worker stream.  Beside
    the pipeline runs' gates (every frame OKAY and equal to the direct
    batcher, #2 + combine, #4 and #6 and no other kernel): detections
    equal to phase 7's where both ran one batch shape (the first frame;
    the burst as one batch of 8 on the lead card), every frame's equal to
    its position's rows run at the same shape on one position (the same
    classes, boxes and scores within DETECT_TOL), both positions
    dispatched every micro-batch, fewer micro-batches than frames, LLM
    decode steps below 0.6 x frames x new tokens and no failed card.  It
    prints each position's micro-batches and rows, the detect graphs and
    their cards, the burst's agreement with phase 7's beside one card's
    batch 8 against two batches of 4, the ``DET_time`` median beside
    phase 7's and the phase's seconds;
15. the multi-host backend (``multihost``): 15b's one-process run (two
    train steps of Llama-3.2-1B, phase 11a's batch, over ``{"fsdp":
    2}`` with the card listed twice), then two child processes started
    by ``subprocess`` that share the card and meet through
    ``torch.distributed`` (the coordinator on 127.0.0.1 at a port bound
    at 0 first; gloo, since one card is listed by both, and the phase
    prints it), each running: 15a, 13c's placed int8 path over ``{"tp":
    2}`` with position 0 in process 0 and position 1 in process 1 (each
    builds the seed-0 tree, quantizes it and puts its own shard, the two
    in turns so only one bf16 tree is on the card; the launch counters
    zeroed just before it), fed 13c's one-position
    greedy tokens: its logits bitwise equal (SHA-256 of each call's
    bytes) to 13c's placed run with the card listed twice, its greedy
    tokens equal, and each process launching exactly one position's
    kernels, half of 13c's placed counts; 15b over ``{"fsdp": 2}``
    with a position a process: the losses and the updated tree's
    SHA-256 equal to the one-process run's, each process's peak
    printed; 15c, a ``(det llm)`` pipeline of ``StageWork`` over
    ``mesh: {hosts: 2, coordinator}``, ``det`` on host 0 and ``llm`` on
    host 1: 4 frames of 1024 x 1024 ones in order in both processes,
    process 1 holding ``llm``'s tensors and process 0 handles naming
    process 1; 15d, right after 15a on 15a's placed tree (none is built
    again), ``ContinuousBatcher`` with ``cache_put`` placing its cache,
    phase 3's 8 requests at MULTIHOST_BATCHER_TOKENS new tokens (8
    slots, 512-token chunks, top-k 50, ``rng_seed`` 0): dense at
    decode_block 4 (``inflight`` 2), then paged (64-token pages, a full
    pool) at decode_block 1, every launch counter zeroed before each
    run; every stream, greedy and sampled, equal to the same run's at
    the end of phase 13d (one process, ``{"tp": 2}`` with the card
    listed twice), no leaked page, each process launching exactly half
    that run's counts of every kernel (#2 or #3 int8, the combines, #4,
    #5's two routes) and its whole count of top-k (each process samples
    the whole rows); then the captured loop's batcher
    (``decode_block_tokens=16``), which must raise at construction,
    naming gloo and the shared card.  Before the children start it
    prints the card's free memory and the card tensors this process
    still reaches.  Each child
    writes to a file of its own; a child that fails or outlasts
    MULTIHOST_TIMEOUT_S fails the phase; the children's lines are
    printed first, prefixed with their process, and on a failure their
    last lines also go to standard error;
16. remote stages over the data plane, and replicas on the card, every
    launch counter zeroed before each part.  (a) ``bench.py``'s
    ``bench_pipeline_transport`` shape on the card, both pipelines in
    this process under ``transfer_guard: disallow`` (the loopback
    broker, a registrar, the pipe on 127.0.0.1): ``(work (fwd))`` --
    ``StageWork`` (factor 1, no wait) placed on the card, so the hopped
    ``x`` is a card tensor, then a remote stage -- forwarding to
    ``(inc)``, an ``Identity`` placed on the card; a (1024, 2048, 3)
    uint8 frame (numpy seed 0) in pinned memory, 10 round trips over
    the pipe, then 6 with ``data_plane: mqtt``, then the frame as bf16
    10 times over the pipe (its tagged integer view).  Gates: every
    reply OKAY and exactly ``x * 1.0``; one counted ledger fetch a
    forward; over the pipe, ``pipe_frames`` equal to the hops on both
    sides, no fallback, the back's head given the payload on its card
    (one pinned upload a hop, ``StagePlacement.uploads``) and one
    counted fetch a response; over MQTT, ``mqtt_frames`` equal to the
    hops; no guard error; no kernel launched.  It prints the hops' p50
    and p99 ms and the wire bytes against the raw bytes a round trip.
    (b) config 4 split over the data plane (``config4-remote-loop-16``):
    ``(DET (fwd))`` -- phase 7's detector placed on the card, its image
    and detections forwarded -- to ``(CAP (LLM))`` with the LLM as in
    ``pipeline-loop-16``; phase 7's 8 frames as pinned tensors (so the
    image the pipe carries lies on the card), the first alone, then 7
    at once.  Gates: 8/8 replies equal to phase 7's; #2, its combine,
    #4 and #6 and no other kernel, ``flash_attention`` exactly phase
    7's 768, top-k once and #2 and ``decode_combine`` 32 times a loop
    iteration (a warm-up a capture, 16 a replay); LLM steps below 0.6 x
    frames x new tokens; every forward over the pipe with one counted
    fetch, one fetch a retired block; no guard error, no fallback.
    (c) the replica failover of ``__graft_entry__.py``'s
    ``[replica-failover]`` section (10) on the card, the device pool
    (``device.local_devices``) listing it five times for the run: three
    ``StageWork`` replicas of ``detect`` (``busy_ms`` 20), ``llm``, a
    spare; ``device_kill`` on ``detect#1`` fired by the health probe
    mid-flight, ``replica_rebuild_ms`` 80, 9 frames then 6 (16 x 16
    float32, numpy seed 0, pinned).  Gates: the JAX section's (every
    frame OKAY and in order, one peer-shed failover, the rule fired
    once, a rebuild, slot 1 dead then half-open, three live slots at
    the end), the killed position alone gone (four of the five left),
    every reply ``x * 4`` on the card, no kernel launched.

The last two lines are the card (``nvidia-smi``), a ``{"kernels": ...}``
line (each kernel's ``launches`` over every serving and pipeline run,
the pipeline runs' own under ``pipeline_launches``, phase 9's zero
under ``fusion-chain``, phase 10's under ``checkpoint-cli``, phase 11's
(11b's, with 11a's, 11c's and 11d's zeros) under ``train-moe``, phase
12's zeros under ``context-parallel``, phase 13's (13c's placed run)
under ``sharded-step``, 13d's (its four placed batcher runs) under
``serving-tp-int8`` (with 15d's one-process reference runs, made at
its end on its tree), 13e's (its two batcher runs) under
``moe-dp2-burst``, phase 14's under ``config4-dp2-loop-16``, phase
15's (both processes' 15a and 15d together) under ``multihost``,
phase 16b's under ``config4-remote-loop-16``; the
entries on config 4's and config 5's paths carry ``"path"`` and their
run's launches, phase 14's as ``config4_dp2_launches``), then ``{"ok":
true, "device": {...}}``.  It imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import queue
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

DECODE_TOL = 1e-4       # f32 queries: the two differ in summation order only
ATTENTION_TOL = 2e-2    # bf16 out: exp in bf16 against a running max per tile
BF16_TOL = 2e-2         # bf16 softmax weights: one-ulp flips (0.4%) of a weight
LOGITS_TOL = 0.05       # kernel path vs dense path, relative to max |logit|
# int8 matmul on random bf16 inputs, relative to max |out|: both round the
# same f32 sum (up to order) to bf16 once, so at most one bf16 step (2^-8
# of a value) apart; two steps of the largest value allowed.
INT8_MATMUL_TOL = 2.0 ** -7


def fail(message: str, code: int = 1):
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_line() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return result.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float, flop_type: str):
    """(least time in ms, what bounds it) at the card's peaks."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[flop_type]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def attention_bound_ms(n_bytes: float, live_tokens: int, queries: int,
                       head_dim: int, f32_queries: bool):
    """bound_ms of the split attention body (decode and verify): the
    bytes given, and its operations as the tensor cores run them -- 4 a
    (cached position, query, dim), in bf16, twice over for f32 queries
    (their hi and lo products)."""
    flops = 4 * live_tokens * queries * head_dim * (2 if f32_queries else 1)
    return bound_ms(n_bytes, flops, "bf16")


# -- phase 2: kernels -------------------------------------------------------

def _decode_error(got, want) -> float:
    """Largest of the normalised-output, running-max and relative
    denominator differences of two (acc, m, l) triples."""
    import torch
    (acc, m, l), (acc_r, m_r, l_r) = got, want
    live = (l_r > 0)[..., None]
    out = torch.where(live, acc / l[..., None], acc)
    out_r = torch.where(live, acc_r / l_r[..., None], acc_r)
    return max((out - out_r).abs().max().item(),
               (m - m_r).abs().max().item(),
               ((l - l_r).abs() / l_r.clamp(min=1.0)).max().item())


def _bitwise(got, want) -> bool:
    import torch
    return all(torch.equal(a, b) for a, b in zip(got, want))


def check_decode(device) -> list[dict]:
    """flash_decode_attention_stacked (#2: the split body at one query
    token, then its combine) at llama3-8b decode shapes: f32 scaled
    queries [8, 32, 128] against a [32, 8, 2048, 1024] bf16 cache,
    ragged lengths including 0 and T-1; then decode_combine alone on the
    body's own partials against the plain combine."""
    import torch
    from aiko_services_tpu_torch.kernel_times import graph_ms
    from aiko_services_tpu_torch.ops import flash_decode as fd
    gen = torch.Generator(device=device).manual_seed(1)
    n_layers, b, t, kv, hd, h = 32, 8, 2048, 8, 128, 32
    k = torch.randn((n_layers, b, t, kv * hd), generator=gen, device=device,
                    dtype=torch.float32).to(torch.bfloat16)
    v = torch.randn_like(k, dtype=torch.float32).to(torch.bfloat16)
    q = torch.randn((b, h, hd), generator=gen, device=device).to(
        torch.bfloat16)
    q_scaled, _ = fd._prep_query(q, hd)
    lengths = torch.tensor([0, 2047, 1, 1500, 513, 64, 2046, 1024],
                           device=device, dtype=torch.int32)
    layer = 17
    errors = {}
    # The f32 queries are the serving path's (head_dim 128).  The bf16 branch
    # (power-of-two scales) rounds each softmax weight to bf16, and a
    # weight whose f32 value differs in summation order can round to the
    # neighbouring bf16 value: the bf16 tolerance.
    for q_in, tol in ((q_scaled, DECODE_TOL),
                      (q_scaled.to(torch.bfloat16), BF16_TOL)):
        acc, m, l = fd.flash_decode_attention_stacked(
            q_in, k, v, layer, lengths)
        acc_r, m_r, l_r = fd.flash_decode_attention_stacked_reference(
            q_in, k, v, layer, lengths)
        torch.cuda.synchronize()
        err = _decode_error((acc, m, l), (acc_r, m_r, l_r))
        if acc[0].abs().max() != 0 or l[0].abs().max() != 0 \
                or (m[0] != -1e30).any():
            raise AssertionError("decode: a length-0 row must give acc=0, "
                                 "l=0, m=-1e30")
        print(f"decode q={q_in.dtype}: max_abs_err {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"decode kernel disagrees: {err} > {tol}")
        errors[q_in.dtype] = err
    worst = errors[torch.float32]
    ms = graph_ms(lambda: fd.flash_decode_attention_stacked(
        q_scaled, k, v, layer, lengths))
    plain = graph_ms(lambda: fd.flash_decode_attention_stacked_reference(
        q_scaled, k, v, layer, lengths), iters=5)
    # Yardstick: SDPA over the same cache view (normalised output, no
    # m/l), lengths as a boolean mask.
    kg = k[layer].reshape(b, t, kv, hd).transpose(1, 2) \
        .repeat_interleave(h // kv, dim=1)
    vg = v[layer].reshape(b, t, kv, hd).transpose(1, 2) \
        .repeat_interleave(h // kv, dim=1)
    mask = (torch.arange(t, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qs = q.float().to(torch.bfloat16)[:, :, None, :]
    library = graph_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask))
    # Bytes: the live k/v rows (bf16), the f32 queries in, acc/m/l out.
    live_tokens = int(lengths.sum().item())
    n_bytes = 2 * live_tokens * kv * hd * 2 \
        + q_scaled.numel() * q_scaled.element_size() + b * h * (hd + 2) * 4
    bound, by = attention_bound_ms(n_bytes, live_tokens, h, hd, True)
    combine = _check_combine(
        "decode_combine", 387,
        fd.flash_decode_partials_stacked(q_scaled, k, v, layer, lengths),
        fd.decode_combine, fd.decode_combine_reference)
    return [{"name": "flash_decode_attention_stacked", "route": "cuda",
             "source": "aiko_services_tpu_torch/csrc/flash_verify.cu",
             "replaces": "aiko_services_tpu/ops/pallas_decode.py:387",
             "max_abs_err": worst, "ms": ms, "plain_ms": plain,
             "bound_ms": bound, "bound_by": by, "library_ms": library},
            combine]


def check_attention(device) -> dict:
    """flash_attention at the first and the last admission chunk of a
    2048-token prompt: q [1, 512, 32, 128] against k/v [1, 2048, 8, 128]
    bf16 at q_offset 0 and 1536, each within ATTENTION_TOL of the plain
    version and timed beside SDPA; the line's numbers are offset 1536's.
    Then the form the captured admission chunk launches: k/v a whole
    cache layer of 16 and of 32 slots, ``at`` (a middle slot, 1536) on
    the card, within ATTENTION_TOL of the plain version, bit for bit the
    host-int launch on that slot's row, and timed beside it."""
    import torch
    from aiko_services_tpu_torch.kernel_times import graph_ms
    from aiko_services_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(2)
    b, s, h, t, kv, d = 1, 512, 32, 2048, 8, 128
    q = torch.randn((b, s, h, d), generator=gen, device=device).to(
        torch.bfloat16)
    k = torch.randn((b, t, kv, d), generator=gen, device=device).to(
        torch.bfloat16)
    v = torch.randn((b, t, kv, d), generator=gen, device=device).to(
        torch.bfloat16)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(h // kv, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(h // kv, dim=1)
    shapes = {}
    for offset in (0, 1536):
        out = fa.flash_attention(q, k, v, q_offset=offset)
        ref = fa.flash_attention_reference(q, k, v, offset)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        print(f"attention q_offset={offset}: max_abs_err {err:.3e} "
              f"(tol {ATTENTION_TOL})")
        if not err <= ATTENTION_TOL:
            raise AssertionError(f"attention kernel disagrees: {err}")
        ms = graph_ms(lambda: fa.flash_attention(q, k, v, q_offset=offset))
        plain = graph_ms(lambda: fa.flash_attention_reference(q, k, v,
                                                             offset),
                        iters=5)
        mask = torch.arange(t, device=device)[None, :] \
            <= offset + torch.arange(s, device=device)[:, None]
        library = graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        pairs = sum(min(t, offset + i + 1) for i in range(s))
        flops = 4 * b * h * d * pairs
        n_bytes = (2 * q.numel() + 2 * k.numel()) * 2
        bound, by = bound_ms(n_bytes, flops, "bf16")
        shapes[f"q_offset={offset}"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": library, "max_abs_err": err,
            "tflops": flops / ms / 1e9}
        print(f"attention q_offset={offset}: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s; plain {plain:.4f}, SDPA "
              f"{library:.4f}, bound {bound:.4f} by {by})", flush=True)
    offset = 1536
    for slots in (16, 32):
        layer_k, layer_v = (torch.randn((slots, t, kv, d), generator=gen,
                                        device=device).to(torch.bfloat16)
                            for _ in range(2))
        slot = slots // 2
        at = torch.tensor([slot, offset], dtype=torch.int32, device=device)
        row_k, row_v = layer_k[slot:slot + 1], layer_v[slot:slot + 1]
        out = fa.flash_attention(q, layer_k, layer_v, at=at)
        ref = fa.flash_attention_reference(q, layer_k, layer_v, at=at)
        host = fa.flash_attention(q, row_k, row_v, q_offset=offset)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        same = torch.equal(out, host)
        print(f"attention at=({slot} of {slots}, {offset}): max_abs_err "
              f"{err:.3e} (tol {ATTENTION_TOL}); bit for bit the host-int "
              f"launch: {same}")
        if not err <= ATTENTION_TOL or not same:
            raise AssertionError(f"attention kernel with at disagrees: "
                                 f"{err}, host-int equal {same}")
        ms = graph_ms(lambda: fa.flash_attention(q, layer_k, layer_v, at=at))
        host_ms = graph_ms(lambda: fa.flash_attention(q, row_k, row_v,
                                                      q_offset=offset))
        shapes[f"at=({slot} of {slots}, {offset})"] = {
            "ms": ms, "host_int_ms": host_ms, "max_abs_err": err}
        print(f"attention at=({slot} of {slots}, {offset}): {ms:.4f} ms "
              f"(host-int launch on the row {host_ms:.4f})", flush=True)
        del layer_k, layer_v
    return {"name": "flash_attention", "route": "cuda",
            "source": "aiko_services_tpu_torch/csrc/flash_attention.cu",
            "replaces": "aiko_services_tpu/ops/pallas_attention.py:138",
            **{key: value for key, value in shapes["q_offset=1536"].items()
               if key != "tflops"},
            "max_abs_err": max(entry["max_abs_err"]
                               for entry in shapes.values()),
            "shapes": shapes}


def check_topk(device) -> dict:
    """topk on [8, 128256] f32 logits with planted ties and one mostly
    -inf row, at k 1, 50 and 128; exact agreement with the plain version
    (values and indices), no duplicate index."""
    import torch
    from aiko_services_tpu_torch.kernel_times import graph_ms
    from aiko_services_tpu_torch.ops.topk import topk, topk_reference
    gen = torch.Generator(device=device).manual_seed(3)
    b, vocab = 8, 128_256
    x = torch.randn((b, vocab), generator=gen, device=device)
    x[0, [7, 70_000, 128_255, 3]] = 9.0               # tied maxima
    x[1, 1000:1100] = 5.0                             # a 100-way tie
    x[2] = float("-inf")                              # mostly -inf
    x[2, [5, 90_000]] = 1.0
    x[3, ::2] = 0.25                                  # ties everywhere
    for k in (1, 50, 128):
        values, indices = topk(x, k)
        ref_v, ref_i = topk_reference(x, k)
        torch.cuda.synchronize()
        if not (torch.equal(values, ref_v) and torch.equal(indices, ref_i)):
            raise AssertionError(f"topk kernel disagrees at k={k}")
        for row in indices.tolist():
            if len(set(row)) != k:
                raise AssertionError(f"topk: duplicate index at k={k}")
        print(f"topk k={k}: exact (values and indices)")
    ms = graph_ms(lambda: topk(x, 50))
    plain = graph_ms(lambda: topk_reference(x, 50), iters=5)
    library = graph_ms(lambda: torch.topk(x, 50))
    n_bytes = x.numel() * 4 + b * 50 * 8
    bound, by = bound_ms(n_bytes, x.numel(), "f32")
    return {"name": "topk", "route": "cuda",
            "source": "aiko_services_tpu_torch/csrc/topk.cu",
            "replaces": "aiko_services_tpu/ops/pallas_topk.py:146",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": library}


def check_paged(device) -> list[dict]:
    """flash_decode_attention_paged (#3) at llama3-8b decode shapes: f32
    and bf16 scaled queries [8, 32, 128] against [32, 257, 64, 1024] bf16
    pools (full provisioning for 8 slots x 2048 tokens plus the trash
    page) through a [8, 32] table holding a random permutation of the
    physical pages, the #2 check's ragged lengths.  #3 is held against
    its plain version and BITWISE against flash_decode_attention (#1) on
    the gathered contiguous view, at 64- and at 16-token pages (the same
    pools seen as [32, 1028, 16, 1024]); #1 against its plain version."""
    import torch
    from aiko_services_tpu_torch.kernel_times import graph_ms
    from aiko_services_tpu_torch.ops import flash_decode as fd
    gen = torch.Generator(device=device).manual_seed(4)
    n_layers, b, t, kv, hd, h, pt = 32, 8, 2048, 8, 128, 32, 64
    pps = t // pt
    pages = b * pps + 1
    pool_k = torch.randn((n_layers, pages, pt, kv * hd), generator=gen,
                         device=device, dtype=torch.float32).to(torch.bfloat16)
    pool_v = torch.randn_like(pool_k, dtype=torch.float32).to(torch.bfloat16)
    table = (torch.randperm(pages - 1, generator=gen, device=device) + 1) \
        .reshape(b, pps).to(torch.int32)
    q = torch.randn((b, h, hd), generator=gen, device=device).to(
        torch.bfloat16)
    q_scaled, _ = fd._prep_query(q, hd)
    lengths = torch.tensor([0, 2047, 1, 1500, 513, 64, 2046, 1024],
                           device=device, dtype=torch.int32)
    layer = 17
    fd.flash_decode_attention.launches = 0

    def gathered(pool, tbl):
        return pool[layer][tbl.long()].reshape(b, t, kv * hd)
    errors = {"paged": {}, "flat": {}}
    for q_in, tol in ((q_scaled, DECODE_TOL),
                      (q_scaled.to(torch.bfloat16), BF16_TOL)):
        got = fd.flash_decode_attention_paged(q_in, pool_k, pool_v, layer,
                                              table, lengths)
        want = fd.flash_decode_attention_paged_reference(
            q_in, pool_k, pool_v, layer, table, lengths)
        kg, vg = gathered(pool_k, table), gathered(pool_v, table)
        flat = fd.flash_decode_attention(q_in, kg, vg, lengths)
        flat_want = fd.flash_decode_attention_reference(q_in, kg, vg,
                                                        lengths)
        torch.cuda.synchronize()
        err = _decode_error(got, want)
        err_flat = _decode_error(flat, flat_want)
        same = _bitwise(got, flat)
        print(f"paged decode q={q_in.dtype} pt={pt}: max_abs_err {err:.3e}"
              f" (tol {tol}); flat {err_flat:.3e}; bitwise equal to the "
              f"flat kernel on the gathered view: {same}")
        if got[0][0].abs().max() != 0 or got[2][0].abs().max() != 0 \
                or (got[1][0] != -1e30).any():
            raise AssertionError("paged decode: a length-0 row must give "
                                 "acc=0, l=0, m=-1e30")
        if not (err <= tol and err_flat <= tol):
            raise AssertionError(f"paged/flat decode kernel disagrees: "
                                 f"{err} / {err_flat} > {tol}")
        if not same:
            raise AssertionError("the paged kernel is not bitwise equal to "
                                 "the flat kernel on the gathered view")
        errors["paged"][q_in.dtype] = err
        errors["flat"][q_in.dtype] = err_flat
    # 16-token pages: the same pools seen as [L, 1028, 16, C], a table of
    # 1024 of their pages in random order; each 64-row tile spans 4 pages.
    small_k = pool_k.view(n_layers, pages * 4, 16, kv * hd)
    small_v = pool_v.view(n_layers, pages * 4, 16, kv * hd)
    small_table = (torch.randperm(pages * 4 - 1, generator=gen,
                                  device=device)[:b * t // 16] + 1) \
        .reshape(b, t // 16).to(torch.int32)
    for q_in in (q_scaled, q_scaled.to(torch.bfloat16)):
        got = fd.flash_decode_attention_paged(q_in, small_k, small_v, layer,
                                              small_table, lengths)
        flat = fd.flash_decode_attention(
            q_in, gathered(small_k, small_table),
            gathered(small_v, small_table), lengths)
        torch.cuda.synchronize()
        same = _bitwise(got, flat)
        print(f"paged decode q={q_in.dtype} pt=16: bitwise equal to the "
              f"flat kernel on the gathered view: {same}")
        if not same:
            raise AssertionError("the paged kernel at 16-token pages is not "
                                 "bitwise equal to the flat kernel")
    kg, vg = gathered(pool_k, table), gathered(pool_v, table)
    ms = graph_ms(lambda: fd.flash_decode_attention_paged(
        q_scaled, pool_k, pool_v, layer, table, lengths))
    plain = graph_ms(lambda: fd.flash_decode_attention_paged_reference(
        q_scaled, pool_k, pool_v, layer, table, lengths), iters=5)
    flat_ms = graph_ms(lambda: fd.flash_decode_attention(q_scaled, kg, vg,
                                                        lengths))
    flat_plain = graph_ms(lambda: fd.flash_decode_attention_reference(
        q_scaled, kg, vg, lengths), iters=5)
    # Yardstick for both: SDPA over the PRE-GATHERED contiguous view
    # (normalised output, no m/l; no single PyTorch call walks a page
    # table), lengths as a boolean mask.
    kt = kg.reshape(b, t, kv, hd).transpose(1, 2) \
        .repeat_interleave(h // kv, dim=1)
    vt = vg.reshape(b, t, kv, hd).transpose(1, 2) \
        .repeat_interleave(h // kv, dim=1)
    mask = (torch.arange(t, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    library = graph_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask))
    flat_launches = fd.flash_decode_attention.launches
    live_tokens = int(lengths.sum().item())
    live_pages = int(((lengths + pt - 1) // pt).sum().item())
    io_bytes = q_scaled.numel() * q_scaled.element_size() \
        + lengths.numel() * 4 + b * h * (hd + 2) * 4
    paged_bound, paged_by = attention_bound_ms(
        2 * live_tokens * kv * hd * 2 + live_pages * 4 + io_bytes,
        live_tokens, h, hd, True)
    flat_bound, flat_by = attention_bound_ms(
        2 * live_tokens * kv * hd * 2 + io_bytes, live_tokens, h, hd, True)
    source = "aiko_services_tpu_torch/csrc/flash_verify.cu"
    library_note = "SDPA on the pre-gathered view"
    return [{"name": "flash_decode_attention_paged", "route": "cuda",
             "source": source,
             "replaces": "aiko_services_tpu/ops/pallas_decode.py:487",
             "max_abs_err": errors["paged"][torch.float32], "ms": ms,
             "plain_ms": plain, "bound_ms": paged_bound,
             "bound_by": paged_by, "library_ms": library,
             "library": library_note},
            {"name": "flash_decode_attention", "route": "cuda",
             "source": source,
             "replaces": "aiko_services_tpu/ops/pallas_decode.py:285",
             "max_abs_err": errors["flat"][torch.float32], "ms": flat_ms,
             "plain_ms": flat_plain, "bound_ms": flat_bound,
             "bound_by": flat_by, "library_ms": library,
             "library": library_note, "path": "kernel phase",
             "launches": flat_launches}]


def _int8_side(shape, gen, device):
    """A random int8 cache side [.., K*hd] with its [.., K] f32 scales,
    quantized as ``kv_dtype="int8"`` stores it (one layer at a time, so
    the float32 draw stays small)."""
    import torch
    from aiko_services_tpu_torch.models.quant import quantize_kv
    kv, hd = 8, shape[-1] // 8
    codes = torch.empty(shape, dtype=torch.int8, device=device)
    scales = torch.empty((*shape[:-1], kv), dtype=torch.float32,
                         device=device)
    for layer in range(shape[0]):
        leaf = quantize_kv(torch.randn((*shape[1:-1], kv, hd), generator=gen,
                                       device=device))
        codes[layer] = leaf["int8"].reshape(shape[1:])
        scales[layer] = leaf["scale"][..., 0]
    return codes, scales


def _dequantized(codes, scales):
    """[.., K*hd] codes and [.., K] scales -> the bf16 values."""
    import torch
    kv = scales.shape[-1]
    grouped = codes.reshape(*codes.shape[:-1], kv, -1).float() \
        * scales[..., None]
    return grouped.reshape(codes.shape).to(torch.bfloat16)


def check_int8_decode(device) -> list[dict]:
    """The int8 payload of the decode body at PR 2's shapes: f32 and bf16
    scaled queries [8, 32, 128] against int8 caches with per-(position,
    kv head) f32 scales -- #2 on a [32, 8, 2048, 1024] stacked cache, #3
    on [32, 257, 64, 1024] pools through a random permutation table, #1
    on the gathered view -- each against its plain version; #3 BITWISE
    against #1 at 64- and 16-token pages."""
    import torch
    from aiko_services_tpu_torch.kernel_times import graph_ms
    from aiko_services_tpu_torch.ops import flash_decode as fd
    gen = torch.Generator(device=device).manual_seed(6)
    n_layers, b, t, kv, hd, h, pt = 32, 8, 2048, 8, 128, 32, 64
    pps, layer = t // pt, 17
    pages = b * pps + 1
    k, ks = _int8_side((n_layers, b, t, kv * hd), gen, device)
    v, vs = _int8_side((n_layers, b, t, kv * hd), gen, device)
    pool_k, pool_ks = _int8_side((n_layers, pages, pt, kv * hd), gen, device)
    pool_v, pool_vs = _int8_side((n_layers, pages, pt, kv * hd), gen, device)
    table = (torch.randperm(pages - 1, generator=gen, device=device) + 1) \
        .reshape(b, pps).to(torch.int32)
    q = torch.randn((b, h, hd), generator=gen, device=device).to(
        torch.bfloat16)
    q_scaled, _ = fd._prep_query(q, hd)
    lengths = torch.tensor([0, 2047, 1, 1500, 513, 64, 2046, 1024],
                           device=device, dtype=torch.int32)

    def gathered(pool, tbl):
        return pool[layer][tbl.long()].reshape(b, t, pool.shape[-1])
    errors = {"stacked": {}, "paged": {}, "flat": {}}
    for q_in, tol in ((q_scaled, DECODE_TOL),
                      (q_scaled.to(torch.bfloat16), BF16_TOL)):
        stacked = (fd.flash_decode_attention_stacked(
            q_in, k, v, layer, lengths, ks, vs),
            fd.flash_decode_attention_stacked_reference(
                q_in, k, v, layer, lengths, ks, vs))
        paged = (fd.flash_decode_attention_paged(
            q_in, pool_k, pool_v, layer, table, lengths, pool_ks, pool_vs),
            fd.flash_decode_attention_paged_reference(
                q_in, pool_k, pool_v, layer, table, lengths, pool_ks,
                pool_vs))
        views = [gathered(pool, table)
                 for pool in (pool_k, pool_v, pool_ks, pool_vs)]
        flat = (fd.flash_decode_attention(q_in, *views[:2], lengths,
                                          *views[2:]),
                fd.flash_decode_attention_reference(q_in, *views[:2],
                                                    lengths, *views[2:]))
        torch.cuda.synchronize()
        for name, (got, want) in (("stacked", stacked), ("paged", paged),
                                  ("flat", flat)):
            errors[name][q_in.dtype] = err = _decode_error(got, want)
            if got[0][0].abs().max() != 0 or got[2][0].abs().max() != 0 \
                    or (got[1][0] != -1e30).any():
                raise AssertionError(f"int8 {name} decode: a length-0 row "
                                     f"must give acc=0, l=0, m=-1e30")
            if not err <= tol:
                raise AssertionError(f"int8 {name} decode kernel disagrees: "
                                     f"{err} > {tol}")
        same = _bitwise(paged[0], flat[0])
        print(f"int8 decode q={q_in.dtype}: max_abs_err stacked "
              f"{errors['stacked'][q_in.dtype]:.3e}, paged "
              f"{errors['paged'][q_in.dtype]:.3e}, flat "
              f"{errors['flat'][q_in.dtype]:.3e} (tol {tol}); paged bitwise "
              f"equal to flat at pt={pt}: {same}")
        if not same:
            raise AssertionError("int8: the paged kernel is not bitwise "
                                 "equal to the flat kernel")
    # 16-token pages: the same pools seen as [L, 1028, 16, C].
    small = [pool.view(n_layers, pages * 4, 16, pool.shape[-1])
             for pool in (pool_k, pool_v, pool_ks, pool_vs)]
    small_table = (torch.randperm(pages * 4 - 1, generator=gen,
                                  device=device)[:b * t // 16] + 1) \
        .reshape(b, t // 16).to(torch.int32)
    for q_in in (q_scaled, q_scaled.to(torch.bfloat16)):
        got = fd.flash_decode_attention_paged(
            q_in, small[0], small[1], layer, small_table, lengths,
            small[2], small[3])
        flat = fd.flash_decode_attention(
            q_in, *(gathered(pool, small_table) for pool in small[:2]),
            lengths, *(gathered(pool, small_table) for pool in small[2:]))
        torch.cuda.synchronize()
        same = _bitwise(got, flat)
        print(f"int8 paged decode q={q_in.dtype} pt=16: bitwise equal to "
              f"the flat kernel: {same}")
        if not same:
            raise AssertionError("int8: the paged kernel at 16-token pages "
                                 "is not bitwise equal to the flat kernel")
    views = [gathered(pool, table) for pool in (pool_k, pool_v, pool_ks,
                                                pool_vs)]
    timed = {
        "stacked": (lambda: fd.flash_decode_attention_stacked(
            q_scaled, k, v, layer, lengths, ks, vs),
            lambda: fd.flash_decode_attention_stacked_reference(
                q_scaled, k, v, layer, lengths, ks, vs)),
        "paged": (lambda: fd.flash_decode_attention_paged(
            q_scaled, pool_k, pool_v, layer, table, lengths, pool_ks,
            pool_vs),
            lambda: fd.flash_decode_attention_paged_reference(
                q_scaled, pool_k, pool_v, layer, table, lengths, pool_ks,
                pool_vs)),
        "flat": (lambda: fd.flash_decode_attention(
            q_scaled, *views[:2], lengths, *views[2:]),
            lambda: fd.flash_decode_attention_reference(
                q_scaled, *views[:2], lengths, *views[2:]))}
    fd.flash_decode_attention.int8_launches = 0
    times = {name: (graph_ms(kernel), graph_ms(plain, iters=5))
             for name, (kernel, plain) in timed.items()}
    flat_launches = fd.flash_decode_attention.int8_launches

    # Yardstick: SDPA over the dequantized bf16 view (normalised output,
    # no m/l), lengths as a boolean mask.
    def sdpa_inputs(codes, scales):
        return _dequantized(codes, scales).reshape(b, t, kv, hd) \
            .transpose(1, 2).repeat_interleave(h // kv, dim=1)
    kt, vt = sdpa_inputs(views[0], views[2]), sdpa_inputs(views[1], views[3])
    mask = (torch.arange(t, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    library = graph_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kt, vt, attn_mask=mask))
    live_tokens = int(lengths.sum().item())
    live_pages = int(((lengths + pt - 1) // pt).sum().item())
    io_bytes = q_scaled.numel() * q_scaled.element_size() \
        + lengths.numel() * 4 + b * h * (hd + 2) * 4
    cache_bytes = 2 * live_tokens * (kv * hd + kv * 4)
    source = "aiko_services_tpu_torch/csrc/flash_verify.cu"
    rows = []
    for name, wrapper, replaces, extra in (
            ("stacked", "flash_decode_attention_stacked", 387, 0),
            ("paged", "flash_decode_attention_paged", 487, live_pages * 4),
            ("flat", "flash_decode_attention", 285, 0)):
        bound, by = attention_bound_ms(cache_bytes + io_bytes + extra,
                                       live_tokens, h, hd, True)
        rows.append({"name": f"{wrapper}[int8]", "route": "cuda",
                     "source": source,
                     "replaces": f"aiko_services_tpu/ops/pallas_decode.py:"
                                 f"{replaces}",
                     "max_abs_err": errors[name][torch.float32],
                     "ms": times[name][0], "plain_ms": times[name][1],
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": library,
                     "library": "SDPA on the dequantized bf16 view"})
    rows[2].update({"path": "kernel phase", "launches": flat_launches})
    return rows


def check_verify(device) -> list[dict]:
    """The chunk-verify kernel at llama3-8b verify shapes: S 5 (4 draft
    tokens), f32 and bf16 scaled queries [8, 5, 32, 128], starts = the
    decode check's lengths, against a [32, 8, 2048, 1024] stacked cache
    and [32, 257, 64, 1024] pools through a random permutation table,
    bf16 and int8.  The stacked and paged forms against their plain
    versions, the paged form BITWISE against the stacked form on the
    gathered view at 64- and 16-token pages.  Timed: the stacked and
    paged forms, bf16 and int8, with their plain versions; the yardstick
    is SDPA over the pre-gathered (dequantized) view, the cache part
    only."""
    import torch
    from aiko_services_tpu_torch.kernel_times import graph_ms
    from aiko_services_tpu_torch.ops import flash_decode as fd
    gen = torch.Generator(device=device).manual_seed(12)
    n_layers, b, t, kv, hd, h, s, pt = 32, 8, 2048, 8, 128, 32, 5, 64
    pps, layer = t // pt, 17
    pages = b * pps + 1
    starts = torch.tensor([0, 2047, 1, 1500, 513, 64, 2046, 1024],
                          device=device, dtype=torch.int32)
    table = (torch.randperm(pages - 1, generator=gen, device=device) + 1) \
        .reshape(b, pps).to(torch.int32)
    small_table = (torch.randperm(pages * 4 - 1, generator=gen,
                                  device=device)[:b * t // 16] + 1) \
        .reshape(b, t // 16).to(torch.int32)
    q = torch.randn((b, s, h, hd), generator=gen, device=device).to(
        torch.bfloat16)
    q_scaled, _ = fd._prep_query(q, hd)
    shape = (n_layers, pages, pt, kv * hd)
    caches = {}
    for payload in ("bf16", "int8"):
        if payload == "int8":
            (k_pool, ks), (v_pool, vs) = (_int8_side(shape, gen, device)
                                          for _ in range(2))
        else:
            k_pool, v_pool = (torch.randn(shape, generator=gen, device=device,
                                          dtype=torch.float32)
                              .to(torch.bfloat16) for _ in range(2))
            ks = vs = None
        caches[payload] = (k_pool, v_pool, ks, vs)

    def stacked_view(pool, tbl):
        """The table's pages as a [1, B, T, ...] stacked cache (layer 0)."""
        if pool is None:
            return None
        return pool[layer][tbl.long()].reshape(1, b, t, pool.shape[-1]) \
            .contiguous()
    errors, timed = {}, {}
    for payload, (k_pool, v_pool, ks, vs) in caches.items():
        scales = (ks, vs)
        for q_in, tol in ((q_scaled, DECODE_TOL),
                          (q_scaled.to(torch.bfloat16), BF16_TOL)):
            for page_tokens, tbl in ((pt, table), (16, small_table)):
                pools = [None if pool is None else pool.view(
                    n_layers, pages * pt // page_tokens, page_tokens,
                    pool.shape[-1]) for pool in (k_pool, v_pool, *scales)]
                paged = fd.flash_verify_attention_paged(
                    q_in, pools[0], pools[1], layer, tbl, starts, *pools[2:])
                views = [stacked_view(pool, tbl) for pool in pools]
                flat = fd.flash_verify_attention_stacked(
                    q_in, views[0], views[1], 0, starts, *views[2:])
                want = fd.flash_verify_attention_stacked_reference(
                    q_in, views[0], views[1], 0, starts, *views[2:])
                torch.cuda.synchronize()
                err = _decode_error(flat, want)
                same = _bitwise(paged, flat)
                print(f"verify {payload} q={q_in.dtype} pt={page_tokens}: "
                      f"max_abs_err {err:.3e} (tol {tol}); paged bitwise "
                      f"equal to stacked on the gathered view: {same}")
                if flat[0][0].abs().max() != 0 or (flat[1][0] != -1e30).any():
                    raise AssertionError("verify: a start-0 row must give "
                                         "acc=0, m=-1e30")
                if not err <= tol or not same:
                    raise AssertionError(f"verify kernel disagrees "
                                         f"({payload}, pt={page_tokens}): "
                                         f"{err} > {tol} or not bitwise")
                errors.setdefault(payload, {})[q_in.dtype] = max(
                    err, errors.get(payload, {}).get(q_in.dtype, 0.0))
        views = [stacked_view(pool, table) for pool in (k_pool, v_pool, *scales)]
        suffix = "[int8]" if payload == "int8" else ""
        fd.flash_verify_attention_stacked.int8_launches = 0
        timed[f"flash_verify_attention_stacked{suffix}"] = (
            graph_ms(lambda: fd.flash_verify_attention_stacked(
                q_scaled, views[0], views[1], 0, starts, *views[2:])),
            graph_ms(lambda: fd.flash_verify_attention_stacked_reference(
                q_scaled, views[0], views[1], 0, starts, *views[2:]),
                iters=5))
        if payload == "int8":
            stacked_int8_launches = fd.flash_verify_attention_stacked \
                .int8_launches
        timed[f"flash_verify_attention_paged{suffix}"] = (
            graph_ms(lambda: fd.flash_verify_attention_paged(
                q_scaled, k_pool, v_pool, layer, table, starts, ks, vs)),
            graph_ms(lambda: fd.flash_verify_attention_paged_reference(
                q_scaled, k_pool, v_pool, layer, table, starts, ks, vs),
                iters=5))
        # Yardstick: SDPA of the S queries over the pre-gathered view (the
        # dequantized bf16 view for int8), the cache part only.
        if payload == "int8":
            kg = _dequantized(views[0][0], views[2][0])
            vg = _dequantized(views[1][0], views[3][0])
        else:
            kg, vg = views[0][0], views[1][0]
        kt = kg.reshape(b, t, kv, hd).transpose(1, 2) \
            .repeat_interleave(h // kv, dim=1)
        vt = vg.reshape(b, t, kv, hd).transpose(1, 2) \
            .repeat_interleave(h // kv, dim=1)
        mask = (torch.arange(t, device=device)[None, :]
                < starts[:, None])[:, None, None, :]
        library = graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), kt, vt, attn_mask=mask))
        timed[f"library{suffix}"] = library
        del kt, vt, kg, vg
        if payload == "bf16":
            combine = _check_combine(
                "verify_combine", 830, fd.flash_verify_partials_stacked(
                    q_scaled, views[0], views[1], 0, starts),
                lambda *parts: fd.verify_combine(*parts, s),
                lambda *parts: fd.verify_combine_reference(*parts, s))
    live_tokens = int(starts.sum().item())
    live_pages = int(((starts + pt - 1) // pt).sum().item())
    io_bytes = q_scaled.numel() * 4 + starts.numel() * 4 \
        + b * s * h * (hd + 2) * 4
    source = "aiko_services_tpu_torch/csrc/flash_verify.cu"
    rows = []
    for payload in ("bf16", "int8"):
        suffix = "[int8]" if payload == "int8" else ""
        per_token = kv * hd * 2 if payload == "bf16" else kv * hd + kv * 4
        for form, extra in (("stacked", 0), ("paged", live_pages * 4)):
            name = f"flash_verify_attention_{form}{suffix}"
            ms, plain = timed[name]
            bound, by = attention_bound_ms(
                2 * live_tokens * per_token + io_bytes + extra, live_tokens,
                s * h, hd, True)
            row = {"name": name, "route": "cuda", "source": source,
                   "replaces": "aiko_services_tpu/ops/pallas_decode.py:830",
                   "max_abs_err": errors[payload][torch.float32], "ms": ms,
                   "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                   "library_ms": timed[f"library{suffix}"],
                   "library": "SDPA on the pre-gathered view, cache part"}
            if name == "flash_verify_attention_stacked[int8]":
                # No serving run of this script verifies over a dense int8
                # cache: its launches are the kernel phase's.
                row.update({"path": "kernel phase",
                            "launches": stacked_int8_launches})
            rows.append(row)
    del caches
    torch.cuda.empty_cache()
    return rows + [combine]


def _check_combine(name: str, replaces: int, parts, combine,
                   plain_combine) -> dict:
    """A split body's combine kernel (``combine``: decode_combine or
    verify_combine) on the body's own partials at the serving shapes (8
    splits of 4 tiles a row) against its plain version on the same
    partials, timed beside it."""
    import torch
    from aiko_services_tpu_torch.kernel_times import graph_ms
    got = combine(*parts)
    want = plain_combine(*parts)
    torch.cuda.synchronize()
    err = _decode_error(got, want)
    print(f"{name}, partials {tuple(parts[0].shape)}: max_abs_err "
          f"{err:.3e} (tol {DECODE_TOL})")
    if not err <= DECODE_TOL:
        raise AssertionError(f"{name} disagrees: {err}")
    ms = graph_ms(lambda: combine(*parts))
    plain = graph_ms(lambda: plain_combine(*parts), iters=5)
    # Bytes: every m/l partial, the acc partials of live splits, the
    # outputs; two operations an accumulated element.
    live = int((parts[1] > -1e29).sum().item())
    head_dim = parts[0].shape[-1]
    n_bytes = 2 * parts[1].numel() * 4 + live * head_dim * 4 \
        + got[0].numel() * 4 + 2 * got[1].numel() * 4
    bound, by = bound_ms(n_bytes, 2 * live * head_dim, "f32")
    return {"name": name, "route": "cuda",
            "source": "aiko_services_tpu_torch/csrc/flash_verify.cu",
            "replaces": f"aiko_services_tpu/ops/pallas_decode.py:{replaces}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "splits": parts[0].shape[2]}


def check_int8_matmul(device) -> dict:
    """int8_matmul (#5) at the serving path's shapes.  Decode route (M 8,
    split over D; its combine checked and timed in check_int8_combine):
    the decode unembed (D 4,096, F 128,256), w_down (D 14,336, F 4,096),
    wq/wo (4,096 x 4,096), wk/wv (4,096 x 1,024) and w_gate/w_up (4,096 x
    14,336).  Admission route (M > 16): the prefill unembed (M 512), the
    layer leaves that dominate an int8 admission chunk at M 512 (w_up
    4,096 x 14,336, w_down 14,336 x 4,096, wk 4,096 x 1,024) and w_up at
    the verify forward's M 40.  Config 5's Llama-3.2-1B widths: the
    decode unembed (2,048 x 128,256), w_down (8,192 x 2,048) and wk
    (2,048 x 512) at M 8, w_up and w_down at the admission chunk's M
    512.  Exact against the plain version on grid
    inputs (integer x, power-of-two scales: every product and sum is an
    exact float) at every shape; within INT8_MATMUL_TOL of max |out| on
    random bf16 inputs with quantizer-made weights.  Each shape is timed
    beside cuBLAS bf16 on the dequantized weight, with its tile and
    grid."""
    import torch
    from aiko_services_tpu_torch.kernel_times import graph_ms
    from aiko_services_tpu_torch.models.quant import quantize_weight
    from aiko_services_tpu_torch.ops.int8_matmul import (
        int8_matmul, int8_matmul_reference, kernel_tiles)
    gen = torch.Generator(device=device).manual_seed(8)
    shapes = {"decode_unembed": (8, 4096, 128_256),
              "prefill_unembed": (512, 4096, 128_256),
              "decode_w_down": (8, 14_336, 4096),
              "decode_wq": (8, 4096, 4096),
              "decode_wk": (8, 4096, 1024),
              "decode_w_up": (8, 4096, 14_336),
              "prefill_w_up": (512, 4096, 14_336),
              "prefill_w_down": (512, 14_336, 4096),
              "prefill_wk": (512, 4096, 1024),
              "verify_w_up": (40, 4096, 14_336),
              # config 5's LLM, Llama-3.2-1B widths
              "1b_decode_unembed": (8, 2048, 128_256),
              "1b_decode_w_down": (8, 8192, 2048),
              "1b_decode_wk": (8, 2048, 512),
              "1b_prefill_w_up": (512, 2048, 8192),
              "1b_prefill_w_down": (512, 8192, 2048)}
    weights = {}
    for d, f in sorted({(d, f) for _, d, f in shapes.values()}):
        w = torch.randint(-127, 128, (d, f), generator=gen, device=device,
                          dtype=torch.int8)
        scale = 2.0 ** torch.randint(-10, -4, (1, f), generator=gen,
                                     device=device).float()
        leaf = quantize_weight(torch.randn((d, f), generator=gen,
                                           device=device))
        weights[d, f] = (w, scale, leaf)
    out = {}
    for label, (m, d, f) in shapes.items():
        w, scale, leaf = weights[d, f]
        x = torch.randint(-3, 4, (m, d), generator=gen,
                          device=device).to(torch.bfloat16)
        exact = torch.equal(int8_matmul(x, w, scale),
                            int8_matmul_reference(x, w, scale))
        x = torch.randn((m, d), generator=gen, device=device).to(
            torch.bfloat16)
        got = int8_matmul(x, leaf["int8"], leaf["scale"]).float()
        want = int8_matmul_reference(x, leaf["int8"], leaf["scale"]).float()
        torch.cuda.synchronize()
        err = ((got - want).abs().max() / want.abs().max()).item()
        tile_m, tile_n, blocks = kernel_tiles(m, d, f)
        print(f"int8_matmul {label} [{m}x{d}]@[{d}x{f}]: grid inputs exact "
              f"{exact}; random rel err {err:.3e} (tol {INT8_MATMUL_TOL}); "
              f"tile {tile_m}x{tile_n}, {blocks} blocks")
        if not exact or not err <= INT8_MATMUL_TOL:
            raise AssertionError(f"int8_matmul disagrees at {label}")
        dense = (leaf["int8"].float() * leaf["scale"]).to(torch.bfloat16)
        ms = graph_ms(lambda: int8_matmul(x, leaf["int8"], leaf["scale"]))
        plain = graph_ms(lambda: int8_matmul_reference(
            x, leaf["int8"], leaf["scale"]), iters=5)
        library = graph_ms(lambda: torch.matmul(x, dense))
        del dense
        n_bytes = m * d * 2 + d * f + f * 4 + m * f * 2
        flops = 2.0 * m * d * f
        bound, by = bound_ms(n_bytes, flops, "bf16")
        out[label] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                      "bound_by": by, "library_ms": library,
                      "max_abs_err": err, "matmul_route": "m<=16" if m <= 16
                      else "m>16", "tile": f"{tile_m}x{tile_n}",
                      "blocks": blocks}
        print(f"int8_matmul {label}: {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s; plain {plain:.4f}, cuBLAS bf16 on the dequantized "
              f"weight {library:.4f}, bound {bound:.4f} by {by})",
              flush=True)
    del weights
    torch.cuda.empty_cache()
    main = out["decode_unembed"]
    return {"name": "int8_matmul", "route": "cuda",
            "source": "aiko_services_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "aiko_services_tpu/ops/pallas_matmul.py:73",
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "max_abs_err": max(entry["max_abs_err"]
                               for entry in out.values()),
            "library": "torch.matmul (cuBLAS bf16) on the dequantized "
            "weight", "max_abs_err_is": "relative to max |out|",
            "shapes": out}


def check_int8_combine(device) -> dict:
    """int8_combine, the decode route's combine, at decode w_down's split
    (D 14,336 in decode_splits' splits, M 8, F 4,096; and config 5's D
    8,192, F 2,048): exactly its plain version (both add the splits in
    split order), timed beside it at Llama-3-8B's."""
    import torch
    from aiko_services_tpu_torch.kernel_times import graph_ms
    from aiko_services_tpu_torch.ops.int8_matmul import (
        decode_splits, int8_combine, int8_combine_reference)
    gen = torch.Generator(device=device).manual_seed(14)
    m = 8
    for d, f in ((8192, 2048), (14_336, 4096)):
        splits = decode_splits(d, f)[0]
        partial = torch.randn((splits, m, f), generator=gen,
                              device=device) * 50
        scale = torch.rand((1, f), generator=gen, device=device) / 64
        exact = torch.equal(int8_combine(partial, scale),
                            int8_combine_reference(partial, scale))
        print(f"int8 combine [{splits}x{m}x{f}]: equal to the plain combine "
              f"{exact}")
        if not exact:
            raise AssertionError("int8 combine disagrees with its plain "
                                 "version")
    ms = graph_ms(lambda: int8_combine(partial, scale))
    plain = graph_ms(lambda: int8_combine_reference(partial, scale), iters=5)
    n_bytes = partial.numel() * 4 + f * 4 + m * f * 2
    bound, by = bound_ms(n_bytes, partial.numel() + m * f, "f32")
    return {"name": "int8_combine", "route": "cuda",
            "source": "aiko_services_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "aiko_services_tpu/ops/pallas_matmul.py:73",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "splits": splits}


# -- phase 3: serving -------------------------------------------------------

PROMPT_LENGTHS = (100, 1500, 700, 300, 1200, 900, 513, 1024)
NEW_TOKENS = 32


def serving_config():
    from aiko_services_tpu_torch.models import llama
    return dataclasses.replace(
        llama.LlamaConfig.llama3_8b(), max_seq=2048, attention="flash",
        decode_attention="auto")


def mixed_requests(config) -> list[tuple]:
    """The eight (prompt, temperature) requests of the serving runs:
    prompts of PROMPT_LENGTHS tokens, even ones greedy, odd ones at 0.8."""
    import numpy as np
    rng = np.random.default_rng(7)
    return [(rng.integers(0, config.vocab_size, length).tolist(),
             0.0 if index % 2 == 0 else 0.8)
            for index, length in enumerate(PROMPT_LENGTHS)]


def prefix_requests(config) -> list[tuple]:
    """Four greedy requests sharing a 1024-token prefix (two whole
    prefill chunks, 16 pages of 64) with distinct 256-token tails."""
    import numpy as np
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, config.vocab_size, 1024).tolist()
    return [(prefix + rng.integers(0, config.vocab_size, 256).tolist(), 0.0)
            for _ in range(4)]


def serve(params, config, requests, label: str, device, card: str, *,
          decode_block: int = 1, serial_first: bool = False,
          recover_at: int = 0, new_tokens: int = NEW_TOKENS,
          **options) -> dict:
    """One ContinuousBatcher run (8 slots, prefill chunk 512, top-k 50)
    over ``requests``; ``serial_first`` drains the first request alone
    before submitting the rest; ``recover_at`` > 0 arms a fault probe that
    raises at that device-loop dispatch, and the run calls recover() on
    the raise.  Returns the per-request token streams, the ids of
    requests preempted under pool pressure, the batcher's page and prefix
    counters and the run's metrics."""
    import torch
    from aiko_services_tpu_torch.models.batching import (ContinuousBatcher,
                                                         Request)
    dispatches = [0]

    def probe(point):
        dispatches[0] += 1
        if dispatches[0] == recover_at:
            raise RuntimeError(f"injected fault at dispatch {recover_at}")
    if recover_at:
        options["fault_probe"] = probe
    batcher = ContinuousBatcher(params, config, max_slots=8,
                                prefill_chunk=512, sample_top_k=50,
                                decode_block=decode_block, device=device,
                                **options)
    evicted = set()
    evict = batcher._evict_slot

    def record_eviction(slot):
        if batcher.slots[slot] is not None:
            evicted.add(batcher.slots[slot].request_id)
        evict(slot)
    batcher._evict_slot = record_eviction
    streams = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    begin = time.perf_counter()
    for index, (prompt, temperature) in enumerate(requests):
        rid = f"r{index}"
        streams[rid] = []
        batcher.submit(Request(
            rid, list(prompt), max_new_tokens=new_tokens,
            temperature=temperature,
            emit=lambda r, token, done: streams[r].append(token)))
        if serial_first and index == 0:
            batcher.run_until_drained(max_steps=10_000)
    for _ in range(10_000):
        if not (batcher.pending or batcher.active_count
                or batcher.blocks_in_flight):
            break
        try:
            batcher.step()
        except RuntimeError:
            if not recover_at or batcher.recoveries:
                raise
            batcher.recover()
    torch.cuda.synchronize()
    wall = time.perf_counter() - begin
    stats = batcher.take_request_stats()
    for rid, tokens in streams.items():
        if len(tokens) != new_tokens:
            raise AssertionError(f"{label}: {rid} got {len(tokens)} of "
                                 f"{new_tokens} tokens")
    ttft = sorted(s["ttft_ms"] for s in stats)
    metrics = {
        "run": label, "decode_block": decode_block,
        "requests": len(streams), "tokens": batcher.tokens_emitted,
        "prefill_tokens": batcher.prefill_tokens,
        "wall_s": wall, "tokens_per_s": batcher.tokens_emitted / wall,
        "ttft_ms_median": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "evictions": batcher.evictions,
        "prefix_hits": batcher.prefix_hits,
        "prefix_shared_tokens": batcher.prefix_shared_tokens,
        "card": card}
    if batcher.device_loop:
        loop = batcher._loop
        metrics.update({
            "decode_block_tokens": batcher.decode_block_tokens,
            "speculative": batcher.speculative,
            "blocks_dispatched": batcher.blocks_dispatched,
            "blocks_retired": batcher.blocks_retired,
            "loop_steps": batcher.steps,
            "draft_tokens": batcher.draft_tokens,
            "accepted_tokens": batcher.accepted_tokens,
            "recoveries": batcher.recoveries,
            "captures": loop.captures,
            "replays": loop.replays, "capture_s": loop.capture_s})
    leaked = batcher._pages.leaked_pages() if batcher._pages else 0
    del batcher._evict_slot         # the hook's cycle would keep the cache
    del batcher
    torch.cuda.empty_cache()
    return {"streams": streams, "evicted": evicted, "leaked": leaked,
            "metrics": metrics}


def check_dense_agreement(params, config, device) -> dict:
    """The same chunked prefill (a 1500-token prompt, 3 chunks into slot
    3) and one decode step through three settings: the kernel path, the
    dense reference path in bf16, and the dense path in float32 on the
    same weights (the precision yardstick).  The kernel path's logits
    must agree with the bf16 dense path to LOGITS_TOL of max |logit|,
    and may lose at most twice the dense bf16 path's error against f32
    (plus 1e-3), so a kernel computing in lower precision than the
    dense path fails."""
    import torch
    from aiko_services_tpu_torch.models import llama
    gen = torch.Generator(device=device).manual_seed(11)
    prompt = torch.randint(0, config.vocab_size, (1, 1500), generator=gen,
                           device=device)
    dense = dataclasses.replace(config, attention="dense",
                                decode_attention="dense")
    exact = dataclasses.replace(dense, dtype="float32")
    params32 = _map(params, lambda leaf: leaf.float())
    results = {}
    for label, cfg, weights in (("kernel", config, params),
                                ("dense", dense, params),
                                ("f32", exact, params32)):
        cache = llama.init_cache(cfg, 8, device=device)
        for start in (0, 512, 1024):
            chunk = torch.zeros((1, 512), dtype=torch.long, device=device)
            part = prompt[:, start:start + 512]
            chunk[:, :part.shape[1]] = part
            logits, cache = llama.prefill_into_slot(weights, cfg, chunk,
                                                    cache, 3, start)
        prefill_logits = logits[0, 1500 - 1024 - 1].float()
        tokens = torch.full((8,), 17, dtype=torch.long, device=device)
        tokens[3] = prompt[0, 0]
        lengths = torch.full((8,), 2047, dtype=torch.int32, device=device)
        lengths[3] = 1500
        step_logits, cache = llama.decode_step(weights, cfg, tokens, cache,
                                               lengths)
        results[label] = (prefill_logits, step_logits[3].float())
        del cache
    del params32
    out = {}
    for index, name in enumerate(("prefill", "decode")):
        kernel, ref, exact_ref = (results[label][index]
                                  for label in ("kernel", "dense", "f32"))

        def rel(a, b):
            return ((a - b).abs().max() / b.abs().max()).item()
        err, err_kernel, err_dense = (rel(kernel, ref), rel(kernel, exact_ref),
                                      rel(ref, exact_ref))
        same = int(kernel.argmax()) == int(ref.argmax())
        print(f"{name} logits: kernel vs dense bf16 max rel err {err:.3e} "
              f"(tol {LOGITS_TOL}), argmax agree {same}; against f32: "
              f"kernel {err_kernel:.3e}, dense bf16 {err_dense:.3e}")
        if not err <= LOGITS_TOL:
            raise AssertionError(f"{name} logits disagree: {err}")
        if not err_kernel <= 2 * err_dense + 1e-3:
            raise AssertionError(f"{name}: the kernel path loses more "
                                 f"precision than the dense bf16 path")
        out[name] = err
    return out


def check_int8_agreement(qparams, config, device) -> dict:
    """The same chunked prefill and decode step as check_dense_agreement,
    on the quantized tree, through the int8 kernel path (#5 on every int8
    leaf, the int8 KV cache, flash prefill and decode) and through the
    plain path (``matmul_kernel="off"``, bf16 KV, dense attention): the
    logits must agree to LOGITS_TOL of max |logit|."""
    import torch
    from aiko_services_tpu_torch.models import llama
    gen = torch.Generator(device=device).manual_seed(11)
    prompt = torch.randint(0, config.vocab_size, (1, 1500), generator=gen,
                           device=device)
    plain = dataclasses.replace(config, attention="dense",
                                decode_attention="dense",
                                matmul_kernel="off", kv_dtype="bfloat16")
    results = {}
    for label, cfg in (("kernel", config), ("plain", plain)):
        cache = llama.init_cache(cfg, 8, device=device)
        for start in (0, 512, 1024):
            chunk = torch.zeros((1, 512), dtype=torch.long, device=device)
            part = prompt[:, start:start + 512]
            chunk[:, :part.shape[1]] = part
            logits, cache = llama.prefill_into_slot(qparams, cfg, chunk,
                                                    cache, 3, start)
        prefill_logits = logits[0, 1500 - 1024 - 1].float()
        tokens = torch.full((8,), 17, dtype=torch.long, device=device)
        tokens[3] = prompt[0, 0]
        lengths = torch.full((8,), 2047, dtype=torch.int32, device=device)
        lengths[3] = 1500
        step_logits, cache = llama.decode_step(qparams, cfg, tokens, cache,
                                               lengths)
        results[label] = (prefill_logits, step_logits[3].float())
        del cache
    out = {}
    for index, name in enumerate(("prefill", "decode")):
        kernel, ref = results["kernel"][index], results["plain"][index]
        err = ((kernel - ref).abs().max() / ref.abs().max()).item()
        same = int(kernel.argmax()) == int(ref.argmax())
        print(f"int8 {name} logits: kernel path vs plain path max rel err "
              f"{err:.3e} (tol {LOGITS_TOL}), argmax agree {same}")
        if not err <= LOGITS_TOL:
            raise AssertionError(f"int8 {name} logits disagree: {err}")
        out[name] = err
    return out


def check_verify_agreement(params, config, device) -> float:
    """The speculative verify step against S sequential decode steps on
    the same cache: a 1500-token prompt prefilled into slot 3, then a
    5-token chunk per row verified at once (``_chunk_verify`` on the
    verify kernel, one copy of the cache) and decoded token by token
    (``decode_step`` on kernel #2, the other copy).  The logits must agree
    to LOGITS_TOL of max |logit|."""
    import torch
    from aiko_services_tpu_torch.models import llama
    gen = torch.Generator(device=device).manual_seed(13)
    b, s = 8, 5
    cache = llama.init_cache(config, b, device=device)
    prompt = torch.randint(0, config.vocab_size, (1, 1500), generator=gen,
                           device=device)
    for start in (0, 512, 1024):
        chunk = torch.zeros((1, 512), dtype=torch.long, device=device)
        part = prompt[:, start:start + 512]
        chunk[:, :part.shape[1]] = part
        _, cache = llama.prefill_into_slot(params, config, chunk, cache, 3,
                                           start)
    tokens = torch.randint(0, config.vocab_size, (b, s), generator=gen,
                           device=device)
    starts = torch.zeros((b,), dtype=torch.int32, device=device)
    starts[3] = 1500
    copy = {side: cache[side].clone() for side in ("k", "v")}
    verified, _ = llama._chunk_verify(params, config, tokens, copy, starts,
                                      config.max_seq - 1, use_flash=True)
    del copy
    stepped = []
    for i in range(s):
        logits, cache = llama.decode_step(params, config, tokens[:, i], cache,
                                          starts + i)
        stepped.append(logits.float())
    stepped = torch.stack(stepped, dim=1)
    verified = verified.float()
    err = ((verified - stepped).abs().max() / stepped.abs().max()).item()
    agree = int((verified.argmax(-1) == stepped.argmax(-1)).sum())
    print(f"verify-step logits vs {s} sequential decode steps: max rel err "
          f"{err:.3e} (tol {LOGITS_TOL}), argmax agree {agree}/{b * s}")
    if not err <= LOGITS_TOL:
        raise AssertionError(f"verify-step logits disagree: {err}")
    del cache
    torch.cuda.empty_cache()
    return err


def check_loop_graph(params, config, device, card) -> dict:
    """Captured decode_loop blocks at the serving runs' settings (8 rows at
    1,000 cached positions, ring 16, top-k 50).  A plain block over the
    dense cache replayed twice from the same inputs at temperature 0.8
    must draw different tokens (the generator is registered with the
    graph, so a replay draws anew).  Then one block's device time (CUDA
    events, the mean of 5 replays) for each mode: plain over the dense
    cache, ngram over 64-token pages, the int8 self-draft over the dense
    cache.  A block runs a fixed number of iterations, so its device time
    does not depend on how many drafts it accepts."""
    import torch
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.loop_graph import LoopRunner
    from aiko_services_tpu_torch.models.paged import init_paged_cache
    from aiko_services_tpu_torch.models.quant import draft_params
    b, ring = 8, 16
    out = {"ring": ring, "rows": b, "block_device_ms": {}, "capture_s": {}}
    for mode, page_tokens in (("off", 0), ("ngram", 64), ("draft", 0)):
        if page_tokens:
            cache = init_paged_cache(config, b, config.max_seq, page_tokens,
                                     device=device)
            cache["page_table"].copy_(torch.arange(
                1, b * config.max_seq // page_tokens + 1, dtype=torch.int32,
                device=device).reshape(b, -1))
        else:
            cache = llama.init_cache(config, b, device=device)
        runner = LoopRunner(
            params, config, batch=b, ring=ring, speculative=mode,
            spec_tokens=4, spec_window=32,
            draft=draft_params(params) if mode == "draft" else None,
            top_k=50, generator=torch.Generator(device=device).manual_seed(5),
            history_width=32 if mode == "ngram" else 1, device=device)
        inputs = runner.inputs

        def load():
            inputs["tokens"].copy_(torch.arange(b, device=device) * 7 + 3)
            inputs["lengths"].fill_(1000)
            inputs["active"].fill_(True)
            inputs["budget"].fill_(ring)
            inputs["temperatures"].fill_(0.8)
        if mode == "off":
            load()
            first = runner.run(cache)["emitted"].clone()
            load()
            second = runner.run(cache)["emitted"].clone()
            torch.cuda.synchronize()
            out["sampled_tokens_differing"] = int((first != second).sum())
        load()
        runner.run(cache)                   # the capture, off the clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            load()
            runner.run(cache)
        end.record()
        torch.cuda.synchronize()
        out["block_device_ms"][mode] = start.elapsed_time(end) / 5
        out["capture_s"][mode] = runner.capture_s
        del runner, cache, inputs
        torch.cuda.empty_cache()
    out["card"] = card
    print(f"loop graph: {json.dumps(out)}", flush=True)
    if not out["sampled_tokens_differing"]:
        raise AssertionError("two replays of one captured block from the "
                             "same inputs at temperature 0.8 drew the same "
                             "tokens: the generator is not advancing")
    return out


def run_plan(plan, params, config, device, card, runs, launches) -> None:
    """Serve each (label, requests, options[, path]) of ``plan``: every
    launch counter of the port zeroed just before the run and read just
    after; every kernel of the run's path must launch and no other may.
    The default path is the run's decode kernel (stacked on dense runs,
    paged on paged runs, the int8 payload with an int8 cache), #4, #6
    and, on a quantized tree, #5's admission route (M > 16: prompt
    chunks, verify forwards) and its decode route (M <= 16); device-loop
    runs name theirs, the decode route among them where it runs.  A split
    kernel brings its combine: ``verify_combine`` with a verify kernel,
    ``int8_combine`` with the decode route (every decode leaf but the
    unembed splits D), ``decode_combine`` with a decode kernel."""
    from aiko_services_tpu_torch.ops import launch_counters
    counters = launch_counters()
    int8 = config.kv_dtype == "int8"
    suffix = "[int8]" if int8 else ""
    quantized = isinstance(params["unembed"], dict)
    for label, requests, options, *path in plan:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        runs[label] = serve(params, config, requests, label, device, card,
                            **options)
        counts = {name: getattr(fn, attr)
                  for name, (fn, attr) in counters.items()}
        print(f"serving {json.dumps(runs[label]['metrics'])} "
              f"launches {json.dumps(counts)}", flush=True)
        decode = "flash_decode_attention_paged" if "kv_page_tokens" \
            in options else "flash_decode_attention_stacked"
        wanted = {name + suffix if name.startswith("flash_") and
                  name != "flash_attention" else name
                  for name in (path[0] if path else {decode})} \
            | {"flash_attention", "topk"} \
            | ({"int8_matmul[M>16]"} | (set() if path else {"int8_matmul"})
               if quantized else set())
        if any(name.startswith("flash_decode") for name in wanted):
            wanted.add("decode_combine")
        if any(name.startswith("flash_verify") for name in wanted):
            wanted.add("verify_combine")
        if "int8_matmul" in wanted:
            wanted.add("int8_combine")
        for name, count in counts.items():
            if (count > 0) != (name in wanted):
                raise AssertionError(
                    f"{label}: {name} launched {count} times; the run's "
                    f"path is {sorted(wanted)}")
            launches[name] = launches.get(name, 0) + count


# -- phase 6: the pipeline engine and the LLM element ----------------------

#: 1,127 bytes, one ByteTokenizer token each: admission runs the
#: chunked prefill (#4) over three 512-token chunks, and the paged run's
#: prefix cache shares its whole pages between frames.
SYSTEM_PROMPT = " ".join(
    f"Rule {index:02d}: describe what the detector saw in one short, "
    f"plain sentence." for index in range(16)) + " Scene: "
PIPELINE_DETECTIONS = [
    [{"class": "car"}] * 3 + [{"class": "person"}],
    [],
    [{"class": "dog"}],
    [{"class": "truck"}, {"class": "bicycle"}] + [{"class": "person"}] * 5,
    [{"class": "cat"}, {"class": "dog"}],
    [{"class": "bus"}] * 4 + [{"class": "car"}] * 2,
    [{"class": "traffic light"}] * 2 + [{"class": "person"}],
    [{"class": "motorcycle"}, {"class": "car"}, {"class": "stop sign"}],
]
PIPELINE_LLM = {"model": "llama3-8b", "seed": 0, "max_seq": 2048,
                "attention": "flash", "sample_top_k": 50, "temperature": 0,
                "max_new_tokens": NEW_TOKENS, "max_slots": 8,
                "system_prompt": SYSTEM_PROMPT}
#: (label, LLM parameters, pipeline parameters, the run's decode kernel)
PIPELINE_PLAN = (
    ("pipeline-loop-16", {"decode_block_tokens": 16},
     {"transfer_guard": "disallow"}, "flash_decode_attention_stacked"),
    ("pipeline-paged-4",
     {"kv_page_tokens": 64, "decode_block": 4, "prefix_cache": "on"}, {},
     "flash_decode_attention_paged"))


#: BASELINE config 4 on one card: the detector at YOLO-n scale (width
#: 32, depth 1, 80 classes) on 640x640 frames in batches of up to 8,
#: placed on the card by a placement block; the LLM as in
#: ``pipeline-loop-16`` (no placement block: one card holds no two
#: disjoint stages).
COCO_CLASSES = (
    "person bicycle car motorcycle airplane bus train truck boat "
    "traffic_light fire_hydrant stop_sign parking_meter bench bird cat dog "
    "horse sheep cow elephant bear zebra giraffe backpack umbrella handbag "
    "tie suitcase frisbee skis snowboard sports_ball kite baseball_bat "
    "baseball_glove skateboard surfboard tennis_racket bottle wine_glass "
    "cup fork knife spoon bowl banana apple sandwich orange broccoli carrot "
    "hot_dog pizza donut cake chair couch potted_plant bed dining_table "
    "toilet tv laptop mouse remote keyboard cell_phone microwave oven "
    "toaster sink refrigerator book clock vase scissors teddy_bear "
    "hair_drier toothbrush").split()
CONFIG4_DETECTOR = {"width": 32, "max_batch": 8,
                    "class_names": [name.replace("_", " ")
                                    for name in COCO_CLASSES]}
CONFIG4_FRAMES = 8
CONFIG4_SIZE = 640
DETECT_TOL = 1e-3       # boxes and scores, captured replay vs eager call


def _pipeline_definition(label: str, llm: dict, parameters: dict,
                         detector: dict | None = None,
                         det_mesh: dict | None = None) -> dict:
    """``(CAP (LLM))``, or ``(DET (CAP (LLM)))`` when the detector's
    parameters are given (the detector placed by ``det_mesh``, one
    position by default)."""
    module = "aiko_services_tpu_torch.elements.llm"
    elements = [
        {"name": "CAP", "input": [{"name": "detections"}],
         "output": [{"name": "text"}],
         "deploy": {"local": {"module": module,
                              "class_name": "DetectionCaption"}}},
        {"name": "LLM", "input": [{"name": "text"}],
         "output": [{"name": "text"}],
         "parameters": {**PIPELINE_LLM, **llm},
         "deploy": {"local": {"module": module, "class_name": "LLM"}}}]
    graph = "(CAP (LLM))"
    if detector is not None:
        graph = "(DET (CAP (LLM)))"
        elements.insert(0, {
            "name": "DET", "input": [{"name": "image"}],
            "output": [{"name": "detections"}],
            "parameters": detector,
            "placement": {"mesh": det_mesh or {"dp": 1}},
            "deploy": {"local": {
                "module": "aiko_services_tpu_torch.elements.detect",
                "class_name": "Detector"}}})
    return {"version": 0, "name": label, "runtime": "torch",
            "graph": [graph], "parameters": parameters,
            "elements": elements}


class Responses(queue.Queue):
    """A pipeline's response queue that stamps each arrival and notes
    each failed frame (an ERROR ends the stream: the run stops)."""

    def __init__(self):
        super().__init__()
        self.arrivals, self.failures = {}, []

    def put(self, item, *args, **kwargs):
        self.arrivals[item[1]] = time.perf_counter()
        if not item[4]:
            self.failures.append(f"frame {item[1]}: {item[5]}")
        super().put(item, *args, **kwargs)


@contextlib.contextmanager
def recording_llm():
    """Instrument the ``LLM`` element's module for one pipeline run and
    yield what it records: its batcher class keeps its settings
    (``made``), submit times and prompt tokens and its host time in
    admission and decode; its emit keeps token ids and finish times; its
    model build is timed.  The module is restored on exit."""
    import torch
    from aiko_services_tpu_torch.elements import llm as port_llm
    from aiko_services_tpu_torch.models.batching import ContinuousBatcher

    timers = {"build_s": 0.0, "admission_s": 0.0, "decode_s": 0.0}
    record = {"timers": timers, "made": [], "prompts": {}, "tokens": {},
              "submitted": {}, "finished": {}}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            begin = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                timers[key] += time.perf_counter() - begin
        return wrapper

    class Batcher(ContinuousBatcher):
        def __init__(self, params, config, **kwargs):
            record["made"].append((config, kwargs))
            super().__init__(params, config, **kwargs)

        def submit(self, request):
            record["submitted"][request.request_id] = time.perf_counter()
            record["prompts"][request.request_id] = \
                list(request.prompt_tokens)
            super().submit(request)
    Batcher._prefill_tick = timed(ContinuousBatcher._prefill_tick,
                                  "admission_s")
    for name in ("_decode_tick", "_dispatch_block", "_retire_block",
                 "_dispatch_loop_block", "_retire_loop_block"):
        setattr(Batcher, name, timed(getattr(ContinuousBatcher, name),
                                     "decode_s"))
    collector = port_llm._collector

    def recording_collector(tokenizer, collected):
        inner = collector(tokenizer, collected)

        def emit(request_id, token, done):
            record["tokens"].setdefault(request_id, []).append(int(token))
            if done:
                record["finished"][request_id] = time.perf_counter()
            inner(request_id, token, done)
        return emit
    patched = {"ContinuousBatcher": Batcher,
               "_collector": recording_collector}
    saved = {name: getattr(port_llm, name) for name in patched}
    ensure_model = port_llm.LLM._ensure_model

    def build(self, settings=None):
        if self._batcher is None:
            begin = time.perf_counter()
            ensure_model(self, settings)
            torch.cuda.synchronize()    # the weights' draw is asynchronous
            timers["build_s"] += time.perf_counter() - begin
    for name, value in patched.items():
        setattr(port_llm, name, value)
    port_llm.LLM._ensure_model = build
    try:
        yield record
    finally:
        for name, value in saved.items():
            setattr(port_llm, name, value)
        port_llm.LLM._ensure_model = ensure_model


@contextlib.contextmanager
def loopback_runtime():
    """A fresh process runtime of the port on its in-memory loopback
    broker, torn down on exit (the card's cache emptied)."""
    import torch
    from aiko_services_tpu_torch.runtime import init_process, reset_process
    from aiko_services_tpu_torch.services.share import reset_services_cache
    from aiko_services_tpu_torch.transport import reset_broker
    reset_broker()
    reset_services_cache()
    runtime = init_process(transport="loopback")
    runtime.initialize()
    try:
        yield runtime
    finally:
        runtime.engine.terminate()
        reset_process()
        reset_services_cache()
        reset_broker()
        torch.cuda.empty_cache()


def load_pipeline(definition: dict, runtime):
    """``create_pipeline`` on the definition, written to a JSON file as
    a user would give it."""
    import tempfile
    from aiko_services_tpu_torch.pipeline import create_pipeline
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        path = Path(workdir) / f"{definition['name']}.json"
        path.write_text(json.dumps(definition))
        return create_pipeline(str(path), runtime=runtime)


def zero_launches() -> dict:
    """Every launch counter of the port set to 0; returns the counters."""
    from aiko_services_tpu_torch.ops import launch_counters
    counters = launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    return counters


def read_launches(counters: dict) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def check_launches(label: str, counts: dict, wanted: set) -> None:
    """Every kernel of ``wanted`` launched in the run, no other one did."""
    for name, count in counts.items():
        if (count > 0) != (name in wanted):
            raise AssertionError(
                f"{label}: {name} launched {count} times; the run's "
                f"path is {sorted(wanted)}")


def direct_streams(batcher, record: dict, alone) -> dict:
    """The run's prompts through a ``ContinuousBatcher`` built directly
    with the element's settings on the element's weights, greedy, in
    submission order; a request id in ``alone`` is drained before the
    next is submitted.  A comparison: it counts nowhere."""
    from aiko_services_tpu_torch.models.batching import (ContinuousBatcher,
                                                         Request)
    from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer
    config, kwargs = record["made"][0]
    direct = ContinuousBatcher(batcher.params, config, **{
        name: value for name, value in kwargs.items()
        if name not in ("fetch", "fault_probe", "on_block")})
    eos = ByteTokenizer().eos_tokens
    streams = {rid: [] for rid in record["prompts"]}
    for rid, prompt in record["prompts"].items():
        direct.submit(Request(
            rid, prompt, max_new_tokens=NEW_TOKENS, temperature=0.0,
            eos_tokens=eos,
            emit=lambda r, token, done: streams[r].append(int(token))))
        if rid in alone:
            direct.run_until_drained()
    direct.run_until_drained()
    return streams


def agree_with_direct(label: str, streams: dict, record: dict,
                      request_of: dict, texts: dict, ledger: dict) -> None:
    """Each frame's text and token ids against the direct batcher's."""
    from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer
    tokenizer = ByteTokenizer()
    agree = 0
    for frame_id, rid in request_of.items():
        direct_text = tokenizer.decode(
            [t for t in streams[rid] if t not in tokenizer.eos_tokens])
        agree += streams[rid] == record["tokens"][rid] \
            and direct_text == texts[frame_id]
    print(f"{label}: frames equal to the direct batcher (text and "
          f"token ids): {agree}/{len(request_of)}; ledger "
          f"{json.dumps(ledger)}", flush=True)
    if agree != len(request_of):
        raise AssertionError(f"{label}: {len(request_of) - agree} frames "
                             f"differ from the direct batcher")


def pipeline_run(label: str, llm: dict, parameters: dict, decode: str,
                 card: str, detector: dict | None = None,
                 frames_in: list | None = None, after=None,
                 kernels: set | None = None,
                 det_mesh: dict | None = None) -> dict:
    """One run of the ``(CAP (LLM))`` pipeline over PIPELINE_DETECTIONS
    (see the module docstring) -- or of ``(DET (CAP (LLM)))`` over
    ``frames_in`` when ``detector`` holds the detector's parameters --
    then the same prompts through a ``ContinuousBatcher`` built
    directly with the element's settings on the element's weights.  The
    launch counters are zeroed just before the frames and read as the
    last frame's response arrives; the direct run is a comparison and
    counts nowhere.  The element's module is instrumented for the run
    only (``recording_llm``).  ``after(pipeline, frame_metrics)`` runs
    before the pipeline stops; its dict joins the result, beside each
    frame's ``detections`` (None without a detector).  ``kernels``
    names the run's path when it is not ``decode`` with its combine, #4
    and #6; ``det_mesh`` places the detector."""
    import torch
    from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer

    with recording_llm() as record, loopback_runtime() as runtime:
        timers, prompts = record["timers"], record["prompts"]
        submitted, finished = record["submitted"], record["finished"]
        pipeline = load_pipeline(_pipeline_definition(
            label, llm, parameters, detector, det_mesh), runtime)
        counters = zero_launches()
        responses = Responses()
        arrivals, failures = responses.arrivals, responses.failures
        if frames_in is None:
            frames_in = [{"detections": detections}
                         for detections in PIPELINE_DETECTIONS]
        frames = len(frames_in)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        begin = time.perf_counter()
        stream = pipeline.create_stream_local("1", queue_response=responses)
        # The first frame alone (it pays the model build and, in the
        # loop, the capture), then the rest at once: their prompts find
        # the first one's pages in the prefix index.
        pipeline.create_frame_local(stream, frames_in[0])
        runtime.run(until=lambda: responses.qsize() >= 1, timeout=300.0)
        burst = time.perf_counter()
        for frame in frames_in[1:]:
            pipeline.create_frame_local(stream, frame)
        runtime.run(until=lambda: responses.qsize() >= frames or failures,
                    timeout=300.0)
        counts = read_launches(counters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - begin
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if failures or responses.qsize() < frames:
            raise AssertionError(f"{label}: {responses.qsize()} of {frames} "
                                 f"frames answered; failed: {failures}")
        element = pipeline.graph.get_node("LLM").element
        batcher = element._batcher
        texts, captions, frame_metrics, detections = {}, {}, {}, {}
        while not responses.empty():
            _, frame_id, swag, frame_metrics[frame_id], okay, diagnostic = \
                responses.get()
            if not okay:
                raise AssertionError(f"{label}: frame {frame_id} failed: "
                                     f"{diagnostic}")
            texts[frame_id], captions[frame_id] = swag["text"], \
                swag["CAP.text"]
            detections[frame_id] = swag.get("detections")
        tokenizer = ByteTokenizer()
        by_prompt = {tuple(prompt): rid for rid, prompt in prompts.items()}
        request_of = {
            frame_id: by_prompt[tuple(tokenizer.encode(SYSTEM_PROMPT
                                                       + caption))]
            for frame_id, caption in captions.items()}
        ledger = pipeline.transfer_ledger.stats
        loop = batcher._loop
        burst_s = begin + wall - burst
        first_rid = next(iter(prompts))
        metrics = {
            "run": label, "frames": frames, "wall_s": wall,
            "first_frame_ms": (min(arrivals.values()) - begin) * 1e3,
            "burst_frames_per_s": (frames - 1) / burst_s,
            "burst_wall_per_frame_ms": burst_s * 1e3 / (frames - 1),
            **timers,
            "capture_s": loop.capture_s if loop is not None else 0.0,
            "inbound_hop_ms_max": max(submitted[rid] - burst
                                      for rid in submitted
                                      if rid != first_rid) * 1e3,
            "return_hop_ms_max": max(arrivals[frame] - finished[rid]
                                     for frame, rid in request_of.items())
            * 1e3,
            "tokens": batcher.tokens_emitted,
            "blocks_retired": batcher.blocks_retired,
            "ledger": ledger, "recoveries": batcher.recoveries,
            "prefix_hits": batcher.prefix_hits,
            "leaked": batcher._pages.leaked_pages() if batcher._pages else 0,
            "peak_memory_gib": peak, "card": card}
        print(f"pipeline {json.dumps(metrics)} launches "
              f"{json.dumps(counts)}", flush=True)
        check_launches(label, counts, kernels if kernels is not None else {
            decode, "decode_combine", "flash_attention", "topk"})
        if batcher.device_loop and (
                ledger["explicit_by_label"].get("llm_block", 0)
                != batcher.blocks_retired or ledger["implicit"]
                or batcher.recoveries):
            raise AssertionError(f"{label}: ledger fetches {ledger} against "
                                 f"{batcher.blocks_retired} blocks retired, "
                                 f"{batcher.recoveries} recoveries")
        if metrics["leaked"] or (batcher.prefix_cache
                                 and batcher.prefix_hits <= 0):
            raise AssertionError(f"{label}: {metrics['leaked']} leaked pages,"
                                 f" {batcher.prefix_hits} prefix hits")
        streams = direct_streams(batcher, record, alone={first_rid})
        agree_with_direct(label, streams, record, request_of, texts, ledger)
        extra = after(pipeline, frame_metrics) if after is not None else {}
        del batcher, loop
        pipeline.stop()
        element.close()
        return {"metrics": metrics, "launches": counts,
                "detections": detections, "texts": texts, **extra}


def detector_work(config, batch: int, size: int) -> dict:
    """One batched ``detect``'s convolution operations (2 a
    multiply-add) and bytes: the function's own (uint8-normalised f32
    images read, weights read, the slate written) and, for reference,
    the activations' (each conv's bf16 input read and output written
    once)."""
    from aiko_services_tpu_torch.models.detector import param_shapes
    layout = param_shapes(config)
    ops, weights, activations = 0, 0, 0

    def conv(shape, n_in, stride):
        nonlocal ops, weights, activations
        cout, cin, kernel = shape
        n_out = -(-n_in // stride)
        ops += 2 * batch * cout * cin * kernel * kernel * n_out * n_out
        weights += (cout * cin * kernel * kernel + cout) * 2
        activations += batch * (cin * n_in * n_in + cout * n_out * n_out) * 2
        return n_out

    n = conv(layout["stem"], size, 2)
    sides = []
    for name in ("stage1", "stage2", "stage3", "stage4"):
        n = conv(layout[name]["down"], n, 2)
        for block in layout[name]["blocks"]:
            conv(block["c1"], n, 1)
            conv(block["c2"], n, 1)
        sides.append(n)
    p3, p4, p5 = sides[1:]
    conv(layout["lateral4"], p4, 1)
    conv(layout["lateral3"], p3, 1)
    for head, side in zip(layout["heads"], (p3, p4, p5)):
        conv(head, side, 1)
    slate = batch * config.max_detections * (4 * 4 + 4 + 8 + 1)
    return {"ops": ops, "bytes": batch * size * size * 3 * 4 + weights
            + slate, "activation_bytes": activations}


def device_ms(fn, calls: int = 10) -> float:
    """The median of ``calls`` calls' device time (CUDA events)."""
    import numpy as np
    import torch
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def config4_images() -> list:
    """Config 4's frames: 640x640x3 uint8 from numpy seed 4."""
    import numpy as np
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, (CONFIG4_SIZE, CONFIG4_SIZE, 3),
                         dtype=np.uint8) for _ in range(CONFIG4_FRAMES)]


def config4_run(card: str) -> dict:
    """BASELINE config 4 on one card: ``(DET (CAP (LLM)))`` through the
    port's ``create_pipeline``, the detector placed on the card by its
    placement block, the LLM as in ``pipeline-loop-16``.  Eight
    640x640x3 uint8 frames from a numpy seed, the first alone, then
    seven at once.  Beside ``pipeline_run``'s gates: a captured batch-8
    replay of ``detect`` equals an eager call on the same batch
    (``valid`` and ``classes`` exactly, boxes and scores within
    DETECT_TOL), detect dispatches number fewer than the frames, the
    LLM's decode steps stay below 0.6 x frames x new tokens (the JAX
    package's overlap test: steps are batched decode steps, the device
    loop's counted on the device), and the device health probe finds
    no failed card."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.models import detector
    from aiko_services_tpu_torch.pipeline import JitCache

    images = config4_images()

    def after(pipeline, frame_metrics) -> dict:
        det = pipeline.graph.get_node("DET").element
        batcher = pipeline.graph.get_node("LLM").element._batcher
        dispatches = det.jit_cache.hits + det.jit_cache.misses
        steps_limit = 0.6 * CONFIG4_FRAMES * NEW_TOKENS
        failed = pipeline.check_device_health()
        plan = pipeline.stage_placement.plan("DET")
        out = {"detect_dispatches": dispatches,
               "detect_graphs": det.jit_cache.entries,
               "detect_capture_s": det.jit_cache.capture_s,
               "llm_steps": batcher.steps, "llm_steps_limit": steps_limit,
               "health_failed": [str(device) for device in failed],
               "det_mesh": dict(plan.mesh.shape),
               "det_device": str(plan.device),
               "det_time_ms_median": float(np.median(
                   [m["DET_time"] for m in frame_metrics.values()])) * 1e3,
               "llm_time_ms_median": float(np.median(
                   [m["LLM_time"] for m in frame_metrics.values()])) * 1e3}
        if dispatches >= CONFIG4_FRAMES or batcher.steps >= steps_limit \
                or failed:
            raise AssertionError(f"config4: {out}")

        # A captured batch-8 replay against an eager call, same batch.
        device = plan.device
        batch = torch.from_numpy(np.stack(images)).to(device).float() / 255.0
        replayed = det._detect(det._params, batch)
        eager = detector.detect(det._params, det._config, batch)
        torch.cuda.synchronize()
        for name in ("valid", "classes"):
            if not torch.equal(replayed[name], eager[name]):
                raise AssertionError(f"config4: replay {name} differs from "
                                     f"the eager call")
        error = max((replayed[name] - eager[name]).abs().max().item()
                    for name in ("boxes", "scores"))
        out["replay_vs_eager_max_abs_err"] = error
        out["detections_per_frame"] = replayed["valid"].sum(-1).tolist()
        if error > DETECT_TOL:
            raise AssertionError(f"config4: replay boxes/scores differ from "
                                 f"the eager call by {error}")

        out["detect_replay_ms"] = device_ms(
            lambda: det._detect(det._params, batch))
        forward = JitCache()(
            lambda params, x: detector.forward(params, det._config, x))
        forward(det._params, batch)         # the capture, off the clock
        out["detect_forward_replay_ms"] = device_ms(
            lambda: forward(det._params, batch))
        out["detect_eager_ms"] = device_ms(
            lambda: detector.detect(det._params, det._config, batch))
        work = detector_work(det._config, CONFIG4_FRAMES, CONFIG4_SIZE)
        out["detect_bound_ms"], out["detect_bound_by"] = bound_ms(
            work["bytes"], work["ops"], "bf16")
        out.update({"detect_gflop": work["ops"] / 1e9,
                    "detect_activation_mb": work["activation_bytes"] / 1e6,
                    "card": card})
        print(f"config4 {json.dumps(out)}", flush=True)
        return {"config4": out}

    return pipeline_run(
        "config4-loop-16", {"decode_block_tokens": 16},
        {"transfer_guard": "disallow"}, "flash_decode_attention_stacked",
        card, detector=CONFIG4_DETECTOR,
        frames_in=[{"image": image} for image in images], after=after)


# -- phase 14: config 4 with DET split over its stage's dp positions ------

#: DET's stage in ``config4-dp2-loop-16``: two dp positions, which the
#: one card stands in for (the device pool lists it twice).
CONFIG4_DP_MESH = {"dp": 2}


def compare_detections(got: dict, want: dict) -> dict:
    """Each frame's detections (frame id -> list) against another run's:
    a frame agrees when its count and classes are equal in order and
    every box coordinate and score lies within DETECT_TOL -> the frames
    that agree, of how many, and the largest error over the frames
    whose classes agree."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"frames {sorted(got)} against {sorted(want)}")
    agree, error = 0, 0.0
    for frame_id, rows in got.items():
        expected = want[frame_id]
        if [d["class"] for d in rows] != [d["class"] for d in expected]:
            continue
        frame_error = max([abs(a - b) for mine, theirs in zip(rows, expected)
                           for a, b in zip(mine["box"] + [mine["score"]],
                                           theirs["box"] + [theirs["score"]])]
                          or [0.0])
        error = max(error, frame_error)
        agree += frame_error <= DETECT_TOL
    return {"frames_equal": agree, "frames": len(got), "max_abs_err": error}


def position_detections(det, images: list, first_id: int,
                        positions: int | None = None) -> dict:
    """``images`` as the ``Detector``'s worker runs one micro-batch of
    them over ``positions`` (by default its stage's) -- padded to a
    multiple of them, each position's rows one batch -- but every batch
    through the captured ``detect`` on the lead card: frame id ->
    detections."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.models.batching import pad_to_bucket
    positions = positions or det.plan.mesh.size
    padded = pad_to_bucket(images, multiple=positions)
    rows = len(padded) // positions
    found = []
    for position in range(positions):
        batch = torch.from_numpy(np.stack(
            padded[position * rows:(position + 1) * rows])).to(
                det.plan.device).float() / 255.0
        fetched = {name: value.cpu().numpy()
                   for name, value in det._detect(det._params, batch).items()}
        found += [det._slate_outputs(fetched, row)["detections"]
                  for row in range(rows)]
    return {first_id + index: rows for index, rows
            in enumerate(found[:len(images)])}


def config4_dp_run(card: str, single: dict) -> dict:
    """Phase 7's run with DET placed by ``placement: {mesh: {dp: 2}}``:
    the device pool (``device.local_devices``) lists the one card twice
    for the run, so DET's stage has two positions on it and the
    ``Detector`` splits every micro-batch over them, each position's
    rows run in turn on the card's worker stream.  Beside
    ``pipeline_run``'s gates: the detections equal phase 7's
    (``single``: the same count and classes, boxes and scores within
    DETECT_TOL) where the two ran the same batch shape -- the first
    frame, alone in both -- and every frame's equal to its position's
    rows run at the same shape through the one-position captured
    ``detect``; both positions dispatched every micro-batch, fewer
    micro-batches than frames, LLM steps below 0.6 x frames x new
    tokens and no failed card; and the burst run as one batch of 8 on
    the lead card (phase 7's shape) equal to phase 7's.  The burst's
    agreement with phase 7's (batch 8 there, 4 a position here) is
    printed beside the same comparison made on one card alone (batch 8
    against two batches of 4): bf16 slates at another batch shape may
    break score ties otherwise."""
    import numpy as np
    from aiko_services_tpu_torch import device as device_rule

    images = config4_images()

    def after(pipeline, frame_metrics) -> dict:
        det = pipeline.graph.get_node("DET").element
        batcher = pipeline.graph.get_node("LLM").element._batcher
        positions = [dict(stats) for stats in det.position_stats]
        micro_batches = positions[0]["batches"]
        steps_limit = 0.6 * CONFIG4_FRAMES * NEW_TOKENS
        failed = pipeline.check_device_health()
        out = {"det_mesh": dict(det.plan.mesh.shape),
               "positions": positions, "micro_batches": micro_batches,
               "detect_calls": det.jit_cache.hits + det.jit_cache.misses,
               "detect_graphs": det.jit_cache.entries,
               "graph_devices": sorted(map(str, det.jit_cache.devices)),
               "detect_capture_s": det.jit_cache.capture_s,
               "llm_steps": batcher.steps, "llm_steps_limit": steps_limit,
               "health_failed": [str(device) for device in failed],
               "det_time_ms_median": float(np.median(
                   [m["DET_time"] for m in frame_metrics.values()])) * 1e3,
               "llm_time_ms_median": float(np.median(
                   [m["LLM_time"] for m in frame_metrics.values()])) * 1e3}
        if out["det_mesh"] != CONFIG4_DP_MESH or micro_batches < 1 \
                or any(stats["batches"] != micro_batches
                       for stats in positions) \
                or micro_batches >= CONFIG4_FRAMES \
                or batcher.steps >= steps_limit or failed:
            raise AssertionError(f"config4-dp2: {out}")
        same_shape = {**position_detections(det, images[:1], 0),
                      **position_detections(det, images[1:], 1)}
        batch8 = position_detections(det, images[1:], 1, positions=1)
        out["one_card_batch8_vs_batch4"] = compare_detections(
            batch8, {frame_id: rows for frame_id, rows
                     in same_shape.items() if frame_id})
        return {"config4_dp": out, "same_shape": same_shape,
                "batch8": batch8}

    begin = time.perf_counter()
    pool = device_rule.local_devices
    card_zero = pool()[0]
    device_rule.local_devices = lambda: [card_zero] * CONFIG4_DP_MESH["dp"]
    try:
        result = pipeline_run(
            "config4-dp2-loop-16", {"decode_block_tokens": 16},
            {"transfer_guard": "disallow"}, "flash_decode_attention_stacked",
            card, detector=CONFIG4_DETECTOR,
            frames_in=[{"image": image} for image in images], after=after,
            det_mesh=CONFIG4_DP_MESH)
    finally:
        device_rule.local_devices = pool
    out = result["config4_dp"]
    got = result["detections"]
    out["vs_positions_same_shape"] = compare_detections(
        got, result["same_shape"])
    phase7 = single["detections"]
    out["vs_phase7_first_frame"] = compare_detections(
        {0: got[0]}, {0: phase7[0]})
    out["batch8_vs_phase7_burst"] = compare_detections(
        result["batch8"], {frame_id: rows for frame_id, rows
                           in phase7.items() if frame_id})
    out["vs_phase7_burst"] = compare_detections(
        {frame_id: rows for frame_id, rows in got.items() if frame_id},
        {frame_id: rows for frame_id, rows in phase7.items() if frame_id})
    out.update({"phase7_det_time_ms_median":
                single["config4"]["det_time_ms_median"],
                "phase_s": time.perf_counter() - begin, "card": card})
    print(f"config4-dp2 {json.dumps(out)}", flush=True)
    for key in ("vs_positions_same_shape", "vs_phase7_first_frame",
                "batch8_vs_phase7_burst"):
        if out[key]["frames_equal"] != out[key]["frames"]:
            raise AssertionError(f"config4-dp2: detections {key}: "
                                 f"{out[key]}")
    return result


# -- phase 8: BASELINE config 5, streaming ASR -> gate -> int8 LLM ---------

#: BASELINE config 5 (``BASELINE.md:31``) as ``bench.py``'s
#: ``bench_speech_e2e`` drives it: the ASR at Whisper-base widths (dim
#: 384, 6 heads, 4 + 4 layers, 80 mels, 10 s chunks, a 128-token
#: budget) on streaming 1 s hops with a 0.5 s energy endpoint, the gate
#: on ``utterance_end``, the LLM at Llama-3.2-1B widths with int8
#: weights (dense attention at max_seq 512: no attention kernel).
CONFIG5_ASR = {"model_size": "base", "streaming": True,
               "hop_seconds": 1.0, "endpoint_silence": 0.5}
CONFIG5_LLM = {"model": "llama3-1b", "max_seq": 512, "quantize": "int8",
               "decode_block": 16, "inflight": 3,
               "max_new_tokens": NEW_TOKENS}
CONFIG5_RATE = 16_000
CONFIG5_UTTERANCES = 3      # after a warm-up utterance
CONFIG5_SPEECH_HOPS = 3     # then one silence hop, an utterance
CONFIG5_SOLO_HOPS = 6       # the gate-free (ASR) pipeline's hops
#: config 5's path: #5's two routes and the decode route's combine.
CONFIG5_KERNELS = {"int8_matmul", "int8_matmul[M>16]", "int8_combine"}


def _config5_definition(name: str, with_llm: bool = True) -> dict:
    """bench.py's ``(ASR (GATE (LLM)))`` under ``transfer_guard:
    disallow``, or the gate-free ``(ASR)``."""
    module = "aiko_services_tpu_torch.elements"

    def entry(name, cls, inputs, outputs, parameters, source):
        return {"name": name, "input": [{"name": n} for n in inputs],
                "output": [{"name": n} for n in outputs],
                "parameters": parameters,
                "deploy": {"local": {"module": f"{module}.{source}",
                                     "class_name": cls}}}
    asr = entry("ASR", "ASR", ["audio", "sample_rate"],
                ["text", "partial_text", "utterance_end"], CONFIG5_ASR,
                "speech")
    if not with_llm:
        return {"version": 0, "name": name, "runtime": "torch",
                "graph": ["(ASR)"], "parameters": {}, "elements": [asr]}
    return {"version": 0, "name": name, "runtime": "torch",
            "graph": ["(ASR (GATE (LLM)))"],
            "parameters": {"transfer_guard": "disallow"},
            "elements": [
                asr,
                entry("GATE", "TextFilter", ["text", "utterance_end"],
                      ["text"], {"gate": "utterance_end"}, "text"),
                entry("LLM", "LLM", ["text"], ["text"], CONFIG5_LLM,
                      "llm")]}


def asr_work(config, batch: int) -> dict:
    """One batched ``transcribe``'s operations (2 a multiply-add: the mel
    projection, both convolutions, every weight product, the attention
    products of the encoder, the cross-attention projections and all
    ``max_text`` decode steps, which run whether or not a row has
    ended; the FFT's few are left out) and bytes (the waveform read, the
    weights read once, the token ids written)."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.models.asr import _dtype, param_shapes
    c = config
    d, proj, hidden = c.dim, c.n_heads * c.head_dim, c.hidden_dim
    frames, t = c.n_frames, c.n_audio_positions
    ops = 2 * frames * (c.n_fft // 2 + 1) * c.n_mels
    ops += 2 * (frames // 2) * d * c.n_mels * 3 + 2 * t * d * d * 3
    ops += c.n_encoder_layers * (8 * t * d * proj + 4 * t * t * proj
                                 + 6 * t * d * hidden)
    ops += c.n_decoder_layers * 4 * t * d * proj        # cross K and V
    for step in range(c.max_text):
        ops += c.n_decoder_layers * (
            12 * d * proj + 4 * (step + 1) * proj + 4 * t * proj
            + 6 * d * hidden) + 2 * d * c.vocab_size

    def count(layout):
        return sum(count(v) if isinstance(v, dict) else
                   int(np.prod(v)) for v in layout.values())
    width = torch.empty((), dtype=_dtype(c)).element_size()
    weights = count(param_shapes(c)) * width
    chunk = int(c.sample_rate * c.chunk_seconds)
    return {"ops": batch * ops,
            "bytes": batch * chunk * 4 + weights + batch * c.max_text * 4,
            "weight_bytes": weights}


def config5_run(card: str) -> dict:
    """BASELINE config 5 on one card: ``(ASR (GATE (LLM)))`` through the
    port's ``create_pipeline`` as ``bench.py`` drives it -- numpy seed
    0, 1 s hops of N(0, 0.3) speech or zeros, a warm-up utterance of 3
    speech hops and a silence hop, then 3 such utterances -- and a
    gate-free ``(ASR)`` pipeline for the per-hop time.  The launch
    counters are zeroed just before the first hop and read after the
    last reply.  Gates: one OKAY reply an utterance and no other
    response; the LLM sees the 4 utterance-end frames (12 speech hops
    drop at the gate); the ASR counts 12 partial decodes and 4
    finalised chunks; each reply's text and token ids equal the direct
    batcher's on the element's weights and the transcript prompt; no
    guard error and ledger fetches = blocks retired; #5's two routes and
    its combine launch, no other kernel; a captured batch-1
    ``transcribe`` replay equals the eager call's token ids; streaming
    push/flush joined equals the whole-chunk transcription of the same
    audio.  Prints the capture's seconds, the replay's and the eager
    call's device ms (CUDA events) beside the bound, the hop and
    utterance -> reply p50s, the peak memory and one base-width TTS
    ``synthesize`` of the first reply."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.models import asr, tts
    from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer

    label = "config5-speech"
    rng = np.random.default_rng(0)
    speech = (rng.standard_normal(CONFIG5_RATE) * 0.3).astype(np.float32)
    silence = np.zeros(CONFIG5_RATE, dtype=np.float32)
    hops = ([speech] * CONFIG5_SPEECH_HOPS + [silence]) \
        * (1 + CONFIG5_UTTERANCES)
    utterances = 1 + CONFIG5_UTTERANCES
    with recording_llm() as record, loopback_runtime() as runtime:
        pipeline = load_pipeline(_config5_definition(label), runtime)
        responses = Responses()

        def replies(count: int, timeout: float) -> None:
            runtime.run(until=lambda: responses.qsize() >= count
                        or responses.failures, timeout=timeout)
            if responses.failures or responses.qsize() < count:
                raise AssertionError(
                    f"{label}: {responses.qsize()} of {count} replies; "
                    f"failed: {responses.failures}")
        counters = zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        begin = time.perf_counter()
        reply_ms = []
        per_utterance = CONFIG5_SPEECH_HOPS + 1
        for index, samples in enumerate(hops):
            pushed = time.perf_counter()
            pipeline.process_frame_local(
                {"audio": samples, "sample_rate": CONFIG5_RATE},
                stream_id="speech", queue_response=responses)
            if index % per_utterance == per_utterance - 1:
                utterance = index // per_utterance
                replies(utterance + 1, 600.0 if utterance == 0 else 300.0)
                if utterance:           # the warm-up pays the builds
                    reply_ms.append((max(responses.arrivals.values())
                                     - pushed) * 1e3)
        first_reply_ms = (min(responses.arrivals.values()) - begin) * 1e3
        runtime.run(until=lambda: responses.qsize() > utterances,
                    timeout=1.0)
        counts = read_launches(counters)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        asr_element = pipeline.graph.get_node("ASR").element
        streamer = asr_element._streamers["speech"]
        llm_element = pipeline.graph.get_node("LLM").element
        batcher = llm_element._batcher
        ledger = pipeline.transfer_ledger.stats
        tokenizer = ByteTokenizer()
        texts, transcripts = {}, {}
        while not responses.empty():
            _, frame_id, swag, _, okay, diagnostic = responses.get()
            if not okay:
                raise AssertionError(f"{label}: frame {frame_id} failed: "
                                     f"{diagnostic}")
            texts[frame_id], transcripts[frame_id] = swag["text"], \
                swag["GATE.text"]
        by_prompt = {tuple(prompt): rid
                     for rid, prompt in record["prompts"].items()}
        request_of = {frame_id: by_prompt[tuple(tokenizer.encode(text))]
                      for frame_id, text in transcripts.items()}
        ends = [index for index in range(len(hops))
                if index % per_utterance == per_utterance - 1]
        out = {"run": label, "hops": len(hops),
               "replies": sorted(texts), "llm_requests":
               len(record["prompts"]),
               "partial_decodes": streamer.partial_decodes,
               "chunks_transcribed": streamer.chunks_transcribed,
               "transcripts_bytes": [len(transcripts[f]) for f in
                                     sorted(transcripts)],
               "ledger": ledger, "blocks_retired": batcher.blocks_retired,
               "llm_steps": batcher.steps,
               "first_reply_ms": first_reply_ms,
               "utterance_to_reply_ms": reply_ms,
               "utterance_to_reply_p50_ms": float(np.median(reply_ms)),
               **record["timers"], "peak_memory_gib": peak, "card": card}
        print(f"config5 pipeline {json.dumps(out)} launches "
              f"{json.dumps(counts)}", flush=True)
        if sorted(texts) != ends or len(record["prompts"]) != utterances:
            raise AssertionError(f"{label}: replies to frames "
                                 f"{sorted(texts)}, LLM requests "
                                 f"{len(record['prompts'])}; expected the "
                                 f"utterance ends {ends}")
        if (streamer.partial_decodes, streamer.chunks_transcribed) != (
                CONFIG5_SPEECH_HOPS * utterances, utterances):
            raise AssertionError(f"{label}: {streamer.partial_decodes} "
                                 f"partial decodes, "
                                 f"{streamer.chunks_transcribed} chunks")
        if ledger["implicit"] or ledger["explicit_by_label"].get(
                "llm_block", 0) != batcher.blocks_retired:
            raise AssertionError(f"{label}: ledger {ledger} against "
                                 f"{batcher.blocks_retired} blocks retired")
        check_launches(label, counts, CONFIG5_KERNELS)
        streams = direct_streams(batcher, record,
                                 alone=set(record["prompts"]))
        agree_with_direct(label, streams, record, request_of, texts, ledger)

        # A captured batch-1 transcribe against the eager call.
        config, params = asr_element._config, asr_element._params
        device = params["embed"].device
        window = asr.upload(asr.pad_audio(config, np.concatenate(
            [speech] * CONFIG5_SPEECH_HOPS))[None], device)
        replayed = asr_element._transcribe(window)
        eager = asr.transcribe(params, config, window)
        if not torch.equal(replayed, eager):
            raise AssertionError(f"{label}: the captured transcribe's "
                                 f"tokens differ from the eager call's")
        work = asr_work(config, 1)
        bound, bound_by = bound_ms(work["bytes"], work["ops"], "bf16")
        out = {"transcribe_graphs": asr_element.jit_cache.entries,
               "transcribe_capture_s": asr_element.jit_cache.capture_s,
               "transcribe_replay_ms": device_ms(
                   lambda: asr_element._transcribe(window)),
               "transcribe_eager_ms": device_ms(
                   lambda: asr.transcribe(params, config, window), calls=3),
               "transcribe_bound_ms": bound,
               "transcribe_bound_by": bound_by,
               "transcribe_gflop": work["ops"] / 1e9,
               "asr_weight_mb": work["weight_bytes"] / 1e6}

        # Streaming push/flush joined against whole-chunk transcription:
        # 12 s of new speech fills one 10 s chunk, the flush takes 2 s.
        audio = (rng.standard_normal(12 * CONFIG5_RATE) * 0.3).astype(
            np.float32)
        live = asr.StreamingAsr(params, config, hop_seconds=1.0,
                                transcribe_fn=asr_element._transcribe)
        joined = "".join(live.push(piece) for piece in
                         np.split(audio, 12)) + live.flush()
        chunk = int(config.sample_rate * config.chunk_seconds)
        whole = "".join(asr.decode_text(config, asr.transcribe(
            params, config, asr.upload(asr.pad_audio(config, part)[None],
                                       device))[0].cpu().numpy())
            for part in (audio[:chunk], audio[chunk:]))
        out["streaming_equals_whole"] = joined == whole
        if joined != whole:
            raise AssertionError(f"{label}: streaming gave {joined!r}, the "
                                 f"whole chunks {whole!r}")

        # The per-hop time through a gate-free (ASR) pipeline.
        solo = load_pipeline(_config5_definition("config5-solo", False),
                             runtime)
        solo_responses = Responses()
        hop_ms = []
        for index in range(CONFIG5_SOLO_HOPS):
            start = time.perf_counter()
            solo.process_frame_local(
                {"audio": speech, "sample_rate": CONFIG5_RATE},
                stream_id="solo", queue_response=solo_responses)
            runtime.run(until=lambda: solo_responses.qsize() > index,
                        timeout=300.0)
            if solo_responses.failures or solo_responses.qsize() <= index:
                raise AssertionError(f"{label}: solo hop {index} failed: "
                                     f"{solo_responses.failures}")
            if index:                   # the first hop pays the build
                hop_ms.append((time.perf_counter() - start) * 1e3)
        out.update({"hop_ms": hop_ms, "hop_p50_ms": float(np.median(hop_ms))})

        # One base-width TTS synthesize of the first reply.
        tts_config = tts.TtsConfig()
        tts_params = tts.init_params(0, tts_config, device)
        reply = texts[ends[0]]
        tts.synthesize(tts_params, tts_config, reply)     # plans, warm-up
        start = time.perf_counter()
        waveform = tts.synthesize(tts_params, tts_config, reply)
        out["tts_synthesize_ms"] = (time.perf_counter() - start) * 1e3
        peak_abs = float(np.abs(waveform).max())
        out.update({"tts_samples": int(waveform.shape[0]),
                    "tts_finite": bool(np.isfinite(waveform).all()),
                    "tts_peak": peak_abs, "card": card})
        print(f"config5 {json.dumps(out)}", flush=True)
        if not out["tts_finite"] or abs(peak_abs - 1.0) > 1e-5 \
                or waveform.shape != (tts_config.n_frames * tts_config.hop,):
            raise AssertionError(f"{label}: TTS waveform {waveform.shape}, "
                                 f"finite {out['tts_finite']}, peak "
                                 f"{peak_abs}")
        del batcher, tts_params
        solo.stop()
        pipeline.stop()
        llm_element.close()
        return {"launches": counts, "config5": out}


# -- phase 9: bench.py's fusion chain, fused on the card -------------------

#: ``bench.py``'s ``bench_pipeline_fusion``: ``(R1 (R2 (DET)))``, two
#: synchronous ImageResizes (512 then 640) and a synchronous Detector,
#: here at phase 7's YOLO-n scale (width 32, depth 1, 80 classes, bf16,
#: seed 0; bench.py leaves the element's width of 8), under
#: ``transfer_guard: disallow`` and ``device_inflight: 3``; 24 frames
#: cycling through 4 frames of 576x576x3 uint8 (numpy seed 0).
FUSION_FRAMES = 24
FUSION_SOURCES = 4
FUSION_SOURCE_SIZE = 576
FUSION_SIZES = (("R1", 512), ("R2", 640))
FUSION_DETECTOR = {"width": 32, "seed": 0, "synchronous": True,
                   "class_names": [name.replace(" ", "_")
                                   for name in COCO_CLASSES]}
FUSION_BURST = 8            # the async resize burst, from two streams


def _fusion_definition(mode: str) -> dict:
    image = "aiko_services_tpu_torch.elements.image"
    elements = [
        {"name": name, "input": [{"name": "image"}],
         "output": [{"name": "image"}],
         "parameters": {"width": size, "height": size,
                        "synchronous": True},
         "deploy": {"local": {"module": image,
                              "class_name": "ImageResize"}}}
        for name, size in FUSION_SIZES]
    elements.append(
        {"name": "DET", "input": [{"name": "image"}],
         "output": [{"name": "image"}, {"name": "overlay"},
                    {"name": "detections"}],
         "parameters": FUSION_DETECTOR,
         "deploy": {"local": {
             "module": "aiko_services_tpu_torch.elements.detect",
             "class_name": "Detector"}}})
    return {"version": 0, "name": f"fusion-{mode}", "runtime": "torch",
            "graph": ["(R1 (R2 (DET)))"],
            "parameters": {"transfer_guard": "disallow",
                           "device_inflight": 3, "fuse": mode},
            "elements": elements}


def fusion_mode_run(mode: str, sources: list) -> dict:
    """FUSION_FRAMES frames through one stream of the chain: each
    frame's image (on the host), detections, overlay and metrics, the
    launch counts, the steady frames/s (the frames after the first
    response, whose capture is off the clock), the transfer and fusion
    stats, the peak memory above what the card held before the run
    and, fused, one segment call's device time (CUDA events: the
    upload, the replay and its output copies)."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.device import sync_allowed

    with loopback_runtime() as runtime:
        pipeline = load_pipeline(_fusion_definition(mode), runtime)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        counters = zero_launches()
        responses = Responses()
        for index in range(FUSION_FRAMES):
            pipeline.process_frame_local(
                {"image": sources[index % len(sources)]}, stream_id=mode,
                queue_response=responses)
        runtime.run(until=lambda: responses.qsize() >= FUSION_FRAMES
                    or responses.failures, timeout=600.0)
        torch.cuda.synchronize()
        counts = read_launches(counters)
        if responses.failures or responses.qsize() < FUSION_FRAMES:
            raise AssertionError(f"fusion-{mode}: {responses.qsize()} of "
                                 f"{FUSION_FRAMES} frames, failures "
                                 f"{responses.failures}")
        frames = {}
        while not responses.empty():
            _, frame_id, swag, metrics, okay, diagnostic = responses.get()
            image = swag["image"]
            with sync_allowed():
                image = image.cpu().numpy() if isinstance(
                    image, torch.Tensor) else np.asarray(image)
            frames[int(frame_id)] = {
                "image": image, "detections": swag["detections"],
                "overlay": swag["overlay"], "metrics": metrics}
        arrivals = sorted(responses.arrivals.values())
        out = {"frames": frames, "launches": counts,
               "fps": (FUSION_FRAMES - 1) / (arrivals[-1] - arrivals[0]),
               "transfer": pipeline.transfer_stats(),
               "fusion": pipeline.fusion_stats(),
               "segments": [segment.stats for segment
                            in pipeline.fused_segments],
               "capture_s": [segment.jit_cache.capture_s for segment
                             in pipeline.fused_segments],
               "peak_mb": (torch.cuda.max_memory_allocated() - held)
               / 2**20}
        if pipeline.fused_segments:
            segment = pipeline.fused_segments[0]
            out["segment_device_ms"] = device_ms(
                lambda: segment.call({"image": sources[0]}, set()))
        pipeline.stop()
        return out


def resize_burst_run() -> dict:
    """FUSION_BURST frames parked at one ``ImageResize`` on its default
    async path, from two streams at once: fewer micro-batch dispatches
    than frames, and every row equal to the synchronous path's resize of
    the same frame."""
    import numpy as np
    import torch

    definition = {
        "version": 0, "name": "resize-burst", "runtime": "torch",
        "graph": ["(R1)"], "parameters": {},
        "elements": [{
            "name": "R1", "input": [{"name": "image"}],
            "output": [{"name": "image"}],
            "parameters": {"width": FUSION_SIZES[0][1],
                           "height": FUSION_SIZES[0][1]},
            "deploy": {"local": {
                "module": "aiko_services_tpu_torch.elements.image",
                "class_name": "ImageResize"}}}]}
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (FUSION_SOURCE_SIZE,
                                    FUSION_SOURCE_SIZE, 3), dtype=np.uint8)
              for _ in range(FUSION_BURST)]
    with loopback_runtime() as runtime:
        pipeline = load_pipeline(definition, runtime)
        streams = {f"s{index}": Responses() for index in range(2)}
        for index, image in enumerate(images):
            stream_id = f"s{index % 2}"
            pipeline.process_frame_local(
                {"image": image, "index": index}, stream_id=stream_id,
                queue_response=streams[stream_id])
        runtime.run(until=lambda: sum(q.qsize() for q in streams.values())
                    >= FUSION_BURST, timeout=300.0)
        element = pipeline.graph.get_node("R1").element
        failures = [f for q in streams.values() for f in q.failures]
        if failures or sum(q.qsize() for q in streams.values()) \
                < FUSION_BURST:
            raise AssertionError(f"resize burst: {failures}")
        dispatches = element._batcher.dispatches
        equal = 0
        for responses in streams.values():
            while not responses.empty():
                *_, swag, _, _, _ = responses.get()
                _, sync_out = element.process_frame(
                    None, image=images[swag["index"]])
                equal += bool(torch.equal(swag["image"], sync_out["image"]))
        pipeline.stop()
    out = {"frames": FUSION_BURST, "dispatches": dispatches,
           "rows_equal_sync": equal}
    if dispatches >= FUSION_BURST or equal != FUSION_BURST:
        raise AssertionError(f"resize burst: {out}")
    return out


def fusion_run(card: str) -> dict:
    """Phase 9 (module docstring): the chain under ``fuse: auto``, then
    ``fuse: off``, on the same frames, then the async resize burst.  The
    launch counters are zeroed before each mode; no kernel of the port
    may launch on this path."""
    import numpy as np

    rng = np.random.default_rng(0)
    sources = [rng.integers(0, 256, (FUSION_SOURCE_SIZE, FUSION_SOURCE_SIZE,
                                     3), dtype=np.uint8)
               for _ in range(FUSION_SOURCES)]
    auto = fusion_mode_run("auto", sources)
    off = fusion_mode_run("off", sources)
    label = "fusion-chain"
    fusion, segments = auto["fusion"], auto["segments"]
    if fusion["segments"] != 1 or fusion["broken"] != 0:
        raise AssertionError(f"{label}: fusion stats {fusion}")
    jit = segments[0]["jit"]
    if (jit["misses"], jit["hits"]) != (1, FUSION_FRAMES - 1):
        raise AssertionError(f"{label}: segment cache {jit}")
    for mode, run, want in (("auto", auto, 1), ("off", off, 3)):
        for frame_id, frame in run["frames"].items():
            metrics = frame["metrics"]
            if metrics.get("device_dispatches") != want or (
                    mode == "auto"
                    and metrics.get("fused_segments") != 1):
                raise AssertionError(
                    f"{label}: {mode} frame {frame_id}: "
                    f"{metrics.get('device_dispatches')} dispatches, "
                    f"{metrics.get('fused_segments')} segments")
        for name, count in run["launches"].items():
            if count:
                raise AssertionError(f"{label}: {mode} launched {name} "
                                     f"{count} times; the path has no "
                                     f"kernel of the port")
    transfer = auto["transfer"]
    if transfer["explicit"] != FUSION_FRAMES or transfer["implicit"]:
        raise AssertionError(f"{label}: transfers {transfer}")
    if sorted(auto["frames"]) != sorted(off["frames"]):
        raise AssertionError(f"{label}: frame ids differ between modes")
    detections = 0
    for frame_id, frame in auto["frames"].items():
        other = off["frames"][frame_id]
        if not np.array_equal(frame["image"], other["image"]):
            raise AssertionError(f"{label}: frame {frame_id}: the fused "
                                 f"image differs from fuse: off")
        if frame["detections"] != other["detections"] \
                or frame["overlay"] != other["overlay"]:
            raise AssertionError(f"{label}: frame {frame_id}: detections "
                                 f"differ between the modes")
        size = FUSION_SIZES[-1][1]
        if frame["image"].shape != (size, size, 3):
            raise AssertionError(f"{label}: image {frame['image'].shape}")
        detections += len(frame["detections"])
    burst = resize_burst_run()
    out = {"pipeline_e2e_fused_fps": auto["fps"],
           "pipeline_e2e_fuse_off_fps": off["fps"],
           "pipeline_e2e_dispatch_overhead_ms":
               (1.0 / off["fps"] - 1.0 / auto["fps"]) * 1e3,
           "fused_segments": fusion["segments"],
           "fused_dispatches_per_frame": 1,
           "fuse_off_dispatches_per_frame": 3,
           "jit_cache_hits": jit["hits"], "jit_cache_misses": jit["misses"],
           "segment_capture_s": auto["capture_s"][0],
           "segment_device_ms": auto["segment_device_ms"],
           "device_busy_share_fused":
               auto["segment_device_ms"] * auto["fps"] / 1e3,
           "dispatch_p50_ms": segments[0]["dispatch_p50_ms"],
           "dispatch_p99_ms": segments[0]["dispatch_p99_ms"],
           "transfers_explicit": transfer["explicit"],
           "transfers_implicit": transfer["implicit"],
           "detections": detections,
           "peak_mb_fused": auto["peak_mb"], "peak_mb_off": off["peak_mb"],
           "resize_burst": burst, "card": card}
    print(f"fusion {json.dumps(out)}", flush=True)
    return {"launches": auto["launches"], "fusion": out}


# -- phase 10: checkpoints, HF conversion, the profiler and the CLI -------

#: Phase 10 serves config 5's LLM (``CONFIG5_LLM``: Llama-3.2-1B widths,
#: int8 weights, dense attention at max_seq 512) from a checkpoint that
#: ``python3 -m aiko_services_tpu_torch convert llama`` made of a Hugging
#: Face snapshot written here from seed 0.
CHECKPOINT_PROMPTS = ("Describe the scene in one sentence. ",
                      "Three cars wait at a red light. ",
                      "A dog runs across the empty street. ",
                      "Count the people near the bus stop. ")
PROFILE_FRAMES = 3
#: the published ``config.json`` of Llama-3.2-1B, but for the tied
#: embeddings: the snapshot carries ``lm_head.weight``, so the round trip
#: is exact.  ``rope_scaling`` is read by neither package's conversion.
HF_CONFIG = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
             "torch_dtype": "bfloat16", "rms_norm_eps": 1e-05,
             "max_position_embeddings": 131072, "bos_token_id": 128000,
             "eos_token_id": 128001, "tie_word_embeddings": False,
             "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0,
                              "low_freq_factor": 1.0,
                              "original_max_position_embeddings": 8192,
                              "rope_type": "llama3"}}
INT8_KERNEL_NAMES = ("int8_gemv_kernel", "int8_matmul_kernel",
                     "int8_combine_kernel")


def checkpoint_config():
    """The config the ``LLM`` element builds for ``CONFIG5_LLM``."""
    from aiko_services_tpu_torch.models import llama
    return dataclasses.replace(llama.LlamaConfig.llama3_1b(),
                               max_seq=CONFIG5_LLM["max_seq"])


def write_hf_snapshot(directory: Path, params: dict, config) -> dict:
    """``params`` (the port's layer-stacked tree) as a Hugging Face
    snapshot: ``config.json`` and two bf16 shards written by the port's
    writer, each projection transposed back to ``[out, in]`` one layer at
    a time."""
    from aiko_services_tpu_torch.models._safetensors import write_file
    hf = dict(HF_CONFIG, vocab_size=config.vocab_size,
              hidden_size=config.dim, intermediate_size=config.hidden_dim,
              num_hidden_layers=config.n_layers,
              num_attention_heads=config.n_heads,
              num_key_value_heads=config.n_kv_heads,
              rope_theta=config.rope_theta)
    (directory / "config.json").write_text(json.dumps(hf, indent=2))
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    half = config.n_layers // 2
    shards = ({"model.embed_tokens.weight": params["embed"].cpu()}, {})
    layers = params["layers"]
    for index in range(config.n_layers):
        shard = shards[index >= half]
        prefix = f"model.layers.{index}"
        for leaf, name in names.items():
            shard[f"{prefix}.{name}.weight"] = \
                layers[leaf][index].T.contiguous().cpu()
        shard[f"{prefix}.input_layernorm.weight"] = \
            layers["attn_norm"][index].cpu()
        shard[f"{prefix}.post_attention_layernorm.weight"] = \
            layers["mlp_norm"][index].cpu()
    shards[1]["model.norm.weight"] = params["final_norm"].cpu()
    shards[1]["lm_head.weight"] = params["unembed"].T.contiguous().cpu()
    sizes = {}
    for number, shard in enumerate(shards, 1):
        path = directory / f"model-0000{number}-of-00002.safetensors"
        write_file(path, shard, metadata={"format": "pt"})
        sizes[path.name] = path.stat().st_size
    return sizes


def convert_cli(source: Path, destination: Path) -> tuple[dict, float]:
    """``python3 -m aiko_services_tpu_torch convert llama SRC DST
    --max-seq N`` as a user runs it; (its JSON report, seconds)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    begin = time.perf_counter()
    result = subprocess.run(
        [sys.executable, "-m", "aiko_services_tpu_torch", "convert",
         "llama", str(source), str(destination), "--max-seq",
         str(CONFIG5_LLM["max_seq"])], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - begin
    if result.returncode != 0:
        raise AssertionError(f"convert llama exited {result.returncode}: "
                             f"{result.stderr[-2000:]}")
    return json.loads(result.stdout.strip().splitlines()[-1]), seconds


def _checkpoint_definition(name: str, llm: dict) -> dict:
    return {"version": 0, "name": name, "runtime": "torch",
            "graph": ["(LLM)"],
            "parameters": {"transfer_guard": "disallow"},
            "elements": [{
                "name": "LLM", "input": [{"name": "text"}],
                "output": [{"name": "text"}], "parameters": llm,
                "deploy": {"local": {
                    "module": "aiko_services_tpu_torch.elements.llm",
                    "class_name": "LLM"}}}]}


@contextlib.contextmanager
def build_peak():
    """The card's peak allocation above what it held when the ``LLM``
    element's model build began, over that build (GiB, in ``peak``)."""
    import torch
    from aiko_services_tpu_torch.elements import llm as port_llm
    ensure_model = port_llm.LLM._ensure_model
    peak = {}

    def build(self, settings=None):
        if self._batcher is not None or peak:
            return ensure_model(self, settings)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ensure_model(self, settings)
        torch.cuda.synchronize()
        peak.update(gib=(torch.cuda.max_memory_allocated() - held) / 2**30,
                    held_gib=held / 2**30)
    port_llm.LLM._ensure_model = build
    try:
        yield peak
    finally:
        port_llm.LLM._ensure_model = ensure_model


def serve_prompts(label: str, llm: dict, runtime, keep: bool = False):
    """CHECKPOINT_PROMPTS through one ``(LLM)`` pipeline: the replies'
    texts and token ids (in prompt order), the launches, the build peak
    and the build seconds; the pipeline is returned open when
    ``keep``."""
    import torch
    from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer
    with recording_llm() as record, build_peak() as peak:
        pipeline = load_pipeline(_checkpoint_definition(label, llm),
                                 runtime)
        counters = zero_launches()
        responses = Responses()
        for prompt in CHECKPOINT_PROMPTS:
            pipeline.process_frame_local({"text": prompt}, stream_id=label,
                                         queue_response=responses)
        runtime.run(until=lambda: responses.qsize()
                    >= len(CHECKPOINT_PROMPTS) or responses.failures,
                    timeout=600.0)
        counts = read_launches(counters)
        torch.cuda.synchronize()
        if responses.failures or responses.qsize() < len(CHECKPOINT_PROMPTS):
            raise AssertionError(f"{label}: {responses.qsize()} replies, "
                                 f"failed: {responses.failures}")
        texts = {}
        while not responses.empty():
            _, frame_id, swag, _, okay, _ = responses.get()
            texts[int(frame_id)] = swag["text"]
        ledger = pipeline.transfer_ledger.stats
        if ledger["implicit"]:
            raise AssertionError(f"{label}: implicit transfers {ledger}")
        element = pipeline.graph.get_node("LLM").element
        by_prompt = {tuple(record["prompts"][rid]): ids
                     for rid, ids in record["tokens"].items()}
        tokenizer = ByteTokenizer()
        out = {"texts": [texts[index] for index in sorted(texts)],
               "tokens": [by_prompt[tuple(tokenizer.encode(prompt))]
                          for prompt in CHECKPOINT_PROMPTS],
               "launches": counts, "peak": dict(peak),
               "build_s": record["timers"]["build_s"], "ledger": ledger}
    if keep:
        return out, pipeline, element
    pipeline.stop()
    element.close()
    return out


def kernels_in_spans(trace_path: str, span: str) -> dict:
    """From a Chrome trace: the ``span`` user spans, and the #5 kernel
    events (``INT8_KERNEL_NAMES``) that start and end inside each."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [(event["ts"], event["ts"] + event["dur"]) for event in events
             if event.get("cat") == "user_annotation"
             and event.get("name") == span]
    kernels = [(event["ts"], event["ts"] + event.get("dur", 0),
                event["name"]) for event in events
               if event.get("cat") == "kernel"]
    int8 = [kernel for kernel in kernels
            if any(name in kernel[2] for name in INT8_KERNEL_NAMES)]
    inside = [sum(begin <= start and stop <= end
                  for start, stop, _ in int8) for begin, end in spans]
    return {"spans": len(spans), "kernel_events": len(kernels),
            "int8_kernel_events": len(int8),
            "int8_kernels_inside_each_span": inside}


def detector_checkpoint_run(workdir: Path, runtime) -> dict:
    """The Detector at phase 9's scale from a checkpoint of its own
    ``init_params(0)`` against one built from ``init_params(0)``: the
    detections of 4 frames (numpy seed 0) must be bitwise equal."""
    import numpy as np
    from aiko_services_tpu_torch.device import resolve_device
    from aiko_services_tpu_torch.models import detector
    from aiko_services_tpu_torch.models.checkpoint import save_pytree
    names = FUSION_DETECTOR["class_names"]
    config = detector.DetectorConfig(
        num_classes=len(names), width=FUSION_DETECTOR["width"],
        score_threshold=0.25, max_detections=32)
    save_pytree(workdir / "detector", {"params": detector.init_params(
        0, config, resolve_device(None))})
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (CONFIG4_SIZE, CONFIG4_SIZE, 3),
                           dtype=np.uint8) for _ in range(4)]
    found = {}
    for label, parameters in (
            ("seed", dict(FUSION_DETECTOR)),
            ("checkpoint", dict(FUSION_DETECTOR, seed=7,
                                checkpoint=str(workdir / "detector")))):
        definition = {
            "version": 0, "name": f"detector-{label}", "runtime": "torch",
            "graph": ["(DET)"], "parameters": {},
            "elements": [{
                "name": "DET", "input": [{"name": "image"}],
                "output": [{"name": "detections"}],
                "parameters": parameters,
                "deploy": {"local": {
                    "module": "aiko_services_tpu_torch.elements.detect",
                    "class_name": "Detector"}}}]}
        pipeline = load_pipeline(definition, runtime)
        responses = Responses()
        for image in images:
            pipeline.process_frame_local({"image": image}, stream_id=label,
                                         queue_response=responses)
        runtime.run(until=lambda: responses.qsize() >= len(images)
                    or responses.failures, timeout=300.0)
        if responses.failures or responses.qsize() < len(images):
            raise AssertionError(f"detector-{label}: {responses.failures}")
        found[label] = {}
        while not responses.empty():
            _, frame_id, swag, _, _, _ = responses.get()
            found[label][int(frame_id)] = swag["detections"]
        pipeline.stop()
    detections = sum(len(frame) for frame in found["seed"].values())
    equal = found["seed"] == found["checkpoint"]
    out = {"frames": len(images), "detections": detections,
           "checkpoint_equals_init": equal}
    if not equal or not detections:
        raise AssertionError(f"detector checkpoint: {out}")
    return out


def checkpoint_run(card: str) -> dict:
    """Phase 10 (module docstring).  The launch counters are zeroed just
    before the checkpoint pipeline's first frame and read after its last
    reply."""
    import shutil
    import tempfile
    import torch
    from aiko_services_tpu_torch.device import resolve_device
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.checkpoint import (flatten,
                                                           restore_pytree)
    from aiko_services_tpu_torch.tpu import Profiler

    label = "checkpoint-cli"
    device = resolve_device(None)
    config = checkpoint_config()
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    out = {"card": card}
    try:
        source, converted = workdir / "hf", workdir / "converted"
        source.mkdir()
        begin = time.perf_counter()
        params = llama.init_params(0, config, device)
        sizes = write_hf_snapshot(source, params, config)
        out["snapshot_s"] = time.perf_counter() - begin
        out["snapshot_gb"] = sum(sizes.values()) / 1e9
        out["snapshot_params_b"] = sum(
            leaf.numel() for leaf in _leaves(params)) / 1e9
        report, out["convert_s"] = convert_cli(source, converted)
        inferred = llama.LlamaConfig(**report["config"])
        out["converted_config_equal"] = inferred == config
        print(f"{label}: snapshot {out['snapshot_gb']:.3f} GB "
              f"({out['snapshot_params_b']:.3f} B params) in "
              f"{out['snapshot_s']:.1f} s; convert llama exit 0 in "
              f"{out['convert_s']:.1f} s, config "
              f"{'equal to' if inferred == config else 'DIFFERS from'} "
              f"llama3_1b at max_seq {config.max_seq}", flush=True)
        if inferred != config:
            raise AssertionError(f"{label}: converted config {inferred}")
        torch.cuda.synchronize()
        begin = time.perf_counter()
        restored = restore_pytree(
            converted, template={"params": llama.abstract_params(config)},
            device=device)["params"]
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - begin
        theirs = flatten(params)
        unequal = [name for name, ours in flatten(restored).items()
                   if not torch.equal(ours, theirs.pop(name))] + list(theirs)
        out["restored_leaves_equal"] = not unequal
        if unequal:
            raise AssertionError(f"{label}: restored leaves differ: "
                                 f"{unequal}")
        del params, restored
        torch.cuda.empty_cache()

        with loopback_runtime() as runtime:
            ckpt = serve_prompts(label, dict(CONFIG5_LLM,
                                             checkpoint=str(converted)),
                                 runtime)
            torch.cuda.empty_cache()
            seeded, pipeline, element = serve_prompts(
                "seed-0", dict(CONFIG5_LLM, seed=0), runtime, keep=True)
            out.update({
                "replies": len(ckpt["tokens"]),
                "replies_equal_to_seed_0": ckpt["tokens"]
                == seeded["tokens"] and ckpt["texts"] == seeded["texts"],
                "tokens": sum(map(len, ckpt["tokens"])),
                "build_s_checkpoint": ckpt["build_s"],
                "build_s_seed_0": seeded["build_s"],
                "build_peak_gib_checkpoint": ckpt["peak"]["gib"],
                "build_peak_gib_seed_0": seeded["peak"]["gib"]})
            print(f"{label}: {json.dumps(out)} launches "
                  f"{json.dumps(ckpt['launches'])}", flush=True)
            check_launches(label, ckpt["launches"], CONFIG5_KERNELS)
            if not out["replies_equal_to_seed_0"]:
                raise AssertionError(f"{label}: replies differ from the "
                                     f"seed-0 pipeline's")
            if ckpt["peak"]["gib"] > 1.1 * seeded["peak"]["gib"]:
                raise AssertionError(f"{label}: build peak "
                                     f"{ckpt['peak']} above 1.1 x "
                                     f"{seeded['peak']}")

            # The same pipeline under the profiler, one frame at a time.
            profiler = Profiler()
            profiler.start(str(workdir / "trace"))
            profiler.attach(pipeline)
            responses = Responses()
            for index in range(PROFILE_FRAMES):
                pipeline.process_frame_local(
                    {"text": CHECKPOINT_PROMPTS[index]}, stream_id="traced",
                    queue_response=responses)
                runtime.run(until=lambda: responses.qsize() > index
                            or responses.failures, timeout=300.0)
            profiler.detach()
            trace = profiler.stop()
            if responses.failures or responses.qsize() < PROFILE_FRAMES:
                raise AssertionError(f"{label}: profiled frames failed: "
                                     f"{responses.failures}")
            spans = kernels_in_spans(trace, "element:LLM")
            spans["trace_mb"] = Path(trace).stat().st_size / 1e6
            out["profile"] = spans
            print(f"{label}: profile {json.dumps(spans)}", flush=True)
            if spans["spans"] != PROFILE_FRAMES or not all(
                    spans["int8_kernels_inside_each_span"]):
                raise AssertionError(f"{label}: the trace holds {spans}")
            pipeline.stop()
            element.close()
            del element
            torch.cuda.empty_cache()
            out["detector"] = detector_checkpoint_run(workdir, runtime)
        print(f"checkpoint {json.dumps(out)}", flush=True)
        return {"launches": ckpt["launches"], "checkpoint": out}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# -- phase 11: training and the mixture-of-experts ---------------------------

TRAIN_BATCH = (4, 512)      # 11a: Llama-3.2-1B, 4 x 512 tokens
TRAIN_STEPS = 5
MOE_TRAIN_BATCH = (2, 512)  # 11c: the 4-expert MoE, remat
MOE_TRAIN_STEPS = 3
MOE_EXPERTS = 4
ASR_FIT_STEPS = 5           # 11d: config 5's ASR on the tone corpus
TTS_FIT_STEPS = 3
#: test_asr_fit.py's corpus: four "words", each a pure tone (Hz).
TONES = {"a": 400.0, "b": 800.0, "c": 1600.0, "d": 3000.0}
#: 11b's ``(LLM)`` at tiny-moe widths (head_dim 16: no attention kernel
#: takes it, so dense attention; greedy rows still go through top-k).
MOE_PIPELINE_LLM = {"model": "tiny-moe", "attention": "dense",
                    "decode_kernel": "reference", "decode_block_tokens": 16}


def train_config(**overrides):
    """Llama-3.2-1B at its published widths (dim 2048, 16 layers, 32/8
    heads, FFN 8192, vocab 128,256), max_seq 512, bf16."""
    from aiko_services_tpu_torch.models import llama
    return dataclasses.replace(llama.LlamaConfig.llama3_1b(),
                               **{"max_seq": 512, **overrides})


def moe_config(**overrides):
    """``tiny_moe``'s routing (top-2, capacity factor 2.0) at Llama-3.2-1B
    widths with MOE_EXPERTS experts, flash prefill and decode, bf16."""
    from aiko_services_tpu_torch.models import llama
    settings = dict(n_experts=MOE_EXPERTS, max_seq=2048, attention="flash",
                    decode_attention="flash")
    return dataclasses.replace(llama.LlamaConfig.llama3_1b(),
                               **{**settings, **overrides})


def token_batch(config, shape, device, seed: int = 0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, config.vocab_size, shape)) \
        .to(device)


def free_card() -> float:
    """Collect, empty the cache, reset the peak; GiB the card still
    holds."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 30


def serving_cross_entropy(params, config, tokens) -> float:
    """The next-token cross-entropy of the SERVING path's logits on
    ``tokens``: ``llama.prefill_into_slot`` (the batcher's admission
    forward, which writes its cache in place), one row a call.  The
    yardstick of the differentiable forward's first loss."""
    import torch
    import torch.nn.functional as F
    from aiko_services_tpu_torch.models import llama
    b, s = tokens.shape
    with torch.no_grad():
        cache = llama.init_cache(config, b, s, device=tokens.device)
        logits = torch.cat([
            llama.prefill_into_slot(params, config, tokens[row:row + 1],
                                    cache, row, 0)[0] for row in range(b)])
        loss = F.cross_entropy(
            logits[:, :-1].float().reshape(-1, logits.shape[-1]),
            tokens[:, 1:].reshape(-1))
    return float(loss)


def train_steps(label: str, config, tokens, steps: int, card: str, *,
                accumulate: int = 1, reference: bool = False) -> dict:
    """``init_train_state(0)`` on the card, then ``steps`` AdamW steps of
    ``make_train_step`` on one batch.  Step times are CUDA events around
    each step, steps 2 on (the first allocates the moments); the peak is
    ``max_memory_allocated`` over the steps above what the card held
    before the init.  ``reference`` adds the serving path's cross-entropy
    on the initial weights."""
    import torch
    from aiko_services_tpu_torch.models import llama, train
    from aiko_services_tpu_torch.parallel.mesh import MeshPlan
    held = free_card()
    plan = MeshPlan.build({"dp": 1}, devices=[tokens.device])
    params, opt_state, optimizer = train.init_train_state(0, config, plan)
    out = {"run": label, "steps": steps, "accumulate_steps": accumulate,
           "remat": config.remat, "batch": list(tokens.shape),
           "params_b": sum(leaf.numel() for leaf in _leaves(params)) / 1e9,
           "card": card}
    if reference:
        out["serving_cross_entropy"] = serving_cross_entropy(params, config,
                                                             tokens)
    if config.n_experts:
        with torch.no_grad():
            _, _, aux = llama.prefill_with_aux(
                params, config, tokens,
                llama.init_cache(config, *tokens.shape, device=tokens.device),
                torch.zeros(tokens.shape[0], dtype=torch.int32,
                            device=tokens.device))
        out["aux_at_init"] = float(aux)
        out["aux_at_init_per_layer"] = float(aux) / config.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = train.make_train_step(config, plan, optimizer=optimizer,
                                 accumulate_steps=accumulate)
    losses, events = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, loss = step(params, opt_state, tokens)
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    out["losses"] = [float(loss) for loss in losses]
    times = [start.elapsed_time(end) for start, end in events]
    out["step_ms"] = times
    timed = times[1:] or times
    out["step_ms_mean"] = sum(timed) / len(timed)
    out["tokens_per_s"] = tokens.numel() / (out["step_ms_mean"] / 1e3)
    out["peak_gib_above_held"] = torch.cuda.max_memory_allocated() / 2 ** 30 \
        - held
    if not config.n_experts:
        # 6 N operations a token, N the matmul parameters (the embedding
        # is a gather): the model-flops share of the bf16 peak.
        matmul_params = out["params_b"] * 1e9 - params["embed"].numel()
        out["model_flops_share_of_989_tf"] = (
            6 * matmul_params * tokens.numel()
            / (out["step_ms_mean"] / 1e3) / PEAK_FLOPS["bf16"])
    del params, opt_state, step, losses
    free_card()
    print(f"train {json.dumps(out)}", flush=True)
    if not all(math.isfinite(loss) for loss in out["losses"]):
        raise AssertionError(f"{label}: a loss is not finite: "
                             f"{out['losses']}")
    return out


def dense_training(device, card: str) -> dict:
    """11a (module docstring)."""
    config = train_config()
    tokens = token_batch(config, TRAIN_BATCH, device)
    plain = train_steps("train-1b", config, tokens, TRAIN_STEPS, card,
                        reference=True)
    remat = train_steps("train-1b-remat", train_config(remat=True), tokens,
                        2, card)
    accumulated = train_steps("train-1b-accumulate-2", config, tokens, 2,
                              card, accumulate=2)
    first = plain["losses"][0]
    gaps = {"serving": abs(first - plain["serving_cross_entropy"]) / first,
            "remat": abs(remat["losses"][0] - first),
            "accumulate": abs(accumulated["losses"][0] - first)}
    print(f"train-1b: first loss {first:.6f}, serving path's cross-entropy "
          f"{plain['serving_cross_entropy']:.6f} (rel gap "
          f"{gaps['serving']:.3e}, tol 2e-2); remat first loss gap "
          f"{gaps['remat']:.3e} (tol 1e-2), accumulate-2 {gaps['accumulate']:.3e}"
          f" (tol 5e-2); peaks above held: plain "
          f"{plain['peak_gib_above_held']:.3f} GiB, remat "
          f"{remat['peak_gib_above_held']:.3f}, accumulate-2 "
          f"{accumulated['peak_gib_above_held']:.3f}", flush=True)
    if not plain["losses"][-1] < first:
        raise AssertionError(f"train-1b: the loss did not fall: "
                             f"{plain['losses']}")
    if not (gaps["serving"] <= 2e-2 and gaps["remat"] <= 1e-2
            and gaps["accumulate"] <= 5e-2):
        raise AssertionError(f"train-1b: first losses disagree: {gaps}")
    if not remat["peak_gib_above_held"] < plain["peak_gib_above_held"]:
        raise AssertionError("train-1b: the remat peak is not below the "
                             "plain peak")
    return {"plain": plain, "remat": remat, "accumulate": accumulated,
            "gaps": gaps}


def moe_decode_ms(params, config, device, steps: int = 10) -> float:
    """Mean device-timeline ms of one eager ``decode_step`` of 8 rows at
    1,000 cached positions (CUDA events around ``steps`` steps)."""
    import torch
    from aiko_services_tpu_torch.models import llama
    cache = llama.init_cache(config, 8, device=device)
    tokens = torch.arange(8, device=device) * 7 + 3
    lengths = torch.full((8,), 1000, dtype=torch.int32, device=device)
    llama.decode_step(params, config, tokens, cache, lengths)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        logits, cache = llama.decode_step(params, config, tokens, cache,
                                          lengths)
    end.record()
    torch.cuda.synchronize()
    del cache
    return start.elapsed_time(end) / steps


def moe_serving(device, card: str) -> tuple[dict, dict]:
    """11b (module docstring) -> (results, launches of its runs)."""
    import torch
    from aiko_services_tpu_torch.models import llama
    config = moe_config()
    free_card()
    begin = time.perf_counter()
    params = llama.init_params(0, config, device=device)
    torch.cuda.synchronize()
    n_params = sum(leaf.numel() for leaf in _leaves(params))
    print(f"moe: {MOE_EXPERTS} experts at Llama-3.2-1B widths, random init "
          f"{time.perf_counter() - begin:.2f} s, {n_params / 1e9:.3f} B "
          f"params, capacity {config.moe_capacity(8)} of 8 decode rows, "
          f"{config.moe_capacity(512)} of a 512-token chunk", flush=True)
    mixed = mixed_requests(config)
    paged = dict(kv_page_tokens=64)
    plan = [("moe-dense-4", mixed, dict(decode_block=4)),
            ("moe-loop-16", mixed, dict(decode_block_tokens=16),
             {"flash_decode_attention_stacked"}),
            ("moe-paged-1", mixed, dict(decode_block=1, **paged)),
            ("moe-loop-ngram-paged-16", mixed,
             dict(speculative="ngram", spec_tokens=4, decode_block_tokens=16,
                  **paged), {"flash_verify_attention_paged"})]
    runs, launches = {}, {}
    run_plan(plan, params, config, device, card, runs, launches)
    greedy = [f"r{index}" for index in range(0, len(mixed), 2)]
    for other in ("moe-loop-16", "moe-paged-1"):
        agree = sum(runs["moe-dense-4"]["streams"][rid]
                    == runs[other]["streams"][rid] for rid in greedy)
        print(f"moe: greedy streams equal, moe-dense-4 and {other}: "
              f"{agree}/{len(greedy)}", flush=True)
        if agree != len(greedy):
            raise AssertionError(f"moe: {other} emitted other greedy tokens "
                                 f"than moe-dense-4")
    for label in ("moe-paged-1", "moe-loop-ngram-paged-16"):
        if runs[label]["leaked"]:
            raise AssertionError(f"{label}: leaked pages")
    if runs["moe-loop-ngram-paged-16"]["metrics"]["draft_tokens"] <= 0:
        raise AssertionError("moe-loop-ngram-paged-16: no draft tokens")
    agreement = check_dense_agreement(params, config, device)
    decode_ms = moe_decode_ms(params, config, device)
    print(f"moe: decode_step of 8 rows at 1,000 positions {decode_ms:.3f} ms "
          f"(CUDA events, eager) on {card}", flush=True)
    del params
    free_card()
    pipeline = pipeline_run("moe-pipeline-loop-16", MOE_PIPELINE_LLM,
                            {"transfer_guard": "disallow"}, None, card,
                            kernels={"topk"})
    return ({"runs": {label: run["metrics"] for label, run in runs.items()},
             "params_b": n_params / 1e9, "agreement": agreement,
             "decode_step_ms": decode_ms,
             "pipeline": pipeline["metrics"]},
            {"moe-serving": launches,
             "moe-pipeline-loop-16": pipeline["launches"]})


def moe_training(device, card: str) -> dict:
    """11c (module docstring)."""
    config = moe_config(max_seq=512, remat=True)
    tokens = token_batch(config, MOE_TRAIN_BATCH, device)
    out = train_steps("train-moe-remat", config, tokens, MOE_TRAIN_STEPS,
                      card)
    if not out["losses"][-1] < out["losses"][0]:
        raise AssertionError(f"train-moe-remat: the loss did not fall: "
                             f"{out['losses']}")
    return out


def tone_chunk(config, freq: float, rng):
    """One chunk of a tone with random phase and noise (test_asr_fit.py's
    corpus)."""
    import numpy as np
    t = np.arange(int(config.sample_rate * config.chunk_seconds),
                  dtype=np.float32) / config.sample_rate
    wave = 0.5 * np.sin(2 * np.pi * freq * t + rng.uniform(0, 2 * np.pi))
    return (wave + rng.normal(0, 0.01, wave.shape)).astype(np.float32)


def fit_steps(label: str, loss_fn, params: dict, batches, card: str) -> dict:
    """``torch.optim.Adam(3e-3)`` steps of ``loss_fn(params, batch)``, one
    a batch; CUDA-event step times, steps 2 on."""
    import torch
    leaves = list(_leaves(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    optimizer = torch.optim.Adam(leaves, lr=3e-3)
    losses, events = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = loss_fn(params, batch)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        end.record()
        losses.append(loss.detach())
        events.append((start, end))
    torch.cuda.synchronize()
    times = [start.elapsed_time(end) for start, end in events]
    out = {"run": label, "losses": [float(loss) for loss in losses],
           "step_ms": times, "step_ms_mean": sum(times[1:]) / (len(times) - 1),
           "card": card}
    print(f"fit {json.dumps(out)}", flush=True)
    if not all(math.isfinite(loss) for loss in out["losses"]) \
            or not out["losses"][-1] < out["losses"][0]:
        raise AssertionError(f"{label}: losses {out['losses']}")
    return out


def speech_fits(device, card: str) -> dict:
    """11d (module docstring)."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.models import asr, tts
    free_card()
    config = asr.AsrConfig.base()
    params = asr.init_params(0, config, device=device)
    rng = np.random.default_rng(7)
    letters = list(TONES)
    targets = np.full((len(letters), config.max_text), 259, dtype=np.int32)
    for row, letter in enumerate(letters):
        ids = asr.encode_text(config, letter) + [config.eos_token]
        targets[row, :len(ids)] = ids
    targets = torch.from_numpy(targets).to(device)
    batches = [torch.from_numpy(np.stack(
        [tone_chunk(config, TONES[letter], rng) for letter in letters]))
        .to(device) for _ in range(ASR_FIT_STEPS)]
    asr_fit = fit_steps("asr-base-tones", lambda p, audio: asr.asr_loss(
        p, config, audio, targets), params, batches, card)
    del params, batches
    free_card()
    tts_config = tts.TtsConfig()
    params = tts.init_params(0, tts_config, device=device)
    texts = ["aa", "bb", "cc", "dd"]
    tokens = torch.from_numpy(np.stack(
        [tts.encode_text(tts_config, text) for text in texts])).to(device)
    frames, mels = tts_config.n_frames, tts_config.n_mels
    grid_f = np.arange(frames)[:, None] / frames
    grid_m = np.arange(mels)[None, :] / mels
    mel_targets = torch.from_numpy(np.stack(
        [np.sin(2 * np.pi * ((i + 1) * grid_f + i * grid_m))
         for i in range(len(texts))]).astype(np.float32)).to(device)
    tts_fit = fit_steps("tts-base", lambda p, _: tts.tts_loss(
        p, tts_config, tokens, mel_targets), params,
        [None] * TTS_FIT_STEPS, card)
    del params
    free_card()
    return {"asr": asr_fit, "tts": tts_fit}


def train_moe_run(card: str) -> dict:
    """Phase 11 (module docstring): 11a, 11c and 11d must launch no
    kernel of the port; 11b's runs launch their paths' kernels (each run
    checks its own).  Returns the phase's summed launches."""
    from aiko_services_tpu_torch.device import resolve_device
    device = resolve_device(None)
    held = free_card()
    print(f"train-moe: the card holds {held:.3f} GiB before the phase",
          flush=True)
    counters = zero_launches()
    dense = dense_training(device, card)
    counts = read_launches(counters)
    check_launches("train-1b", counts, set())
    serving, serving_launches = moe_serving(device, card)
    counters = zero_launches()
    moe = moe_training(device, card)
    fits = speech_fits(device, card)
    counts = read_launches(counters)
    check_launches("train-moe-remat and the speech fits", counts, set())
    total = {}
    for run_counts in serving_launches.values():
        for name, count in run_counts.items():
            total[name] = total.get(name, 0) + count
    out = {"dense": dense, "moe_serving": serving, "moe_training": moe,
           "speech_fits": fits, "launches_by_run": serving_launches}
    print(f"train-moe {json.dumps(out)}", flush=True)
    return {"launches": total, "train_moe": out}


# -- phase 12: context parallelism on a mesh --------------------------------

#: (label, mesh axes, attention, batch, sequence): Llama-3-8B forwards.
CP_FORWARDS = (("cp-ring-sp4", {"sp": 4}, "ring", 1, 8192),
               ("cp-ulysses-sp4", {"sp": 4}, "ulysses", 1, 8192),
               ("cp-ring-dp2-sp2-tp2", {"dp": 2, "sp": 2, "tp": 2}, "ring",
                2, 4096))
CP_TRAIN_BATCH = (1, 2048)  # 12b: Llama-3.2-1B, one backward over {"sp": 4}
CP_LOSS_TOL = 1e-2          # |CP loss - dense loss|, both float32 from bf16
# Relative L2 of the whole gradient, CP against dense, in bf16: every
# product rounds to bf16 (2^-8 relative) on both sides, in two attention
# schedules (a float32 online softmax against the dense one's bf16
# weights), through 16 layers' backward: about 3 % at 16 narrow layers
# on the CPU.  A ring that drops the rotated blocks' gradients reads 54 %
# there; 10 % keeps the two apart.
CP_GRAD_TOL = 0.10


def cp_mesh_plan(axes: dict, device):
    """A plan whose mesh lists ``device`` once a position."""
    from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh
    count = math.prod(axes.values())
    return MeshPlan(make_mesh(axes, [device] * count))


def relative_error(got, want) -> float:
    """max |got - want| / max |want| over [B, S, V] logits, a sequence
    chunk at a time (a whole float32 copy would be 4 GiB)."""
    top, worst = 0.0, 0.0
    for start in range(0, want.shape[1], 1024):
        a = got[:, start:start + 1024].float()
        b = want[:, start:start + 1024].float()
        top = max(top, b.abs().max().item())
        worst = max(worst, (a - b).abs().max().item())
    return worst / top


def timed(fn):
    """(fn's result, its CUDA-event ms, the peak GiB above what the card
    held before)."""
    import torch
    held = free_card()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 - held
    return result, start.elapsed_time(end), peak


def dense_logits(params, config, tokens):
    """``llama.prefill`` of ``tokens`` on a fresh cache at start 0."""
    import torch
    from aiko_services_tpu_torch.models import llama
    b, s = tokens.shape
    cache = llama.init_cache(config, b, s, device=tokens.device)
    return llama.prefill(params, config, tokens, cache,
                         torch.zeros(b, dtype=torch.int32,
                                     device=tokens.device))[0]


def cp_forwards(device, card: str) -> tuple[list, dict]:
    """12a: each of CP_FORWARDS on Llama-3-8B (seed 0) against the dense
    prefill of the same tokens; every launch counter zeroed before each
    sharded forward and read after it."""
    import torch
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.long_context import \
        make_long_context_forward
    config = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(0, config, device=device)
    runs, total, references = [], {}, {}
    with torch.no_grad():
        for label, axes, attention, batch, seq in CP_FORWARDS:
            tokens = token_batch(config, (batch, seq), device)
            if (batch, seq) not in references:
                counters = zero_launches()
                logits, ms, peak = timed(
                    lambda: dense_logits(params, config, tokens))
                references[(batch, seq)] = {
                    "logits": logits, "ms": ms, "peak_gib": peak,
                    "launches": {k: v for k, v in read_launches(
                        counters).items() if v}}
                print(f"context-parallel: dense prefill [{batch}, {seq}] "
                      f"{ms:.2f} ms, peak {peak:.3f} GiB above held, "
                      f"launches {references[(batch, seq)]['launches']} "
                      f"on {card}", flush=True)
            reference = references[(batch, seq)]
            forward = make_long_context_forward(
                config, cp_mesh_plan(axes, device), attention)
            counters = zero_launches()
            logits, first_ms, _ = timed(lambda: forward(params, tokens))
            counts = read_launches(counters)
            check_launches(label, counts, set())
            for name, count in counts.items():
                total[name] = total.get(name, 0) + count
            error = relative_error(logits, reference["logits"])
            finite = bool(torch.isfinite(logits).all())
            shape_ok = tuple(logits.shape) == (batch, seq, config.vocab_size)
            on_card = logits.device.type == device.type
            del logits
            _, ms, peak = timed(lambda: forward(params, tokens))
            run = {"run": label, "mesh": axes, "attention": attention,
                   "batch": batch, "seq": seq, "first_ms": first_ms,
                   "ms": ms, "peak_gib_above_held": peak,
                   "dense_ms": reference["ms"],
                   "dense_peak_gib_above_held": reference["peak_gib"],
                   "max_err_rel": error, "tol": LOGITS_TOL,
                   "launches": {k: v for k, v in counts.items() if v},
                   "card": card}
            runs.append(run)
            print(f"context-parallel {json.dumps(run)}", flush=True)
            if not (finite and shape_ok and on_card) \
                    or error > LOGITS_TOL:
                raise AssertionError(
                    f"{label}: logits finite {finite}, shape ok {shape_ok}, "
                    f"on the card {on_card}, error {error:.4f} of max "
                    f"|logit| (tol {LOGITS_TOL})")
    del params, references
    free_card()
    return runs, total


def cp_backward(device, card: str) -> tuple[dict, dict]:
    """12b: one backward of ``make_long_context_loss`` (ring, {"sp": 4})
    on Llama-3.2-1B (seed 0) against ``train.language_model_loss``'s on
    the same tokens: the losses within CP_LOSS_TOL, the whole gradient's
    relative L2 within CP_GRAD_TOL."""
    import torch
    from aiko_services_tpu_torch.models import llama, train
    from aiko_services_tpu_torch.models.long_context import \
        make_long_context_loss
    config = llama.LlamaConfig.llama3_1b()
    params = llama.init_params(0, config, device=device)
    leaves = list(_leaves(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    tokens = token_batch(config, CP_TRAIN_BATCH, device)

    def backward(loss_fn):
        loss = loss_fn(params, tokens)
        loss.backward()
        return float(loss.detach())
    dense_loss, dense_ms, dense_peak = timed(
        lambda: backward(lambda p, t: train.language_model_loss(p, config,
                                                                t)))
    dense_grads = [leaf.grad for leaf in leaves]
    for leaf in leaves:
        leaf.grad = None
    loss_fn = make_long_context_loss(config,
                                     cp_mesh_plan({"sp": 4}, device), "ring")
    counters = zero_launches()
    loss, ms, peak = timed(lambda: backward(loss_fn))
    counts = read_launches(counters)
    check_launches("cp-loss-backward", counts, set())
    diff = norm = 0.0
    for leaf, want in zip(leaves, dense_grads):
        diff += (leaf.grad.float() - want.float()).square().sum().item()
        norm += want.float().square().sum().item()
    grad_rel = math.sqrt(diff / norm)
    out = {"run": "cp-loss-backward", "mesh": {"sp": 4}, "attention": "ring",
           "batch": CP_TRAIN_BATCH[0], "seq": CP_TRAIN_BATCH[1],
           "loss": loss, "dense_loss": dense_loss,
           "loss_gap": abs(loss - dense_loss), "loss_tol": CP_LOSS_TOL,
           "grad_rel_l2": grad_rel, "grad_tol": CP_GRAD_TOL,
           "ms": ms, "dense_ms": dense_ms, "peak_gib_above_held": peak,
           "dense_peak_gib_above_held": dense_peak,
           "launches": {k: v for k, v in counts.items() if v}, "card": card}
    del params, leaves, dense_grads
    free_card()
    print(f"context-parallel {json.dumps(out)}", flush=True)
    if not (math.isfinite(loss) and out["loss_gap"] <= CP_LOSS_TOL
            and grad_rel <= CP_GRAD_TOL):
        raise AssertionError(f"cp-loss-backward: loss {loss} against "
                             f"{dense_loss} (tol {CP_LOSS_TOL}), gradient "
                             f"relative L2 {grad_rel:.4f} (tol "
                             f"{CP_GRAD_TOL})")
    return out, counts


def context_parallel_run(card: str) -> dict:
    """Phase 12 (module docstring): no kernel of the port may launch in
    a sharded run.  Returns the phase's summed launches (all 0)."""
    from aiko_services_tpu_torch.device import resolve_device
    device = resolve_device(None)
    held = free_card()
    print(f"context-parallel: the card holds {held:.3f} GiB before the "
          f"phase", flush=True)
    forwards, total = cp_forwards(device, card)
    backward, counts = cp_backward(device, card)
    for name, count in counts.items():
        total[name] = total.get(name, 0) + count
    return {"launches": total, "forwards": forwards, "backward": backward}


# -- phase 13: the sharded model step ---------------------------------------

#: 13a: Llama-3.2-1B on ``_factor_axes(8)`` -- dp x fsdp x tp.
SHARDED_MESH = {"dp": 1, "fsdp": 2, "tp": 4}
SHARDED_STEPS = 3
#: 13b: the 4-expert MoE, remat, on dp x ep x tp.
SHARDED_MOE_MESH = {"dp": 2, "ep": 2, "tp": 2}
#: 13c: Llama-3-8B int8, prefill and decode on a tree placed over tp.
SHARDED_DECODE_MESH = {"tp": 2}
SHARDED_DECODE_STEPS = 8
SHARDED_LOSS_TOL = 1e-2     # |first loss - the one-position step's|
# Relative L2 of each gradient leaf against the one-position step's, in
# bf16: both round every product to bf16, in another order (tp's partial
# sums, fsdp's gathers); CP_GRAD_TOL's bound.
SHARDED_GRAD_TOL = 0.10


def timed_steps(step, params, state, tokens, steps: int, held: float):
    """``steps`` calls of a train step -> (params, state, losses, CUDA-
    event ms of each step, peak GiB above ``held`` over the steps)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, events = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, loss = step(params, state, tokens)
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    times = [start.elapsed_time(end) for start, end in events]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 - held
    return params, state, [float(loss) for loss in losses], times, peak


def profiled_step(step, params, state, tokens):
    """One more step under ``torch.profiler`` (device activity only) ->
    (params, state, {the step's wall ms on the host clock ending in a
    synchronise, the device's busy ms -- the sum of its kernel times --,
    the busy share, the kernels launched})."""
    import torch
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        begin = time.perf_counter()
        params, state, _ = step(params, state, tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - begin) * 1e3
    busy, kernels = 0.0, 0
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            busy += getattr(event, "device_time_total",
                            getattr(event, "cuda_time_total", 0)) / 1e3
            kernels += event.count
    return params, state, {"wall_ms": wall, "device_busy_ms": busy,
                           "device_busy_share": busy / wall,
                           "device_kernels": kernels}


def forward_backward_ms(params, config, tokens) -> dict:
    """One forward of the training loss and its backward, apart: host
    clock, each ending in a synchronise (where a step's time goes: the
    positions' threads run the forward, one autograd thread the
    backward)."""
    import torch
    from aiko_services_tpu_torch.models import train
    leaves = train._leaves(params)
    torch.cuda.synchronize()
    begin = time.perf_counter()
    loss = train.language_model_loss(params, config, tokens)
    torch.cuda.synchronize()
    middle = time.perf_counter()
    torch.autograd.grad(loss, leaves, allow_unused=True,
                        materialize_grads=True)
    torch.cuda.synchronize()
    end = time.perf_counter()
    return {"forward_ms": (middle - begin) * 1e3,
            "backward_ms": (end - middle) * 1e3}


def step_summary(label: str, losses, times, peak, card: str, **extra):
    timed = times[1:] or times
    out = {"run": label, "losses": losses, "step_ms": times,
           "step_ms_mean": sum(timed) / len(timed),
           "peak_gib_above_held": peak, "card": card, **extra}
    print(f"sharded {json.dumps(out)}", flush=True)
    if not all(math.isfinite(loss) for loss in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses not finite or not falling: "
                             f"{losses}")
    return out


def one_position_run(label: str, config, tokens, steps: int, card: str, *,
                     grads: bool = False, drops: bool = False):
    """``init_train_state(0)`` on a plan of one position: the loss and
    (``grads``) the gradient at init -- on the host, bf16 -- and
    (``drops``) the routes the MoE drops there, then ``steps`` timed
    steps.  Everything on the card is freed before it returns."""
    import torch
    from aiko_services_tpu_torch.models import llama, train
    from aiko_services_tpu_torch.models.checkpoint import flatten
    from aiko_services_tpu_torch.parallel.mesh import MeshPlan
    held = free_card()
    plan = MeshPlan.build({"dp": 1}, devices=[tokens.device])
    params, state, _ = train.init_train_state(0, config, plan)
    out = {}
    if drops:
        out["drops"] = routes_dropped(params, config, tokens)
    if grads:
        loss, gradient = train.value_and_grad(params, config, tokens)
        out["grads"] = {name: leaf.to("cpu")
                        for name, leaf in flatten(gradient).items()}
        out["loss"] = float(loss)
        del gradient
    step = train.make_train_step(config, plan)
    params, state, losses, times, peak = timed_steps(
        step, params, state, tokens, steps, held)
    params, state, profiled = profiled_step(step, params, state, tokens)
    profiled.update(forward_backward_ms(params, config, tokens))
    del params, state
    free_card()
    out["run"] = step_summary(label, losses, times, peak, card,
                              mesh={"dp": 1}, batch=list(tokens.shape),
                              profiled=profiled)
    out.setdefault("loss", losses[0])
    return out


def routes_dropped(params, config, tokens) -> int:
    """The (token, expert) routes the MoE drops in one forward of the
    training loss at ``params`` (one position or placed)."""
    import torch
    from aiko_services_tpu_torch.models import llama, train
    with torch.no_grad(), llama.record_route_drops() as counts:
        train.language_model_loss(params, config, tokens)
    return int(sum(int(count) for count in counts))


def replicas_stored_once(params, config) -> dict:
    """A placed tree's replicas after the steps: the groups on distinct
    cards hold equal bits (none when every position lists one card), and
    the distinct tensors hold the model's parameter count exactly -- each
    replica stored, and stepped, once a card."""
    import torch
    from aiko_services_tpu_torch.models import llama
    replicas = params.replicas()
    return {"distinct_tensors": len(params.tensors()),
            "stored": sum(t.numel() for t in params.tensors()),
            "params": sum(leaf.numel()
                          for leaf in _leaves(llama.abstract_params(config))),
            "replica_groups_across_cards": len(replicas),
            "equal": all(torch.equal(group[0], member.to(group[0].device))
                         for group in replicas for member in group[1:])}


def sharded_dense(device, card: str) -> dict:
    """13a (module docstring)."""
    import torch
    from aiko_services_tpu_torch.models import train
    from aiko_services_tpu_torch.models.checkpoint import flatten
    config = train_config()
    tokens = token_batch(config, TRAIN_BATCH, device)
    reference = one_position_run("sharded-1b-one-position", config, tokens,
                                 SHARDED_STEPS, card, grads=True)
    plan = cp_mesh_plan(SHARDED_MESH, device)
    held = free_card()
    params, state, _ = train.init_train_state(0, config, plan)
    loss, gradient = train.value_and_grad(params, config, tokens)
    worst, diff, norm = 0.0, 0.0, 0.0
    for name, got in flatten(plan.gather(gradient)).items():
        want = reference["grads"][name].to(device).float()
        leaf_diff = (got.float() - want).square().sum().item()
        leaf_norm = want.square().sum().item()
        worst = max(worst, math.sqrt(leaf_diff / max(leaf_norm, 1e-30)))
        diff, norm = diff + leaf_diff, norm + leaf_norm
    del gradient, reference["grads"]
    step = train.make_train_step(config, plan)
    params, state, losses, times, peak = timed_steps(
        step, params, state, tokens, SHARDED_STEPS, held)
    params, state, profiled = profiled_step(step, params, state, tokens)
    profiled.update(forward_backward_ms(params, config, tokens))
    replicas = replicas_stored_once(params, config)
    del params, state
    free_card()
    gaps = {"loss_gap": abs(float(loss) - reference["loss"]),
            "grad_rel_l2_worst_leaf": worst,
            "grad_rel_l2": math.sqrt(diff / norm)}
    run = step_summary("sharded-1b", losses, times, peak, card,
                       mesh=SHARDED_MESH, batch=list(tokens.shape),
                       replicas=replicas, **gaps, profiled=profiled,
                       one_position=reference["run"])
    modes = {}
    for label, cfg, accumulate, tol in (
            ("sharded-1b-remat", train_config(remat=True), 1, 1e-2),
            ("sharded-1b-accumulate-2", config, 2, 5e-2)):
        held = free_card()
        params, state, _ = train.init_train_state(0, cfg, plan)
        params, state, mode_losses, mode_times, mode_peak = timed_steps(
            train.make_train_step(cfg, plan, accumulate_steps=accumulate),
            params, state, tokens, 2, held)
        del params, state
        free_card()
        modes[label] = step_summary(
            label, mode_losses, mode_times, mode_peak, card,
            mesh=SHARDED_MESH, first_loss_gap=abs(mode_losses[0] - losses[0]),
            tol=tol)
        if modes[label]["first_loss_gap"] > tol:
            raise AssertionError(f"{label}: first loss {mode_losses[0]} "
                                 f"against {losses[0]} (tol {tol})")
    if not (gaps["loss_gap"] <= SHARDED_LOSS_TOL
            and worst <= SHARDED_GRAD_TOL and replicas["equal"]
            and replicas["stored"] == replicas["params"]):
        raise AssertionError(f"sharded-1b: loss gap {gaps['loss_gap']:.3e} (tol "
                             f"{SHARDED_LOSS_TOL}), worst leaf's gradient "
                             f"relative L2 {worst:.4f} (tol "
                             f"{SHARDED_GRAD_TOL}), replicas {replicas}")
    return {"plain": run, **modes}


def sharded_moe(device, card: str) -> dict:
    """13b (module docstring)."""
    from aiko_services_tpu_torch.models import train
    config = moe_config(max_seq=512, remat=True)
    tokens = token_batch(config, MOE_TRAIN_BATCH, device)
    reference = one_position_run("sharded-moe-one-position", config, tokens,
                                 MOE_TRAIN_STEPS, card, drops=True)
    plan = cp_mesh_plan(SHARDED_MOE_MESH, device)
    held = free_card()
    params, state, _ = train.init_train_state(0, config, plan)
    drops = routes_dropped(params, config, tokens)
    params, state, losses, times, peak = timed_steps(
        train.make_train_step(config, plan), params, state, tokens,
        MOE_TRAIN_STEPS, held)
    del params, state
    free_card()
    gap = abs(losses[0] - reference["loss"])
    run = step_summary("sharded-moe-remat", losses, times, peak, card,
                       mesh=SHARDED_MOE_MESH, batch=list(tokens.shape),
                       loss_gap=gap, routes_dropped=drops,
                       one_position_routes_dropped=reference["drops"],
                       one_position=reference["run"])
    if gap > SHARDED_LOSS_TOL or drops != reference["drops"]:
        raise AssertionError(f"sharded-moe-remat: first loss gap {gap:.3e} "
                             f"(tol {SHARDED_LOSS_TOL}), routes dropped "
                             f"{drops} against {reference['drops']}")
    return run


def placed_serving(params, config, prompts, device, card: str, label: str,
                   feed=None):
    """Each prompt through ``prefill_into_slot`` into its slot of one
    8-row cache (placed by ``cache_specs`` for a placed tree), then
    SHARDED_DECODE_STEPS ``decode_step`` calls of every row, fed the
    greedy tokens of ``feed`` (this run's own when None).  Returns the
    logits (each prompt's prefill, each step's), the greedy tokens, the
    launches and the CUDA-event ms."""
    import torch
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.parallel.mesh import MeshPlan, Placed
    cache = llama.init_cache(config, len(prompts), device=device)
    if isinstance(params, Placed):
        cache = MeshPlan(params.mesh).put(cache, llama.cache_specs(config))
    torch.cuda.synchronize()
    counters = zero_launches()
    out = {"prefill": [], "steps": [], "greedy": [], "first": []}
    begin = torch.cuda.Event(enable_timing=True)
    middle = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        begin.record()
        for slot, prompt in enumerate(prompts):
            logits, cache = llama.prefill_into_slot(
                params, config, prompt[None], cache, slot, 0)
            out["prefill"].append(logits[0])
            out["first"].append(int(logits[0, -1].argmax()))
        middle.record()
        tokens = torch.tensor(out["first"] if feed is None
                              else feed["first"], device=device)
        lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                               device=device)
        for index in range(SHARDED_DECODE_STEPS):
            logits, cache = llama.decode_step(params, config, tokens, cache,
                                              lengths)
            out["steps"].append(logits)
            out["greedy"].append(logits.argmax(-1))
            tokens = out["greedy"][-1] if feed is None \
                else feed["greedy"][index]
            lengths = lengths + 1
        end.record()
    end.synchronize()
    out["launches"] = {k: v for k, v in read_launches(counters).items() if v}
    out["prefill_ms"] = begin.elapsed_time(middle)
    out["decode_step_ms"] = middle.elapsed_time(end) / SHARDED_DECODE_STEPS
    del cache
    print(f"sharded-int8 {label}: prefill of {len(prompts)} prompts "
          f"{out['prefill_ms']:.2f} ms, decode step "
          f"{out['decode_step_ms']:.3f} ms (CUDA events, eager), launches "
          f"{out['launches']} on {card}", flush=True)
    return out


def sharded_int8(device, card: str) -> tuple[dict, dict]:
    """13c (module docstring) -> (results, the placed run's launches)."""
    import torch
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                      quantize_specs)
    config = dataclasses.replace(serving_config(), kv_dtype="int8")
    free_card()
    params = llama.init_params(0, config, device=device)
    qparams = quantize_params(params)
    del params
    free_card()
    prompts = [torch.tensor(prompt, device=device)
               for prompt, _ in mixed_requests(config)]
    one = placed_serving(qparams, config, prompts, device, card,
                         "one-position")
    plan = cp_mesh_plan(SHARDED_DECODE_MESH, device)
    placed = plan.put(qparams, quantize_specs(llama.partition_specs(config)))
    del qparams
    free_card()
    got = placed_serving(placed, config, prompts, device, card,
                         f"placed {SHARDED_DECODE_MESH}", feed=one)
    del placed
    # Phase 15a's reference: the same run with each position in a
    # process of its own is held to this one, bit for bit.
    MULTIHOST_REFERENCE["int8"] = {
        "feed": {"first": list(one["first"]),
                 "greedy": [t.tolist() for t in one["greedy"]]},
        "digests": logits_digests(got),
        "greedy": [t.tolist() for t in got["greedy"]],
        "launches": dict(got["launches"])}
    errors = [relative_error(a[None], b[None])
              for a, b in zip(got["prefill"], one["prefill"])] + \
        [relative_error(a[None], b[None])
         for a, b in zip(got["steps"], one["steps"])]
    agree = sum(bool(torch.equal(a, b))
                for a, b in zip(got["greedy"], one["greedy"]))
    wanted = {name: 2 * count for name, count in one["launches"].items()
              if name != "int8_combine"}
    counts = got["launches"]
    out = {"run": "sharded-int8", "mesh": SHARDED_DECODE_MESH,
           "prompts": len(prompts), "steps": SHARDED_DECODE_STEPS,
           "max_err_rel": max(errors), "prefill_err_rel": errors[:8],
           "step_err_rel": errors[8:], "tol": LOGITS_TOL,
           "argmax_agree_steps": agree,
           "prefill_ms": got["prefill_ms"],
           "one_position_prefill_ms": one["prefill_ms"],
           "decode_step_ms": got["decode_step_ms"],
           "one_position_decode_step_ms": one["decode_step_ms"],
           "launches": counts, "one_position_launches": one["launches"],
           "card": card}
    del got, one
    free_card()
    print(f"sharded {json.dumps(out)}", flush=True)
    kernels = {"flash_decode_attention_stacked[int8]", "decode_combine",
               "flash_attention", "int8_matmul", "int8_matmul[M>16]"}
    if max(errors) > LOGITS_TOL or not kernels <= set(wanted) \
            or any(counts.get(name, 0) != count
                   for name, count in wanted.items()) \
            or set(counts) - set(wanted) - {"int8_combine"}:
        raise AssertionError(
            f"sharded-int8: logits error {max(errors):.4f} (tol "
            f"{LOGITS_TOL}); launches {counts}, wanted twice the "
            f"one-position run's {wanted} (int8_combine apart) and no other")
    return out, counts


def logits_digests(run: dict) -> list[str]:
    """SHA-256 of the bytes of each logits tensor of a
    :func:`placed_serving` run (its prefills, then its steps)."""
    import hashlib
    import torch
    return [hashlib.sha256(logits.detach().contiguous().view(torch.uint8)
                           .cpu().numpy().tobytes()).hexdigest()
            for logits in run["prefill"] + run["steps"]]


def sharded_step_run(card: str) -> dict:
    """Phase 13 (module docstring): 13a and 13b launch no kernel of the
    port; 13c launches #2 (int8), #4 and #5 at each position.  Returns
    the phase's launches (13c's placed run)."""
    from aiko_services_tpu_torch.device import resolve_device
    device = resolve_device(None)
    held = free_card()
    print(f"sharded-step: the card holds {held:.3f} GiB before the phase; "
          f"every position of each mesh lists {device}", flush=True)
    counters = zero_launches()
    dense = sharded_dense(device, card)
    moe = sharded_moe(device, card)
    counts = read_launches(counters)
    check_launches("sharded-1b and sharded-moe-remat", counts, set())
    serving, launches = sharded_int8(device, card)
    return {"launches": launches, "dense": dense, "moe": moe,
            "int8": serving}


# -- phase 13d: the continuous batcher on a placed int8 tree --------------

SERVING_TP_TOKENS = 16      # new tokens a request (about 120 s a phase)
#: (label, batcher options, the attention kernel of the run's path)
SERVING_TP_PLAN = (
    ("tp-int8-dense-4", dict(decode_block=4, inflight=2),
     "flash_decode_attention_stacked"),
    ("tp-int8-paged-1", dict(decode_block=1, kv_page_tokens=64),
     "flash_decode_attention_paged"),
    ("tp-int8-loop-16", dict(decode_block_tokens=16),
     "flash_decode_attention_stacked"),
    ("tp-int8-loop-ngram-paged-16",
     dict(decode_block_tokens=16, speculative="ngram", spec_tokens=4,
          kv_page_tokens=64), "flash_verify_attention_paged"))


def hand_driven(params, config, requests, device, card: str,
                label: str) -> dict:
    """The batcher's work on ``requests`` driven by hand, eagerly: each
    prompt into slot = its index through ``prefill_into_slot`` in the
    batcher's 512-token chunks (padded, the last start clamped to
    ``max_seq - 512``), its first token the argmax at the last prompt
    position, then SERVING_TP_TOKENS - 1 ``decode_step`` calls of all
    eight rows, each fed its own argmax at its own length.  A placed tree
    gets a cache placed by ``cache_specs``.  Returns the greedy token
    streams by request id, the admission ms a chunk and the decode-step
    ms (CUDA events)."""
    import torch
    from aiko_services_tpu_torch.device import upload
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.parallel.mesh import MeshPlan, Placed
    chunk = 512
    cache = llama.init_cache(config, len(requests), device=device)
    if isinstance(params, Placed):
        cache = MeshPlan(params.mesh).put(cache, llama.cache_specs(config))
    free_card()
    begin, middle, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
    firsts, chunks = [], 0
    with torch.no_grad():
        begin.record()
        for slot, (prompt, _) in enumerate(requests):
            done = 0
            while done < len(prompt):
                start = min(done, config.max_seq - chunk)
                part = prompt[start:start + chunk]
                padded = torch.zeros((1, chunk), dtype=torch.int64)
                padded[0, :len(part)] = torch.tensor(part)
                logits, cache = llama.prefill_into_slot(
                    params, config, upload(padded, device), cache, slot,
                    start)
                done = start + len(part)
                chunks += 1
            firsts.append(logits[0, len(prompt) - start - 1].argmax())
        middle.record()
        tokens = torch.stack(firsts)
        lengths = torch.tensor([len(prompt) for prompt, _ in requests],
                               dtype=torch.int32, device=device)
        emitted = [tokens]
        for _ in range(SERVING_TP_TOKENS - 1):
            logits, cache = llama.decode_step(params, config, tokens, cache,
                                              lengths)
            tokens = logits.argmax(-1)
            lengths = lengths + 1
            emitted.append(tokens)
        end.record()
    end.synchronize()
    rows = torch.stack(emitted, dim=1).tolist()
    out = {"streams": {f"r{index}": row for index, row in enumerate(rows)},
           "admission_ms": begin.elapsed_time(middle) / chunks,
           "chunks": chunks,
           "decode_step_ms": middle.elapsed_time(end)
           / (SERVING_TP_TOKENS - 1)}
    del cache
    print(f"serving-tp-int8 {label}, by hand: {chunks} admission chunks "
          f"{out['admission_ms']:.2f} ms each, decode step "
          f"{out['decode_step_ms']:.3f} ms (CUDA events, eager) on {card}",
          flush=True)
    return out


def serving_tp_run(card: str) -> dict:
    """Phase 13d (module docstring) -> its launches (the four placed
    batcher runs' and 15d's one-process reference runs' together) and
    each run's summary."""
    from aiko_services_tpu_torch.device import resolve_device
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                      quantize_specs)
    device = resolve_device(None)
    config = dataclasses.replace(serving_config(), kv_dtype="int8")
    free_card()
    params = llama.init_params(0, config, device=device)
    qparams = quantize_params(params)
    del params
    free_card()
    requests = mixed_requests(config)
    greedy = [f"r{index}" for index in range(0, len(requests), 2)]
    options = dict(new_tokens=SERVING_TP_TOKENS)

    def run(label, tree, settings, cache_put=None):
        counters = zero_launches()
        extra = {} if cache_put is None else {"cache_put": cache_put}
        result = serve(tree, config, requests, label, device, card,
                       **options, **settings, **extra)
        result["launches"] = {name: count for name, count
                              in read_launches(counters).items() if count}
        print(f"serving-tp-int8 {json.dumps(result['metrics'])} launches "
              f"{json.dumps(result['launches'])}", flush=True)
        return result
    alone = {"hand": hand_driven(qparams, config, requests, device, card,
                                 "one position")}
    for label, settings, _ in SERVING_TP_PLAN:
        alone[label] = run(f"{label} one position", qparams, settings)
    plan = cp_mesh_plan(SHARDED_DECODE_MESH, device)
    placed = plan.put(qparams, quantize_specs(llama.partition_specs(config)))
    del qparams
    free_card()
    hand = hand_driven(placed, config, requests, device, card,
                       f"placed {SHARDED_DECODE_MESH}")
    launches, summary = {}, []
    for label, settings, attention in SERVING_TP_PLAN:
        specs = llama.paged_cache_specs(config) \
            if "kv_page_tokens" in settings else llama.cache_specs(config)
        got = run(label, placed, settings,
                  cache_put=lambda cache, specs=specs: plan.put(cache, specs))
        one = alone[label]
        agree = sum(got["streams"][rid] == hand["streams"][rid]
                    for rid in greedy)
        agree_one = sum(got["streams"][rid] == one["streams"][rid]
                        for rid in greedy)
        speculative = "speculative" in settings
        wanted = {f"{attention}[int8]", "flash_attention",
                  "int8_matmul[M>16]", "topk"} | (
            {"verify_combine"} if speculative else
            {"decode_combine", "int8_matmul", "int8_combine"})
        check_launches(f"{label} one position", one["launches"], wanted)
        check_launches(label, got["launches"], wanted)
        # The model's kernels launch at each position; top-k samples the
        # whole logits once a step on the first device, as one position
        # does.
        twice = {name: (count if name == "topk" else 2 * count)
                 for name, count in one["launches"].items()
                 if name != "int8_combine"}
        metrics = got["metrics"]
        if speculative:
            # Acceptance sets how many blocks a run takes, so the two
            # runs' totals differ; each replayed block verifies
            # ring - spec_tokens times (one more in the capture's
            # warm-up) at every layer of every position.
            iterations = settings["decode_block_tokens"] \
                - settings["spec_tokens"]
            twice = {name: 2 * config.n_layers
                     * (iterations * metrics["replays"] + 1)
                     for name in (f"{attention}[int8]", "verify_combine")}
            if metrics["draft_tokens"] <= 0 or got["leaked"]:
                raise AssertionError(f"{label}: no draft tokens, or "
                                     f"leaked pages")
        entry = {"run": label, "mesh": SHARDED_DECODE_MESH,
                 "greedy_equal_to_hand": f"{agree}/{len(greedy)}",
                 "greedy_equal_to_one_position": f"{agree_one}/{len(greedy)}",
                 "tokens_per_s": metrics["tokens_per_s"],
                 "one_position_tokens_per_s": one["metrics"]["tokens_per_s"],
                 "decode_step_ms": hand["decode_step_ms"],
                 "one_position_decode_step_ms":
                     alone["hand"]["decode_step_ms"],
                 "admission_ms": hand["admission_ms"],
                 "one_position_admission_ms": alone["hand"]["admission_ms"],
                 "int8_combine": got["launches"].get("int8_combine", 0),
                 "one_position_int8_combine":
                     one["launches"].get("int8_combine", 0),
                 "card": card}
        if speculative:
            entry.update(draft_tokens=metrics["draft_tokens"],
                         accepted_tokens=metrics["accepted_tokens"])
        if "captures" in metrics:
            eager = metrics["blocks_dispatched"] - metrics["replays"]
            entry.update(captures=metrics["captures"],
                         replays=metrics["replays"],
                         capture_s=metrics["capture_s"], broken=eager)
            if metrics["captures"] < 1 or eager:
                raise AssertionError(
                    f"{label}: {metrics['captures']} captures, {eager} "
                    f"blocks not replayed from a captured graph")
        print(f"serving-tp-int8 {json.dumps(entry)}", flush=True)
        summary.append(entry)
        # A verified position attends the chunk's earlier k/v before
        # their int8 quantization, where a decode step reads them
        # quantized: the speculative run's agreement is reported only.
        if agree != len(greedy) and not speculative:
            raise AssertionError(
                f"{label}: greedy streams equal to the placed decode_step "
                f"driven by hand for {agree} of {len(greedy)} requests")
        if any(got["launches"].get(name, 0) != count
               for name, count in twice.items()):
            raise AssertionError(
                f"{label}: launches {got['launches']}, wanted {twice} "
                f"(twice one position's, top-k once, int8_combine "
                f"apart; a verify kernel per replayed iteration)")
        for name, count in got["launches"].items():
            launches[name] = launches.get(name, 0) + count
        del got
    # Phase 15d's reference: the same batcher runs with each position in
    # a process of its own are held to these, stream for stream.
    MULTIHOST_REFERENCE["batcher"] = multihost_batcher(
        placed, config, device, card, f"one process, {SHARDED_DECODE_MESH}"
        f" on the card twice")
    for run in MULTIHOST_REFERENCE["batcher"].values():
        for name, count in run["launches"].items():
            launches[name] = launches.get(name, 0) + count
    del placed
    free_card()
    return {"launches": launches, "runs": summary}


#: 13e: phase 11's MoE over dp x tp, one card at every position.
MOE_DP_MESH = {"dp": 2, "tp": 2}
MOE_DP_TOKENS = 8               # new tokens a request
#: the batcher's prompts (tokens): slots 0-3 of a 4-row cache, two rows
#: a dp group.
MOE_DP_PROMPTS = (100, 300, 200, 500)
#: the burst: chunk rows into slots of both dp groups, out of order.
MOE_DP_SLOTS = (3, 0, 2, 1)
#: a capacity factor at which the burst drops routes.
MOE_DP_DROPPING = 0.5


def moe_dp_run(card: str) -> dict:
    """Phase 13e (module docstring) -> its launches and summary."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.device import resolve_device
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.batching import (ContinuousBatcher,
                                                         Request)
    begin = time.perf_counter()
    device = resolve_device(None)
    config = moe_config()
    held = free_card()
    params = llama.init_params(0, config, device=device)
    plan = cp_mesh_plan(MOE_DP_MESH, device)
    placed = plan.put(params, llama.partition_specs(config))
    # The burst goes through the dense admission (flash admits a slot a
    # call): the same weights with dense attention, at the config's
    # capacity factor and at one where routes drop.  Its reference is the
    # same burst on {"tp": 2} (one group holds every row, so it routes
    # the burst whole) -- the same tp arithmetic; the unplaced call's
    # bf16 sums differ from tp's, which flips router near-ties, so it is
    # reported only.
    whole = cp_mesh_plan({"tp": MOE_DP_MESH["tp"]}, device)
    whole_tree = whole.put(params, llama.partition_specs(config))
    tokens = token_batch(config, (len(MOE_DP_SLOTS), 512), device, seed=11)
    starts = [0] * len(MOE_DP_SLOTS)
    counters = zero_launches()
    bursts = []
    for factor in (config.capacity_factor, MOE_DP_DROPPING):
        dense = dataclasses.replace(config, attention="dense",
                                    capacity_factor=factor)
        out = {}
        for name, tree, mesh_plan in (("placed", placed, plan),
                                      ("one group", whole_tree, whole),
                                      ("unplaced", params, None)):
            cache = llama.init_cache(dense, 4, device=device)
            if mesh_plan is not None:
                cache = mesh_plan.put(cache, llama.cache_specs(dense))
            with llama.record_route_drops() as found:
                logits, _ = llama.prefill_into_slots(
                    tree, dense, tokens, cache, MOE_DP_SLOTS, starts)
                out[name] = (logits, int(sum(found)))
            del cache
        burst = {"capacity_factor": factor, "rows": len(MOE_DP_SLOTS),
                 "slots": list(MOE_DP_SLOTS),
                 "logits_error": relative_error(out["placed"][0],
                                                out["one group"][0]),
                 "route_drops": out["placed"][1],
                 "one_group_route_drops": out["one group"][1],
                 "unplaced_logits_error": relative_error(
                     out["placed"][0], out["unplaced"][0]),
                 "unplaced_route_drops": out["unplaced"][1]}
        del out
        print(f"moe-dp2-burst {json.dumps(burst)}", flush=True)
        if burst["logits_error"] > LOGITS_TOL \
                or burst["route_drops"] != burst["one_group_route_drops"]:
            raise AssertionError(
                f"moe-dp2-burst at capacity factor {factor}: logits "
                f"{burst['logits_error']:.4f} of max |logit| from the burst "
                f"on one group (tolerance {LOGITS_TOL}), route drops "
                f"{burst['route_drops']} against "
                f"{burst['one_group_route_drops']}")
        bursts.append(burst)
    if bursts[-1]["route_drops"] <= 0:
        raise AssertionError(f"moe-dp2-burst: no route dropped at capacity "
                             f"factor {MOE_DP_DROPPING}")
    launches = {name: count for name, count
                in read_launches(counters).items() if count}
    check_launches("moe-dp2-burst", launches, set())
    del whole_tree, params
    free_card()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, config.vocab_size, length).tolist()
               for length in MOE_DP_PROMPTS]
    wanted = {"flash_decode_attention_stacked", "decode_combine",
              "flash_attention", "topk"}
    runs = {}
    for label, options in (("moe-dp2-host-4", dict(decode_block=4,
                                                    inflight=2)),
                           ("moe-dp2-loop-16", dict(decode_block_tokens=16))):
        counters = zero_launches()
        batcher = ContinuousBatcher(
            placed, config, max_slots=4, prefill_chunk=512, sample_top_k=50,
            device=device, cache_put=lambda c: plan.put(
                c, llama.cache_specs(config)), **options)
        streams = {}
        started = time.perf_counter()
        for index, prompt in enumerate(prompts):
            streams[index] = []
            batcher.submit(Request(
                str(index), prompt, max_new_tokens=MOE_DP_TOKENS,
                emit=lambda rid, token, done: streams[int(rid)].append(
                    token)))
        batcher.run_until_drained(max_steps=10_000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - started
        run = {"run": label, "mesh": MOE_DP_MESH, "wall_s": wall,
               "tokens_per_s": batcher.tokens_emitted / wall,
               "launches": {name: count for name, count
                            in read_launches(counters).items() if count}}
        if batcher.device_loop:
            run.update(captures=batcher._loop.captures,
                       replays=batcher._loop.replays,
                       capture_s=batcher._loop.capture_s,
                       broken=batcher.blocks_dispatched
                       - batcher._loop.replays)
        print(f"moe-dp2 {json.dumps(run)}", flush=True)
        check_launches(label, run["launches"], wanted)
        if any(len(stream) != MOE_DP_TOKENS for stream in streams.values()):
            raise AssertionError(f"{label}: a request fell short of "
                                 f"{MOE_DP_TOKENS} tokens")
        runs[label] = dict(run, streams=streams)
        del batcher
    loop = runs["moe-dp2-loop-16"]
    if loop["captures"] < 1 or loop["broken"]:
        raise AssertionError(f"moe-dp2-loop-16: {loop['captures']} "
                             f"captures, {loop['broken']} blocks not "
                             f"replayed from a captured graph")
    agree = sum(runs["moe-dp2-host-4"]["streams"][index]
                == loop["streams"][index] for index in range(len(prompts)))
    del placed
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 - held
    free_card()
    seconds = time.perf_counter() - begin
    print(f"moe-dp2: greedy streams equal, host-4 and loop-16: "
          f"{agree}/{len(prompts)}; phase {seconds:.1f} s, peak "
          f"{peak:.2f} GiB above held on {card}", flush=True)
    if agree != len(prompts):
        raise AssertionError("moe-dp2-loop-16 emitted other greedy tokens "
                             "than moe-dp2-host-4")
    totals: dict = {}
    for run in runs.values():
        for name, count in run["launches"].items():
            totals[name] = totals.get(name, 0) + count
    return {"launches": totals, "bursts": bursts, "seconds": seconds,
            "peak_gib": peak,
            "runs": [{key: value for key, value in run.items()
                      if key != "streams"} for run in runs.values()]}


def _map(tree: dict, fn) -> dict:
    return {name: _map(value, fn) if isinstance(value, dict) else fn(value)
            for name, value in tree.items()}


# -- phase 15: the multi-host backend, two processes on the card ---------

#: What phase 15's processes are held to: 13c's placed int8 run
#: (filled by ``sharded_int8``) and 15b's one-process train run.
MULTIHOST_REFERENCE: dict = {}
MULTIHOST_TRAIN_MESH = {"fsdp": 2}
MULTIHOST_TRAIN_STEPS = 2
MULTIHOST_FRAMES = 4
MULTIHOST_FRAME_SHAPE = (1024, 1024)    # 4 MiB of float32 a hop
MULTIHOST_TIMEOUT_S = 600               # a child's whole run
#: 15d: the batcher over the processes' positions, and its reference.
MULTIHOST_BATCHER_TOKENS = 8
MULTIHOST_BATCHER_PLAN = (
    ("mh-int8-dense-4", dict(decode_block=4, inflight=2)),
    ("mh-int8-paged-1", dict(decode_block=1, kv_page_tokens=64)))


def params_checksum(plan, params) -> str:
    """SHA-256 over the bytes of every leaf of a placed tree, gathered
    whole, in name order."""
    import hashlib
    import torch
    from aiko_services_tpu_torch.models.checkpoint import flatten
    digest = hashlib.sha256()
    for name, leaf in sorted(flatten(plan.gather(params)).items()):
        digest.update(name.encode())
        digest.update(leaf.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    return digest.hexdigest()


def multihost_train(plan, device, card: str, label: str) -> dict:
    """15b: ``init_train_state(0)`` of Llama-3.2-1B on ``plan``, then
    MULTIHOST_TRAIN_STEPS steps of TRAIN_BATCH (numpy seed 0) -> the
    losses, the updated tree's checksum, the step ms and the peak."""
    from aiko_services_tpu_torch.models import train
    config = train_config()
    held = free_card()
    tokens = token_batch(config, TRAIN_BATCH, device)
    params, state, _ = train.init_train_state(0, config, plan)
    step = train.make_train_step(config, plan)
    params, state, losses, times, peak = timed_steps(
        step, params, state, tokens, MULTIHOST_TRAIN_STEPS, held)
    out = {"losses": losses, "checksum": params_checksum(plan, params),
           "step_ms": times, "peak_gib_above_held": peak}
    del params, state
    free_card()
    print(f"multihost-train {label}: losses {losses}, step ms {times} "
          f"(CUDA events), peak {peak:.2f} GiB above held on {card}",
          flush=True)
    return out


def multihost_pipeline(coordinator: str, process: int) -> dict:
    """15c: ``(det llm)`` of ``StageWork`` over ``mesh: {hosts: 2,
    coordinator, process_id}``, ``det`` on host 0 and ``llm`` on host 1,
    one card each -> the carve and every response."""
    import torch
    from aiko_services_tpu_torch.pipeline.tensor import RemoteValue

    def stage(name: str, placement: dict) -> dict:
        return {"name": name, "input": [{"name": "x"}],
                "output": [{"name": "x"}],
                "parameters": {"factor": 2.0}, "placement": placement,
                "deploy": {"local": {
                    "module": "aiko_services_tpu_torch.elements.common",
                    "class_name": "StageWork"}}}
    definition = {
        "version": 0, "name": "multihost_det_llm", "runtime": "torch",
        "graph": ["(det llm)"],
        "parameters": {"mesh": {"hosts": 2, "coordinator": coordinator,
                                "process_id": process}},
        "elements": [stage("det", {"devices": 1}),
                     stage("llm", {"devices": 1, "host": 1})]}
    with loopback_runtime() as runtime:
        pipeline = load_pipeline(definition, runtime)
        placement = pipeline.stage_placement
        responses = Responses()
        frame = torch.ones(MULTIHOST_FRAME_SHAPE)
        begin = time.perf_counter()
        for _ in range(MULTIHOST_FRAMES):
            pipeline.process_frame_local({"x": frame}, stream_id="s",
                                         queue_response=responses)
        rows = []

        def drained():
            while not responses.empty():
                rows.append(responses.get())
            return len(rows) >= MULTIHOST_FRAMES or responses.failures
        runtime.run(until=drained, timeout=120.0)
        seconds = time.perf_counter() - begin
        pipeline.stop()
        out = {"stage_hosts": dict(placement.stage_hosts),
               "host_groups": [len(group) for group in placement.host_groups],
               "frames": [row[1] for row in rows],
               "failures": list(responses.failures), "seconds": seconds,
               "values": []}
        for row in rows:
            value = row[2].get("x")
            out["values"].append(
                repr(value) if isinstance(value, RemoteValue)
                else float(value.float().mean()) if torch.is_tensor(value)
                else repr(value))
    return out


def multihost_batcher(placed, config, device, card: str, label: str) -> dict:
    """15d's two runs (``MULTIHOST_BATCHER_PLAN``) of ``ContinuousBatcher``
    on the placed int8 tree, ``cache_put`` placing each cache, phase 3's
    8 requests at MULTIHOST_BATCHER_TOKENS new tokens (8 slots, 512-token
    chunks, top-k 50, ``rng_seed`` 0), every launch counter zeroed before
    each run -> each run's streams, launches, leaked pages and times."""
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.parallel.mesh import MeshPlan
    plan = MeshPlan(placed.mesh)
    requests = mixed_requests(config)
    runs = {}
    for name, settings in MULTIHOST_BATCHER_PLAN:
        specs = llama.paged_cache_specs(config) \
            if settings.get("kv_page_tokens") else llama.cache_specs(config)
        counters = zero_launches()
        result = serve(placed, config, requests, f"{name} {label}", device,
                       card, new_tokens=MULTIHOST_BATCHER_TOKENS,
                       cache_put=lambda cache, specs=specs: plan.put(
                           cache, specs), **settings)
        launches = {name: count for name, count
                    in read_launches(counters).items() if count}
        metrics = result["metrics"]
        runs[name] = {"streams": result["streams"], "launches": launches,
                      "leaked": result["leaked"],
                      "wall_s": metrics["wall_s"],
                      "tokens_per_s": metrics["tokens_per_s"],
                      "ttft_ms_median": metrics["ttft_ms_median"],
                      "ttft_ms_max": metrics["ttft_ms_max"]}
        print(f"multihost-batcher {name} {label}: "
              f"{metrics['tokens_per_s']:.2f} tokens/s, wall "
              f"{metrics['wall_s']:.2f} s, first token "
              f"{metrics['ttft_ms_median']:.1f} ms median, launches "
              f"{json.dumps(launches)} on {card}", flush=True)
    return runs


def multihost_batcher_refused(placed, config, device) -> str | None:
    """The captured loop's batcher over a mesh of the card that spans
    processes on gloo: the error its construction raises (None if it
    builds)."""
    from aiko_services_tpu_torch.models.batching import ContinuousBatcher
    try:
        ContinuousBatcher(placed, config, max_slots=8, prefill_chunk=512,
                          sample_top_k=50, decode_block_tokens=16,
                          device=device)
    except RuntimeError as error:
        return str(error)
    return None


def multihost_batcher_gate(reference: dict, runs: dict,
                           process: int) -> list[str]:
    """What process ``process``'s 15d runs break: every stream equal to
    the one-process reference's, no leaked page, each kernel launched
    half the reference's count (one of two positions), top-k as often
    (each process samples the whole rows), no other kernel."""
    problems = []
    for name, want in reference.items():
        got = runs[name]
        if got["streams"] != want["streams"]:
            same = sum(got["streams"][rid] == stream
                       for rid, stream in want["streams"].items())
            problems.append(f"process {process}: 15d {name}'s streams "
                            f"equal the one-process run's for {same} of "
                            f"{len(want['streams'])} requests")
        if got["leaked"]:
            problems.append(f"process {process}: 15d {name} leaked "
                            f"{got['leaked']} pages")
        counts, wanted = got["launches"], want["launches"]
        if any(counts.get(kernel, 0) * (1 if kernel == "topk" else 2)
               != count for kernel, count in wanted.items()) \
                or set(counts) - set(wanted):
            problems.append(f"process {process}: 15d {name} launched "
                            f"{counts}; the one-process run {wanted} "
                            f"(half a process, top-k whole)")
    return problems


def multihost_child(spec_path: str) -> None:
    """One process of phase 15: brings itself up as process ``k`` of 2
    through the pipeline package's ``ensure_distributed``, runs 15a,
    15d, 15b and 15c, and writes what each gave to its result file."""
    import resource
    import torch
    import torch.distributed as dist
    spec = json.loads(Path(spec_path).read_text())
    process, card = spec["process"], spec["card"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                      quantize_specs)
    from aiko_services_tpu_torch.ops import _build
    from aiko_services_tpu_torch.parallel import MeshPlan, distributed
    from aiko_services_tpu_torch.pipeline.tensor import ensure_distributed
    _build.load_library()
    device = torch.device("cuda", 0)
    out = {"process": process}

    def host_peak(part: str) -> None:
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        free, _ = torch.cuda.mem_get_info()
        print(f"process {process}: {part} done, host peak {rss:.2f} GiB, "
              f"{free / 2 ** 30:.2f} GiB of the card free", flush=True)

    out["ensure"] = ensure_distributed({"hosts": 2, "process_id": process,
                                        "coordinator": spec["coordinator"]})
    out["transport"] = distributed.transport()
    free, _ = torch.cuda.mem_get_info()
    print(f"process {process}: torch.distributed up, transport "
          f"{out['transport']}, {free / 2 ** 30:.2f} GiB of the card free",
          flush=True)

    # 15a: 13c's placed int8 serving, one position in each process.
    reference = spec["int8"]
    config = dataclasses.replace(serving_config(), kv_dtype="int8")
    plan = MeshPlan.build(SHARDED_DECODE_MESH)      # the global pool
    # The processes build the tree in turns: two bf16 trees of
    # Llama-3-8B at once would take some 50 GB of the shared card.
    for turn in range(2):
        if turn == process:
            free_card()
            params = llama.init_params(0, config, device=device)
            qparams = quantize_params(params)
            del params
            placed = plan.put(qparams,
                              quantize_specs(llama.partition_specs(config)))
            del qparams
            held = free_card()
        dist.barrier()
    prompts = [torch.tensor(prompt, device=device)
               for prompt, _ in mixed_requests(config)]
    feed = {"first": reference["feed"]["first"],
            "greedy": [torch.tensor(tokens, device=device)
                       for tokens in reference["feed"]["greedy"]]}
    got = placed_serving(placed, config, prompts, device, card,
                         f"process {process} of {SHARDED_DECODE_MESH}",
                         feed=feed)
    out["int8"] = {"digests": logits_digests(got),
                   "greedy": [t.tolist() for t in got["greedy"]],
                   "launches": got["launches"],
                   "prefill_ms": got["prefill_ms"],
                   "decode_step_ms": got["decode_step_ms"],
                   "peak_gib_above_held":
                       torch.cuda.max_memory_allocated() / 2 ** 30 - held}
    del got
    free_card()
    host_peak("15a")

    # 15d: the continuous batcher on 15a's tree, its positions in the two
    # processes; then the captured loop's batcher, which gloo refuses.
    begin = time.perf_counter()
    out["batcher"] = multihost_batcher(placed, config, device, card,
                                       f"process {process}")
    out["batcher_refused"] = multihost_batcher_refused(placed, config,
                                                       device)
    out["batcher_seconds"] = time.perf_counter() - begin
    del placed
    free_card()
    host_peak("15d")

    # 15b: two train steps of Llama-3.2-1B over fsdp across the processes.
    out["train"] = multihost_train(MeshPlan.build(MULTIHOST_TRAIN_MESH),
                                   device, card, f"process {process}")
    host_peak("15b")

    # 15c: the (det llm) pipeline, det here on host 0, llm on host 1.
    out["pipeline"] = multihost_pipeline(spec["coordinator"], process)
    host_peak("15c")
    distributed.shutdown()
    Path(spec["result"]).write_text(json.dumps(out))


def live_card_tensors(top: int = 5) -> str:
    """The card tensors the garbage collector can reach: their GiB and
    the largest shapes (what an earlier phase left alive)."""
    import gc
    import warnings
    import torch
    seen, sizes = set(), []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # deprecated module attributes
        tensors = [thing for thing in gc.get_objects()
                   if isinstance(thing, torch.Tensor)]
    for thing in tensors:
        try:
            if not thing.is_cuda:
                continue
            storage = thing.untyped_storage()
        except RuntimeError:
            continue
        if storage.data_ptr() in seen:
            continue
        seen.add(storage.data_ptr())
        sizes.append((storage.nbytes(), tuple(thing.shape), thing.dtype))
    sizes.sort(key=lambda entry: -entry[0])
    largest = ", ".join(f"{list(shape)} {str(dtype)[6:]}"
                        for _, shape, dtype in sizes[:top])
    return (f"{len(sizes)} reachable tensors, "
            f"{sum(entry[0] for entry in sizes) / 2 ** 30:.2f} GiB; "
            f"largest {largest}")


def multihost_run(card: str) -> dict:
    """Phase 15 (module docstring): 15b's one-process run, then two
    child processes sharing the card over gloo.  Returns each process's
    launches in 15a and 15d."""
    import resource
    import socket
    import tempfile
    import torch
    from aiko_services_tpu_torch.parallel import MeshPlan
    device = torch.device("cuda", 0)
    begin = time.perf_counter()
    one = multihost_train(MeshPlan.build(MULTIHOST_TRAIN_MESH,
                                         devices=[device, device]),
                          device, card, "one process, the card twice")
    free_card()
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{probe.getsockname()[1]}"
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_multihost_"))
    free, total = torch.cuda.mem_get_info()
    print(f"multihost: spawning 2 processes at {coordinator}; the card has "
          f"{free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB free, this "
          f"process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          f"GiB ({live_card_tensors()}), host peak "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20:.2f}"
          f" GiB", flush=True)
    # Each child writes to a file, never a pipe: a child blocked on a
    # full pipe the parent is not reading stalls its peer's collectives.
    logs = [workdir / f"{process}.log" for process in range(2)]
    children = []
    try:
        for process in range(2):
            spec = {"process": process, "coordinator": coordinator,
                    "card": card, "int8": MULTIHOST_REFERENCE["int8"],
                    "result": str(workdir / f"{process}.json")}
            path = workdir / f"{process}.spec.json"
            path.write_text(json.dumps(spec))
            code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                    f"import chip_smoke; "
                    f"chip_smoke.multihost_child({str(path)!r})")
            with logs[process].open("w") as log:
                children.append(subprocess.Popen(
                    [sys.executable, "-u", "-c", code], cwd=str(ROOT),
                    stdin=subprocess.DEVNULL, stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + MULTIHOST_TIMEOUT_S
        while any(child.poll() is None for child in children) \
                and time.monotonic() < deadline:
            time.sleep(0.5)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.wait()
    codes = [child.returncode for child in children]
    outputs = [log.read_text(errors="replace") for log in logs]
    for process, output in enumerate(outputs):
        for line in output.splitlines():
            print(f"[multihost process {process}] {line}", flush=True)
    if any(codes):
        # Standard error too, so a failure shows the children's own words.
        for process, output in enumerate(outputs):
            for line in output.splitlines()[-60:]:
                print(f"[multihost process {process}] {line}",
                      file=sys.stderr, flush=True)
        raise AssertionError(f"multihost: the processes exited {codes} "
                             f"(a negative code: killed after "
                             f"{MULTIHOST_TIMEOUT_S} s)")
    results = [json.loads((workdir / f"{process}.json").read_text())
               for process in range(2)]
    seconds = time.perf_counter() - begin
    reference = MULTIHOST_REFERENCE["int8"]
    placed_counts = reference["launches"]
    problems = []
    for process, got in enumerate(results):
        int8, trained, served = got["int8"], got["train"], got["pipeline"]
        if tuple(got["ensure"]) != (process, 2):
            problems.append(f"process {process}: ensure_distributed gave "
                            f"{got['ensure']}")
        if got["transport"] != "gloo":
            problems.append(f"process {process}: transport "
                            f"{got['transport']}, not gloo (one card)")
        half = {name: count // 2 for name, count in placed_counts.items()}
        if any(2 * int8["launches"].get(name, 0) != count
               for name, count in placed_counts.items()) \
                or set(int8["launches"]) - set(placed_counts):
            problems.append(f"process {process}: 15a launched "
                            f"{int8['launches']}, one position of 13c's "
                            f"placed run is {half}")
        if int8["greedy"] != reference["greedy"]:
            problems.append(f"process {process}: 15a's greedy tokens differ "
                            f"from 13c's placed run")
        same = sum(a == b for a, b in zip(int8["digests"],
                                          reference["digests"]))
        if same != len(reference["digests"]):
            problems.append(f"process {process}: 15a's logits bitwise equal "
                            f"to 13c's placed run in {same} of "
                            f"{len(reference['digests'])} calls")
        if trained["losses"] != one["losses"] \
                or trained["checksum"] != one["checksum"]:
            problems.append(f"process {process}: 15b's losses "
                            f"{trained['losses']} / checksum "
                            f"{trained['checksum'][:12]} against one "
                            f"process's {one['losses']} / "
                            f"{one['checksum'][:12]}")
        problems += multihost_batcher_gate(MULTIHOST_REFERENCE["batcher"],
                                           got["batcher"], process)
        refused = got["batcher_refused"] or ""
        if "gloo" not in refused or "card" not in refused:
            problems.append(f"process {process}: the captured loop's "
                            f"batcher over gloo gave {refused!r}, not the "
                            f"named refusal")
        want = ["RemoteValue(process 1, llm.x)"] * MULTIHOST_FRAMES \
            if process == 0 else [4.0] * MULTIHOST_FRAMES
        if served["failures"] or served["frames"] != list(
                range(MULTIHOST_FRAMES)) or served["values"] != want \
                or served["stage_hosts"] != {"det": 0, "llm": 1}:
            problems.append(f"process {process}: 15c {served}")
    out = {"run": "multihost", "card": card, "seconds": seconds,
           "transport": results[0]["transport"],
           "one_process_train": one,
           "processes": [{"int8": {key: got["int8"][key] for key in
                                   ("launches", "prefill_ms",
                                    "decode_step_ms", "peak_gib_above_held")},
                          "train": {key: got["train"][key] for key in
                                    ("losses", "step_ms",
                                     "peak_gib_above_held")},
                          "pipeline": {key: got["pipeline"][key] for key in
                                       ("frames", "seconds", "values")},
                          "batcher": {name: {key: run[key] for key in
                                             ("tokens_per_s", "wall_s",
                                              "ttft_ms_median",
                                              "ttft_ms_max", "launches")}
                                      for name, run in got["batcher"].items()},
                          "batcher_seconds": got["batcher_seconds"]}
                         for got in results],
           "batcher_one_process": {
               name: {key: run[key] for key in
                      ("tokens_per_s", "wall_s", "ttft_ms_median",
                       "ttft_ms_max", "launches")}
               for name, run in MULTIHOST_REFERENCE["batcher"].items()},
           "13c_placed_launches": placed_counts}
    print(f"multihost {json.dumps(out)}", flush=True)
    if problems:
        raise AssertionError("multihost: " + "; ".join(problems))
    by_process = []
    for got in results:
        counts = dict(got["int8"]["launches"])
        for run in got["batcher"].values():
            for name, count in run["launches"].items():
                counts[name] = counts.get(name, 0) + count
        by_process.append(counts)
    return {"launches": by_process[0], "launches_by_process": by_process}


# -- phase 16: remote stages over the data plane, replicas on the card -----

#: ``bench.py``'s ``bench_pipeline_transport`` frame (``bench.py:1604-1606``):
#: 6 MB of uint8 (numpy seed 0), 10 hops over the pipe and 6 over MQTT;
#: then the same frame as bf16 over the pipe (its tagged integer view).
#: ``StageWork`` hops ``x * 1.0``: float32 from the uint8 frame (24 MB,
#: about 10 s a hop over MQTT, in the S-expression parser), bf16 as it is.
TRANSPORT_SHAPE = (1024, 2048, 3)
TRANSPORT_HOPS = {"tensor_pipe": 10, "mqtt": 6}
TRANSPORT_RUNS = (("tensor_pipe", "uint8"), ("mqtt", "uint8"),
                  ("tensor_pipe", "bfloat16"))
#: The JAX section's walk (``__graft_entry__.py:487-616``): frames through
#: ``(detect llm)``, then more after the rebuild.
FAILOVER_FRAMES = (9, 6)


def _remote_definitions(name: str, mode: str, front: list, graph: str,
                        back: list, back_graph: str) -> tuple[dict, dict]:
    """A front pipeline ending in the remote stage ``fwd`` and the back
    pipeline it forwards to (``{name}_back``), both under
    ``transfer_guard: disallow`` on the data plane ``mode``."""
    parameters = {"transfer_guard": "disallow", "data_plane": mode}
    return ({"version": 0, "name": f"{name}_front", "runtime": "torch",
             "graph": [graph], "parameters": dict(parameters),
             "elements": front},
            {"version": 0, "name": f"{name}_back", "runtime": "torch",
             "graph": [back_graph], "parameters": dict(parameters),
             "elements": back})


def _remote_pair(runtime, front: dict, back: dict) -> tuple:
    """Both pipelines through ``create_pipeline``, the back first; returns
    once the front's remote stage has found the back."""
    back_pipeline = load_pipeline(back, runtime)
    front_pipeline = load_pipeline(front, runtime)
    stage = front_pipeline.graph.get_node("fwd").element
    runtime.run(until=lambda: stage.remote_topic_path is not None,
                timeout=60.0)
    if stage.remote_topic_path is None:
        raise AssertionError(f"{front['name']}: the remote stage never "
                             f"found {back['name']}")
    return front_pipeline, back_pipeline, stage


def _plane(pipeline) -> dict:
    stats = pipeline.data_plane_stats()
    return {key: stats[key] for key in ("pipe_frames", "mqtt_frames",
                                        "fallbacks", "pipe_bytes",
                                        "mqtt_bytes")}


def transport_mode(runtime, mode: str, dtype: str, frame, card: str) -> dict:
    """16a's pair in one data-plane mode: ``(work (fwd))`` -- a
    ``StageWork`` (factor 1, no wait) placed on the card, so the hopped
    ``x`` is a card tensor -- forwarding to ``(inc)``, an ``Identity``
    placed on the card; TRANSPORT_HOPS[mode] round trips of ``frame`` (a
    pinned host tensor), one at a time."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.device import sync_allowed
    common = "aiko_services_tpu_torch.elements.common"

    def placed(name: str, cls: str, parameters: dict) -> dict:
        return {"name": name, "input": [{"name": "x"}],
                "output": [{"name": "x"}], "parameters": parameters,
                "placement": {"devices": 1},
                "deploy": {"local": {"module": common, "class_name": cls}}}

    label = f"transport_{mode}_{dtype}"
    front, back = _remote_definitions(
        label, mode,
        [placed("work", "StageWork", {"factor": 1.0}),
         {"name": "fwd", "input": [{"name": "x"}],
          "output": [{"name": "x"}],
          "deploy": {"remote": {"name": f"{label}_back"}}}],
        "(work (fwd))", [placed("inc", "Identity", {})], "(inc)")
    front, back, stage = _remote_pair(runtime, front, back)
    expected = frame * 1.0
    raw = expected.numel() * expected.element_size()
    hops = TRANSPORT_HOPS[mode]
    responses = Responses()
    laps, exact = [], 0
    for _ in range(hops):
        begin = time.perf_counter()
        front.process_frame_local({"x": frame}, stream_id="s",
                                  queue_response=responses)
        runtime.run(until=lambda: not responses.empty(), timeout=120.0)
        laps.append((time.perf_counter() - begin) * 1e3)
        if responses.empty():
            raise AssertionError(f"{label}: a hop never returned")
        _, _, swag, _, okay, diagnostic = responses.get()
        if not okay:
            raise AssertionError(f"{label}: {diagnostic}")
        got = swag["x"]
        with sync_allowed():
            got = got.cpu() if isinstance(got, torch.Tensor) \
                else torch.from_numpy(np.asarray(got))
        exact += got.dtype == expected.dtype and torch.equal(got, expected)
    fs, bs = _plane(front), _plane(back)
    out = {"run": label, "hops": hops, "exact": exact,
           "piped": stage.remote_pipe is not None, "front": fs, "back": bs,
           "front_ledger": front.transfer_ledger.stats,
           "back_ledger": back.transfer_ledger.stats,
           "back_uploads": back.stage_placement.uploads,
           "raw_bytes_per_hop": 2 * raw,
           "wire_bytes_per_hop": (fs["pipe_bytes"] + fs["mqtt_bytes"]
                                  + bs["pipe_bytes"] + bs["mqtt_bytes"])
           / hops,
           "hop_p50_ms": float(np.percentile(laps, 50)),
           "hop_p99_ms": float(np.percentile(laps, 99)), "card": card}
    out["wire_over_raw"] = out["wire_bytes_per_hop"] / out["raw_bytes_per_hop"]
    front.stop()
    back.stop()
    problems = []
    if exact != hops:
        problems.append(f"{hops - exact} of {hops} hops returned other "
                        f"bytes than x * 1.0")
    for side in ("front_ledger", "back_ledger"):
        if out[side]["implicit"]:
            problems.append(f"{side}: guard errors {out[side]}")
    # One counted fetch a forward (the card tensor x) and a response (x
    # uploaded onto the back's card by the receiver).
    if out["front_ledger"]["explicit"] != hops:
        problems.append(f"front fetches {out['front_ledger']} for {hops} "
                        f"forwards")
    if mode == "tensor_pipe":
        if not out["piped"] or fs["pipe_frames"] != hops \
                or bs["pipe_frames"] != hops or fs["fallbacks"] \
                or bs["fallbacks"]:
            problems.append(f"pipe frames and fallbacks: {fs} {bs}")
        if out["back_uploads"] != hops \
                or out["back_ledger"]["explicit"] != hops:
            problems.append(f"the back's head got {out['back_uploads']} "
                            f"uploads and its responses "
                            f"{out['back_ledger']} fetches for {hops} hops")
    elif fs["mqtt_frames"] != hops or bs["mqtt_frames"] != hops \
            or fs["pipe_frames"] or bs["pipe_frames"]:
        problems.append(f"mqtt frames: {fs} {bs}")
    print(f"remote-transport {json.dumps(out)}", flush=True)
    if problems:
        raise AssertionError(f"{label}: " + "; ".join(problems))
    return out


def transport_run(card: str) -> dict:
    """16a (module docstring)."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.services import Registrar
    image = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, TRANSPORT_SHAPE, dtype=np.uint8))
    frames = {"uint8": image.pin_memory(),
              "bfloat16": image.to(torch.bfloat16).pin_memory()}
    runs = []
    with loopback_runtime() as runtime:
        Registrar(runtime=runtime, primary_search_timeout=0.05)
        for mode, dtype in TRANSPORT_RUNS:
            runs.append(transport_mode(runtime, mode, dtype, frames[dtype],
                                       card))
    return {"runs": runs}


def _config4_remote_definitions() -> tuple[dict, dict]:
    """Config 4 split over the data plane: ``(DET (fwd))`` -- phase 7's
    detector, placed on the card -- forwarding its image and detections
    to ``(CAP (LLM))`` with the LLM as in ``pipeline-loop-16``."""
    unsplit = _pipeline_definition("config4_remote", {
        "decode_block_tokens": 16}, {"transfer_guard": "disallow"},
        detector=CONFIG4_DETECTOR)
    det, cap, llm = unsplit["elements"]
    det = {**det, "output": [{"name": "image"}, {"name": "detections"}]}
    return _remote_definitions(
        "config4_remote", "tensor_pipe",
        [det, {"name": "fwd", "input": [{"name": "image"},
                                        {"name": "detections"}],
               "output": [{"name": "text"}],
               "deploy": {"remote": {"name": "config4_remote_back"}}}],
        "(DET (fwd))", [cap, llm], "(CAP (LLM))")


def config4_remote_run(card: str, single: dict) -> dict:
    """16b (module docstring): phase 7's frames and models split over the
    data plane, held to phase 7's replies."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.services import Registrar
    images = [torch.from_numpy(image).pin_memory()
              for image in config4_images()]
    begin = time.perf_counter()
    with loopback_runtime() as runtime:
        Registrar(runtime=runtime, primary_search_timeout=0.05)
        front, back = _config4_remote_definitions()
        front, back, stage = _remote_pair(runtime, front, back)
        counters = zero_launches()
        responses = Responses()
        stream = front.create_stream_local("1", queue_response=responses)
        front.create_frame_local(stream, {"image": images[0]})
        runtime.run(until=lambda: responses.qsize() >= 1, timeout=300.0)
        for image in images[1:]:
            front.create_frame_local(stream, {"image": image})
        runtime.run(until=lambda: responses.qsize() >= CONFIG4_FRAMES
                    or responses.failures, timeout=300.0)
        counts = read_launches(counters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - begin
        if responses.failures or responses.qsize() < CONFIG4_FRAMES:
            raise AssertionError(f"config4-remote: {responses.qsize()} of "
                                 f"{CONFIG4_FRAMES} frames answered; "
                                 f"failed: {responses.failures}")
        texts, metrics = {}, {}
        while not responses.empty():
            _, frame_id, swag, metrics[frame_id], _, _ = responses.get()
            texts[frame_id] = swag["text"]
        element = back.graph.get_node("LLM").element
        batcher = element._batcher
        loop = batcher._loop
        steps_limit = 0.6 * CONFIG4_FRAMES * NEW_TOKENS
        out = {"run": "config4-remote-loop-16", "frames": CONFIG4_FRAMES,
               "wall_s": wall,
               "replies_equal_phase7": sum(
                   texts[frame_id] == single["texts"][frame_id]
                   for frame_id in texts),
               "llm_steps": batcher.steps, "llm_steps_limit": steps_limit,
               "captures": loop.captures, "replays": loop.replays,
               "blocks_retired": batcher.blocks_retired,
               "front": _plane(front), "back": _plane(back),
               "front_ledger": front.transfer_ledger.stats,
               "back_ledger": back.transfer_ledger.stats,
               "phase7_flash_attention":
                   single["launches"]["flash_attention"],
               "det_time_ms_median": float(np.median(
                   [m["DET_time"] for m in metrics.values()])) * 1e3,
               "card": card}
        print(f"config4-remote {json.dumps(out)} launches "
              f"{json.dumps(counts)}", flush=True)
        front.stop()
        back.stop()
        element.close()
        del batcher, loop
    check_launches("config4-remote-loop-16", counts, {
        "flash_decode_attention_stacked", "decode_combine",
        "flash_attention", "topk"})
    iterations = out["captures"] + 16 * out["replays"]
    decode = counts["flash_decode_attention_stacked"]
    problems = []
    if out["replies_equal_phase7"] != CONFIG4_FRAMES:
        problems.append(f"{out['replies_equal_phase7']} of "
                        f"{CONFIG4_FRAMES} replies equal phase 7's")
    if counts["flash_attention"] != out["phase7_flash_attention"]:
        problems.append(f"flash_attention {counts['flash_attention']} "
                        f"against phase 7's {out['phase7_flash_attention']}")
    if counts["topk"] != iterations or decode != 32 * iterations \
            or counts["decode_combine"] != decode:
        problems.append(f"decode launches {decode}, combine "
                        f"{counts['decode_combine']}, top-k "
                        f"{counts['topk']} against {iterations} loop "
                        f"iterations (a warm-up a capture, 16 a replay)")
    if not out["llm_steps"] < steps_limit:
        problems.append(f"{out['llm_steps']} LLM steps, limit {steps_limit}")
    for side in ("front", "back"):
        if out[f"{side}_ledger"]["implicit"] or out[side]["fallbacks"]:
            problems.append(f"{side}: guard errors or fallbacks: "
                            f"{out[side + '_ledger']} {out[side]}")
    if out["front"]["pipe_frames"] != CONFIG4_FRAMES \
            or out["front_ledger"]["explicit"] != CONFIG4_FRAMES \
            or out["back_ledger"]["explicit_by_label"].get("llm_block") \
            != out["blocks_retired"]:
        problems.append(f"forwards over the pipe and fetches: "
                        f"{out['front']} {out['front_ledger']} "
                        f"{out['back_ledger']}")
    if problems:
        raise AssertionError("config4-remote: " + "; ".join(problems))
    return {"launches": counts, **out}


def replica_failover_run(card: str) -> dict:
    """16c (module docstring): the JAX section's replica-failover walk on
    one card listed five times."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch import device as device_rule
    from aiko_services_tpu_torch.pipeline.tensor import resident
    common = "aiko_services_tpu_torch.elements.common"

    def element(name: str, placement: dict) -> dict:
        return {"name": name, "input": [{"name": "x"}],
                "output": [{"name": "x"}],
                "parameters": {"busy_ms": 20.0, "factor": 2.0},
                "placement": placement,
                "deploy": {"local": {"module": common,
                                     "class_name": "StageWork"}}}

    definition = {
        "version": 0, "name": "replica_failover", "runtime": "torch",
        "graph": ["(detect llm)"],
        "parameters": {"replay_limit": 3, "replica_rebuild_ms": 80,
                       "health_probe_timeout": 2.0,
                       "fault_plan": {"seed": 0, "rules": [
                           {"point": "device_kill", "target": "detect#1",
                            "count": 1}]}},
        "elements": [element("detect", {"devices": 1, "replicas": 3}),
                     element("llm", {"devices": 1})]}
    rng = np.random.default_rng(0)
    batches = [[torch.from_numpy(rng.standard_normal((16, 16)).astype(
        np.float32)).pin_memory() for _ in range(count)]
        for count in FAILOVER_FRAMES]
    pool = device_rule.local_devices
    card_zero = pool()[0]
    device_rule.local_devices = lambda: [card_zero] * 5
    begin = time.perf_counter()
    try:
        with loopback_runtime() as runtime:
            pipeline = load_pipeline(definition, runtime)
            placement = pipeline.stage_placement
            group = pipeline.stage_scheduler.groups["detect"]
            positions = list(placement.devices)
            counters = zero_launches()
            rows, walk = [], None
            for index, frames in enumerate(batches):
                responses = Responses()
                for x in frames:
                    pipeline.process_frame_local(
                        {"x": x}, stream_id=f"rf{index}",
                        queue_response=responses)
                if index == 0:
                    def replica1_busy():
                        return any(frame.stage == "detect"
                                   and frame.stage_replica == 1
                                   for stream in pipeline.streams.values()
                                   for frame in stream.frames.values())
                    runtime.run(until=replica1_busy, timeout=60.0)
                    if not replica1_busy():
                        raise AssertionError("replica-failover: no frame "
                                             "admitted to replica 1")
                    pipeline.post_self("check_device_health")
                runtime.run(until=lambda: responses.qsize() >= len(frames)
                            or responses.failures, timeout=300.0)
                got = [responses.get() for _ in range(responses.qsize())]
                rows.append(got)
                if index == 0:
                    survivors = list(placement.devices)
                    runtime.run(until=lambda: pipeline.share[
                        "replica_rebuilds"] >= 1, timeout=60.0)
                    walk = [(slot, state)
                            for slot, state, _ in group.transitions]
            counts = read_launches(counters)
            torch.cuda.synchronize()
            out = {"run": "replica-failover", "frames": list(FAILOVER_FRAMES),
                   "answered": [len(got) for got in rows],
                   "okay": sum(row[4] for got in rows for row in got),
                   "in_order": all([row[1] for row in got]
                                   == sorted(row[1] for row in got)
                                   for got in rows),
                   "failovers": pipeline.share["replica_failovers"],
                   "failover_ms": pipeline.share["replica_failover_ms"],
                   "rebuilds": pipeline.share["replica_rebuilds"],
                   "device_kill": pipeline.fault_stats()["plan"]["fired"]
                   .get("device_kill"),
                   "walk_has_dead_and_half_open":
                       (1, "dead") in walk and (1, "half_open") in walk,
                   "states": list(group.states),
                   "positions": [str(entry) for entry in positions],
                   "positions_after_kill": [str(entry)
                                            for entry in survivors],
                   "positions_now": len(placement.devices),
                   "replicas_served": sorted({
                       row[3].get("stage_detect_replica") for got in rows
                       for row in got}),
                   "on_card_exact": sum(
                       isinstance(row[2]["x"], torch.Tensor)
                       and resident(row[2]["x"], card_zero)
                       and torch.equal(row[2]["x"].cpu(), x * 4.0)
                       for got, frames in zip(rows, batches)
                       for row, x in zip(sorted(got, key=lambda r: r[1]),
                                         frames)),
                   "phase_s": time.perf_counter() - begin, "card": card}
            pipeline.stop()
    finally:
        device_rule.local_devices = pool
    print(f"replica-failover {json.dumps(out)}", flush=True)
    check_launches("replica-failover", counts, set())
    total = sum(FAILOVER_FRAMES)
    if out["answered"] != list(FAILOVER_FRAMES) or out["okay"] != total \
            or not out["in_order"] or out["failovers"] != 1 \
            or out["device_kill"] != 1 or out["rebuilds"] < 1 \
            or not out["walk_has_dead_and_half_open"] \
            or out["states"] != ["live"] * 3 \
            or len(positions) != 5 or len(survivors) != 4 \
            or out["positions_now"] != 4 \
            or set(survivors) != set(positions) - {positions[1]} \
            or out["on_card_exact"] != total:
        raise AssertionError(f"replica-failover: {out}")
    return out


def remote_stages_run(card: str, config4: dict) -> dict:
    """Phase 16 (module docstring): 16a, 16b and 16c, every launch
    counter zeroed before each; 16a and 16c launch no kernel."""
    begin = time.perf_counter()
    counters = zero_launches()
    transport = transport_run(card)
    check_launches("remote-transport", read_launches(counters), set())
    remote = config4_remote_run(card, config4)
    failover = replica_failover_run(card)
    print(f"phase 16: {time.perf_counter() - begin:.1f} s", flush=True)
    return {"launches": remote["launches"], "transport": transport,
            "config4_remote": remote, "replica_failover": failover}


def main() -> int:
    if len(sys.argv) > 1:
        fail(f"takes no arguments, got {sys.argv[1:]}", 2)
    if not (ROOT / "aiko_services_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no aiko_services_tpu_torch package", 2)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    sys.path.insert(0, str(ROOT))
    from aiko_services_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"card: {card}", flush=True)

    begin = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - begin:.1f} s")
    for source, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line:
                print(f"  {source}: {line.strip()}")

    kernels = [*check_decode(device), *check_paged(device),
               *check_int8_decode(device), *check_verify(device),
               check_int8_matmul(device), check_int8_combine(device),
               check_attention(device),
               check_topk(device)]
    for entry in kernels:
        library = entry["library_ms"]
        print(f"{entry['name']}: {entry['ms']:.4f} ms (plain "
              f"{entry['plain_ms']:.4f}, library "
              f"{'none' if library is None else f'{library:.4f}'}, "
              f"bound {entry['bound_ms']:.4f} by {entry['bound_by']}) "
              f"on {card}", flush=True)
    torch.cuda.empty_cache()

    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.quant import quantize_params
    config = serving_config()
    begin = time.perf_counter()
    params = llama.init_params(0, config, device=device)
    torch.cuda.synchronize()
    print(f"llama3-8b widths, {config.n_layers} layers: random init "
          f"{time.perf_counter() - begin:.1f} s, "
          f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B "
          f"params")
    mixed, shared = mixed_requests(config), prefix_requests(config)
    paged = dict(kv_page_tokens=64)
    plan = [("dense-1", mixed, dict(decode_block=1)),
            ("dense-4", mixed, dict(decode_block=4)),
            ("paged-1", mixed, dict(decode_block=1, **paged)),
            # inflight=1 retires each block before the next tick admits,
            # so an admission short of pages preempts instead of waiting
            # for the in-flight blocks (with 2 in flight it always waits).
            ("paged-pressure-4", mixed,
             dict(decode_block=4, inflight=1, kv_pages=97, **paged)),
            ("prefix-warm-1", shared,
             dict(decode_block=1, serial_first=True, prefix_cache="on",
                  **paged)),
            ("prefix-cold-1", shared,
             dict(decode_block=1, serial_first=True, **paged))]
    runs, launches = {}, {}
    run_plan(plan, params, config, device, card, runs, launches)

    def greedy_agree(a: str, b: str, rids) -> int:
        return sum(runs[a]["streams"][rid] == runs[b]["streams"][rid]
                   for rid in rids)
    greedy = [f"r{index}" for index in range(0, len(mixed), 2)]
    for a, b in (("dense-1", "dense-4"), ("dense-1", "paged-1")):
        agree = greedy_agree(a, b, greedy)
        print(f"greedy streams equal, {a} and {b}: {agree}/{len(greedy)}")
        if agree != len(greedy):
            raise AssertionError(f"{b} emitted other greedy tokens than {a}")
    pressure = runs["paged-pressure-4"]
    kept = [rid for rid in greedy if rid not in pressure["evicted"]]
    lost = [rid for rid in greedy if rid in pressure["evicted"]]
    agree = greedy_agree("dense-4", "paged-pressure-4", kept)
    print(f"pool pressure: {pressure['metrics']['evictions']} evictions of "
          f"{sorted(pressure['evicted'])}, leaked pages "
          f"{pressure['leaked']}; greedy streams equal to dense-4: never "
          f"evicted {agree}/{len(kept)}, evicted "
          f"{greedy_agree('dense-4', 'paged-pressure-4', lost)}/{len(lost)}"
          f" (a re-prefill rounds otherwise in bf16)")
    if pressure["metrics"]["evictions"] < 1 or pressure["leaked"] \
            or agree != len(kept):
        raise AssertionError("pool pressure: expected >= 1 eviction, no "
                             "leaked page and the dense greedy streams for "
                             "every request never evicted")
    warm, cold = runs["prefix-warm-1"], runs["prefix-cold-1"]
    agree = greedy_agree("prefix-warm-1", "prefix-cold-1", warm["streams"])
    print(f"prefix cache: {warm['metrics']['prefix_hits']} page hits, "
          f"{warm['metrics']['prefix_shared_tokens']} shared tokens, "
          f"warm streams equal to cold: {agree}/{len(warm['streams'])}")
    if warm["metrics"]["prefix_hits"] != 48 \
            or warm["metrics"]["prefix_shared_tokens"] != 3072 \
            or agree != len(warm["streams"]) or warm["leaked"]:
        raise AssertionError("prefix cache: expected 48 page hits, 3072 "
                             "shared tokens, warm streams equal to cold and "
                             "no leaked page")
    check_dense_agreement(params, config, device)

    # -- phase 4: the device-resident loop, bf16 tree ------------------------
    loop = dict(decode_block_tokens=16)
    spec = dict(spec_tokens=4, **loop)
    loop_plan = [
        ("loop-16", mixed, dict(loop), {"flash_decode_attention_stacked"}),
        ("loop-ngram-paged-16", mixed,
         dict(speculative="ngram", **spec, **paged),
         {"flash_verify_attention_paged"}),
        ("loop-draft-16", mixed, dict(speculative="draft", **spec),
         {"flash_verify_attention_stacked", "int8_matmul"}),
        ("loop-recover-16", mixed, dict(recover_at=3, **loop),
         {"flash_decode_attention_stacked"})]
    run_plan(loop_plan, params, config, device, card, runs, launches)
    agree = greedy_agree("dense-1", "loop-16", greedy)
    print(f"greedy streams equal, dense-1 and loop-16: {agree}/{len(greedy)}")
    if agree != len(greedy):
        raise AssertionError("loop-16 emitted other greedy tokens than "
                             "dense-1")
    for label in ("loop-ngram-paged-16", "loop-draft-16"):
        metrics = runs[label]["metrics"]
        print(f"{label}: greedy streams equal to dense-1 "
              f"{greedy_agree('dense-1', label, greedy)}/{len(greedy)} "
              f"(reported: bf16 near-ties may flip a verify argmax); "
              f"{metrics['accepted_tokens']} of {metrics['draft_tokens']} "
              f"draft tokens accepted")
        if metrics["draft_tokens"] <= 0 or runs[label]["leaked"]:
            raise AssertionError(f"{label}: no draft tokens, or leaked pages")
    if runs["loop-draft-16"]["metrics"]["accepted_tokens"] <= 0:
        raise AssertionError("loop-draft-16 accepted no draft token")
    if runs["loop-recover-16"]["metrics"]["recoveries"] != 1:
        raise AssertionError("loop-recover-16: expected one recovery")
    check_verify_agreement(params, config, device)
    check_loop_graph(params, config, device, card)

    # -- phase 5: int8 serving on the same weights, quantized ----------------
    begin = time.perf_counter()
    qparams = quantize_params(params)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tree_gb = sum(leaf.numel() * leaf.element_size()
                  for leaf in _leaves(qparams)) / 1e9
    print(f"quantize_params: {time.perf_counter() - begin:.1f} s, quantized "
          f"tree {tree_gb:.3f} GB (bf16 tree freed)", flush=True)
    int8_config = dataclasses.replace(config, kv_dtype="int8")
    int8_plan = [("int8-dense-4", mixed, dict(decode_block=4)),
                 ("int8-paged-1", mixed, dict(decode_block=1, **paged)),
                 ("int8-loop-ngram-paged-16", mixed,
                  dict(speculative="ngram", **spec, **paged),
                  {"flash_verify_attention_paged"})]
    run_plan(int8_plan, qparams, int8_config, device, card, runs, launches)
    int8_loop = runs["int8-loop-ngram-paged-16"]
    if int8_loop["metrics"]["draft_tokens"] <= 0 or int8_loop["leaked"]:
        raise AssertionError("int8-loop-ngram-paged-16: no draft tokens, or "
                             "leaked pages")
    agree = greedy_agree("int8-dense-4", "int8-paged-1", greedy)
    leaked = runs["int8-paged-1"]["leaked"]
    print(f"int8: greedy streams equal, int8-dense-4 and int8-paged-1: "
          f"{agree}/{len(greedy)}; leaked pages {leaked}")
    if agree != len(greedy) or leaked:
        raise AssertionError("int8: the paged run emitted other greedy "
                             "tokens than the dense run, or leaked pages")
    check_int8_agreement(qparams, int8_config, device)
    del qparams
    torch.cuda.empty_cache()

    # -- phase 6: the pipeline engine and the LLM element --------------------
    pipeline_launches = {}
    for label, llm, parameters, decode in PIPELINE_PLAN:
        pipeline_launches[label] = pipeline_run(label, llm, parameters,
                                                decode, card)["launches"]

    # -- phase 7: BASELINE config 4, detect -> caption -> LLM ----------------
    config4 = config4_run(card)
    pipeline_launches["config4-loop-16"] = config4["launches"]

    # -- phase 8: BASELINE config 5, streaming ASR -> gate -> int8 LLM ------
    config5 = config5_run(card)
    pipeline_launches["config5-speech"] = config5["launches"]

    # -- phase 9: bench.py's fusion chain (R1 (R2 (DET))), fused -----------
    fusion = fusion_run(card)
    pipeline_launches["fusion-chain"] = fusion["launches"]

    # -- phase 10: checkpoints, HF conversion, the profiler, the CLI ------
    checkpoint = checkpoint_run(card)
    pipeline_launches["checkpoint-cli"] = checkpoint["launches"]

    # -- phase 11: training and the mixture-of-experts ---------------------
    train_moe = train_moe_run(card)
    pipeline_launches["train-moe"] = train_moe["launches"]

    # -- phase 12: context parallelism on a mesh of positions ------------
    context = context_parallel_run(card)
    pipeline_launches["context-parallel"] = context["launches"]

    # -- phase 13: the sharded model step on placed trees -----------------
    sharded = sharded_step_run(card)
    pipeline_launches["sharded-step"] = sharded["launches"]

    # -- phase 13d: the continuous batcher on a placed int8 tree ---------
    serving_tp = serving_tp_run(card)
    pipeline_launches["serving-tp-int8"] = serving_tp["launches"]

    # -- phase 13e: an MoE admission burst over two dp groups ------------
    moe_dp = moe_dp_run(card)
    pipeline_launches["moe-dp2-burst"] = moe_dp["launches"]

    # -- phase 14: config 4 with DET split over two dp positions ---------
    config4_dp = config4_dp_run(card, config4)
    pipeline_launches["config4-dp2-loop-16"] = config4_dp["launches"]

    # -- phase 15: the multi-host backend, two processes on the card -----
    multihost = multihost_run(card)
    # Both processes' launches: the path launched its kernels in each.
    pipeline_launches["multihost"] = {
        name: sum(counts.get(name, 0)
                  for counts in multihost["launches_by_process"])
        for name in multihost["launches"]}

    # -- phase 16: remote stages over the data plane, replicas on the card
    remote = remote_stages_run(card, config4)
    pipeline_launches["config4-remote-loop-16"] = remote["launches"]

    for entry in kernels:
        by_run = {label: counts.get(entry["name"], 0)
                  for label, counts in pipeline_launches.items()}
        entry["pipeline_launches"] = by_run
        for run, path in (("config4-loop-16", "config4"),
                          ("config5-speech", "config5")):
            if by_run[run]:
                entry["path"] = path
                entry[f"{path}_launches"] = by_run[run]
        if by_run["config4-dp2-loop-16"]:
            entry["config4_dp2_launches"] = by_run["config4-dp2-loop-16"]
        if entry.get("path") != "kernel phase":
            entry["launches"] = launches[entry["name"]] \
                + sum(by_run.values())
        if entry["name"] == "int8_matmul":
            wide = launches["int8_matmul[M>16]"] + sum(
                counts.get("int8_matmul[M>16]", 0)
                for counts in pipeline_launches.values())
            entry["launches_by_route"] = {"m<=16": entry["launches"],
                                          "m>16": wide}
            entry["pipeline_launches_m>16"] = {
                label: counts.get("int8_matmul[M>16]", 0)
                for label, counts in pipeline_launches.items()}
            entry["launches"] += wide
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for value in tree.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


if __name__ == "__main__":
    sys.exit(main())
