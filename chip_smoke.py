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
    (6 GB) is removed at the end, also on a failure.

The last two lines are the card (``nvidia-smi``), a ``{"kernels": ...}``
line (each kernel's ``launches`` over every serving and pipeline run,
the pipeline runs' own under ``pipeline_launches``, phase 9's zero
under ``fusion-chain``, phase 10's under ``checkpoint-cli``; the entries on config 4's and config 5's paths
carry ``"path"`` and their run's launches), then ``{"ok": true, "device": {...}}``.  It imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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
    version and timed beside SDPA; the line's numbers are offset 1536's."""
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
          recover_at: int = 0, **options) -> dict:
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
            rid, list(prompt), max_new_tokens=NEW_TOKENS,
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
        if len(tokens) != NEW_TOKENS:
            raise AssertionError(f"{label}: {rid} got {len(tokens)} of "
                                 f"{NEW_TOKENS} tokens")
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
                         detector: dict | None = None) -> dict:
    """``(CAP (LLM))``, or ``(DET (CAP (LLM)))`` when the detector's
    parameters are given (the detector placed on the card)."""
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
            "parameters": detector, "placement": {"mesh": {"dp": 1}},
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
                 frames_in: list | None = None, after=None) -> dict:
    """One run of the ``(CAP (LLM))`` pipeline over PIPELINE_DETECTIONS
    (see the module docstring) -- or of ``(DET (CAP (LLM)))`` over
    ``frames_in`` when ``detector`` holds the detector's parameters --
    then the same prompts through a ``ContinuousBatcher`` built
    directly with the element's settings on the element's weights.  The
    launch counters are zeroed just before the frames and read as the
    last frame's response arrives; the direct run is a comparison and
    counts nowhere.  The element's module is instrumented for the run
    only (``recording_llm``).  ``after(pipeline, frame_metrics)`` runs
    before the pipeline stops; its dict joins the result."""
    import torch
    from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer

    with recording_llm() as record, loopback_runtime() as runtime:
        timers, prompts = record["timers"], record["prompts"]
        submitted, finished = record["submitted"], record["finished"]
        pipeline = load_pipeline(_pipeline_definition(
            label, llm, parameters, detector), runtime)
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
        texts, captions, frame_metrics = {}, {}, {}
        while not responses.empty():
            _, frame_id, swag, frame_metrics[frame_id], okay, diagnostic = \
                responses.get()
            if not okay:
                raise AssertionError(f"{label}: frame {frame_id} failed: "
                                     f"{diagnostic}")
            texts[frame_id], captions[frame_id] = swag["text"], \
                swag["CAP.text"]
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
        check_launches(label, counts, {decode, "decode_combine",
                                       "flash_attention", "topk"})
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
        return {"metrics": metrics, "launches": counts, **extra}


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

    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (CONFIG4_SIZE, CONFIG4_SIZE, 3),
                           dtype=np.uint8) for _ in range(CONFIG4_FRAMES)]

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


def _map(tree: dict, fn) -> dict:
    return {name: _map(value, fn) if isinstance(value, dict) else fn(value)
            for name, value in tree.items()}


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

    for entry in kernels:
        by_run = {label: counts.get(entry["name"], 0)
                  for label, counts in pipeline_launches.items()}
        entry["pipeline_launches"] = by_run
        for run, path in (("config4-loop-16", "config4"),
                          ("config5-speech", "config5")):
            if by_run[run]:
                entry["path"] = path
                entry[f"{path}_launches"] = by_run[run]
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
