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
   forward's w_up (M 40) shapes, and its decode route's combine exactly
   against the plain combine; prefill attention (#4) at offsets 0 and
   1536; the chunk-verify kernel (speculative decoding's verify step,
   S 5: the tensor-core body split over T, then its combine) stacked
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
   inbound and return hops, and peak memory.

The last two lines are the card (``nvidia-smi``), a ``{"kernels": ...}``
line (each kernel's ``launches`` over every serving and pipeline run,
the pipeline runs' own under ``pipeline_launches``), then
``{"ok": true, "device": {...}}``.  It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
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
    the verify forward's M 40.  Exact against the plain version on grid
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
              "verify_w_up": (40, 4096, 14_336)}
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
    (D 14,336 in decode_splits' splits, M 8, F 4,096): exactly its plain
    version (both add the splits in split order), timed beside it."""
    import torch
    from aiko_services_tpu_torch.kernel_times import graph_ms
    from aiko_services_tpu_torch.ops.int8_matmul import (
        decode_splits, int8_combine, int8_combine_reference)
    gen = torch.Generator(device=device).manual_seed(14)
    m, d, f = 8, 14_336, 4096
    splits = decode_splits(d, f)[0]
    partial = torch.randn((splits, m, f), generator=gen, device=device) * 50
    scale = torch.rand((1, f), generator=gen, device=device) / 64
    exact = torch.equal(int8_combine(partial, scale),
                        int8_combine_reference(partial, scale))
    print(f"int8 combine [{splits}x{m}x{f}]: equal to the plain combine "
          f"{exact}")
    if not exact:
        raise AssertionError("int8 combine disagrees with its plain version")
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


def _pipeline_definition(label: str, llm: dict, parameters: dict) -> dict:
    module = "aiko_services_tpu_torch.elements.llm"
    return {"version": 0, "name": label, "runtime": "torch",
            "graph": ["(CAP (LLM))"], "parameters": parameters,
            "elements": [
                {"name": "CAP", "input": [{"name": "detections"}],
                 "output": [{"name": "text"}],
                 "deploy": {"local": {"module": module,
                                      "class_name": "DetectionCaption"}}},
                {"name": "LLM", "input": [{"name": "text"}],
                 "output": [{"name": "text"}],
                 "parameters": {**PIPELINE_LLM, **llm},
                 "deploy": {"local": {"module": module,
                                      "class_name": "LLM"}}}]}


def pipeline_run(label: str, llm: dict, parameters: dict, decode: str,
                 card: str) -> dict:
    """One run of the ``(CAP (LLM))`` pipeline over PIPELINE_DETECTIONS
    (see the module docstring), then the same prompts through a
    ``ContinuousBatcher`` built directly with the element's settings on
    the element's weights.  The launch counters are zeroed just before
    the frames and read as the last frame's response arrives; the direct
    run is a comparison and counts nowhere.  The element's module is
    instrumented for the run only: its batcher class records its
    settings, submit times and host time in admission and decode, its
    emit records token ids, its model build is timed."""
    import queue
    import tempfile

    import torch
    from aiko_services_tpu_torch.elements import llm as port_llm
    from aiko_services_tpu_torch.models.batching import (ContinuousBatcher,
                                                         Request)
    from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer
    from aiko_services_tpu_torch.ops import launch_counters
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import init_process, reset_process
    from aiko_services_tpu_torch.services.share import reset_services_cache
    from aiko_services_tpu_torch.transport import reset_broker

    timers = {"build_s": 0.0, "admission_s": 0.0, "decode_s": 0.0}
    made, prompts, tokens, submitted, finished = [], {}, {}, {}, {}

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
            made.append((config, kwargs))
            super().__init__(params, config, **kwargs)

        def submit(self, request):
            submitted[request.request_id] = time.perf_counter()
            prompts[request.request_id] = list(request.prompt_tokens)
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
            tokens.setdefault(request_id, []).append(int(token))
            if done:
                finished[request_id] = time.perf_counter()
            inner(request_id, token, done)
        return emit
    arrivals, failures = {}, []

    class Responses(queue.Queue):
        def put(self, item, *args, **kwargs):
            arrivals[item[1]] = time.perf_counter()
            if not item[4]:             # an ERROR ends the stream: stop
                failures.append(f"frame {item[1]}: {item[5]}")
            super().put(item, *args, **kwargs)
    patched = {"ContinuousBatcher": Batcher,
               "_collector": recording_collector}
    saved = {name: getattr(port_llm, name) for name in patched}
    ensure_model = port_llm.LLM._ensure_model
    for name, value in patched.items():
        setattr(port_llm, name, value)

    def build(self, settings=None):
        if self._batcher is None:
            begin = time.perf_counter()
            ensure_model(self, settings)
            torch.cuda.synchronize()    # the weights' draw is asynchronous
            timers["build_s"] += time.perf_counter() - begin
    port_llm.LLM._ensure_model = build
    reset_broker()
    reset_services_cache()
    runtime = init_process(transport="loopback")
    runtime.initialize()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            path = Path(workdir) / "cap.json"
            path.write_text(json.dumps(_pipeline_definition(label, llm,
                                                            parameters)))
            pipeline = create_pipeline(str(path), runtime=runtime)
        counters = launch_counters()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        responses = Responses()
        frames = len(PIPELINE_DETECTIONS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        begin = time.perf_counter()
        stream = pipeline.create_stream_local("1", queue_response=responses)
        # The first frame alone (it pays the model build and, in the
        # loop, the capture), then the rest at once: their prompts find
        # the first one's pages in the prefix index.
        pipeline.create_frame_local(stream,
                                    {"detections": PIPELINE_DETECTIONS[0]})
        runtime.run(until=lambda: responses.qsize() >= 1, timeout=300.0)
        burst = time.perf_counter()
        for detections in PIPELINE_DETECTIONS[1:]:
            pipeline.create_frame_local(stream, {"detections": detections})
        runtime.run(until=lambda: responses.qsize() >= frames or failures,
                    timeout=300.0)
        counts = {name: getattr(fn, attr)
                  for name, (fn, attr) in counters.items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - begin
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if failures or responses.qsize() < frames:
            raise AssertionError(f"{label}: {responses.qsize()} of {frames} "
                                 f"frames answered; failed: {failures}")
        element = pipeline.graph.get_node("LLM").element
        batcher = element._batcher
        texts, captions = {}, {}
        while not responses.empty():
            _, frame_id, swag, _, okay, diagnostic = responses.get()
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
        wanted = {decode, "decode_combine", "flash_attention", "topk"}
        for name, count in counts.items():
            if (count > 0) != (name in wanted):
                raise AssertionError(
                    f"{label}: {name} launched {count} times; the run's "
                    f"path is {sorted(wanted)}")
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

        # The same prompts, directly, on the element's weights.
        config, kwargs = made[0]
        direct = ContinuousBatcher(batcher.params, config, **{
            name: value for name, value in kwargs.items()
            if name not in ("fetch", "fault_probe", "on_block")})
        streams = {rid: [] for rid in prompts}
        for rid, prompt in prompts.items():
            direct.submit(Request(
                rid, prompt, max_new_tokens=NEW_TOKENS, temperature=0.0,
                eos_tokens=tokenizer.eos_tokens,
                emit=lambda r, token, done: streams[r].append(int(token))))
            if rid == first_rid:
                direct.run_until_drained()
        direct.run_until_drained()
        agree = 0
        for frame_id, rid in request_of.items():
            direct_text = tokenizer.decode(
                [t for t in streams[rid] if t not in tokenizer.eos_tokens])
            agree += streams[rid] == tokens[rid] \
                and direct_text == texts[frame_id]
        print(f"{label}: frames equal to the direct batcher (text and "
              f"token ids): {agree}/{frames}; ledger {json.dumps(ledger)}",
              flush=True)
        if agree != frames:
            raise AssertionError(f"{label}: {frames - agree} frames differ "
                                 f"from the direct batcher")
        del direct, batcher, loop
        pipeline.stop()
        element.close()
        return {"metrics": metrics, "launches": counts}
    finally:
        runtime.engine.terminate()
        reset_process()
        reset_services_cache()
        reset_broker()
        for name, value in saved.items():
            setattr(port_llm, name, value)
        port_llm.LLM._ensure_model = ensure_model
        torch.cuda.empty_cache()


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

    for entry in kernels:
        by_run = {label: counts.get(entry["name"], 0)
                  for label, counts in pipeline_launches.items()}
        entry["pipeline_launches"] = by_run
        if entry.get("path") != "kernel phase":
            entry["launches"] = launches[entry["name"]] \
                + sum(by_run.values())
        if entry["name"] == "int8_matmul":
            wide = launches["int8_matmul[M>16]"]
            entry["launches_by_route"] = {"m<=16": entry["launches"],
                                          "m>16": wide}
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
