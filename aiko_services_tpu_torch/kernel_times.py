"""Time the prefill-attention (#4), int8-matmul (#5) and chunk-verify kernels on the card.

    python3 aiko_services_tpu_torch/kernel_times.py [--root DIR] [--label NAME]

Imports ``aiko_services_tpu_torch`` from ``--root`` (default: the checkout
that holds this file), so that one call can time two trees on one card
in turns (parent, change, change, parent).  Each time is the mean device
time of 20 calls replayed from one CUDA graph (no host enqueue between
the launches), at ``chip_smoke.py``'s shapes: #4 on q [1, 512, 32, 128]
against 2,048 keys at offsets 0 and 1,536; #5 at the decode and prefill
unembed, the admission chunk's w_up, w_down and wk (M 512), the verify
forward's w_up (M 40) and the decode leaves w_down, wq/wo, wk/wv and
w_gate/w_up (M 8); the chunk verify (its cache part, S 5, f32 queries
[8, 5, 32, 128] against 7,195 live positions of a 2,048-position row:
``chip_smoke.py``'s shapes) stacked and paged over bf16 and int8 caches.
Beside each, the library call on the same inputs (SDPA, over the
pre-gathered and dequantized view for the verify; cuBLAS bf16 on the
dequantized weight).  Prints one JSON object a shape, with the card's
name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ATTENTION = (1, 512, 32, 2048, 8, 128)        # b, s, h, t, kv, d
MATMULS = {"decode_unembed": (8, 4096, 128_256),
           "prefill_unembed": (512, 4096, 128_256),
           "decode_w_down": (8, 14_336, 4096),
           "prefill_w_up": (512, 4096, 14_336),
           "prefill_w_down": (512, 14_336, 4096),
           "prefill_wk": (512, 4096, 1024),
           "verify_w_up": (40, 4096, 14_336),
           "decode_wq": (8, 4096, 4096),
           "decode_wk": (8, 4096, 1024),
           "decode_w_up": (8, 4096, 14_336)}
VERIFY = (8, 5, 32, 2048, 8, 128, 64)          # b, s, h, t, kv, d, pt
VERIFY_STARTS = (0, 2047, 1, 1500, 513, 64, 2046, 1024)


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls replayed from one
    CUDA graph (captured after three warm-up calls on a side stream): no
    host enqueue sits between the launches, so a wrapper's Python cost,
    which is host time, does not hide the kernel's."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parent.parent))
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    here = Path(__file__).resolve().parent    # not a top-level package dir
    sys.path[:] = [str(Path(args.root).resolve())] + [
        entry for entry in sys.path if Path(entry or ".").resolve() != here]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    from aiko_services_tpu_torch.models.quant import quantize_weight
    from aiko_services_tpu_torch.ops.flash_attention import flash_attention
    from aiko_services_tpu_torch.ops.int8_matmul import int8_matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(11)
    base = {"label": args.label, "root": args.root, "card": card}

    b, s, h, t, kv, d = ATTENTION
    q, k, v = (torch.randn(shape, generator=gen, device=device)
               .to(torch.bfloat16)
               for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(h // kv, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(h // kv, dim=1)
    for offset in (0, 1536):
        mask = torch.arange(t, device=device)[None, :] \
            <= offset + torch.arange(s, device=device)[:, None]
        ms = graph_ms(lambda: flash_attention(q, k, v, q_offset=offset))
        sdpa = graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        flops = 4 * b * h * d * sum(min(t, offset + i + 1) for i in range(s))
        print(json.dumps({**base, "kernel": "flash_attention",
                          "shape": f"q_offset={offset}", "ms": ms,
                          "library_ms": sdpa,
                          "tflops": flops / ms / 1e9}), flush=True)
    del q, k, v, qt, kt, vt

    for label, (m, d, f) in MATMULS.items():
        leaf = quantize_weight(torch.randn((d, f), generator=gen,
                                           device=device))
        x = torch.randn((m, d), generator=gen, device=device).to(
            torch.bfloat16)
        dense = (leaf["int8"].float() * leaf["scale"]).to(torch.bfloat16)
        ms = graph_ms(lambda: int8_matmul(x, leaf["int8"], leaf["scale"]))
        cublas = graph_ms(lambda: torch.matmul(x, dense))
        print(json.dumps({**base, "kernel": "int8_matmul", "shape": label,
                          "mdf": [m, d, f], "ms": ms, "library_ms": cublas,
                          "tflops": 2 * m * d * f / ms / 1e9}), flush=True)
        del leaf, x, dense
        torch.cuda.empty_cache()
    time_verify(base, device, gen)
    return 0


def time_verify(base: dict, device, gen) -> None:
    """The chunk verify's cache part: the stacked form over one layer of a
    [1, B, T, C] cache and the paged form over [1, B*T/pt + 1, pt, C]
    pools through a shuffled table, bf16 and int8, f32 queries; SDPA of
    the S queries over the (dequantized) gathered view beside them."""
    import torch
    from aiko_services_tpu_torch.models.quant import quantize_kv
    from aiko_services_tpu_torch.ops import flash_decode as fd
    b, s, h, t, kv, d, pt = VERIFY
    pages = b * t // pt + 1
    starts = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device=device)
    table = (torch.randperm(pages - 1, generator=gen, device=device) + 1) \
        .reshape(b, t // pt).to(torch.int32)
    q = torch.randn((b, s, h, d), generator=gen, device=device).to(
        torch.bfloat16)
    q_scaled, _ = fd._prep_query(q, d)
    mask = (torch.arange(t, device=device)[None, :]
            < starts[:, None])[:, None, None, :]
    for payload in ("bf16", "int8"):
        sides = []
        for _ in range(2):
            raw = torch.randn((1, pages, pt, kv, d), generator=gen,
                              device=device)
            if payload == "int8":
                leaf = quantize_kv(raw)
                sides.append((leaf["int8"].reshape(1, pages, pt, kv * d),
                              leaf["scale"][..., 0]))
            else:
                sides.append((raw.to(torch.bfloat16).reshape(
                    1, pages, pt, kv * d), None))
            del raw
        (k_pool, ks), (v_pool, vs) = sides
        gathered = [None if pool is None else pool[0][table.long()].reshape(
            1, b, t, pool.shape[-1]).contiguous()
            for pool in (k_pool, v_pool, ks, vs)]
        stacked_ms = graph_ms(lambda: fd.flash_verify_attention_stacked(
            q_scaled, gathered[0], gathered[1], 0, starts, *gathered[2:]))
        paged_ms = graph_ms(lambda: fd.flash_verify_attention_paged(
            q_scaled, k_pool, v_pool, 0, table, starts, ks, vs))
        views = []
        for codes, scales in ((gathered[0], gathered[2]),
                              (gathered[1], gathered[3])):
            values = codes[0].reshape(b, t, kv, d)
            if scales is not None:
                values = (values.float() * scales[0][..., None]).to(
                    torch.bfloat16)
            views.append(values.transpose(1, 2)
                         .repeat_interleave(h // kv, dim=1))
        sdpa = graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), views[0], views[1], attn_mask=mask))
        suffix = "[int8]" if payload == "int8" else ""
        for form, ms in (("stacked", stacked_ms), ("paged", paged_ms)):
            print(json.dumps({**base,
                              "kernel": f"flash_verify_attention_{form}"
                                        f"{suffix}",
                              "shape": f"b{b} s{s} h{h} t{t}",
                              "ms": ms, "library_ms": sdpa}), flush=True)
        del sides, gathered, views, k_pool, v_pool, ks, vs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
