"""Time the prefill-attention (#4) and int8-matmul (#5) kernels on the card.

    python3 aiko_services_tpu_torch/kernel_times.py [--root DIR] [--label NAME]

Imports ``aiko_services_tpu_torch`` from ``--root`` (default: the checkout
that holds this file), so that one call can time two trees on one card
in turns (parent, change, change, parent).  Each time is the mean device
time of 20 calls replayed from one CUDA graph (no host enqueue between
the launches), at ``chip_smoke.py``'s shapes: #4 on q [1, 512, 32, 128]
against 2,048 keys at offsets 0 and 1,536; #5 at the decode and prefill
unembed, the admission chunk's w_up, w_down and wk (M 512), the verify
forward's w_up (M 40) and the decode w_down (M 8).  Beside each, the
library call on the same inputs (SDPA; cuBLAS bf16 on the dequantized
weight).  Prints one JSON object a shape, with the card's name and power
limit.  Needs a CUDA card.
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
           "verify_w_up": (40, 4096, 14_336)}


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
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
