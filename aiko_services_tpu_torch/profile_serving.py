"""Where a serving step's time goes on the card.

    python3 -m aiko_services_tpu_torch.profile_serving [bf16|int8]

Builds llama3-8b at full width and depth (random weights from a seed;
``int8`` serves their ``quantize_params`` quantization with
``kv_dtype="int8"``, the bf16 tree freed first),
fills all eight slots of a 2048-token cache with 1500-token prompts
through the flash admission path, then times with CUDA events and
``torch.profiler``:

- one admission chunk (``prefill_into_slot``, 512 tokens at offset 1024);
- ``decode_step`` + ``select_tokens`` (top-k 50), host clock and device
  clock over 20 steps each;
- device kernel time by name over 5 profiled admission chunks and 5
  profiled decode steps, and the device's busy share of each window
  (sum of kernel times / wall); host self time by operator over the
  same calls (where the enqueue time goes; the profiler's own cost
  inflates it).

Prints one JSON object per measurement, each with the card's name and
power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

from .models import llama
from .models.quant import quantize_params


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


STEPS = 20


def main(argv: list[str]) -> int:
    mode = argv[0] if argv else "bf16"
    if mode not in ("bf16", "int8") or len(argv) > 1:
        raise SystemExit("usage: profile_serving [bf16|int8]")
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA card")
    card = _card()
    device = torch.device("cuda", 0)
    config = dataclasses.replace(
        llama.LlamaConfig.llama3_8b(), max_seq=2048, attention="flash",
        decode_attention="auto")
    params = llama.init_params(0, config, device=device)
    if mode == "int8":
        params = quantize_params(params)
        config = dataclasses.replace(config, kv_dtype="int8")
        torch.cuda.empty_cache()
    cache = llama.init_cache(config, 8, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    chunk = 512
    for slot in range(8):
        for start in (0, 512, 1024):
            tokens = torch.randint(0, config.vocab_size, (1, chunk),
                                   generator=gen, device=device)
            llama.prefill_into_slot(params, config, tokens, cache, slot,
                                    start)
    torch.cuda.synchronize()

    def prefill_once():
        llama.prefill_into_slot(params, config, tokens, cache, 0, 1024)

    tokens_dec = torch.randint(0, config.vocab_size, (8,), generator=gen,
                               device=device)
    lengths = torch.full((8,), 1500, dtype=torch.int32, device=device)
    temps = torch.tensor([0.0, 0.8] * 4, device=device)

    def decode_once():
        logits, _ = llama.decode_step(params, config, tokens_dec, cache,
                                      lengths)
        return llama.select_tokens(gen, logits, temps, top_k=50)

    results = []
    for name, fn in (("prefill_chunk", prefill_once),
                     ("decode_step", decode_once)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        host = time.perf_counter()
        start.record()
        for _ in range(STEPS):
            fn()
        enqueue_ms = (time.perf_counter() - host) * 1e3 / STEPS
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - host) * 1e3 / STEPS
        results.append({"measure": name, "mode": mode,
                        "layers": config.n_layers,
                        "device_ms": start.elapsed_time(end) / STEPS,
                        "host_enqueue_ms": enqueue_ms, "wall_ms": wall_ms,
                        "card": card})

    for name, fn in (("prefill_chunk", prefill_once),
                     ("decode_step", decode_once)):
        results.append(_profile(name, fn, mode, card))
    for entry in results:
        print(json.dumps(entry))
    return 0


def _profile(name: str, fn, mode: str, card: str, calls: int = 5) -> dict:
    """Device kernel time by name, the device's busy share and host self
    time by operator over ``calls`` profiled calls of ``fn``."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        begin = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - begin) * 1e3
    kernels, host = {}, {}
    for event in prof.key_averages():
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = getattr(event, "cuda_time_total", 0)
        if device_us and event.device_type == torch.autograd.DeviceType.CUDA:
            kernels[event.key] = device_us / 1e3 / calls
        elif event.device_type == torch.autograd.DeviceType.CPU:
            host[event.key] = (event.self_cpu_time_total / 1e3 / calls,
                               event.count // calls)
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda item: -item[1])[:12]
    host_top = sorted(host.items(), key=lambda item: -item[1][0])[:12]
    return {"measure": f"{name}_kernels_ms_per_step", "mode": mode,
            "window_ms_per_step": window_ms / calls,
            "device_busy_ms_per_step": busy_ms,
            "device_busy_share": busy_ms / (window_ms / calls),
            "top": [[key[:80], ms] for key, ms in top],
            "host_self_ms_per_step": sum(ms for ms, _ in host.values()),
            "host_top": [[key[:60], ms, count]
                         for key, (ms, count) in host_top],
            "card": card}


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
