"""The arithmetic the metric readers share: the card's peaks, the window's
work from the taps, and the reductions of a trace.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit; a
roofline or model-FLOPs share is stated against them, with the card's
power limit beside it in the run's record.
"""

from __future__ import annotations

import statistics

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

DECODE_KERNELS = ("flash_verify_kernel", "verify_combine_kernel")
PREFILL_KERNELS = ("flash_attention_kernel",)


def percentile(values, q: float):
    """The q-th percentile of every value (linear between order
    statistics); None without values."""
    return float(np.percentile(values, q)) if values else None


def mean(values):
    return float(statistics.fmean(values)) if values else None


def bound_s(n_bytes: float, flops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def window_emits(run: dict) -> list:
    """The tokens emitted inside the window: of the retires after the
    opening one, up to the closing one, where the run counts retires;
    else by their host time."""
    tape = run["tape"]
    if "retired" in run:
        r_open, r_close = run["retired"]
        return [e for e in tape.emits if r_open < e[1] - 1 <= r_close]
    t_open, t_close = run["window"]
    return [e for e in tape.emits if t_open < e[0] <= t_close]


def steady(run: dict) -> tuple:
    """(a test for a host time, the seconds it admits): the window, or in
    a traced run the window up to the moment its profiler began to
    start.  Starting the profiler blocks the thread that steps the run
    for seconds; an open loop's queue fills meanwhile and drains through
    the rest of the window, so what should read the steady state stops
    where that pause begins."""
    t_open, t_close = run["window"]
    paused = run.get("paused")
    t_end = min(t_close, paused[0]) if paused else t_close

    def inside(t: float) -> bool:
        return t_open < t <= t_end
    return inside, t_end - t_open


def model_flops(run: dict, family, inside) -> float:
    """The model's operations for the tokens computed at host times
    ``inside`` admits: each decoded token at its context (its prompt
    and the answer before it), each admission chunk's tokens at theirs,
    the output head included."""
    sizes = run["sizes"]
    total = 0.0
    for t, _, _, k, plen, _ in run["tape"].emits:
        if k >= 1 and inside(t):    # the first token is admission's
            total += family.token_flops(sizes, plen + k)
    for _, t, start, length in run["tape"].chunks:
        if inside(t):
            total += family.chunk_flops(sizes, start, length)
    return total


def mfu(run: dict):
    """The model's operations for the work done in the steady stretch
    (each decoded token at its context, each admission chunk's tokens at
    theirs, the output head; the detector's convolutions for each frame
    answered) over its seconds, as a share of the card's bf16 peak."""
    inside, seconds = steady(run)
    flops = model_flops(run, run["family"], inside)
    frames = [t for t in run.get("answered", []) if inside(t)]
    if "detector" in run and frames:
        from torch_bench.models import detector
        det = run["detector"]
        flops += len(frames) * detector.conv_flops(det, 1,
                                                   det["image_size"])
    if flops <= 0 or seconds <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS


def idle(run: dict):
    """The share of the traced slice in which no operation ran on the
    card."""
    trace = run.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def kernel_share(trace, names) -> list:
    """Device operations of the slice whose name holds one of
    ``names``."""
    return [op for op in trace.in_slice()
            if any(name in op[0] for name in names)]


def block_spans(trace) -> dict:
    """correlation id of each graph launch in the slice -> (first kernel
    start, last kernel end, its kernels), for launches whose kernels all
    lie inside the slice."""
    launches = set(trace.graph_launches())
    groups = {}
    for op in trace.device:
        if op[3] in launches:
            groups.setdefault(op[3], []).append(op)
    out = {}
    for corr, ops in groups.items():
        start = min(op[1] for op in ops)
        end = max(op[1] + op[2] for op in ops)
        if trace.begin_us <= start and end <= trace.end_us:
            out[corr] = (start, end, ops)
    return out
