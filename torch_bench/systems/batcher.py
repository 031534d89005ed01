"""A model served by the port's ``ContinuousBatcher`` itself, driven by
clients in a closed loop: each client sends its next request as soon as
its last one finishes (mix ``kind`` ``closed_loop_requests``).

Set-up: the weights drawn on the card, the batcher built, the clients
started; the loop then runs ``ramp_s`` past the first retired block
(the capture of the device loop, every admission shape and both
samplers are warm by then).  The window runs from a retired block to
the first retired block ``seconds`` later; a token belongs to the block
whose retire emits it, so the window holds whole blocks.
"""

from __future__ import annotations

import time

import numpy as np

from .. import readers, taps, traffic
from . import common


def port_config(config: dict, sizes, serving: dict):
    from aiko_services_tpu_torch.models import llama
    return llama.LlamaConfig(
        vocab_size=sizes.vocab, dim=sizes.dim, n_layers=sizes.layers,
        n_heads=sizes.heads, n_kv_heads=sizes.kv_heads,
        hidden_dim=sizes.ffn, rope_theta=sizes.rope_theta,
        max_seq=sizes.max_seq, norm_eps=sizes.norm_eps,
        dtype=config["torch_dtype"], attention=serving["attention"],
        decode_attention=serving["decode_attention"],
        kv_dtype=serving["kv_dtype"])


KIND = "closed_loop_requests"


def run(ctx) -> dict:
    from aiko_services_tpu_torch.models.batching import (ContinuousBatcher,
                                                         Request)
    config, mix, family = ctx.config, ctx.mix, ctx.family
    if mix["kind"] != KIND:
        raise ValueError(f"the batcher system drives {KIND!r} mixes")
    sizes = family.Sizes.of(config)
    serving = {**config["serving"], **mix["serving"]}
    weights = family.draw(ctx.seed, sizes, ctx.device)
    pool = traffic.requests(mix, sizes.vocab, ctx.seed)
    tape = taps.Tape()
    sent, answers, finished = {}, {}, []
    state = {"next": 0, "closing": False}

    with taps.installed(tape):
        batcher = ContinuousBatcher(
            weights, port_config(config, sizes, serving),
            max_slots=serving["max_slots"],
            prefill_chunk=serving["prefill_chunk"], rng_seed=ctx.seed,
            decode_block_tokens=serving["decode_block_tokens"],
            inflight=serving["inflight"],
            sample_top_k=serving["sample_top_k"],
            speculative=serving["speculative"],
            kv_page_tokens=serving["kv_page_tokens"], device=ctx.device)

        def on_token(rid, token, done):
            answers[rid].append(int(token))
            if done:
                finished.append(rid)
                if not state["closing"]:
                    send()

        def send():
            ask = pool[state["next"] % len(pool)]
            rid = f"r{state['next']}"
            state["next"] += 1
            answers[rid], sent[rid] = [], (time.perf_counter(), ask)
            batcher.submit(Request(
                rid, list(ask.prompt), max_new_tokens=ask.new_tokens,
                temperature=ask.temperature, emit=on_token))

        for _ in range(mix["clients"]):
            send()
        r_open = r_close = None
        slice_ = None
        deadline = time.perf_counter() + ctx.limit_s
        while r_close is None:
            batcher.step()
            now = time.perf_counter()
            if now > deadline:
                raise RuntimeError("the window never closed")
            retires = tape.retires
            if r_open is None and retires \
                    and retires[-1] >= retires[0] + mix["ramp_s"]:
                r_open = len(retires) - 1
                slice_ = ctx.slice_for(retires[r_open])
                captures = batcher._loop.captures
            elif r_open is not None \
                    and retires[-1] >= retires[r_open] + ctx.seconds:
                r_close = len(retires) - 1
            if slice_ is not None:
                slice_.poll(now)
        state["closing"] = True
        if slice_ is not None:
            slice_.close()
        t_open, t_close = tape.retires[r_open], tape.retires[r_close]
        memory_peak = common.memory_peak(ctx.device)
        in_window = readers.window_emits({"tape": tape,
                                          "retired": (r_open, r_close)})
        ttft = [(e[0] - sent[e[2]][0]) * 1e3 for e in in_window
                if e[3] == 0]
        common.note_captures(
            {"loop_captures": batcher._loop.captures - captures})
        taps.check_admissions(tape, batcher.prefill_tokens)
        del batcher
    common.free(ctx.device)

    lengths = {rid: len(answers[rid]) for rid in finished}
    wrong_length = [rid for rid in finished
                    if lengths[rid] != sent[rid][1].new_tokens]
    result = {
        "setup_s": t_open - ctx.started, "window": (t_open, t_close),
        "window_s": t_close - t_open, "tokens": len(in_window),
        "ttft_ms": ttft, "tape": tape, "sizes": sizes,
        "retired": (r_open, r_close),
        "trace": slice_.trace if slice_ is not None else None,
        "paused": slice_.paused if slice_ is not None else None,
        "attempted": len(sent), "failed": len(wrong_length),
        "memory_peak_bytes": memory_peak}

    # -- the judgement, once the window has closed --------------------------
    rng = np.random.default_rng(ctx.seed)
    judge = mix["judge"]
    greedy = [rid for rid in finished if sent[rid][1].temperature == 0.0]
    sampled = [rid for rid in finished if sent[rid][1].temperature > 0.0]
    picks = common.sample(greedy, judge["greedy_requests"], lengths, rng) \
        + common.sample(sampled, judge["sampled_requests"], lengths, rng)
    requests = [(sent[rid][1].prompt, answers[rid]) for rid in picks]
    common.reference_precision()
    logits = family.served_logits(weights, sizes, requests)
    n_greedy = len([rid for rid in picks if rid in greedy])
    checks = {
        "greedy_gap": max([family.greedy_gap(lg, served) for lg, (_, served)
                           in zip(logits[:n_greedy], requests)] or [0.0]),
        "topk_gap": max([family.topk_gap(lg, served, serving["sample_top_k"])
                         for lg, (_, served)
                         in zip(logits[n_greedy:], requests[n_greedy:])]
                        or [0.0]),
        "wrong_lengths": float(len(wrong_length)),
    }
    result["checks"] = checks
    result["judged"] = {"requests": len(picks),
                        "tokens": sum(len(s) for _, s in requests)}
    result["control_inputs"] = (weights, sizes, requests, n_greedy,
                                serving["sample_top_k"])
    if not ctx.keep_inputs:
        del result["control_inputs"], weights
    return result
