"""BASELINE config 4 through the port's ``create_pipeline``:
``(DET (CAP (LLM)))`` on the in-memory loopback transport, fed by
cameras (mix ``kind`` ``periodic_frames``): each of ``streams`` sends
``fps_per_stream`` frames a second, evenly, from a phase drawn from the
seed, whether or not its earlier frames were answered (an open loop:
one thread hands each frame to ``create_frame_local`` at its due time).

The elements are the port's ``Detector``, ``DetectionCaption`` and
``LLM``.  Their weights are the benchmark's: each element asks
``restore_or_init`` for its tree, and for this run that name in the
element's module hands over the tree drawn here.  Set-up sends bursts
of each micro-batch size (``warm_batches``), so the detector's captured
graphs, the LLM's build, loop capture and admission are warm, then the
cameras start and run ``ramp_s`` before the window.  A frame's latency
runs from its due time to its answer, over every frame due in the
window; the cameras go on until each of those is answered (at most
``drain_s`` past the close).  The per-frame readings (the engine's gap,
detector calls and prompt tokens a frame) take the window up to a
traced run's profiler start (``readers.steady``), from a snapshot of
the counters taken there.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from .. import taps, traffic
from ..models import detector as det_ref
from . import common

COCO_CLASSES = [name.replace("_", " ") for name in (
    "person bicycle car motorcycle airplane bus train truck boat "
    "traffic_light fire_hydrant stop_sign parking_meter bench bird cat dog "
    "horse sheep cow elephant bear zebra giraffe backpack umbrella handbag "
    "tie suitcase frisbee skis snowboard sports_ball kite baseball_bat "
    "baseball_glove skateboard surfboard tennis_racket bottle wine_glass "
    "cup fork knife spoon bowl banana apple sandwich orange broccoli carrot "
    "hot_dog pizza donut cake chair couch potted_plant bed dining_table "
    "toilet tv laptop mouse remote keyboard cell_phone microwave oven "
    "toaster sink refrigerator book clock vase scissors teddy_bear "
    "hair_drier toothbrush").split()]
BOS, EOS = 257, 258             # the byte tokenizer's specials
START_S = 0.1                   # the first frame's phase starts after
LATE_S = 0.05                   # a frame sent this late is reported


def caption(template: str, detections: list) -> str:
    """The caption the pipeline's CAP stage should write."""
    counts = {}
    for detection in detections:
        counts[detection["class"]] = counts.get(detection["class"], 0) + 1
    summary = ", ".join(f"{n} {name}" if n > 1 else name
                        for name, n in sorted(counts.items())) or "nothing"
    return template.replace("{detections}", summary)


def encode(text: str) -> list:
    return [BOS] + list(text.encode("utf-8"))


def decode(tokens) -> str:
    return bytes(t for t in tokens if 0 <= t < 256).decode(
        "utf-8", errors="replace")


def definition(config: dict, det: dict, llm_extra: dict) -> dict:
    pipe = config["pipeline"]
    llm_module = "aiko_services_tpu_torch.elements.llm"
    detector = dict(pipe["detector"])
    placement = detector.pop("placement")
    return {
        "version": 0, "name": "bench_config4", "runtime": "torch",
        "graph": [pipe["graph"]], "parameters": pipe["parameters"],
        "elements": [
            {"name": "DET", "input": [{"name": "image"}],
             "output": [{"name": "detections"}],
             "parameters": {**detector, "class_names": COCO_CLASSES,
                            "score_threshold": det["score_threshold"]},
             "placement": placement,
             "deploy": {"local": {
                 "module": "aiko_services_tpu_torch.elements.detect",
                 "class_name": "Detector"}}},
            {"name": "CAP", "input": [{"name": "detections"}],
             "output": [{"name": "text"}],
             "parameters": {"template": pipe["caption_template"]},
             "deploy": {"local": {"module": llm_module,
                                  "class_name": "DetectionCaption"}}},
            {"name": "LLM", "input": [{"name": "text"}],
             "output": [{"name": "text"}],
             "parameters": {**pipe["llm"], **llm_extra},
             "deploy": {"local": {"module": llm_module,
                                  "class_name": "LLM"}}}]}


@contextlib.contextmanager
def handed_weights(trees: dict):
    """Each element's ``restore_or_init`` returns the benchmark's tree
    for its model module (``llama``, ``detector``)."""
    from aiko_services_tpu_torch.elements import detect, llm
    saved = {module: module.restore_or_init for module in (detect, llm)}

    def restore_or_init(model, config, seed, checkpoint, device):
        return trees[model.__name__.rsplit(".", 1)[-1]]
    for module in saved:
        module.restore_or_init = restore_or_init
    try:
        yield
    finally:
        for module, fn in saved.items():
            module.restore_or_init = fn


@contextlib.contextmanager
def device_pool(device):
    """Off a card (the benchmark's own tests), the port's device pool
    is the CPU, and the LLM element is told so."""
    from aiko_services_tpu_torch import device as device_rule
    if torch.device(device).type == "cuda":
        yield {}
        return
    saved = device_rule.local_devices
    device_rule.local_devices = lambda: [torch.device("cpu", 0)]
    try:
        yield {"device": "cpu"}
    finally:
        device_rule.local_devices = saved


@contextlib.contextmanager
def loopback_runtime():
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


def load(spec: dict, runtime):
    from aiko_services_tpu_torch.pipeline import create_pipeline
    with tempfile.TemporaryDirectory() as workdir:
        path = os.path.join(workdir, "pipeline.json")
        with open(path, "w") as stream:
            json.dump(spec, stream)
        return create_pipeline(path, runtime=runtime)


class Answers(queue.Queue):
    """The streams' response queue: stamps each answer and hands it to
    ``on_answer`` on the pipeline's loop thread."""

    def __init__(self, on_answer):
        super().__init__()
        self.on_answer = on_answer

    def put(self, item, *args, **kwargs):
        self.on_answer(time.perf_counter(), item)


def warm(pipeline, runtime, frames: list, batches: list,
         limit_s: float) -> None:
    """Set-up: bursts of each size in ``batches`` on a stream of their
    own, each answered before the next, so the detector captures the
    graph of every micro-batch shape the closed loop will make, and
    the LLM builds, captures its loop and admits, before any frame that
    counts."""
    answered = []
    stream = pipeline.create_stream_local(
        "warm", queue_response=Answers(lambda now, item:
                                       answered.append(item[4])))
    for size in batches:
        wanted = len(answered) + size
        for index in range(size):
            pipeline.create_frame_local(stream,
                                        {"image": frames[index % len(frames)]})
        runtime.run(until=lambda: len(answered) >= wanted, timeout=limit_s)
        if len(answered) < wanted or not all(answered):
            raise RuntimeError(f"warm-up: {len(answered)} of {wanted} "
                               f"frames answered, failures "
                               f"{answered.count(False)}")


def arrivals(mix: dict, streams: int, seed: int, begin: float,
             end: float) -> list:
    """(due time, stream) of every frame from ``begin`` to ``end``:
    each stream sends ``fps_per_stream`` frames a second, evenly, from
    a phase drawn from the seed."""
    period = 1.0 / mix["fps_per_stream"]
    phases = np.random.default_rng(seed).uniform(0.0, period, streams)
    count = int((end - begin) / period) + 1
    return sorted((begin + phase + k * period, number)
                  for number, phase in enumerate(phases)
                  for k in range(count) if begin + phase + k * period < end)


def send_frames(pipeline, streams, frames, schedule, sent, state) -> None:
    """The cameras: each frame handed to ``create_frame_local`` at its
    due time; ``sent`` keeps (due, stream, when it went)."""
    for index, (due, number) in enumerate(schedule):
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        if state["closing"]:
            return
        sent[index] = (due, streams[number].stream_id, time.perf_counter())
        pipeline.create_frame_local(
            streams[number], {"image": frames[index % len(frames)],
                              "bench_frame": index})


def check_llm_config(batcher, sizes) -> None:
    """The element's model has the configuration's sizes."""
    c = batcher.config
    got = (c.vocab_size, c.dim, c.n_layers, c.n_heads, c.n_kv_heads,
           c.hidden_dim, c.rope_theta, c.max_seq, c.norm_eps)
    want = (sizes.vocab, sizes.dim, sizes.layers, sizes.heads,
            sizes.kv_heads, sizes.ffn, sizes.rope_theta, sizes.max_seq,
            sizes.norm_eps)
    if got != want:
        raise RuntimeError(f"the LLM element runs {got}, the "
                           f"configuration states {want}")


KIND = "periodic_frames"


def run(ctx) -> dict:
    config, mix, family = ctx.config, ctx.mix, ctx.family
    if mix["kind"] != KIND:
        raise ValueError(f"the pipeline system drives {KIND!r} mixes")
    sizes = family.Sizes.of(config)
    det = config["detector"]
    trees = {"llama": family.draw(ctx.seed, sizes, ctx.device),
             "detector": det_ref.draw(ctx.seed + 1, det, ctx.device)}
    frames = traffic.frames(mix, ctx.seed)
    tape = taps.Tape()
    sent, answers = {}, {}
    state = {"closing": False, "failed": False}
    snapshots = {}

    with contextlib.ExitStack() as stack:
        stack.enter_context(taps.installed(tape))
        stack.enter_context(handed_weights(trees))
        llm_extra = stack.enter_context(device_pool(ctx.device))
        runtime = stack.enter_context(loopback_runtime())
        pipeline = load(definition(config, det, llm_extra), runtime)
        det_element = pipeline.graph.get_node("DET").element
        llm_element = pipeline.graph.get_node("LLM").element
        stack.callback(llm_element.close)
        stack.callback(pipeline.stop)

        def counters():
            batcher = llm_element._batcher
            cache = det_element.jit_cache
            return {"det_dispatches": cache.hits + cache.misses,
                    "det_graphs": cache.entries,
                    "llm_captures": batcher._loop.captures
                    if batcher is not None else 0,
                    "prefill_tokens": batcher.prefill_tokens
                    if batcher is not None else 0}

        def on_answer(now, item):
            _, _, swag, metrics, okay, diagnostic = item
            index = swag.get("bench_frame")
            answers[index] = (now, swag, metrics, okay, diagnostic)
            state["failed"] = state["failed"] or not okay

        warm(pipeline, runtime, frames, mix["warm_batches"], ctx.limit_s)
        streams = [pipeline.create_stream_local(
            str(number), queue_response=Answers(on_answer))
            for number in range(mix["streams"])]
        begin = time.perf_counter() + START_S
        t_open = begin + mix["ramp_s"]
        t_close = t_open + ctx.seconds
        schedule = arrivals(mix, len(streams), ctx.seed, begin,
                            t_close + mix["drain_s"])
        sender = threading.Thread(
            target=send_frames, daemon=True, name="bench-cameras",
            args=(pipeline, streams, frames, schedule, sent, state))
        slices = []

        def until() -> bool:
            now = time.perf_counter()
            if now >= t_open and "open" not in snapshots:
                snapshots["open"] = counters()
                slices.append(ctx.slice_for(t_open))
            if now >= t_close and "close" not in snapshots:
                snapshots["close"] = counters()
            for piece in slices:
                if piece is not None:
                    if piece.paused is None and now >= piece.begin:
                        snapshots["pause"] = counters()
                    piece.poll(now)
            if state["failed"] or "close" not in snapshots:
                return state["failed"]
            due = [index for index, (at, _, _) in sent.items()
                   if t_open <= at < t_close]
            return all(index in answers for index in due) \
                or now >= t_close + mix["drain_s"]
        sender.start()
        try:
            runtime.run(until=until, timeout=ctx.limit_s)
        finally:
            state["closing"] = True
            sender.join(timeout=10.0)
        for piece in slices:
            if piece is not None:
                piece.close()
        if state["failed"] or "close" not in snapshots:
            bad = [a[4] for a in answers.values() if not a[3]]
            raise RuntimeError(f"the run stopped before the window's frames "
                               f"were answered: {len(answers)} answers, "
                               f"failures {bad[:3]}")
        memory_peak = common.memory_peak(ctx.device)
        batcher = llm_element._batcher
        check_llm_config(batcher, sizes)
        due = [index for index, (at, _, _) in sent.items()
               if t_open <= at < t_close]
    # The worker has stopped: nothing admits any more.
    taps.check_admissions(tape, batcher.prefill_tokens)
    del det_element, llm_element, pipeline, batcher
    common.free(ctx.device)

    common.note_captures({name: snapshots["close"][name]
                          - snapshots["open"][name]
                          for name in ("det_graphs", "llm_captures")})
    late = max(actual - at for at, _, actual in sent.values())
    if late > LATE_S:
        print(f"torch_bench: a frame went out {late * 1e3:.1f} ms after it "
              f"was due", file=sys.stderr, flush=True)
    latency, gaps, missing = [], [], 0
    for index in due:
        if index not in answers:
            missing += 1
            continue
        now, _, metrics, _, _ = answers[index]
        latency.append((now - sent[index][0]) * 1e3)
        inside = sum(metrics.get(f"{name}_time", 0.0)
                     for name in ("DET", "CAP", "LLM"))
        gaps.append((now, ((now - sent[index][0]) - inside) * 1e3))
    answered = sorted(a[0] for a in answers.values())
    failed = [index for index, a in answers.items() if not a[3]]
    failed += [None] * missing
    timeline = [(sent[index][0], a[0]) + tuple(
        a[2].get(f"{name}_time", 0.0) for name in ("DET", "CAP", "LLM"))
        for index, a in sorted(answers.items())]
    trace = slices[0].trace if slices and slices[0] is not None else None
    paused = slices[0].paused if trace is not None else None
    t_end, end = (paused[0], "pause") if paused else (t_close, "close")
    result = {
        "setup_s": t_open - ctx.started, "window": (t_open, t_close),
        "window_s": t_close - t_open,
        "latency_ms": latency, "engine_gap_ms": gaps, "tape": tape,
        "timeline": timeline, "sizes": sizes, "detector": det,
        "steady_frames": sum(t_open < t <= t_end for t in answered),
        "steady_counters": {
            name: snapshots[end][name] - snapshots["open"][name]
            for name in snapshots["open"]},
        "trace": trace, "answered": answered, "paused": paused,
        "attempted": len(sent), "failed": len(failed),
        "memory_peak_bytes": memory_peak}

    # -- the judgement, once the window has closed --------------------------
    template = config["pipeline"]["caption_template"]
    system_prompt = config["pipeline"]["llm"]["system_prompt"]
    served = {}                    # request id -> token ids
    prompts = {}
    for _, _, rid, k, _, token in tape.emits:
        served.setdefault(rid, []).append(token)
    for rid, prompt in tape.prompts.items():
        prompts[rid] = prompt
    okay = [index for index, a in answers.items() if a[3]]
    lengths = {index: len(answers[index][1].get("detections") or [])
               for index in okay}
    rng = np.random.default_rng(ctx.seed)
    picks = common.sample(sorted(okay), mix["judge"]["frames"], lengths,
                          rng)
    mismatched, requests = 0, []
    for index in picks:
        _, swag, _, _, _ = answers[index]
        stream_id = sent[index][1]
        wanted = caption(template, swag.get("detections") or [])
        prompt = encode(system_prompt + wanted)
        match = [rid for rid in served
                 if rid.startswith(f"{stream_id}/")
                 and prompts.get(rid) == prompt
                 and decode([t for t in served[rid] if t != EOS])
                 == swag["text"]]
        if swag.get("CAP.text") != wanted or not match:
            mismatched += 1
            continue
        requests.append((prompt, served[match[0]]))
    common.reference_precision()
    logits = family.served_logits(trees["llama"], sizes, requests)
    gap = max([family.greedy_gap(lg, tokens)
               for lg, (_, tokens) in zip(logits, requests)] or [0.0])
    images = np.stack([frames[index % len(frames)] for index in picks])
    checks = {"greedy_gap": gap, "det_err": 0.0, "det_rank_gap": 0.0,
              "det_count_gap": 0.0, "text_mismatch": float(mismatched)}
    if picks:
        batch = torch.from_numpy(images).to(ctx.device).float() / 255.0
        slates = det_ref.slate(trees["detector"], det, batch)
        for index, reference in zip(picks, slates):
            judged = det_ref.judge(det, reference,
                                   answers[index][1].get("detections") or [],
                                   COCO_CLASSES)
            for name, value in judged.items():
                checks[name] = max(checks[name], value)
    result["checks"] = checks
    result["judged"] = {"frames": len(picks),
                        "tokens": sum(len(t) for _, t in requests)}
    if ctx.keep_inputs:
        result["control_inputs"] = (trees, sizes, requests, det, images)
    return result
