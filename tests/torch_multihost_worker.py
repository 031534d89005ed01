"""The processes' side of the port's multi-host tests
(``tests/test_torch_multihost.py``, ``tests/test_torch_mesh_mode.py``,
``tests/test_torch_multihost_cuda.py``), JAX-free.  The bridged weights
the CPU cases start from come in one file (``argument``), a dict of
numpy trees by name: ``train``, ``serving`` and ``moe``.

:func:`spawn` starts ``hosts`` processes of this file, each with its own
devices (``AIKO_CPU_DEVICES`` CPU descriptors, or the cards the caller
lists for it), the coordinator on a port bound at 0 first.  Each
process brings itself up (``parallel.distributed.ensure``), runs the
named cases in order, and writes what each returned to
``<out>/<process>.pt``; a case that raises ends the process after its
error is written, so its peer fails within the bring-up's timeout
rather than running on alone.  The cases are plain functions of this
module; the tests call the same functions in one process for the
comparison runs.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Seconds a spawned pair may take before it is killed.
SPAWN_TIMEOUT_S = 240.0


def free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def spawn(cases: list[str], out: Path, hosts: int = 2, cpu_devices: int = 4,
          cards: list[str] | None = None, argument: str = "",
          timeout: float = SPAWN_TIMEOUT_S, gone: tuple = ()) -> list[dict]:
    """Run ``cases`` in ``hosts`` processes over gloo (CPU descriptors)
    or, with ``cards`` (one ``CUDA_VISIBLE_DEVICES`` value a process),
    over the cards -> each process's {case: result, "_exit": code,
    "_log": its output's end}, or {"error": traceback} from the case
    that raised.  The processes in ``gone`` may end without a word (a
    case that makes them exit)."""
    out.mkdir(parents=True, exist_ok=True)
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    for process in range(hosts):
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        env.pop("AIKO_CPU_DEVICES", None)
        if cards is None:
            env["AIKO_CPU_DEVICES"] = str(cpu_devices)
        else:
            env["CUDA_VISIBLE_DEVICES"] = cards[process]
        log = open(out / f"{process}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, ",".join(cases), str(process),
             str(hosts), coordinator, str(out), argument],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    codes = []
    for proc, log in procs:
        try:
            codes.append(proc.wait(max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            proc.kill()
            codes.append(proc.wait())
        log.close()
    results = []
    for process in range(hosts):
        path = out / f"{process}.pt"
        text = (out / f"{process}.log").read_text()[-4000:]
        if not path.exists() and process in gone:
            results.append({"_exit": codes[process]})
            continue
        if not path.exists():
            raise AssertionError(f"process {process} wrote nothing (exit "
                                 f"{codes[process]}):\n{text}")
        result = torch.load(path, weights_only=False)
        result["_log"] = text
        result["_exit"] = codes[process]
        results.append(result)
    return results


# -- cases -------------------------------------------------------------------

def _body(x):
    """Every collective once, and remat around two of them."""
    from aiko_services_tpu_torch.parallel import mesh as m
    scale = m.axis_index("tp") + 1
    a = m.psum(x * scale, "dp")
    b = m.all_gather(a, "tp", axis=1)
    c = m.ppermute(b, ("dp", "tp"), [(i, (i + 1) % 4) for i in range(4)])
    d = m.all_to_all(c, "dp", 0, 1)
    lone = m.ppermute(d, "dp", [(0, 1)])            # position 0 gets zeros
    e = m.remat(lambda t: m.psum(t.sum() * t, ("dp", "tp")) * 0.5, d + lone)
    f, g = m.ppermute((e, e * 2), "tp", [(0, 1), (1, 0)])
    return f + g


def collectives(devices=None) -> dict:
    """``_body`` over ``{"dp": 2, "tp": 2}`` (the global pool's first
    two devices of each process, or ``devices``) on a global input and
    its gradient under an integer-valued cotangent (every sum exact)."""
    from aiko_services_tpu_torch.parallel import mesh as m
    from aiko_services_tpu_torch import device as device_rule
    if devices is None:
        pool = device_rule.devices()
        devices = [d for d in pool if device_rule.process_index(d) == 0][:2] \
            + [d for d in pool if device_rule.process_index(d) == 1][:2]
    mesh = m.make_mesh({"dp": 2, "tp": 2}, devices)
    x = (torch.arange(32.0).reshape(4, 8) - 15).requires_grad_(True)
    y = m.shard_map(_body, mesh, (m.P("dp", "tp"),), m.P("dp", "tp"))(x)
    weight = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
    grad, = torch.autograd.grad((y * (weight % 7 - 3)).sum(), [x])
    return {"y": y.detach(), "grad": grad}


def tiny_config(**overrides):
    from aiko_services_tpu_torch.models import llama
    return dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=128,
                                                      max_seq=64),
                               dtype="float32", **overrides)


def train_batch() -> np.ndarray:
    return np.random.default_rng(3).integers(0, 128, (4, 16)).astype(
        np.int32)


TRAIN_MESHES = (("dp2", {"dp": 2}, False),
                ("dp2-tp2", {"dp": 2, "tp": 2}, False),
                ("dp2-tp2-remat", {"dp": 2, "tp": 2}, True),
                ("fsdp2", {"fsdp": 2}, False))


def mesh_devices(axes: dict, devices=None) -> list:
    """The devices of a mesh whose major axis splits over the processes:
    the first ``size / processes`` devices of each process, in order (or
    the first ``size`` of ``devices``)."""
    from aiko_services_tpu_torch import device as device_rule
    size = int(np.prod(list(axes.values())))
    if devices is not None:
        return list(devices)[:size]
    pool = device_rule.devices()
    count = device_rule._process["count"]
    each = size // count
    return [d for p in range(count)
            for d in [d for d in pool
                      if device_rule.process_index(d) == p][:each]]


def train(weights: dict, devices=None) -> dict:
    """One train step over each of ``TRAIN_MESHES`` from the bridged
    ``weights`` -> {label: {"loss", "params" (gathered, numpy)}}."""
    from aiko_services_tpu_torch.models import bridge, llama
    from aiko_services_tpu_torch.models import train as tt
    from aiko_services_tpu_torch.models.checkpoint import flatten
    from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh
    out = {}
    for label, axes, remat in TRAIN_MESHES:
        config = tiny_config(remat=remat)
        plan = MeshPlan(make_mesh(axes, mesh_devices(axes, devices)))
        placed = plan.put(bridge.params_from_numpy(weights, config,
                                                   device="cpu"),
                          llama.partition_specs(config))
        for leaf in placed.tensors():
            leaf.requires_grad_(True)
        step = tt.make_train_step(config, plan)
        placed, _, loss = step(placed, tt.PlacedOptimizer(tt.adamw(),
                                                          placed),
                               torch.from_numpy(train_batch()))
        out[label] = {"loss": float(loss), "params": {
            name: leaf.detach().numpy()
            for name, leaf in flatten(plan.gather(placed)).items()}}
    return out


DECODE_STEPS = 3


def decode_config():
    from aiko_services_tpu_torch.models import llama
    return dataclasses.replace(llama.LlamaConfig.tiny(512, 64),
                               dtype="float32", attention="flash",
                               kv_dtype="int8")


def decode_prompts() -> list[torch.Tensor]:
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(0, 512, n)) for n in (5, 23, 9)]


def placed_decode(params, config, steps: int = DECODE_STEPS,
                  device="cpu") -> dict:
    """Each prompt through ``prefill_into_slot`` into one cache (placed
    by ``cache_specs`` for a placed tree), then ``steps`` greedy
    ``decode_step`` calls -> the logits and tokens."""
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.parallel import MeshPlan, Placed
    prompts = [prompt.to(device) for prompt in decode_prompts()]
    cache = llama.init_cache(config, len(prompts), device=device)
    if isinstance(params, Placed):
        cache = MeshPlan(params.mesh).put(cache, llama.cache_specs(config))
    out = {"prefill": [], "steps": [], "tokens": []}
    with torch.no_grad():
        first = []
        for slot, prompt in enumerate(prompts):
            logits, cache = llama.prefill_into_slot(
                params, config, prompt[None], cache, slot, 0)
            out["prefill"].append(logits[0].cpu())
            first.append(int(logits[0, -1].argmax()))
        tokens = torch.tensor(first, device=device)
        lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                               device=device)
        for _ in range(steps):
            logits, cache = llama.decode_step(params, config, tokens, cache,
                                              lengths)
            out["steps"].append(logits.cpu())
            tokens = logits.argmax(-1)
            out["tokens"].append(tokens.cpu())
            lengths = lengths + 1
    return out


def decode(devices=None) -> dict:
    """The int8 tree placed over ``{"tp": 2}``, position 0 in process 0
    and position 1 in process 1 (or on ``devices``)."""
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                      quantize_specs)
    from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh
    config = decode_config()
    params = quantize_params(llama.init_params(0, config, device="cpu"))
    axes = {"tp": 2}
    plan = MeshPlan(make_mesh(axes, mesh_devices(axes, devices)))
    placed = plan.put(params, quantize_specs(llama.partition_specs(config)))
    return placed_decode(placed, config)


def _stage(name: str, placement: dict) -> dict:
    return {"name": name, "input": [{"name": "x"}],
            "output": [{"name": "x"}],
            "parameters": {"busy_ms": 1.0, "factor": 2.0},
            "placement": placement,
            "deploy": {"local": {"module":
                                 "aiko_services_tpu_torch.elements.common",
                                 "class_name": "StageWork"}}}


def pipeline_definition(mesh: dict, devices: int) -> dict:
    """``(det llm)`` of ``StageWork`` (``tests/test_data_plane.py``'s
    mesh-mode pipeline), ``det`` on host 0, ``llm`` on host 1."""
    return {"version": 0, "name": "p_mesh", "runtime": "torch",
            "graph": ["(det llm)"], "parameters": {"mesh": mesh},
            "elements": [_stage("det", {"devices": devices}),
                         _stage("llm", {"devices": devices, "host": 1})]}


def serve_frames(definition: dict, frames: int = 4,
                 host_frames: bool = False, frame_shape=(8, 8)) -> dict:
    """Build the pipeline on the port's loopback runtime and post
    ``frames`` frames of ones -> the placement's carve and every
    response (okay, its frame id, its ``x``: a tensor or the handle's
    text)."""
    import queue
    from aiko_services_tpu_torch.pipeline import Pipeline
    from aiko_services_tpu_torch.pipeline.tensor import RemoteValue
    from aiko_services_tpu_torch.runtime import init_process, reset_process
    from aiko_services_tpu_torch.services.share import reset_services_cache
    from aiko_services_tpu_torch.transport import reset_broker
    reset_broker()
    reset_services_cache()
    runtime = init_process(transport="loopback")
    runtime.initialize()
    try:
        pipeline = Pipeline(definition, runtime=runtime)
        placement = pipeline.stage_placement
        responses = queue.Queue()
        # A tensor frame: a hop moves tensor leaves, and only tensors
        # cross hosts.  A numpy frame stays a host value (``host_frames``),
        # and so is ``det``'s output: its hop to ``llm`` fails the frame
        # (and, as any frame error does, ends the stream).
        x = np.ones(frame_shape, dtype=np.float32) if host_frames \
            else torch.ones(frame_shape, dtype=torch.float32)
        for _ in range(frames):
            pipeline.process_frame_local({"x": x}, stream_id="s",
                                         queue_response=responses)
        rows = []

        def drained():
            while not responses.empty():
                rows.append(responses.get())
            return len(rows) >= frames
        begin = time.perf_counter()
        runtime.run(until=drained, timeout=120.0)
        seconds = time.perf_counter() - begin
        pipeline.stop()

        def shown(value):
            if isinstance(value, RemoteValue):
                return repr(value)
            if torch.is_tensor(value):
                return value.detach().cpu()
            return value
        return {"hosts": placement.hosts,
                "host_groups": [[repr(d) for d in group]
                                for group in placement.host_groups],
                "stage_hosts": dict(placement.stage_hosts),
                "same_host": placement.same_host("det", "llm"),
                "stats_stage_hosts": placement.stats["stage_hosts"],
                "seconds": seconds,
                "rows": [{"frame": row[1], "okay": row[4],
                          "diagnostic": row[5], "x": shown(row[2].get("x"))}
                         for row in rows]}
    finally:
        runtime.engine.terminate()
        reset_process()
        reset_services_cache()
        reset_broker()


def pipeline(coordinator: str, process: int, hosts: int,
             host_frames: bool = False) -> dict:
    """The ``(det llm)`` pipeline over ``mesh: {hosts, coordinator,
    process_id}``: the pipeline's own bring-up (a second call of
    ``ensure`` returns the first's)."""
    from aiko_services_tpu_torch import device as device_rule
    local = len(device_rule.local_devices())
    return serve_frames(pipeline_definition(
        {"hosts": hosts, "coordinator": coordinator, "process_id": process},
        local), frames=1 if host_frames else 4, host_frames=host_frames)


def bringup(coordinator: str, process: int, hosts: int) -> dict:
    """What the bring-up gives: ``ensure_distributed``'s pair (twice),
    the pool, the transport and ``device_inventory()``."""
    from aiko_services_tpu_torch import device as device_rule
    from aiko_services_tpu_torch.parallel import device_inventory
    from aiko_services_tpu_torch.parallel import distributed
    from aiko_services_tpu_torch.pipeline.tensor import ensure_distributed
    spec = {"hosts": hosts, "coordinator": coordinator, "process_id": process}
    first = ensure_distributed(spec)
    return {"first": first, "second": ensure_distributed(spec),
            "virtual": ensure_distributed(None),
            "pool": [repr(d) for d in device_rule.devices()],
            "transport": distributed.transport(),
            "inventory": device_inventory()}


def lost_peer(coordinator: str, process: int, hosts: int) -> dict:
    """Process 1 exits before the collective; process 0 waits in it and
    must raise -> how long it waited and what it raised."""
    from aiko_services_tpu_torch.parallel import mesh as m
    devices = mesh_devices({"dp": 2})
    mesh = m.make_mesh({"dp": 2}, devices)
    m.shard_map(lambda t: m.psum(t, "dp"), mesh, (m.P("dp"),), m.P())(
        torch.ones(2))                      # both processes: groups made
    if process == 1:
        os._exit(0)
    begin = time.monotonic()
    try:
        m.shard_map(lambda t: m.psum(t, "dp"), mesh, (m.P("dp"),), m.P())(
            torch.ones(2))
    except Exception as error:             # what the survivor raises
        return {"seconds": time.monotonic() - begin,
                "error": f"{type(error).__name__}: {error}"}
    return {"seconds": time.monotonic() - begin, "error": None}


# -- the continuous batcher across processes ---------------------------------

#: (label, axes): dp across the processes (the dryrun's serving layout),
#: and tp across them, one position a process.
BATCHER_MESHES = (("dp2-tp2", {"dp": 2, "tp": 2}), ("tp2", {"tp": 2}))
BATCHER_TOKENS = 8
#: (label, batcher options; ``recover_at``: a fault at that dispatch).
BATCHER_RUNS = (
    ("dense-4", dict(decode_block=4, inflight=2)),
    ("paged-1", dict(decode_block=1, kv_page_tokens=8)),
    ("loop-16", dict(decode_block_tokens=16)),
    ("loop-ngram-paged-16", dict(decode_block_tokens=16,
                                 speculative="ngram", spec_tokens=4,
                                 kv_page_tokens=8)),
    ("loop-recover-16", dict(decode_block_tokens=16, recover_at=2)))


def batcher_requests() -> list[tuple]:
    """Four (prompt, temperature) requests, two greedy and two at 0.8;
    the 23-token prompt spans two 16-token chunks."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 512, n).tolist(), 0.0 if index % 2 == 0
             else 0.8) for index, n in enumerate((5, 23, 9, 17))]


def serving_tree(weights: dict, axes: dict, devices=None):
    """``decode_config``'s int8 tree from the bridged ``weights``, placed
    over ``axes`` (:func:`mesh_devices`)."""
    from aiko_services_tpu_torch.models import bridge, llama
    from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                      quantize_specs)
    from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh
    config = decode_config()
    params = quantize_params(bridge.params_from_numpy(weights, config,
                                                      device="cpu"))
    plan = MeshPlan(make_mesh(axes, mesh_devices(axes, devices)))
    return plan.put(params, quantize_specs(llama.partition_specs(config)))


#: The CPU runs' batcher settings.
SMALL_BATCHER = dict(max_slots=2, max_seq=64, prefill_chunk=16,
                     sample_top_k=8)


def serve_batcher(placed, options: dict, config=None, requests=None,
                  settings=SMALL_BATCHER, device="cpu",
                  new_tokens: int = BATCHER_TOKENS,
                  block_replays: int = 0) -> dict:
    """One ``ContinuousBatcher`` run over ``placed`` with ``settings``,
    ``options`` and ``cache_put`` by the cache's specs on ``requests``
    (:func:`batcher_requests` and ``decode_config`` by default) -> every
    stream, the host state it ends with and, on the card, the run's
    launches and (``block_replays`` > 0) a loop block's device ms."""
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.batching import (ContinuousBatcher,
                                                         Request)
    from aiko_services_tpu_torch.parallel import MeshPlan
    config = config or decode_config()
    options = dict(options)
    recover_at = options.pop("recover_at", 0)
    dispatches = [0]

    def probe(point):
        dispatches[0] += 1
        if dispatches[0] == recover_at:
            raise RuntimeError(f"injected fault at dispatch {recover_at}")
    plan = MeshPlan(placed.mesh)
    specs = llama.paged_cache_specs(config) \
        if options.get("kv_page_tokens") else llama.cache_specs(config)
    batcher = ContinuousBatcher(
        placed, config, device=device,
        cache_put=lambda cache: plan.put(cache, specs),
        fault_probe=probe if recover_at else None, **settings, **options)
    streams = {}
    for index, (prompt, temperature) in enumerate(
            requests or batcher_requests()):
        rid = f"r{index}"
        streams[rid] = []
        batcher.submit(Request(
            rid, list(prompt), max_new_tokens=new_tokens,
            temperature=temperature,
            emit=lambda r, token, done: streams[r].append(token)))
    begin = time.perf_counter()
    for _ in range(1000):
        if not (batcher.pending or batcher.active_count
                or batcher.blocks_in_flight):
            break
        try:
            batcher.step()
        except RuntimeError:
            if not recover_at or batcher.recoveries:
                raise
            batcher.recover()
    cards = device != "cpu"
    if cards:
        for index in range(torch.cuda.device_count()):
            torch.cuda.synchronize(index)
    wall = time.perf_counter() - begin
    pages = batcher._pages
    out = {"streams": streams, "recoveries": batcher.recoveries,
           "speculative": batcher.speculative,
           "spec_probe_ratio": batcher.spec_probe_ratio,
           "device": str(batcher.device), "wall_s": wall,
           "tokens_per_s": batcher.tokens_emitted / wall,
           "ttft_ms": sorted(s["ttft_ms"]
                             for s in batcher.take_request_stats()),
           "host": {"slots": [None if r is None else r.request_id
                              for r in batcher.slots],
                    "lengths": batcher.lengths.tolist(),
                    "tokens_emitted": batcher.tokens_emitted,
                    "prefill_tokens": batcher.prefill_tokens,
                    "steps": batcher.steps,
                    "draft_tokens": batcher.draft_tokens,
                    "accepted_tokens": batcher.accepted_tokens,
                    "table": None if pages is None
                    else batcher._table_host.tolist(),
                    "leaked": 0 if pages is None else pages.leaked_pages(),
                    "prefix": None if pages is None
                    else [pages.prefix_hits, pages.prefix_lookups]}}
    if cards:
        from aiko_services_tpu_torch.ops import launch_counters
        out["launches"] = {name: getattr(wrapper, attr) for name,
                           (wrapper, attr) in launch_counters().items()
                           if getattr(wrapper, attr)}
    if batcher._loop is not None:
        out.update(captures=batcher._loop.captures,
                   replays=batcher._loop.replays,
                   capture_s=batcher._loop.capture_s,
                   blocks=batcher.blocks_dispatched)
        if cards and block_replays:
            # Every row idle: the block still runs each iteration's
            # kernels (masked), so its device time is a full block's.
            def replays():
                for _ in range(block_replays):
                    batcher._loop.run(batcher.cache)
            _, ms = _timed(replays)
            out["block_ms"] = ms / block_replays
    return out


def batcher(weights: dict, devices=None) -> dict:
    """Every run of ``BATCHER_RUNS`` over each of ``BATCHER_MESHES`` ->
    {"<mesh> <run>": :func:`serve_batcher`'s result}."""
    out = {}
    for mesh_label, axes in BATCHER_MESHES:
        placed = serving_tree(weights, axes, devices)
        for label, options in BATCHER_RUNS:
            out[f"{mesh_label} {label}"] = serve_batcher(placed, options)
    return out


def batcher_step(weights: dict) -> dict:
    """The batcher over ``{"tp": 2}`` across the processes, built and
    stepped once."""
    from aiko_services_tpu_torch.models.batching import (ContinuousBatcher,
                                                         Request)
    from aiko_services_tpu_torch.parallel import distributed
    placed = serving_tree(weights, {"tp": 2})
    built = ContinuousBatcher(placed, decode_config(), max_slots=2,
                              max_seq=64, prefill_chunk=16, device="cpu")
    built.submit(Request("r0", batcher_requests()[0][0], max_new_tokens=8))
    return {"spans": distributed.spans_processes(placed.mesh),
            "occupied": built.step(), "prefill_tokens":
            built.prefill_tokens, "device": str(built.device)}


#: The probe's ratio each process is made to report: alone, process 0
#: would choose draft and process 1 plain.
FORCED_RATIOS = (2.0, 0.5)


def spec_probe(weights: dict, process: int) -> dict:
    """``speculative="auto"`` over ``{"tp": 2}`` across the processes:
    the real probe runs (both arms, across the processes), then each
    process reports its ``FORCED_RATIOS`` entry in its place -> the
    ratio and mode the batcher took, and its streams."""
    from aiko_services_tpu_torch.models import batching as tb
    measure = tb.ContinuousBatcher._probe_ratio
    measured = []

    def forced(self):
        measured.append(measure(self))
        return FORCED_RATIOS[process]
    tb.ContinuousBatcher._probe_ratio = forced
    try:
        out = serve_batcher(serving_tree(weights, {"tp": 2}),
                            dict(decode_block_tokens=16,
                                 speculative="auto", spec_tokens=4))
    finally:
        tb.ContinuousBatcher._probe_ratio = measure
    out.update(forced=FORCED_RATIOS[process], measured=measured)
    return out


def capture_path(weights: dict) -> dict:
    """The capture path of the exchanges (``distributed.capturing``)
    over gloo between CPU tensors: ``{"tp": 2}`` across the processes,
    an eager ``decode_step`` (the warm-up that checks the layouts), the
    same step inside ``capturing`` (every ``psum`` and the logits' fetch
    from the layouts alone), ``replayed``, another eager step (the
    sequences still agree), then a step of another batch inside
    ``capturing``, whose layouts were never checked."""
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.parallel import MeshPlan, distributed
    config = decode_config()
    placed = serving_tree(weights, {"tp": 2})
    plan = MeshPlan(placed.mesh)
    cache = plan.put(llama.init_cache(config, 2, device="cpu"),
                     llama.cache_specs(config))
    tokens = torch.tensor([3, 7])
    lengths = torch.tensor([4, 9], dtype=torch.int32)
    out = {}
    with torch.no_grad():
        eager, cache = llama.decode_step(placed, config, tokens, cache,
                                         lengths)
        with distributed.capturing() as record:
            captured, cache = llama.decode_step(placed, config, tokens,
                                                cache, lengths)
        distributed.replayed(record)
        again, cache = llama.decode_step(placed, config, tokens, cache,
                                         lengths)
        out.update(eager=eager, captured=captured, again=again,
                   counts=sorted(record.counts.values()))
        wider = plan.put(llama.init_cache(config, 4, device="cpu"),
                         llama.cache_specs(config))
        try:
            with distributed.capturing():
                llama.decode_step(placed, config,
                                  torch.zeros(4, dtype=torch.long), wider,
                                  torch.zeros(4, dtype=torch.int32))
            out["unchecked"] = None
        except Exception as error:
            out["unchecked"] = f"{type(error).__name__}: {error}"
    return out


# -- the mixture-of-experts over ep across processes --------------------------

MOE_AXES = {"dp": 2, "tp": 2, "ep": 2}
#: The device orders of the MoE step: the dryrun's own (the global pool
#: in order: dp crosses the processes) and one where ep crosses them.
MOE_ORDERS = ("dp-across", "ep-across")


def moe_config():
    from aiko_services_tpu_torch.models import llama
    return dataclasses.replace(llama.LlamaConfig.tiny_moe(256, 64),
                               dtype="float32")


def moe_batch() -> np.ndarray:
    return np.random.default_rng(6).integers(0, 256, (8, 16)).astype(
        np.int32)


def moe_devices(order: str, devices=None) -> list:
    """The eight devices of ``MOE_AXES`` (positions in (dp, ep, tp)
    order) for ``order``; one process's ``devices`` as they stand."""
    from aiko_services_tpu_torch import device as device_rule
    if devices is not None:
        return list(devices)[:8]
    pool = device_rule.devices()
    if order == "dp-across":
        return mesh_devices(MOE_AXES)
    by_process = [[d for d in pool if device_rule.process_index(d) == p]
                  for p in range(2)]
    return [by_process[ep][dp * 2 + tp]
            for dp in range(2) for ep in range(2) for tp in range(2)]


def moe_ep(weights: dict, devices=None) -> dict:
    """The dryrun's ``[moe-ep]`` train step (``tiny_moe``, ``MOE_AXES``)
    from the bridged ``weights``, once in each of ``MOE_ORDERS`` ->
    {order: {"loss", "grads" and "params" (the gradient at the weights
    and the updated tree, gathered, numpy), "axes", "owners"}}."""
    from aiko_services_tpu_torch import device as device_rule
    from aiko_services_tpu_torch.models import bridge, llama
    from aiko_services_tpu_torch.models import train as tt
    from aiko_services_tpu_torch.models.checkpoint import flatten
    from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh
    config = moe_config()
    tokens = torch.from_numpy(moe_batch())
    out = {}

    def gathered(plan, tree) -> dict:
        return {name: leaf.detach().numpy()
                for name, leaf in flatten(plan.gather(tree)).items()}
    for order in MOE_ORDERS:
        plan = MeshPlan(make_mesh(MOE_AXES, moe_devices(order, devices)))
        placed = plan.put(bridge.params_from_numpy(weights, config,
                                                   device="cpu"),
                          llama.partition_specs(config))
        for leaf in placed.tensors():
            leaf.requires_grad_(True)
        _, grads = tt.value_and_grad(placed, config, tokens)
        step = tt.make_train_step(config, plan)
        placed, _, loss = step(placed, tt.PlacedOptimizer(tt.adamw(),
                                                          placed), tokens)
        out[order] = {
            "loss": float(loss), "grads": gathered(plan, grads),
            "params": gathered(plan, placed),
            "axes": dict(plan.mesh.shape),
            "owners": [device_rule.process_index(d)
                       for d in plan.mesh.devices.flat]}
    return out


# -- four cards: two processes of two cards each (NCCL) ----------------------

CARD_MESH = {"dp": 2, "tp": 2}
CARD_PROMPTS = (100, 1500, 700, 300)        # tokens, numpy seed 7
CARD_STEPS = 8
CARD_TRAIN_BATCH = (4, 512)
CARD_TRAIN_STEPS = 2


def _digest(tensor: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(tensor.detach().contiguous().view(torch.uint8)
                          .cpu().numpy().tobytes()).hexdigest()


def _timed(fn):
    """(fn's result, its ms: CUDA events on the current card)."""
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, begin.elapsed_time(end)


def card_decode(devices=None) -> dict:
    """Llama-3-8B int8 (flash, int8 cache, ``max_seq`` 2048, seed 0)
    placed over ``CARD_MESH``: each prompt into its slot, then
    ``CARD_STEPS`` greedy decode steps -> digests of every logits tensor,
    the tokens and the CUDA-event ms."""
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                      quantize_specs)
    from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh
    config = dataclasses.replace(llama.LlamaConfig.llama3_8b(), max_seq=2048,
                                 attention="flash", decode_attention="auto",
                                 kv_dtype="int8")
    plan = MeshPlan(make_mesh(CARD_MESH, mesh_devices(CARD_MESH, devices)))
    lead = plan.device
    params = quantize_params(llama.init_params(0, config, device=lead))
    placed = plan.put(params, quantize_specs(llama.partition_specs(config)))
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    prompts = [torch.from_numpy(rng.integers(0, config.vocab_size, n))
               .to(lead) for n in CARD_PROMPTS]
    cache = plan.put(llama.init_cache(config, len(prompts), device=lead),
                     llama.cache_specs(config))
    digests, tokens = [], []
    with torch.no_grad():
        def admit():
            nonlocal cache
            first = []
            for slot, prompt in enumerate(prompts):
                logits, cache = llama.prefill_into_slot(
                    placed, config, prompt[None], cache, slot, 0)
                digests.append(_digest(logits))
                first.append(logits[0, -1].argmax())
            return torch.stack(first)
        step, prefill_ms = _timed(admit)
        lengths = torch.tensor(CARD_PROMPTS, dtype=torch.int32, device=lead)

        def decode():
            nonlocal cache, step, lengths
            for _ in range(CARD_STEPS):
                logits, cache = llama.decode_step(placed, config, step,
                                                  cache, lengths)
                digests.append(_digest(logits))
                step = logits.argmax(-1)
                tokens.append(step.tolist())
                lengths = lengths + 1
        _, decode_ms = _timed(decode)
    return {"digests": digests, "tokens": tokens, "prefill_ms": prefill_ms,
            "decode_step_ms": decode_ms / CARD_STEPS}


def card_train(devices=None) -> dict:
    """Llama-3.2-1B (``max_seq`` 512, bf16, seed 0) over ``CARD_MESH``:
    ``CARD_TRAIN_STEPS`` steps of one batch (numpy seed 0) -> the losses,
    a checksum of the updated tree and the CUDA-event ms a step."""
    import hashlib
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models import train as tt
    from aiko_services_tpu_torch.models.checkpoint import flatten
    from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh
    config = dataclasses.replace(llama.LlamaConfig.llama3_1b(), max_seq=512)
    plan = MeshPlan(make_mesh(CARD_MESH, mesh_devices(CARD_MESH, devices)))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, config.vocab_size, CARD_TRAIN_BATCH)).to(plan.device)
    params, state, _ = tt.init_train_state(0, config, plan)
    step = tt.make_train_step(config, plan)
    losses, times = [], []
    for _ in range(CARD_TRAIN_STEPS):
        (params, state, loss), ms = _timed(
            lambda: step(params, state, tokens))
        losses.append(float(loss))
        times.append(ms)
    digest = hashlib.sha256()
    for name, leaf in sorted(flatten(plan.gather(params)).items()):
        digest.update(name.encode())
        digest.update(leaf.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    return {"losses": losses, "checksum": digest.hexdigest(),
            "step_ms": times}


#: The batcher on four cards: (mesh label, run label, options).  dp2-tp2
#: puts dp across the processes (two cards each), tp2 one card of each
#: process (so every layer's ``psum`` crosses them).
CARD_BATCHER_RUNS = (
    ("dp2-tp2", "dense-4", dict(decode_block=4, inflight=2)),
    ("dp2-tp2", "paged-1", dict(decode_block=1, kv_page_tokens=64)),
    ("dp2-tp2", "loop-16", dict(decode_block_tokens=16)),
    ("dp2-tp2", "loop-ngram-paged-16",
     dict(decode_block_tokens=16, speculative="ngram", spec_tokens=4,
          kv_page_tokens=64)),
    ("tp2", "loop-16", dict(decode_block_tokens=16)))
CARD_BATCHER_TOKENS = 8
CARD_BLOCK_REPLAYS = 3


def card_config(width: str = "full"):
    """Llama-3-8B int8 (flash, int8 cache, ``max_seq`` 2048), or at
    ``width`` "small" a dim-256 two-layer int8 Llama with kernel-sized
    heads (``max_seq`` 1024): the quick check of the same path."""
    from aiko_services_tpu_torch.models import llama
    if width == "small":
        return dataclasses.replace(
            llama.LlamaConfig(vocab_size=256, dim=256, n_layers=2,
                              n_heads=4, n_kv_heads=2, hidden_dim=512,
                              max_seq=1024, rope_theta=10_000.0),
            attention="flash", kv_dtype="int8")
    return dataclasses.replace(llama.LlamaConfig.llama3_8b(), max_seq=2048,
                               attention="flash", decode_attention="auto",
                               kv_dtype="int8")


def card_requests(config) -> list[tuple]:
    """Four requests (numpy seed 7; ``CARD_PROMPTS`` tokens, 40-300 at
    the small width), even ones greedy, odd ones at 0.8."""
    rng = np.random.default_rng(7)
    lengths = CARD_PROMPTS if config.max_seq > 1024 else (40, 300, 120, 260)
    return [(rng.integers(0, config.vocab_size, n).tolist(),
             0.0 if index % 2 == 0 else 0.8)
            for index, n in enumerate(lengths)]


def card_mesh(label: str, devices=None):
    """The mesh of ``label``: over the processes' cards, or over one
    process's ``devices`` (the same four cards, in the same order)."""
    from aiko_services_tpu_torch import device as device_rule
    from aiko_services_tpu_torch.parallel import make_mesh
    if label == "dp2-tp2":
        return make_mesh(CARD_MESH, mesh_devices(CARD_MESH, devices))
    if devices is not None:
        return make_mesh({"tp": 2}, [devices[0], devices[2]])
    pool = device_rule.devices()
    return make_mesh({"tp": 2}, [next(d for d in pool if
                                      device_rule.process_index(d) == p)
                                 for p in range(2)])


def card_batcher(devices=None, width: str = "full") -> dict:
    """Each run of ``CARD_BATCHER_RUNS`` (4 slots for the four requests,
    512-token chunks, top-k 50, ``CARD_BATCHER_TOKENS`` new tokens),
    launch counters zeroed before each -> {"<mesh> <run>":
    streams, host state, tokens/s, launches, captures and replays, and a
    loop block's device ms (CUDA events over ``CARD_BLOCK_REPLAYS``
    replays after the run, on the batcher's card)}."""
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.quant import (quantize_params,
                                                      quantize_specs)
    from aiko_services_tpu_torch.ops import launch_counters
    from aiko_services_tpu_torch.parallel import MeshPlan
    config = card_config(width)
    requests = card_requests(config)
    settings = dict(max_slots=4, prefill_chunk=512 if width == "full"
                    else 256, sample_top_k=50)
    params = quantize_params(llama.init_params(0, config, device="cuda"))
    out = {}
    for mesh_label in dict.fromkeys(row[0] for row in CARD_BATCHER_RUNS):
        plan = MeshPlan(card_mesh(mesh_label, devices))
        placed = plan.put(params, quantize_specs(
            llama.partition_specs(config)))
        for label, run, options in CARD_BATCHER_RUNS:
            if label != mesh_label:
                continue
            counters = launch_counters()
            for wrapper, attr in counters.values():
                setattr(wrapper, attr, 0)
            got = serve_batcher(placed, options, config, requests,
                                settings, device=None,
                                new_tokens=CARD_BATCHER_TOKENS,
                                block_replays=CARD_BLOCK_REPLAYS)
            out[f"{mesh_label} {run}"] = got
        del placed
        torch.cuda.empty_cache()
    return out


CARD_MOE_MESH = {"ep": 2, "tp": 2}
CARD_MOE_BATCH = (2, 512)
CARD_MOE_STEPS = 3


def card_moe(devices=None) -> dict:
    """The 4-expert MoE at Llama-3.2-1B widths (top-2, capacity factor
    2.0, ``max_seq`` 512, remat, bf16, seed 0) over ``CARD_MOE_MESH``, ep
    across the processes: ``CARD_MOE_STEPS`` steps of one batch (numpy
    seed 0) -> the losses, a checksum of the updated tree and the
    CUDA-event ms a step."""
    import hashlib
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models import train as tt
    from aiko_services_tpu_torch.models.checkpoint import flatten
    from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh
    config = dataclasses.replace(llama.LlamaConfig.llama3_1b(), n_experts=4,
                                 max_seq=512, attention="flash",
                                 decode_attention="flash", remat=True)
    plan = MeshPlan(make_mesh(CARD_MOE_MESH,
                              mesh_devices(CARD_MOE_MESH, devices)))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, config.vocab_size, CARD_MOE_BATCH)).to(plan.device)
    params, state, _ = tt.init_train_state(0, config, plan)
    step = tt.make_train_step(config, plan)
    losses, times = [], []
    for _ in range(CARD_MOE_STEPS):
        (params, state, loss), ms = _timed(
            lambda: step(params, state, tokens))
        losses.append(float(loss))
        times.append(ms)
    digest = hashlib.sha256()
    for name, leaf in sorted(flatten(plan.gather(params)).items()):
        digest.update(name.encode())
        digest.update(leaf.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    return {"losses": losses, "checksum": digest.hexdigest(),
            "step_ms": times}


def card_pipeline(coordinator: str | None, process: int) -> dict:
    """``(det llm)`` with two cards a stage: across the two processes
    (``coordinator`` set) or the virtual carve of one process's four
    cards (None)."""
    mesh = {"hosts": 2} if coordinator is None else {
        "hosts": 2, "coordinator": coordinator, "process_id": process}
    return serve_frames(pipeline_definition(mesh, 2), frame_shape=(1024,
                                                                   1024))


def _weights(path: str, name: str) -> dict:
    return torch.load(path, weights_only=False)[name]


CASES = {"collectives": lambda c, p, h, a: collectives(),
         "train": lambda c, p, h, a: train(_weights(a, "train")),
         "batcher": lambda c, p, h, a: batcher(_weights(a, "serving")),
         "batcher_step": lambda c, p, h, a: batcher_step(
             _weights(a, "serving")),
         "spec_probe": lambda c, p, h, a: spec_probe(_weights(a, "serving"),
                                                     p),
         "capture_path": lambda c, p, h, a: capture_path(
             _weights(a, "serving")),
         "moe_ep": lambda c, p, h, a: moe_ep(_weights(a, "moe")),
         "decode": lambda c, p, h, a: decode(),
         "pipeline": lambda c, p, h, a: pipeline(c, p, h),
         "pipeline_host": lambda c, p, h, a: pipeline(c, p, h, True),
         "bringup": lambda c, p, h, a: bringup(c, p, h),
         "lost_peer": lambda c, p, h, a: lost_peer(c, p, h),
         "card_decode": lambda c, p, h, a: card_decode(),
         "card_train": lambda c, p, h, a: card_train(),
         "card_pipeline": lambda c, p, h, a: card_pipeline(c, p),
         "card_batcher": lambda c, p, h, a: card_batcher(),
         "card_batcher_small": lambda c, p, h, a: card_batcher(
             width="small"),
         "card_moe": lambda c, p, h, a: card_moe()}


def main() -> None:
    names, process, hosts, coordinator, out = sys.argv[1:6]
    argument = sys.argv[6] if len(sys.argv) > 6 else ""
    process, hosts = int(process), int(hosts)
    from aiko_services_tpu_torch.parallel import distributed
    results: dict = {}
    failed = False
    try:
        if names.split(",")[0] != "bringup":   # that case brings up
            distributed.ensure(hosts, coordinator, process)
        for name in names.split(","):
            results[name] = CASES[name](coordinator, process, hosts,
                                        argument)
        distributed.shutdown()
    except Exception:
        results["error"] = traceback.format_exc()
        failed = True
    torch.save(results, Path(out) / f"{process}.pt")
    sys.stdout.flush()
    os._exit(1 if failed else 0)


if __name__ == "__main__":
    main()
