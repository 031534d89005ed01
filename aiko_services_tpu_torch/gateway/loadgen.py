"""Open-loop load generator for the gateway (ISSUE 12 satellite).

Drives mixed-tenant traffic at FIXED arrival rates against a running
:class:`~.server.GatewayServer`: one WebSocket session per traffic
spec, a sender thread that ships frames on the open-loop schedule
(``start + i/rate`` -- it never waits for completions, so queueing
delay shows up as latency instead of silently throttling the offered
load, the classic closed-loop benchmarking mistake), and a receiver
thread that tallies results, rejections and backpressure.

Latencies come from the gateway's own ``e2e_ms`` stamp (admission ->
result, the server-side view of the session SLO); per-class p50/p99,
goodput (ok results / wall), and shed/reject counts aggregate across
sessions.  Reused by ``bench_pipeline_gateway``, the ``loadgen`` CLI
command, and the overload fairness tests.
"""

from __future__ import annotations

import threading
import time

from .client import GatewayClient
from . import ws

__all__ = ["run_loadgen", "LoadSpec"]


class LoadSpec:
    """One tenant's traffic: ``rate`` frames/s open-loop for
    ``frames`` frames, under ``qos_class`` with an optional per-frame
    ``deadline_ms``.  ``data`` is the frame payload (dict) or a
    callable ``(index) -> dict``."""

    def __init__(self, tenant: str, qos_class: str, rate: float,
                 frames: int, data=None, deadline_ms: float = 0.0,
                 window: int | None = None, session: str | None = None):
        self.tenant = tenant
        self.qos_class = qos_class
        self.rate = float(rate)
        self.frames = int(frames)
        self.data = data if data is not None else {"x": 1.0}
        self.deadline_ms = float(deadline_ms)
        self.window = window
        self.session = session or f"lg-{tenant}-{qos_class}"


def _blank_bucket() -> dict:
    return {"sent": 0, "ok": 0, "errors": 0, "shed": 0, "deadline": 0,
            "rejected": 0, "busy": 0, "latencies_ms": []}


def _merge_result(bucket: dict, message: dict) -> None:
    if message.get("ok"):
        bucket["ok"] += 1
        bucket["latencies_ms"].append(float(message.get("e2e_ms", 0.0)))
    else:
        bucket["errors"] += 1
        diagnostic = str(message.get("diagnostic", ""))
        if "shed" in diagnostic:
            bucket["shed"] += 1
        elif "deadline" in diagnostic:
            bucket["deadline"] += 1


def _quantile(values: list, q: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    index = min(len(ordered) - 1, int(q * len(ordered)))
    return ordered[index]


def _drive(host: str, port: int, spec: LoadSpec, bucket: dict,
           errors: list) -> None:
    try:
        client = GatewayClient(host, port)
        client.open(session=spec.session, tenant=spec.tenant,
                    qos_class=spec.qos_class,
                    deadline_ms=spec.deadline_ms or None,
                    window=spec.window)
    except Exception as error:
        errors.append(f"{spec.tenant}: open failed: {error}")
        return
    done = threading.Event()
    outstanding = {"count": 0}
    lock = threading.Lock()

    def receive():
        while True:
            try:
                message = client.recv(timeout=30.0)
            except (ws.WsClosed, OSError):
                return
            op = message.get("op")
            with lock:
                if op == "result":
                    _merge_result(bucket, message)
                    outstanding["count"] -= 1
                elif op == "rejected":
                    bucket["rejected"] += 1
                    outstanding["count"] -= 1
                elif op == "busy":
                    bucket["busy"] += 1
                    outstanding["count"] -= 1
                else:
                    continue
                if done.is_set() and outstanding["count"] <= 0:
                    return

    receiver = threading.Thread(target=receive, daemon=True,
                                name=f"loadgen-recv-{spec.tenant}")
    receiver.start()
    start = time.monotonic()
    for index in range(spec.frames):
        due = start + index / spec.rate if spec.rate > 0 else start
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        payload = spec.data(index) if callable(spec.data) \
            else dict(spec.data)
        with lock:
            bucket["sent"] += 1
            outstanding["count"] += 1
        try:
            client.send_frame(payload)
        except OSError as error:
            errors.append(f"{spec.tenant}: send failed: {error}")
            break
    done.set()
    receiver.join(timeout=60.0)
    client.close()


def run_loadgen(host: str, port: int, specs: list) -> dict:
    """Run every spec concurrently; -> per-class and per-tenant
    aggregates with p50/p99 latency, goodput and shed/reject counts."""
    buckets = [_blank_bucket() for _ in specs]
    errors: list = []
    started = time.monotonic()
    threads = [threading.Thread(target=_drive,
                                args=(host, port, spec, bucket, errors),
                                daemon=True,
                                name=f"loadgen-{spec.tenant}")
               for spec, bucket in zip(specs, buckets)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=300.0)
    wall_s = max(1e-9, time.monotonic() - started)

    def aggregate(group_of) -> dict:
        groups: dict = {}
        for spec, bucket in zip(specs, buckets):
            entry = groups.setdefault(group_of(spec), _blank_bucket())
            for key, value in bucket.items():
                if key == "latencies_ms":
                    entry[key] = entry[key] + value
                else:
                    entry[key] += value
        result = {}
        for name, entry in groups.items():
            latencies = entry.pop("latencies_ms")
            entry["p50_ms"] = round(_quantile(latencies, 0.50), 3)
            entry["p99_ms"] = round(_quantile(latencies, 0.99), 3)
            entry["goodput_fps"] = round(entry["ok"] / wall_s, 3)
            result[name] = entry
        return result

    return {"wall_s": round(wall_s, 3),
            "classes": aggregate(lambda spec: spec.qos_class),
            "tenants": aggregate(lambda spec: spec.tenant),
            "errors": errors}
