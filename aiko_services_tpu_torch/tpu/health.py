"""Chip health checks (SURVEY.md §5.3 TPU-equiv note: the reference
detects *process* death via MQTT last-will (reference
registrar.py:235-239); a TPU stage can also lose *chips* while its
process stays alive -- XLA raises on the next dispatch.  This module
probes devices directly so the pipeline can re-place stages onto
survivors before a frame hits the dead chip).

Counterpart of ``aiko_services_tpu/tpu/health.py``: on the card a lost
device raises on the next launch or copy instead of XLA's next dispatch.

``probe_devices`` runs a trivial round-trip on every device and returns
the ones that fail.  Probes run on abandoned-on-timeout daemon threads
so a *hung* chip counts as failed after ``timeout`` seconds instead of
freezing the event engine.  The prober is injectable: tests (and exotic
deployments) substitute a fake; the default is a one-element upload and
fetch.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

import torch

from ..device import card_of, sync_allowed
from ..utils import get_logger

__all__ = ["probe_devices", "default_prober"]

_logger = get_logger("aiko.health")

PROBE_TIMEOUT = 5.0


def default_prober(device) -> bool:
    """True when the device (a pool entry: a :class:`~..device.PoolSlot`
    probes its card) completes a host->device->host round trip.  The
    fetch is a planned wait: it runs with the synchronisation guard
    lifted (``device.sync_allowed``)."""
    try:
        with sync_allowed():
            value = torch.zeros((), dtype=torch.float32).to(
                card_of(device))
            float(value.cpu())
        return True
    except Exception:
        _logger.exception("device %s failed health probe", device)
        return False


def probe_devices(devices: Sequence, prober: Callable | None = None,
                  timeout: float | None = None) -> list:
    """Probe every device; returns the list that FAILED.

    Probes run concurrently on a worker pool with a deadline, so the
    caller (usually the single-threaded event engine) blocks for at most
    ~``timeout`` even when a chip *hangs* instead of erroring -- a hung
    probe counts as failed.  The worker servicing a truly hung transfer
    is abandoned (daemon thread), never joined on.

    ``timeout=None`` uses :data:`PROBE_TIMEOUT`; pipelines plumb their
    ``health_probe_timeout`` parameter through here
    (``Pipeline.check_device_health``), so deployments with slow links
    (TPU tunnels) or tight failover SLOs tune it without patching."""
    prober = prober or default_prober
    timeout = PROBE_TIMEOUT if timeout is None else float(timeout)
    devices = list(devices)
    if not devices:
        return []
    results: dict[int, bool] = {}

    def run(index, device):
        try:
            results[index] = bool(prober(device))
        except Exception:
            _logger.exception("device %s prober raised", device)
            results[index] = False

    threads = []
    for index, device in enumerate(devices):
        thread = threading.Thread(target=run, args=(index, device),
                                  daemon=True,
                                  name=f"aiko.health.probe.{index}")
        thread.start()
        threads.append(thread)
    deadline = time.monotonic() + timeout
    for thread in threads:
        thread.join(timeout=max(0.0, deadline - time.monotonic()))
    failed = []
    for index, device in enumerate(devices):
        healthy = results.get(index)
        if healthy is None:
            _logger.error("device %s health probe hung (> %.1fs)",
                          device, timeout)
            failed.append(device)
        elif not healthy:
            failed.append(device)
    return failed
