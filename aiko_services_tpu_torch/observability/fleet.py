"""Fleet metrics federation + cross-process trace assembly (ISSUE 19).

One process's telemetry answers "what is THIS pipeline doing"; a
placed, replicated, failing-over fleet needs the union.  The
:class:`FleetCollector` is that union, built on the machinery the repo
already has instead of a parallel config plane:

- **Discovery IS membership.**  Every pipeline that binds a telemetry
  endpoint advertises it as a registrar tag (``metrics=host:port``,
  bound pre-registration exactly like ``tensor_pipe=`` and
  ``gateway=``), so the collector's member set is the registrar's
  pipeline records -- no static scrape config, and LWT-driven removal
  means a killed process leaves the member set the same way it leaves
  every other plane.
- **Exact merge, not quantile-of-quantiles.**  Members are scraped at
  ``/metrics/raw`` (:meth:`MetricsRegistry.state`): raw
  :class:`LogHistogram` bucket counts.  Every histogram in the fleet
  shares the same fixed log-scale edges, so the cross-process merge is
  element-wise addition and the fleet p99 carries exactly the same
  bucketing error as a single process's p99.  Merging the TEXT
  exposition's quantiles instead would be wrong in general (quantiles
  do not compose).
- **Counters are monotonic across death and adoption** (the PR 10
  stale-same-id discipline, applied fleet-wide).  Each member's
  counters are folded per incarnation: a scraped value SMALLER than
  the previous one means the process restarted, so the previous total
  is banked into a base and the exposed value is ``base + current``.
  A member that dies keeps its banked totals in the aggregate -- its
  frames happened; adoption moving its streams to a survivor must not
  make fleet counters go backwards.

Served surfaces (mounted on the gateway under ``/fleet*`` when one is
attached, rendered by ``python -m aiko_services_tpu_torch fleet`` otherwise):
``/fleet`` -- Prometheus exposition, per-member rows labeled
``pipeline=...`` plus unlabeled fleet-aggregate rows; ``/fleet/slo`` --
per-tenant/class error-budget burn; ``/fleet/traces/<id>`` -- one trace
assembled from every member holding spans for it (a door-to-decode
trace crosses processes by construction).

Import discipline: stdlib only (json/threading/urllib), jax-free, like
the rest of ``observability/`` -- a standalone collector must not drag
an accelerator runtime into a monitoring process.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

from .metrics import (LogHistogram, MetricsRegistry, _labels_key,
                      _labels_text)
from ..utils import get_logger

__all__ = ["FleetCollector", "FLEET_SCRAPE_MS_DEFAULT"]

_logger = get_logger("aiko.fleet")

FLEET_SCRAPE_MS_DEFAULT = 1000.0     # ms between scrape sweeps
_SCRAPE_TIMEOUT_S = 2.0


class _Member:
    """One scraped process: its latest raw state plus the banked
    totals of every previous incarnation (see module docstring)."""

    def __init__(self, name: str, endpoint: str | None):
        self.name = name
        self.endpoint = endpoint        # "host:port"; None = in-process
        self.alive = True
        self.scrapes = 0
        self.errors = 0
        self.last_scrape: float | None = None
        # (series name, labels key) -> latest scraped histogram state /
        # counter value / gauge value for the CURRENT incarnation.
        self.histograms: dict[tuple, dict] = {}
        self.counters: dict[tuple, float] = {}
        self.gauges: dict[tuple, float] = {}
        # Banked dead-incarnation totals (never shrink).
        self.hist_base: dict[tuple, LogHistogram] = {}
        self.counter_base: dict[tuple, float] = {}
        self.labels: dict[tuple, dict] = {}

    def fold(self, payload: dict) -> None:
        """Fold one scrape in, banking the previous incarnation when
        any series went BACKWARDS (the restart signature)."""
        for entry in payload.get("histograms") or []:
            key = (str(entry.get("name")),
                   _labels_key(entry.get("labels")))
            self.labels[key] = dict(entry.get("labels") or {})
            last = self.histograms.get(key)
            if last is not None and \
                    int(entry.get("count", 0)) < int(last.get("count", 0)):
                self._bank_histogram(key, last)
            self.histograms[key] = entry
        for entry in payload.get("counters") or []:
            key = (str(entry.get("name")),
                   _labels_key(entry.get("labels")))
            self.labels[key] = dict(entry.get("labels") or {})
            value = float(entry.get("value") or 0.0)
            last = self.counters.get(key, 0.0)
            if value < last:
                self.counter_base[key] = \
                    self.counter_base.get(key, 0.0) + last
            self.counters[key] = value
        gauges: dict[tuple, float] = {}
        for entry in payload.get("gauges") or []:
            key = (str(entry.get("name")),
                   _labels_key(entry.get("labels")))
            self.labels[key] = dict(entry.get("labels") or {})
            try:
                gauges[key] = float(entry.get("value"))
            except (TypeError, ValueError):
                continue
        self.gauges = gauges
        self.scrapes += 1
        self.last_scrape = time.monotonic()

    def _bank_histogram(self, key: tuple, state: dict) -> None:
        base = self.hist_base.get(key)
        if base is None:
            base = self.hist_base[key] = LogHistogram()
        base.merge_state(state)

    def retire(self) -> None:
        """The member's process died (LWT): bank the current
        incarnation so the aggregate keeps everything it ever counted,
        then stop scraping it.  Gauges are instantaneous -- a dead
        process HAS no queue depth -- so they drop."""
        for key, state in self.histograms.items():
            self._bank_histogram(key, state)
        self.histograms = {}
        for key, value in self.counters.items():
            self.counter_base[key] = \
                self.counter_base.get(key, 0.0) + value
        self.counters = {}
        self.gauges = {}
        self.alive = False

    # -- effective (base + current) views ----------------------------------

    def histogram_keys(self) -> set:
        return set(self.histograms) | set(self.hist_base)

    def counter_keys(self) -> set:
        return set(self.counters) | set(self.counter_base)

    def effective_histogram(self, key: tuple) -> LogHistogram:
        merged = LogHistogram()
        base = self.hist_base.get(key)
        if base is not None:
            merged.merge_state(base.state())
        state = self.histograms.get(key)
        if state is not None:
            merged.merge_state(state)
        return merged

    def effective_counter(self, key: tuple) -> float:
        return self.counter_base.get(key, 0.0) \
            + self.counters.get(key, 0.0)


class FleetCollector:
    """Registrar-discovered scraper + exact merger (see module doc).

    ``runtime``  -- service fabric for registrar discovery (optional:
                    tests drive static ``members`` directly);
    ``members``  -- static ``host:port`` scrape targets (additive);
    ``local``    -- an in-process Pipeline scraped with zero HTTP (the
                    in-gateway deployment shape);
    ``scrape_ms``-- sweep interval for the background thread
                    (``start``); 0 disables the thread (callers drive
                    ``scrape_once``)."""

    def __init__(self, runtime=None,
                 scrape_ms: float = FLEET_SCRAPE_MS_DEFAULT,
                 members=None, local=None, name: str = "fleet"):
        self.runtime = runtime
        self.local = local
        self.name = name
        self.scrape_ms = float(scrape_ms or 0.0)
        self.registry = MetricsRegistry()   # the collector's own plane
        self._members: dict[str, _Member] = {}
        self._lock = threading.Lock()
        self._discovery = None
        self._thread: threading.Thread | None = None
        self._stopped = threading.Event()
        for endpoint in members or ():
            endpoint = str(endpoint)
            self._members[endpoint] = _Member(endpoint, endpoint)
        if local is not None:
            local_name = str(getattr(local, "name", "local"))
            self._members[local_name] = _Member(local_name, None)

    # -- membership (registrar discovery) ----------------------------------

    def start(self) -> None:
        if self.runtime is not None and self._discovery is None:
            # Deferred: pipeline imports stay out of a bare collector.
            from ..pipeline.pipeline import PROTOCOL_PIPELINE
            from ..services import ServiceFilter, do_discovery
            self._discovery = do_discovery(
                self.runtime, ServiceFilter(protocol=PROTOCOL_PIPELINE),
                add_handler=self._on_found,
                remove_handler=self._on_lost)
        if self.scrape_ms > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._scrape_loop, daemon=True,
                name="fleet-scrape")
            self._thread.start()

    def stop(self) -> None:
        self._stopped.set()
        if self._discovery is not None:
            self._discovery.terminate()
            self._discovery = None

    def _on_found(self, record, proxy=None) -> None:
        from ..services import ServiceTags
        endpoint = ServiceTags.get(record.tags, "metrics") \
            or ServiceTags.get(record.tags, "gateway")
        if endpoint is None:
            return                  # member exports nothing scrapable
        name = str(record.name)
        if self.local is not None \
                and name == str(getattr(self.local, "name", None)):
            return                  # scraped in-process, no HTTP
        with self._lock:
            member = self._members.get(name)
            if member is None:
                self._members[name] = _Member(name, endpoint)
            else:
                # Same name back (rolling restart, adoption source
                # re-created): KEEP the banked bases -- that is the
                # monotonic contract -- and scrape the new endpoint.
                member.endpoint = endpoint
                member.alive = True
        _logger.info("fleet: member %s at %s", name, endpoint)

    def _on_lost(self, record, proxy=None) -> None:
        with self._lock:
            member = self._members.get(str(record.name))
            if member is not None and member.alive:
                member.retire()
        _logger.info("fleet: member %s retired (totals banked)",
                     record.name)

    # -- scraping ----------------------------------------------------------

    def _scrape_loop(self) -> None:
        interval = self.scrape_ms / 1000.0
        while not self._stopped.wait(interval):
            try:
                self.scrape_once()
            except Exception:
                _logger.exception("fleet scrape sweep failed")

    def scrape_once(self) -> int:
        """One sweep over every live member; returns the error count.
        HTTP happens OUTSIDE the lock (a slow member must not block
        /fleet renders); each member's fold is brief and locked."""
        with self._lock:
            targets = [member for member in self._members.values()
                       if member.alive]
        errors = 0
        for member in targets:
            payload = self._scrape_member(member)
            if payload is None:
                errors += 1
                member.errors += 1
                self.registry.count("fleet_scrape_errors",
                                    pipeline=member.name)
                continue
            with self._lock:
                member.fold(payload)
            self.registry.count("fleet_scrapes")
        with self._lock:
            live = sum(1 for m in self._members.values() if m.alive)
        self.registry.gauge("fleet_members", live)
        return errors

    def _scrape_member(self, member: _Member) -> dict | None:
        if member.endpoint is None:         # the in-process pipeline
            telemetry = getattr(self.local, "telemetry", None)
            if telemetry is None:
                return None
            try:
                telemetry.metrics_text()    # refresh gauge snapshot
                return telemetry.registry.state()
            except Exception:
                _logger.exception("fleet: local scrape failed")
                return None
        try:
            with urllib.request.urlopen(
                    f"http://{member.endpoint}/metrics/raw",
                    timeout=_SCRAPE_TIMEOUT_S) as reply:
                return json.loads(reply.read().decode())
        except Exception as error:
            _logger.warning("fleet: scrape of %s (%s) failed: %s",
                            member.name, member.endpoint, error)
            return None

    # -- merged views ------------------------------------------------------

    def members_snapshot(self) -> list[dict]:
        with self._lock:
            return [{"name": member.name,
                     "endpoint": member.endpoint or "(in-process)",
                     "alive": member.alive,
                     "scrapes": member.scrapes,
                     "errors": member.errors}
                    for member in self._members.values()]

    def merged_histogram(self, name: str,
                         labels: dict | None = None) -> LogHistogram:
        """The fleet-wide histogram for one series: every member's
        effective (banked + current) state added bucket-wise."""
        key = (name, _labels_key(labels))
        merged = LogHistogram()
        with self._lock:
            for member in self._members.values():
                if key in member.histogram_keys():
                    merged.merge_state(
                        member.effective_histogram(key).state())
        return merged

    def merged_quantile(self, name: str, q: float,
                        labels: dict | None = None) -> float | None:
        return self.merged_histogram(name, labels).quantile(
            q, windowed=False)

    def counter_value(self, name: str,
                      labels: dict | None = None) -> float:
        key = (name, _labels_key(labels))
        with self._lock:
            return sum(member.effective_counter(key)
                       for member in self._members.values()
                       if key in member.counter_keys())

    # -- /fleet exposition -------------------------------------------------

    def render_fleet_text(self, prefix: str = "aiko_") -> str:
        """Prometheus exposition of the merged fleet: per-member rows
        carry ``pipeline="..."``; aggregate rows carry no pipeline
        label (and for counters/histograms include banked dead-member
        totals -- the monotonic rows an alerting rule should watch).
        Gauges are instantaneous, so they render per-member only."""
        lines: list[str] = []
        with self._lock:
            members = list(self._members.values())
            hist_keys: dict[tuple, dict] = {}
            counter_keys: dict[tuple, dict] = {}
            for member in members:
                for key in member.histogram_keys():
                    hist_keys.setdefault(key, member.labels.get(key, {}))
                for key in member.counter_keys():
                    counter_keys.setdefault(key,
                                            member.labels.get(key, {}))
            seen_types: set[str] = set()
            for key in sorted(hist_keys):
                name, _ = key
                labels = hist_keys[key]
                full = prefix + name
                if full not in seen_types:
                    lines.append(f"# TYPE {full} summary")
                    seen_types.add(full)
                aggregate = LogHistogram()
                for member in members:
                    if key not in member.histogram_keys():
                        continue
                    effective = member.effective_histogram(key)
                    aggregate.merge_state(effective.state())
                    self._render_summary(
                        lines, full, effective,
                        dict(labels, pipeline=member.name))
                self._render_summary(lines, full, aggregate, labels)
            for key in sorted(counter_keys):
                name, _ = key
                labels = counter_keys[key]
                full = prefix + name
                if full not in seen_types:
                    lines.append(f"# TYPE {full} counter")
                    seen_types.add(full)
                total = 0.0
                for member in members:
                    if key not in member.counter_keys():
                        continue
                    value = member.effective_counter(key)
                    total += value
                    lines.append(
                        f"{full}"
                        f"{_labels_text(_labels_key(dict(labels, pipeline=member.name)))}"
                        f" {value:.6g}")
                lines.append(
                    f"{full}{_labels_text(_labels_key(labels))}"
                    f" {total:.6g}")
            for member in members:
                for key, value in sorted(member.gauges.items()):
                    name, _ = key
                    full = prefix + name
                    if full not in seen_types:
                        lines.append(f"# TYPE {full} gauge")
                        seen_types.add(full)
                    labels = dict(member.labels.get(key, {}),
                                  pipeline=member.name)
                    lines.append(
                        f"{full}{_labels_text(_labels_key(labels))}"
                        f" {value:.6g}")
        # The collector's own plane (scrapes/errors/members) rides the
        # same exposition -- rendered last, outside the member lock.
        own = self.registry.render_text(prefix)
        return "\n".join(lines) + "\n" + own

    @staticmethod
    def _render_summary(lines: list, full: str,
                        histogram: LogHistogram, labels: dict) -> None:
        for q in (0.5, 0.9, 0.99):
            value = histogram.quantile(q, windowed=False)
            if value is None:
                continue
            label_text = _labels_text(
                _labels_key(labels) + (("quantile", str(q)),))
            lines.append(f"{full}{label_text} {value:.6g}")
        label_text = _labels_text(_labels_key(labels))
        lines.append(f"{full}_sum{label_text} {histogram.total:.6g}")
        lines.append(f"{full}_count{label_text} {histogram.count}")

    # -- /fleet/slo --------------------------------------------------------

    def fleet_slo(self) -> dict:
        """Per-tenant/class error-budget burn, fleet-wide: the local
        SLO engine's full snapshot (objectives, windowed burn rates,
        firings) when this process runs one, plus every member's last
        scraped ``slo_burn`` gauges."""
        result: dict = {"collector": self.name, "members": {}}
        qos = getattr(self.local, "qos", None)
        slo = getattr(qos, "slo", None)
        if slo is not None:
            result.update(slo.snapshot())
        with self._lock:
            for member in self._members.values():
                rows: dict = {}
                for key, value in member.gauges.items():
                    if key[0] != "slo_burn":
                        continue
                    labels = member.labels.get(key, {})
                    tenant = str(labels.get("tenant", "?"))
                    cls = str(labels.get("cls", "?"))
                    rows.setdefault(tenant, {})[cls] = value
                if rows:
                    result["members"][member.name] = rows
        return result

    # -- /fleet/traces/<id> ------------------------------------------------

    def fleet_trace(self, trace_id: str) -> dict | None:
        """Assemble one trace across the fleet: the local buffer plus
        every live member's ``/traces/<id>``, span-deduped (the origin
        pipeline of a remote hop already holds the remote's spans).
        None when nobody knows the id."""
        trace_id = str(trace_id)
        spans: list = []
        seen: set = set()
        okay = True
        found = False

        def merge(trace: dict) -> None:
            nonlocal okay, found
            found = True
            okay = okay and bool(trace.get("okay", True))
            for span in trace.get("spans") or []:
                span_id = span.get("span_id")
                if span_id in seen:
                    continue
                seen.add(span_id)
                spans.append(span)

        telemetry = getattr(self.local, "telemetry", None)
        if telemetry is not None:
            local_trace = telemetry.traces.get(trace_id)
            if local_trace is not None:
                merge(local_trace)
        gateway = getattr(self.local, "gateway", None)
        own_traces = getattr(gateway, "_own_traces", None)
        if own_traces is not None:
            gateway_trace = own_traces.get(trace_id)
            if gateway_trace is not None:
                merge(gateway_trace)
        with self._lock:
            targets = [member.endpoint
                       for member in self._members.values()
                       if member.alive and member.endpoint]
        for endpoint in targets:
            try:
                with urllib.request.urlopen(
                        f"http://{endpoint}/traces/{trace_id}",
                        timeout=_SCRAPE_TIMEOUT_S) as reply:
                    merge(json.loads(reply.read().decode()))
            except Exception:
                continue            # 404 = member doesn't hold it
        if not found:
            return None
        spans.sort(key=lambda span: span.get("start") or 0.0)
        return {"trace_id": trace_id, "okay": okay, "spans": spans}

    # -- terminal view -----------------------------------------------------

    def render_terminal(self) -> str:
        """The ``python -m aiko_services_tpu_torch fleet`` live view: member
        table + the headline fleet latencies."""
        rows = self.members_snapshot()
        lines = [f"fleet: {len(rows)} member(s)",
                 f"{'MEMBER':24} {'ENDPOINT':22} {'ALIVE':6} "
                 f"{'SCRAPES':8} {'ERRORS':7}"]
        for row in rows:
            lines.append(
                f"{row['name'][:24]:24} {row['endpoint'][:22]:22} "
                f"{str(row['alive']):6} {row['scrapes']:<8d} "
                f"{row['errors']:<7d}")
        for series in ("frame_latency_ms", "gateway_e2e_ms",
                       "llm_ttft_ms"):
            merged = self.merged_histogram(series)
            if merged.count == 0:
                continue
            p50 = merged.quantile(0.5, windowed=False)
            p99 = merged.quantile(0.99, windowed=False)
            lines.append(f"{series}: count={merged.count} "
                         f"p50={p50:.3f}ms p99={p99:.3f}ms")
        slo = self.fleet_slo()
        for scope in ("tenants",):
            for tenant, classes in (slo.get(scope) or {}).items():
                for cls, entry in classes.items():
                    burn = entry.get("burn") if isinstance(entry, dict) \
                        else entry
                    lines.append(f"slo burn {tenant}/{cls}: "
                                 f"{float(burn):.2f}x")
        return "\n".join(lines)
