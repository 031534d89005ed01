"""Terminal dashboard (reference: src/aiko_services/main/dashboard.py:
317-790, an asciimatics TUI; this one is stdlib-curses with the same
capability set):

- live service table from the :class:`ServicesCache` directory mirror;
- selecting a service attaches an :class:`ECConsumer` to live-view its
  ``share`` dict (the observability surface: lifecycle, log_level,
  streams, element_count, ...);
- tails the selected service's ``log`` topic;
- publishes ``(update name value)`` to ``topic/control`` to change a
  share variable remotely (reference dashboard.py:552-700);
- ``(stop)`` to ask a service to shut down;
- per-protocol/per-name **plugins** render service-specific views
  (reference dashboard_plugins.py:1-52: plugin key = service name or
  protocol): built-ins for the Registrar and Pipelines, extensible via
  :func:`register_plugin`.

``DashboardModel`` is UI-free and fully testable offline; ``run_dashboard``
is the curses front end polling at ~5 Hz (reference refresh rate,
dashboard.py:152).
"""

from __future__ import annotations

import collections

from .runtime import init_process
from .services import (ECConsumer, REGISTRAR_PROTOCOL,
                       SERVICE_PROTOCOL_PREFIX, ServiceTags)
from .services.share import services_cache_singleton
from .utils import generate, get_logger

__all__ = ["DashboardModel", "run_dashboard", "ServicePlugin",
           "FleetPlugin", "register_plugin", "plugin_for"]

_logger = get_logger("aiko.dashboard")

LOG_RING_SIZE = 256


# ---------------------------------------------------------------------------
# plugin registry (reference dashboard_plugins.py: keyed by service name
# or protocol; name match wins)


class ServicePlugin:
    """A service-specific dashboard view.  Subclass, set ``title``, and
    implement ``render(model, record) -> list[str]`` returning body lines
    for the selected service (UI-free: the curses front end and any other
    UI draw whatever lines the plugin produces)."""

    title = "service"

    def render(self, model: "DashboardModel", record) -> list[str]:
        raise NotImplementedError


_PLUGINS: dict[str, type[ServicePlugin]] = {}


def register_plugin(key: str, plugin_class: type[ServicePlugin]):
    """Key is a service *name* or a *protocol* string (exact match;
    names take precedence when both match a selected service)."""
    _PLUGINS[key] = plugin_class


def plugin_for(record) -> ServicePlugin | None:
    plugin_class = _PLUGINS.get(record.name) or _PLUGINS.get(record.protocol)
    return plugin_class() if plugin_class is not None else None


class RegistrarPlugin(ServicePlugin):
    """Directory statistics: what the primary Registrar is tracking
    (reference dashboard_plugins.py RegistrarFrame)."""

    title = "registrar"

    def render(self, model, record):
        lines = [f"service_count: "
                 f"{model.share_view.get('service_count', '?')}"]
        by_protocol = collections.Counter(
            r.protocol.rsplit("/", 1)[-1] for r in model.services())
        lines.append("directory by protocol:")
        for protocol, count in sorted(by_protocol.items()):
            lines.append(f"  {protocol:24.24s} {count}")
        return lines


class PipelinePlugin(ServicePlugin):
    """Pipeline vitals from its share dict: elements, streams, frame
    counters, the telemetry plane's windowed percentiles, per-element
    parameters."""

    title = "pipeline"

    @staticmethod
    def _telemetry_lines(view) -> list[str]:
        """Windowed p50/p99 rollups the pipeline publishes under
        ``share["telemetry"]`` (observability/telemetry.py) -- the
        ECConsumer sees them for free; render the latency sections."""
        telemetry = view.get("telemetry")
        if not isinstance(telemetry, dict):
            return []
        lines = []
        frame = telemetry.get("frame") or {}
        if frame.get("count"):
            lines.append(f"frame latency ms p50/p90/p99: "
                         f"{frame.get('p50_ms')}/{frame.get('p90_ms')}"
                         f"/{frame.get('p99_ms')} n={frame.get('count')}")
        for section in ("element", "segment", "stage", "hop", "queue"):
            entries = telemetry.get(section) or {}
            if not isinstance(entries, dict) or not entries:
                continue
            lines.append(f"{section} latency ms (p50/p99):")
            for name in sorted(entries):
                entry = entries[name] or {}
                if not isinstance(entry, dict):
                    continue
                lines.append(f"  {str(name):24.24s} "
                             f"{entry.get('p50_ms')}/{entry.get('p99_ms')}"
                             f" n={entry.get('count')}")
        traces = telemetry.get("traces") or {}
        if isinstance(traces, dict) and traces:
            lines.append(f"traces: {traces.get('buffered')} buffered / "
                         f"{traces.get('completed')} completed")
        return lines

    def render(self, model, record):
        view = model.share_view
        lines = [f"element_count: {view.get('element_count', '?')}",
                 f"streams:       {view.get('streams', '?')}",
                 f"frames:        {view.get('frames_processed', '?')}"]
        telemetry_lines = self._telemetry_lines(view)
        if telemetry_lines:
            lines.append("[telemetry]")
            lines.extend(telemetry_lines)
        fleet_lines = FleetPlugin.fleet_lines(record)
        if fleet_lines:
            lines.append("[fleet]")
            lines.extend(fleet_lines)
        extras = [(name, value) for name, value in model.share_items()
                  if name.split(".")[0] not in
                  ("element_count", "streams", "frames_processed",
                   "lifecycle", "log_level", "running", "telemetry")]
        if extras:
            lines.append("element shares:")
            lines.extend(f"  {name:32.32s} {value}"
                         for name, value in extras)
        return lines


class FleetPlugin(ServicePlugin):
    """The fleet-aggregate view behind a pipeline that runs a
    collector (``fleet: on``): scrapes the selected service's
    ``/fleet`` + ``/fleet/slo`` over the endpoint its own registrar
    tags advertise (``gateway=`` or ``metrics=``) and renders the
    fleet-wide headline rows -- the aggregate samples carry no
    ``pipeline`` label, which is how they are filtered here.  Share
    dicts stay the transport for everything else; the fleet plane is
    pull-based by design, so this plugin pulls."""

    title = "fleet"
    #: Headline series worth terminal space (full detail: GET /fleet).
    SERIES = ("frame_latency_ms", "gateway_e2e_ms", "llm_ttft_ms")

    @staticmethod
    def _endpoint(record) -> str | None:
        tags = getattr(record, "tags", None) or []
        return ServiceTags.get(tags, "gateway") \
            or ServiceTags.get(tags, "metrics")

    @classmethod
    def fleet_lines(cls, record, timeout: float = 1.0) -> list[str]:
        """Aggregate rows + per-tenant burn, or [] when the service
        exports no endpoint / no collector answers there."""
        import json as json_module
        import urllib.request

        endpoint = cls._endpoint(record)
        if endpoint is None:
            return []
        lines: list[str] = []
        try:
            with urllib.request.urlopen(f"http://{endpoint}/fleet",
                                        timeout=timeout) as reply:
                text = reply.read().decode()
        except Exception:
            return []
        for line in text.splitlines():
            if line.startswith("#") or "pipeline=" in line:
                continue                    # fleet-aggregate rows only
            if any(series in line for series in cls.SERIES) \
                    or line.startswith("aiko_fleet_"):
                lines.append(line)
        try:
            with urllib.request.urlopen(f"http://{endpoint}/fleet/slo",
                                        timeout=timeout) as reply:
                slo = json_module.loads(reply.read().decode())
        except Exception:
            return lines
        for tenant, classes in (slo.get("tenants") or {}).items():
            for cls_name, entry in classes.items():
                burn = entry.get("burn") if isinstance(entry, dict) \
                    else entry
                if burn is None:
                    continue
                lines.append(f"slo burn {tenant}/{cls_name}: "
                             f"{float(burn):.2f}x")
        return lines

    def render(self, model, record):
        lines = self.fleet_lines(record)
        return lines or ["no fleet collector reachable (fleet: on, "
                         "plus a gateway= or metrics= endpoint)"]


register_plugin(REGISTRAR_PROTOCOL, RegistrarPlugin)
register_plugin("fleet", FleetPlugin)
# Spelled out rather than importing PROTOCOL_PIPELINE: the pipeline
# package pulls in jax, which a service browser doesn't need.  Equality
# with the real constant is asserted in tests/test_dashboard_cli.py.
register_plugin(f"{SERVICE_PROTOCOL_PREFIX}/pipeline:0", PipelinePlugin)


class DashboardModel:
    """Directory + selected-service state behind any dashboard UI."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.cache = services_cache_singleton(runtime)
        self.selected: str | None = None          # topic_path
        self.share_view: dict = {}
        self.log_lines: collections.deque = collections.deque(
            maxlen=LOG_RING_SIZE)
        self._consumer: ECConsumer | None = None
        self._log_topic: str | None = None

    # -- directory ---------------------------------------------------------

    def services(self) -> list:
        """ServiceRecords sorted by topic path (stable table order).

        Called from the UI thread while the engine thread mutates the
        registry; retry on the rare mid-iteration resize rather than
        crash the TUI (writes are engine-marshaled, reads are not).
        """
        for _ in range(4):
            try:
                return sorted(self.cache.registry.all(),
                              key=lambda record: record.topic_path)
            except RuntimeError:      # dict changed size during iteration
                continue
        return []

    # -- selection ---------------------------------------------------------

    def select(self, topic_path: str):
        if topic_path == self.selected:
            return
        self.deselect()
        self.selected = topic_path
        self.share_view = {}
        self._consumer = ECConsumer(self.runtime, topic_path,
                                    self.share_view)
        self._log_topic = f"{topic_path}/log"
        self.runtime.add_message_handler(self._on_log, self._log_topic)

    def deselect(self):
        if self._consumer is not None:
            self._consumer.terminate()
            self._consumer = None
        if self._log_topic is not None:
            self.runtime.remove_message_handler(self._on_log,
                                                self._log_topic)
            self._log_topic = None
        self.selected = None
        self.share_view = {}
        self.log_lines.clear()

    def _on_log(self, topic: str, payload):
        self.log_lines.append(str(payload))

    # -- remote actions ----------------------------------------------------

    def update_share(self, name: str, value):
        """Publish ``(update name value)`` to the selected service's
        control topic -- live remote reconfiguration."""
        if self.selected is None:
            return
        self.runtime.message.publish(f"{self.selected}/control",
                                     generate("update", [name, value]))

    def stop_selected(self):
        if self.selected is None:
            return
        self.runtime.message.publish(f"{self.selected}/in",
                                     generate("stop", []))

    def kill_selected(self, kill=None) -> bool:
        """Kill the selected service's host PROCESS (SIGKILL) -- the
        hard counterpart of ``stop_selected``'s polite ``(stop)``
        (reference dashboard.py:399-408 _kill_service).  Topic paths
        are ``namespace/hostname/pid/service_id``; like the reference,
        only a process on THIS host can be killed (its documented
        same-system limitation made explicit).  Returns True when a
        kill was issued."""
        if self.selected is None:
            return False
        parts = self.selected.split("/")
        if len(parts) < 4 or not parts[-2].isdigit():
            return False
        if parts[-3] != self.runtime.hostname:
            _logger.warning("kill_selected: %s is not on this host",
                            self.selected)
            return False
        pid = int(parts[-2])
        if pid == int(self.runtime.pid):    # runtime.pid is a string
            return False              # the dashboard's own process
        import os
        import signal
        try:
            (kill or os.kill)(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError) as error:
            # Stale registrar entry (process already gone) or a
            # recycled pid owned by someone else: report, don't crash
            # the dashboard.
            _logger.warning("kill_selected: pid %s: %s", pid, error)
            return False
        return True

    def copy_selected_topic(self, copier=None) -> tuple[str, bool] | None:
        """Copy the selected topic path to the system clipboard
        (reference dashboard.py:519-520, pyperclip).  Returns
        ``(topic_path, copied)`` -- ``copied`` False when no clipboard
        helper succeeded (a terminal UI can then fall back to OSC 52)
        -- or None when nothing is selected."""
        if self.selected is None:
            return None
        text = self.selected
        if copier is not None:
            copier(text)
            return text, True
        import shutil
        import subprocess
        for tool, args in (("wl-copy", []), ("xclip", ["-selection",
                                                       "clipboard"]),
                           ("xsel", ["--clipboard", "--input"]),
                           ("pbcopy", [])):
            path = shutil.which(tool)
            if path:
                try:
                    subprocess.run([path, *args], input=text.encode(),
                                   timeout=2.0, check=True)
                    return text, True
                except Exception:                 # pragma: no cover
                    continue
        return text, False

    def selected_record(self):
        for record in self.services():
            if record.topic_path == self.selected:
                return record
        return None

    def plugin_view(self) -> tuple[str, list[str]] | None:
        """(title, body lines) from the plugin matching the selected
        service, or None when no plugin is registered for it."""
        record = self.selected_record()
        if record is None:
            return None
        plugin = plugin_for(record)
        if plugin is None:
            return None
        try:
            return plugin.title, plugin.render(self, record)
        except Exception:
            _logger.exception("plugin %s render failed", plugin.title)
            return None

    def share_items(self) -> list[tuple[str, str]]:
        def flatten(data, prefix=""):
            for key in sorted(data):
                value = data.get(key)
                if isinstance(value, dict):
                    yield from flatten(dict(value), f"{prefix}{key}.")
                else:
                    yield f"{prefix}{key}", str(value)
        for _ in range(4):
            try:
                return list(flatten(dict(self.share_view)))
            except RuntimeError:      # ECConsumer updating concurrently
                continue
        return []

    def terminate(self):
        self.deselect()


# ---------------------------------------------------------------------------
# curses front end


def run_dashboard(transport: str | None = None):      # pragma: no cover
    import curses

    runtime = init_process(transport=transport)
    runtime.initialize()
    model = DashboardModel(runtime)

    # The event engine must keep running while curses owns the main
    # thread: drive it from a daemon thread and marshal all framework
    # calls through engine.post for single-threaded semantics.
    import threading
    thread = threading.Thread(target=runtime.run, daemon=True,
                              name="aiko.dashboard.engine")
    thread.start()

    curses.wrapper(_dashboard_loop, runtime, model)
    runtime.terminate()


def _dashboard_loop(stdscr, runtime, model):          # pragma: no cover
    import curses

    curses.curs_set(0)
    stdscr.nodelay(True)
    stdscr.timeout(200)           # ~5 Hz refresh
    cursor = 0
    show_log = False
    raw_view = False          # 'v': raw share dict instead of plugin view
    status = ("q quit | enter select | l logs | v raw/plugin | u update "
              "| k stop | K kill | c copy topic")

    while True:
        records = model.services()
        cursor = max(0, min(cursor, len(records) - 1))
        height, width = stdscr.getmaxyx()
        stdscr.erase()
        title = (f" aiko_services_tpu_torch dashboard -- {runtime.namespace} "
                 f"-- {len(records)} services ")
        stdscr.addnstr(0, 0, title.ljust(width), width - 1,
                       curses.A_REVERSE)

        table_height = max(3, (height - 4) // 2)
        for row, record in enumerate(records[:table_height]):
            marker = ">" if row == cursor else " "
            chosen = "*" if record.topic_path == model.selected else " "
            line = (f"{marker}{chosen} {record.name:20.20s} "
                    f"{record.protocol:32.32s} {record.topic_path}")
            attr = curses.A_BOLD if row == cursor else curses.A_NORMAL
            stdscr.addnstr(1 + row, 0, line, width - 1, attr)

        divider = 1 + table_height
        stdscr.hline(divider, 0, "-", width)
        body_top = divider + 1
        body_rows = height - body_top - 1
        if show_log and model.selected:
            lines = list(model.log_lines)[-body_rows:]
            for i, line in enumerate(lines):
                stdscr.addnstr(body_top + i, 0, line, width - 1)
        elif model.selected:
            plugin_view = None if raw_view else model.plugin_view()
            if plugin_view is not None and body_rows > 0:
                title, lines = plugin_view
                stdscr.addnstr(body_top, 0, f"[{title}]", width - 1,
                               curses.A_BOLD)
                for i, line in enumerate(lines[:max(0, body_rows - 1)]):
                    stdscr.addnstr(body_top + 1 + i, 0, line, width - 1)
            else:
                items = model.share_items()[:body_rows]
                for i, (name, value) in enumerate(items):
                    stdscr.addnstr(body_top + i, 0,
                                   f"{name:32.32s} {value}", width - 1)
        stdscr.addnstr(height - 1, 0, status.ljust(width - 1), width - 1,
                       curses.A_REVERSE)
        stdscr.refresh()

        key = stdscr.getch()
        if key in (ord("q"), ord("Q")):
            break
        if key == curses.KEY_UP:
            cursor -= 1
        elif key == curses.KEY_DOWN:
            cursor += 1
        elif key in (curses.KEY_ENTER, 10, 13) and records:
            runtime.engine.post(model.select,
                                records[cursor].topic_path)
        elif key in (ord("l"), ord("L")):
            show_log = not show_log
        elif key in (ord("v"), ord("V")):
            raw_view = not raw_view
        elif key in (ord("u"), ord("U")) and model.selected:
            name_value = _prompt(stdscr, "update <name> <value>: ")
            parts = name_value.split(None, 1)
            if len(parts) == 2:
                runtime.engine.post(model.update_share, parts[0], parts[1])
        elif key == ord("k") and model.selected:
            runtime.engine.post(model.stop_selected)
        elif key == ord("K") and model.selected:
            model.kill_selected()     # direct os.kill: no engine hop
        elif key == ord("c") and model.selected:
            result = model.copy_selected_topic()
            if result is not None and not result[1]:
                # No clipboard helper on this host: the OSC 52 escape
                # reaches the terminal's clipboard even over SSH.
                import base64
                import sys
                payload = base64.b64encode(result[0].encode()).decode()
                sys.stdout.write(f"\x1b]52;c;{payload}\x07")
                sys.stdout.flush()


def _prompt(stdscr, label):                           # pragma: no cover
    import curses

    height, width = stdscr.getmaxyx()
    stdscr.addnstr(height - 1, 0, label.ljust(width - 1), width - 1)
    curses.echo()
    stdscr.nodelay(False)
    try:
        return stdscr.getstr(height - 1, len(label), 128).decode()
    finally:
        curses.noecho()
        stdscr.nodelay(True)
