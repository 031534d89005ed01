"""In-tree native MQTT broker management (native/mqtt_broker.cpp).

The reference's message fabric is an external mosquitto daemon
(reference scripts/system_start.sh:28-56); here the broker is part of
the framework: a single-file C++ broker compiled on demand with g++ and
run as a managed subprocess.  Single-host deployments and integration
tests get a real MQTT fabric with zero external dependencies::

    with BrokerProcess() as broker:
        runtime = init_process(transport="mqtt")   # AIKO_MQTT_PORT set

CLI: ``python -m aiko_services_tpu_torch broker [--port N]``.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess

from ..utils import get_logger

__all__ = ["broker_binary", "build_native", "BrokerProcess",
           "native_dir"]

_logger = get_logger("aiko.broker")

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


def native_dir() -> pathlib.Path:
    return _REPO_ROOT / "native"


def build_native(source_name: str, output_name: str,
                 extra_flags: tuple = (), rebuild: bool = False) \
        -> pathlib.Path:
    """Compile a native/ source (cached by mtime) -> build artifact
    path.  Shared by the broker binary and the tensor_pipe shared
    library so the build recipe lives in exactly one place."""
    source = native_dir() / source_name
    build_dir = native_dir() / "build"
    build_dir.mkdir(exist_ok=True)
    artifact = build_dir / output_name
    if (not rebuild and artifact.exists()
            and artifact.stat().st_mtime >= source.stat().st_mtime):
        return artifact
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        raise RuntimeError(f"no C++ compiler found to build "
                           f"{source_name}")
    _logger.info("building %s", artifact)
    subprocess.run(
        [compiler, "-O2", "-std=c++17", *extra_flags,
         "-o", str(artifact), str(source)],
        check=True, capture_output=True, text=True)
    return artifact


def broker_binary(rebuild: bool = False) -> pathlib.Path:
    """Compile native/mqtt_broker.cpp and return the binary path."""
    return build_native("mqtt_broker.cpp", "mqtt_broker",
                        rebuild=rebuild)


class BrokerProcess:
    """Run the native broker as a child process; context-manager
    friendly.  ``port=0`` (default) takes a kernel-assigned port,
    reported by the broker's ``LISTENING <port>`` line and exported to
    ``AIKO_MQTT_HOST``/``AIKO_MQTT_PORT`` for this process unless
    ``export_env=False``."""

    def __init__(self, port: int = 0, export_env: bool = True):
        self._requested_port = port
        self._export_env = export_env
        self._saved_env: dict | None = None
        self.port: int | None = None
        self.process: subprocess.Popen | None = None

    def start(self) -> "BrokerProcess":
        binary = broker_binary()
        self.process = subprocess.Popen(
            [str(binary), str(self._requested_port)],
            stdout=subprocess.PIPE, text=True)
        line = self.process.stdout.readline().strip()
        if not line.startswith("LISTENING "):
            self.stop()
            raise RuntimeError(f"broker failed to start: {line!r}")
        self.port = int(line.split()[1])
        _logger.info("native MQTT broker on port %d (pid %d)",
                     self.port, self.process.pid)
        if self._export_env:
            self._saved_env = {
                key: os.environ.get(key)
                for key in ("AIKO_MQTT_HOST", "AIKO_MQTT_PORT")}
            os.environ["AIKO_MQTT_HOST"] = "127.0.0.1"
            os.environ["AIKO_MQTT_PORT"] = str(self.port)
        return self

    def stop(self):
        if self.process is not None:
            self.process.terminate()
            try:
                self.process.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.process.kill()
                self.process.wait(timeout=5.0)
            self.process = None
        if self._saved_env is not None:
            for key, value in self._saved_env.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
            self._saved_env = None

    def __enter__(self) -> "BrokerProcess":
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()
