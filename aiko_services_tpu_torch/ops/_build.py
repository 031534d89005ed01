"""Build the port's CUDA kernels from ``csrc/*.cu`` at first use.

One ``nvcc`` per source runs in parallel (``-c``, position-independent
objects for ``sm_90a``); one link step joins the objects into a single
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/`` next to the package (a directory the
repository ignores), named by a hash of the sources, so an edited
kernel is never served from a stale build.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load_library", "entry", "check", "SOURCE_DIR", "BUILD_DIR"]

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-lineinfo"]

_lock = threading.Lock()
_library: ctypes.CDLL | None = None
_entries: dict = {}
#: ptxas register/shared-memory report of the last build, per source.
build_log: dict[str, str] = {}


def _nvcc() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                       "built from csrc/ at first use and need the CUDA "
                       "toolkit")


def _sources() -> list[Path]:
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {SOURCE_DIR}")
    return sources


def _digest(sources: list[Path]) -> str:
    digest = hashlib.sha256()
    for path in sorted(SOURCE_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    return digest.hexdigest()[:16]


def _build(target: Path, sources: list[Path]) -> None:
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in sources:
        obj = work / (source.stem + ".o")
        jobs.append((source, obj, subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-I", str(SOURCE_DIR),
             "-c", str(source), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for source, _, proc in jobs:
        output, _ = proc.communicate()
        build_log[source.name] = output
        if proc.returncode:
            failed.append(f"{source.name}:\n{output}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    linked = work / target.name
    result = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(linked),
         *[str(obj) for _, obj, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if result.returncode:
        raise RuntimeError(f"nvcc link failed:\n{result.stdout}")
    os.replace(linked, target)
    shutil.rmtree(work, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _library
    with _lock:
        if _library is None:
            sources = _sources()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            target = BUILD_DIR / f"libaiko_kernels-{_digest(sources)}.so"
            if not target.exists():
                _build(target, sources)
            _library = ctypes.CDLL(str(target))
        return _library


def entry(name: str, argtypes: list, restype=ctypes.c_int):
    """The C function ``name`` of the kernel library, its argument types
    declared once (pointers and streams as ``c_void_p``, so ctypes
    never truncates them to 32 bits)."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load_library(), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _entries[name] = fn
    return fn


def check(status: int, name: str) -> None:
    """Raise when a C entry returned a non-zero ``cudaError_t``."""
    if status:
        describe = entry("aiko_error_string", [ctypes.c_int],
                         ctypes.c_char_p)
        raise RuntimeError(f"{name}: CUDA error {status} "
                           f"({describe(status).decode()}) at launch")
