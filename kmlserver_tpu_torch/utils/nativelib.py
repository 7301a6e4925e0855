"""Build and load the port's native host libraries — counterpart of
``kmlserver_tpu/utils/nativelib.py``.

Three C++ sources under ``kmlserver_tpu_torch/native/`` — the CSV loader
(``data/native.py``), the POPCNT pair counter and top-k
(``ops/cpu_popcount.py``) and the serving lookup
(``serving/native_serve.py``) — share one lifecycle: built with ``g++`` at
first use into ``build/kmls_torch_native/`` at the repository root
(``.gitignore`` lists ``build/``), named by a digest of the source and the
flags so an edited source never loads a stale library, written through a
private temporary file renamed into place (concurrent builders cannot
tear it), loaded with ``ctypes`` and ABI-checked by the module's ``bind``.

The contract is the reference's: one build per library per process, the
result cached either way (a host without a toolchain does not re-spawn a
failing compiler on every call), and the ``KMLS_NATIVE=0`` kill switch
checked on EVERY call, before the cache. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

SOURCE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kmls_torch_native"
# the reference Makefile's flags; never -march=native: a library built on
# one host may load on another, and the counter needs only POPCNT
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
POPCNT_FLAGS = (
    ("-mpopcnt", "-pthread")
    if platform.machine().lower() in ("x86_64", "amd64") else ("-pthread",)
)

# per source: seconds in g++ (0.0 when a cached library was reused), the
# library's digest and the compiler's first ``--version`` line
BUILD_LOG: dict[str, dict] = {}


def cxx_path() -> str:
    """``$CXX``, else ``g++`` on PATH."""
    return os.environ.get("CXX") or shutil.which("g++") or "g++"


def flags(source: str) -> tuple[str, ...]:
    return CXX_FLAGS + (POPCNT_FLAGS if source == "kmls_popcount" else ())


def library_path(source: str) -> Path:
    """Where ``native/<source>.cpp`` builds to (digest of source + flags)."""
    digest = hashlib.sha256(
        (SOURCE_DIR / f"{source}.cpp").read_bytes() + "\0".join(flags(source)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source}-{digest}.so"


def _compiler_version(cxx: str) -> str:
    try:
        out = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    except OSError:
        return ""
    return out.stdout.splitlines()[0] if out.stdout else ""


def build(source: str) -> Path:
    """Compile ``native/<source>.cpp`` unless its library already exists.
    Raises ``RuntimeError`` when the compiler is missing or fails."""
    out = library_path(source)
    digest = out.stem.rsplit("-", 1)[1]
    cxx = cxx_path()
    if out.exists():
        BUILD_LOG.setdefault(
            source, {"seconds": 0.0, "digest": digest, "compiler": _compiler_version(cxx)}
        )
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *flags(source), "-o", str(tmp), str(SOURCE_DIR / f"{source}.cpp")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"cannot run {cxx}: {exc}") from None
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed for {source}.cpp (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_LOG[source] = {
        "seconds": seconds, "digest": digest, "compiler": _compiler_version(cxx),
    }
    return out


class NativeLib:
    """One library's cached loader: ``bind`` receives the raw CDLL and sets
    up prototypes and checks the ABI version (raising ``OSError`` to
    refuse it). Success and failure are both cached; the kill switch
    stays live. ``error`` says why a load failed."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], ctypes.CDLL]):
        self.source = source
        self._bind = bind
        self._lib: ctypes.CDLL | None = None
        self._failed = False
        self.error: str | None = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL | None:
        # KMLS_NATIVE=0 turns every native route off, read per call
        if os.environ.get("KMLS_NATIVE", "1") == "0":
            return None
        with self._lock:
            if self._lib is not None:
                return self._lib
            if self._failed:
                return None
            try:
                self._lib = self._bind(ctypes.CDLL(str(build(self.source))))
            except (OSError, RuntimeError) as exc:
                self._failed = True
                self.error = str(exc)
                return None
            return self._lib

    def available(self) -> bool:
        return self.load() is not None
