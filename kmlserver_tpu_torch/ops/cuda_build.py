"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers are included, so a build takes seconds. Libraries are built
at first use into ``build/kmls_torch_kernels/`` at the repository root
(``.gitignore`` lists ``build/``), named by a digest of the source and the
flags, so an edited source can never load a stale library. Concurrent
builders (a process and the subprocess it starts) each write a private
temporary file and rename it into place.

Nothing here runs at import: ``nvcc`` and a CUDA device exist only on the
machine with the card, and the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kmls_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler=-fPIC",
    "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# per-source build record: seconds spent in nvcc (0.0 when a cached library
# was reused) and nvcc's ptxas report (registers, shared memory, spills),
# kept beside the library so a reused library still has its report
BUILD_LOG: dict[str, dict] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (digest of source + flags)."""
    digest = hashlib.sha256(
        (CSRC_DIR / f"{name}.cu").read_bytes()
        + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libkmls_{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists.
    Raises ``RuntimeError`` with nvcc's output when compilation fails."""
    out = library_path(name)
    report = out.with_suffix(".ptxas.txt")
    if out.exists():
        ptxas = report.read_text() if report.exists() else ""
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": ptxas})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    ptxas = proc.stderr + proc.stdout
    tmp_report = report.with_name(f".{report.name}.{os.getpid()}.tmp")
    tmp_report.write_text(ptxas)
    os.replace(tmp_report, report)
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": seconds, "ptxas": ptxas}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
