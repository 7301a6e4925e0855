"""Tracing and phase timing — counterpart of
``kmlserver_tpu/utils/profiling.py`` on ``torch.profiler``.

Two layers, both free when disabled:

- :func:`trace_session` — a ``torch.profiler`` trace (CPU and, where a
  card is present, CUDA activities) of a whole region, written as a
  Chrome trace (``*.pt.trace.json``, readable in Perfetto or
  ``chrome://tracing``) under ``$KMLS_PROFILE_DIR/<label>/``. Enabled only
  when the variable is set: profiling is opt-in in production.
  :func:`start_capture` runs one for N seconds on a thread (the serving
  ``/debug/profile`` route). The first profiler start in a process
  initialises CUPTI, which took 12.2 s on an H100 host and holds the
  interpreter meanwhile; :func:`prime` pays that once up front, so a
  server opted into profiling does not freeze its loop on its first
  capture.
- :class:`PhaseTimer` — named host-side phase timings that synchronise the
  card at each phase's end (a kernel is not done when its launch
  returns), each phase also a ``kmls:<name>`` range in the trace, so host
  phases line up against the device timeline.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Iterator

import torch

PROFILE_DIR_ENV = "KMLS_PROFILE_DIR"

# the profiler's one-time initialisation is process-wide, so the flag that
# it happened is too
_PRIMED = False
_PRIME_LOCK = threading.Lock()


def profile_dir() -> str | None:
    """The trace dump directory, or None when profiling is disabled."""
    raw = os.getenv(PROFILE_DIR_ENV)
    return raw if raw else None


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def prime() -> bool:
    """Start and stop one empty profiler session, once per process, when
    ``$KMLS_PROFILE_DIR`` is set → whether it ran now."""
    global _PRIMED
    if profile_dir() is None:
        return False
    with _PRIME_LOCK:
        if _PRIMED:
            return False
        prof = torch.profiler.profile(activities=_activities())
        prof.start()
        prof.stop()
        _PRIMED = True
    return True


@contextlib.contextmanager
def trace_session(label: str) -> Iterator[str | None]:
    """``torch.profiler`` trace of the enclosed region when
    ``$KMLS_PROFILE_DIR`` is set, else a no-op → the trace file's path
    (written when the region ends), or None. One profiler runs per process
    at a time: nest no session inside another."""
    target = profile_dir()
    if target is None:
        yield None
        return
    path = os.path.join(target, label)
    os.makedirs(path, exist_ok=True)
    trace_file = os.path.join(
        path, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
    )
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield trace_file
    finally:
        prof.stop()
        prof.export_chrome_trace(trace_file)


def start_capture(label: str, seconds: float) -> threading.Thread:
    """Timed on-demand capture (the ``/debug/profile`` route): run
    :func:`trace_session` for ``seconds`` on a daemon thread → the thread
    (join it to wait). CUDA activity is traced device-wide, so the trace
    holds the kernels every thread launched in the window."""

    def run() -> None:
        with trace_session(label):
            time.sleep(max(seconds, 0.0))

    thread = threading.Thread(target=run, daemon=True, name="kmls-profile-capture")
    thread.start()
    return thread


class PhaseTimer:
    """Named wall-clock phases; on a CUDA device each phase synchronises
    at its end so asynchronous kernels are billed to the phase that
    launched them."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        with torch.profiler.record_function(f"kmls:{name}"):
            t0 = time.perf_counter()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0


def format_phases(phases: dict[str, float]) -> str:
    parts = ", ".join(f"{k} {v:.3f}s" for k, v in phases.items())
    return f"phase timings: {parts}" if parts else "phase timings: (none)"
