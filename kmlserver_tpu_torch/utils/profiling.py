"""Tracing and phase timing — counterpart of
``kmlserver_tpu/utils/profiling.py`` on ``torch.profiler``.

Three layers, all free when disabled:

- :func:`span` — the port's one way to name a stretch of host work in a
  profiler trace: a ``kmls:<name>[:key=value...]`` range on the thread
  that runs it, the same clock as the device's kernels (a Chrome trace's
  ``ts + baseTimeNanoseconds / 1e3`` is unix microseconds). A running
  profiler is the switch: with none, :func:`span` returns one shared null
  context after a single flag read, and its fields are never formatted.
- :func:`trace_session` — a ``torch.profiler`` trace of every thread (CPU
  and, where a card is present, CUDA activities) of a whole region,
  written as a Chrome trace (``*.pt.trace.json``, readable in Perfetto or
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
  returns), each phase also a :func:`span`, so host phases line up
  against the device timeline.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Iterator

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

PROFILE_DIR_ENV = "KMLS_PROFILE_DIR"

# the profiler's one-time initialisation is process-wide, so the flag that
# it happened is too
_PRIMED = False
_PRIME_LOCK = threading.Lock()


SPAN_PREFIX = "kmls:"

# what span() hands out while no profiler runs: one shared, reentrant
# null context, so an idle span costs a flag read and nothing else
_OFF = contextlib.nullcontext()

# the profiler's cheap range: a ``cpu_op`` event, 2.4 µs a span on the
# H100 host while a profiler runs, where ``torch.profiler.record_function``'s
# ``user_annotation`` took 8–12
_FAST_RANGE = _RecordFunctionFast


def span_name(name: str, fields: dict) -> str:
    """``span_name("embed_topk", {"rows": 32})`` →
    ``"kmls:embed_topk:rows=32"``; a callable field value is called here,
    so a field that costs something to compute is computed only for a
    running profiler."""
    parts = [SPAN_PREFIX + name]
    for key, value in fields.items():
        parts.append(f"{key}={value() if callable(value) else value}")
    return ":".join(parts)


def span(name: str, **fields):
    """A ``kmls:<name>[:key=value...]`` range around the enclosed host
    work while a profiler runs (on any thread: the gate is the profiler's
    process-wide flag, which a profiler tracing every thread sets too),
    else a shared null context. Field values are formatted only when the
    range opens; a callable value is called then. Open no span across an
    ``await``: the range belongs to the thread's call stack."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _FAST_RANGE(span_name(name, fields))


def profile_dir() -> str | None:
    """The trace dump directory, or None when profiling is disabled."""
    raw = os.getenv(PROFILE_DIR_ENV)
    return raw if raw else None


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _all_threads_profiler() -> torch.profiler.profile:
    """A profiler that records the host activity of every thread, not
    only the one that starts it: the serving loop, the batcher's
    executor and the engine's threads all land in one trace."""
    from torch._C._profiler import _ExperimentalConfig

    return torch.profiler.profile(
        activities=_activities(),
        experimental_config=_ExperimentalConfig(profile_all_threads=True),
    )


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
    (written when the region ends), or None. Every thread's host activity
    is traced, and with it every :func:`span` opened anywhere in the
    process. One profiler runs per process at a time: nest no session
    inside another."""
    target = profile_dir()
    if target is None:
        yield None
        return
    path = os.path.join(target, label)
    os.makedirs(path, exist_ok=True)
    trace_file = os.path.join(
        path, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
    )
    prof = _all_threads_profiler()
    prof.start()
    try:
        yield trace_file
    finally:
        prof.stop()
        prof.export_chrome_trace(trace_file)


def start_capture(label: str, seconds: float) -> threading.Thread:
    """Timed on-demand capture (the ``/debug/profile`` route): run
    :func:`trace_session` for ``seconds`` on a daemon thread → the thread
    (join it to wait). Host activity is traced on every thread and CUDA
    activity device-wide, so the trace holds the spans and kernels of the
    loop, the batcher's executor and every other thread in the window."""

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
        with span(name):
            t0 = time.perf_counter()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0


def format_phases(phases: dict[str, float]) -> str:
    parts = ", ".join(f"{k} {v:.3f}s" for k, v in phases.items())
    return f"phase timings: {parts}" if parts else "phase timings: (none)"
