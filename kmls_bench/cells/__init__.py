"""The cell drivers, one module per kind of deployment, named by a
configuration's ``driver`` key. Each defines ``run(config=, traffic=,
seed=, seconds=, trace=, device=, t_start=)`` → a dict with ``attempted``,
``failed``, ``e2e`` (end-to-end values by metric name), ``layer`` (what
the per-layer readers read: the reduced ``trace`` of a traced run, the
benchmark's host timings, the program's counters), ``device``, ``checks``
(``{name: (value, limit)}``) and ``notes`` (diagnostics for standard
error).

Shared here: seeds derived from the run's seed, the device record, and an
in-process traced window.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import subprocess
import tempfile


def subseed(seed: int, *parts) -> int:
    """A 63-bit seed derived from the run's ``--seed`` (any integer) and
    ``parts``."""
    text = "\x1f".join([str(int(seed)), *map(str, parts)]).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "big") >> 1


def device_info(dev) -> dict:
    """The result line's ``device`` record of this process's card."""
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _activities(dev) -> list:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def prime_profiler(dev) -> None:
    """Start and stop the profiler once: its first start initialises
    CUPTI (seconds on the card's host), which belongs to set-up."""
    import torch

    prof = torch.profiler.profile(activities=_activities(dev))
    prof.start()
    prof.stop()


class _Window:
    trace = None


@contextlib.contextmanager
def profile_window(enabled: bool, dev):
    """Trace the enclosed window with ``torch.profiler`` (CPU, and CUDA on
    a card) inside a ``kmls_bench:window`` span, when ``enabled`` → an
    object whose ``trace`` is the reduced :class:`~kmls_bench.trace.Trace`
    once the window closes (None untraced)."""
    import torch

    from ..trace import Trace

    out = _Window()
    if not enabled:
        yield out
        return
    prof = torch.profiler.profile(activities=_activities(dev))
    prof.start()
    try:
        with torch.profiler.record_function("kmls_bench:window"):
            yield out
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out.trace = Trace.load(path)
    finally:
        os.unlink(path)
