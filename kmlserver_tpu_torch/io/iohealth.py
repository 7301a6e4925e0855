"""IO-health monitor — counterpart of ``kmlserver_tpu/io/iohealth.py``.

The artifact volume is a ReadWriteMany PVC, in practice NFS, whose usual
failure is not an error but slowness: reads of hundreds of milliseconds,
writes that hang for seconds. This module keeps a per-operation latency
EWMA (token poll, reload reads, publication writes), an error and retry
ledger, a free-space gauge, and a hysteresis "storage slow" conviction
that the app shows as a ready-but-degraded ``/readyz`` reason
(``storage-slow``) — degraded, not unready, because serving runs from
memory.

Conviction: EWMA alpha 0.2, at least :data:`MIN_SAMPLES` samples of an
op before any conviction, convict when any op's EWMA crosses
``KMLS_IO_SLOW_MS``, clear only when every op falls under half of it.
"""

from __future__ import annotations

import os
import threading
import time

from ..config import io_slow_s_from_env

# A 0.2-alpha EWMA converges in a handful of observations while one
# outlier moves it only 20%, and 8 samples is enough history that a
# conviction means a *pattern*, not a cold cache.
EWMA_ALPHA = 0.2
MIN_SAMPLES = 8
DEFAULT_SLOW_MS = 250.0
# how stale the cached free-space reading may get before the next
# artifact operation re-runs statvfs
DISK_REFRESH_S = 5.0


class IoHealthMonitor:
    """Latency/error/space ledger for one process's artifact plane."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ewma_s: dict[str, float] = {}
        self._samples: dict[str, int] = {}
        self._errors: dict[tuple[str, int], int] = {}
        self._retries = 0
        self._slow = False
        self._disk_path: str | None = None
        self._disk_free: int | None = None
        self._disk_free_at: float | None = None

    # ---------- observations ----------

    def note_latency(self, op: str, seconds: float) -> None:
        """Record one operation's wall clock and re-evaluate the slow
        conviction. ``op`` ∈ token_poll / read / write / fsync."""
        seconds = max(seconds, 0.0)
        slow_s = io_slow_s_from_env(DEFAULT_SLOW_MS)
        # every observation comes from a thread already touching the
        # PVC — the safe place to keep the free-space cache warm
        self.refresh_disk_free()
        with self._lock:
            prev = self._ewma_s.get(op)
            self._ewma_s[op] = (
                seconds
                if prev is None
                else prev + EWMA_ALPHA * (seconds - prev)
            )
            self._samples[op] = self._samples.get(op, 0) + 1
            convicted = any(
                ewma > slow_s and self._samples.get(name, 0) >= MIN_SAMPLES
                for name, ewma in self._ewma_s.items()
            )
            if convicted:
                self._slow = True
            elif self._slow and all(
                ewma < slow_s / 2 for ewma in self._ewma_s.values()
            ):
                self._slow = False

    def note_error(self, op: str, err_errno: int) -> None:
        with self._lock:
            key = (op, err_errno)
            self._errors[key] = self._errors.get(key, 0) + 1

    def note_retry(self) -> None:
        with self._lock:
            self._retries += 1

    # ---------- disk space ----------

    def watch_disk(self, path: str) -> None:
        """Point the free-space gauge at the artifact mount. Callers are
        PVC-touching threads (preflight, engine load), so the immediate
        first refresh is safe here."""
        with self._lock:
            self._disk_path = path
            self._disk_free_at = None  # force the refresh below
        self.refresh_disk_free()

    def refresh_disk_free(self) -> int | None:
        """Re-run ``statvfs`` on the watched mount and cache the result
        (rate-limited to one probe per :data:`DISK_REFRESH_S`). Only
        ever called from the worker threads that already touch the PVC —
        NEVER from the event loop: on a sick NFS mount ``statvfs`` can
        hang for seconds, the exact gray failure this monitor exists to
        convict; the loop reads the cached :meth:`disk_free_bytes`."""
        with self._lock:
            path = self._disk_path
            stamp = self._disk_free_at
            cached = self._disk_free
        if not path:
            return None
        now = time.monotonic()
        if stamp is not None and now - stamp < DISK_REFRESH_S:
            return cached
        try:
            stat = os.statvfs(path)
            free: int | None = stat.f_bavail * stat.f_frsize
        except OSError:
            free = None
        with self._lock:
            self._disk_free = free
            self._disk_free_at = now
        return free

    def disk_free_bytes(self) -> int | None:
        """Last cached free-space reading — loop-safe: never touches the
        disk (see :meth:`refresh_disk_free`)."""
        with self._lock:
            return self._disk_free

    # ---------- state reads ----------

    def storage_slow(self) -> bool:
        with self._lock:
            return self._slow

    def snapshot(self) -> dict[str, object]:
        """One coherent view for the metrics renderer."""
        with self._lock:
            latency = dict(self._ewma_s)
            errors = dict(self._errors)
            retries = self._retries
            slow = self._slow
        return {
            "latency_s": latency,
            "errors": errors,
            "retries": retries,
            "storage_slow": slow,
            "disk_free_bytes": self.disk_free_bytes(),
        }

    def reset(self) -> None:
        """Forget everything (test teardown)."""
        with self._lock:
            self._ewma_s.clear()
            self._samples.clear()
            self._errors.clear()
            self._retries = 0
            self._slow = False
            self._disk_path = None
            self._disk_free = None
            self._disk_free_at = None


# One process-wide monitor: artifacts.py feeds it from whichever thread
# touches the PVC; the app renders it.
MONITOR = IoHealthMonitor()
