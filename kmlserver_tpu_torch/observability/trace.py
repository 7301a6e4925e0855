"""Per-request span tracing with tail-based retention — counterpart of
``kmlserver_tpu/observability/trace.py``.

The latency summaries in ``serving/metrics.py`` say WHERE a percentile
lives (queue vs device vs e2e) but not WHY one request was slow. A
:class:`TraceContext` rides one request from the HTTP front end through
cache → admission → batcher queue → dispatch → device → compose,
collecting named spans, and a :class:`SpanRecorder` keeps the interesting
traces in a bounded ring served at ``GET /debug/traces``.

Retention is decided at FINISH, when the outcome is known:

- every non-OK trace (shed / degraded / error) is kept;
- the slowest-N OK traces seen so far are kept (a min-heap of the N
  largest durations: a new tail entrant evicts the fastest member);
- the other OK traces are kept with probability ``KMLS_TRACE_SAMPLE``.

``KMLS_TRACE_SAMPLE=0`` (the default) makes :attr:`SpanRecorder.enabled`
False and every call site checks that one attribute before allocating
anything; the ``began`` counter stays 0, which the tests assert.

The id travels in ``X-KMLS-Trace`` (request: ``<trace_id>`` or
``<trace_id>:<parent_id>``; the response echoes the trace id), so a
replay client can join its own timing to the server's spans
(``observability/tracejoin.py``).
"""

from __future__ import annotations

import collections
import heapq
import random
import threading
import time

# ids are [-A-Za-z0-9_.]{1,64}: anything else in the header counts as
# absent, so a hostile header never reaches the JSON output verbatim
_ID_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_."
)
_MAX_ID_LEN = 64


def _valid_id(s: str) -> bool:
    return 0 < len(s) <= _MAX_ID_LEN and all(c in _ID_OK for c in s)


class TraceContext:
    """One request's spans. Append-only (``list.append`` is atomic under
    the GIL), so the batcher's completion thread and the HTTP thread can
    both record without a lock; the batchers record their spans before
    the future resolves, so the finishing thread sees a complete list.
    ``finished`` turns a late ``span()`` into a no-op (best-effort); the
    recorder keeps the dict rendered at finish, which cannot change."""

    __slots__ = (
        "trace_id", "parent_id", "t0", "wall_start",
        "spans", "attrs", "status", "duration_s", "finished",
    )

    def __init__(self, trace_id: str, parent_id: str | None, t0: float):
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.t0 = t0  # perf_counter at begin
        self.wall_start = time.time()
        self.spans: list[tuple[str, float, float, dict | None]] = []
        self.attrs: dict[str, object] = {}
        self.status = "open"
        self.duration_s = 0.0
        self.finished = False

    def span(
        self, name: str, t_start: float, t_end: float, attrs: dict | None = None,
    ) -> None:
        """Record a named span (perf_counter endpoints); a no-op once the
        trace is finished."""
        if self.finished:
            return
        self.spans.append((name, t_start, t_end, attrs))

    def annotate(self, key: str, value) -> None:
        self.attrs[key] = value

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "parent_id": self.parent_id,
            "status": self.status,
            "start_unix": round(self.wall_start, 6),
            "duration_ms": round(self.duration_s * 1e3, 4),
            "attrs": dict(self.attrs),
            "spans": [
                {
                    "name": name,
                    "start_ms": round((t_start - self.t0) * 1e3, 4),
                    "duration_ms": round((t_end - t_start) * 1e3, 4),
                    **({"attrs": attrs} if attrs else {}),
                }
                for name, t_start, t_end, attrs in list(self.spans)
            ],
        }


class SpanRecorder:
    """Bounded ring of finished traces with tail-based retention.

    ``sample <= 0`` disables the recorder (``enabled`` False). The lock is
    taken at most twice per finished request, never per span, and guards
    only the ring and the heap."""

    def __init__(
        self,
        sample: float = 0.0,
        capacity: int = 512,
        slow_n: int = 32,
        rng: random.Random | None = None,
    ):
        self.sample = min(max(sample, 0.0), 1.0)
        self.capacity = max(1, capacity)
        self.slow_n = max(0, slow_n)
        self.enabled = self.sample > 0.0
        # contexts created: must stay 0 while tracing is disabled
        self.began = 0
        self.retained_total = 0
        # retained traces are stored rendered (to_dict at finish), so a
        # scraped trace never changes between scrapes
        self._buf: collections.deque[dict] = collections.deque(maxlen=self.capacity)
        # min-heap of the N largest OK durations kept so far: the root is
        # the bar a new trace must clear
        self._slow: list[float] = []
        self._lock = threading.Lock()
        self._rng = rng or random.Random()

    # ---------- lifecycle ----------

    def begin(self, header: str | None = None) -> TraceContext | None:
        """Open a trace for one request; ``header`` is the raw
        ``X-KMLS-Trace`` value (``id`` or ``id:parent``). None when
        disabled, so a miswired call site degrades to untraced."""
        if not self.enabled:
            return None
        self.began += 1  # diagnostic counter, GIL-coalesced
        trace_id = ""
        parent_id: str | None = None
        if header:
            head, _, tail = header.partition(":")
            head = head.strip()
            tail = tail.strip()
            if _valid_id(head):
                trace_id = head
            if tail and _valid_id(tail):
                parent_id = tail
        if not trace_id:
            trace_id = f"{self._rng.getrandbits(64):016x}"
        return TraceContext(trace_id, parent_id, time.perf_counter())

    def finish(self, trace: TraceContext, status: str, duration_s: float) -> bool:
        """Close the trace and decide retention → whether it was kept.
        ``status``: ``"ok"`` | ``"shed"`` | ``"degraded"`` | ``"error"``
        (a degraded trace carries its reason in ``attrs["reason"]``)."""
        trace.status = status
        trace.duration_s = duration_s
        trace.finished = True
        with self._lock:
            keep = status != "ok"
            if not keep and self.slow_n > 0:
                if len(self._slow) < self.slow_n:
                    heapq.heappush(self._slow, duration_s)
                    keep = True
                elif duration_s > self._slow[0]:
                    heapq.heapreplace(self._slow, duration_s)
                    keep = True
            if not keep:
                keep = self._rng.random() < self.sample
        if keep:
            # render outside the lock, then append the frozen dict
            frozen = trace.to_dict()
            with self._lock:
                self._buf.append(frozen)
                self.retained_total += 1
        return keep

    # ---------- exposition ----------

    def retained(self) -> int:
        with self._lock:
            return len(self._buf)

    def snapshot(self) -> list[dict]:
        """Retained traces, oldest first (callers must not mutate them)."""
        with self._lock:
            return list(self._buf)

    def debug_payload(self) -> dict:
        """The ``GET /debug/traces`` response body."""
        traces = self.snapshot() if self.enabled else []
        return {
            "enabled": self.enabled,
            "sample": self.sample,
            "capacity": self.capacity,
            "slow_n": self.slow_n,
            "began": self.began,
            "retained_total": self.retained_total,
            "traces": traces,
        }
