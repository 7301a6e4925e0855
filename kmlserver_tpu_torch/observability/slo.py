"""SLO burn rates — counterpart of ``kmlserver_tpu/observability/slo.py``:
multi-window budget consumption computed from the counters and
fixed-bucket histograms ``serving/metrics.py`` already keeps.

The *burn rate* is how fast an SLO's error budget is being spent relative
to plan: 1.0 spends it exactly by the window's end, 14 spends a 30-day
budget in about 2 days. A FAST window catches a cliff in minutes and a
SLOW one confirms it is not a blip; both are windowed deltas of the
cumulative counters Prometheus would use, so a pod without Prometheus
still gets the numbers at ``GET /debug/slo``.

Three SLOs:

- ``latency_p99``: the share of batched requests slower than
  ``KMLS_SLO_P99_MS``, read from the ``kmls_e2e_seconds`` histogram (the
  target snaps UP to the nearest bucket boundary, the histogram's honest
  resolution). Budget 1 %.
- ``availability``: errors + sheds over attempts, budget
  ``KMLS_SLO_ERROR_BUDGET``.
- ``quality``: degraded answers over attempts, budget
  ``KMLS_SLO_DEGRADE_BUDGET``.

Observability only: the admission ladder stays the actuator. Nothing here
runs on the request path; the tracker samples the counters when
``/metrics`` or ``/debug/slo`` reads it.
"""

from __future__ import annotations

import bisect
import collections
import threading
import time

WINDOWS = ("fast", "slow")
SLOS = ("latency_p99", "availability", "quality")


class SloTracker:
    """Windowed burn rates over a :class:`~..serving.metrics.ServingMetrics`.
    Samples are (monotonic time, cumulative counters) pairs appended at
    most once per ``sample_interval_s`` whenever a reader shows up, pruned
    past the slow window."""

    def __init__(
        self,
        metrics,
        *,
        p99_target_ms: float = 25.0,
        error_budget: float = 0.001,
        degrade_budget: float = 0.01,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        clock=time.monotonic,
    ):
        self.metrics = metrics
        self.p99_target_ms = max(p99_target_ms, 0.0)
        self.error_budget = max(error_budget, 1e-9)
        self.degrade_budget = max(degrade_budget, 1e-9)
        self.fast_window_s = max(fast_window_s, 1.0)
        self.slow_window_s = max(slow_window_s, self.fast_window_s)
        self.sample_interval_s = max(0.5, min(self.fast_window_s / 30.0, 10.0))
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: collections.deque[tuple[float, dict]] = collections.deque()
        # the histogram boundary the latency target snapped to (seconds)
        buckets = self.metrics.e2e_hist.buckets
        idx = bisect.bisect_left(buckets, self.p99_target_ms / 1e3)
        self.latency_boundary_s = buckets[idx] if idx < len(buckets) else float("inf")
        self._boundary_idx = idx

    # ---------- counter snapshots ----------

    def _counters(self) -> dict:
        """One cumulative snapshot of the SLO inputs."""
        m = self.metrics
        with m._lock:
            requests = m.requests_total
            errors = m.errors_total
            shed = m.shed_total
            degraded = sum(m.degraded_by_reason.values())
        counts, _sum, total = m.e2e_hist.snapshot()
        # counts[i] = observations in band i (<= buckets[i]); every band up
        # to and including the snapped boundary is within the SLO
        within = sum(counts[: self._boundary_idx + 1])
        return {
            "attempts": requests + errors + shed,
            "bad_availability": errors + shed,
            "bad_quality": degraded,
            "latency_total": total,
            "latency_slow": total - within,
        }

    def _ensure_sample(self, now: float | None = None) -> dict:
        """Record a sample if the last one is stale → the CURRENT
        cumulative counters."""
        now = self._clock() if now is None else now
        cur = self._counters()
        with self._lock:
            if not self._samples or now - self._samples[-1][0] >= self.sample_interval_s:
                self._samples.append((now, cur))
            horizon = now - self.slow_window_s - 2 * self.sample_interval_s
            while len(self._samples) > 1 and self._samples[0][0] < horizon:
                self._samples.popleft()
        return cur

    def _reference(self, now: float, window_s: float) -> dict | None:
        """The newest sample at least ``window_s`` old (the delta base),
        else the OLDEST sample: a young pod reports over its lifetime."""
        with self._lock:
            ref = None
            for t, snap in self._samples:
                if t <= now - window_s:
                    ref = snap
                else:
                    break
            if ref is None and self._samples:
                ref = self._samples[0][1]
        return ref

    # ---------- burn rates ----------

    @staticmethod
    def _burn(bad: float, total: float, budget: float) -> float:
        if total <= 0:
            return 0.0
        return (bad / total) / budget

    def burn_rates(self, now: float | None = None) -> dict[str, dict[str, float]]:
        """→ ``{slo: {window: burn}}`` for the three SLOs over both
        windows; 1.0 spends the budget exactly on plan."""
        now = self._clock() if now is None else now
        cur = self._ensure_sample(now)
        out: dict[str, dict[str, float]] = {s: {} for s in SLOS}
        for window, span in (("fast", self.fast_window_s), ("slow", self.slow_window_s)):
            ref = self._reference(now, span) or cur
            d_attempts = cur["attempts"] - ref["attempts"]
            out["latency_p99"][window] = self._burn(
                cur["latency_slow"] - ref["latency_slow"],
                cur["latency_total"] - ref["latency_total"], 0.01,
            )
            out["availability"][window] = self._burn(
                cur["bad_availability"] - ref["bad_availability"],
                d_attempts, self.error_budget,
            )
            out["quality"][window] = self._burn(
                cur["bad_quality"] - ref["bad_quality"], d_attempts, self.degrade_budget,
            )
        return out

    # ---------- exposition ----------

    def render_lines(self) -> list[str]:
        """``kmls_slo_burn_rate{slo, window}``: always all six series,
        zero while idle."""
        rates = self.burn_rates()
        lines = ["# TYPE kmls_slo_burn_rate gauge"]
        for slo in SLOS:
            for window in WINDOWS:
                lines.append(
                    f'kmls_slo_burn_rate{{slo="{slo}",window="{window}"}} '
                    f"{rates[slo][window]:.6g}"
                )
        return lines

    def debug_payload(self) -> dict:
        """The ``GET /debug/slo`` response body: targets, windows, the
        cumulative inputs, and both windows' burn rates."""
        rates = self.burn_rates()
        cur = self._counters()
        return {
            "targets": {
                "latency_p99": {
                    "target_ms": self.p99_target_ms,
                    "bucket_boundary_ms": (
                        self.latency_boundary_s * 1e3
                        if self.latency_boundary_s != float("inf") else None
                    ),
                    "budget": 0.01,
                },
                "availability": {"budget": self.error_budget},
                "quality": {"budget": self.degrade_budget},
            },
            "windows_s": {"fast": self.fast_window_s, "slow": self.slow_window_s},
            "counters": cur,
            "burn_rates": rates,
        }
