"""Online traffic forecasting — counterpart of
``kmlserver_tpu/serving/forecast.py``.

Every overload mechanism of the serving stack is reactive: the admission
ladder escalates after queue waits rise, ``kmls_utilization`` reports a
burst once it has landed, and the cache warms a seed set after its first
miss. :class:`TrafficForecaster` sees a ramp coming with Holt
double-exponential smoothing (level + trend) over fixed arrival-count
windows, plus a decayed per-seed-set frequency table (the request mix).
The batcher feeds it one ``observe()`` per admitted request; it answers:

- ``predicted_rate()``: arrivals/s ``horizon_s`` ahead (level +
  trend·horizon, floored at 0). Reads roll the window clock forward, so
  the forecast decays in real time after a burst;
- ``growth_ratio()``: predicted over current rate (1.0 at steady state);
- ``hot_seed_sets()``: the top seed sets by decayed frequency, the
  candidates of the post-delta cache pre-fetch.

Its three actuators: (a) the batcher sizes its collection window from the
predicted gap under a ramp and pre-touches the engine's largest bucket
once per ramp episode; (b) ``kmls_utilization`` gains
:meth:`utilization_lead`, clamped to ``[reactive, util_cap]``; (c) the app
re-warms predicted-hot, owned seed sets after a selective invalidation.
The admission ladder never reads the forecast, so a wrong one can only
over-provision.

With ``KMLS_FORECAST=0`` the app holds no forecaster and every call site
is one is-None check: ``OBSERVATIONS_TOTAL`` stays 0 under any traffic.
The clock is injectable.
"""

from __future__ import annotations

import threading
import time

# incremented by every observe() in the process: with KMLS_FORECAST=0 it
# never moves (a moved counter means a call site dodged the gate)
OBSERVATIONS_TOTAL = 0

# per-window decay of the request-mix table: a seed set stays hot for a few
# dozen windows after its last appearance
_MIX_DECAY = 0.9
_MIX_FLOOR = 0.05


class TrafficForecaster:
    """Per-window arrival-rate and request-mix EWMAs with a trend term.

    When a ``window_s`` window closes its arrival count becomes a rate
    sample; ``level`` smooths the rate and ``trend`` its slope. Silent
    windows fold in as zero-rate samples when the next observation or
    read rolls the clock. Thread-safe: all state mutates under one lock."""

    def __init__(
        self,
        *,
        horizon_s: float = 2.0,
        window_s: float = 0.5,
        alpha: float = 0.35,
        trend_alpha: float = 0.3,
        util_cap: float = 1.0,
        ramp_ratio: float = 1.2,
        hot_top_n: int = 8,
        mix_capacity: int = 512,
        clock=time.monotonic,
    ):
        self.horizon_s = max(0.0, float(horizon_s))
        self.window_s = max(1e-3, float(window_s))
        self.alpha = min(1.0, max(0.0, float(alpha)))
        self.trend_alpha = min(1.0, max(0.0, float(trend_alpha)))
        self.util_cap = max(0.0, float(util_cap))
        self.ramp_ratio = max(1.0, float(ramp_ratio))
        self.hot_top_n = max(1, int(hot_top_n))
        self.mix_capacity = max(1, int(mix_capacity))
        self._clock = clock
        self._lock = threading.Lock()
        self._level = 0.0  # smoothed arrivals/s
        self._trend = 0.0  # arrivals/s per second
        self._windows = 0  # closed windows folded in
        self._win_start: float | None = None
        self._win_count = 0
        # canonical seed key -> [decayed weight, seed list], at most
        # mix_capacity entries (the coldest evicted)
        self._mix: dict[str, list] = {}
        self.observations = 0

    def observe(self, seeds: list[str] | None = None) -> None:
        """One admitted request (and its seed set, if given)."""
        global OBSERVATIONS_TOTAL
        OBSERVATIONS_TOTAL += 1
        now = self._clock()
        with self._lock:
            self.observations += 1
            if self._win_start is None:
                self._win_start = now
            else:
                self._roll_locked(now)
            self._win_count += 1
            if seeds:
                key = "\x1f".join(sorted(seeds))
                entry = self._mix.get(key)
                if entry is None:
                    if len(self._mix) >= self.mix_capacity:
                        coldest = min(self._mix, key=lambda k: self._mix[k][0])
                        del self._mix[coldest]
                    self._mix[key] = [1.0, list(seeds)]
                else:
                    entry[0] += 1.0

    def _roll_locked(self, now: float) -> None:
        """Fold every fully elapsed window into level/trend: the first
        carries the counted arrivals, the rest were silent."""
        if self._win_start is None:
            return
        elapsed = int((now - self._win_start) / self.window_s)
        if elapsed <= 0:
            return
        for i in range(elapsed):
            rate = (self._win_count if i == 0 else 0) / self.window_s
            if self._windows == 0:
                self._level = rate
                self._trend = 0.0
            else:
                prev = self._level
                self._level = self.alpha * rate + (1.0 - self.alpha) * (
                    self._level + self._trend * self.window_s
                )
                # rates are non-negative: a negative level would flip the
                # trend positive and a dead burst would forecast a comeback
                if self._level < 0.0:
                    self._level = 0.0
                self._trend = (
                    self.trend_alpha * (self._level - prev) / self.window_s
                    + (1.0 - self.trend_alpha) * self._trend
                )
            self._windows += 1
            if self._mix:
                dead = []
                for key, entry in self._mix.items():
                    entry[0] *= _MIX_DECAY
                    if entry[0] < _MIX_FLOOR:
                        dead.append(key)
                for key in dead:
                    del self._mix[key]
        self._win_start += elapsed * self.window_s
        self._win_count = 0

    def current_rate(self, now: float | None = None) -> float:
        """The smoothed current arrival rate after rolling to ``now``."""
        if now is None:
            now = self._clock()
        with self._lock:
            self._roll_locked(now)
            return max(0.0, self._level)

    def predicted_rate(self, now: float | None = None) -> float:
        """Arrivals/s ``horizon_s`` ahead: level + trend·horizon, ≥ 0."""
        if now is None:
            now = self._clock()
        with self._lock:
            self._roll_locked(now)
            return max(0.0, self._level + self._trend * self.horizon_s)

    def growth_ratio(self, now: float | None = None) -> float:
        """predicted / current rate; 1.0 with no signal yet."""
        if now is None:
            now = self._clock()
        with self._lock:
            self._roll_locked(now)
            if self._level <= 1e-9 or self._windows < 2:
                return 1.0
            predicted = max(0.0, self._level + self._trend * self.horizon_s)
            return predicted / self._level

    def ramp_predicted(self, now: float | None = None) -> bool:
        """The growth ratio clears ``ramp_ratio``: arms the actuators."""
        return self.growth_ratio(now) >= self.ramp_ratio

    def expected_gap_s(self, now: float | None = None) -> float:
        """The mean inter-arrival gap the horizon forecast implies."""
        rate = self.predicted_rate(now)
        return (1.0 / rate) if rate > 1e-9 else float("inf")

    def utilization_lead(self, reactive: float, now: float | None = None) -> float:
        """The reactive utilization scaled by the growth ratio, clamped to
        ``[reactive, max(reactive, util_cap)]``: never below what is
        measured, and the forecast alone never past the cap."""
        ratio = self.growth_ratio(now)
        if ratio <= 1.0:
            return reactive
        return max(reactive, min(self.util_cap, reactive * ratio))

    def hot_seed_sets(self, top_n: int | None = None) -> list[list[str]]:
        """The predicted-hot seed sets, hottest first."""
        n = self.hot_top_n if top_n is None else max(0, int(top_n))
        with self._lock:
            ranked = sorted(self._mix.values(), key=lambda e: e[0], reverse=True)
            return [list(entry[1]) for entry in ranked[:n]]

    def snapshot(self, now: float | None = None) -> dict:
        """One consistent read of rate, prediction, ratio and observation
        count, for /metrics."""
        if now is None:
            now = self._clock()
        with self._lock:
            self._roll_locked(now)
            level = max(0.0, self._level)
            predicted = max(0.0, self._level + self._trend * self.horizon_s)
            if self._level <= 1e-9 or self._windows < 2:
                ratio = 1.0
            else:
                ratio = predicted / self._level
            return {
                "rate": level,
                "predicted_rate": predicted,
                "ratio": ratio,
                "observations": self.observations,
            }
