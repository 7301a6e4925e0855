"""Request micro-batcher — counterpart of ``kmlserver_tpu/serving/batcher.py``:
group concurrent ``/api/recommend/`` calls into batched device lookups,
pipelined, with an adaptive deadline-aware collection window and an
admission ladder.

The collector issues one :meth:`RecommendEngine.recommend_many_async`
call per group. Dispatch and completion run on SEPARATE threads: the
collector dispatches a batch (enqueued on the device, returns at once) and
keeps collecting while a completion lane blocks on that batch's CUDA event
and resolves futures. Up to ``max_inflight`` batches per replica are in
flight.

Three tail-latency disciplines:

- **Idle fast path**: the window is SKIPPED while some replica is idle —
  waiting only buys throughput when a batch is already in flight, so a
  lone request dispatches immediately.
- **Adaptive window**: when every replica IS busy, the wait is sized from
  the observed arrival rate (mean gap over a sliding window of arrivals) —
  roughly the time the current rate needs to fill the batch — clamped to
  [``window_min_ms``, ``window_ms``], and capped so the batch leader's
  queue wait never crosses the shed budget.
- **Admission ladder**: an :class:`AdmissionController` tracks PRESSURE =
  effective queue wait / ``shed_queue_budget_ms`` (the max of the
  instantaneous projection and a time-decaying EWMA of measured queue
  waits). Below ``soft_ratio`` every request is admitted; up to 1.0 a
  rising fraction degrades (:class:`OverloadDegraded` → 200 +
  ``X-KMLS-Degraded: overload`` from the popularity fallback); up to
  ``hard_ratio`` a rising fraction sheds (:class:`Overloaded` → 429 with
  a jittered ``Retry-After``) and the rest degrades; past it everything
  sheds.

Per-request enqueue/dispatch/complete timestamps are reported to
:class:`~.metrics.ServingMetrics` as ``queue_wait`` / ``device`` / ``e2e``,
and a traced request (``submit(..., trace=...)``) gets the same two
intervals as its ``queue`` and ``device`` spans, recorded before its
future resolves. With a ``lag_monitor`` (observability/runtime.py) the
decayed event-loop stall joins the admission pressure: a wedged loop
escalates the ladder as a saturated queue would.
Under a running profiler a batch's dispatch is a ``kmls:flush`` span and
its completion a ``kmls:resolve`` span (``utils/profiling.span``), each
with the batch's rows.
A failure is propagated to every waiting request — the batcher threads
themselves never die.

**Replicas**: with more than one replica the batcher dispatches each batch
to the replica with the fewest batches in flight (ties rotate), with one
completion lane per replica: a card runs its stream in order, but two
cards finish in any order. The pipeline bound and the shed projection use
AGGREGATE capacity.

**Replica health** (``eject_threshold > 0``): a per-replica
consecutive-failure circuit breaker. A replica whose batches keep failing
is EJECTED from the pick; its failed batch's requests are re-dispatched to
the survivors (bounded per-request retries). An ejected replica gets one
half-open trial batch every ``probe_interval_s``; success re-admits it.
With every replica ejected and no probe due, admission raises
:class:`NoHealthyReplicas` — the app degrades those requests to the
popularity fallback instead of 500ing. A failed dispatch is never retried
on another device kind: there is no CPU branch.

**Forecast** (``forecaster=``, a :class:`~.forecast.TrafficForecaster`):
every arrival is observed before the shed decision; under a predicted ramp
the busy window is sized from the predicted gap when it is tighter, the
engine's ``prewarm_touch`` runs once per ramp episode on a ``kmls-prewarm``
thread (joined by ``close()``), and ``utilization_parts()`` adds the
bounded lead to ``kmls_utilization``. None (the default) costs one is-None
check per touchpoint.

**Deadlines**: ``submit(seeds, deadline=...)`` carries a perf_counter
deadline. A request still queued at its deadline fails with
:class:`DeadlineExceeded` instead of dispatching dead work; in-flight
overruns surface as the same exception from the blocking ``recommend()``
wait (threaded) or a loop timer (async).
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import itertools
import logging
import math
import queue
import random
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout

from ..utils.profiling import span
from .engine import RecommendEngine

logger = logging.getLogger("kmlserver_tpu_torch.serving")

# EWMA smoothing for the device-batch-time estimate: reactive within ~10
# batches, smooth enough that one straggler doesn't flip the shed decision
_EWMA_ALPHA = 0.2


class Overloaded(RuntimeError):
    """Raised by ``submit`` instead of enqueueing when admission pressure
    says this request would outwait the shed budget. ``retry_after_s``
    carries the controller's jitter."""

    def __init__(self, retry_after_s: float, projected_wait_ms: float):
        super().__init__(
            f"projected queue wait {projected_wait_ms:.0f}ms exceeds the "
            f"shed budget; retry after {retry_after_s:.1f}s"
        )
        self.retry_after_s = retry_after_s
        self.projected_wait_ms = projected_wait_ms


class OverloadDegraded(RuntimeError):
    """Admission pressure is in the degrade band: answer this request from
    the popularity fallback (200 + ``X-KMLS-Degraded: overload``), one rung
    BEFORE any 429. Cache hits never reach admission."""

    def __init__(self, pressure: float):
        super().__init__(
            f"admission pressure {pressure:.2f} in the degrade band; "
            "answering from the popularity fallback"
        )
        self.pressure = pressure


class AdmissionController:
    """Pressure-proportional admission: admit → degrade → shed.

    Pressure is the effective queue wait over the shed budget; effective
    wait = max(instantaneous projection, measured queue-wait EWMA with
    time decay). Decision bands (ratios of the budget):

    - ``p < soft_ratio``            → admit
    - ``soft_ratio <= p < 1``       → degrade with prob (p-soft)/(1-soft)
    - ``1 <= p < hard_ratio``       → shed with prob (p-1)/(hard-1),
                                      degrade otherwise
    - ``p >= hard_ratio``           → shed

    ``soft_ratio >= 1`` disables the degrade band and ``hard_ratio <= 1``
    makes the shed band a cliff at the budget. ``lag_source``, a zero-arg
    callable returning the current event-loop stall estimate in seconds
    (``LoopLagMonitor.lag_s``), is an effective-wait floor: requests are
    already waiting that long in the socket backlog, where the projection
    cannot see them. All state is plain floats, single writer per field, no
    locks — the loop-confined async twin shares the class unchanged."""

    def __init__(
        self,
        budget_s: float,
        *,
        soft_ratio: float = 0.6,
        hard_ratio: float = 1.5,
        retry_after_s: float = 1.0,
        retry_jitter: float = 0.5,
        rng: random.Random | None = None,
        lag_source=None,
    ):
        self.budget_s = budget_s
        self.soft_ratio = max(0.0, soft_ratio)
        self.hard_ratio = max(self.soft_ratio, hard_ratio, 1.0)
        self.retry_after_s = retry_after_s
        self.retry_jitter = min(max(retry_jitter, 0.0), 1.0)
        self._rng = rng or random.Random()
        self._wait_ewma: float | None = None
        self._wait_noted_at = 0.0
        # decay half-life: one budget width (floored so a sub-ms budget
        # doesn't make the memory vanish between completions)
        self._half_life_s = max(budget_s, 0.25)
        self._lag_source = lag_source

    def note_queue_wait(self, wait_s: float, now: float | None = None) -> None:
        """Completion-side: fold an admitted request's MEASURED queue wait
        into the EWMA (the first sample is adopted outright)."""
        now = time.perf_counter() if now is None else now
        self._wait_ewma = (
            wait_s if self._wait_ewma is None
            else (1 - _EWMA_ALPHA) * self._decayed_wait(now) + _EWMA_ALPHA * wait_s
        )
        self._wait_noted_at = now

    def _decayed_wait(self, now: float) -> float:
        """The EWMA decayed by the time since the last sample — after a
        burst drains, completions stop and only time brings it down."""
        if self._wait_ewma is None or self._wait_ewma <= 0.0:
            return 0.0
        age = max(now - self._wait_noted_at, 0.0)
        return self._wait_ewma * math.exp(-age * math.log(2) / self._half_life_s)

    def pressure(self, projected_s: float, now: float | None = None) -> float:
        """Effective queue wait over the budget (0 with shedding off): the
        max of the projection, the measured-wait EWMA and, when wired, the
        loop stall estimate."""
        if self.budget_s <= 0.0:
            return 0.0
        now = time.perf_counter() if now is None else now
        wait = max(projected_s, self._decayed_wait(now))
        if self._lag_source is not None:
            wait = max(wait, self._lag_source())
        return wait / self.budget_s

    def decide(self, projected_s: float) -> tuple[str, float]:
        """→ ``(decision, pressure)`` with decision ``"admit"`` |
        ``"degrade"`` | ``"shed"``; the pressure that drove it rides along."""
        p = self.pressure(projected_s)
        if p < self.soft_ratio:
            return "admit", p
        if p < 1.0:
            span = 1.0 - self.soft_ratio
            frac = (p - self.soft_ratio) / span if span > 0 else 1.0
            return ("degrade" if self._rng.random() < frac else "admit"), p
        if p < self.hard_ratio:
            span = self.hard_ratio - 1.0
            frac = (p - 1.0) / span if span > 0 else 1.0
            return ("shed" if self._rng.random() < frac else "degrade"), p
        return "shed", p

    def retry_after_jittered_s(self) -> float:
        """Retry-After uniform on ``base·(1 ± retry_jitter)``, floored at
        100 ms: a constant value re-synchronizes every shed client."""
        if self.retry_jitter <= 0.0:
            return self.retry_after_s
        spread = 1.0 + self.retry_jitter * (2.0 * self._rng.random() - 1.0)
        return max(self.retry_after_s * spread, 0.1)


class DeadlineExceeded(RuntimeError):
    """A request's deadline ran out before (or while) the device could
    answer it; the app degrades it to the popularity fallback."""


class NoHealthyReplicas(RuntimeError):
    """Every serving replica is ejected by the circuit breaker and no
    re-admission probe is due; degraded like :class:`DeadlineExceeded`."""


@dataclasses.dataclass
class _Pending:
    seeds: list[str]
    future: Future | asyncio.Future
    t_enqueue: float
    # perf_counter deadline (None = no budget) and how many times this
    # request has been re-dispatched after a replica failure
    deadline: float | None = None
    retries: int = 0
    # the request's TraceContext (observability/trace.py), or None: an
    # untraced request (tracing off, the default) never builds one
    trace: object | None = None


class _ReplicaPolicy:
    """The replica bookkeeping and policy both batchers share: per-replica
    in-flight counts, the circuit breaker, least-loaded pick, the shed
    projection and the adaptive window. The threaded batcher calls the
    ``*_locked`` methods under its lock; the async one calls them on its
    loop."""

    def _init_policy(
        self, engine, *, max_size, window_ms, max_inflight, adaptive, window_min_ms,
        shed_queue_budget_ms, shed_retry_after_s, shed_soft_ratio, shed_hard_ratio,
        shed_retry_jitter, eject_threshold, probe_interval_s, redispatch_max, metrics,
        lag_monitor, forecaster,
    ) -> None:
        self.engine = engine
        # a serving.forecast.TrafficForecaster, or None (every forecast
        # touchpoint is then one is-None check)
        self.forecaster = forecaster
        self.prewarm_total = 0
        self._prewarm_armed = True  # one pre-touch per ramp episode
        self._prewarm_threads: list[threading.Thread] = []
        self.max_size = max_size
        self.window_s = window_ms / 1e3
        self.adaptive = adaptive
        self.window_min_s = min(window_min_ms / 1e3, self.window_s)
        self.shed_budget_s = shed_queue_budget_ms / 1e3
        self.shed_retry_after_s = shed_retry_after_s
        # the event-loop stall estimate (observability/runtime.py), folded
        # into admission pressure
        self.lag_monitor = lag_monitor
        self._admission = AdmissionController(
            self.shed_budget_s,
            soft_ratio=shed_soft_ratio, hard_ratio=shed_hard_ratio,
            retry_after_s=shed_retry_after_s, retry_jitter=shed_retry_jitter,
            lag_source=lag_monitor.lag_s if lag_monitor is not None else None,
        )
        self.metrics = metrics
        self.shed_total = 0
        self.degrade_total = 0  # OverloadDegraded raised at admission
        # circuit breaker (0 = off: the propagate-the-error behavior)
        self.eject_threshold = eject_threshold
        self.probe_interval_s = probe_interval_s
        self.redispatch_max = max(0, redispatch_max)
        self._consec_failures: dict[int, int] = {}
        self._ejected: dict[int, float] = {}  # idx -> perf_counter at eject
        self._probing: set[int] = set()  # half-open: one trial batch out
        self.eject_total = 0
        self.readmit_total = 0
        self.redispatch_total = 0
        # pipeline depth PER REPLICA ("no pipelining" is depth 1, not 0)
        self.max_inflight = max(1, max_inflight)
        self._inflight_by_replica: dict[int, int] = {}
        # rotation point for least-loaded ties
        self._rr = 0
        # per-replica dispatch times of in-flight batches, FIFO: the oldest
        # one's age floors the device-time estimate, so a stalled device
        # shows in the shed projection before its first completion
        self._dispatch_times: dict[int, collections.deque[float]] = {}
        # a sliding window of arrival times (the adaptive window's rate)
        self._arrivals: collections.deque[float] = collections.deque(maxlen=64)
        self._device_s_ewma: float | None = None
        # the ladder's inputs are logged at most once a second while it
        # degrades or sheds; the decisions in between are counted
        self._ladder_logged_at = -math.inf
        self._ladder_unlogged = 0

    # ---------- replica bookkeeping ----------

    def _n_replicas(self) -> int:
        return max(1, getattr(self.engine, "n_replicas", 1))

    def _total_inflight_locked(self) -> int:
        return sum(self._inflight_by_replica.values())

    def _n_healthy_locked(self, n: int) -> int:
        if self.eject_threshold <= 0:
            return n
        return n - sum(1 for i in self._ejected if i < n)

    def _n_effective_locked(self, n: int) -> int:
        """Capacity the shed projection and the idle fast path may COUNT
        ON: neither an ejected replica, nor one under a half-open probe,
        nor one inside a consecutive-failure run."""
        if self.eject_threshold <= 0:
            return n
        return n - sum(
            1 for i in range(n)
            if i in self._ejected or self._consec_failures.get(i, 0) > 0
        )

    def _probe_due_locked(self, n: int, now: float) -> bool:
        return any(
            i < n and i not in self._probing and now - t >= self.probe_interval_s
            for i, t in self._ejected.items()
        )

    def _pick_replica_locked(self, n: int) -> int:
        """Least-loaded HEALTHY replica index (ties rotate); an ejected
        replica whose probe interval elapsed gets ONE half-open trial
        batch instead. → -1 when every replica is ejected and no probe is
        due."""
        if self.eject_threshold > 0 and self._ejected:
            now = time.perf_counter()
            for i, t in self._ejected.items():
                if i < n and i not in self._probing and now - t >= self.probe_interval_s:
                    self._probing.add(i)
                    return i
        best, best_load = -1, None
        for off in range(n):
            i = (self._rr + off) % n
            if i in self._ejected:
                continue
            load = self._inflight_by_replica.get(i, 0)
            if best_load is None or load < best_load:
                best, best_load = i, load
        if best >= 0:
            self._rr = (best + 1) % n
        return best

    def _projected_wait_locked(self, now: float, queued: int) -> float:
        """Batches ahead of a request enqueued now (in flight + queued)
        times the per-batch device-time estimate, over the effective
        replica count. 0 while there is no evidence at all."""
        device_s = self._device_s_ewma or 0.0
        for lane in self._dispatch_times.values():
            if lane:
                device_s = max(device_s, now - lane[0])
        if device_s <= 0.0:
            return 0.0
        capacity = max(1, self._n_effective_locked(self._n_replicas()))
        queued_batches = queued / max(self.max_size, 1)
        return (self._total_inflight_locked() + queued_batches) * device_s / capacity

    def _arrival_gap_s(self) -> float | None:
        """Mean inter-arrival gap over the sliding window, or None before
        any rate evidence exists."""
        arrivals = list(self._arrivals)
        if len(arrivals) < 2:
            return None
        return (arrivals[-1] - arrivals[0]) / (len(arrivals) - 1)

    def _busy_window_s(self, n_collected: int, leader_t: float | None, now: float) -> float:
        """Collection wait while every replica is busy: the fixed ceiling,
        or (adaptive) the time the observed rate needs to fill the rest of
        the batch; always capped so the leader's queue wait stays inside
        the shed budget. Under a forecast ramp the predicted gap is used
        when it is the tighter one."""
        window = self.window_s
        if self.adaptive:
            gap = self._forecast_gap_s(self._arrival_gap_s())
            if gap is not None:
                need = (self.max_size - n_collected) * gap
                window = min(self.window_s, max(self.window_min_s, need))
        if self.shed_budget_s > 0 and leader_t is not None:
            window = min(window, max(0.0, self.shed_budget_s - (now - leader_t)))
        return window

    def _forecast_gap_s(self, gap: float | None) -> float | None:
        """Under a predicted ramp, the tighter of the measured and the
        predicted arrival gap (the window can only shrink); else the
        measured gap. Runs once per batch collection, so it also drives
        the once-per-episode pre-touch."""
        f = self.forecaster
        if f is None:
            return gap
        ramping = f.ramp_predicted()
        self._note_ramp(ramping)
        if not ramping:
            return gap
        predicted = f.expected_gap_s()
        if predicted == float("inf"):
            return gap
        return predicted if gap is None else min(gap, predicted)

    def _note_ramp(self, ramping: bool) -> None:
        """Once per ramp episode (the signal clearing re-arms it), run the
        engine's largest-bucket pre-touch on a daemon thread: it waits on
        a device dispatch, which neither the collector nor the loop may."""
        if not ramping:
            self._prewarm_armed = True
            return
        if not self._prewarm_armed:
            return
        self._prewarm_armed = False
        touch = getattr(self.engine, "prewarm_touch", None)
        if touch is None:
            return

        def _touch() -> None:
            try:
                self.prewarm_total += touch()
            except Exception:
                logger.exception("predictive pre-touch failed (ignored)")

        thread = threading.Thread(target=_touch, daemon=True, name="kmls-prewarm")
        self._prewarm_threads = [t for t in self._prewarm_threads if t.is_alive()]
        self._prewarm_threads.append(thread)
        thread.start()

    def _join_prewarm(self, timeout_s: float) -> None:
        for thread in self._prewarm_threads:
            thread.join(timeout_s)

    def _observe(self, seeds: list[str]) -> None:
        """Feed the forecaster (before the shed decision: demand the ladder
        turns away is still demand)."""
        f = self.forecaster
        if f is not None:
            f.observe(seeds)

    def _admit(self, projected_s: float) -> None:
        """The admission ladder for one arrival: raises Overloaded or
        OverloadDegraded, or returns to enqueue."""
        if self.shed_budget_s <= 0:
            return
        decision, pressure = self._admission.decide(projected_s)
        if decision != "admit":
            self._log_ladder(decision, pressure, projected_s)
        if decision == "shed":
            self.shed_total += 1
            if self.metrics is not None:
                self.metrics.record_shed()
            # the EFFECTIVE wait the decision was made on
            raise Overloaded(
                self._admission.retry_after_jittered_s(),
                pressure * self.shed_budget_s * 1e3,
            )
        if decision == "degrade":
            self.degrade_total += 1
            raise OverloadDegraded(pressure)

    def _log_ladder(self, decision: str, pressure: float, projected_s: float) -> None:
        """One log line with what drove a degrade or shed decision: the
        projected wait and its device-time parts, the measured queue-wait
        EWMA and the loop lag. Reads the lanes without the lock (copies
        only), so a line may be a batch stale."""
        now = time.perf_counter()
        if now - self._ladder_logged_at < 1.0:
            self._ladder_unlogged += 1
            return
        ages = [now - head for lane in list(self._dispatch_times.values())
                for head in list(lane)[:1]]
        lag_source = self._admission._lag_source
        logger.warning(
            "admission ladder %s at pressure %.3f (budget %.0f ms; %d more since the last "
            "line): projected wait %.3f ms (%d batches in flight, device EWMA %.3f ms, oldest "
            "in flight %.3f ms), queue-wait EWMA %.3f ms, loop lag %.3f ms",
            decision, pressure, self.shed_budget_s * 1e3, self._ladder_unlogged,
            projected_s * 1e3, sum(list(self._inflight_by_replica.values())),
            (self._device_s_ewma or 0.0) * 1e3, max(ages, default=0.0) * 1e3,
            self._admission._decayed_wait(now) * 1e3,
            (lag_source() if lag_source is not None else 0.0) * 1e3,
        )
        self._ladder_logged_at = now
        self._ladder_unlogged = 0

    def _note_replica_ok_locked(self, idx: int) -> None:
        """Successful completion on ``idx``: reset the breaker's count; a
        succeeding half-open probe re-admits the replica."""
        if self.eject_threshold <= 0:
            return
        self._consec_failures[idx] = 0
        if idx in self._probing:
            self._probing.discard(idx)
            if self._ejected.pop(idx, None) is not None:
                self.readmit_total += 1
                if self.metrics is not None:
                    self.metrics.record_replica_readmitted()
                logger.info("replica %d re-admitted after successful probe", idx)

    def _note_replica_failure_locked(
        self, idx: int, batch: list[_Pending]
    ) -> tuple[list[_Pending], list[_Pending]]:
        """A batch failed on ``idx``: advance the breaker (eject past the
        threshold; a failed probe re-arms the timer) → (requests to
        re-dispatch, requests to fail). Re-dispatch only with the breaker
        ON and another healthy replica."""
        if self.eject_threshold > 0:
            if idx in self._probing:
                self._probing.discard(idx)
                self._ejected[idx] = time.perf_counter()
            else:
                fails = self._consec_failures.get(idx, 0) + 1
                self._consec_failures[idx] = fails
                if fails >= self.eject_threshold and idx not in self._ejected:
                    self._ejected[idx] = time.perf_counter()
                    self.eject_total += 1
                    if self.metrics is not None:
                        self.metrics.record_replica_ejected()
                    logger.warning(
                        "replica %d ejected after %d consecutive failures; "
                        "re-admission probe every %.1fs",
                        idx, fails, self.probe_interval_s,
                    )
        n = self._n_replicas()
        healthy_other = self.eject_threshold > 0 and any(
            i != idx and i not in self._ejected for i in range(n)
        )
        retriable: list[_Pending] = []
        dead: list[_Pending] = []
        for pending in batch:
            if pending.future.done():  # deadline already resolved it
                continue
            if healthy_other and pending.retries < self.redispatch_max:
                pending.retries += 1
                retriable.append(pending)
            else:
                dead.append(pending)
        if retriable:
            self.redispatch_total += len(retriable)
            if self.metrics is not None:
                self.metrics.record_redispatch(len(retriable))
        return retriable, dead

    def _note_completion_locked(self, idx: int, device_s: float | None) -> None:
        """A batch on ``idx`` finished (``device_s`` None on failure)."""
        self._inflight_by_replica[idx] -= 1
        times = self._dispatch_times.get(idx)
        if times:
            times.popleft()
        if device_s is not None:
            self._device_s_ewma = (
                device_s if self._device_s_ewma is None
                else (1 - _EWMA_ALPHA) * self._device_s_ewma + _EWMA_ALPHA * device_s
            )
            self._note_replica_ok_locked(idx)

    def _reserve_locked(self, n: int) -> int:
        """Pick the replica for the next batch and count it in flight."""
        idx = self._pick_replica_locked(n) if (n > 1 or self.eject_threshold > 0) else 0
        if idx >= 0:
            self._inflight_by_replica[idx] = self._inflight_by_replica.get(idx, 0) + 1
            self._dispatch_times.setdefault(idx, collections.deque()).append(
                time.perf_counter()
            )
        return idx

    def _unreserve_locked(self, idx: int) -> None:
        """Undo :meth:`_reserve_locked` after a dispatch that raised."""
        self._inflight_by_replica[idx] -= 1
        lane = self._dispatch_times.get(idx)
        if lane:
            lane.pop()

    def _record_done(self, batch: list[_Pending], results, idx: int, t_dispatch: float,
                     t_complete: float) -> None:
        """Record a finished batch's spans, resolve its futures and record
        its attribution. Spans come first: the thread that finishes a
        trace must see a complete span list when the result lands."""
        self._admission.note_queue_wait(t_dispatch - batch[0].t_enqueue, now=t_complete)
        for pending in batch:
            if pending.trace is not None:
                pending.trace.span("queue", pending.t_enqueue, t_dispatch, {"batch": len(batch)})
                pending.trace.span("device", t_dispatch, t_complete, {"replica": idx})
        for pending, result in zip(batch, results):
            if not pending.future.done():  # a deadline may have expired it
                pending.future.set_result(result)
        if self.metrics is not None:
            device_s = t_complete - t_dispatch
            for pending in batch:
                self.metrics.record_attribution(
                    queue_wait_s=t_dispatch - pending.t_enqueue,
                    device_s=device_s,
                    e2e_s=t_complete - pending.t_enqueue,
                )

    def _dispatch(self, batch: list[_Pending], idx: int, n: int):
        """→ the engine's finish() for ``batch`` on replica ``idx``; the
        replica kwarg is passed only when there is a choice."""
        seeds = [p.seeds for p in batch]
        if n > 1:
            return self.engine.recommend_many_async(seeds, replica=idx)
        return self.engine.recommend_many_async(seeds)

    def ejected_replicas(self) -> list[int]:
        return sorted(self._ejected)

    def utilization(self) -> float:
        """The autoscaling signal (``kmls_utilization``): max of pipeline
        occupancy over the effective replicas and admission pressure, plus,
        with a forecaster, its bounded lead (never below the reactive
        value; the admission ladder does not read it)."""
        return self.utilization_parts()[1]

    def _reactive_utilization(self) -> float:
        capacity = max(1, self._n_effective_locked(self._n_replicas()))
        occupancy = self._total_inflight_locked() / (self.max_inflight * capacity)
        return max(occupancy, self._admission.pressure(self.projected_queue_wait_s()))

    def utilization_parts(self) -> tuple[float, float]:
        """→ ``(reactive, led)``: the reactive value and the one exported
        as ``kmls_utilization`` (equal without a forecaster; the
        difference is ``kmls_utilization_forecast``)."""
        reactive = self._reactive_utilization()
        f = self.forecaster
        if f is None:
            return reactive, reactive
        return reactive, f.utilization_lead(reactive)


class MicroBatcher(_ReplicaPolicy):
    """The threaded batcher: admission on the request threads, one
    collector thread that dispatches, one completion lane thread per
    replica."""

    def __init__(
        self,
        engine: RecommendEngine,
        *,
        max_size: int = 32,
        window_ms: float = 2.0,
        max_inflight: int = 4,
        adaptive: bool = True,
        window_min_ms: float = 1.0,
        shed_queue_budget_ms: float = 0.0,
        shed_retry_after_s: float = 1.0,
        shed_soft_ratio: float = 0.6,
        shed_hard_ratio: float = 1.5,
        shed_retry_jitter: float = 0.5,
        eject_threshold: int = 0,
        probe_interval_s: float = 5.0,
        redispatch_max: int = 2,
        metrics=None,
        lag_monitor=None,
        forecaster=None,
    ):
        self._init_policy(
            engine, max_size=max_size, window_ms=window_ms, max_inflight=max_inflight,
            adaptive=adaptive, window_min_ms=window_min_ms,
            shed_queue_budget_ms=shed_queue_budget_ms, shed_retry_after_s=shed_retry_after_s,
            shed_soft_ratio=shed_soft_ratio, shed_hard_ratio=shed_hard_ratio,
            shed_retry_jitter=shed_retry_jitter, eject_threshold=eject_threshold,
            probe_interval_s=probe_interval_s, redispatch_max=redispatch_max, metrics=metrics,
            lag_monitor=lag_monitor, forecaster=forecaster,
        )
        # priority queue of (priority, seq, pending): re-dispatched requests
        # ride at 0, ahead of fresh arrivals at 1; seq keeps FIFO order.
        # close() queues (2, seq, None), behind every request
        self._queue: queue.PriorityQueue[tuple[int, int, _Pending | None]] = (
            queue.PriorityQueue()
        )
        self._lane_threads: list[threading.Thread] = []
        self._seq = itertools.count()
        # one completion lane PER REPLICA, created by the collector on its
        # first dispatch to that replica
        self._completions: dict[int, queue.Queue] = {}
        self._n_lock = threading.Lock()
        # the collector blocks here while every replica's pipeline is full
        self._pipe_cond = threading.Condition(self._n_lock)
        # guards the arrival window and the admission counters, written by
        # every request thread
        self._rate_lock = threading.Lock()
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True, name="kmls-microbatcher"
        )
        self._collector.start()

    def ejected_replicas(self) -> list[int]:
        with self._n_lock:
            return super().ejected_replicas()

    def projected_queue_wait_s(self) -> float:
        with self._n_lock:
            return self._projected_wait_locked(time.perf_counter(), self._queue.qsize())

    def _reactive_utilization(self) -> float:
        projected = self.projected_queue_wait_s()
        with self._n_lock:
            capacity = max(1, self._n_effective_locked(self._n_replicas()))
            occupancy = self._total_inflight_locked() / (self.max_inflight * capacity)
        return max(occupancy, self._admission.pressure(projected))

    def _arrival_gap_s(self) -> float | None:
        with self._rate_lock:
            return super()._arrival_gap_s()

    def _completion_lane(self, idx: int) -> queue.Queue:
        lane = self._completions.get(idx)
        if lane is None:
            lane = queue.Queue()
            self._completions[idx] = lane
            thread = threading.Thread(
                target=self._complete_loop, args=(idx,), daemon=True,
                name=f"kmls-batch-completer-{idx}",
            )
            thread.start()
            self._lane_threads.append(thread)
        return lane

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the collector and the completion lanes after the requests
        already queued have been dispatched and finished."""
        self._join_prewarm(timeout_s)
        if not self._collector.is_alive():
            return
        self._queue.put((2, next(self._seq), None))
        self._collector.join(timeout_s)
        for thread in self._lane_threads:
            thread.join(timeout_s)

    # ---------- admission ----------

    def submit(self, seeds: list[str], deadline: float | None = None, trace=None) -> Future:
        """Non-blocking admission: shed-or-enqueue → the request's Future
        (the async transport resolves it via a done-callback; the threaded
        transport blocks on it in :meth:`recommend`). ``trace`` rides the
        request so completion records its queue/device spans."""
        now = time.perf_counter()
        with self._rate_lock:
            self._arrivals.append(now)
        self._observe(seeds)
        if self.eject_threshold > 0 and self._ejected:
            # unlocked pre-check: the healthy case pays no lock
            with self._n_lock:
                n = self._n_replicas()
                if self._n_healthy_locked(n) == 0 and not self._probe_due_locked(n, now):
                    raise NoHealthyReplicas(
                        "all serving replicas ejected; next probe in "
                        f"<= {self.probe_interval_s:.1f}s"
                    )
        if self.shed_budget_s > 0:
            projected = self.projected_queue_wait_s()
            with self._rate_lock:  # the counters += from request threads
                self._admit(projected)
        pending = _Pending(seeds=seeds, future=Future(), t_enqueue=now, deadline=deadline,
                           trace=trace)
        self._queue.put((1, next(self._seq), pending))
        return pending.future

    def recommend(
        self, seeds: list[str], timeout: float = 30.0, deadline: float | None = None,
        trace=None,
    ) -> tuple[list[str], str]:
        future = self.submit(seeds, deadline=deadline, trace=trace)
        if deadline is not None:
            timeout = max(deadline - time.perf_counter(), 0.0)
        try:
            return future.result(timeout=timeout)
        except FuturesTimeout:
            if deadline is not None:
                raise DeadlineExceeded(
                    f"request exceeded its deadline budget after "
                    f"{timeout * 1e3:.0f}ms in flight"
                ) from None
            raise

    # ---------- collection ----------

    def _next_pending(self, timeout: float | None) -> _Pending | None:
        """The next queued request, None when none came within ``timeout``
        (0 = don't wait) or the close marker is next (it goes back)."""
        try:
            item = self._queue.get(timeout=timeout) if timeout else self._queue.get_nowait()
        except queue.Empty:
            return None
        if item[2] is None:
            self._queue.put(item)
        return item[2]

    def _collect_loop(self) -> None:
        while True:
            _, _, first = self._queue.get()  # block for the batch leader
            if first is None:  # close(): every request before it dispatched
                for lane in list(self._completions.values()):
                    lane.put(None)
                return
            batch = [first]
            while len(batch) < self.max_size:
                pending = self._next_pending(0)
                if pending is None:
                    break
                batch.append(pending)
            with self._n_lock:
                device_idle = self._total_inflight_locked() < max(
                    1, self._n_effective_locked(self._n_replicas())
                )
            if not device_idle:
                # all replicas busy: the window buys amortization
                now = time.perf_counter()
                until = now + self._busy_window_s(len(batch), batch[0].t_enqueue, now)
                while len(batch) < self.max_size:
                    remaining = until - time.perf_counter()
                    pending = self._next_pending(remaining) if remaining > 0 else None
                    if pending is None:
                        break
                    batch.append(pending)
            # bound the pipeline AGGREGATELY: backpressure, not failure
            with self._pipe_cond:
                while self._total_inflight_locked() >= self.max_inflight * max(
                    1, self._n_healthy_locked(self._n_replicas())
                ):
                    self._pipe_cond.wait(timeout=1.0)
            # deadline check AFTER the capacity wait; outside the lock
            # (expiry resolves futures, whose callbacks take the cache's)
            batch = self._expire_overdue(batch)
            if not batch:
                continue
            with self._pipe_cond:
                n = self._n_replicas()
                idx = self._reserve_locked(n)
            t_dispatch = time.perf_counter()
            if idx < 0:
                err = NoHealthyReplicas("all serving replicas ejected")
                for pending in batch:
                    if not pending.future.done():
                        pending.future.set_exception(err)
                continue
            try:
                with span("flush", rows=len(batch)):
                    finish = self._dispatch(batch, idx, n)
            except Exception as exc:  # propagate, don't die
                with self._pipe_cond:
                    self._unreserve_locked(idx)
                    self._pipe_cond.notify_all()
                self._on_replica_failure(idx, batch, exc)
                continue
            self._completion_lane(idx).put((batch, finish, t_dispatch))

    def _complete_loop(self, idx: int) -> None:
        lane = self._completions[idx]
        while True:
            item = lane.get()
            if item is None:  # close()
                return
            batch, finish, t_dispatch = item
            try:
                results = finish()
                err = None
            except Exception as exc:  # propagate, don't die
                err = exc
            t_complete = time.perf_counter()
            # decrement BEFORE resolving futures: the client's next request
            # must not see a replica that still looks busy
            with self._pipe_cond:
                self._note_completion_locked(
                    idx, None if err is not None else t_complete - t_dispatch
                )
                self._pipe_cond.notify_all()
            if err is not None:
                self._on_replica_failure(idx, batch, err)
                continue
            with span("resolve", rows=len(batch)):
                self._record_done(batch, results, idx, t_dispatch, t_complete)

    # ---------- replica health ----------

    def _expire_overdue(self, batch: list[_Pending]) -> list[_Pending]:
        """Fail pendings whose deadline already passed (DeadlineExceeded,
        degraded at the app layer) → the survivors."""
        now = time.perf_counter()
        live: list[_Pending] = []
        for pending in batch:
            if pending.deadline is not None and now >= pending.deadline:
                if not pending.future.done():
                    pending.future.set_exception(
                        DeadlineExceeded("deadline expired before dispatch")
                    )
            else:
                live.append(pending)
        return live

    def _on_replica_failure(self, idx: int, batch: list[_Pending], err: Exception) -> None:
        """Advance the breaker, re-queue what may retry (ahead of fresh
        arrivals), fail the rest — futures resolved outside the lock."""
        with self._pipe_cond:
            retriable, dead = self._note_replica_failure_locked(idx, batch)
        for pending in retriable:
            self._queue.put((0, next(self._seq), pending))
        for pending in dead:
            if not pending.future.done():
                pending.future.set_exception(err)


class AsyncMicroBatcher(_ReplicaPolicy):
    """Loop-native twin of :class:`MicroBatcher` for the asyncio transport
    (serving/aioserver.py): admission, collection and future resolution run
    ON the loop (plain ints, no locks), each batch's finish() runs as ONE
    executor task — it blocks on the batch's CUDA event — and the loop
    wakes once per BATCH. Policy-identical to :class:`MicroBatcher`. For an
    engine on the native host lookup (``host_kernel_active``) finish() runs
    on the loop itself, as the reference's does, unless a request of the
    batch carries a deadline."""

    def __init__(
        self,
        engine: RecommendEngine,
        *,
        max_size: int = 32,
        window_ms: float = 2.0,
        max_inflight: int = 4,
        adaptive: bool = True,
        window_min_ms: float = 1.0,
        shed_queue_budget_ms: float = 0.0,
        shed_retry_after_s: float = 1.0,
        shed_soft_ratio: float = 0.6,
        shed_hard_ratio: float = 1.5,
        shed_retry_jitter: float = 0.5,
        eject_threshold: int = 0,
        probe_interval_s: float = 5.0,
        redispatch_max: int = 2,
        metrics=None,
        lag_monitor=None,
        forecaster=None,
    ):
        self._init_policy(
            engine, max_size=max_size, window_ms=window_ms, max_inflight=max_inflight,
            adaptive=adaptive, window_min_ms=window_min_ms,
            shed_queue_budget_ms=shed_queue_budget_ms, shed_retry_after_s=shed_retry_after_s,
            shed_soft_ratio=shed_soft_ratio, shed_hard_ratio=shed_hard_ratio,
            shed_retry_jitter=shed_retry_jitter, eject_threshold=eject_threshold,
            probe_interval_s=probe_interval_s, redispatch_max=redispatch_max, metrics=metrics,
            lag_monitor=lag_monitor, forecaster=forecaster,
        )
        self._pending: list[_Pending] = []
        # the loop submit() runs on, once known: the app's post-delta
        # pre-fetch hops onto it from the engine's poll thread
        self._loop: asyncio.AbstractEventLoop | None = None
        self._flush_handle: asyncio.TimerHandle | None = None
        # finish() blocks — it runs off-loop. The pool is sized for a large
        # replica set (threads spawn on demand) and the ADMISSION bound in
        # _flush clamps to it: a batch the pool could not run at once must
        # not be dispatched, or its executor wait would read as device time
        self._executor_workers = min(32, self.max_inflight * 8)
        self._executor = ThreadPoolExecutor(
            max_workers=self._executor_workers, thread_name_prefix="kmls-abatch",
        )

    def projected_queue_wait_s(self) -> float:
        return self._projected_wait_locked(time.perf_counter(), len(self._pending))

    def close(self) -> None:
        """Stop the finish() pool (idle threads exit; none is waited on)
        after any pre-touch thread."""
        self._join_prewarm(5.0)
        self._executor.shutdown(wait=False)

    # ---------- admission (loop thread only) ----------

    def submit(
        self, seeds: list[str], deadline: float | None = None, trace=None,
    ) -> asyncio.Future:
        loop = asyncio.get_running_loop()
        if self._loop is None:
            self._loop = loop
        now = time.perf_counter()
        self._arrivals.append(now)
        self._observe(seeds)
        if self.eject_threshold > 0 and self._ejected:
            n = self._n_replicas()
            if self._n_healthy_locked(n) == 0 and not self._probe_due_locked(n, now):
                raise NoHealthyReplicas(
                    "all serving replicas ejected; next probe in "
                    f"<= {self.probe_interval_s:.1f}s"
                )
        if self.shed_budget_s > 0:
            self._admit(self.projected_queue_wait_s())
        future = loop.create_future()
        pending = _Pending(seeds=seeds, future=future, t_enqueue=now, deadline=deadline,
                           trace=trace)
        self._pending.append(pending)
        if deadline is not None:
            # in-flight overruns included: the timer fires wherever the
            # request is stuck; cancelled on completion so thousands of
            # live handles don't pile into the loop's heap
            handle = loop.call_later(max(deadline - now, 0.0), self._expire, pending)
            future.add_done_callback(lambda _f: handle.cancel())
        if len(self._pending) >= self.max_size:
            self._flush(loop)  # full batch: dispatch now
        elif getattr(self.engine, "host_kernel_active", False):
            # inline mode (the native host lookup runs ON the loop): no
            # pipeline to keep busy, so a batch forms only in a short
            # window, and only when the observed rate says more arrivals
            # will land inside it; sparse traffic dispatches at once
            if self._flush_handle is None:
                gap = self._arrival_gap_s()
                window = self._busy_window_s(len(self._pending), self._pending[0].t_enqueue, now)
                if gap is None or gap >= window or window <= 0.0:
                    self._flush(loop)
                else:
                    self._flush_handle = loop.call_later(window, self._flush, loop)
        elif self._total_inflight_locked() < max(
            1, self._n_effective_locked(self._n_replicas())
        ):
            self._flush(loop)  # idle fast path
        elif self._flush_handle is None:
            self._flush_handle = loop.call_later(
                self._busy_window_s(len(self._pending), self._pending[0].t_enqueue, now),
                self._flush, loop,
            )
        return future

    # ---------- dispatch / completion (loop thread only) ----------

    def _expire(self, pending: _Pending) -> None:
        if not pending.future.done():
            pending.future.set_exception(
                DeadlineExceeded("request exceeded its deadline budget")
            )

    def _flush(self, loop: asyncio.AbstractEventLoop) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        # expired requests must not burn device time
        if any(p.future.done() for p in self._pending):
            self._pending = [p for p in self._pending if not p.future.done()]
        if not self._pending:
            return
        n = self._n_replicas()
        if self._total_inflight_locked() >= min(
            self.max_inflight * max(1, self._n_healthy_locked(n)), self._executor_workers,
        ):
            # pipeline full: the next completion re-flushes a bigger batch
            return
        batch = self._pending[: self.max_size]
        del self._pending[: len(batch)]
        idx = self._reserve_locked(n)
        if idx < 0:
            err = NoHealthyReplicas("all serving replicas ejected")
            for pending in batch:
                if not pending.future.done():
                    pending.future.set_exception(err)
            return
        t_dispatch = time.perf_counter()
        try:
            with span("flush", rows=len(batch)):
                finish = self._dispatch(batch, idx, n)
        except Exception as exc:  # propagate, don't die
            self._unreserve_locked(idx)
            self._on_replica_failure(idx, batch, exc, loop)
            if self._pending:
                loop.call_soon(self._flush, loop)
            return

        def run_finish():
            try:
                return finish(), None
            except Exception as exc:
                return None, exc

        if getattr(self.engine, "host_kernel_active", False) and not any(
            p.deadline is not None for p in batch
        ):
            # inline: the native lookup is a sub-ms C call that releases the
            # GIL — cheaper here than one thread handoff. Not when a request
            # carries a deadline: a stalled call would block the loop, and
            # the expiry timers with it, for the whole stall
            outcome = run_finish()
            if self.lag_monitor is not None:
                # this finish() just held the loop this long: note it now,
                # before the next request is parsed (the drift tick would
                # see it one iteration later)
                self.lag_monitor.note(time.perf_counter() - t_dispatch)
            self._resolve(batch, outcome, t_dispatch, loop, idx)
            return

        task = self._executor.submit(run_finish)
        task.add_done_callback(
            lambda f: loop.call_soon_threadsafe(self._complete, batch, f, t_dispatch, loop, idx)
        )
        if self._pending:
            loop.call_soon(self._flush, loop)  # overflow past max_size

    def _complete(self, batch, task, t_dispatch: float, loop, idx: int) -> None:
        # kmls-verify: allow[loopblock] — scheduled via
        # call_soon_threadsafe from the executor task's done-callback,
        # so the task is complete and result() returns immediately
        self._resolve(batch, task.result(), t_dispatch, loop, idx)

    def _resolve(self, batch, outcome, t_dispatch: float, loop, idx: int) -> None:
        results, err = outcome
        t_complete = time.perf_counter()
        with span("resolve", rows=len(batch)):
            self._note_completion_locked(
                idx, None if err is not None else t_complete - t_dispatch)
            if err is not None:
                self._on_replica_failure(idx, batch, err, loop)
            else:
                self._record_done(batch, results, idx, t_dispatch, t_complete)
        if self._pending and self._flush_handle is None:
            # a freed pipeline slot dispatches the waiting batch now
            self._flush(loop)

    def _on_replica_failure(self, idx: int, batch, err, loop) -> None:
        retriable, dead = self._note_replica_failure_locked(idx, batch)
        if retriable:
            # front of the queue: they have waited longest
            self._pending[:0] = retriable
            loop.call_soon(self._flush, loop)
        for pending in dead:
            pending.future.set_exception(err)
