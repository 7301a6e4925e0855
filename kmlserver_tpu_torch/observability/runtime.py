"""Event-loop lag — counterpart of ``kmlserver_tpu/observability/runtime.py``.

When something blocks the asyncio loop, requests wait in the socket
backlog where the admission controller's queue projection cannot see
them: the projection measures the batcher's queue, and nothing reaches
the batcher while the loop is wedged. :class:`LoopLagMonitor` measures
the stall with a timer-drift tick: ``loop.call_later`` re-arms every
``interval_s``, and the difference between when a tick was due and when
it ran is the time something blocked the loop. A thread variant
(:meth:`start_thread`) gives the threaded transport the same signal for
host-scheduling stalls (CPU starvation, a GIL convoy). :meth:`note` folds
in a directly measured stall.

The signal is a peak hold with exponential decay (half-life
``half_life_s``): one 200 ms stall registers at once and fades over about
a second instead of flapping per tick. It is exported as
``kmls_loop_lag_ms`` and folded into
:class:`~..serving.batcher.AdmissionController` pressure through
``lag_source``, so a wedged loop escalates the admission ladder (degrade
→ shed) as a saturated queue would. Plain floats, benign races, no locks
on any hot path.

Unlike the reference, whose drivers run for the life of the process,
both drivers stop on :meth:`stop`: the transports call it on drain and
``RecommendApp.close()`` calls it, so no ``kmls-*`` thread outlives its
server.
"""

from __future__ import annotations

import math
import threading
import time


class LoopLagMonitor:
    """Peak-hold, time-decaying lag estimate for one event loop (or the
    host scheduler, under the thread driver)."""

    def __init__(self, interval_s: float = 0.05, half_life_s: float = 1.0):
        self.interval_s = max(interval_s, 0.005)
        self.half_life_s = max(half_life_s, 0.05)
        self._lag = 0.0
        self._noted_at = 0.0
        self.ticks = 0  # drift-tick count (diagnostics, tests)
        self._running = False
        # a driver runs while its generation is current: stop() bumps it
        self._gen = 0
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()

    # ---------- signal ----------

    def note(self, lag_s: float, now: float | None = None) -> None:
        """Fold one measured blockage (seconds) into the estimate: a stall
        at least as large as the decayed current value replaces it, a
        smaller one leaves the decaying peak in place."""
        if lag_s <= 0.0:
            return
        now = time.perf_counter() if now is None else now
        if lag_s >= self._decayed(now):
            self._lag = lag_s
            self._noted_at = now

    def _decayed(self, now: float) -> float:
        if self._lag <= 0.0:
            return 0.0
        age = max(now - self._noted_at, 0.0)
        return self._lag * math.exp(-age * math.log(2) / self.half_life_s)

    def lag_s(self, now: float | None = None) -> float:
        """The current decayed lag estimate (seconds): two floats and an
        exp, cheap enough for the admission path."""
        return self._decayed(time.perf_counter() if now is None else now)

    # ---------- drivers ----------

    def start_on_loop(self, loop) -> None:
        """Arm the drift tick on an asyncio loop (call from the loop
        thread). It re-arms itself until :meth:`stop`."""
        if self._running:
            return
        self._running = True
        gen = self._gen
        expected = [time.perf_counter() + self.interval_s]

        def tick() -> None:
            if gen != self._gen:
                return  # stopped
            now = time.perf_counter()
            self.ticks += 1
            self.note(max(now - expected[0], 0.0), now=now)
            expected[0] = now + self.interval_s
            loop.call_later(self.interval_s, tick)

        loop.call_later(self.interval_s, tick)

    def start_thread(self) -> threading.Thread | None:
        """Thread driver for the threaded transport: the same drift signal
        measured against a timed wait. A second call while it runs hands
        back the running thread (a twin would double-count ticks)."""
        if self._running:
            return self._thread
        self._running = True
        stop = self._stop_event = threading.Event()

        def loop_() -> None:
            while True:
                expected = time.perf_counter() + self.interval_s
                if stop.wait(self.interval_s):
                    return
                now = time.perf_counter()
                self.ticks += 1
                self.note(max(now - expected, 0.0), now=now)

        thread = threading.Thread(target=loop_, daemon=True, name="kmls-loop-lag")
        self._thread = thread
        thread.start()
        return thread

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop whichever driver runs: the loop tick does not re-arm, the
        thread exits and is joined. Idempotent; a later start works."""
        self._gen += 1
        self._running = False
        self._stop_event.set()
        thread, self._thread = self._thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout_s)
