"""The port's batched device path and micro-batchers
(kmlserver_tpu_torch/serving/engine.py, batcher.py) against the JAX
package: the same bucket grids, the same admission decisions under an
injected clock, the same answers through both batchers and through the
replica lanes (spread, ejection, redispatch, probe), deadlines, the async
batcher's inline mode for an engine on the native host lookup (the same
branch choices as the reference's on one fake clock), and — on the card —
pipelined batches that stay exact under load."""

import asyncio
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from kmlserver_tpu.serving.batcher import AdmissionController as RefAdmission
from kmlserver_tpu.serving.batcher import AsyncMicroBatcher as RefAsyncMicroBatcher
from kmlserver_tpu.serving.batcher import MicroBatcher as RefMicroBatcher
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu_torch.serving.batcher import (
    AdmissionController,
    AsyncMicroBatcher,
    DeadlineExceeded,
    MicroBatcher,
    NoHealthyReplicas,
    Overloaded,
    OverloadDegraded,
)
from kmlserver_tpu_torch.serving.engine import RecommendEngine

from .torch_serving_util import mine_pvc, port_cfg, ref_cfg, seed_sets


@pytest.fixture(scope="module")
def pvc(tmp_path_factory):
    return mine_pvc(tmp_path_factory.mktemp("torch_batcher"))


@pytest.fixture(scope="module")
def engines(pvc):
    """(port engine on the CPU, reference engine), both loaded."""
    port = RecommendEngine(port_cfg(pvc), device="cpu")
    ref = RefEngine(ref_cfg(pvc))
    assert port.load() and ref.load()
    return port, ref


@pytest.mark.parametrize("max_seed_tracks", [1, 5, 8, 32, 100, 128, 300])
@pytest.mark.parametrize("batch_max_size", [1, 3, 8, 32, 48])
def test_bucket_grids_match_the_reference(tmp_path, max_seed_tracks, batch_max_size):
    knobs = dict(max_seed_tracks=max_seed_tracks, batch_max_size=batch_max_size)
    port = RecommendEngine(port_cfg(str(tmp_path), **knobs), device="cpu")
    ref = RefEngine(ref_cfg(str(tmp_path), **knobs))
    assert port._len_buckets() == ref._len_buckets()
    assert port._batch_buckets() == ref._batch_buckets()
    for n in range(0, 2 * max(max_seed_tracks, batch_max_size) + 3):
        assert port._bucket_len(n) == ref._bucket_len(n), n
        assert port._bucket_batch(n) == ref._bucket_batch(n), n


@pytest.mark.parametrize(
    "budget_s,soft,hard,jitter",
    [(0.25, 0.6, 1.5, 0.5), (0.05, 1.0, 1.0, 0.0), (0.01, 0.2, 3.0, 1.0), (0.0, 0.6, 1.5, 0.5)],
)
def test_admission_sequences_match_the_reference(monkeypatch, budget_s, soft, hard, jitter):
    """The same measured waits, projections and clock → the same
    pressure, decision and Retry-After, step by step."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    kw = dict(soft_ratio=soft, hard_ratio=hard, retry_after_s=1.0, retry_jitter=jitter)
    port = AdmissionController(budget_s, rng=random.Random(7), **kw)
    ref = RefAdmission(budget_s, rng=random.Random(7), **kw)
    rng = random.Random(budget_s)
    for step in range(300):
        clock[0] += rng.expovariate(200.0)
        if step % 3 == 0:
            wait = rng.uniform(0.0, 2.5 * max(budget_s, 0.01))
            port.note_queue_wait(wait, now=clock[0] - 0.001)
            ref.note_queue_wait(wait, now=clock[0] - 0.001)
        projected = rng.uniform(0.0, 2.0 * max(budget_s, 0.01))
        assert port.pressure(projected) == ref.pressure(projected)
        assert port.decide(projected) == ref.decide(projected)
        assert port.retry_after_jittered_s() == ref.retry_after_jittered_s()
        if step == 150:
            clock[0] += 5.0  # a quiet spell: the measured wait decays


def test_engine_batches_match_the_reference(engines, pvc):
    """Every bucketed batch shape answers like the reference engine, with
    no shape outside the warmed grid."""
    port, ref = engines
    sets = seed_sets(pvc, 120)
    want = [ref.recommend(s) for s in sets]
    assert {src for _, src in want} >= {"rules", "fallback"}
    got = []
    for size in (1, 2, 3, 5, 8):
        got = []
        for i in range(0, len(sets), size):
            got += port.recommend_many_async(sets[i:i + size])()
        assert got == want, size
    assert [port.recommend(s) for s in sets[:20]] == want[:20]
    assert port.unwarmed_dispatches == 0
    assert port.bundle.warmed_shapes == {
        (b, length) for b in port._batch_buckets() for length in port._len_buckets()
    }
    # more rows than batch_max_size round up to a multiple of it: unwarmed
    assert port.recommend_many(sets[:11]) == want[:11]
    assert port.unwarmed_dispatches == 1
    port.unwarmed_dispatches = 0


def _hammer(submit_and_wait, sets, threads=16):
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(submit_and_wait, sets))


def test_threaded_batcher_pipelines_exact_answers(engines, pvc):
    port, ref = engines
    sets = seed_sets(pvc, 300, seed=1)
    want = [ref.recommend(s) for s in sets]
    batcher = MicroBatcher(port, max_size=8, window_ms=2.0, max_inflight=4)
    before = sum(port.dispatch_counts)
    try:
        got = _hammer(lambda s: batcher.recommend(s, timeout=30), sets)
    finally:
        batcher.close()
    assert got == want
    # concurrent arrivals formed multi-row batches
    assert sum(port.dispatch_counts) - before < len(sets)


def test_async_batcher_pipelines_exact_answers(engines, pvc):
    port, ref = engines
    sets = seed_sets(pvc, 300, seed=2)
    want = [ref.recommend(s) for s in sets]

    async def run():
        batcher = AsyncMicroBatcher(port, max_size=8, window_ms=2.0, max_inflight=4)
        try:
            return await asyncio.gather(*(batcher.submit(s) for s in sets))
        finally:
            batcher.close()

    before = sum(port.dispatch_counts)
    assert asyncio.run(run()) == want
    assert sum(port.dispatch_counts) - before < len(sets)


def _replica_scenario(engine, batcher_cls, sets):
    """Sequential traffic over two replicas while replica 1 fails, then
    after it heals and its probe is due → answers and breaker counters."""
    real = engine.recommend_many_async
    broken = [True]

    def flaky(seed_sets, replica=None):
        if replica == 1 and broken[0]:
            raise RuntimeError("injected replica failure")
        return real(seed_sets, replica=replica)

    engine.recommend_many_async = flaky
    batcher = batcher_cls(engine, max_size=8, window_ms=2.0, max_inflight=1,
                          eject_threshold=2, probe_interval_s=0.2, redispatch_max=3)
    try:
        answers = [batcher.recommend(s, timeout=30) for s in sets[:12]]
        ejected = batcher.ejected_replicas()
        broken[0] = False
        time.sleep(0.3)  # the probe is due
        answers += [batcher.recommend(s, timeout=30) for s in sets[12:24]]
    finally:
        engine.recommend_many_async = real
    counters = (batcher.eject_total, batcher.readmit_total,
                batcher.redispatch_total, batcher.ejected_replicas())
    close = getattr(batcher, "close", None)  # the reference's has none
    if callable(close):
        close()
    return answers, ejected, counters


def test_replica_lanes_eject_redispatch_and_readmit_like_the_reference(pvc):
    port = RecommendEngine(port_cfg(pvc, serve_devices=2), device="cpu")
    ref = RefEngine(ref_cfg(pvc, serve_devices=2))
    assert port.load() and ref.load()
    assert port.n_replicas == ref.n_replicas == 2
    sets = seed_sets(pvc, 24, seed=3)
    want = [ref.recommend(s) for s in sets]
    got = _replica_scenario(port, MicroBatcher, sets)
    ref_got = _replica_scenario(ref, RefMicroBatcher, sets)
    assert got[0] == want == ref_got[0]
    assert got[1] == ref_got[1] == [1]
    assert got[2] == ref_got[2]
    assert got[2][0] == 1 and got[2][1] == 1 and got[2][3] == []
    # both lanes carried traffic
    assert all(c > 0 for c in port.dispatch_counts)


def test_total_replica_loss_raises_no_healthy_replicas(engines, pvc):
    port, _ = engines
    real = port.recommend_many_async

    def failing(seed_sets, replica=None):
        raise RuntimeError("injected replica failure")

    port.recommend_many_async = failing
    try:
        batcher = MicroBatcher(port, max_size=8, window_ms=2.0, eject_threshold=1,
                               probe_interval_s=60.0)
        with pytest.raises(RuntimeError, match="injected"):
            batcher.recommend(["x"], timeout=10)
        assert batcher.ejected_replicas() == [0]
        with pytest.raises(NoHealthyReplicas):
            batcher.submit(["y"])
        batcher.close()
    finally:
        port.recommend_many_async = real


def test_deadlines_expire_queued_and_in_flight_requests(engines, pvc):
    port, _ = engines
    real = port.recommend_many_async

    def slow(seed_sets, replica=None):
        finish = real(seed_sets)

        def slow_finish():
            time.sleep(0.3)
            return finish()

        return slow_finish

    port.recommend_many_async = slow
    try:
        batcher = MicroBatcher(port, max_size=1, window_ms=2.0, max_inflight=1)
        sets = seed_sets(pvc, 3, seed=4)
        t0 = time.perf_counter()
        first = batcher.submit(sets[0])
        # queued behind the slow batch, past its deadline before dispatch
        queued = batcher.submit(sets[1], deadline=t0 + 0.05)
        with pytest.raises(DeadlineExceeded):
            queued.result(timeout=5)
        with pytest.raises(DeadlineExceeded):
            batcher.recommend(sets[2], deadline=time.perf_counter() + 0.05)
        first.result(timeout=5)
        batcher.close()
    finally:
        port.recommend_many_async = real


@pytest.mark.cuda
def test_cuda_pipelined_batches_match_the_cpu_engine(pvc):
    """On the card: both batchers with four batches in flight, hammered by
    2,000 distinct seed sets from many threads, answer exactly like the
    CPU engine's sequential answers (staging and copy-back reuse would
    corrupt answers only under this kind of load)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    cpu = RecommendEngine(port_cfg(pvc), device="cpu")
    card = RecommendEngine(port_cfg(pvc), device="cuda")
    assert cpu.load() and card.load()
    sets = seed_sets(pvc, 2000, seed=5)
    want = [cpu.recommend(s) for s in sets]
    batcher = MicroBatcher(card, max_size=8, window_ms=2.0, max_inflight=4)
    try:
        assert _hammer(lambda s: batcher.recommend(s, timeout=60), sets, threads=32) == want
    finally:
        batcher.close()

    async def run():
        abatch = AsyncMicroBatcher(card, max_size=8, window_ms=2.0, max_inflight=4)
        loop = asyncio.get_running_loop()

        async def one(s):
            return await abatch.submit(s)

        def from_thread(s):
            return asyncio.run_coroutine_threadsafe(one(s), loop).result(60)

        try:
            return await loop.run_in_executor(None, lambda: _hammer(from_thread, sets, 32))
        finally:
            abatch.close()

    assert asyncio.run(run()) == want
    assert card.unwarmed_dispatches == 0


# ---------------------------------------------------------------- inline mode


class _HostEngine:
    """A fake engine on the native host lookup (``host_kernel_active``):
    each finish() records the thread it ran on and may advance the fake
    clock by ``stall_s`` (a stalled call)."""

    def __init__(self, clock: list, host: bool = True, stall_s: float = 0.0):
        self.host_kernel_active = host
        self.n_replicas = 1
        self.clock = clock
        self.stall_s = stall_s
        self.batches: list[int] = []
        self.threads: list[str] = []
        self.thread_of: dict[str, str] = {}  # a batch's first seed -> its finish's thread

    def recommend_many_async(self, seed_sets):
        self.batches.append(len(seed_sets))

        def finish():
            self.threads.append(threading.current_thread().name)
            self.thread_of[seed_sets[0][0]] = threading.current_thread().name
            self.clock[0] += self.stall_s
            return [(list(s), "rules") for s in seed_sets]

        return finish


class _LagMonitor:
    def __init__(self):
        self.noted: list[float] = []

    def note(self, lag_s: float, now=None) -> None:
        self.noted.append(lag_s)

    def lag_s(self, now=None) -> float:
        return 0.0


# fake-clock gaps between arrivals (s): sparse, then a dense burst longer
# than the 64-arrival rate window, then sparse again, then dense again
_GAPS = [0.05] * 6 + [0.00005] * 100 + [0.03] * 5 + [0.00001] * 80


class _FakeTimers:
    """``loop.call_later`` on the fake clock: a timer runs when the driver
    moves the clock past it, so every window closes at the same arrival in
    both packages."""

    def __init__(self, clock: list, loop):
        self.clock, self.loop, self.timers = clock, loop, []
        loop.call_later = self.call_later

    def call_later(self, delay, callback, *args, context=None):
        handle = asyncio.TimerHandle(self.clock[0] + delay, callback, args, self.loop, context)
        self.timers.append(handle)
        return handle

    def run_until(self, t: float) -> None:
        while True:
            due = [h for h in self.timers if not h.cancelled() and h.when() <= t]
            self.timers = [h for h in self.timers if not h.cancelled() and h.when() > t]
            if not due:
                return
            for handle in sorted(due, key=lambda h: h.when()):
                handle._run()


def _inline_trace(cls, monkeypatch, gaps=_GAPS, host=True, deadline_every=0, stall_s=0.0):
    """Submit one request per gap on a fake clock → per arrival
    (dispatched at once, a window scheduled), the batch sizes, the finish
    threads, the lag notes and the answers."""
    clock = [1000.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    engine = _HostEngine(clock, host=host, stall_s=stall_s)
    lag = _LagMonitor()

    async def run():
        timers = _FakeTimers(clock, asyncio.get_running_loop())
        batcher = cls(engine, max_size=8, window_ms=2.0, window_min_ms=1.0, max_inflight=2,
                      lag_monitor=lag)
        steps, futures = [], []
        try:
            for i, gap in enumerate(gaps):
                clock[0] += gap
                timers.run_until(clock[0])
                before = len(engine.batches)
                deadline = clock[0] + 60.0 if deadline_every and i % deadline_every == 0 else None
                futures.append(batcher.submit([f"t{i}"], deadline=deadline))
                steps.append((len(engine.batches) > before, batcher._flush_handle is not None))
                await asyncio.sleep(0)
            timers.run_until(clock[0] + 1.0)  # the last window closes
            answers = await asyncio.wait_for(asyncio.gather(*futures), 30)
            pool_threads = len(batcher._executor._threads)
        finally:
            close = getattr(batcher, "close", None)  # the reference's has none
            if callable(close):
                close()
            else:
                batcher._executor.shutdown(wait=False)
        return steps, answers, pool_threads

    steps, answers, pool_threads = asyncio.run(run())
    return {"steps": steps, "batches": engine.batches, "threads": engine.threads,
            "thread_of": engine.thread_of,
            "noted": lag.noted, "answers": answers, "pool_threads": pool_threads}


def test_host_kernel_inline_flush_matches_the_reference(monkeypatch):
    """Sparse arrivals dispatch at once, a dense burst waits out the
    short window; the same choice at every arrival as the reference's,
    every finish() on the loop's thread, no executor thread started."""
    port = _inline_trace(AsyncMicroBatcher, monkeypatch)
    ref = _inline_trace(RefAsyncMicroBatcher, monkeypatch)
    assert port["steps"] == ref["steps"]
    assert port["batches"] == ref["batches"]
    assert port["answers"] == [(list(s), "rules") for s in ([f"t{i}"] for i in range(len(_GAPS)))]
    loop_thread = threading.current_thread().name
    assert set(port["threads"]) == set(ref["threads"]) == {loop_thread}
    assert port["pool_threads"] == 0 and ref["pool_threads"] == 0
    assert all(now and not window for now, window in port["steps"][:6])  # sparse: at once
    assert any(window for _, window in port["steps"][70:106])  # dense: a window
    assert port["batches"][:6] == [1] * 6 and max(port["batches"]) == 8


def test_deadline_batches_and_card_engines_take_the_executor(monkeypatch):
    """A batch with a deadline-carrying request hops to the executor, as
    does every batch of an engine off the host lookup (a card's)."""
    for kw in (dict(deadline_every=1), dict(host=False)):
        port = _inline_trace(AsyncMicroBatcher, monkeypatch, gaps=[0.05] * 4, **kw)
        ref = _inline_trace(RefAsyncMicroBatcher, monkeypatch, gaps=[0.05] * 4, **kw)
        assert port["batches"] == ref["batches"] == [1] * 4
        assert port["steps"] == ref["steps"]
        assert all(t.startswith("kmls-abatch") for t in port["threads"]), port["threads"]
        assert threading.current_thread().name not in ref["threads"]
        assert port["pool_threads"] >= 1 and port["noted"] == ref["noted"] == []
    # one request without a deadline in an otherwise inline stream: inline
    mixed = _inline_trace(AsyncMicroBatcher, monkeypatch, gaps=[0.05] * 4, deadline_every=2)
    by_seed = mixed["thread_of"]
    assert by_seed["t1"] == by_seed["t3"] == threading.current_thread().name
    assert by_seed["t0"].startswith("kmls-abatch") and by_seed["t2"].startswith("kmls-abatch")


def test_slow_inline_finish_reaches_the_lag_monitor(monkeypatch):
    """A finish() that holds the loop 200 ms is noted with that stall
    right away, in both packages."""
    port = _inline_trace(AsyncMicroBatcher, monkeypatch, gaps=[0.05] * 3, stall_s=0.2)
    ref = _inline_trace(RefAsyncMicroBatcher, monkeypatch, gaps=[0.05] * 3, stall_s=0.2)
    assert port["noted"] == ref["noted"] == [pytest.approx(0.2, abs=1e-9)] * 3


class _StallLag(_LagMonitor):
    """A loop-lag source stuck at ``lag`` seconds."""

    def __init__(self, lag: float):
        super().__init__()
        self.lag = lag

    def lag_s(self, now=None) -> float:
        return self.lag


def test_ladder_logs_its_inputs_once_a_second(monkeypatch, caplog):
    """A degraded or shed arrival leaves one log line with what drove it:
    the projected wait and its device-time parts, the queue-wait EWMA and
    the loop lag. At most one a second; the decisions between are counted
    in the next line."""
    clock = [1000.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    lag = _StallLag(0.08)  # 80 ms of loop lag on a 100 ms budget: the degrade band

    async def run():
        batcher = AsyncMicroBatcher(_HostEngine(clock, host=False), max_size=8,
                                    shed_queue_budget_ms=100.0, lag_monitor=lag)
        monkeypatch.setattr(batcher._admission._rng, "random", lambda: 0.0)
        outcomes = []
        try:
            for gap, stall in ((0.0, 0.08), (0.3, 0.08), (0.3, 0.08), (0.5, 0.08), (0.0, 0.2)):
                clock[0] += gap
                lag.lag = stall
                try:
                    batcher.submit(["t0"])
                    outcomes.append("admit")
                except OverloadDegraded:
                    outcomes.append("degrade")
                except Overloaded:
                    outcomes.append("shed")
        finally:
            batcher.close()
        return outcomes

    with caplog.at_level("WARNING", logger="kmlserver_tpu_torch.serving"):
        outcomes = asyncio.run(run())
    assert outcomes == ["degrade"] * 4 + ["shed"]
    lines = [r.getMessage() for r in caplog.records if "admission ladder" in r.getMessage()]
    assert lines == [
        "admission ladder degrade at pressure 0.800 (budget 100 ms; 0 more since the last "
        "line): projected wait 0.000 ms (0 batches in flight, device EWMA 0.000 ms, oldest "
        "in flight 0.000 ms), queue-wait EWMA 0.000 ms, loop lag 80.000 ms",
        "admission ladder degrade at pressure 0.800 (budget 100 ms; 2 more since the last "
        "line): projected wait 0.000 ms (0 batches in flight, device EWMA 0.000 ms, oldest "
        "in flight 0.000 ms), queue-wait EWMA 0.000 ms, loop lag 80.000 ms",
    ]


def test_host_kernel_active_follows_the_bundle(pvc):
    """True on a CPU engine serving through the native lookup, as the
    reference's; False with it off and before the first load."""
    from kmlserver_tpu.config import ServingConfig as RefServingConfig

    from .torch_serving_util import KNOBS

    native = RecommendEngine(port_cfg(pvc, native_serve=True), device="cpu")
    assert native.host_kernel_active is False  # nothing loaded yet
    assert native.load() and native.host_kernel_active is True
    off = RecommendEngine(port_cfg(pvc), device="cpu")
    assert off.load() and off.host_kernel_active is False
    ref_native = RefEngine(RefServingConfig(base_dir=pvc, polling_wait_in_minutes=5.0, **KNOBS))
    assert ref_native.load() and ref_native.host_kernel_active is True
    ref_off = RefEngine(ref_cfg(pvc))
    assert ref_off.load() and ref_off.host_kernel_active is False
