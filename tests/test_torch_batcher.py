"""The port's batched device path and micro-batchers
(kmlserver_tpu_torch/serving/engine.py, batcher.py) against the JAX
package: the same bucket grids, the same admission decisions under an
injected clock, the same answers through both batchers and through the
replica lanes (spread, ejection, redispatch, probe), deadlines, and — on
the card — pipelined batches that stay exact under load."""

import asyncio
import random
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from kmlserver_tpu.serving.batcher import AdmissionController as RefAdmission
from kmlserver_tpu.serving.batcher import MicroBatcher as RefMicroBatcher
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu_torch.serving.batcher import (
    AdmissionController,
    AsyncMicroBatcher,
    DeadlineExceeded,
    MicroBatcher,
    NoHealthyReplicas,
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
