"""The port's answer cache and metrics (kmlserver_tpu_torch/serving/cache.py,
metrics.py) against the JAX package's: the same keys, LRU and
singleflight behaviour for the same operations, run on both
``RecommendCache`` classes; the same reservoir and histogram quantiles;
and a ``/metrics`` catalog that is a subset of the reference's."""

import random
import threading
from concurrent.futures import Future

import pytest

from kmlserver_tpu.serving.cache import RecommendCache as RefCache
from kmlserver_tpu.serving import metrics as ref_metrics
from kmlserver_tpu_torch.serving import metrics
from kmlserver_tpu_torch.serving.cache import RecommendCache

CACHES = pytest.mark.parametrize("cls", [RecommendCache, RefCache], ids=["port", "ref"])


@CACHES
@pytest.mark.parametrize(
    "seeds,cap",
    [
        (["x", "a", "m"], 128),
        (["a", "a"], 128),  # duplicates kept
        (["s4", "s3", "s2", "s1", "s0"], 3),  # over the cap: request order
        (["b"], 1),
    ],
)
def test_keys_match_the_reference(cls, seeds, cap):
    cache, ref = cls(), RefCache()
    for epoch in (0, 1, 7):
        want = RefCache.key(epoch, seeds, cap)
        assert cls.key(epoch, seeds, cap) == want
        assert cache.make_key(epoch, seeds, cap) == want
    # a selective invalidation moves the generation component alike
    for c in (cache, ref):
        c.invalidate_seeds({seeds[0]})
        c.invalidate_seeds({seeds[0], "other"})
    assert cache.make_key(3, seeds, cap) == ref.make_key(3, seeds, cap)
    assert cache.make_key(3, seeds, cap)[1] == 2 * seeds.count(seeds[0])


def _script(cache, rng: random.Random) -> list:
    """A fixed sequence of gets/puts/invalidations → everything observable."""
    seen = []
    names = [f"t{i}" for i in range(12)]
    for step in range(400):
        seeds = rng.sample(names, rng.randint(1, 3))
        key = cache.make_key(step // 100, seeds, 8)
        op = rng.random()
        if op < 0.5:
            seen.append(("get", cache.get(key)))
        elif op < 0.9:
            source = "degraded:overload" if rng.random() < 0.1 else "rules"
            cache.put(key, ([f"r{step}"], source))
        else:
            seen.append(("inv", cache.invalidate_seeds(set(rng.sample(names, 2)))))
        seen.append(len(cache))
    counters = ("hits", "misses", "evictions", "singleflight_joins",
                "selective_invalidations", "invalidated_keys")
    seen.append({c: getattr(cache, c) for c in counters})
    seen.append(round(cache.hit_ratio(), 12))
    return seen


@pytest.mark.parametrize("max_entries", [1, 4, 32, 8192])
def test_lru_and_counters_match_the_reference(max_entries):
    got = _script(RecommendCache(max_entries), random.Random(max_entries))
    want = _script(RefCache(max_entries), random.Random(max_entries))
    assert got == want


@CACHES
def test_degraded_answers_are_never_stored(cls):
    cache = cls()
    cache.put((1, 0, ("a",)), (["x"], "degraded:mesh-straggler"))
    assert len(cache) == 0 and cache.get((1, 0, ("a",))) is None


@CACHES
def test_singleflight_collapses_identical_misses(cls):
    cache = cls()
    submitted = []

    def submit():
        f = Future()
        submitted.append(f)
        return f

    key = (1, 0, ("a",))
    leader, joined = cache.join_or_lead(key, submit)
    assert not joined
    leader.add_done_callback(lambda f: cache.finish(key, f))
    followers = [cache.join_or_lead(key, submit) for _ in range(5)]
    assert all(j and f is leader for f, j in followers)
    assert len(submitted) == 1 and cache.singleflight_joins == 5
    leader.set_result((["x"], "rules"))
    assert cache.get(key) == (["x"], "rules")
    # the flight retired: the next miss leads again
    _, joined = cache.join_or_lead((1, 0, ("b",)), submit)
    assert not joined and len(submitted) == 2


@CACHES
def test_failed_or_raising_flights_cache_nothing(cls):
    cache = cls()
    key = (1, 0, ("a",))
    f, _ = cache.join_or_lead(key, Future)
    f.add_done_callback(lambda fut: cache.finish(key, fut))
    f.set_exception(RuntimeError("device failed"))
    assert cache.get(key) is None

    def shed():
        raise OverflowError("shed")

    with pytest.raises(OverflowError):
        cache.join_or_lead((1, 0, ("b",)), shed)
    # nothing installed: the next caller leads
    _, joined = cache.join_or_lead((1, 0, ("b",)), Future)
    assert not joined


@CACHES
def test_concurrent_puts_and_gets_keep_the_bound(cls):
    cache = cls(max_entries=16)
    errors = []

    def hammer(i):
        try:
            for j in range(300):
                key = cache.make_key(0, [f"s{(i * 7 + j) % 40}"], 8)
                if cache.get(key) is None:
                    cache.put(key, ([str(j)], "rules"))
        except Exception as exc:  # pragma: no cover - the assertion below names it
            errors.append(exc)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(cache) <= 16
    assert cache.hits + cache.misses == 8 * 300


@pytest.mark.parametrize("n", [0, 1, 17, 20000])
def test_reservoir_and_histogram_match_the_reference(n):
    rng = random.Random(n)
    samples = [rng.expovariate(300.0) for _ in range(n)]
    port_r, ref_r = metrics.LatencyReservoir(), ref_metrics.LatencyReservoir()
    port_h, ref_h = metrics.LatencyHistogram(), ref_metrics.LatencyHistogram()
    for s in samples:
        for obj in (port_r, ref_r, port_h, ref_h):
            obj.observe(s)
    qs = (0.5, 0.95, 0.99, 0.999)
    assert port_r.percentiles(*qs) == ref_r.percentiles(*qs)
    assert [port_h.quantile(q) for q in qs] == [ref_h.quantile(q) for q in qs]
    assert port_h.render("kmls_e2e_seconds") == ref_h.render("kmls_e2e_seconds")
    assert port_r.reset() == ref_r.reset() == n


def test_series_catalog_is_the_references():
    for name, kind in metrics.METRIC_REGISTRY.items():
        assert ref_metrics.METRIC_REGISTRY.get(name) == kind, name
    assert metrics.UTILIZATION_SERIES == ref_metrics.UTILIZATION_SERIES


def test_render_names_only_catalog_series():
    """Everything the port's render() emits — with a cache, dispatch
    counts, a robustness dict, artifact ages, an IO-health snapshot, a cost
    model and an SLO tracker — is a registered serving series, every
    serving series but the per-card memory gauges (rendered only where a
    card is initialised) is emitted, and the shared sections render
    identically to the reference's."""
    from kmlserver_tpu_torch.observability.costmodel import CostModel
    from kmlserver_tpu_torch.observability.slo import SloTracker

    port_m, ref_m = metrics.ServingMetrics(), ref_metrics.ServingMetrics()
    for m in (port_m, ref_m):
        m.record("rules", 0.002)
        m.record("fallback", 0.004)
        m.record_shed()
        m.record_degraded("deadline")
        m.record_replica_ejected()
        m.record_redispatch(3)
        m.record_attribution(0.001, 0.0005, 0.002)
    cache = RecommendCache()
    cache.put((1, 0, ("a",)), (["x"], "rules"))
    cache.get((1, 0, ("a",)))
    robust = {"replicas_ejected": 0, "utilization": 0.25, "admission_degrade_total": 2,
              "loop_lag_ms": 0.0, "deadline_expired_total": 1,
              "traces_began_total": 0, "traces_retained_total": 0, "trace_buffer_entries": 0,
              "artifact_quarantines_total": 1,
              "reload_failures_total": 2, "reload_consecutive_failures": 1,
              "embedding_active": 0, "embedding_load_failures_total": 0,
              "hybrid_blend_weight": 0.5,
              "delta_applied_total": 1, "delta_rejected_total": 0, "delta_seq": 1,
              "delta_chain_length": 1, "freshness_lag_seconds": 0.5,
              "cache_affinity_local_total": 3, "cache_affinity_remote_total": 4}
    io = {"latency_s": {"read": 0.002}, "errors": {("read", 5): 1}, "retries": 1,
          "storage_slow": False, "disk_free_bytes": 1 << 30}
    cost = CostModel(peak_flops=1e12, peak_bytes_s=1e11)
    cost.observe_kernel("serve_rules", 0.001, b=8, l=8, k_max=16, v=100, k_best=10)
    cost.watch_compiles("serve_rules", lambda: 0)
    cost.note_publish({"rule_ids": 6400, "rule_confs": 6400}, 1 << 30)
    text = port_m.render(3, True, cache=cache, dispatch_counts=[4, 5], robustness=robust,
                         artifact_ages={"rules": 1.0, "popularity": 2.0}, io=io,
                         cost=cost, slo=SloTracker(port_m))
    names = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            names.add(name)
            assert metrics.METRIC_REGISTRY[name] == f"{kind}:serving", name
    card_only = {"kmls_device_bytes_in_use", "kmls_device_bytes_limit"}
    serving = {n for n, k in metrics.METRIC_REGISTRY.items() if k.endswith(":serving")}
    assert names == serving - card_only
    want = ref_m.render(3, True, cache=cache, dispatch_counts=[4, 5])
    # the summaries, histograms, counters and cache lines agree line for line
    # (uptime aside), the embedding family's sources included
    ref_lines = [line for line in want.splitlines()
                 if not line.startswith("kmls_uptime_seconds ")]
    port_lines = [line for line in text.splitlines() if not line.startswith("kmls_uptime_seconds ")]
    assert port_lines[: len(ref_lines)] == ref_lines
    # the storage-health section renders as the reference's does
    def storage(t):
        return [line for line in t.splitlines()
                if any(k in line for k in ("kmls_io_", "kmls_storage_slow", "kmls_disk_free"))]
    assert storage(text) == storage(ref_m.render(3, True, io=io))
