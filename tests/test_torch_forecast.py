"""The port's traffic forecaster (kmlserver_tpu_torch/serving/forecast.py)
and its actuators against the JAX package's: the reference's FakeClock
schedules drive both packages' forecasters to equal ``snapshot()`` dicts
and hot seed sets, its model cases run against both, and its actuator
contracts (bounded lead, shrink-only gap, one pre-touch per ramp episode,
the zero-cost gate, the post-delta pre-fetch) run against the port's
batchers and app on a mined PVC."""

import dataclasses
import json
import time

import pytest

from kmlserver_tpu.config import ServingConfig as RefServingConfig
from kmlserver_tpu.serving import forecast as ref_forecast
from kmlserver_tpu.serving import replay as ref_replay
from kmlserver_tpu_torch.config import ServingConfig
from kmlserver_tpu_torch.freshness.ring import RendezvousRing
from kmlserver_tpu_torch.serving import forecast, replay
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.batcher import AsyncMicroBatcher, MicroBatcher

from . import test_forecast
from .torch_serving_util import mine_pvc, port_cfg, rebound_class, reference_cases

PACKAGES = {
    "reference": (ref_forecast.TrafficForecaster, ref_replay),
    "port": (forecast.TrafficForecaster, replay),
}


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("cls,name", reference_cases(test_forecast.TestForecastModel))
def test_reference_model_case(package, cls, name):
    """tests/test_forecast.py's model cases (ramp, sine, burst decay, Zipf
    head, mix bound, quiet start) with each package's forecaster and
    schedules."""
    fc_cls, rp = PACKAGES[package]
    case = rebound_class(cls, TrafficForecaster=fc_cls, shaped_arrivals=rp.shaped_arrivals,
                         sample_seed_sets=rp.sample_seed_sets)
    getattr(case(), name)()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _schedule(name: str):
    """(arrival times, payloads or None, forecaster kwargs, read points)"""
    if name == "ramp":
        return replay.shaped_arrivals(4000, 200.0, "ramp"), None, {}, 20
    if name == "sine":
        return replay.shaped_arrivals(6000, 200.0, "sine"), None, {}, 20
    if name == "burst-decay":
        return [i / 500.0 for i in range(1000)] + [2.0 + 20 * 0.5], None, {}, 10
    if name == "zipf-head":
        payloads = replay.sample_seed_sets([f"track_{i}" for i in range(40)], 3000, rng_seed=7,
                                           unknown_fraction=0.0, zipf_s=1.1, zipf_pool=64)
        return [i / 500.0 for i in range(3000)], payloads, {}, 12
    if name == "mix-bound":
        return ([i * 1e-3 for i in range(200)], [[f"s{i}"] for i in range(200)],
                {"mix_capacity": 16}, 8)
    if name == "knobs":
        return (replay.shaped_arrivals(3000, 400.0, "burst"), None,
                dict(horizon_s=3.5, window_s=0.25, alpha=0.5, trend_alpha=0.1, util_cap=0.8,
                     ramp_ratio=1.4, hot_top_n=3), 15)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["ramp", "sine", "burst-decay", "zipf-head", "mix-bound", "knobs"])
def test_snapshots_equal_the_references(name):
    """Both forecasters on one schedule: equal snapshot dicts (floats
    equal, not close), predictions, leads and hot sets at every read."""
    arrivals, payloads, kw, reads = _schedule(name)
    clocks = _Clock(), _Clock()
    got = forecast.TrafficForecaster(clock=clocks[0], **kw)
    want = ref_forecast.TrafficForecaster(clock=clocks[1], **kw)
    step = max(1, len(arrivals) // reads)
    for i, t in enumerate(arrivals):
        for clock in clocks:
            clock.t = float(t)
        seeds = payloads[i] if payloads is not None else None
        got.observe(seeds)
        want.observe(seeds)
        if i % step == 0 or i == len(arrivals) - 1:
            assert got.snapshot() == want.snapshot()
            assert got.hot_seed_sets() == want.hot_seed_sets()
            for reactive in (0.0, 0.3, 0.95, 1.4):
                assert got.utilization_lead(reactive) == want.utilization_lead(reactive)
            assert got.expected_gap_s() == want.expected_gap_s()
            assert got.ramp_predicted() == want.ramp_predicted()
    for _ in range(30):  # silence folds in as zeros, window by window
        for clock in clocks:
            clock.t += got.window_s
        assert got.snapshot() == want.snapshot()
        assert got.growth_ratio() == want.growth_ratio()
    assert got._mix.keys() == want._mix.keys()


# ---------------------------------------------------------------- actuators


class _Stub:
    def __init__(self, ramping=False, gap=float("inf")):
        self.ramping, self.gap = ramping, gap

    def ramp_predicted(self, now=None):
        return self.ramping

    def expected_gap_s(self, now=None):
        return self.gap


class _GapHost:
    """The state the shared forecast fold and pre-touch read."""

    def __init__(self, forecaster, engine=None):
        self.forecaster = forecaster
        self.engine = engine if engine is not None else object()
        self.prewarm_total = 0
        self._prewarm_armed = True
        self._prewarm_threads = []

    _note_ramp = MicroBatcher._note_ramp


def test_utilization_lead_bounds():
    clock = _Clock()
    fc = forecast.TrafficForecaster(clock=clock, util_cap=1.0)
    for t in replay.shaped_arrivals(1500, 200.0, "ramp")[:400]:
        clock.t = float(t)
        fc.observe()
    assert fc.growth_ratio() > 1.2
    for reactive in (0.0, 0.1, 0.5, 0.9, 1.0, 1.3):
        assert fc.utilization_lead(reactive) >= reactive
    assert fc.utilization_lead(0.9) <= 1.0
    assert fc.utilization_lead(1.3) == 1.3  # measured overload passes the cap
    steady = forecast.TrafficForecaster(clock=_Clock())
    assert [steady.utilization_lead(r) for r in (0.0, 0.4, 1.0)] == [0.0, 0.4, 1.0]


@pytest.mark.parametrize("batcher", [MicroBatcher, AsyncMicroBatcher])
def test_forecast_gap_can_only_shrink(batcher):
    fold = batcher._forecast_gap_s
    host = _GapHost(None)
    assert fold(host, 0.01) == 0.01 and fold(host, None) is None
    assert fold(_GapHost(_Stub(True, 0.05)), 0.01) == 0.01
    host = _GapHost(_Stub(True, 0.002))
    assert fold(host, 0.01) == 0.002 and fold(host, None) == 0.002
    assert fold(_GapHost(_Stub(False, 0.002)), 0.01) == 0.01
    assert fold(_GapHost(_Stub(True, float("inf"))), 0.01) == 0.01


def test_prewarm_fires_once_per_ramp_episode():
    calls = []

    class Engine:
        def prewarm_touch(self):
            calls.append(1)
            return 3

    host = _GapHost(_Stub(True, 0.01), Engine())
    host._note_ramp(True)
    host._note_ramp(True)  # the same episode
    for thread in host._prewarm_threads:
        thread.join(5)
    assert len(calls) == 1 and host.prewarm_total == 3
    assert all(t.name == "kmls-prewarm" for t in host._prewarm_threads)
    host._note_ramp(False)  # the signal clears: re-armed
    host._note_ramp(True)
    for thread in host._prewarm_threads:
        thread.join(5)
    assert len(calls) == 2 and host.prewarm_total == 6


def test_forecast_knobs_parse_as_the_references(monkeypatch):
    env = {"KMLS_FORECAST": "1", "KMLS_FORECAST_HORIZON_S": "3.5",
           "KMLS_FORECAST_WINDOW_S": "0.25", "KMLS_FORECAST_ALPHA": "0.5",
           "KMLS_FORECAST_UTIL_CAP": "0.9", "KMLS_FORECAST_RAMP_RATIO": "1.4",
           "KMLS_FORECAST_PREFETCH_TOP_N": "5", "KMLS_FLEET_SELF": "replica-1",
           "KMLS_FLEET_PEERS": "replica-0,replica-1,replica-2", "KMLS_PEER_SLOW_RATIO": "3.0",
           "KMLS_HEDGE": "1", "KMLS_HEDGE_DELAY_MS": "20", "KMLS_HEDGE_MAX_FRAC": "0.5"}
    fields = [f.name for f in dataclasses.fields(ServingConfig)
              if f.name.startswith(("forecast_", "fleet_", "hedge_", "peer_slow"))]
    assert len(fields) == 13
    for env_set in ({}, env):
        for key in env:
            monkeypatch.delenv(key, raising=False)
        for key, value in env_set.items():
            monkeypatch.setenv(key, value)
        got, want = ServingConfig.from_env(None), RefServingConfig.from_env(None)
        assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert got.forecast_enabled and got.forecast_prefetch_top_n == 5


# ---------------------------------------------------------------- the app


@pytest.fixture(scope="module")
def pvc(tmp_path_factory):
    return mine_pvc(tmp_path_factory.mktemp("torch_forecast"))


def _post(app, songs):
    return app.handle("POST", "/api/recommend/", json.dumps({"songs": songs}).encode())


def _rule_seeds(app) -> list[str]:
    bundle = app.engine.bundle
    return [n for n, known in zip(bundle.vocab, bundle.known_mask) if known][:8]


def test_disabled_mode_never_observes(pvc):
    app = RecommendApp(port_cfg(pvc, cache_enabled=False), device="cpu")
    try:
        assert app.engine.load() and app.forecaster is None
        before = forecast.OBSERVATIONS_TOTAL
        for s in _rule_seeds(app)[:6]:
            assert _post(app, [s])[0] == 200
        assert forecast.OBSERVATIONS_TOTAL == before
        text = app.handle("GET", "/metrics", None)[2].decode()
        assert "kmls_forecast_" not in text and "kmls_utilization_forecast" not in text
    finally:
        app.close()


def test_enabled_mode_observes_and_renders(pvc):
    app = RecommendApp(port_cfg(pvc, cache_enabled=False, forecast_enabled=True), device="cpu")
    try:
        assert app.engine.load() and app.forecaster is not None
        before = forecast.OBSERVATIONS_TOTAL
        seeds = _rule_seeds(app)[:6]
        for s in seeds:
            assert _post(app, [s])[0] == 200
        assert forecast.OBSERVATIONS_TOTAL == before + len(seeds)
        assert app.forecaster.observations == len(seeds)
        reactive, led = app.batcher.utilization_parts()
        assert led >= reactive
        text = app.handle("GET", "/metrics", None)[2].decode()
        assert "# TYPE kmls_forecast_observations_total counter" in text
        assert f"\nkmls_forecast_observations_total {len(seeds)}" in text
        assert "# TYPE kmls_utilization_forecast gauge" in text
    finally:
        app.close()


def test_prefetch_warms_only_cooled_owned_uncached_keys(pvc):
    app = RecommendApp(port_cfg(pvc, forecast_enabled=True), device="cpu")
    try:
        assert app.engine.load()
        seeds = _rule_seeds(app)[:3]
        for s in seeds:
            assert _post(app, [s])[0] == 200
        hot = seeds[0]
        key = app._cache_key([hot])
        assert app.cache.contains(key)
        assert app._forecast_prefetch({"__untouched_name__"}) == 0
        assert app._forecast_prefetch({hot}) == 0  # still cached
        assert app.cache.invalidate_seeds({hot}) >= 1
        fresh_key = app._cache_key([hot])
        assert fresh_key != key
        assert app._forecast_prefetch({hot}) == 1
        assert app.forecast_prefetch_total == 1
        deadline = time.monotonic() + 10.0
        while not app.cache.contains(fresh_key) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert app.cache.get(fresh_key) == app.engine.recommend([hot])
        # owner-only: a ring that gives every key to another replica
        app.cache.invalidate_seeds({hot})
        app.ring, app._ring_self = RendezvousRing(["some-other-replica"]), "this-replica"
        assert app._forecast_prefetch({hot}) == 0
        assert app.forecast_prefetch_total == 1
    finally:
        app.close()


def test_delta_callback_prefetches_on_the_async_batchers_loop(pvc):
    """Through ``_on_delta_applied`` on the asyncio transport: the engine's
    poll thread hops onto the batcher's loop, which leads the re-fill."""
    import asyncio

    app = RecommendApp(port_cfg(pvc, forecast_enabled=True), device="cpu", defer_batcher=True)
    hot = None

    async def run():
        nonlocal hot
        from kmlserver_tpu_torch.serving.app import batcher_kwargs

        app.batcher = AsyncMicroBatcher(app.engine, **batcher_kwargs(app.cfg),
                                        metrics=app.metrics, forecaster=app.forecaster)
        hot = _rule_seeds(app)[0]
        response, future, t0, trace = app.submit_recommend(json.dumps({"songs": [hot]}).encode())
        assert response is None
        await future
        app.cache.invalidate_seeds({hot})
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, app._on_delta_applied, {hot}, False)
        deadline = time.monotonic() + 10.0
        while not app.cache.contains(app._cache_key([hot])) and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        app.batcher.close()

    try:
        assert app.engine.load()
        asyncio.run(run())
        assert app.forecast_prefetch_total >= 1
        assert app.cache.contains(app._cache_key([hot]))
    finally:
        app.close()
