"""The port's owner-aware serving and its gray-failure sites
(kmlserver_tpu_torch/serving/app.py fleet branch, aioserver.py, faults.py
``fleet.peer``) against the JAX package's app on one mined PVC: owner
stamps and misrouted counts, the gang-as-ring-peer 503, the fleet, hedge
and forecast series of /metrics, the ``fleet.peer`` stall fired once per
request on both transports, and the zero-cost defaults."""

import json
import time
import urllib.request

import pytest

from kmlserver_tpu.freshness.ring import RendezvousRing as RefRing
from kmlserver_tpu.serving.app import RecommendApp as RefApp
from kmlserver_tpu_torch import faults
from kmlserver_tpu_torch.config import ServingConfig
from kmlserver_tpu_torch.freshness.ring import RendezvousRing, seeds_key
from kmlserver_tpu_torch.serving import forecast, replay
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.mesh import MeshShardUnavailable

from .torch_serving_util import ServerThread, mine_pvc, port_cfg, ref_cfg, seed_sets

FLEET = "replica-0,replica-1,replica-2"


@pytest.fixture(scope="module")
def pvc(tmp_path_factory):
    return mine_pvc(tmp_path_factory.mktemp("torch_grayfailure"))


@pytest.fixture()
def clean_faults():
    faults.clear()
    yield
    faults.clear()


def _body(seeds) -> bytes:
    return json.dumps({"songs": seeds}).encode()


def _apps(pvc, **knobs):
    port = RecommendApp(port_cfg(pvc, **knobs), device="cpu")
    ref = RefApp(ref_cfg(pvc, **knobs))
    assert port.engine.load() and ref.engine.load()
    return port, ref


@pytest.mark.parametrize("me", ["replica-0", "replica-2"])
@pytest.mark.parametrize("cache", [True, False])
def test_owner_stamps_and_misrouted_counts_equal_the_references(pvc, me, cache):
    """Every request answered locally; the owner header, the misrouted
    count (non-owned misses only) and the affinity counters equal the
    reference app's, cache hits and unknown seeds included."""
    port, ref = _apps(pvc, fleet_self=me, fleet_peers=FLEET, cache_enabled=cache)
    try:
        assert port.fleet_routing and port._fleet_index == sorted(FLEET.split(",")).index(me)
        sets = seed_sets(pvc, 40, seed=9)
        for seeds in sets + sets[:15]:
            got = port.handle("POST", "/api/recommend/", _body(seeds))
            want = ref.handle("POST", "/api/recommend/", _body(seeds))
            assert got[0] == want[0] == 200
            for header in ("X-KMLS-Cache-Owner", "X-KMLS-Cache", "X-KMLS-Degraded"):
                assert got[1].get(header) == want[1].get(header), header
            assert json.loads(got[2])["songs"] == json.loads(want[2])["songs"]
        assert port.misrouted_total == ref.misrouted_total > 0
        assert (port.affinity_local_total, port.affinity_remote_total) == (
            ref.affinity_local_total, ref.affinity_remote_total)
        owners = RendezvousRing(FLEET.split(","))
        assert owners.peers == RefRing(FLEET.split(",")).peers
        assert port.affinity_remote_total == sum(
            owners.owner(seeds_key(s)) != me for s in sets + sets[:15])
    finally:
        port.close()


def test_owner_header_strips_line_breaks(pvc):
    port = RecommendApp(port_cfg(pvc, fleet_self="a", fleet_peers="a,evil\r\nX-Bad: 1"),
                        device="cpu")
    try:
        assert port.engine.load()
        stamped = [port.handle("POST", "/api/recommend/", _body(s))[1].get("X-KMLS-Cache-Owner")
                   for s in seed_sets(pvc, 30, seed=2)]
        assert "evilX-Bad: 1" in stamped
        assert not any("\r" in h or "\n" in h for h in stamped if h)
    finally:
        port.close()


def test_self_missing_from_peers_still_serves(pvc, caplog):
    port = RecommendApp(port_cfg(pvc, fleet_self="stray", fleet_peers="replica-0,replica-1"),
                        device="cpu")
    try:
        assert port.engine.load()
        assert "not in KMLS_FLEET_PEERS" in caplog.text
        assert port.ring.peers == ["replica-0", "replica-1", "stray"]
        assert port._fleet_index == 2
        assert port.handle("POST", "/api/recommend/", _body(seed_sets(pvc, 1)[0]))[0] == 200
    finally:
        port.close()


class _DarkGang:
    """An engine double whose gang misses rank 1 (the pre-check), or whose
    lookup raises MeshShardUnavailable (a member that died mid-flight)."""

    def __init__(self, engine, precheck: bool):
        self._engine, self._precheck = engine, precheck

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def mesh_missing_shards(self, probe=False):
        return [1] if self._precheck else []

    def recommend_many_async(self, seed_sets, replica=None):
        raise MeshShardUnavailable(1, "rank 1 is dark")


@pytest.mark.parametrize("precheck", [True, False])
@pytest.mark.parametrize("routed", [True, False])
@pytest.mark.parametrize("path", ["handle", "submit"])
def test_gang_as_ring_peer(pvc, precheck, routed, path):
    """A dark gang member: with the routing tier armed 503 +
    X-KMLS-Mesh-Unavailable and an integer Retry-After; standalone 200 +
    X-KMLS-Degraded: mesh-shard-missing:1 — on both app entry points."""
    knobs = dict(fleet_self="gang", fleet_peers="gang,solo") if routed else {}
    app = RecommendApp(port_cfg(pvc, cache_enabled=False, **knobs), device="cpu",
                       defer_batcher=path == "submit")
    try:
        assert app.engine.load()
        app.engine = _DarkGang(app.engine, precheck)
        if app.batcher is not None:
            app.batcher.engine = app.engine
        seeds = seed_sets(pvc, 1, seed=1)[0]
        if path == "handle":
            status, headers, body = app.handle("POST", "/api/recommend/", _body(seeds))
        else:
            from kmlserver_tpu_torch.serving.batcher import MicroBatcher

            app.batcher = MicroBatcher(app.engine, max_size=4, window_ms=1.0)
            response, future, t0, trace = app.submit_recommend(_body(seeds))
            if response is None:
                future.exception(timeout=10)
                response = app.finish_recommend(future, t0, trace)
            status, headers, body = response
        if routed:
            assert status == 503
            assert headers["X-KMLS-Mesh-Unavailable"] == "1"
            assert headers["Retry-After"].isdigit()
            assert json.loads(body) == {"detail": "serve mesh degraded: vocab shard 1 unavailable"}
        else:
            assert status == 200
            assert headers["X-KMLS-Degraded"] == "mesh-shard-missing:1"
        assert app.metrics.degraded_by_reason == {"mesh-shard-missing:1": 1}
    finally:
        app.close()


def test_mesh_retry_after_is_a_jittered_integer(tmp_path):
    app = RecommendApp(ServingConfig(base_dir=str(tmp_path), fleet_self="replica-a",
                                     fleet_peers="replica-a,replica-b", shed_retry_jitter=0.3,
                                     replica_probe_interval_s=4.0), device="cpu")
    try:
        seen = set()
        for _ in range(50):
            status, headers, _ = app._mesh_shard_response(time.perf_counter(), ["seed-a"], 1)
            assert status == 503 and headers["X-KMLS-Mesh-Unavailable"] == "1"
            assert headers["Retry-After"].isdigit() and 3 <= int(headers["Retry-After"]) <= 6
            seen.add(headers["Retry-After"])
        assert len(seen) >= 2
    finally:
        app.close()


def _type_names(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


FAMILIES = ("kmls_cache_misrouted", "kmls_fleet_peers", "kmls_hedge_", "kmls_peer_slow",
            "kmls_forecast_", "kmls_utilization", "kmls_cache_affinity")


@pytest.mark.parametrize("armed", [True, False])
def test_metrics_render_the_references_fleet_hedge_and_forecast_series(pvc, armed):
    knobs = dict(fleet_self="replica-1", fleet_peers=FLEET, forecast_enabled=True) if armed else {}
    port, ref = _apps(pvc, **knobs)
    try:
        for seeds in seed_sets(pvc, 12, seed=4):
            port.handle("POST", "/api/recommend/", _body(seeds))
            ref.handle("POST", "/api/recommend/", _body(seeds))
        got = port.handle("GET", "/metrics", None)[2].decode()
        want = ref.handle("GET", "/metrics", None)[2].decode()

        def family(text):
            return {n for n in _type_names(text) if n.startswith(FAMILIES)}

        assert family(got) == family(want)
        lines = [ln for ln in got.splitlines()
                 if ln.startswith(("kmls_cache_misrouted_total ", "kmls_fleet_peers ",
                                   "kmls_forecast_observations_total "))]
        assert lines == [ln for ln in want.splitlines() if ln in lines] or not armed
        assert ("kmls_forecast_observations_total" in got) == armed
        assert f"kmls_fleet_peers {3 if armed else 0}" in got
    finally:
        port.close()


def _arm(monkeypatch, spec: str) -> None:
    monkeypatch.setenv("KMLS_FAULT_FLEET_PEER_DELAY_MS", spec)
    faults.clear()  # forget the earlier env parse


def test_fleet_peer_fault_stalls_the_indexed_replica(pvc, monkeypatch, clean_faults):
    app = RecommendApp(port_cfg(pvc, fleet_self="replica-a",
                                fleet_peers="replica-a,replica-b"), device="cpu")
    other = RecommendApp(port_cfg(pvc, fleet_self="replica-b",
                                  fleet_peers="replica-a,replica-b"), device="cpu")
    try:
        assert app.engine.load() and other.engine.load()
        assert (app._fleet_index, other._fleet_index) == (0, 1)
        _arm(monkeypatch, "0:80:1")
        body = _body(seed_sets(pvc, 1)[0])
        t0 = time.perf_counter()
        assert other.handle("POST", "/api/recommend/", body)[0] == 200
        assert time.perf_counter() - t0 < 0.06  # not the armed replica
        t0 = time.perf_counter()
        assert app.handle("POST", "/api/recommend/", body)[0] == 200
        assert time.perf_counter() - t0 >= 0.06
        t0 = time.perf_counter()
        app.handle("POST", "/api/recommend/", body)  # times=1: spent
        assert time.perf_counter() - t0 < 0.06
        # the transport consumed it: the app does not fire it again
        _arm(monkeypatch, "0:80:1")
        t0 = time.perf_counter()
        assert app.handle("POST", "/api/recommend/", body, fire_fleet_fault=False)[0] == 200
        assert time.perf_counter() - t0 < 0.06
        assert faults.take("fleet.peer", replica=0) == pytest.approx(0.08)
    finally:
        app.close()
        other.close()


@pytest.mark.parametrize("transport", ["async", "threaded"])
def test_fleet_peer_fault_fires_once_per_request_on_each_transport(
        pvc, monkeypatch, clean_faults, transport):
    """Over a socket: an armed budget of 2 stalls exactly the first two
    requests by ~its delay, on the loop timer (async) or the handler
    thread (threaded), and no more."""
    app = RecommendApp(port_cfg(pvc, fleet_self="replica-b", fleet_peers="replica-a,replica-b"),
                       device="cpu", defer_batcher=transport == "async")
    assert app.engine.load()
    srv = ServerThread(app, transport)
    try:
        _arm(monkeypatch, "1:150:2")
        body = _body(seed_sets(pvc, 1)[0])
        times = []
        for _ in range(4):
            req = urllib.request.Request(srv.url + "/api/recommend/", data=body,
                                         headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert resp.status == 200
            times.append(time.perf_counter() - t0)
        assert min(times[:2]) >= 0.12 and max(times[2:]) < 0.12
        assert faults.take("fleet.peer", replica=1) == 0.0  # the budget is spent
    finally:
        srv.drain()
        assert srv.join() == 0
        app.close()


def test_zero_cost_defaults(pvc):
    cfg = ServingConfig()
    assert (cfg.fleet_peers, cfg.fleet_self, cfg.forecast_enabled, cfg.hedge_enabled,
            cfg.peer_slow_ratio) == ("", "", False, False, 0.0)
    app = RecommendApp(port_cfg(pvc), device="cpu")
    try:
        assert app.engine.load()
        assert not app.fleet_routing and app._fleet_index is None and app.forecaster is None
        before = forecast.OBSERVATIONS_TOTAL
        for seeds in seed_sets(pvc, 10, seed=6):
            status, headers, _ = app.handle("POST", "/api/recommend/", _body(seeds))
            assert status == 200 and "X-KMLS-Cache-Owner" not in headers
        assert forecast.OBSERVATIONS_TOTAL == before and app.misrouted_total == 0
        text = app.handle("GET", "/metrics", None)[2].decode()
        assert "kmls_fleet_peers 0" in text and "kmls_hedge_wins_total 0" in text
    finally:
        app.close()


def test_unhedged_fleet_replay_issues_no_hedge(pvc):
    """hedge=False against a live server leaves HEDGES_ISSUED where it was;
    hedge=True against two replicas (one stalled) issues and wins some,
    with identical bodies whichever copy wins."""
    apps = [RecommendApp(port_cfg(pvc, fleet_self=me, fleet_peers="replica-0,replica-1"),
                         device="cpu", defer_batcher=True) for me in ("replica-0", "replica-1")]
    for app in apps:
        assert app.engine.load()
    servers = [ServerThread(app, "async") for app in apps]
    try:
        urls = {f"replica-{i}": s.url for i, s in enumerate(servers)}
        payloads = seed_sets(pvc, 80, seed=8)
        before = replay.HEDGES_ISSUED
        report, fleet = replay.replay_fleet_http(urls, payloads, qps=400.0)
        assert report.n_errors == 0 and replay.HEDGES_ISSUED == before
        assert fleet["hedges_issued"] == 0
        # a gray replica-1: every answer 300 ms late
        faults.inject("fleet.peer", replica=1, delay_s=0.3, times=-1)
        report, fleet = replay.replay_fleet_http(
            urls, payloads, qps=100.0, hedge=True, hedge_delay_ms=20.0, hedge_max_frac=0.5,
            deadline_ms=5000.0,
        )
        assert report.n_errors == 0 and fleet["http_5xx"] == 0
        assert fleet["hedges_issued"] >= 1 and fleet["hedge_wins"] >= 1
        assert fleet["hedge_mismatch"] == 0
        assert replay.HEDGES_ISSUED == before + fleet["hedges_issued"]
    finally:
        faults.clear()
        for srv in servers:
            srv.drain()
        for srv in servers:
            assert srv.join() == 0
        for app in apps:
            app.close()
