"""The port's REST app and transports (kmlserver_tpu_torch/serving/app.py,
aioserver.py, server.py) against the JAX package's ``RecommendApp`` over
the same PVC: every ported route on status, JSON body and the headers this
slice carries — the degraded paths, the shed and the cache hit included —
then both transports on a socket, under concurrent load, and their drain."""

import concurrent.futures
import http.client
import json
import socket
import threading
import time

import pytest

from kmlserver_tpu.serving.app import RecommendApp as RefApp
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu.serving.metrics import METRIC_REGISTRY as REF_REGISTRY
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.replay import replay_async_http

from .torch_serving_util import ServerThread, mine_pvc, port_cfg, ref_cfg, seed_sets, wrap_engine

HEADERS = ("Content-Type", "Location", "Retry-After", "X-KMLS-Cache", "X-KMLS-Degraded")


@pytest.fixture(scope="module")
def pvc(tmp_path_factory):
    return mine_pvc(tmp_path_factory.mktemp("torch_app"))


# port apps built by a test, closed by _close_port_apps after it: the
# threaded batcher's collector and completion threads would otherwise stay
# parked for the rest of the session
_OPEN_APPS: list = []


def _port_app(*args, **kwargs) -> RecommendApp:
    app = RecommendApp(*args, **kwargs)
    _OPEN_APPS.append(app)
    return app


@pytest.fixture(autouse=True)
def _close_port_apps():
    n = len(_OPEN_APPS)
    yield
    while len(_OPEN_APPS) > n:
        _OPEN_APPS.pop().close()


def _apps(pvc, *, delay_s=0.0, fail=False, **knobs):
    """(port app on the CPU, reference app), engines loaded (and wrapped)."""
    port = _port_app(port_cfg(pvc, **knobs), device="cpu")
    ref = RefApp(ref_cfg(pvc, **knobs))
    assert port.engine.load() and ref.engine.load()
    if delay_s or fail:
        wrap_engine(port.engine, delay_s=delay_s, fail=fail)
        wrap_engine(ref.engine, delay_s=delay_s, fail=fail)
    return port, ref


def _view(response, json_body=True):
    status, headers, body = response
    kept = {k: v for k, v in headers.items() if k in HEADERS}
    return status, kept, json.loads(body) if json_body and body else body


def _post(app, payload, **kw):
    body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    return app.handle("POST", "/api/recommend/", body, **kw)


@pytest.fixture(scope="module")
def apps(pvc):
    port, ref = _apps(pvc)
    yield port, ref
    _OPEN_APPS.remove(port)
    port.close()


def test_recommend_route_matches_the_reference(apps, pvc):
    port, ref = apps
    payloads = [{"songs": s} for s in seed_sets(pvc, 40)]
    payloads += [
        {"songs": []}, {"songs": "a"}, {"songs": [1, 2]}, {"tracks": ["a"]}, [], b"{not json",
        b"", {"songs": ["No Such Track"]},
    ]
    for payload in payloads:
        want = _view(_post(ref, payload))
        assert _view(_post(port, payload)) == want, payload
    # the same payload again is a cache hit, marked, with the same body
    for payload in payloads[:5]:
        want = _view(_post(ref, payload))
        assert want[1].get("X-KMLS-Cache") == "hit"
        assert _view(_post(port, payload)) == want


@pytest.mark.parametrize(
    "method,path,host",
    [
        ("GET", "/healthz", None), ("GET", "/openapi.json", None), ("GET", "/nope", None),
        ("POST", "/healthz", None), ("GET", "/api/recommend/", None),
        ("POST", "/metrics/reset", "10.0.0.7"), ("POST", "/metrics/reset", "::ffff:8.8.8.8"),
        ("POST", "/metrics/reset", "::ffff:127.0.0.1"), ("GET", "/static/../app.py", None),
        ("GET", "/static/nope.css", None),
    ],
)
def test_json_routes_match_the_reference(apps, method, path, host):
    port, ref = apps
    want = _view(ref.handle(method, path, None, client_host=host))
    got = _view(port.handle(method, path, None, client_host=host))
    if path == "/metrics/reset" and want[0] == 200:
        assert set(got[2]) == set(want[2]) and got[2]["status"] == "reset"
        return
    assert got == want


def test_page_routes_match_the_reference(apps):
    port, ref = apps
    assert _view(port.handle("GET", "/test", None), False) == _view(
        ref.handle("GET", "/test", None), False)
    for path in ("/", "/docs", "/static/style.css"):
        got, want = port.handle("GET", path, None), ref.handle("GET", path, None)
        assert got[:2] == want[:2], path
    assert port.handle("GET", "/static/style.css", None) == ref.handle(
        "GET", "/static/style.css", None)
    page = port.handle("GET", "/", None)[2].decode()
    assert "{{" not in page and 'type="checkbox"' in page


def test_readyz_and_metrics(apps, pvc):
    port, ref = apps
    status, _, body = _view(port.handle("GET", "/readyz", None))
    _, _, ref_body = _view(ref.handle("GET", "/readyz", None))
    assert status == 200 and body["status"] == ref_body["status"] == "ready"
    assert set(body["artifact_age_seconds"]) == set(ref_body["artifact_age_seconds"])
    cold = _port_app(port_cfg(pvc + "-missing"), device="cpu")
    ref_cold = RefApp(ref_cfg(pvc + "-missing"))
    assert _view(cold.handle("GET", "/readyz", None)) == _view(
        ref_cold.handle("GET", "/readyz", None))
    text = port.handle("GET", "/metrics", None)[2].decode()
    names = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}
    assert names and all(name in REF_REGISTRY for name in names), names - set(REF_REGISTRY)
    assert "kmls_device_dispatch_total" in names and "kmls_utilization" in names


def test_shed_answers_429_with_retry_after(pvc):
    """A slow engine and a tiny queue budget: a request arriving while a
    batch is in flight is shed with an integer Retry-After."""
    knobs = dict(batch_max_size=1, batch_max_inflight=1, shed_queue_budget_ms=1.0,
                 shed_soft_ratio=1.0, shed_hard_ratio=1.0, shed_retry_jitter=0.0)
    views = []
    for app in _apps(pvc, delay_s=0.3, **knobs):
        sets = seed_sets(pvc, 2, seed=9)
        first = threading.Thread(target=_post, args=(app, {"songs": sets[0]}))
        first.start()
        time.sleep(0.1)
        views.append(_view(_post(app, {"songs": sets[1]})))
        first.join(10)
    got, want = views
    assert got[0] == want[0] == 429
    assert got[1] == want[1] == {"Content-Type": "application/json", "Retry-After": "1"}
    assert got[2]["detail"].startswith("overloaded: projected queue wait")


def test_deadline_and_expired_budget_degrade_like_the_reference(pvc):
    port, ref = _apps(pvc, delay_s=0.3, request_deadline_ms=50.0)
    sets = seed_sets(pvc, 3, seed=10)
    want = _view(_post(ref, {"songs": sets[0]}))
    assert want[1]["X-KMLS-Degraded"] == "deadline"
    assert _view(_post(port, {"songs": sets[0]})) == want
    want = _view(_post(ref, {"songs": sets[1]}, budget_header="0"))
    assert want[1]["X-KMLS-Degraded"] == "deadline-expired"
    assert _view(_post(port, {"songs": sets[1]}, budget_header="0")) == want
    for app in (port, ref):
        assert app.deadline_expired_total == 1


def test_replica_failure_past_the_threshold_degrades_to_replica_loss(pvc):
    """The first failed batch is a 500 (the error propagates); it ejects
    the only replica, so later requests answer from the fallback with
    X-KMLS-Degraded: replica-loss, and /readyz says degraded."""
    port, ref = _apps(pvc, fail=True, replica_eject_threshold=1,
                      replica_probe_interval_s=60.0)
    sets = seed_sets(pvc, 4, seed=11)
    for seeds in sets:
        want = _view(_post(ref, {"songs": seeds}))
        assert _view(_post(port, {"songs": seeds})) == want
    assert want[1]["X-KMLS-Degraded"] == "replica-loss"
    assert _view(port.handle("GET", "/readyz", None))[2]["reasons"] == ["replicas ejected: [0]"]


def _answer(engine, seeds):
    songs, _ = engine.recommend(seeds)
    return {"songs": songs, "model_date": engine.cache_value, "version": "V1.1"}


@pytest.mark.parametrize("transport", ["async", "threaded"])
def test_transport_answers_concurrent_load_like_the_reference(pvc, transport):
    """200 distinct seed sets, pipelined over 16 connections: multi-row
    batches form, and every body equals the reference engine's answer
    (admission off: the CPU lookups here are slow enough to shed)."""
    app = _port_app(port_cfg(pvc, shed_queue_budget_ms=0.0), device="cpu",
                       defer_batcher=transport == "async")
    assert app.engine.load()
    ref = RefEngine(ref_cfg(pvc))
    assert ref.load()
    server = ServerThread(app, transport)
    try:
        sets = seed_sets(pvc, 200, seed=12)
        responses = []
        report = replay_async_http(server.url, sets, qps=2000.0, n_conns=16, responses=responses)
        assert report.n_errors == 0 and len(responses) == 200
        for i, status, _head, body in responses:
            assert status == 200 and json.loads(body) == _answer(ref, sets[i]), sets[i]
        assert sum(app.engine.dispatch_counts) < 200
        assert app.engine.unwarmed_dispatches == 0
    finally:
        server.drain()
    assert server.join() == 0


@pytest.mark.parametrize("transport", ["async", "threaded"])
def test_drain_closes_keepalive_and_exits(pvc, transport, monkeypatch):
    """The SIGTERM drain, in process: a keep-alive connection gets its next
    answer with Connection: close, the listener refuses new connections,
    an idle keep-alive connection does not hold the exit, and the
    transport returns 0."""
    monkeypatch.setenv("KMLS_DRAIN_SETTLE_S", "3")
    app = _port_app(port_cfg(pvc), device="cpu", defer_batcher=transport == "async")
    assert app.engine.load()
    server = ServerThread(app, transport)
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=5)
    idle = http.client.HTTPConnection("127.0.0.1", server.port, timeout=5)
    for c in (conn, idle):
        c.request("GET", "/healthz")
        r = c.getresponse()
        r.read()
        assert (r.getheader("Connection") or "").lower() != "close"
    server.drain()
    time.sleep(0.2)
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    r.read()
    assert r.status == 200 and r.getheader("Connection", "").lower() == "close"
    time.sleep(1.0)  # past the threaded accept loop's shutdown poll
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", server.port), timeout=2).close()
    assert server.join() == 0
    idle.close()
    conn.close()


def test_threaded_transport_serves_post_and_get(pvc):
    """A plain keep-alive client over the threaded transport: recommend,
    a 400 (not counted as a request) and /metrics on one connection,
    then 32 concurrent clients."""
    app = _port_app(port_cfg(pvc), device="cpu")
    assert app.engine.load()
    server = ServerThread(app, "threaded")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
        seeds = seed_sets(pvc, 1, seed=13)[0]
        for payload, status in (({"songs": seeds}, 200), ({"songs": []}, 400)):
            conn.request("POST", "/api/recommend/", json.dumps(payload))
            r = conn.getresponse()
            body = json.loads(r.read())
            assert r.status == status
        assert body == {"detail": "Request with no songs"}
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        assert r.status == 200 and b"kmls_requests_total 1\n" in r.read()
        conn.close()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            statuses = list(pool.map(
                lambda s: _http_status(server.port, s), seed_sets(pvc, 32, seed=14)))
        assert statuses == [200] * 32
    finally:
        server.drain()
    assert server.join() == 0


def _http_status(port, seeds):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", "/api/recommend/", json.dumps({"songs": seeds}))
        r = conn.getresponse()
        r.read()
        return r.status
    finally:
        conn.close()
