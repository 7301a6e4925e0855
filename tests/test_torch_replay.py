"""The port's load generator (kmlserver_tpu_torch/serving/replay.py)
against the JAX package's: the same payload draws, schedule, percentiles
and response parsing, and a replay of the port's async server that
answers every request."""

import dataclasses
import json
import sys

import numpy as np
import pytest

from kmlserver_tpu.serving import replay as ref_replay
from kmlserver_tpu_torch.serving import replay
from kmlserver_tpu_torch.serving.app import RecommendApp

from .torch_serving_util import ServerThread, mine_pvc, port_cfg

VOCAB = [f"Track {i}" for i in range(40)]


@pytest.mark.parametrize(
    "vocab,n,kw",
    [
        (VOCAB, 200, {}),
        (VOCAB, 500, {"zipf_s": 1.1}),
        (VOCAB, 64, {"zipf_s": 0.7, "zipf_pool": 16, "rng_seed": 3}),
        (VOCAB[:2], 50, {"seeds_per_request": 5, "unknown_fraction": 0.5}),
        ([], 20, {}),
        (VOCAB, 0, {"zipf_s": 1.1}),
    ],
)
def test_sample_seed_sets_match_the_reference(vocab, n, kw):
    assert replay.sample_seed_sets(vocab, n, **kw) == ref_replay.sample_seed_sets(vocab, n, **kw)


@pytest.mark.parametrize("n", [0, 1, 2, 99, 1000])
def test_percentiles_and_schedule_match_the_reference(n):
    values = sorted(np.random.default_rng(n).exponential(3.0, size=n).tolist())
    for q in (0.0, 0.5, 0.95, 0.99, 0.999, 1.0):
        got, want = replay._percentile(values, q), ref_replay._percentile(values, q)
        assert got == want or (np.isnan(got) and np.isnan(want))
    if n:
        np.testing.assert_array_equal(
            replay._poisson_arrivals(n, 1000.0), ref_replay.shaped_arrivals(n, 1000.0)
        )


@pytest.mark.parametrize(
    "head",
    [
        b"HTTP/1.1 200 OK\r\nContent-Length: 42\r\nX-KMLS-Cache: hit",
        b"HTTP/1.1 429 Too Many Requests\r\ncontent-length: 7\r\nRetry-After: 1",
        b"HTTP/1.1 307 Temporary Redirect\r\nLocation: /docs",
    ],
)
def test_response_head_parse_matches_the_reference(head):
    assert replay._parse_http_head(head) == ref_replay._parse_http_head(head)


def test_report_fields_are_the_references():
    ref_fields = {f.name for f in dataclasses.fields(ref_replay.ReplayReport)}
    assert {f.name for f in dataclasses.fields(replay.ReplayReport)} <= ref_fields


def test_replay_pooled_counts_like_the_reference():
    """A deterministic in-process target: every request answered, sources
    and cache outcomes tallied the same way."""
    payloads = replay.sample_seed_sets(VOCAB, 120, zipf_s=1.1)

    def make_send():
        def send(seeds):
            if seeds[0].startswith("__replay_unknown"):
                raise RuntimeError("shed")
            return ("rules" if len(seeds) > 1 else "empty", seeds[0] < "Track 2")

        return send

    got = replay.replay_pooled(make_send, payloads, qps=2000.0, n_workers=4)
    want = ref_replay.replay_pooled(make_send, payloads, qps=2000.0, n_workers=4)
    assert got.n_errors == want.n_errors and got.by_source == want.by_source
    assert got.n_requests == 120 and got.cache_hit_ratio == want.cache_hit_ratio
    assert got.p50_ms <= got.p95_ms <= got.p99_ms


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    pvc = mine_pvc(tmp_path_factory.mktemp("torch_replay"))
    app = RecommendApp(port_cfg(pvc), device="cpu", defer_batcher=True)
    assert app.engine.load()
    srv = ServerThread(app, "async")
    yield pvc, app, srv
    srv.drain()
    assert srv.join() == 0


def test_replay_async_http_against_the_async_server(server):
    pvc, app, srv = server
    vocab = list(app.engine.bundle.vocab)
    payloads = replay.sample_seed_sets(vocab, 300, zipf_s=1.1)
    report = replay.replay_async_http(srv.url, payloads, qps=300.0, n_conns=8)
    assert report.n_errors == 0 and sum(report.by_source.values()) == 300
    assert report.achieved_qps > 0 and report.p50_ms <= report.p99_ms
    # the Zipf mix repeats payloads: the server's cache answers some
    assert 0 < report.cache_hit_ratio < 1


def test_cli_replays_a_server(server, monkeypatch, capsys):
    pvc, _, srv = server
    monkeypatch.setenv("BASE_DIR", pvc)
    monkeypatch.setattr(sys, "argv", ["replay", "--url", srv.url, "--qps", "200",
                                      "--requests", "100", "--zipf-s", "1.1"])
    assert replay.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_requests"] == 100 and out["n_errors"] == 0 and out["target_qps"] == 200.0


@pytest.mark.parametrize(
    "n,qps,shape,kw",
    [
        (500, 1000.0, "constant", {}),
        (8000, 1000.0, "ramp", {"ramp_stop_factor": 3.0, "rng_seed": 41}),
        (8000, 1000.0, "sine", {"rng_seed": 43}),
        (8000, 1000.0, "constant", {"rng_seed": 47}),
        (3000, 400.0, "burst", {}),
        (2000, 50.0, "burst", {"burst_factor": 4.0, "burst_fraction": 0.3, "n_bursts": 2}),
        (1500, 200.0, "ramp", {"ramp_start_factor": 0.5, "ramp_stop_factor": 1.5}),
        (1500, 200.0, "sine", {"sine_amplitude": 0.99, "sine_cycles": 0.5}),
        (0, 100.0, "ramp", {}),
    ],
)
def test_shaped_arrivals_equal_the_references(n, qps, shape, kw):
    np.testing.assert_array_equal(replay.shaped_arrivals(n, qps, shape, **kw),
                                  ref_replay.shaped_arrivals(n, qps, shape, **kw))


def test_unknown_shape_raises():
    for mod in (replay, ref_replay):
        with pytest.raises(ValueError):
            mod.shaped_arrivals(10, 10.0, "square")
    assert replay.REPLAY_SHAPES == ref_replay.REPLAY_SHAPES


@pytest.mark.parametrize(
    "kw", [{}, {"window": (0.1, 0.2), "hot_pool": 2}, {"window": (0.5, 0.5)}, {"hot_pool": 50}]
)
def test_flash_crowd_payloads_equal_the_references(kw):
    payloads = replay.sample_seed_sets(VOCAB, 400, zipf_s=1.1)
    assert replay.flash_crowd_payloads(payloads, **kw) == ref_replay.flash_crowd_payloads(
        payloads, **kw)


@pytest.mark.parametrize("span", [0.0, 1.0, 7.5])
def test_onset_steady_split_equals_the_references(span):
    rng = np.random.default_rng(3)
    points = list(zip(rng.uniform(0, 7.5, 500).tolist(), rng.exponential(4.0, 500).tolist()))
    assert replay.onset_steady_p99(points, span) == ref_replay.onset_steady_p99(points, span)
    assert replay.onset_steady_p99([], 1.0) == (None, None)


def test_attach_attribution_equals_the_references():
    from kmlserver_tpu.serving.metrics import ServingMetrics as RefMetrics
    from kmlserver_tpu_torch.serving.metrics import ServingMetrics

    got_m, want_m = ServingMetrics(), RefMetrics()
    for i in range(50):
        for m in (got_m, want_m):
            m.record_attribution(0.001 * i, 0.0005 * i, 0.002 * i)
    fields = dict(target_qps=1.0, offered_qps=1.0, achieved_qps=1.0, duration_s=1.0,
                  n_requests=1, n_errors=0, p50_ms=1.0, p95_ms=1.0, p99_ms=1.0, by_source={})
    got = replay.attach_attribution(replay.ReplayReport(**fields), got_m)
    want = ref_replay.attach_attribution(ref_replay.ReplayReport(**fields), want_m)
    for key in ("queue_wait_p50_ms", "queue_wait_p99_ms", "device_p50_ms", "device_p99_ms",
                "e2e_p999_ms"):
        assert getattr(got, key) == getattr(want, key), key


@pytest.mark.parametrize("driver", ["replay", "replay_pooled"])
def test_shaped_drivers_fire_events_and_count_like_the_reference(driver):
    """Both drivers under a shaped schedule and two mid-run events: each
    event fires once at its index, and answers, errors, sources and the
    cache split tally as the reference's."""
    payloads = replay.flash_crowd_payloads(replay.sample_seed_sets(VOCAB, 150, zipf_s=1.1))
    arrivals = replay.shaped_arrivals(150, 3000.0, "burst")

    def make_send():
        def send(seeds):
            if seeds[0].startswith("__replay_unknown"):
                raise RuntimeError("shed")
            return ("rules" if len(seeds) > 1 else "empty", seeds[0] < "Track 2")

        return send

    reports = []
    for mod in (replay, ref_replay):
        fired = []
        events = [(40, lambda: fired.append(40)), (90, lambda: fired.append(90))]
        if driver == "replay":
            rep = mod.replay(make_send(), payloads, qps=3000.0, arrivals=arrivals, events=events)
        else:
            rep = mod.replay_pooled(make_send, payloads, qps=3000.0, n_workers=4,
                                    arrivals=arrivals, events=events)
            assert rep.onset_p99_ms is not None and rep.steady_p99_ms is not None
        assert fired == [40, 90]
        reports.append(rep)
    got, want = reports
    assert (got.n_errors, got.by_source, got.cache_hit_ratio, got.n_requests) == (
        want.n_errors, want.by_source, want.cache_hit_ratio, want.n_requests)


def test_cli_fleet_replays_a_one_replica_fleet(server, monkeypatch, capsys):
    pvc, _, srv = server
    monkeypatch.setenv("BASE_DIR", pvc)
    monkeypatch.setattr(sys, "argv", ["replay", "--fleet", f"replica-0={srv.url}", "--qps",
                                      "200", "--requests", "60", "--zipf-s", "1.1"])
    assert replay.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_errors"] == 0 and out["fleet"]["answered_by"] == {"replica-0": 60}
    monkeypatch.setattr(sys, "argv", ["replay", "--fleet", f"replica-0={srv.url}",
                                      "--shape", "ramp"])
    assert replay.main() == 1  # shaped fleet runs are refused, not mislabelled


def test_cli_pooled_client_paces_a_shape(server, monkeypatch, capsys):
    pvc, _, srv = server
    monkeypatch.setenv("BASE_DIR", pvc)
    monkeypatch.setattr(sys, "argv", ["replay", "--url", srv.url, "--qps", "300", "--requests",
                                      "90", "--shape", "sine", "--workers", "4"])
    assert replay.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_requests"] == 90 and out["n_errors"] == 0
    assert out["onset_p99_ms"] is not None
