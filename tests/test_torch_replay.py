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
