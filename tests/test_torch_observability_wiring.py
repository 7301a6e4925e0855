"""The observability package wired into the port's serving front end and
mining job, against the JAX package over the same PVC and CSV: trace ids
echoed and replaced, the /debug routes' keys, statuses and loopback guard,
the queue/device/cache/compose spans through both batchers and both
transports, the loop-lag escalation of the admission ladder, the engine's
serve_rules cost observations and first-shape counter, the zero-cost
proofs with tracing and the cost model off, and job_metrics.prom from a
full and a resumed job."""

import asyncio
import dataclasses
import http.client
import json
import os
import random
import re
import threading
import time

import pytest

from kmlserver_tpu import faults as ref_faults
from kmlserver_tpu.mining.pipeline import run_mining_job as ref_run_mining_job
from kmlserver_tpu.observability import costmodel as ref_costmodel
from kmlserver_tpu.serving.app import RecommendApp as RefApp
from kmlserver_tpu.serving.engine import RecommendEngine as RefEngine
from kmlserver_tpu_torch import faults
from kmlserver_tpu_torch.mining.pipeline import run_mining_job
from kmlserver_tpu_torch.observability import SpanRecorder, costmodel
from kmlserver_tpu_torch.serving.app import RecommendApp
from kmlserver_tpu_torch.serving.batcher import AsyncMicroBatcher, MicroBatcher
from kmlserver_tpu_torch.serving.engine import RecommendEngine
from kmlserver_tpu_torch.serving.replay import ClientTraceLog, replay_async_http

from .torch_chaos_util import port_mining_cfg, ref_mining_cfg, write_dataset
from .torch_serving_util import ServerThread, mine_pvc, port_cfg, ref_cfg, seed_sets

_OPEN_APPS: list = []


@pytest.fixture(scope="module")
def pvc(tmp_path_factory):
    return mine_pvc(tmp_path_factory.mktemp("torch_observability"))


@pytest.fixture(autouse=True)
def _close_port_apps():
    n = len(_OPEN_APPS)
    yield
    while len(_OPEN_APPS) > n:
        _OPEN_APPS.pop().close()


def _port_app(cfg, **kwargs) -> RecommendApp:
    app = RecommendApp(cfg, device="cpu", **kwargs)
    _OPEN_APPS.append(app)
    return app


def _apps(pvc, **knobs):
    port = _port_app(port_cfg(pvc, **knobs))
    ref = RefApp(ref_cfg(pvc, **knobs))
    assert port.engine.load() and ref.engine.load()
    return port, ref


def _post(app, songs, trace_header=None):
    return app.handle("POST", "/api/recommend/", json.dumps({"songs": songs}).encode(),
                      trace_header=trace_header)


def _known_sets(pvc, n, seed=0):
    """Seed sets whose every seed is a rule key (each batch launches)."""
    engine = RecommendEngine(port_cfg(pvc), device="cpu")
    assert engine.load()
    keys = [name for name, known in zip(engine.bundle.vocab, engine.bundle.known_mask) if known]
    rng = random.Random(seed)
    return [rng.sample(keys, rng.randint(1, 4)) for _ in range(n)]


def _keys(obj):
    """The nested key structure of a JSON object (lists by first element)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return type(obj).__name__ if obj is not None else None


def _assert_spans_fit(trace: dict, names=("cache", "queue", "device", "compose")):
    spans = {s["name"]: s for s in trace["spans"]}
    for name in names:
        assert name in spans, (name, list(spans))
    total = sum(s["duration_ms"] for s in trace["spans"])
    assert total <= trace["duration_ms"] * 1.05 + 0.5, (total, trace["duration_ms"])
    for span in trace["spans"]:
        assert span["duration_ms"] >= 0.0 and -0.1 <= span["start_ms"] <= trace["duration_ms"] + 0.1
    assert spans["queue"]["attrs"]["batch"] >= 1 and spans["device"]["attrs"] == {"replica": 0}


# ---------------------------------------------------------------------------
# the app: trace ids, /debug routes, zero cost
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("header", ["client-1", "client-2:parent-9", "bad id!", None])
def test_trace_id_echoed_or_replaced_like_the_reference(pvc, header):
    port, ref = _apps(pvc, trace_sample=1.0)
    seeds = seed_sets(pvc, 1, seed=21)[0]
    got, want = _post(port, seeds, header), _post(ref, seeds, header)
    assert got[0] == want[0] == 200 and got[2] == want[2]
    port_id, ref_id = got[1]["X-KMLS-Trace"], want[1]["X-KMLS-Trace"]
    if header and header.split(":")[0] != "bad id!":
        assert port_id == ref_id == header.split(":")[0]
    else:
        assert re.fullmatch("[0-9a-f]{16}", port_id) and re.fullmatch("[0-9a-f]{16}", ref_id)
    traces = json.loads(port.handle("GET", "/debug/traces", None)[2])["traces"]
    assert traces[-1]["trace_id"] == port_id
    if header == "client-2:parent-9":
        assert traces[-1]["parent_id"] == "parent-9"


def test_debug_payloads_have_the_references_keys(pvc):
    port, ref = _apps(pvc, trace_sample=1.0)
    for seeds in seed_sets(pvc, 6, seed=22):
        _post(port, seeds, "k")
        _post(ref, seeds, "k")
    for path in ("/debug/traces", "/debug/slo"):
        got, want = port.handle("GET", path, None), ref.handle("GET", path, None)
        assert got[0] == want[0] == 200, path
        assert _keys(json.loads(got[2])) == _keys(json.loads(want[2])), path
    traces = json.loads(port.handle("GET", "/debug/traces", None)[2])["traces"]
    ref_traces = json.loads(ref.handle("GET", "/debug/traces", None)[2])["traces"]
    assert [t["status"] for t in traces] == [t["status"] for t in ref_traces]
    assert [[s["name"] for s in t["spans"]] for t in traces] == [
        [s["name"] for s in t["spans"]] for t in ref_traces]


@pytest.mark.parametrize("path", ["/debug/traces", "/debug/slo", "/debug/profile?seconds=1"])
@pytest.mark.parametrize("host", ["10.0.0.7", "::ffff:8.8.8.8", "127.0.0.1", "::1", None])
def test_debug_routes_guard_and_status_like_the_reference(pvc, monkeypatch, path, host):
    monkeypatch.delenv("KMLS_PROFILE_DIR", raising=False)
    port, ref = _apps(pvc)
    got = port.handle("GET", path, None, client_host=host)
    want = ref.handle("GET", path, None, client_host=host)
    assert got[0] == want[0]
    if got[0] in (403, 409):  # the guard, and a profile without KMLS_PROFILE_DIR
        assert got[2] == want[2]
    loopback = host in ("127.0.0.1", "::1", None)
    assert got[0] == (403 if not loopback else 409 if "profile" in path else 200)


@pytest.mark.parametrize("query", ["seconds=nan", "seconds=inf", "seconds=abc"])
def test_debug_profile_rejects_a_bad_duration_like_the_reference(pvc, monkeypatch, tmp_path,
                                                                  query):
    monkeypatch.setenv("KMLS_PROFILE_DIR", str(tmp_path))
    port, ref = _apps(pvc)
    got = port.handle("GET", f"/debug/profile?{query}", None)
    want = ref.handle("GET", f"/debug/profile?{query}", None)
    assert got[0] == want[0] == 422 and got[2] == want[2]


def test_debug_profile_captures_a_trace_under_load(pvc, monkeypatch, tmp_path):
    monkeypatch.setenv("KMLS_PROFILE_DIR", str(tmp_path))
    port = _port_app(port_cfg(pvc))
    assert port.engine.load()
    status, _, body = port.handle("GET", "/debug/profile?seconds=0.5", None)
    doc = json.loads(body)
    assert status == 202 and doc["status"] == "capturing" and doc["seconds"] == 0.5
    assert port.handle("GET", "/debug/profile?seconds=1", None)[0] == 409  # one at a time
    for seeds in seed_sets(pvc, 10, seed=23):
        assert _post(port, seeds)[0] == 200
    port._profile_thread.join(30)
    assert not port._profile_thread.is_alive()
    files = os.listdir(doc["dir"])
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(doc["dir"], files[0])) as fh:
        assert json.load(fh)["traceEvents"]


def test_tracing_off_builds_nothing(pvc):
    port, ref = _apps(pvc)
    for app in (port, ref):
        assert not app.recorder.enabled
        for seeds in seed_sets(pvc, 5, seed=24):
            status, headers, _ = _post(app, seeds, trace_header="want-a-trace")
            assert status == 200 and "X-KMLS-Trace" not in headers
        assert app.recorder.began == 0 and app.recorder.retained_total == 0
        text = app.handle("GET", "/metrics", None)[2].decode()
        assert "kmls_traces_began_total 0" in text and "kmls_trace_buffer_entries 0" in text
        assert "kmls_loop_lag_ms 0.0" in text
        assert json.loads(app.handle("GET", "/debug/traces", None)[2])["traces"] == []


def test_cost_model_off_observes_nothing(pvc):
    before = costmodel.OBSERVATIONS_TOTAL
    ref_before = ref_costmodel.OBSERVATIONS_TOTAL
    port, ref = _apps(pvc, costmodel_enabled=False, cache_enabled=False)
    assert port.engine.cost_model is None and ref.engine.cost_model is None
    for seeds in _known_sets(pvc, 8, seed=25):
        assert _post(port, seeds)[0] == _post(ref, seeds)[0] == 200
    assert costmodel.OBSERVATIONS_TOTAL == before
    assert ref_costmodel.OBSERVATIONS_TOTAL == ref_before
    for app in (port, ref):
        text = app.handle("GET", "/metrics", None)[2].decode()
        assert "kmls_kernel_" not in text and "kmls_mfu" not in text
        assert "kmls_costmodel_observations_total" not in text


# ---------------------------------------------------------------------------
# the engine's cost observations
# ---------------------------------------------------------------------------


def test_serve_rules_observations_equal_the_references(pvc):
    port = RecommendEngine(port_cfg(pvc), device="cpu")
    ref = RefEngine(ref_cfg(pvc))
    assert port.load() and ref.load()
    batches = [_known_sets(pvc, n, seed=26 + n) for n in (1, 3, 8, 5, 2)]
    for batch in batches:
        assert port.recommend_many(batch) == ref.recommend_many(batch)
    got = port.cost_model.kernel_stats()["serve_rules"]
    want = ref.cost_model.kernel_stats()["serve_rules"]
    for key in ("dispatches", "flops", "bytes"):
        assert got[key] == want[key], key
    assert got["dispatches"] == len(batches) and got["device_s"] > 0.0
    assert port.cost_model.compiles_post_publish() == {"serve_rules": 0}
    assert port.cost_model.tensor_bytes == ref.cost_model.tensor_bytes
    assert port.cost_model.budget_bytes == ref.cost_model.budget_bytes
    assert port.cost_model.peak_source == "auto:cpu"
    text = "\n".join(port.cost_model.render_lines())
    ref_text = "\n".join(ref.cost_model.render_lines())
    names = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}
    ref_names = {line.split()[2] for line in ref_text.splitlines() if line.startswith("# TYPE")}
    assert names == ref_names


def test_unwarmed_dispatches_are_the_compile_counter_across_publications(pvc):
    port = RecommendEngine(port_cfg(pvc), device="cpu")
    assert port.load()
    sets = _known_sets(pvc, 12, seed=31)  # 12 rows > batch_max_size 8: an unwarmed bucket
    port.recommend_many(sets)
    assert port.unwarmed_dispatches == 1
    assert port.cost_model.compiles_post_publish() == {"serve_rules": 1}
    # a re-publication banks the count; its warm-up adds nothing
    port.finished_loading = False
    assert port.load()
    assert port.cost_model.compiles_post_publish() == {"serve_rules": 1}
    port.recommend_many(sets)
    assert port.cost_model.compiles_post_publish() == {"serve_rules": 2} == {
        "serve_rules": port.unwarmed_dispatches}


# ---------------------------------------------------------------------------
# batcher spans and the loop-lag escalation
# ---------------------------------------------------------------------------


def test_threaded_batcher_records_queue_and_device_spans(pvc):
    engine = RecommendEngine(port_cfg(pvc), device="cpu")
    assert engine.load()
    rec = SpanRecorder(sample=1.0)
    batcher = MicroBatcher(engine, max_size=8, window_ms=2.0)
    try:
        sets = _known_sets(pvc, 6, seed=32)
        traces = [rec.begin(f"t{i}") for i in range(len(sets))]
        futures = [batcher.submit(s, trace=t) for s, t in zip(sets, traces)]
        results = [f.result(timeout=30) for f in futures]
    finally:
        batcher.close()
    assert results == engine.recommend_many(sets)
    for trace in traces:
        names = [name for name, *_ in trace.spans]
        assert names == ["queue", "device"]
        (_, q0, q1, q_attrs), (_, d0, d1, d_attrs) = trace.spans
        assert q0 <= q1 == d0 <= d1 and q_attrs["batch"] >= 1 and d_attrs == {"replica": 0}


def test_async_batcher_records_queue_and_device_spans(pvc):
    engine = RecommendEngine(port_cfg(pvc), device="cpu")
    assert engine.load()
    rec = SpanRecorder(sample=1.0)
    sets = _known_sets(pvc, 6, seed=33)
    traces = [rec.begin(f"a{i}") for i in range(len(sets))]

    async def run():
        batcher = AsyncMicroBatcher(engine, max_size=8, window_ms=2.0)
        try:
            return await asyncio.gather(*(batcher.submit(s, trace=t)
                                          for s, t in zip(sets, traces)))
        finally:
            batcher.close()

    assert list(asyncio.run(run())) == engine.recommend_many(sets)
    for trace in traces:
        assert [name for name, *_ in trace.spans] == ["queue", "device"]


def test_a_stalled_loop_escalates_the_ladder_with_no_5xx(pvc):
    """The drift tick sees a 200 ms stall of the serving loop; the
    requests after it degrade or shed (200 + X-KMLS-Degraded, or 429)
    where the queue projection alone saw nothing, and none is a 5xx."""
    app = _port_app(port_cfg(pvc, shed_queue_budget_ms=50.0, cache_enabled=False,
                             trace_sample=1e-9, loop_lag_half_life_s=0.4),
                    defer_batcher=True)
    assert app.engine.load()
    app.recorder = SpanRecorder(sample=1e-9, rng=random.Random(9))
    sets = seed_sets(pvc, 8, seed=34)

    async def scenario():
        app.batcher = AsyncMicroBatcher(app.engine, max_size=4, window_ms=1.0,
                                        shed_queue_budget_ms=50.0, lag_monitor=app.loop_lag)
        app.loop_lag.interval_s = 0.01
        app.loop_lag.start_on_loop(asyncio.get_running_loop())
        await asyncio.sleep(0.05)
        time.sleep(0.2)  # the loop stalls (deliberately not awaited)
        await asyncio.sleep(0.02)  # the overdue tick notes the stall
        lag = app.loop_lag.lag_s()
        statuses = []
        for seeds in sets:
            response, future, t0, trace = app.submit_recommend(
                json.dumps({"songs": seeds}).encode())
            if future is not None:
                await future
                response = app.finish_recommend(future, t0, trace=trace)
            statuses.append((response[0], response[1].get("X-KMLS-Degraded")))
        app.batcher.close()
        return lag, statuses

    lag, statuses = asyncio.run(scenario())
    assert lag > 0.1, lag
    assert all(code < 500 for code, _ in statuses), statuses
    assert any(code == 429 or why == "overload" for code, why in statuses), statuses
    retained = {(t["status"], t["attrs"].get("admission"))
                for t in app.recorder.debug_payload()["traces"]}
    assert retained & {("shed", "shed"), ("degraded", "degrade")}
    text = app.handle("GET", "/metrics", None)[2].decode()
    assert float(re.search(r"^kmls_loop_lag_ms (\S+)$", text, re.M).group(1)) > 0.0


@pytest.mark.parametrize("lag_monitor", [True, False])
def test_a_noted_stall_escalates_the_threaded_ladder(pvc, lag_monitor):
    knobs = dict(shed_queue_budget_ms=50.0, cache_enabled=False,
                 loop_lag_half_life_s=5.0 if lag_monitor else 0.0)
    app = _port_app(port_cfg(pvc, **knobs))
    assert app.engine.load()
    assert (app.loop_lag is not None) == lag_monitor
    if lag_monitor:
        app.loop_lag.note(0.3)  # 6x the budget: past the hard ratio
    responses = [_post(app, s) for s in seed_sets(pvc, 6, seed=35)]
    statuses = [(code, headers.get("X-KMLS-Degraded")) for code, headers, _ in responses]
    assert all(code < 500 for code, _ in statuses)
    if lag_monitor:
        assert all(code == 429 for code, _ in statuses), statuses
    else:  # the control arm: without the fold the stall is invisible
        assert all(code == 200 and why is None for code, why in statuses), statuses


# ---------------------------------------------------------------------------
# both transports on a socket
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["async", "threaded"])
def test_transport_traces_joins_and_drives_the_lag_monitor(pvc, transport, tmp_path):
    app = _port_app(port_cfg(pvc, trace_sample=1.0, shed_queue_budget_ms=0.0),
                    defer_batcher=transport == "async")
    assert app.engine.load()
    server = ServerThread(app, transport)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
        seeds = _known_sets(pvc, 1, seed=36)[0]
        conn.request("POST", "/api/recommend/", json.dumps({"songs": seeds}),
                     headers={"X-KMLS-Trace": f"{transport}-cli-1:bench-7"})
        r = conn.getresponse()
        r.read()
        assert r.status == 200 and r.getheader("X-KMLS-Trace") == f"{transport}-cli-1"
        log = ClientTraceLog()
        sets = seed_sets(pvc, 60, seed=37)
        report = replay_async_http(server.url, sets, qps=500.0, n_conns=8, trace_log=log)
        assert report.n_errors == 0 and len(log.entries()) == len(sets)
        conn.request("GET", "/debug/traces")
        r = conn.getresponse()
        doc = json.loads(r.read())
        conn.close()
        by_id = {t["trace_id"]: t for t in doc["traces"]}
        first = by_id[f"{transport}-cli-1"]
        assert first["parent_id"] == "bench-7"
        _assert_spans_fit(first)
        joined = [e for e in log.entries() if e["trace_id"] in by_id]
        assert len(joined) == len(sets)
        for entry in joined:
            trace = by_id[entry["trace_id"]]
            assert trace["duration_ms"] <= entry["client_rtt_ms"] + 0.5
        deadline = time.monotonic() + 10
        while app.loop_lag.ticks == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert app.loop_lag.ticks > 0
    finally:
        server.drain()
    assert server.join() == 0
    ticks = app.loop_lag.ticks
    time.sleep(0.2)
    assert app.loop_lag.ticks == ticks  # the drain stopped the driver
    assert not [t for t in threading.enumerate()
                if t.name == "kmls-loop-lag" and t.is_alive()
                and getattr(t, "_target", None) is not None
                and "kmlserver_tpu_torch" in getattr(t._target, "__module__", "")]


# ---------------------------------------------------------------------------
# the job's job_metrics.prom against the reference's
# ---------------------------------------------------------------------------

_TIME_SERIES = ("kmls_job_phase_duration_seconds", "kmls_job_rule_generation_seconds",
                "kmls_job_duration_seconds", "kmls_job_last_success_timestamp_seconds")


def _prom(path) -> dict[str, float]:
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            key, _, value = line.rstrip("\n").rpartition(" ")
            out[key] = float(value)
    return out


def _types(path) -> list[str]:
    with open(path) as fh:
        return [line.strip() for line in fh if line.startswith("# TYPE")]


def _assert_same_job_metrics(port_path, ref_path):
    got, want = _prom(port_path), _prom(ref_path)
    assert sorted(got) == sorted(want)  # names and labels
    assert _types(port_path) == _types(ref_path)
    for key, value in want.items():
        if not key.startswith(_TIME_SERIES) and not key.startswith("kmls_job_artifact_bytes"):
            assert got[key] == value, key
    assert all(v >= 0 for v in got.values())


@pytest.mark.parametrize("crash_phase", [None, "encode", "mine", "rules"])
def test_job_metrics_equal_the_reference_jobs(tmp_path, crash_phase):
    port_base, ref_base = str(tmp_path / "port"), str(tmp_path / "ref")
    for base in (port_base, ref_base):
        write_dataset(base, seed=4)
    port_cfg_, ref_cfg_ = port_mining_cfg(port_base), ref_mining_cfg(ref_base)
    try:
        if crash_phase is not None:
            faults.inject(f"mine.crash.{crash_phase}", times=1)
            ref_faults.inject(f"mine.crash.{crash_phase}", times=1)
            with pytest.raises(faults.FaultInjected):
                run_mining_job(port_cfg_, device="cpu")
            with pytest.raises(ref_faults.FaultInjected):
                ref_run_mining_job(ref_cfg_)
            port_path = os.path.join(port_cfg_.pickles_dir, "job_metrics.prom")
            ref_path = os.path.join(ref_cfg_.pickles_dir, "job_metrics.prom")
            _assert_same_job_metrics(port_path, ref_path)  # the aborted run's file
            assert _prom(port_path)["kmls_job_success"] == 0
        faults.clear()
        ref_faults.clear()
        run_mining_job(port_cfg_, device="cpu")
        ref_run_mining_job(ref_cfg_)
    finally:
        faults.clear()
        ref_faults.clear()
    port_path = os.path.join(port_cfg_.pickles_dir, "job_metrics.prom")
    ref_path = os.path.join(ref_cfg_.pickles_dir, "job_metrics.prom")
    _assert_same_job_metrics(port_path, ref_path)
    got = _prom(port_path)
    assert got["kmls_job_success"] == 1
    resumed = {"encode": ["encode"], "mine": ["encode", "mine"],
               "rules": ["encode", "mine", "rules"]}.get(crash_phase, [])
    for phase in ("encode", "mine", "rules"):
        assert got[f'kmls_job_phase_resumed{{phase="{phase}"}}'] == (phase in resumed)
    assert 'kmls_job_phase_flops{phase="mine"}' in got


def test_job_metrics_knob_disables_the_writer(tmp_path):
    base = str(tmp_path)
    write_dataset(base, seed=4)
    cfg = dataclasses.replace(port_mining_cfg(base), job_metrics=False)
    run_mining_job(cfg, device="cpu")
    assert not os.path.exists(os.path.join(cfg.pickles_dir, "job_metrics.prom"))
    assert os.path.exists(os.path.join(cfg.pickles_dir, "recommendations.pickle"))


def test_job_metrics_count_path_and_mine_cost(tmp_path):
    from kmlserver_tpu_torch.observability.costmodel import phase_cost

    base = str(tmp_path)
    write_dataset(base, seed=4)
    cfg = dataclasses.replace(port_mining_cfg(base), count_path="bitpack")
    summary = run_mining_job(cfg, device="cpu")
    got = _prom(os.path.join(cfg.pickles_dir, "job_metrics.prom"))
    assert got[f'kmls_job_count_path{{path="bitpack-torch",source="override"}}'] == 1
    flops, moved = phase_cost("support_count", p=summary.n_playlists, v=summary.n_tracks)
    assert got['kmls_job_phase_flops{phase="mine"}'] == flops
    assert got['kmls_job_phase_bytes_moved{phase="mine"}'] == moved
    assert got["kmls_job_fencing_token"] == summary.fencing_token
