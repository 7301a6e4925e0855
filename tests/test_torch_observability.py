"""The port's observability package (kmlserver_tpu_torch/observability/,
utils/profiling.py) against the JAX package's on the same inputs: span
retention and the /debug/traces payload under one seeded rng, loop lag
and SLO burn rates under one fake clock (exact floats), the cost specs
over hypothesis-drawn shapes, the job_metrics.prom text byte for byte,
the client trace log and the trace join, and the profiling helpers.
The serving and mining wiring is in test_torch_observability_wiring.py."""

import importlib.util
import json
import os
import random
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kmlserver_tpu.observability import costmodel as ref_costmodel
from kmlserver_tpu.observability import jobmetrics as ref_jobmetrics
from kmlserver_tpu.observability.runtime import LoopLagMonitor as RefLoopLagMonitor
from kmlserver_tpu.observability.slo import SloTracker as RefSloTracker
from kmlserver_tpu.observability.trace import SpanRecorder as RefSpanRecorder
from kmlserver_tpu.serving.batcher import AdmissionController as RefAdmissionController
from kmlserver_tpu.serving.metrics import ServingMetrics as RefServingMetrics
from kmlserver_tpu.serving.replay import ClientTraceLog as RefClientTraceLog
from kmlserver_tpu_torch.observability import costmodel, jobmetrics, tracejoin
from kmlserver_tpu_torch.observability.runtime import LoopLagMonitor
from kmlserver_tpu_torch.observability.slo import SLOS, WINDOWS, SloTracker
from kmlserver_tpu_torch.observability.trace import SpanRecorder
from kmlserver_tpu_torch.serving.batcher import AdmissionController
from kmlserver_tpu_torch.serving.metrics import METRIC_REGISTRY, ServingMetrics
from kmlserver_tpu_torch.serving.replay import ClientTraceLog
from kmlserver_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------------

STATUSES = ("ok", "ok", "ok", "shed", "ok", "degraded", "ok", "error")


def _drive_recorder(rec, script):
    """Open, span, annotate and finish one trace per script entry; span
    times are offsets from the trace's own t0, so both packages render the
    same numbers."""
    kept = []
    for header, status, duration_s, spans in script:
        trace = rec.begin(header)
        for name, start, end in spans:
            trace.span(name, trace.t0 + start, trace.t0 + end, {"n": len(name)})
        trace.annotate("reason", status)
        kept.append(rec.finish(trace, status, duration_s))
        trace.span("late", trace.t0, trace.t0 + 1.0)  # after finish: ignored
    return kept


def _script(seed: int, n: int):
    rng = random.Random(seed)
    script = []
    for i in range(n):
        header = rng.choice([None, f"req-{i}", f"req-{i}:parent-{i}", "bad id!", ""])
        spans = [("cache", 0.0, 0.0001), ("queue", 0.0001, 0.002),
                 ("device", 0.002, 0.002 + rng.random() * 0.01), ("compose", 0.012, 0.0125)]
        script.append((header, rng.choice(STATUSES), rng.random() * 0.05, spans))
    return script


def _without_wall_clock(payload: dict) -> dict:
    out = dict(payload)
    out["traces"] = [
        {**{k: v for k, v in t.items() if k != "start_unix"},
         "spans": [{k: v for k, v in s.items() if k != "start_unix_us"} for s in t["spans"]]}
        for t in payload["traces"]
    ]
    return out


@pytest.mark.parametrize(
    "sample,capacity,slow_n,seed",
    [(1.0, 512, 32, 0), (0.3, 16, 4, 1), (1e-9, 64, 0, 2), (0.5, 8, 200, 3)],
)
def test_span_recorder_retains_what_the_reference_retains(sample, capacity, slow_n, seed):
    script = _script(seed, 150)
    port = SpanRecorder(sample=sample, capacity=capacity, slow_n=slow_n, rng=random.Random(seed))
    ref = RefSpanRecorder(sample=sample, capacity=capacity, slow_n=slow_n,
                          rng=random.Random(seed))
    assert _drive_recorder(port, script) == _drive_recorder(ref, script)
    assert port.retained() == ref.retained() and port.retained_total == ref.retained_total
    assert _without_wall_clock(port.debug_payload()) == _without_wall_clock(ref.debug_payload())


@pytest.mark.parametrize(
    "header",
    ["abc", "abc:def", "a.b-c_d:p", "bad id!", ":parent", "x" * 64, "x" * 65, "a:b:c",
     "ok: spaced ", "", None],
)
def test_trace_id_validation_is_the_references(header):
    port = SpanRecorder(sample=1.0, rng=random.Random(7)).begin(header)
    ref = RefSpanRecorder(sample=1.0, rng=random.Random(7)).begin(header)
    assert (port.trace_id, port.parent_id) == (ref.trace_id, ref.parent_id)


def test_disabled_recorder_builds_nothing():
    rec = SpanRecorder(sample=0.0)
    assert not rec.enabled and rec.begin("want-one") is None and rec.began == 0
    payload = rec.debug_payload()
    assert payload["enabled"] is False and payload["traces"] == []
    assert set(payload) == set(RefSpanRecorder(sample=0.0).debug_payload())


# ---------------------------------------------------------------------------
# loop lag and the admission fold
# ---------------------------------------------------------------------------

LAG_SCRIPT = [(0.2, 100.0), (0.01, 100.1), (None, 100.5), (None, 101.0), (0.5, 102.0),
              (0.0, 102.1), (None, 102.1), (0.3, 103.0), (None, 110.0), (0.001, 110.0)]


@pytest.mark.parametrize("half_life_s", [1.0, 0.4, 0.01, 7.5])
def test_loop_lag_equals_the_reference_under_one_clock(half_life_s):
    port = LoopLagMonitor(half_life_s=half_life_s)
    ref = RefLoopLagMonitor(half_life_s=half_life_s)
    for lag, now in LAG_SCRIPT:
        if lag is not None:
            port.note(lag, now=now)
            ref.note(lag, now=now)
        assert port.lag_s(now=now) == ref.lag_s(now=now)  # the same floats


def test_drift_tick_sees_a_blocked_loop_and_stops():
    import asyncio

    mon = LoopLagMonitor(interval_s=0.01, half_life_s=5.0)

    async def scenario():
        mon.start_on_loop(asyncio.get_running_loop())
        await asyncio.sleep(0.05)
        time.sleep(0.15)  # block the loop (deliberately not awaited)
        await asyncio.sleep(0.05)
        lag = mon.lag_s()
        mon.stop()
        ticks = mon.ticks
        await asyncio.sleep(0.05)
        return lag, ticks

    lag, ticks = asyncio.run(scenario())
    assert lag > 0.05, f"the drift tick missed a 150 ms loop stall ({lag})"
    assert ticks > 0 and mon.ticks <= ticks + 1  # at most the tick already due


def test_thread_driver_is_reentry_safe_and_stops():
    mon = LoopLagMonitor(interval_s=0.01)
    first = mon.start_thread()
    assert first is not None and mon.start_thread() is first
    deadline = time.monotonic() + 5
    while mon.ticks == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert mon.ticks > 0
    mon.stop()
    assert not first.is_alive()
    again = mon.start_thread()  # a stopped monitor starts anew
    assert again is not first and again.is_alive()
    mon.stop()
    assert not again.is_alive()
    assert not [t for t in threading.enumerate() if t.name == "kmls-loop-lag" and t.is_alive()
                and t in (first, again)]


@pytest.mark.parametrize("lag_s", [0.0, 0.03, 0.07, 0.12, 0.3])
def test_admission_folds_lag_like_the_reference(lag_s):
    port_mon, ref_mon = LoopLagMonitor(half_life_s=10.0), RefLoopLagMonitor(half_life_s=10.0)
    port_mon.note(lag_s, now=0.0)
    ref_mon.note(lag_s, now=0.0)
    now = [0.5]
    port = AdmissionController(0.1, rng=random.Random(3),
                               lag_source=lambda: port_mon.lag_s(now=now[0]))
    ref = RefAdmissionController(0.1, rng=random.Random(3),
                                 lag_source=lambda: ref_mon.lag_s(now=now[0]))
    for projected in (0.0, 0.01, 0.05, 0.2):
        for _ in range(20):
            assert port.decide(projected) == ref.decide(projected)
    blind = AdmissionController(0.1)
    if lag_s >= 0.3:
        assert port.decide(0.0)[0] == "shed" and blind.decide(0.0)[0] == "admit"


# ---------------------------------------------------------------------------
# SLO burn rates
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _slo_events(metrics, step: int) -> None:
    rng = random.Random(step)
    for _ in range(rng.randrange(50, 200)):
        metrics.record("rules", 0.001)
        metrics.record_attribution(0.0, 0.001, rng.choice([0.002, 0.004, 0.03, 0.07]))
    for _ in range(rng.randrange(0, 5)):
        metrics.record_error()
    for _ in range(rng.randrange(0, 5)):
        metrics.record_shed()
    for _ in range(rng.randrange(0, 8)):
        metrics.record_degraded(rng.choice(["overload", "deadline"]))
        metrics.record("fallback", 0.001)


@pytest.mark.parametrize(
    "knobs",
    [dict(), dict(p99_target_ms=30.0, fast_window_s=120.0, slow_window_s=600.0),
     dict(p99_target_ms=20_000.0, error_budget=0.01, degrade_budget=0.05),
     dict(fast_window_s=10.0, slow_window_s=10.0)],
)
def test_slo_burn_rates_equal_the_reference_under_one_clock(knobs):
    port_clock, ref_clock = _Clock(), _Clock()
    port_m, ref_m = ServingMetrics(), RefServingMetrics()
    port = SloTracker(port_m, clock=port_clock, **knobs)
    ref = RefSloTracker(ref_m, clock=ref_clock, **knobs)
    assert port.latency_boundary_s == ref.latency_boundary_s
    for step in range(40):
        _slo_events(port_m, step)
        _slo_events(ref_m, step)
        port_clock.t = ref_clock.t = 1000.0 + 37.0 * step
        assert port.burn_rates() == ref.burn_rates()  # the same floats
    assert port.render_lines() == ref.render_lines()
    assert port.debug_payload() == ref.debug_payload()


def test_slo_render_always_emits_all_six_series():
    lines = SloTracker(ServingMetrics(), clock=_Clock()).render_lines()
    assert len(lines) == 1 + len(SLOS) * len(WINDOWS)
    assert lines == RefSloTracker(RefServingMetrics(), clock=_Clock()).render_lines()


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

DIM_NAMES = ("b", "l", "k_max", "v", "k_best", "shards", "r", "p", "iters", "rows",
             "events", "nnz")


def test_cost_registry_is_the_references():
    assert sorted(costmodel.KERNEL_COST_SPECS) == sorted(ref_costmodel.KERNEL_COST_SPECS)
    for name, spec in costmodel.KERNEL_COST_SPECS.items():
        assert spec.name == name == ref_costmodel.KERNEL_COST_SPECS[name].name


@pytest.mark.parametrize("kernel", sorted(ref_costmodel.KERNEL_COST_SPECS))
@settings(max_examples=40, deadline=None)
@given(
    dims=st.dictionaries(st.sampled_from(DIM_NAMES), st.integers(0, 1 << 22), max_size=12),
    peaks=st.tuples(st.floats(1e9, 1e16), st.floats(1e8, 1e13)),
)
def test_phase_cost_and_roofline_equal_the_references(kernel, dims, peaks):
    got = costmodel.phase_cost(kernel, **dims)
    want = ref_costmodel.phase_cost(kernel, **dims)
    if kernel == "support_count":
        # the port counts the one triangle its kernel computes: v(v+1)/2
        # dot products of p terms, two operations each (the reference the
        # whole square, 2·p·v²); the bytes stay the reference's
        p, v = float(dims.get("p", 1)), float(dims.get("v", 1))
        want = (v * (v + 1.0) / 2.0 * p * 2.0, want[1])
    elif kernel == "embed_topk":
        # the port's kernel scores only the valid seeds (every one of the
        # b·l slots where no ``valid`` count is given), 2·v·r operations
        # each, and reads the factors once (ops/csrc/embed_topk.cu)
        b, length, v, r = (float(dims.get(d, 1)) for d in ("b", "l", "v", "r"))
        k_best = float(dims.get("k_best", 10))
        want = (2.0 * (b * length) * v * r, v * r * 4.0 + b * (length * 4.0 + k_best * 8.0))
    elif kernel == "als_sweep_sparse":
        # the port counts a segment sum of the 0/1 matrix as one add per
        # event and column and its bytes once (kmls_bench/roofline/segsum.py);
        # the Gramians and solves stay the reference's
        nnz, p, v, r, iters = (float(dims.get(d, 1)) for d in ("nnz", "p", "v", "r", "iters"))
        want = (iters * (2.0 * nnz * r + 2.0 * r * r * (p + v) + 2.0 * r * r * r),
                iters * (8.0 * nnz + 8.0 * (p + v + 2.0) + 16.0 * r * (p + v)))
    assert got == want
    assert costmodel.classify_roofline(*got, *peaks) == ref_costmodel.classify_roofline(
        *got, *peaks)


def test_embed_topk_cost_counts_the_valid_seeds():
    """A batch's padding costs the kernel nothing: the operations follow the
    valid seeds, the bytes the factors read once and the outputs."""
    v, r = 1 << 20, 32
    flops, moved = costmodel.phase_cost("embed_topk", b=8, l=128, valid=225, v=v, r=r, k_best=10)
    assert flops == 2.0 * 225 * v * r
    assert moved == v * r * 4.0 + 8 * (128 * 4.0 + 10 * 8.0)
    padded, _ = costmodel.phase_cost("embed_topk", b=8, l=128, v=v, r=r, k_best=10)
    assert padded == 2.0 * 8 * 128 * v * r


def test_phase_cost_rejects_an_unknown_kernel():
    with pytest.raises(KeyError):
        costmodel.phase_cost("no_such_kernel", p=1)


@pytest.mark.parametrize(
    "flops,bytes_per_s", [("5e13", "2e12"), ("989.4e12", "3.35e12"), ("1", "1")]
)
def test_resolve_peaks_with_both_knobs_is_the_references(monkeypatch, flops, bytes_per_s):
    monkeypatch.setenv("KMLS_PEAK_FLOPS", flops)
    monkeypatch.setenv("KMLS_PEAK_BYTES_PER_S", bytes_per_s)
    assert costmodel.resolve_peaks() == ref_costmodel.resolve_peaks()
    assert costmodel.resolve_peaks()[2] == "env"


@pytest.mark.parametrize(
    "name,flops,bw",
    [("NVIDIA H100 80GB HBM3", 989.4e12, 3.35e12), ("NVIDIA H100 PCIe", 756e12, 2.0e12),
     ("TPU v5 lite", 197e12, 819e9), ("cpu", 2e11, 1e11)],
)
def test_peak_table_rows(monkeypatch, name, flops, bw):
    monkeypatch.delenv("KMLS_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("KMLS_PEAK_BYTES_PER_S", raising=False)
    monkeypatch.setattr(costmodel, "device_kind", lambda device=None: name)
    assert costmodel.resolve_peaks() == (flops, bw, f"auto:{name}")


def test_h100_peak_bytes_equal_the_smoke_scripts():
    import chip_smoke

    h100 = dict((needle, bw) for needle, _f, bw in costmodel.PEAK_TABLE)["h100"]
    assert h100 == chip_smoke.PEAK_BYTES_PER_S


def test_partial_override_names_both_origins(monkeypatch):
    monkeypatch.setenv("KMLS_PEAK_FLOPS", "5e13")
    monkeypatch.delenv("KMLS_PEAK_BYTES_PER_S", raising=False)
    flops, bw, source = costmodel.resolve_peaks("cpu")
    assert (flops, bw, source) == (5e13, 1e11, "env+auto:cpu")
    assert costmodel.CostModel(peak_flops=5e13, device="cpu").peak_source.startswith("explicit+")


def _observe_script(cm):
    cm.observe_kernel("serve_rules", 0.002, b=8, l=8, k_max=32, v=800, k_best=10)
    cm.observe_kernel("serve_rules", 0.001, b=1, l=1, k_max=32, v=800, k_best=10)
    cm.observe_kernel("support_count", 0.5, p=1000, v=200)
    cm.observe_kernel("kernel_from_the_future", 0.1, b=1)
    cm.note_publish({"rule_ids": 6400, "rule_confs": 6400}, 1 << 20, n_shards=2,
                    watermark_bytes=77)


@pytest.mark.parametrize("peaks", [(1e12, 1e11), (1.0, 1.0), (989.4e12, 3.35e12)])
def test_cost_model_renders_what_the_reference_renders(peaks):
    port, ref = costmodel.CostModel(*peaks), ref_costmodel.CostModel(*peaks)
    _observe_script(port)
    _observe_script(ref)
    got, want = port.kernel_stats(), ref.kernel_stats()
    assert port.observations == ref.observations == 4
    # the pair count's own figures: one triangle (1000 playlists, 200
    # tracks) over 0.5 s against the explicit peak, which stands for int8
    support = got.pop("support_count")
    want.pop("support_count")
    flops = 200 * 201 / 2 * 1000 * 2.0
    assert support["flops"] == flops and support["dispatches"] == 1
    assert support["mfu"] == pytest.approx(flops / 0.5 / peaks[0], rel=1e-12)
    # every other kernel as the reference has it, but the MFU unclamped
    for stats in got.values():
        mfu = stats.pop("mfu")
        assert mfu == pytest.approx(stats["flops_per_s"] / peaks[0], rel=1e-12)
    for stats in want.values():
        stats.pop("mfu")
    assert got == want
    if peaks == (1.0, 1.0):
        assert support["mfu"] > 1.0  # no clamp: the reading says the peak is wrong
    # no watched kernel on either side; the memory lines are absent on the CPU
    def comparable(lines):
        return [line for line in lines if "support_count" not in line
                and not line.startswith("kmls_mfu{")]

    assert comparable(port.render_lines()) == comparable(ref.render_lines())
    assert f'kmls_mfu{{kernel="support_count"}} {support["mfu"]:.6g}' in port.render_lines()
    summary = port.summary()
    assert summary.keys() == ref.summary().keys()


def test_first_shape_watcher_banks_across_publications():
    count = [3]  # earlier unwarmed dispatches: never billed
    probe = lambda: count[0]  # noqa: E731
    watcher = costmodel.CompileWatcher()
    watcher.watch("serve_rules", probe)
    count[0] += 2  # inside the publication's warm-up window
    watcher.mark_published()
    assert watcher.compiles() == {"serve_rules": 0}
    count[0] += 1  # an unwarmed dispatch while serving
    assert watcher.compiles() == {"serve_rules": 1}
    watcher.note_prepublish()  # a re-publication banks it
    count[0] += 4
    watcher.mark_published()
    assert watcher.compiles() == {"serve_rules": 1}
    count[0] += 2
    assert watcher.compiles() == {"serve_rules": 3}
    cm = costmodel.CostModel(1e12, 1e11)
    cm.compile_watcher = watcher
    assert 'kmls_compiles_total{kernel="serve_rules"} 3' in cm.render_lines()


def test_memory_gauges_absent_and_watermark_zero_on_the_cpu():
    assert costmodel.CostModel.device_memory_lines() == []
    assert costmodel.device_watermark_bytes("cpu") == 0


# ---------------------------------------------------------------------------
# job_metrics.prom
# ---------------------------------------------------------------------------


def _job_script(jm, success: bool):
    jm.phase_done("encode", 0.25)
    jm.phase_done("mine", 1.5, resumed=True)
    jm.set_dataset(rows=6000, playlists=300, tracks=800)
    jm.note_count_path("sparse-hybrid", "heuristic")
    jm.note_phase_cost("mine", *costmodel.phase_cost("sparse_count", events=1234, nnz=6000,
                                                     v=90))
    jm.phase_done("rules", 0.125)
    jm.note_artifact("recommendations", jm.path)  # the file itself exists by now
    jm.note_artifact("missing", jm.path + ".nope")
    jm.finish(success, rule_generation_s=1.5 if success else None,
              fencing_token=7 if success else None)


@pytest.mark.parametrize("success", [True, False])
def test_job_metrics_text_is_byte_identical(tmp_path, monkeypatch, success):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
    port = jobmetrics.JobMetrics(str(tmp_path / "port"))
    ref = ref_jobmetrics.JobMetrics(str(tmp_path / "ref"))
    _job_script(port, success)
    _job_script(ref, success)
    assert port.render() == ref.render()
    with open(port.path) as fh_port, open(ref.path) as fh_ref:
        assert fh_port.read() == fh_ref.read()
    assert os.path.basename(port.path) == ref_jobmetrics.JOB_METRICS_FILENAME


def test_job_metrics_refuses_an_unregistered_series(tmp_path, monkeypatch):
    jm = jobmetrics.JobMetrics(str(tmp_path))
    monkeypatch.delitem(METRIC_REGISTRY, "kmls_job_success")
    with pytest.raises(KeyError):
        jm.finish(True)


def test_job_metrics_write_failure_is_best_effort(tmp_path, monkeypatch):
    from kmlserver_tpu_torch.io import artifacts

    def enospc(*args, **kwargs):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(artifacts, "atomic_write_text", enospc)
    jm = jobmetrics.JobMetrics(str(tmp_path))
    jm.phase_done("encode", 0.1)  # no raise
    jm.finish(True)
    assert not os.path.exists(jm.path)


# ---------------------------------------------------------------------------
# the client trace log and the trace join
# ---------------------------------------------------------------------------


def _trace_logs():
    port, ref = ClientTraceLog(capacity=5), RefClientTraceLog(capacity=5)
    for log in (port, ref):
        for i in range(7):
            log.record(f"t{i}" if i != 3 else "", 100.0 + i, 100.0125 + i * 1.5, 200 + i)
    return port, ref


def test_client_trace_log_is_the_references(tmp_path):
    port, ref = _trace_logs()
    assert port.entries() == ref.entries() and port.dropped == ref.dropped == 1
    assert port.write_jsonl(str(tmp_path / "a")) == ref.write_jsonl(str(tmp_path / "b"))
    assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text()


def _reference_tracejoin():
    spec = importlib.util.spec_from_file_location(
        "ref_tracejoin", os.path.join(REPO, "scripts", "kmls_tracejoin.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--all"]])
def test_tracejoin_output_is_the_references(tmp_path, capsys, extra):
    port_log, _ = _trace_logs()
    client = tmp_path / "client.jsonl"
    port_log.write_jsonl(str(client))
    traces = {"enabled": True, "traces": [
        {"trace_id": "t0", "status": "ok", "start_unix": 100.001, "duration_ms": 9.5,
         "attrs": {"hedged": "won", "deadline_budget_ms": 40.0},
         "spans": [{"name": "queue", "start_ms": 0.1, "duration_ms": 2.0}]},
        {"trace_id": "t2", "status": "shed", "start_unix": 102.0, "duration_ms": 0.4,
         "attrs": {"admission": "shed"}, "spans": []},
        {"trace_id": "nobody", "status": "ok", "duration_ms": 1.0, "spans": []},
    ]}
    server = tmp_path / "traces.json"
    server.write_text(json.dumps(traces))
    argv = ["--client", str(client), "--traces", str(server), *extra]
    port_rc = tracejoin.main(argv)
    port_out = capsys.readouterr()
    ref_rc = _reference_tracejoin().main(argv)
    ref_out = capsys.readouterr()
    assert port_rc == ref_rc == 0
    assert port_out.out == ref_out.out and port_out.err == ref_out.err
    joined = [json.loads(line) for line in port_out.out.splitlines()]
    assert joined[0]["client_overhead_ms"] == pytest.approx(12.5 - 9.5)


def test_tracejoin_runs_as_a_module(tmp_path):
    import subprocess
    import sys

    (tmp_path / "c.jsonl").write_text(json.dumps(
        {"trace_id": "a", "client_send_unix": 1.0, "client_recv_unix": 1.01,
         "client_rtt_ms": 10.0, "status": 200}) + "\n")
    (tmp_path / "t.json").write_text(json.dumps(
        {"traces": [{"trace_id": "a", "duration_ms": 4.0, "spans": []}]}))
    proc = subprocess.run(
        [sys.executable, "-m", "kmlserver_tpu_torch.observability.tracejoin",
         "--client", str(tmp_path / "c.jsonl"), "--traces", str(tmp_path / "t.json")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["client_overhead_ms"] == 6.0
    assert "1/1 client records joined" in proc.stderr


# ---------------------------------------------------------------------------
# profiling helpers
# ---------------------------------------------------------------------------


def test_profiling_is_a_no_op_without_the_dir(monkeypatch):
    monkeypatch.delenv("KMLS_PROFILE_DIR", raising=False)
    assert profiling.profile_dir() is None
    with profiling.trace_session("nothing") as path:
        assert path is None
    thread = profiling.start_capture("nothing", 0.01)
    thread.join(10)
    assert not thread.is_alive()


def test_trace_session_writes_a_chrome_trace(monkeypatch, tmp_path):
    import torch

    monkeypatch.setenv("KMLS_PROFILE_DIR", str(tmp_path))
    with profiling.trace_session("unit") as path:
        torch.ones(64).cumsum(0)
    assert os.path.dirname(path) == str(tmp_path / "unit")
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["traceEvents"], "the trace holds no event"


def test_phase_timer_and_format_are_the_references():
    import torch

    from kmlserver_tpu.utils.profiling import format_phases as ref_format

    timer = profiling.PhaseTimer(torch.device("cpu"))
    with timer.phase("a"):
        pass
    with timer.phase("a"):
        pass
    assert list(timer.phases) == ["a"] and timer.phases["a"] >= 0.0
    phases = {"pair_counts": 0.1234, "rule_emission": 2.0}
    assert profiling.format_phases(phases) == ref_format(phases)
    assert profiling.format_phases({}) == ref_format({})
