"""The port's own spans (``utils/profiling.span``): nothing opens while no
profiler runs, nor after one stops; the ranges of every thread land in one
trace with their fields, the serving engine's dispatch and finish and the
device-born mine emit the spans the benchmark's per-layer metrics read (the
embedding lookup's fields computed from the staged seeds, as
``kmls_bench/serve_child.py`` computes them), the request recorder's spans
sit on the profiler's unix clock, and ``trace_session`` traces a second
thread."""

import json
import os
import random
import tempfile
import threading
import time

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.autograd import profiler as autograd_profiler

from kmlserver_tpu_torch.data.device_synthetic import device_synthetic_bitset
from kmlserver_tpu_torch.observability.trace import SpanRecorder
from kmlserver_tpu_torch.ops import popcount as pc
from kmlserver_tpu_torch.ops import rules
from kmlserver_tpu_torch.serving import engine as engine_mod
from kmlserver_tpu_torch.utils import profiling

from .torch_chaos_util import port_mining_cfg, port_serving_cfg, write_dataset

def _profiler() -> torch.profiler.profile:
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _events(prof) -> tuple[list[dict], int]:
    """The exported Chrome trace's complete events and its base time (ns)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        os.unlink(path)
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"], int(doc["baseTimeNanoseconds"])


def _spans(events: list[dict], prefix: str = "kmls:") -> list[tuple[str, dict, dict]]:
    """→ ``[(name, fields, event)]`` of the ``prefix`` ranges, in order."""
    out = []
    for e in sorted(events, key=lambda e: float(e["ts"])):
        if e["name"].startswith(prefix):
            name, *parts = e["name"][len(prefix):].split(":")
            out.append((name, dict(p.split("=", 1) for p in parts), e))
    return out


# ---------------------------------------------------------------------------
# the helper
# ---------------------------------------------------------------------------


class _CountingRange:
    """Stands in for the profiler's range: records each name it opens."""

    opened: list

    def __init__(self, name):
        self.opened.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _count_ranges(monkeypatch) -> list:
    opened = []
    monkeypatch.setattr(_CountingRange, "opened", opened, raising=False)
    monkeypatch.setattr(profiling, "_FAST_RANGE", _CountingRange)
    return opened


def test_no_profiler_opens_no_range(monkeypatch):
    opened = _count_ranges(monkeypatch)
    calls = []
    assert not autograd_profiler._is_profiler_enabled
    for _ in range(100):
        with profiling.span("dispatch", rows=3, valid=lambda: calls.append(1) or 7):
            pass
    assert opened == [] and calls == []  # no range, and no field computed
    assert profiling.span("x") is profiling.span("y", a=1)  # one shared null context


def test_the_gate_is_the_profilers_process_wide_flag(monkeypatch):
    opened = _count_ranges(monkeypatch)
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    with profiling.span("embed_topk", valid=lambda: 31, rows=32, len=8):
        pass
    assert opened == ["kmls:embed_topk:valid=31:rows=32:len=8"]


@pytest.mark.parametrize("session", ["trace_session", "all_threads_profiler"])
def test_no_range_opens_after_a_session_stops(monkeypatch, tmp_path, session):
    """A profiler tracing every thread leaves nothing switched on behind
    it: the gate reads False again on the thread that ran it and on one
    that ran inside it, and no range opens there afterwards."""
    monkeypatch.setenv("KMLS_PROFILE_DIR", str(tmp_path))
    go, done = threading.Event(), threading.Event()
    seen = {}

    def other() -> None:  # a thread alive across the whole session
        with profiling.span("flush", rows=1):
            torch.ones(4).sum()
        go.wait(30)
        seen["gate"] = autograd_profiler._is_profiler_enabled
        seen["span"] = profiling.span("flush", rows=2)
        done.set()

    t = threading.Thread(target=other)
    if session == "trace_session":
        with profiling.trace_session("stops"):
            t.start()
            assert autograd_profiler._is_profiler_enabled
            time.sleep(0.05)
    else:
        prof = _profiler()
        prof.start()
        t.start()
        assert autograd_profiler._is_profiler_enabled
        time.sleep(0.05)
        prof.stop()
    opened = _count_ranges(monkeypatch)
    go.set()
    assert done.wait(30)
    t.join()
    assert not autograd_profiler._is_profiler_enabled
    assert seen == {"gate": False, "span": profiling._OFF}
    with profiling.span("compose", rows=lambda: pytest.fail("field computed")):
        torch.ones(4).sum()
    assert opened == []


def test_span_name_is_the_benchmarks_grammar():
    name = profiling.span_name("embed_topk", {"valid": 31, "rows": 32, "mode": "x"})
    assert name == "kmls:embed_topk:valid=31:rows=32:mode=x"
    # the benchmark parses this very name (kmls_bench/tests/test_kb_program_spans.py)
    ((layer, fields, _),) = _spans([{"name": name, "ts": 0}])
    assert (layer, fields) == ("embed_topk", {"valid": "31", "rows": "32", "mode": "x"})


def test_spans_of_two_threads_land_in_one_trace_with_their_fields():
    barrier = threading.Barrier(2)

    def work(i: int) -> None:
        barrier.wait()
        with profiling.span("flush", rows=i, thread=f"t{i}"):
            torch.ones(16).sum()

    prof = _profiler()
    prof.start()
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        prof.stop()
    events, _ = _events(prof)
    got = {f["thread"]: (name, f["rows"], e["tid"]) for name, f, e in _spans(events)}
    assert got.keys() == {"t1", "t2"}
    assert got["t1"][:2] == ("flush", "1") and got["t2"][:2] == ("flush", "2")
    assert got["t1"][2] != got["t2"][2]  # each on its own thread


def test_phase_timer_phases_are_spans():
    prof = _profiler()
    prof.start()
    try:
        timer = profiling.PhaseTimer(torch.device("cpu"))
        with timer.phase("pair_counts"):
            torch.ones(8).sum()
    finally:
        prof.stop()
    events, _ = _events(prof)
    assert [name for name, _, _ in _spans(events)] == ["pair_counts"]


def test_trace_session_captures_a_span_from_a_second_thread(monkeypatch, tmp_path):
    monkeypatch.setenv("KMLS_PROFILE_DIR", str(tmp_path))
    with profiling.trace_session("threads") as path:
        def work() -> None:
            with profiling.span("resolve", rows=4):
                torch.ones(8).sum()

        t = threading.Thread(target=work)
        t.start()
        t.join()
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    spans = _spans(events)
    assert [(name, f) for name, f, _ in spans] == [("resolve", {"rows": "4"})]
    assert spans[0][2]["tid"] != threading.get_native_id()


def test_request_spans_and_profiler_ranges_share_the_unix_clock():
    rec = SpanRecorder(sample=1.0, rng=random.Random(0))
    prof = _profiler()
    prof.start()
    try:
        trace = rec.begin("clock-1")
        t_a = time.perf_counter()
        with profiling.span("compose", rows=1):
            time.sleep(0.002)
        trace.span("compose", t_a, time.perf_counter())
    finally:
        prof.stop()
    rec.finish(trace, "ok", time.perf_counter() - trace.t0)
    kept = rec.snapshot()[-1]["spans"][0]
    events, base_ns = _events(prof)
    (_, _, event), = _spans(events)
    profiler_unix_us = float(event["ts"]) + base_ns / 1e3
    assert abs(profiler_unix_us - kept["start_unix_us"]) < 1000.0
    assert abs(kept["start_unix_us"] / 1e6 - time.time()) < 60.0


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def blend_pvc(tmp_path_factory) -> str:
    """A 60-playlist PVC with rules and embeddings, mined by the port on
    the CPU (some tracks stay below min_support: cold seeds)."""
    from kmlserver_tpu_torch.mining.pipeline import run_mining_job

    base = str(tmp_path_factory.mktemp("spans_blend"))
    write_dataset(base, seed=0, n_playlists=60, n_tracks=24)
    run_mining_job(port_mining_cfg(base, min_support=0.15, embed_enabled=True, als_rank=8,
                                   als_iters=4), device="cpu")
    return base


def _staging_engine(base: str):
    """A blend engine whose embedding launches keep their staged seeds in
    ``staged`` (on a subclass, so the port's class stays as it is)."""

    class StagingEngine(engine_mod.RecommendEngine):
        staged: list = []

        def _launch_embed(self, bundle, seeds):
            self.staged.append(seeds.numpy().copy())
            return super()._launch_embed(bundle, seeds)

    eng = StagingEngine(port_serving_cfg(base, hybrid_mode="blend"), device="cpu")
    eng.staged = []
    assert eng.load() and eng.bundle.emb_factors is not None
    return eng


def test_dispatch_and_finish_emit_the_engines_spans(blend_pvc):
    eng = _staging_engine(blend_pvc)
    bundle = eng.bundle
    names = list(bundle.emb_vocab)
    batch = [names[:3], [names[5]], ["not a track", names[7]], names[:9]]
    plain = eng.recommend_many_async(batch)()
    eng.staged.clear()
    prof = _profiler()
    prof.start()
    try:
        answers = eng.recommend_many_async(batch)()
    finally:
        prof.stop()
    assert answers == plain  # the spans change nothing
    events, _ = _events(prof)
    spans = _spans(events)
    order = [name for name, _, _ in spans]
    assert order[:1] == ["dispatch"] and order[-2:] == ["finish.wait", "compose"]
    for name in ("stage", "rules_launch", "embed_topk"):
        assert name in order, (name, order)
    fields = {name: f for name, f, _ in spans}
    length = eng._bucket_len(max(len(s) for s in batch))
    assert fields["dispatch"] == {"rows": "4", "len": str(length), "replica": "0"}
    assert fields["compose"] == {"rows": "4"}
    # the embedding lookup's fields, from the staged seeds as the
    # benchmark's serving child computes them
    (staged,) = eng.staged
    v, r = bundle.emb_factors.shape
    assert fields["embed_topk"] == {
        "valid": str(int((staged >= 0).sum())), "rows": str(staged.shape[0]),
        "len": str(staged.shape[1]), "v": str(v), "r": str(r), "k": str(eng.cfg.k_best_tracks)}
    dispatch = next(e for name, _, e in spans if name == "dispatch")
    inner = [e for name, _, e in spans if name in ("stage", "rules_launch", "embed_topk")]
    for e in inner:  # staging and both launches lie inside the dispatch
        assert float(dispatch["ts"]) <= float(e["ts"])
        assert float(e["ts"]) + float(e["dur"]) <= float(dispatch["ts"]) + float(dispatch["dur"])


def test_cost_observations_take_each_lookups_own_time(blend_pvc):
    eng = _staging_engine(blend_pvc)
    names = list(eng.bundle.emb_vocab)
    eng.recommend_many_async([names[:2], [names[4]]])()
    stats = eng.cost_model.kernel_stats()
    assert stats["serve_rules"]["dispatches"] == stats["embed_topk"]["dispatches"] == 1
    assert stats["serve_rules"]["device_s"] > 0.0 and stats["embed_topk"]["device_s"] > 0.0


# ---------------------------------------------------------------------------
# the device-born mine
# ---------------------------------------------------------------------------


def test_a_device_born_mine_emits_gen_count_and_emit():
    p, tracks, rows_target, min_count = 1000, 300, 10000, 40
    prof = _profiler()
    prof.start()
    try:
        bitset, f, info = device_synthetic_bitset(p, tracks, rows_target, min_count, seed=3,
                                                  device="cpu")
        counts = pc.popcount_pair_counts_padded(bitset)
        mined = rules.mine_rules_from_counts(counts, n_playlists=p, min_support=min_count / p,
                                             k_max=8, n_total_songs=tracks)
    finally:
        prof.stop()
    assert mined.n_frequent_items > 0
    spans = _spans(_events(prof)[0])
    order = [name for name, _, _ in spans]
    assert order == ["gen", "gen.host", "gen.draw", "count", "emit", "emit.topk", "emit.fetch",
                     "emit.assemble"]
    fields = {name: f for name, f, _ in spans}
    v_pad, w_pad = bitset.shape
    assert fields["gen"] == {"p": str(p), "tracks": str(tracks), "rows": str(rows_target)}
    assert fields["gen.draw"] == {"f": str(f), "p": str(p), "v_pad": str(v_pad),
                                  "w_pad": str(w_pad)}
    assert (info["v_pad"], info["w_pad"]) == (v_pad, w_pad)
    assert fields["count"] == {"v_pad": str(v_pad), "w_pad": str(w_pad)}
    assert fields["emit"] == {"f": str(v_pad), "k_max": "8"}
    gen = spans[0][2]
    for name, _, e in spans[1:3]:  # the host part and the draw lie inside the call
        assert float(gen["ts"]) <= float(e["ts"])
        assert float(e["ts"]) + float(e["dur"]) <= float(gen["ts"]) + float(gen["dur"])
