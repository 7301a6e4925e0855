"""The program's spans (``program_spans.py``) and the five readers of them,
on hand-built Chrome traces: fields, threads, kernels attributed by launch
correlation to the innermost program span, the idle time by span, and no
reading from a program that opens no span."""

import pytest

from kmls_bench import run
from kmls_bench.program_spans import idle_by_span, parse_name, program_spans
from kmls_bench.trace import Trace

READERS = ("gen_host_s", "dispatch_host_ms.closed", "compose_ms.closed", "front_ms.closed",
           "idle_in_spans.closed")


def _x(name, cat, ts, dur, tid=1, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if args:
        e["args"] = args
    return e


def _launch(corr, ts, tid, kernel_ts, kernel_dur):
    return [_x("cudaLaunchKernel", "cuda_runtime", ts, 2, tid=tid, correlation=corr),
            _x(f"kernel_{corr}", "kernel", kernel_ts, kernel_dur, tid=7, correlation=corr)]


def _serving_trace(with_program: bool = True) -> Trace:
    """A 1 s window: two dispatches on the loop thread (tid 1), their
    finishes on an executor thread (tid 2), three answers."""
    ev = [_x("kmls_bench:window", "user_annotation", 0, 1_000_000)]
    program = [
        _x("kmls:http.parse", "cpu_op", 100, 40),
        _x("kmls:http.parse", "user_annotation", 150, 20),
        _x("kmls:http.parse", "cpu_op", 5_000, 60),
        _x("kmls:dispatch:rows=2:len=8:replica=0", "cpu_op", 1_000, 3_000),
        _x("kmls:stage", "cpu_op", 1_100, 500),
        _x("kmls:embed_topk:valid=3:rows=2:len=8:v=1000:r=32:k=10", "cpu_op", 2_000, 1_500),
        _x("kmls:dispatch:rows=1:len=1:replica=0", "cpu_op", 6_000, 1_000),
        _x("kmls:finish.wait", "cpu_op", 4_100, 20_000, tid=2),
        _x("kmls:compose:rows=2", "cpu_op", 24_200, 1_000, tid=2),
        _x("kmls:compose:rows=1", "cpu_op", 30_000, 3_000, tid=2),
        _x("kmls:http.respond", "cpu_op", 26_000, 100),
        _x("kmls:http.respond", "cpu_op", 26_200, 80),
        _x("kmls:http.respond", "cpu_op", 34_000, 120),
        # a span from before the window is not the window's, nor one still
        # open when the window closes
        _x("kmls:dispatch:rows=9:len=8:replica=0", "cpu_op", -5_000, 900),
        _x("kmls:dispatch:rows=5:len=8:replica=0", "cpu_op", 999_000, 7_000_000),
    ]
    if with_program:
        ev += program
    ev += _launch(11, 1_200, 1, 4_000, 5_000)  # staged: inside stage
    ev += _launch(12, 2_100, 1, 9_000, 10_000)  # inside embed_topk
    ev += _launch(13, 4_050, 1, 19_000, 1_000)  # after the dispatch: no program span
    ev += _launch(14, 24_300, 2, 30_000, 500)  # a copy launched by compose on tid 2
    return Trace(ev)


def _ctx(trace):
    return {"trace": trace, "spans": {}, "device_kind": "NVIDIA H100 80GB HBM3"}


def test_the_names_parse_as_the_benchmarks_grammar():
    assert parse_name("kmls:embed_topk:valid=31:rows=32:mode=x") == (
        "embed_topk", {"valid": 31.0, "rows": 32.0, "mode": "x"})
    assert parse_name("kmls:gen.host") == ("gen.host", {})


def test_program_spans_carry_fields_threads_and_their_kernels():
    spans = program_spans(_serving_trace())
    assert [s.name for s in spans][:4] == ["http.parse", "http.parse", "dispatch", "stage"]
    # the dispatches before the window and past its end are left out
    assert all(0 <= s.t0 and s.t1 <= 1_000_000 for s in spans)
    assert sum(s.name == "dispatch" for s in spans) == 2
    by = {(s.name, s.t0): s for s in spans}
    embed = by[("embed_topk", 2_000.0)]
    assert embed.fields == {"valid": 3.0, "rows": 2.0, "len": 8.0, "v": 1000.0, "r": 32.0,
                            "k": 10.0}
    assert by[("stage", 1_100.0)].device_s == pytest.approx(0.005)
    assert embed.device_s == pytest.approx(0.010)
    # the launch at 4,050 falls in no program span of its thread
    assert by[("dispatch", 1_000.0)].device_s == 0.0
    compose = by[("compose", 24_200.0)]
    assert compose.tid == 2 and compose.device_s == pytest.approx(5e-4)


def test_the_serving_readers():
    ctx = _ctx(_serving_trace())
    assert run.reader("dispatch_host_ms.closed")(ctx) == pytest.approx((3.0 + 1.0) / 2)
    assert run.reader("compose_ms.closed")(ctx) == pytest.approx((1.0 + 3.0) / 2)
    spent_us = 40 + 20 + 60 + 100 + 80 + 120
    assert run.reader("front_ms.closed")(ctx) == pytest.approx(spent_us / 1e3 / 3)
    assert run.reader("gen_host_s")(ctx) is None  # no generation in a serving window


def test_the_mine_reader():
    ev = [_x("kmls_bench:window", "user_annotation", 0, 2_000_000)]
    for i, t in enumerate((0, 800_000)):
        ev += [_x("kmls:gen:p=10000000:tracks=1000000:rows=500000000", "cpu_op", t + 10, 250_000),
               _x("kmls:gen.host", "cpu_op", t + 20, 30_000 + 2_000 * i),
               _x("kmls:gen.draw:f=7834:p=10000000:v_pad=7936:w_pad=312832", "cpu_op",
                  t + 30_100, 200_000),
               _x("kmls:count:v_pad=7936:w_pad=312832", "cpu_op", t + 250_100, 100)]
    ctx = _ctx(Trace(ev))
    assert run.reader("gen_host_s")(ctx) == pytest.approx((0.030 + 0.032) / 2)
    for name in READERS[1:4]:
        assert run.reader(name)(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_nothing(name):
    assert run.reader(name)(_ctx(_serving_trace(with_program=False))) is None
    assert run.reader(name)({"trace": None}) is None


def test_idle_time_by_the_innermost_span():
    idle = idle_by_span(_serving_trace())
    # busy: 4,000-14,000, 9,000-19,000 merged to 4,000-20,000; 30,000-30,500
    assert sum(idle.values()) == pytest.approx(1.0 - 0.016 - 0.0005)
    # the first gap's middle (2,000) lies in embed_topk, nested in dispatch
    assert idle["embed_topk"] == pytest.approx(0.004)
    # 20,000-30,000: middle 25,000 inside compose (24,200-25,200) on tid 2
    assert idle["compose"] == pytest.approx(0.010)
    # 30,500 to the window's end: no span open at its middle
    assert idle[""] == pytest.approx(0.9695)
    share = 100.0 * (sum(idle.values()) - idle[""]) / sum(idle.values())
    assert run.reader("idle_in_spans.closed")(_ctx(_serving_trace())) == pytest.approx(share)


def test_the_benchmark_declares_the_four_readers():
    for cell, names in (("config4_job.mine", READERS[:1]), ("config4_serve.closed", READERS[1:])):
        declared = {m["name"]: m for m in run.load_cell(cell)["per_layer"]}
        for name in names:
            assert declared[name]["source"] == "program_span"
            assert declared[name]["workloads"] == [cell]
