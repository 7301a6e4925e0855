"""The program's own spans in a traced window.

The port names its layers in the profiler's trace itself
(``kmlserver_tpu_torch/utils/profiling.span``): ``kmls:<name>[:key=value...]``
ranges, recorded as ``user_annotation`` or ``cpu_op`` host events on the
thread that ran the work. :func:`program_spans` collects those that lie
wholly inside the window from a reduced :class:`~kmls_bench.trace.Trace`,
with their fields and thread, and gives each the device time of the kernels
launched inside it: a kernel belongs to the innermost program span open on
the thread of the runtime call that launched it (matched by its
``correlation``), as :class:`~kmls_bench.trace.Trace` does for the
benchmark's own ``kmls_bench:`` spans. A span still open when the window
closes is left out: stopping the profiler holds the interpreter for
seconds, and a span open then ends seconds later. A program without these
spans yields none, and every reader of them then reports nothing.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from .trace import PREFIX as BENCH_PREFIX
from .trace import Trace, parse_span_name

PREFIX = "kmls:"
CATS = ("user_annotation", "cpu_op")


@dataclass
class ProgramSpan:
    name: str
    tid: object
    t0: float
    t1: float
    fields: dict = field(default_factory=dict)
    device_s: float = 0.0

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e6


def parse_name(name: str) -> tuple[str, dict]:
    """``kmls:embed_topk:valid=31:rows=32`` → ``("embed_topk", {"valid":
    31.0, "rows": 32.0})``: the benchmark's span grammar under the
    program's prefix."""
    return parse_span_name(BENCH_PREFIX + name[len(PREFIX):])


def program_spans(tr: Trace) -> list[ProgramSpan]:
    """The window's program spans, by start, with their kernels' device
    time (cached on the trace)."""
    cached = getattr(tr, "_program_spans", None)
    if cached is not None:
        return cached
    spans = []
    for e in tr.host:
        name = e.get("name", "")
        if e.get("cat") in CATS and name.startswith(PREFIX):
            t0 = float(e["ts"])
            t1 = t0 + float(e["dur"])
            if tr.t0 <= t0 and t1 <= tr.t1:
                layer, fields = parse_name(name)
                spans.append(ProgramSpan(layer, e.get("tid"), t0, t1, fields))
    spans.sort(key=lambda s: s.t0)
    launch = {}
    for e in tr.host:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
    by_tid: dict[object, list[ProgramSpan]] = {}
    for s in spans:
        by_tid.setdefault(s.tid, []).append(s)
    starts = {tid: ([s.t0 for s in ss], ss) for tid, ss in by_tid.items()}
    for k in tr.device:
        corr = k.get("args", {}).get("correlation")
        if corr not in launch:
            continue
        tid, ts = launch[corr]
        if tid not in starts:
            continue
        t0s, ss = starts[tid]
        i = bisect.bisect_right(t0s, ts) - 1
        # the innermost open span on that thread at the launch: the latest
        # started one that still holds it
        while i >= 0:
            if ss[i].t0 <= ts <= ss[i].t1:
                ss[i].device_s += float(k["dur"]) / 1e6
                break
            i -= 1
    tr._program_spans = spans
    return spans


def named(ctx: dict, name: str) -> list[ProgramSpan]:
    """The traced window's program spans called ``name`` (none untraced)."""
    tr = ctx.get("trace")
    return [s for s in program_spans(tr) if s.name == name] if tr is not None else []


def mean_ms(ctx: dict, name: str) -> float | None:
    """Mean host milliseconds of the window's ``name`` spans, or None."""
    spans = named(ctx, name)
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None


def idle_by_span(tr: Trace) -> dict[str, float]:
    """Idle device seconds of the window by the innermost program span
    open at each gap's middle on any thread (``""``: none open)."""
    gaps, t = [], tr.t0
    for a, b in tr.busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if tr.t1 > t:
        gaps.append((t, tr.t1))
    spans = program_spans(tr)
    t0s = [s.t0 for s in spans]
    out: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        inner = None
        i = bisect.bisect_right(t0s, mid)
        for s in spans[max(0, i - 4096):i]:
            if s.t1 >= mid and (inner is None or s.t1 - s.t0 < inner.t1 - inner.t0):
                inner = s
        key = inner.name if inner is not None else ""
        out[key] = out.get(key, 0.0) + (b - a) / 1e6
    return out
