"""Reduction of a ``torch.profiler`` Chrome trace to what the metrics read:
the device's busy time, its idle gaps and what the host did in them, the
kernels by time, and the device time of the kernels launched inside each
of the benchmark's own spans.

The benchmark opens a ``kmls_bench:window`` span around the traced window
and ``kmls_bench:<layer>[:key=value...]`` spans around its calls into the
program (``torch.profiler.record_function``). A kernel belongs to a span
when the runtime call that launched it (matched by its ``correlation``)
falls inside that span on the same thread.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime")
PREFIX = "kmls_bench:"
WINDOW = PREFIX + "window"


@dataclass
class Span:
    name: str
    tid: object
    t0: float
    t1: float
    fields: dict = field(default_factory=dict)
    device_s: float = 0.0


def _union(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def parse_span_name(name: str) -> tuple[str, dict]:
    """``kmls_bench:embed_topk:valid=31:rows=32`` → ``("embed_topk",
    {"valid": 31.0, "rows": 32.0})``."""
    parts = name[len(PREFIX):].split(":")
    fields = {}
    for p in parts[1:]:
        k, _, v = p.partition("=")
        try:
            fields[k] = float(v)
        except ValueError:
            fields[k] = v
    return parts[0], fields


class Trace:
    """One traced window."""

    def __init__(self, events: list[dict]):
        window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
        if not window:
            raise ValueError("the trace holds no kmls_bench:window span")
        w = window[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                     and e.get("name") != WINDOW]
        self.busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                            for e in self.device], self.t0, self.t1)
        self.spans = self._spans(events)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as fh:
            return cls(json.load(fh)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def _spans(self, events: list[dict]) -> list[Span]:
        spans = []
        for e in events:
            name = e.get("name", "")
            if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                    and name.startswith(PREFIX) and name != WINDOW):
                layer, fields = parse_span_name(name)
                t0 = float(e["ts"])
                if self.t0 <= t0 < self.t1:
                    spans.append(Span(layer, e.get("tid"), t0, t0 + float(e["dur"]), fields))
        launch = {}
        for e in events:
            if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
        by_tid: dict[object, list[Span]] = {}
        for s in spans:
            by_tid.setdefault(s.tid, []).append(s)
        starts = {tid: ([s.t0 for s in ss], ss) for tid, ss in
                  ((tid, sorted(ss, key=lambda s: s.t0)) for tid, ss in by_tid.items())}
        for k in self.device:
            corr = k.get("args", {}).get("correlation")
            if corr not in launch:
                continue
            tid, ts = launch[corr]
            if tid not in starts:
                continue
            t0s, ss = starts[tid]
            i = bisect.bisect_right(t0s, ts) - 1
            # the innermost open span on that thread at the launch
            while i >= 0:
                if ss[i].t0 <= ts <= ss[i].t1:
                    ss[i].device_s += float(k["dur"]) / 1e6
                    break
                i -= 1
        return spans

    def spans_named(self, layer: str) -> list[Span]:
        return [s for s in self.spans if s.name == layer]

    def device_ops(self, n: int = 10) -> list[list]:
        """The device operations that took most time → ``[[name, s], ...]``."""
        total: dict[str, float] = {}
        for e in self.device:
            a, b = max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1)
            if b > a:
                total[e["name"]] = total.get(e["name"], 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle device time by what the host was doing at each gap's
        middle (the innermost host event there, on any thread) →
        ``[[name, s], ...]``, the largest first."""
        gaps, t = [], self.t0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = b
        if self.t1 > t:
            gaps.append((t, self.t1))
        host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                       for e in self.host), key=lambda x: x[0])
        t0s = [h[0] for h in host]
        total: dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            inner = None
            i = bisect.bisect_right(t0s, mid)
            for h in host[max(0, i - 4096):i]:
                if h[1] >= mid and (inner is None or h[1] - h[0] < inner[1] - inner[0]):
                    inner = h
            name = inner[2] if inner is not None else "host: no traced activity"
            total[name] = total.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
