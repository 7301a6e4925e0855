"""Device time of one kernel's launches inside chosen program spans.

A program span (``program_spans.py``) owns every kernel launched inside it;
a roofline of one kernel wants that kernel's time alone. A kernel belongs
to a span when the runtime call that launched it (matched by its
``correlation``) falls inside the span on the same thread.
"""

from __future__ import annotations

from .program_spans import ProgramSpan
from .trace import Trace


def kernel_seconds(tr: Trace, spans: list[ProgramSpan], kernel: str) -> list[float]:
    """Per span of ``spans``, the device seconds of the kernels whose name
    holds ``kernel`` that were launched inside it."""
    launch = {}
    for e in tr.host:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
    out = [0.0] * len(spans)
    for k in tr.device:
        if kernel not in k.get("name", ""):
            continue
        tid, ts = launch.get(k.get("args", {}).get("correlation"), (None, None))
        for i, s in enumerate(spans):
            if s.tid == tid and s.t0 <= ts <= s.t1:
                out[i] += float(k["dur"]) / 1e6
                break
    return out


def roofline(ctx: dict, spans: list[ProgramSpan], kernel: str, counted: str, dims) -> float | None:
    """The least time of the work of the spans that ``dims(span)`` sizes
    (None: a span it does not size) as a share (%) of the device time of
    ``kernel``'s launches in all ``spans``, against ``roofline/<counted>.py``."""
    from .roofline import least_seconds

    tr = ctx.get("trace")
    if tr is None or not spans:
        return None
    need = 0.0
    for s in spans:
        d = dims(s)
        if d is not None:
            least = least_seconds(counted, ctx["device_kind"], **d)
            if least is None:
                return None
            need += least
    spent = sum(kernel_seconds(tr, spans, kernel))
    return 100.0 * need / spent if spent > 0 and need > 0 else None
