"""What the per-layer readers (``metrics/<name>.py``) share. A reader
that finds nothing to read returns None, and the metric is left out of
the result line; a share of a roofline is never reported as 0."""

from __future__ import annotations

from . import roofline


def idle_share(ctx: dict) -> float | None:
    """The traced window's share (%) in which no operation ran on the
    card."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_share(ctx: dict, span: str, kernel: str, dims) -> float | None:
    """The least time the card could take for the work of the traced
    ``kmls_bench:<span>`` spans, as a share (%) of the device time of the
    kernels launched in them. ``dims(span)`` gives the roofline count's
    sizes of one span."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    need = spent = 0.0
    for s in tr.spans_named(span):
        if s.device_s <= 0:
            continue
        least = roofline.least_seconds(kernel, ctx["device_kind"], **dims(s))
        if least is None:
            return None
        need += least
        spent += s.device_s
    return 100.0 * need / spent if spent > 0 else None
